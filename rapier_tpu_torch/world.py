"""Host-side scene construction + a convenience stepping facade.

Counterpart of rapier_tpu.world: the `RigidBodyBuilder` / `ColliderBuilder`
builders (every shape of the reference: the meshes gather into one shared
`MeshData` table, convex hulls into one `ConvexHulls` table, and compounds,
polylines, voxels and convex decompositions expand into leaf colliders on
the same body when inserted), `GenericJointBuilder` with its typed forms for
impulse joints and reduced-coordinate multibody joints, and
`PhysicsWorld`.  Building is plain
numpy and gives the same `SceneState` leaves as the reference's `build()`;
`step()` runs the port's batched pipeline on a batch of one scene on
`device`, the CUDA card unless the caller asks for another device.
"""

from __future__ import annotations

import copy
import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from rapier_tpu_torch.dynamics.solver.joint_constraints import used_slots
from rapier_tpu_torch.geometry import mass_properties as mp
from rapier_tpu_torch.types import (
    ACTIVE_COLLISION_TYPES_DEFAULT,
    Bodies,
    BodyType,
    CoefficientCombineRule,
    Colliders,
    ConvexHulls,
    FrictionModel,
    Joints,
    MAX_HULL_VERTS,
    MeshData,
    SceneState,
    ShapeType,
    SimParams,
    empty_bodies,
    empty_colliders,
    empty_contacts,
    empty_joints,
    from_numpy,
)

_IDQ = (0.0, 0.0, 0.0, 1.0)


def _as_quat(rotation) -> np.ndarray:
    """Accept a quaternion (4,) or a scaled-axis rotation vector (3,)."""
    r = np.asarray(rotation, dtype=np.float64)
    if r.shape == (4,):
        return r / np.linalg.norm(r)
    if r.shape == (3,):
        angle = np.linalg.norm(r)
        if angle < 1e-12:
            return np.array(_IDQ)
        axis = r / angle
        s = math.sin(angle / 2)
        return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle / 2)])
    raise ValueError(f"rotation must be quat (4,) or scaled axis (3,), got {r.shape}")


@dataclass
class RigidBodyBuilder:
    body_type: BodyType = BodyType.DYNAMIC
    translation: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = _IDQ
    linvel: tuple = (0.0, 0.0, 0.0)
    angvel: tuple = (0.0, 0.0, 0.0)
    gravity_scale: float = 1.0
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    can_sleep: bool = True
    sleeping: bool = False
    ccd_enabled: bool = False
    soft_ccd_prediction: float = 0.0
    locked_axes: int = 0
    dominance_group: int = 0
    gyroscopic_forces_enabled: bool = False
    additional_mass: float = 0.0
    enabled: bool = True
    user_data: int = 0
    additional_solver_iterations: int = 0

    @staticmethod
    def dynamic() -> "RigidBodyBuilder":
        return RigidBodyBuilder(BodyType.DYNAMIC)

    @staticmethod
    def fixed() -> "RigidBodyBuilder":
        return RigidBodyBuilder(BodyType.FIXED)

    @staticmethod
    def kinematic_position_based() -> "RigidBodyBuilder":
        return RigidBodyBuilder(BodyType.KINEMATIC_POSITION_BASED)

    @staticmethod
    def kinematic_velocity_based() -> "RigidBodyBuilder":
        return RigidBodyBuilder(BodyType.KINEMATIC_VELOCITY_BASED)

    def _set(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        return self

    def with_translation(self, xyz):
        return self._set(translation=tuple(xyz))

    def with_rotation(self, rot):
        return self._set(rotation=tuple(np.asarray(_as_quat(rot))))

    def with_linvel(self, v):
        return self._set(linvel=tuple(v))

    def with_angvel(self, v):
        return self._set(angvel=tuple(v))

    def with_additional_solver_iterations(self, n: int):
        return self._set(additional_solver_iterations=int(n))

    def lock_rotations(self):
        return self._set(locked_axes=self.locked_axes | (0b111 << 3))

    def lock_translations(self):
        return self._set(locked_axes=self.locked_axes | 0b111)


@dataclass
class ColliderBuilder:
    shape_type: ShapeType = ShapeType.BALL
    shape_params: tuple = (1.0,)
    translation: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = _IDQ
    friction: float = 0.5
    restitution: float = 0.0
    friction_combine_rule: CoefficientCombineRule = CoefficientCombineRule.AVERAGE
    restitution_combine_rule: CoefficientCombineRule = CoefficientCombineRule.AVERAGE
    density: float = 1.0
    mass: Optional[float] = None
    sensor: bool = False
    collision_groups: int = 0xFFFF_FFFF
    solver_groups: int = 0xFFFF_FFFF
    contact_skin: float = 0.0
    active_events: int = 0
    active_hooks: int = 0
    contact_force_event_threshold: float = float("inf")
    enabled: bool = True
    user_data: int = 0
    active_collision_types: int = ACTIVE_COLLISION_TYPES_DEFAULT
    # (vertices [V, 3] float32, triangles [T, 3] int32) of a mesh collider.
    mesh: Optional[tuple] = field(default=None, repr=False, compare=False)
    # The point cloud ``[N, 3]`` of a CONVEX collider (its hull is built with
    # the scene) and the hull's border radius.
    hull_points: Optional[np.ndarray] = field(default=None, repr=False, compare=False)
    hull_border: float = 0.0
    # (translation, rotation, ColliderBuilder) children of a compound,
    # expanded into leaf colliders by PhysicsWorld.insert_collider.
    children: Optional[list] = field(default=None, repr=False, compare=False)

    @staticmethod
    def ball(radius) -> "ColliderBuilder":
        return ColliderBuilder(ShapeType.BALL, (float(radius),))

    @staticmethod
    def cuboid(hx, hy, hz) -> "ColliderBuilder":
        return ColliderBuilder(ShapeType.CUBOID, (float(hx), float(hy), float(hz)))

    @staticmethod
    def round_cuboid(hx, hy, hz, border_radius) -> "ColliderBuilder":
        return ColliderBuilder(ShapeType.ROUND_CUBOID, (float(hx), float(hy), float(hz),
                                                        float(border_radius)))

    @staticmethod
    def capsule_x(half_height, radius) -> "ColliderBuilder":
        hh = float(half_height)
        return ColliderBuilder(
            ShapeType.CAPSULE, (-hh, 0.0, 0.0, hh, 0.0, 0.0, float(radius)))

    @staticmethod
    def capsule_y(half_height, radius) -> "ColliderBuilder":
        hh = float(half_height)
        return ColliderBuilder(
            ShapeType.CAPSULE, (0.0, -hh, 0.0, 0.0, hh, 0.0, float(radius)))

    @staticmethod
    def capsule_z(half_height, radius) -> "ColliderBuilder":
        hh = float(half_height)
        return ColliderBuilder(
            ShapeType.CAPSULE, (0.0, 0.0, -hh, 0.0, 0.0, hh, float(radius)))

    @staticmethod
    def capsule_from_endpoints(a, b, radius) -> "ColliderBuilder":
        a = tuple(float(x) for x in a)
        b = tuple(float(x) for x in b)
        return ColliderBuilder(ShapeType.CAPSULE, a + b + (float(radius),))

    @staticmethod
    def segment(a, b) -> "ColliderBuilder":
        a = tuple(float(x) for x in a)
        b = tuple(float(x) for x in b)
        return ColliderBuilder(ShapeType.SEGMENT, a + b)

    @staticmethod
    def halfspace(normal) -> "ColliderBuilder":
        n = np.asarray(normal, dtype=np.float64)
        return ColliderBuilder(ShapeType.HALFSPACE, tuple(n / np.linalg.norm(n)))

    @staticmethod
    def cylinder(half_height, radius) -> "ColliderBuilder":
        """A cylinder about the local Y axis."""
        return ColliderBuilder(ShapeType.CYLINDER, (float(half_height), float(radius)))

    @staticmethod
    def round_cylinder(half_height, radius, border_radius) -> "ColliderBuilder":
        return ColliderBuilder(ShapeType.ROUND_CYLINDER,
                               (float(half_height), float(radius), float(border_radius)))

    @staticmethod
    def cone(half_height, radius) -> "ColliderBuilder":
        """A cone about the local Y axis: its base at -half_height, its apex
        at +half_height."""
        return ColliderBuilder(ShapeType.CONE, (float(half_height), float(radius)))

    @staticmethod
    def round_cone(half_height, radius, border_radius) -> "ColliderBuilder":
        return ColliderBuilder(ShapeType.ROUND_CONE,
                               (float(half_height), float(radius), float(border_radius)))

    @staticmethod
    def convex_hull(points) -> "ColliderBuilder":
        """The convex hull of a point cloud, computed when the scene is built
        (scipy.spatial.ConvexHull), decimated to MAX_HULL_VERTS support
        vertices and shared through the scene's hull table."""
        return ColliderBuilder(ShapeType.CONVEX, (),
                               hull_points=np.asarray(points, np.float64).reshape(-1, 3))

    @staticmethod
    def round_convex_hull(points, border_radius) -> "ColliderBuilder":
        cb = ColliderBuilder.convex_hull(points)
        cb.hull_border = float(border_radius)
        return cb

    @staticmethod
    def convex_mesh(vertices) -> "ColliderBuilder":
        """Vertices known to be convex: their hull, as `convex_hull`."""
        return ColliderBuilder.convex_hull(vertices)

    @staticmethod
    def compound(children) -> "ColliderBuilder":
        """A compound of child colliders, ``[(translation, rotation,
        ColliderBuilder), ...]``: expanded into colliders on the same body
        when inserted."""
        return ColliderBuilder(ShapeType.COMPOUND, (), children=[
            (tuple(t), _as_quat(r), child) for (t, r, child) in children])

    @staticmethod
    def polyline(points) -> "ColliderBuilder":
        """A polyline: one SEGMENT collider per consecutive pair of points."""
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        return ColliderBuilder(ShapeType.COMPOUND, (), children=[
            ((0.0, 0.0, 0.0), _IDQ, ColliderBuilder.segment(pts[i], pts[i + 1]))
            for i in range(len(pts) - 1)])

    @staticmethod
    def voxels(centers, voxel_size) -> "ColliderBuilder":
        """Cubes of edge `voxel_size` at `centers`, merged greedily into
        boxes along runs in x (rows ordered by y, then z, then x), each box a
        cuboid collider when inserted."""
        size = float(voxel_size)
        half = size / 2.0
        keys = np.round(np.asarray(centers, np.float64).reshape(-1, 3) / size).astype(np.int64)
        keys = keys[np.lexsort((keys[:, 0], keys[:, 2], keys[:, 1]))]
        children = []
        i = 0
        while i < len(keys):
            j = i
            while (j + 1 < len(keys) and keys[j + 1][1] == keys[i][1]
                   and keys[j + 1][2] == keys[i][2] and keys[j + 1][0] == keys[j][0] + 1):
                j += 1
            run = keys[i:j + 1].astype(np.float64) * size
            hx = half + (run[-1][0] - run[0][0]) / 2.0
            children.append((tuple(run.mean(axis=0)), _IDQ,
                             ColliderBuilder.cuboid(hx, half, half)))
            i = j + 1
        return ColliderBuilder(ShapeType.COMPOUND, (), children=children)

    @staticmethod
    def voxels_from_points(points, voxel_size) -> "ColliderBuilder":
        """The voxels holding the points of a cloud."""
        size = float(voxel_size)
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        keys = np.unique(np.round(pts / size).astype(np.int64), axis=0)
        return ColliderBuilder.voxels(keys.astype(np.float64) * size, size)

    @staticmethod
    def convex_decomposition(vertices, indices, max_parts: int = 8) -> "ColliderBuilder":
        """An approximate convex decomposition of a triangle mesh, as the
        reference computes it: k-means (seeded, 12 rounds) of the triangle
        centroids into at most `max_parts` clusters, one convex hull of each
        cluster's vertices (clusters of fewer than 4 vertices dropped)."""
        v = np.asarray(vertices, np.float64).reshape(-1, 3)
        t = np.asarray(indices, np.int64).reshape(-1, 3)
        cent = v[t].mean(axis=1)
        k = min(max_parts, len(t))
        rng = np.random.RandomState(0)
        centers = cent[rng.choice(len(cent), k, replace=False)]
        for _ in range(12):
            d2 = ((cent[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            assign = d2.argmin(axis=1)
            for ci in range(k):
                sel = cent[assign == ci]
                if len(sel):
                    centers[ci] = sel.mean(axis=0)
        children = []
        for ci in range(k):
            tri_sel = t[assign == ci]
            if len(tri_sel) == 0:
                continue
            pts = v[np.unique(tri_sel)]
            if len(pts) < 4:
                continue
            children.append(((0.0, 0.0, 0.0), _IDQ, ColliderBuilder.convex_hull(pts)))
        return ColliderBuilder(ShapeType.COMPOUND, (), children=children)

    @staticmethod
    def trimesh(vertices, indices) -> "ColliderBuilder":
        """Triangle mesh collider: vertices ``(V, 3)``, indices ``(T, 3)``, in
        the collider's frame."""
        return ColliderBuilder(ShapeType.TRIMESH, (), mesh=(
            np.asarray(vertices, np.float32), np.asarray(indices, np.int32)))

    @staticmethod
    def heightfield(heights, scale) -> "ColliderBuilder":
        """Heightfield collider, triangulated here (the reference's
        HeightField::to_trimesh path): heights ``(nrows, ncols)``; scale
        ``(sx, sy, sz)`` the full extents.  The field spans [-sx/2, sx/2] x
        [-sz/2, sz/2] about the collider origin, rows along z and columns
        along x, at y = height * sy; each cell is two triangles."""
        h = np.asarray(heights, np.float64)
        nr, nc = h.shape
        sx, sy, sz = (float(v) for v in scale)
        xs = np.linspace(-sx / 2, sx / 2, nc)
        zs = np.linspace(-sz / 2, sz / 2, nr)
        verts = np.zeros((nr * nc, 3), np.float32)
        for r in range(nr):
            for c in range(nc):
                verts[r * nc + c] = (xs[c], h[r, c] * sy, zs[r])
        tris = []
        for r in range(nr - 1):
            for c in range(nc - 1):
                i00, i01 = r * nc + c, r * nc + c + 1
                i10, i11 = (r + 1) * nc + c, (r + 1) * nc + c + 1
                tris.append((i00, i10, i01))
                tris.append((i01, i10, i11))
        return ColliderBuilder(ShapeType.HEIGHTFIELD, (),
                               mesh=(verts, np.asarray(tris, np.int32)))

    def _set(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        return self

    def with_friction(self, f):
        return self._set(friction=float(f))

    def with_restitution(self, r):
        return self._set(restitution=float(r))

    def with_density(self, d):
        return self._set(density=float(d))

    def with_translation(self, xyz):
        return self._set(translation=tuple(xyz))

    def with_rotation(self, rot):
        return self._set(rotation=tuple(np.asarray(_as_quat(rot))))

    def as_sensor(self):
        return self._set(sensor=True)

    def with_collision_groups(self, groups: int):
        return self._set(collision_groups=int(groups))

    def with_solver_groups(self, groups: int):
        return self._set(solver_groups=int(groups))

    def with_active_events(self, flags: int):
        return self._set(active_events=int(flags))

    def with_contact_force_event_threshold(self, thr: float):
        return self._set(contact_force_event_threshold=float(thr))

    def with_contact_skin(self, skin: float):
        return self._set(contact_skin=float(skin))


def _np_quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _np_quat_rotate(q, v):
    u, w = np.asarray(q[:3]), q[3]
    t = 2.0 * np.cross(u, v)
    return np.asarray(v) + w * t + np.cross(u, t)


def _build_hull(points, max_verts):
    """The convex hull of a point cloud, decimated to at most `max_verts`
    support vertices (the extreme points along a Fibonacci sphere of
    directions when it has more), as the reference builds it.  Returns
    (padded [max_verts, 3] float32, the unused slots repeating the first
    vertex; faces [F, 3] into the decimated vertices; those vertices; the
    local AABB's min and max)."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(points, np.float64).reshape(-1, 3)
    verts = pts[ConvexHull(pts).vertices]
    if len(verts) > max_verts:
        k = np.arange(max_verts, dtype=np.float64)
        phi = np.pi * (3.0 - np.sqrt(5.0))
        y = 1.0 - 2.0 * (k + 0.5) / max_verts
        r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
        dirs = np.stack([r * np.cos(phi * k), y, r * np.sin(phi * k)], axis=1)
        verts = verts[np.unique(np.argmax(dirs @ verts.T, axis=1))]
    verts = verts[np.unique(ConvexHull(verts).simplices)]
    faces = ConvexHull(verts).simplices
    padded = np.zeros((max_verts, 3), np.float32)
    padded[: len(verts)] = verts
    padded[len(verts):] = verts[0]
    return (padded, faces.astype(np.int32), verts.astype(np.float32),
            verts.min(axis=0), verts.max(axis=0))


def _quat_from_x_axis(axis) -> np.ndarray:
    """Shortest-arc quaternion rotating +X onto `axis` (joint frame setup)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    x = np.array([1.0, 0.0, 0.0])
    c = np.cross(x, a)
    d = float(np.dot(x, a))
    if d < -1.0 + 1e-9:
        return np.array([0.0, 0.0, 1.0, 0.0])  # pi around z
    q = np.array([c[0], c[1], c[2], 1.0 + d])
    return q / np.linalg.norm(q)


_ALL_AXES = 0b111111
_LIN_AXES = 0b000111


@dataclass
class GenericJointBuilder:
    """Axis-based joint description (reference GenericJointBuilder,
    generic_joint.rs:653-806), for impulse joints and reduced-coordinate
    multibody joints.  Axes 0-2 are linear, 3-5 angular, in the joint frame;
    for a multibody joint a free slot of `locked_axes` is a generalized dof.
    The typed constructors mirror FixedJoint, RevoluteJoint (the hinge on the
    frame's X axis), PrismaticJoint, SphericalJoint, RopeJoint and
    SpringJoint."""

    locked_axes: int = 0
    limit_axes: int = 0
    motor_axes: int = 0
    coupled_axes: int = 0
    local_anchor1: tuple = (0.0, 0.0, 0.0)
    local_anchor2: tuple = (0.0, 0.0, 0.0)
    local_frame_rot1: tuple = _IDQ
    local_frame_rot2: tuple = _IDQ
    limit_min: tuple = tuple([-float("inf")] * 6)
    limit_max: tuple = tuple([float("inf")] * 6)
    motor_target_pos: tuple = tuple([0.0] * 6)
    motor_target_vel: tuple = tuple([0.0] * 6)
    motor_stiffness: tuple = tuple([0.0] * 6)
    motor_damping: tuple = tuple([0.0] * 6)
    motor_max_force: tuple = tuple([3.4e38] * 6)
    motor_model: tuple = tuple([0] * 6)
    contacts_enabled: bool = True
    # Per-dof passive elements of the articulation.
    armature: tuple = tuple([0.0] * 6)
    mb_damping: tuple = tuple([0.0] * 6)
    mb_spring_stiffness: tuple = tuple([0.0] * 6)
    mb_spring_ref: tuple = tuple([0.0] * 6)

    @staticmethod
    def fixed() -> "GenericJointBuilder":
        return GenericJointBuilder(locked_axes=_ALL_AXES)

    @staticmethod
    def revolute(axis) -> "GenericJointBuilder":
        q = tuple(_quat_from_x_axis(axis))
        return GenericJointBuilder(locked_axes=_ALL_AXES & ~(1 << 3),
                                   local_frame_rot1=q, local_frame_rot2=q)

    @staticmethod
    def prismatic(axis) -> "GenericJointBuilder":
        q = tuple(_quat_from_x_axis(axis))
        return GenericJointBuilder(locked_axes=_ALL_AXES & ~(1 << 0),
                                   local_frame_rot1=q, local_frame_rot2=q)

    @staticmethod
    def spherical() -> "GenericJointBuilder":
        return GenericJointBuilder(locked_axes=_LIN_AXES)

    @staticmethod
    def rope(max_length: float) -> "GenericJointBuilder":
        b = GenericJointBuilder(coupled_axes=_LIN_AXES, limit_axes=1 << 0)
        return b._set_axis("limit_max", 0, float(max_length))

    @staticmethod
    def spring(rest_length: float, stiffness: float, damping: float) -> "GenericJointBuilder":
        b = GenericJointBuilder(coupled_axes=_LIN_AXES, motor_axes=1 << 0)
        b._set_axis("motor_target_pos", 0, float(rest_length))
        b._set_axis("motor_stiffness", 0, float(stiffness))
        return b._set_axis("motor_damping", 0, float(damping))

    def _set_axis(self, field_name, axis, value):
        cur = list(getattr(self, field_name))
        cur[axis] = value
        setattr(self, field_name, tuple(cur))
        return self

    def with_local_anchor1(self, p):
        self.local_anchor1 = tuple(p)
        return self

    def with_local_anchor2(self, p):
        self.local_anchor2 = tuple(p)
        return self

    def with_limits(self, axis: int, lo: float, hi: float):
        self.limit_axes |= 1 << axis
        self._set_axis("limit_min", axis, float(lo))
        return self._set_axis("limit_max", axis, float(hi))

    def with_motor_velocity(self, axis: int, target_vel: float, damping: float):
        self.motor_axes |= 1 << axis
        self._set_axis("motor_target_vel", axis, float(target_vel))
        return self._set_axis("motor_damping", axis, float(damping))

    def with_motor_position(self, axis: int, target_pos: float,
                            stiffness: float, damping: float):
        self.motor_axes |= 1 << axis
        self._set_axis("motor_target_pos", axis, float(target_pos))
        self._set_axis("motor_stiffness", axis, float(stiffness))
        return self._set_axis("motor_damping", axis, float(damping))

    def with_motor_max_force(self, axis: int, force: float):
        return self._set_axis("motor_max_force", axis, float(force))

    def with_contacts_enabled(self, enabled: bool):
        self.contacts_enabled = bool(enabled)
        return self

    def with_swing_limits(self, lo: float, hi: float, twist_axis: int = 0):
        """Spherical swing limit: bounds the arc angle between the two
        frames' `twist_axis` (the coupled angular limit row,
        joint_constraint_builder.rs:814)."""
        for a in {0: (1, 2), 1: (0, 2), 2: (0, 1)}[twist_axis]:
            self.coupled_axes |= 1 << (3 + a)
            self.limit_axes |= 1 << (3 + a)
            self._set_axis("limit_min", 3 + a, float(lo))
            self._set_axis("limit_max", 3 + a, float(hi))
        return self


def FixedJointBuilder():
    return GenericJointBuilder.fixed()


def RevoluteJointBuilder(axis):
    return GenericJointBuilder.revolute(axis)


def PrismaticJointBuilder(axis):
    return GenericJointBuilder.prismatic(axis)


def SphericalJointBuilder():
    return GenericJointBuilder.spherical()


def RopeJointBuilder(max_length):
    return GenericJointBuilder.rope(max_length)


def SpringJointBuilder(rest_length, stiffness, damping):
    return GenericJointBuilder.spring(rest_length, stiffness, damping)


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


class PhysicsWorld:
    """Scene container + stepping facade (reference PhysicsWorld)."""

    def __init__(self, gravity=(0.0, -9.81, 0.0),
                 params: Optional[SimParams] = None,
                 max_pairs: Optional[int] = None,
                 body_capacity: Optional[int] = None,
                 collider_capacity: Optional[int] = None,
                 device="cuda"):
        self._pending_bodies: list[RigidBodyBuilder] = []
        self._pending_colliders: list[tuple[ColliderBuilder, int]] = []
        # (joint, body1, body2)
        self._pending_joints: list[tuple] = []
        # (joint, parent body, child body, kinematic)
        self._pending_mb_joints: list[tuple] = []
        self._mb_trees: list[list[int]] = []
        self.params = params if params is not None else SimParams()
        self.params = self.params.replace(gravity=np.asarray(gravity, np.float32))
        self._max_pairs = max_pairs
        self._body_capacity = body_capacity
        self._collider_capacity = collider_capacity
        self.device = torch.device(device)
        self.state: Optional[SceneState] = None   # batch of one, on `device`
        self.last_events = None

    def insert_body(self, builder: RigidBodyBuilder) -> int:
        assert self.state is None, "world already built"
        self._pending_bodies.append(builder)
        return len(self._pending_bodies) - 1

    def _expand_collider(self, builder: ColliderBuilder):
        """The leaf colliders of a builder: itself, or a compound's children
        (recursively) with their local transforms composed onto its own."""
        if builder.children is None:
            return [builder]
        out = []
        pt = np.asarray(builder.translation, np.float64)
        pr = np.asarray(builder.rotation, np.float64)
        for (ct, cr, child) in builder.children:
            for leaf in self._expand_collider(child):
                leaf = copy.copy(leaf)
                t = pt + _np_quat_rotate(pr, np.asarray(ct, np.float64))
                r = _np_quat_mul(pr, np.asarray(cr, np.float64))
                lt = np.asarray(leaf.translation, np.float64)
                lr = np.asarray(leaf.rotation, np.float64)
                leaf.translation = tuple(t + _np_quat_rotate(r, lt))
                leaf.rotation = tuple(_np_quat_mul(r, lr))
                out.append(leaf)
        return out

    def insert_collider(self, builder: ColliderBuilder, body: int = -1) -> int:
        """Insert a collider (a compound as its leaves, in order) on `body`;
        returns the index of the first."""
        assert self.state is None, "world already built"
        first = len(self._pending_colliders)
        for leaf in self._expand_collider(builder):
            self._pending_colliders.append((leaf, body))
        return first

    def insert(self, body_builder: RigidBodyBuilder, *collider_builders) -> int:
        h = self.insert_body(body_builder)
        for cb in collider_builders:
            self.insert_collider(cb, h)
        return h

    def insert_impulse_joint(self, body1: int, body2: int,
                             joint: GenericJointBuilder) -> int:
        """Join `body2` to `body1` through an impulse joint (solved beside the
        contacts); returns the joint's index."""
        assert self.state is None, "world already built"
        self._pending_joints.append((joint, body1, body2))
        return len(self._pending_joints) - 1

    def insert_multibody_joint(self, body1: int, body2: int,
                               joint: GenericJointBuilder,
                               kinematic: bool = False) -> int:
        """Attach `body2` to `body1` through a reduced-coordinate multibody
        joint; build() groups the edges into articulation trees."""
        assert self.state is None, "world already built"
        self._pending_mb_joints.append((joint, body1, body2, kinematic))
        return len(self._pending_mb_joints) - 1

    def build(self) -> SceneState:
        """Freeze the pending builders into a `SceneState` with numpy leaves
        (one scene, no leading axis), exactly as the reference's build()."""
        nb = len(self._pending_bodies)
        nc = len(self._pending_colliders)
        n_cap = self._body_capacity or _round_up(nb, 8)
        c_cap = self._collider_capacity or _round_up(nc, 8)
        has_meshes = any(cb.mesh is not None for cb, _ in self._pending_colliders)
        mesh_lanes = (self.params.max_mesh_pairs * self.params.tris_per_pair
                      if has_meshes else 0)
        p_cap = self._max_pairs or _round_up(max(8 * nc, 64), 128) + mesh_lanes
        if any(bb.ccd_enabled for bb in self._pending_bodies):
            raise NotImplementedError("CCD is not ported")

        if self.params.max_solver_pairs == 0 and nc > 2048:
            cap = _round_up(4 * nc, 128)
            if cap < p_cap:
                self.params = self.params.replace(max_solver_pairs=cap)
        extra_iters = max(
            (bb.additional_solver_iterations for bb in self._pending_bodies),
            default=0)
        if extra_iters > 0 and not getattr(self, "_extra_iters_folded", False):
            self._extra_iters_folded = True
            self.params = self.params.replace(
                num_solver_iterations=self.params.num_solver_iterations
                + int(extra_iters))

        b0 = empty_bodies(n_cap)
        c0 = empty_colliders(c_cap)
        bodies = {k: np.asarray(v).copy() for k, v in vars(b0).items()}
        colliders = {k: np.asarray(v).copy() for k, v in vars(c0).items()}
        body_parts: dict[int, list] = {i: [] for i in range(nb)}
        meshes, mesh_ranges = self._build_meshes(c_cap)
        hulls, hull_info = self._build_hulls()

        for i, (cb, parent) in enumerate(self._pending_colliders):
            prm = np.zeros(12, np.float32)
            prm[: len(cb.shape_params)] = cb.shape_params
            if i in mesh_ranges:
                start, count, lo, hi = mesh_ranges[i]
                prm[0], prm[1] = start, count
                prm[2:5] = lo
                prm[5:8] = hi
            if i in hull_info:
                hidx, _faces, _verts, bb_min, bb_max = hull_info[i]
                prm[0], prm[1] = hidx, cb.hull_border
                prm[2:5] = bb_min
                prm[5:8] = bb_max
            colliders["parent"][i] = parent
            colliders["local_pos"][i] = cb.translation
            colliders["local_rot"][i] = _as_quat(cb.rotation)
            colliders["shape_type"][i] = int(cb.shape_type)
            colliders["shape_params"][i] = prm
            colliders["friction"][i] = cb.friction
            colliders["restitution"][i] = cb.restitution
            colliders["friction_combine"][i] = int(cb.friction_combine_rule)
            colliders["restitution_combine"][i] = int(cb.restitution_combine_rule)
            colliders["collision_groups"][i] = cb.collision_groups
            colliders["solver_groups"][i] = cb.solver_groups
            colliders["sensor"][i] = cb.sensor
            colliders["enabled"][i] = cb.enabled
            colliders["contact_skin"][i] = cb.contact_skin
            colliders["active_events"][i] = cb.active_events
            colliders["active_hooks"][i] = cb.active_hooks
            colliders["contact_force_event_threshold"][i] = (
                cb.contact_force_event_threshold)
            colliders["user_data"][i] = cb.user_data
            colliders["active_collision_types"][i] = cb.active_collision_types
            if parent >= 0 and not cb.sensor:
                if i in hull_info:
                    _h, faces, verts, _lo, _hi = hull_info[i]
                    smp = mp.mesh_mass_properties(verts, faces, cb.density,
                                                  assume_convex=True)
                elif cb.mesh is not None:
                    smp = mp.mesh_mass_properties(*cb.mesh, cb.density)
                else:
                    smp = mp.shape_mass_properties(int(cb.shape_type), prm, cb.density)
                if cb.mass is not None and smp.mass > 0:
                    scale = cb.mass / smp.mass
                    smp = mp.MassProperties(
                        cb.mass, smp.com, smp.principal_inertia * scale,
                        smp.principal_frame)
                body_parts[parent].append(
                    (smp, np.asarray(cb.translation, np.float64),
                     _as_quat(cb.rotation)))

        for i, bb in enumerate(self._pending_bodies):
            q = _as_quat(bb.rotation)
            bodies["pos"][i] = bb.translation
            bodies["rot"][i] = q
            bodies["next_pos"][i] = bb.translation
            bodies["next_rot"][i] = q
            bodies["linvel"][i] = bb.linvel
            bodies["angvel"][i] = bb.angvel
            bodies["body_type"][i] = int(bb.body_type)
            bodies["enabled"][i] = bb.enabled
            bodies["locked_axes"][i] = bb.locked_axes
            bodies["gravity_scale"][i] = bb.gravity_scale
            bodies["linear_damping"][i] = bb.linear_damping
            bodies["angular_damping"][i] = bb.angular_damping
            bodies["dominance"][i] = bb.dominance_group
            bodies["gyro_enabled"][i] = bb.gyroscopic_forces_enabled
            bodies["can_sleep"][i] = bb.can_sleep
            bodies["sleeping"][i] = bb.sleeping
            bodies["sleep_timer"][i] = 2.0 if bb.sleeping else 0.0
            bodies["ccd_enabled"][i] = bb.ccd_enabled
            bodies["soft_ccd_prediction"][i] = bb.soft_ccd_prediction
            bodies["user_data"][i] = bb.user_data
            if bb.body_type == BodyType.DYNAMIC:
                combined = mp.combine(body_parts[i])
                total_mass = combined.mass + bb.additional_mass
                if total_mass > 0:
                    bodies["inv_mass"][i] = 1.0 / total_mass
                    bodies["local_com"][i] = combined.com
                    inertia = combined.principal_inertia
                    if bb.additional_mass > 0 and combined.mass > 0:
                        inertia = inertia * (total_mass / combined.mass)
                    with np.errstate(divide="ignore"):
                        inv_i = np.where(inertia > 0, 1.0 / inertia, 0.0)
                    bodies["inv_principal_inertia"][i] = inv_i
                    bodies["principal_frame"][i] = combined.principal_frame

        mb_state = self._build_multibodies(bodies) if self._pending_mb_joints else None
        state = SceneState(
            bodies=Bodies(**bodies), colliders=Colliders(**colliders),
            contacts=empty_contacts(p_cap, per_point_tangent=(
                self.params.friction_model == int(FrictionModel.COULOMB))),
            multibodies=mb_state,
            joints=self._build_joints(bodies) if self._pending_joints else None,
            meshes=meshes, hulls=hulls)
        census = Counter(int(cb.shape_type) for cb, _ in self._pending_colliders)
        self.params = self.params.replace(
            shape_types_present=tuple(sorted(census.items())))

        from rapier_tpu_torch.scenes import replicate_scene

        self.state = from_numpy(replicate_scene(state, 1), self.device)
        if state.joints is not None:
            self.params = self.params.replace(joint_slots=used_slots(self.state.joints))
        return state

    def _build_meshes(self, c_cap: int):
        """The mesh colliders' shared tables (vertices and triangles each
        padded to a multiple of 8, triangle rows -1) and each mesh collider's
        (tri_start, tri_count, local lo, local hi); (None, {}) without a
        mesh.  The mesh pair keys, ``lo * C + hi + (tri + 1) * C**2``, are
        int32: the reference computes them in int32 arithmetic, which wraps
        past 2**31 (dispatch.py:762-765), and the port's int64 keys wrap the
        same way when cast, so both hold the same keys (a wrapped key is
        negative, and neither package's cache matches it: ROADMAP R12).
        Refuses a scene whose keys would pass 2**32 and repeat."""
        verts, tris, ranges = [], [], {}
        tri_cursor = vert_cursor = 0
        for i, (cb, _parent) in enumerate(self._pending_colliders):
            if cb.mesh is None:
                continue
            v, t = cb.mesh
            verts.append(v)
            tris.append(t + vert_cursor)
            ranges[i] = (tri_cursor, len(t), v.min(axis=0), v.max(axis=0))
            tri_cursor += len(t)
            vert_cursor += len(v)
        if not verts:
            return None, ranges
        all_v, all_t = np.concatenate(verts), np.concatenate(tris)
        t_cap = _round_up(len(all_t), 8)
        if c_cap * c_cap * (t_cap + 1) >= 2**32:
            raise NotImplementedError(
                f"{c_cap} colliders and {t_cap} triangles: mesh pair keys would repeat in "
                f"int32 (C**2 * (T + 1) = {c_cap * c_cap * (t_cap + 1)} >= 2**32)")
        vpad = np.zeros((_round_up(len(all_v), 8), 3), np.float32)
        vpad[: len(all_v)] = all_v
        tpad = np.full((t_cap, 3), -1, np.int32)
        tpad[: len(all_t)] = all_t
        return MeshData(vertices=vpad, triangles=tpad), ranges

    def _build_hulls(self):
        """The convex hulls' shared table ``[H, MAX_HULL_VERTS, 3]`` (None
        without a hull) and each CONVEX collider's (hull index, faces,
        decimated vertices, local AABB min, max)."""
        slots, info = [], {}
        for i, (cb, _parent) in enumerate(self._pending_colliders):
            if cb.hull_points is None:
                continue
            padded, faces, verts, lo, hi = _build_hull(cb.hull_points, MAX_HULL_VERTS)
            info[i] = (len(slots), faces, verts, lo, hi)
            slots.append(padded)
        if not slots:
            return None, info
        return ConvexHulls(vertices=np.stack(slots).astype(np.float32)), info

    def _build_joints(self, bodies) -> Joints:
        """The impulse-joint table, J rounded up to 8, with the local anchors
        shifted into COM space (transform_to_solver_body_space,
        joint_constraint_builder.rs:60)."""
        j0 = empty_joints(_round_up(len(self._pending_joints), 8))
        arr = {k: np.asarray(v).copy() for k, v in vars(j0).items()}
        for i, (jb, b1, b2) in enumerate(self._pending_joints):
            arr["body1"][i] = b1
            arr["body2"][i] = b2
            arr["local_pos1"][i] = np.asarray(jb.local_anchor1) - bodies["local_com"][b1]
            arr["local_pos2"][i] = np.asarray(jb.local_anchor2) - bodies["local_com"][b2]
            arr["local_rot1"][i] = _as_quat(jb.local_frame_rot1)
            arr["local_rot2"][i] = _as_quat(jb.local_frame_rot2)
            for name in ("locked_axes", "limit_axes", "motor_axes", "coupled_axes",
                         "limit_min", "limit_max", "motor_target_pos", "motor_target_vel",
                         "motor_stiffness", "motor_damping", "motor_model",
                         "contacts_enabled"):
                arr[name][i] = getattr(jb, name)
            arr["motor_max_force"][i] = np.minimum(jb.motor_max_force, 3.4e38)
            arr["enabled"][i] = True
        return Joints(**arr)

    def _build_multibodies(self, bodies):
        """Group the multibody-joint edges into articulation trees (BFS order,
        parents first) and fill a `Multibodies` table with numpy leaves; the
        link bodies become kinematic-position-based (FK drives their poses)
        and enter the contact solve as multibody links."""
        from rapier_tpu_torch.dynamics.multibody import Multibodies, empty_multibodies

        children: dict[int, list[int]] = {}
        child_joint: dict[int, tuple] = {}
        for (jb, b1, b2, kin) in self._pending_mb_joints:
            assert b2 not in child_joint, f"body {b2} attached to two multibody parents"
            children.setdefault(b1, []).append(b2)
            child_joint[b2] = (jb, b1, kin)
        trees = []
        for r in sorted(b for b in children if b not in child_joint):
            order, queue = [r], [r]
            while queue:
                for ch in children.get(queue.pop(0), []):
                    order.append(ch)
                    queue.append(ch)
            trees.append(order)

        mb0 = empty_multibodies(len(trees), max(len(t) for t in trees))
        arr = {k: np.asarray(v).copy() for k, v in vars(mb0).items()}
        for ti, order in enumerate(trees):
            body_to_link = {b: i for i, b in enumerate(order)}
            for li, b in enumerate(order):
                arr["link_valid"][ti, li] = True
                arr["link_body"][ti, li] = b
                bodies["mb_link"][b] = True
                if li == 0:
                    if bodies["body_type"][b] == int(BodyType.DYNAMIC):
                        # Free root: 6 dofs whose coords carry the world pose.
                        arr["locked_axes"][ti, li] = 0
                        arr["q"][ti, li, :3] = bodies["pos"][b]
                        arr["joint_rot"][ti, li] = bodies["rot"][b]
                    else:
                        arr["locked_axes"][ti, li] = 0b111111
                    continue
                jb, parent_b, kin = child_joint[b]
                arr["link_parent"][ti, li] = body_to_link[parent_b]
                arr["locked_axes"][ti, li] = jb.locked_axes
                arr["kinematic"][ti, li] = kin
                arr["contacts_enabled"][ti, li] = jb.contacts_enabled
                arr["local_pos1"][ti, li] = jb.local_anchor1
                arr["local_rot1"][ti, li] = _as_quat(jb.local_frame_rot1)
                arr["local_pos2"][ti, li] = jb.local_anchor2
                arr["local_rot2"][ti, li] = _as_quat(jb.local_frame_rot2)
                arr["armature"][ti, li] = jb.armature
                arr["damping"][ti, li] = jb.mb_damping
                arr["spring_stiffness"][ti, li] = jb.mb_spring_stiffness
                arr["spring_ref"][ti, li] = jb.mb_spring_ref
                for a in range(6):
                    if jb.limit_axes & (1 << a):
                        arr["limit_min"][ti, li, a] = jb.limit_min[a]
                        arr["limit_max"][ti, li, a] = jb.limit_max[a]
                    if jb.motor_axes & (1 << a):
                        arr["motor_target_pos"][ti, li, a] = jb.motor_target_pos[a]
                        arr["motor_target_vel"][ti, li, a] = jb.motor_target_vel[a]
                        arr["motor_stiffness"][ti, li, a] = jb.motor_stiffness[a]
                        arr["motor_damping"][ti, li, a] = jb.motor_damping[a]
                        arr["motor_max_force"][ti, li, a] = min(jb.motor_max_force[a],
                                                                3.4e38)
                bodies["body_type"][b] = int(BodyType.KINEMATIC_POSITION_BASED)
            if bodies["body_type"][order[0]] == int(BodyType.DYNAMIC):
                bodies["body_type"][order[0]] = int(BodyType.KINEMATIC_POSITION_BASED)
        self._mb_trees = trees
        return Multibodies(**arr)

    def multibody_link_of(self, body: int) -> tuple:
        """(tree, link) slot of the articulation link driving `body`."""
        for ti, order in enumerate(self._mb_trees):
            if int(body) in order:
                return ti, order.index(int(body))
        raise KeyError(f"body {body} is not a multibody link")

    def multibody_q(self, tree: int = 0) -> np.ndarray:
        """``[L, 6]`` generalized coordinates of articulation `tree`."""
        return self.state.multibodies.q[0, tree].cpu().numpy()

    def multibody_qd(self, tree: int = 0) -> np.ndarray:
        """``[L, 6]`` generalized velocities of articulation `tree`."""
        return self.state.multibodies.qd[0, tree].reshape(-1, 6).cpu().numpy()

    def set_multibody_motor_targets(self, tree: int, link: int, axis: int,
                                    target_pos=None, target_vel=None):
        """Retarget one dof's motor (in place on the world's state)."""
        mb = self.state.multibodies
        if target_pos is not None:
            mb.motor_target_pos[0, tree, link, axis] = float(target_pos)
        if target_vel is not None:
            mb.motor_target_vel[0, tree, link, axis] = float(target_vel)

    def step(self, n: int = 1):
        from rapier_tpu_torch.pipeline.physics_pipeline import step as _step

        if self.state is None:
            self.build()
        for _ in range(n):
            self.state, self.last_events = _step(self.state, self.params)
        return self.state

    def body_translation(self, h: int) -> np.ndarray:
        return self.state.bodies.pos[0, int(h)].cpu().numpy()

    def body_rotation(self, h: int) -> np.ndarray:
        return self.state.bodies.rot[0, int(h)].cpu().numpy()

    def body_linvel(self, h: int) -> np.ndarray:
        return self.state.bodies.linvel[0, int(h)].cpu().numpy()

    def body_angvel(self, h: int) -> np.ndarray:
        return self.state.bodies.angvel[0, int(h)].cpu().numpy()

    def body_is_sleeping(self, h: int) -> bool:
        return bool(self.state.bodies.sleeping[0, int(h)])
