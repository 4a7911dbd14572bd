"""Host-side scene construction + a convenience stepping facade.

Counterpart of rapier_tpu.world: the `RigidBodyBuilder` / `ColliderBuilder`
builders (ball, cuboid, capsule, halfspace), `GenericJointBuilder` with its
typed forms for impulse joints and reduced-coordinate multibody joints, and
`PhysicsWorld`.  Building is plain
numpy and gives the same `SceneState` leaves as the reference's `build()`;
`step()` runs the port's batched pipeline on a batch of one scene on
`device`, the CUDA card unless the caller asks for another device.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
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
    Joints,
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

    @staticmethod
    def ball(radius) -> "ColliderBuilder":
        return ColliderBuilder(ShapeType.BALL, (float(radius),))

    @staticmethod
    def cuboid(hx, hy, hz) -> "ColliderBuilder":
        return ColliderBuilder(ShapeType.CUBOID, (float(hx), float(hy), float(hz)))

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
    def halfspace(normal) -> "ColliderBuilder":
        n = np.asarray(normal, dtype=np.float64)
        return ColliderBuilder(ShapeType.HALFSPACE, tuple(n / np.linalg.norm(n)))

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

    def insert_collider(self, builder: ColliderBuilder, body: int = -1) -> int:
        assert self.state is None, "world already built"
        self._pending_colliders.append((builder, body))
        return len(self._pending_colliders) - 1

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
        p_cap = self._max_pairs or _round_up(max(8 * nc, 64), 128)
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

        for i, (cb, parent) in enumerate(self._pending_colliders):
            prm = np.zeros(12, np.float32)
            prm[: len(cb.shape_params)] = cb.shape_params
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
            contacts=empty_contacts(p_cap), multibodies=mb_state,
            joints=self._build_joints(bodies) if self._pending_joints else None)
        census = Counter(int(cb.shape_type) for cb, _ in self._pending_colliders)
        self.params = self.params.replace(
            shape_types_present=tuple(sorted(census.items())))

        from rapier_tpu_torch.scenes import replicate_scene

        self.state = from_numpy(replicate_scene(state, 1), self.device)
        if state.joints is not None:
            self.params = self.params.replace(joint_slots=used_slots(self.state.joints))
        return state

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
