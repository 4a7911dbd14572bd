"""The 2D world: rapier2d's API on the 3D engine (counterpart of
rapier_tpu.world2d).

Every dynamic body is plane-locked (z translation, x and y rotations), so
2D scenes run on the 3D pipeline unchanged.  2D shapes become their extruded
3D shapes for collision, while `PhysicsWorld2D.build` gives each body the
true 2D mass properties (area density, a disc's I = m r^2 / 2).
`PhysicsWorld2D` solves 2-point manifolds with the 2x2 block solve
(`SimParams.block_solver_2x2`, BLOCK_SOLVER_ENABLED = dim2,
integration_parameters.rs:9).  Like `PhysicsWorld`, it steps on the CUDA
card unless the caller passes another `device`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rapier_tpu_torch.types import (
    JOINT_ANG_AXES,
    LOCK_ROTATION_X,
    LOCK_ROTATION_Y,
    LOCK_TRANSLATION_Z,
    BodyType,
)
from rapier_tpu_torch.world import (
    ColliderBuilder,
    GenericJointBuilder,
    PhysicsWorld,
    RigidBodyBuilder,
)

_PLANE_LOCK = LOCK_TRANSLATION_Z | LOCK_ROTATION_X | LOCK_ROTATION_Y
_DEPTH = 0.5  # half-thickness of the extruded 2D shapes


class RigidBodyBuilder2D(RigidBodyBuilder):
    """A body builder taking 2D translations, angles and velocities; its
    dynamic bodies are plane-locked."""

    @staticmethod
    def dynamic() -> "RigidBodyBuilder2D":
        return RigidBodyBuilder2D(BodyType.DYNAMIC, locked_axes=_PLANE_LOCK)

    @staticmethod
    def fixed() -> "RigidBodyBuilder2D":
        return RigidBodyBuilder2D(BodyType.FIXED)

    def with_translation(self, xy):
        x, y = xy
        return self._set(translation=(float(x), float(y), 0.0))

    def with_rotation_angle(self, angle):
        return self._set(rotation=(0.0, 0.0, math.sin(angle / 2), math.cos(angle / 2)))

    def with_linvel(self, v):
        return self._set(linvel=(float(v[0]), float(v[1]), 0.0))

    def with_angvel_scalar(self, w):
        return self._set(angvel=(0.0, 0.0, float(w)))


class ColliderBuilder2D:
    """2D shapes as extruded 3D shapes, each tagged (`_shape2d`) with its 2D
    form for `PhysicsWorld2D.build`'s mass properties."""

    @staticmethod
    def cuboid(hx, hy) -> ColliderBuilder:
        cb = ColliderBuilder.cuboid(hx, hy, _DEPTH)
        cb._shape2d = ("cuboid", (float(hx), float(hy)))
        return cb

    @staticmethod
    def ball(r) -> ColliderBuilder:
        cb = ColliderBuilder.ball(r)
        cb._shape2d = ("ball", (float(r),))
        return cb

    @staticmethod
    def capsule_x(hh, r) -> ColliderBuilder:
        cb = ColliderBuilder.capsule_x(hh, r)
        cb._shape2d = ("capsule", (float(hh), float(r), 0))
        return cb

    @staticmethod
    def capsule_y(hh, r) -> ColliderBuilder:
        cb = ColliderBuilder.capsule_y(hh, r)
        cb._shape2d = ("capsule", (float(hh), float(r), 1))
        return cb

    @staticmethod
    def halfspace(normal) -> ColliderBuilder:
        return ColliderBuilder.halfspace((normal[0], normal[1], 0.0))

    @staticmethod
    def segment(a, b) -> ColliderBuilder:
        """A 2D segment: the 3D segment in the z = 0 plane (untagged, so a
        body holding one keeps the 3D mass properties, as in the
        reference)."""
        return ColliderBuilder.segment((a[0], a[1], 0.0), (b[0], b[1], 0.0))

    @staticmethod
    def convex_hull(points) -> ColliderBuilder:
        """A 2D convex polygon: its vertices extruded to +-_DEPTH in z as a 3D
        convex hull for collision; the mass properties are the polygon's."""
        pts = [(float(x), float(y)) for x, y in points]
        cb = ColliderBuilder.convex_hull([(x, y, -_DEPTH) for x, y in pts]
                                         + [(x, y, _DEPTH) for x, y in pts])
        cb._shape2d = ("polygon", tuple(pts))
        return cb


def _mass_props_2d(kind: str, args, density: float):
    """(mass, I_z about the shape's centre, centroid offset) with AREA
    density (rapier2d's MassProperties), for a tag of `ColliderBuilder2D`.
    A polygon's centroid is its offset (its vertices are collider-local, not
    centred)."""
    if kind == "polygon":
        pts = np.asarray(args, float)
        # Counter-clockwise about the vertex mean (the input is a convex set).
        c0 = pts.mean(axis=0)
        pts = pts[np.argsort(np.arctan2(pts[:, 1] - c0[1], pts[:, 0] - c0[0]))]
        x, y = pts[:, 0], pts[:, 1]
        x2, y2 = np.roll(x, -1), np.roll(y, -1)
        cr = x * y2 - x2 * y
        area2 = np.sum(cr)                   # twice the area, > 0 counter-clockwise
        cx = np.sum((x + x2) * cr) / (3.0 * area2)
        cy = np.sum((y + y2) * cr) / (3.0 * area2)
        i_origin = density * np.sum(
            cr * (x * x + x * x2 + x2 * x2 + y * y + y * y2 + y2 * y2)) / 12.0
        m = density * (0.5 * area2)
        return m, i_origin - m * (cx * cx + cy * cy), (cx, cy)
    if kind == "ball":
        (r,) = args
        m = np.pi * r * r * density
        return m, 0.5 * m * r * r, (0.0, 0.0)
    if kind == "cuboid":
        hx, hy = args
        m = 4.0 * hx * hy * density
        return m, m * (hx * hx + hy * hy) / 3.0, (0.0, 0.0)
    if kind == "capsule":
        hh, r, _axis = args
        m_rect = 4.0 * hh * r * density
        m_disc = np.pi * r * r * density
        # The 2hh x 2r rectangle about its centre, and the two half-discs
        # as one full disc displaced by hh (exact to O(r / hh) of the
        # half-disc centroid offset), as the reference computes it.
        i_rect = m_rect * (hh * hh + r * r) / 3.0
        i_disc = 0.5 * m_disc * r * r + m_disc * hh * hh
        return m_rect + m_disc, i_rect + i_disc, (0.0, 0.0)
    raise KeyError(kind)


class PhysicsWorld2D(PhysicsWorld):
    """The 2D facade over the plane-locked 3D world."""

    def __init__(self, gravity=(0.0, -9.81), **kw):
        super().__init__(gravity=(gravity[0], gravity[1], 0.0), **kw)
        # 2D manifolds carry at most two points: solve them as one coupled
        # 2x2 MLCP.
        self.params = self.params.replace(block_solver_2x2=True)

    def insert_body(self, builder) -> int:
        if builder.body_type == BodyType.DYNAMIC:
            builder.locked_axes |= _PLANE_LOCK
        return super().insert_body(builder)

    def build(self):
        """`PhysicsWorld.build`, then the 2D mass properties of each dynamic
        body whose colliders are all 2D shapes and carry no mass override
        (reference world2d.py:177-228); other bodies keep the 3D values.
        Returns the numpy state; `self.state` holds the same on `device`."""
        state = super().build()
        per_body: dict[int, list] = {}
        tagged_ok: dict[int, bool] = {}
        for cb, parent in self._pending_colliders:
            if parent < 0 or cb.sensor:
                continue
            tag = getattr(cb, "_shape2d", None)
            tagged_ok[parent] = tagged_ok.get(parent, True) and tag is not None
            per_body.setdefault(parent, []).append((tag, cb))
        b = state.bodies
        for body, parts in per_body.items():
            if not tagged_ok[body] or b.body_type[body] != BodyType.DYNAMIC:
                continue
            if any(cb.mass is not None for _, cb in parts):
                continue      # an explicit mass wins (the 3D build applied it)
            props = []
            for tag, cb in parts:
                m, i_own, c_off = _mass_props_2d(tag[0], tag[1], cb.density)
                props.append((m, i_own, np.asarray(cb.translation[:2], float)
                              + np.asarray(c_off)))
            m_tot = sum(m for m, _, _ in props)
            if m_tot <= 0.0:
                continue
            com = np.array([sum(m * off[0] for m, _, off in props),
                            sum(m * off[1] for m, _, off in props)]) / m_tot
            i_tot = sum(i_own + m * float(np.sum((off - com) ** 2))
                        for m, i_own, off in props)
            iz = 1.0 / i_tot if i_tot > 0 else 0.0
            b.inv_mass[body] = 1.0 / m_tot
            b.local_com[body] = (com[0], com[1], 0.0)
            # The plane lock fixes the x and y spins; they get the z inertia
            # so that a stray torque stays bounded.
            b.inv_principal_inertia[body] = (iz, iz, iz)
            b.principal_frame[body] = (0.0, 0.0, 0.0, 1.0)
        for name in ("inv_mass", "local_com", "inv_principal_inertia", "principal_frame"):
            getattr(self.state.bodies, name)[0] = torch.from_numpy(getattr(b, name))
        return state

    def body_translation2(self, h) -> np.ndarray:
        return self.body_translation(h)[:2]

    def body_rotation_angle(self, h) -> float:
        q = self.body_rotation(h)
        return float(2.0 * np.arctan2(q[2], q[3]))

    def body_linvel2(self, h) -> np.ndarray:
        return self.body_linvel(h)[:2]


def revolute_joint_2d(anchor1=(0.0, 0.0), anchor2=(0.0, 0.0)) -> GenericJointBuilder:
    """A 2D revolute joint: the 3D revolute about +Z."""
    gb = GenericJointBuilder.revolute((0.0, 0.0, 1.0))
    gb.with_local_anchor1((anchor1[0], anchor1[1], 0.0))
    return gb.with_local_anchor2((anchor2[0], anchor2[1], 0.0))


def prismatic_joint_2d(axis=(1.0, 0.0), anchor1=(0.0, 0.0),
                       anchor2=(0.0, 0.0)) -> GenericJointBuilder:
    """A 2D prismatic joint: a slide along `axis`, rotation locked."""
    gb = GenericJointBuilder.prismatic((axis[0], axis[1], 0.0))
    gb.with_local_anchor1((anchor1[0], anchor1[1], 0.0))
    return gb.with_local_anchor2((anchor2[0], anchor2[1], 0.0))


def pin_slot_joint_2d(axis=(1.0, 0.0), anchor1=(0.0, 0.0),
                      anchor2=(0.0, 0.0)) -> GenericJointBuilder:
    """A 2D pin-slot joint (PinSlotJoint, pin_slot_joint.rs): the anchor
    slides along `axis` and turns freely; only the in-plane perpendicular
    translation is locked (and z, which the plane lock keeps exact)."""
    gb = prismatic_joint_2d(axis, anchor1, anchor2)
    gb.locked_axes &= ~JOINT_ANG_AXES
    return gb
