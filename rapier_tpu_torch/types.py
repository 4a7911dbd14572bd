"""Core SoA state dataclasses and simulation parameters.

Counterpart of `rapier_tpu.types`.  Every state field is a tensor (or, on
the host before the first step, a numpy array) with the reference's
per-scene shape; the port's step takes a leading scene axis ``[B, ...]`` on
every leaf instead of `vmap`.  Pair-lane fields keep the reference's
component-leading, lane-last layout (``[3, P]``, ``[4, 3, P]``).

`from_numpy` / `to_numpy` carry a reference `SceneState` or `SimParams`
(numpy leaves, e.g. from `rapier_tpu.world.PhysicsWorld.build()`) into the
port and back by field name, so the two packages exchange state without this
one importing JAX.  The `joints` slot (impulse joints, `Joints`), the
`multibodies` slot (reduced-coordinate articulations,
`dynamics.multibody.Multibodies`), the `meshes` slot (`MeshData`) and the
`hulls` slot (`ConvexHulls`) cross the same way.

``Colliders.shape_params`` rows follow the reference's table
(rapier_tpu.geometry.shapes): BALL ``[r]``, CUBOID ``[hx, hy, hz]``, CAPSULE
``[ax, ay, az, bx, by, bz, r]`` (segment endpoints in the collider frame),
HALFSPACE ``[nx, ny, nz]`` (outward unit normal of the plane through the
collider origin), SEGMENT ``[ax, ay, az, bx, by, bz]``, CYLINDER and CONE
``[hh, r]`` (axis local Y; a cone's base at -hh, apex at +hh), ROUND_CUBOID
``[hx, hy, hz, border]``, ROUND_CYLINDER and ROUND_CONE ``[hh, r, border]``,
TRIANGLE ``[a(3), b(3), c(3)]``, TRIMESH and HEIGHTFIELD ``[tri_start,
tri_count, lo(3), hi(3)]`` (a range of the shared `MeshData` triangle table
and the mesh's local AABB), CONVEX ``[hull, border, lo(3), hi(3)]`` (a row of
the shared `ConvexHulls` table and the hull's local AABB).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from rapier_tpu_torch import precision as _prec
from rapier_tpu_torch.dynamics.multibody import Multibodies


class BodyType(enum.IntEnum):
    DYNAMIC = 0
    FIXED = 1
    KINEMATIC_POSITION_BASED = 2
    KINEMATIC_VELOCITY_BASED = 3


class ShapeType(enum.IntEnum):
    BALL = 0
    CUBOID = 1
    CAPSULE = 2
    HALFSPACE = 3
    CYLINDER = 4
    CONE = 5
    SEGMENT = 6
    TRIANGLE = 7
    ROUND_CUBOID = 8
    ROUND_CYLINDER = 9
    ROUND_CONE = 10
    CONVEX = 11
    TRIMESH = 12
    HEIGHTFIELD = 13
    POLYLINE = 14
    COMPOUND = 15
    VOXELS = 16


class CoefficientCombineRule(enum.IntEnum):
    AVERAGE = 0
    MIN = 1
    MULTIPLY = 2
    MAX = 3


class FrictionModel(enum.IntEnum):
    SIMPLIFIED = 0
    COULOMB = 1


class BroadPhaseKind(enum.IntEnum):
    ALL_PAIRS = 0
    SAP = 1
    GRID = 2


class ActiveCollisionTypes(enum.IntFlag):
    DYNAMIC_DYNAMIC = 0b0000_0000_0000_0001
    DYNAMIC_KINEMATIC = 0b0000_0000_0000_1100
    DYNAMIC_FIXED = 0b0000_0000_0000_0010
    KINEMATIC_KINEMATIC = 0b1100_1100_0000_0000
    KINEMATIC_FIXED = 0b0010_0010_0000_0000
    FIXED_FIXED = 0b0000_0000_0010_0000


ACTIVE_COLLISION_TYPES_DEFAULT = int(
    ActiveCollisionTypes.DYNAMIC_DYNAMIC
    | ActiveCollisionTypes.DYNAMIC_KINEMATIC
    | ActiveCollisionTypes.DYNAMIC_FIXED
)

# Locked-axes bits (LockedAxes, rigid_body_components.rs:271).
LOCK_TRANSLATION_X = 1 << 0
LOCK_TRANSLATION_Y = 1 << 1
LOCK_TRANSLATION_Z = 1 << 2
LOCK_ROTATION_X = 1 << 3
LOCK_ROTATION_Y = 1 << 4
LOCK_ROTATION_Z = 1 << 5

# Joint axis bits (JointAxesMask): three linear axes, then three angular.
JOINT_LIN_AXES = 0b000111
JOINT_ANG_AXES = 0b111000

# Constraint-row slots per joint (the layout of
# dynamics/solver/joint_constraints.py).
MAX_JOINT_ROWS = 21


class MotorModel(enum.IntEnum):
    """Joint motor model (motor_model.rs)."""

    ACCELERATION_BASED = 0
    FORCE_BASED = 1

ACTIVE_EVENTS_COLLISION = 1 << 0
ACTIVE_EVENTS_CONTACT_FORCE = 1 << 1

# ActiveHooks bit flags (physics_hooks.rs): which hooks of a
# `pipeline.hooks.PhysicsHooks` see a collider's pairs.
ACTIVE_HOOKS_FILTER_CONTACT_PAIR = 1 << 0
ACTIVE_HOOKS_FILTER_INTERSECTION_PAIR = 1 << 1
ACTIVE_HOOKS_MODIFY_SOLVER_CONTACTS = 1 << 2


@dataclass
class Bodies:
    """Rigid-body SoA state; per scene ``[N, ...]`` (see rapier_tpu.types)."""

    pos: Any                    # [N, 3]
    rot: Any                    # [N, 4] (x, y, z, w)
    linvel: Any                 # [N, 3]
    angvel: Any                 # [N, 3]
    force: Any                  # [N, 3]
    torque: Any                 # [N, 3]
    local_com: Any              # [N, 3]
    inv_mass: Any               # [N]
    inv_principal_inertia: Any  # [N, 3]
    principal_frame: Any        # [N, 4]
    body_type: Any              # [N] int32
    enabled: Any                # [N] bool
    locked_axes: Any            # [N] int32
    gravity_scale: Any          # [N]
    linear_damping: Any         # [N]
    angular_damping: Any        # [N]
    dominance: Any              # [N] int32
    gyro_enabled: Any           # [N] bool
    mb_link: Any                # [N] bool
    can_sleep: Any              # [N] bool
    sleeping: Any               # [N] bool
    sleep_timer: Any            # [N]
    ccd_enabled: Any            # [N] bool
    soft_ccd_prediction: Any    # [N]
    next_pos: Any               # [N, 3]
    next_rot: Any               # [N, 4]
    user_data: Any              # [N] int32

    @property
    def n(self) -> int:
        return self.pos.shape[-2]


@dataclass
class Colliders:
    """Collider SoA state; per scene ``[C, ...]``."""

    parent: Any                  # [C] int32, -1 = no parent
    local_pos: Any               # [C, 3]
    local_rot: Any               # [C, 4]
    shape_type: Any              # [C] int32
    shape_params: Any            # [C, 12]
    friction: Any                # [C]
    restitution: Any             # [C]
    friction_combine: Any        # [C] int32
    restitution_combine: Any     # [C] int32
    collision_groups: Any        # [C] memberships << 16 | filter
    solver_groups: Any           # [C]
    sensor: Any                  # [C] bool
    enabled: Any                 # [C] bool
    contact_skin: Any            # [C]
    active_events: Any           # [C] int32
    active_hooks: Any            # [C] int32
    contact_force_event_threshold: Any  # [C]
    user_data: Any               # [C] int32
    active_collision_types: Any  # [C] int32

    @property
    def n(self) -> int:
        return self.parent.shape[-1]


@dataclass
class Contacts:
    """Persistent contact-pair cache, pair lane LAST; per scene ``[..., P]``."""

    pair_key: Any                   # [P] int32
    body1: Any                      # [P]
    body2: Any                      # [P]
    collider1: Any                  # [P]
    collider2: Any                  # [P]
    normal: Any                     # [3, P]
    point: Any                      # [4, 3, P]
    dist: Any                       # [4, P]
    feature_id: Any                 # [4, P] int32
    point_active: Any               # [4, P] bool
    num_points: Any                 # [P] int32
    active: Any                     # [P] bool
    touching: Any                   # [P] bool
    warmstart_impulse: Any          # [4, P]
    warmstart_tangent_impulse: Any  # [2, P]; [4, 2, P] under COULOMB
    warmstart_twist_impulse: Any    # [P]
    impulse: Any                    # [4, P]
    tangent_impulse: Any            # [2, P]; [4, 2, P] under COULOMB
    friction: Any                   # [P]
    restitution: Any                # [P]
    events_or: Any                  # [P] int32

    @property
    def max_pairs(self) -> int:
        return self.pair_key.shape[-1]


@dataclass
class Joints:
    """Impulse joints, one unified axis-based model (generic_joint.rs:260);
    per scene ``[J, ...]``.  Local frames are w.r.t. each body's origin
    frame (`PhysicsWorld.build` shifts the anchors into COM space)."""

    body1: Any              # [J] int32, -1 = padding
    body2: Any              # [J] int32
    local_pos1: Any         # [J, 3]
    local_rot1: Any         # [J, 4]
    local_pos2: Any         # [J, 3]
    local_rot2: Any         # [J, 4]
    locked_axes: Any        # [J] int32 bitmask
    limit_axes: Any         # [J] int32
    motor_axes: Any         # [J] int32
    coupled_axes: Any       # [J] int32
    limit_min: Any          # [J, 6]
    limit_max: Any          # [J, 6]
    motor_target_pos: Any   # [J, 6]
    motor_target_vel: Any   # [J, 6]
    motor_stiffness: Any    # [J, 6]
    motor_damping: Any      # [J, 6]
    motor_max_force: Any    # [J, 6]
    motor_model: Any        # [J, 6] int32 (MotorModel)
    softness_frequency: Any  # [J]
    softness_damping: Any    # [J]
    contacts_enabled: Any    # [J] bool
    enabled: Any             # [J] bool
    impulses: Any            # [J, MAX_JOINT_ROWS], the last substep's

    @property
    def n(self) -> int:
        return self.body1.shape[-1]


@dataclass
class MeshData:
    """The shared mesh tables of TRIMESH and HEIGHTFIELD colliders (the
    reference's MeshData): vertices in each collider's LOCAL frame, and
    triangles as vertex indices, padded rows -1.  A mesh collider holds its
    range ``(tri_start, tri_count)`` in shape_params[0:2].  Heightfields are
    triangulated when the scene is built.  Batched, the tables take the
    scene axis as every other leaf: ``[B, V, 3]``, ``[B, T, 3]``."""

    vertices: Any    # [V, 3]
    triangles: Any   # [T, 3] int32 (padded rows = -1)


def empty_meshes(v: int, t: int) -> MeshData:
    return MeshData(vertices=_f((v, 3)), triangles=_i((t, 3), -1))


MAX_HULL_VERTS = 32  # vertex slots a hull (decimated when the scene is built)


@dataclass
class ConvexHulls:
    """The shared vertex table of CONVEX colliders (the reference's
    ConvexHulls): ``[H, MAX_HULL_VERTS, 3]`` in each collider's local frame,
    a hull's unused slots repeating its first vertex (the support argmax
    stays exact).  Batched, the table takes the scene axis as the mesh tables
    do: ``[B, H, MAX_HULL_VERTS, 3]``."""

    vertices: Any    # [H, MAX_HULL_VERTS, 3]


def empty_hulls(h: int) -> ConvexHulls:
    return ConvexHulls(vertices=_f((h, MAX_HULL_VERTS, 3)))


@dataclass
class SceneState:
    """Full simulation state.  `joints` holds the impulse joints,
    `multibodies` the reduced-coordinate articulations, `meshes` the
    triangle tables of mesh colliders and `hulls` the vertex table of convex
    hulls (each None without any)."""

    bodies: Bodies
    colliders: Colliders
    contacts: Contacts
    step_count: Any = field(default_factory=lambda: np.int32(0))
    multibodies: Any = None
    joints: Any = None
    meshes: Any = None
    hulls: Any = None


# The empty_* constructors read the precision axis when they run (numpy
# leaves at `precision.NP_FLOAT`), as the reference's do.
def _f(shape, fill=0.0):
    return np.full(shape, fill, _prec.NP_FLOAT)


def _i(shape, fill=0):
    return np.full(shape, fill, np.int32)


def _b(shape, fill=False):
    return np.full(shape, fill, bool)


def _quat_id(n: int):
    q = _f((n, 4))
    q[:, 3] = 1.0
    return q


def empty_bodies(n: int) -> Bodies:
    quat_id = _quat_id(n)
    return Bodies(
        pos=_f((n, 3)), rot=quat_id, linvel=_f((n, 3)), angvel=_f((n, 3)),
        force=_f((n, 3)), torque=_f((n, 3)),
        local_com=_f((n, 3)), inv_mass=_f((n,)),
        inv_principal_inertia=_f((n, 3)), principal_frame=quat_id,
        body_type=_i((n,), int(BodyType.FIXED)), enabled=_b((n,)),
        locked_axes=_i((n,)), gravity_scale=_f((n,), 1.0),
        linear_damping=_f((n,)), angular_damping=_f((n,)),
        dominance=_i((n,)), gyro_enabled=_b((n,)), mb_link=_b((n,)),
        can_sleep=_b((n,), True), sleeping=_b((n,)), sleep_timer=_f((n,)),
        ccd_enabled=_b((n,)), soft_ccd_prediction=_f((n,)),
        next_pos=_f((n, 3)), next_rot=quat_id,
        user_data=_i((n,)),
    )


def empty_colliders(c: int) -> Colliders:
    quat_id = _quat_id(c)
    return Colliders(
        parent=_i((c,), -1), local_pos=_f((c, 3)), local_rot=quat_id,
        shape_type=_i((c,), int(ShapeType.BALL)), shape_params=_f((c, 12)),
        friction=_f((c,), 0.5), restitution=_f((c,)),
        friction_combine=_i((c,)), restitution_combine=_i((c,)),
        collision_groups=np.full((c,), 0xFFFF_FFFF, np.uint32),
        solver_groups=np.full((c,), 0xFFFF_FFFF, np.uint32),
        sensor=_b((c,)), enabled=_b((c,)), contact_skin=_f((c,)),
        active_events=_i((c,)), active_hooks=_i((c,)),
        contact_force_event_threshold=_f((c,), np.inf),
        user_data=_i((c,)),
        active_collision_types=np.full(
            (c,), ACTIVE_COLLISION_TYPES_DEFAULT, np.int32),
    )


def empty_contacts(p: int, per_point_tangent: bool = False) -> Contacts:
    """`per_point_tangent` widens the tangent caches to ``[4, 2, P]`` for
    FrictionModel.COULOMB (a tangent pair per contact point, contact_pair.rs
    :34-51); the twist model keeps one pair a manifold, ``[2, P]``."""
    tan_shape = (4, 2, p) if per_point_tangent else (2, p)
    return Contacts(
        pair_key=_i((p,), -1), body1=_i((p,), -1), body2=_i((p,), -1),
        collider1=_i((p,), -1), collider2=_i((p,), -1),
        normal=_f((3, p)), point=_f((4, 3, p)), dist=_f((4, p)),
        feature_id=_i((4, p), -1), point_active=_b((4, p)),
        num_points=_i((p,)), active=_b((p,)), touching=_b((p,)),
        warmstart_impulse=_f((4, p)), warmstart_tangent_impulse=_f(tan_shape),
        warmstart_twist_impulse=_f((p,)),
        impulse=_f((4, p)), tangent_impulse=_f(tan_shape),
        friction=_f((p,)), restitution=_f((p,)),
        events_or=_i((p,)),
    )


def empty_joints(j: int) -> Joints:
    quat_id = _quat_id(j)
    return Joints(
        body1=_i((j,), -1), body2=_i((j,), -1),
        local_pos1=_f((j, 3)), local_rot1=quat_id,
        local_pos2=_f((j, 3)), local_rot2=quat_id,
        locked_axes=_i((j,)), limit_axes=_i((j,)), motor_axes=_i((j,)),
        coupled_axes=_i((j,)),
        limit_min=_f((j, 6), -np.inf),
        limit_max=_f((j, 6), np.inf),
        motor_target_pos=_f((j, 6)), motor_target_vel=_f((j, 6)),
        motor_stiffness=_f((j, 6)), motor_damping=_f((j, 6)),
        motor_max_force=_f((j, 6), 3.4e38),
        motor_model=_i((j, 6)),
        softness_frequency=_f((j,), 1.0e6),
        softness_damping=_f((j,), 1.0),
        contacts_enabled=_b((j,), True), enabled=_b((j,)),
        impulses=_f((j, MAX_JOINT_ROWS)),
    )


def empty_scene(n_bodies: int, n_colliders: int, max_pairs: int) -> SceneState:
    """One scene's empty state, numpy leaves (reference types.py:637)."""
    return SceneState(
        bodies=empty_bodies(n_bodies),
        colliders=empty_colliders(n_colliders),
        contacts=empty_contacts(max_pairs),
    )


def _real(default):
    """A float field of SimParams: a numpy scalar at `precision.NP_FLOAT`,
    read when the params are made (the reference's default_factory)."""
    return field(default_factory=lambda: _prec.NP_FLOAT(default))


_REAL_FIELDS = (
    "dt", "gravity", "length_unit", "contact_natural_frequency", "contact_damping_ratio",
    "warmstart_coefficient", "normalized_allowed_linear_error",
    "normalized_max_corrective_velocity", "normalized_prediction_distance",
    "sleep_linear_threshold", "sleep_angular_threshold", "time_until_sleep")


@dataclass(frozen=True)
class SimParams:
    """Runtime parameters (rapier_tpu.types.SimParams).  Float fields are
    numpy scalars (gravity a numpy array) so derived coefficients round
    like the reference's arithmetic: a value given as a numpy float keeps
    its dtype, any other is taken at `precision.NP_FLOAT` when the params
    are made.  Int fields shape the step's loops."""

    dt: Any = _real(1.0 / 60.0)
    gravity: Any = field(
        default_factory=lambda: np.array([0.0, -9.81, 0.0], _prec.NP_FLOAT))
    length_unit: Any = _real(1.0)
    contact_natural_frequency: Any = _real(30.0)
    contact_damping_ratio: Any = _real(5.0)
    warmstart_coefficient: Any = _real(1.0)
    normalized_allowed_linear_error: Any = _real(0.001)
    normalized_max_corrective_velocity: Any = _real(10.0)
    normalized_prediction_distance: Any = _real(0.002)
    sleep_linear_threshold: Any = _real(0.4)
    sleep_angular_threshold: Any = _real(0.5)
    time_until_sleep: Any = _real(2.0)
    num_solver_iterations: int = 4
    num_internal_pgs_iterations: int = 1
    num_internal_stabilization_iterations: int = 1
    friction_model: int = int(FrictionModel.SIMPLIFIED)
    broad_phase: int = int(BroadPhaseKind.ALL_PAIRS)
    sap_window: int = 64
    max_colors: int = 16
    max_solver_pairs: int = 0
    # Mesh narrow phase: lanes reserved for (convex, mesh) pairs and the
    # candidate triangles of each (geometry/narrowphase_mesh.py).
    max_mesh_pairs: int = 64
    tris_per_pair: int = 8
    # CCD motion clamping (dynamics/ccd.py): clamp passes a step; world.build()
    # turns enable_ccd on when any body has ccd_enabled.
    max_ccd_substeps: int = 1
    enable_ccd: bool = False
    sleep_propagation_iters: int = 16
    sleeping_enabled: bool = True
    shape_types_present: tuple = ()
    # The joint row slots each step builds and solves: a census, as
    # shape_types_present is (PhysicsWorld.build keeps the slots its joint
    # table uses); by default every slot, the reference's layout.
    joint_slots: tuple = tuple(range(MAX_JOINT_ROWS))
    block_solver_2x2: bool = False
    solver_backend: str = "auto"

    def __post_init__(self):
        for name in _REAL_FIELDS:
            v = getattr(self, name)
            if not (isinstance(v, (np.ndarray, np.generic))
                    and np.issubdtype(v.dtype, np.floating)):
                v = np.asarray(v, _prec.NP_FLOAT)
            object.__setattr__(self, name, v[()] if v.ndim == 0 else v)

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)

    @property
    def real(self):
        """The numpy scalar type of the params' own arithmetic (dt's)."""
        return self.dt.dtype.type

    def inv_dt(self):
        t = self.real
        return t(0.0) if self.dt == 0.0 else t(t(1.0) / self.dt)

    def allowed_linear_error(self):
        t = self.real
        return t(t(self.normalized_allowed_linear_error) * t(self.length_unit))

    def max_corrective_velocity(self):
        t = self.real
        return t(t(self.normalized_max_corrective_velocity) * t(self.length_unit))

    def prediction_distance(self):
        t = self.real
        return t(t(self.normalized_prediction_distance) * t(self.length_unit))


def spring_erp_inv_dt(natural_frequency, damping_ratio, dt):
    """erp/dt for a soft constraint (reference types.py): of numpy scalars
    (the contact coefficients, in dt's dtype), or of tensors (per-joint
    softness)."""
    if isinstance(natural_frequency, torch.Tensor):
        ang_freq = natural_frequency * (2.0 * math.pi)
        return ang_freq / (dt * ang_freq + 2.0 * damping_ratio)
    t = np.asarray(dt).dtype.type
    ang_freq = t(natural_frequency) * t(2.0 * math.pi)
    return t(ang_freq / t(t(dt) * ang_freq + t(2.0) * t(damping_ratio)))


def spring_cfm_factor(natural_frequency, damping_ratio, dt):
    """cfm_factor = 1/(1+cfm_coeff), of numpy scalars in dt's dtype
    (reference types.py)."""
    t = np.asarray(dt).dtype.type
    erp = t(t(dt) * spring_erp_inv_dt(natural_frequency, damping_ratio, dt))
    if erp == 0.0:
        return t(1.0)
    inv_erp_m1 = t(t(1.0) / erp - t(1.0))
    dr = t(damping_ratio)
    cfm_coeff = t(inv_erp_m1 * inv_erp_m1 / ((t(1.0) + inv_erp_m1) * t(4.0) * dr * dr))
    return t(t(1.0) / (t(1.0) + cfm_coeff))


# ---------------------------------------------------------------------------
# Crossing between numpy leaves (the reference's host form) and tensors.
# ---------------------------------------------------------------------------

_STATE_TYPES = {
    "bodies": Bodies, "colliders": Colliders, "contacts": Contacts,
}
_OPTIONAL_TYPES = {"joints": Joints, "multibodies": Multibodies, "meshes": MeshData,
                   "hulls": ConvexHulls}


def _leaf_to_tensor(x, device):
    a = np.array(x)   # a writable copy: reference leaves may be read-only
    if a.dtype == np.uint32:
        # Interaction groups: torch's uint32 arithmetic is incomplete, and
        # the packed 16-bit halves fit int64 exactly.
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def tree_map(fn, state) -> SceneState:
    """Apply `fn` to every leaf of a scene state (of either package: fields
    are read by name) and return the port's `SceneState`."""
    types = dict(_STATE_TYPES)
    for slot, cls in _OPTIONAL_TYPES.items():
        if getattr(state, slot, None) is not None:
            types[slot] = cls
    parts = {
        name: cls(**{f.name: fn(getattr(getattr(state, name), f.name))
                     for f in dataclasses.fields(cls)})
        for name, cls in types.items()
    }
    return SceneState(step_count=fn(state.step_count), **parts)


def from_numpy(tree, device="cpu"):
    """Tensors on `device` from a `SceneState` or `SimParams` of either
    package with numpy (or array-like) leaves.  Fields are read by name, so a
    reference `rapier_tpu.types.SceneState` converts directly."""
    if hasattr(tree, "num_solver_iterations"):
        kw = {}
        for f in dataclasses.fields(SimParams):
            if not hasattr(tree, f.name):   # joint_slots: the port's own
                continue
            v = getattr(tree, f.name)
            if f.name in _REAL_FIELDS and not isinstance(v, float):
                v = np.asarray(v)   # a numpy float keeps its dtype (__post_init__)
            kw[f.name] = v
        return SimParams(**kw)
    return tree_map(lambda x: _leaf_to_tensor(x, device), tree)


def to_numpy(state: SceneState) -> SceneState:
    """The same dataclass tree with numpy leaves."""
    return tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
        state)
