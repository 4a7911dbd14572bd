"""MJCF (MuJoCo XML) loader (counterpart of rapier_tpu.loaders.mjcf, after
mjcf-rs and rapier3d-mjcf's conversion.rs).

Reads what the reference reads: ``<compiler angle meshdir>``,
``<include file>`` (spliced in place, recursively), ``<default>`` class
inheritance (``class``, ``childclass``), ``<asset><mesh file scale>``
through `loaders.meshfiles`, the ``<worldbody>`` tree of bodies with
``pos`` and any orientation (``quat``, ``euler``, ``axisangle``, ``zaxis``,
``xyaxes``), ``gravcomp`` and ``mocap``; plane, sphere, box, ellipsoid,
capsule, cylinder and mesh geoms (``size``, ``fromto``, ``pos``, an
orientation, ``friction``, ``density``, ``mass``, ``contype`` /
``conaffinity``); free, ball, hinge and slide joints (``pos``, ``axis``,
``limited``, ``range``, ``damping``); sites; motor, position and velocity
actuators; fixed tendons (dof couplings) and spatial ones (lengths);
``<equality>`` joint (a coupling), connect and weld (impulse joints, also
beside a multibody tree); keyframes (``qpos``, ``mpos``, ``mquat``) and
jointpos, jointvel, framepos and tendonpos sensors.  Whatever else a file
holds is ignored without a word, as in the reference.

Semantics follow the reference loader: world geoms hang on a fixed body; a
body with a free joint is a free dynamic body; a jointless top-level body is
fixed and a jointless nested one is welded to its parent; a top-level
jointed body is jointed to a fixed world anchor made at first need; a body
with several hinges gets a ball joint; a hinge's frames put the joint axis
on X and coincide at the assembled rest pose; contacts between a body and
its joint parent are disabled; a position actuator installs a PD motor (kv
defaults to kp/10) and joint damping a velocity motor to 0; gravcomp folds
into the gravity scale.  Joints are impulse joints unless
``use_multibody=True`` makes them reduced-coordinate multibody joints.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from rapier_tpu_torch.geometry.mass_properties import MassProperties
from rapier_tpu_torch.loaders.meshfiles import load_mesh_file
from rapier_tpu_torch.world import (
    ColliderBuilder,
    GenericJointBuilder,
    PhysicsWorld,
    RigidBodyBuilder,
)
from rapier_tpu_torch.world import _np_quat_mul as _quat_mul
from rapier_tpu_torch.world import _np_quat_rotate as _quat_rotate


def _quat_conj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _vec(s, default):
    if s is None:
        return np.asarray(default, float)
    return np.asarray([float(x) for x in s.split()], float)


def _axis_angle_quat(axis, angle):
    axis = np.asarray(axis, float)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    axis = axis / n
    s = math.sin(angle / 2)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle / 2)])


class _Defaults:
    """``<default>`` class inheritance: the top-level ``<default>`` is the
    "main" class, nested ones are named and inherit their parent's values."""

    def __init__(self):
        self.classes: dict[str, dict[str, dict]] = {"main": {}}

    def parse(self, elem, parent="main"):
        name = elem.get("class", "main" if parent == "main" else parent)
        merged = {k: dict(v) for k, v in self.classes.get(parent, {}).items()}
        for child in elem:
            if child.tag == "default":
                continue
            merged.setdefault(child.tag, {})
            merged[child.tag].update(child.attrib)
        self.classes[name] = merged
        for child in elem.findall("default"):
            self.parse(child, name)

    def resolve(self, tag, attrib, cls):
        out = dict(self.classes.get(cls or "main", {}).get(tag, {}))
        out.update(attrib)
        return out


@dataclass
class MjcfActuator:
    name: str
    kind: str            # motor | position | velocity
    joint: str
    gear: float
    kp: float
    kv: float


@dataclass
class MjcfRobotHandles:
    """Loaded-model handles (reference MjcfRobotHandles, runtime.rs).  The
    methods that drive the model write the world's (batch-of-one) state in
    place."""

    bodies: dict = field(default_factory=dict)       # body name -> handle
    joints: dict = field(default_factory=dict)       # joint name -> joint id
    joint_axis: dict = field(default_factory=dict)   # joint name -> axis slot
    actuators: list = field(default_factory=list)    # [MjcfActuator]
    joint_order: list = field(default_factory=list)  # qpos order (1-dof joints)
    keyframes: dict = field(default_factory=dict)    # key name -> qpos array
    sensors: list = field(default_factory=list)      # [(name, kind, target)]
    tendons: dict = field(default_factory=dict)      # name -> [(joint, coef)]
    couplings: list = field(default_factory=list)    # [(ja, jb, ratio, offset)]
    equalities: dict = field(default_factory=dict)   # name -> impulse joint id
    gravcomp: dict = field(default_factory=dict)     # body name -> factor
    mocap: list = field(default_factory=list)        # mocap body names, in order
    sites: dict = field(default_factory=dict)        # name -> (body, local pos)
    spatial_tendons: dict = field(default_factory=dict)  # name -> [site names]
    keyframes_mocap: dict = field(default_factory=dict)  # name -> (mpos, mquat)
    use_multibody: bool = False
    _mb_slots: dict = field(default_factory=dict)    # joint name -> (tree, link)

    def _mb_slot(self, world: PhysicsWorld, jname: str) -> tuple:
        """(tree, link) articulation slot of a multibody-inserted joint."""
        if jname not in self._mb_slots:
            child = world._pending_mb_joints[self.joints[jname]][2]
            self._mb_slots[jname] = world.multibody_link_of(child)
        return self._mb_slots[jname]

    def _impulse_joint(self, world: PhysicsWorld, jname: str):
        """(body1, body2, axis slot, the joint's local frames on the host)
        of an impulse-inserted joint."""
        j = self.joints[jname]
        joints = world.state.joints
        table = {name: getattr(joints, name)[0, j].cpu().numpy()
                 for name in ("local_pos1", "local_pos2", "local_rot1", "local_rot2")}
        return (int(joints.body1[0, j]), int(joints.body2[0, j]), self.joint_axis[jname],
                table)

    def joint_value(self, world: PhysicsWorld, jname: str) -> float:
        """A 1-dof joint's coordinate (revolute angle, prismatic
        displacement): the articulation's, or read from the two bodies'
        poses for an impulse joint."""
        if self.use_multibody:
            ti, li = self._mb_slot(world, jname)
            return float(world.multibody_q(ti)[li, self.joint_axis[jname]])
        b1, b2, ax, jt = self._impulse_joint(world, jname)
        q1, q2 = world.body_rotation(b1), world.body_rotation(b2)
        f1 = _quat_mul(q1, jt["local_rot1"])
        f2 = _quat_mul(q2, jt["local_rot2"])
        if ax >= 3:
            # Relative rotation about the joint axis (frame X by convention).
            qerr = _quat_mul(np.array([-f1[0], -f1[1], -f1[2], f1[3]]), f2)
            if np.dot(f1, f2) < 0:
                qerr = -qerr
            return float(2.0 * math.asin(np.clip(qerr[0], -1.0, 1.0)))
        p1 = world.body_translation(b1) + _quat_rotate(q1, jt["local_pos1"])
        p2 = world.body_translation(b2) + _quat_rotate(q2, jt["local_pos2"])
        return float(np.dot(p2 - p1, _quat_rotate(f1, np.array([1.0, 0.0, 0.0]))))

    def joint_velocity(self, world: PhysicsWorld, jname: str) -> float:
        """A 1-dof joint's velocity: the articulation's, or the two bodies'
        relative velocity along the joint axis for an impulse joint."""
        if self.use_multibody:
            ti, li = self._mb_slot(world, jname)
            return float(world.multibody_qd(ti)[li, self.joint_axis[jname]])
        b1, b2, ax, jt = self._impulse_joint(world, jname)
        f1 = _quat_mul(world.body_rotation(b1), jt["local_rot1"])
        axis_w = _quat_rotate(f1, np.array([1.0, 0.0, 0.0]))
        if ax >= 3:
            rel = world.body_angvel(b2) - world.body_angvel(b1)
        else:
            rel = world.body_linvel(b2) - world.body_linvel(b1)
        return float(np.dot(rel, axis_w))

    def read_sensors(self, world: PhysicsWorld) -> dict:
        """Evaluate the ``<sensor>`` readers (runtime.rs:677-760): jointpos,
        jointvel, framepos and tendonpos (of a spatial tendon)."""
        out = {}
        for (name, kind, target) in self.sensors:
            if kind == "jointpos":
                out[name] = self.joint_value(world, target)
            elif kind == "jointvel":
                out[name] = self.joint_velocity(world, target)
            elif kind == "framepos":
                h = self.bodies.get(target)
                if h is not None:
                    out[name] = world.body_translation(h)
            elif kind == "tendonpos":
                if target in self.spatial_tendons:
                    out[name] = self.tendon_length(world, target)
        return out

    def site_position(self, world: PhysicsWorld, name: str) -> np.ndarray:
        """World position of a ``<site>`` (its body's pose applied to its
        local position)."""
        h, local = self.sites[name]
        return world.body_translation(h) + _quat_rotate(world.body_rotation(h), local)

    def tendon_length(self, world: PhysicsWorld, name: str) -> float:
        """Path length of a spatial tendon through its site waypoints."""
        pts = [self.site_position(world, s) for s in self.spatial_tendons[name]]
        return float(sum(np.linalg.norm(pts[i + 1] - pts[i]) for i in range(len(pts) - 1)))

    def set_mocap_pose(self, world: PhysicsWorld, name: str, pos, quat=None):
        """Teleport a mocap body (kinematic-position-based, user-driven;
        runtime.rs:141): its pose and its next pose."""
        h = self.bodies[name]
        b = world.state.bodies
        p = torch.as_tensor(np.asarray(pos, np.float32), device=b.pos.device)
        b.pos[0, h] = p
        b.next_pos[0, h] = p
        if quat is not None:
            q = torch.as_tensor(np.asarray(quat, np.float32), device=b.rot.device)
            b.rot[0, h] = q
            b.next_rot[0, h] = q

    def apply_gravity_compensation(self, world: PhysicsWorld):
        """Re-assert gravcomp as gravity_scale = 1 - gravcomp (runtime.rs:38
        adds -g gravcomp m each frame, the same dynamics; the load already
        folds it, so this restores it after the user edits the scales)."""
        gs = world.state.bodies.gravity_scale
        for name, gc in self.gravcomp.items():
            gs[0, self.bodies[name]] = 1.0 - float(gc)

    def apply_keyframe(self, world: PhysicsWorld, name: str):
        """A keyframe's mocap poses, then its qpos: a multibody robot
        teleports exactly (the coordinates set, the dof velocity zeroed, a
        hinge's joint rotation set; FK realizes the links on the next step);
        an impulse-joint robot is driven to it through position motors (at
        least 500 stiffness and 50 damping)."""
        if name in self.keyframes_mocap:
            mpos, mquat = self.keyframes_mocap[name]
            for k, bname in enumerate(self.mocap):
                pos = (mpos[3 * k:3 * k + 3]
                       if mpos is not None and mpos.size >= 3 * (k + 1) else None)
                qm = None
                if mquat is not None and mquat.size >= 4 * (k + 1):
                    w, x, y, z = mquat[4 * k:4 * k + 4]      # MJCF wxyz
                    qm = (x, y, z, w)
                if pos is not None:
                    self.set_mocap_pose(world, bname, pos, qm)
        if name not in self.keyframes:
            return
        q = self.keyframes[name]
        if self.use_multibody:
            mb = world.state.multibodies
            for val, jname in zip(q, self.joint_order):
                if jname not in self.joints:
                    continue
                ti, li = self._mb_slot(world, jname)
                ax = self.joint_axis[jname]
                mb.q[0, ti, li, ax] = float(val)
                mb.qd[0, ti, li * 6 + ax] = 0.0
                if ax >= 3:
                    e = np.zeros(3, np.float32)
                    e[ax - 3] = 1.0
                    half = 0.5 * float(val)
                    rot = np.concatenate([np.sin(half) * e, [np.cos(half)]]).astype(np.float32)
                    mb.joint_rot[0, ti, li] = torch.from_numpy(rot).to(mb.joint_rot.device)
            return
        js = world.state.joints
        for val, jname in zip(q, self.joint_order):
            j = self.joints.get(jname)
            if j is None:
                continue
            ax = self.joint_axis[jname]
            js.motor_target_pos[0, j, ax] = float(val)
            js.motor_stiffness[0, j, ax] = js.motor_stiffness[0, j, ax].clamp(min=500.0)
            js.motor_damping[0, j, ax] = js.motor_damping[0, j, ax].clamp(min=50.0)
            js.motor_axes[0, j] |= 1 << ax

    def apply_controls(self, world: PhysicsWorld, ctrl):
        """Drive the actuators (runtime.rs:450-507): position -> motor
        target position, motor and velocity -> motor target velocity, each
        scaled by its gear."""
        for a, u in zip(self.actuators, np.asarray(ctrl)):
            if a.joint not in self.joints:
                continue
            ax = self.joint_axis[a.joint]
            if self.use_multibody:
                mb = world.state.multibodies
                target = mb.motor_target_pos if a.kind == "position" else mb.motor_target_vel
                ti, li = self._mb_slot(world, a.joint)
                target[0, ti, li, ax] = float(u) * a.gear
            else:
                js = world.state.joints
                target = js.motor_target_pos if a.kind == "position" else js.motor_target_vel
                target[0, self.joints[a.joint], ax] = float(u) * a.gear


def _expand_includes(root, base_dir):
    """Splice every ``<include file>`` (recursively): the included file's
    ``<mujoco>`` children replace the element where it stands; a missing
    file is dropped."""
    for parent in list(root.iter()):
        for child in list(parent):
            if child.tag != "include":
                continue
            path = os.path.join(base_dir, child.get("file", ""))
            if not os.path.exists(path):
                parent.remove(child)
                continue
            inc = ET.parse(path).getroot()
            _expand_includes(inc, os.path.dirname(path))
            # Splice at the element's current position: earlier includes
            # under the same parent have shifted it, and document order
            # decides how defaults and assets resolve.
            pos = list(parent).index(child)
            parent.remove(child)
            for sub in (list(inc) if inc.tag == "mujoco" else [inc]):
                parent.insert(pos, sub)
                pos += 1


def _orientation(attrs, angle_scale):
    """An element's orientation attributes as a quaternion (x, y, z, w)."""
    if "quat" in attrs:
        q = _vec(attrs["quat"], (1, 0, 0, 0))      # MJCF order: w x y z
        return np.array([q[1], q[2], q[3], q[0]])
    if "euler" in attrs:
        e = _vec(attrs["euler"], (0, 0, 0)) * angle_scale
        qx = _axis_angle_quat((1, 0, 0), e[0])
        qy = _axis_angle_quat((0, 1, 0), e[1])
        qz = _axis_angle_quat((0, 0, 1), e[2])
        return _quat_mul(_quat_mul(qx, qy), qz)
    if "axisangle" in attrs:
        aa = _vec(attrs["axisangle"], (0, 0, 1, 0))
        return _axis_angle_quat(aa[:3], aa[3] * angle_scale)
    if "zaxis" in attrs:
        z = _vec(attrs["zaxis"], (0, 0, 1))
        z = z / max(np.linalg.norm(z), 1e-12)
        ref = np.array([0.0, 0.0, 1.0])
        c = np.cross(ref, z)
        d = float(np.dot(ref, z))
        if d < -1 + 1e-9:
            return np.array([1.0, 0.0, 0.0, 0.0])
        q = np.array([c[0], c[1], c[2], 1.0 + d])
        return q / np.linalg.norm(q)
    if "xyaxes" in attrs:
        v = _vec(attrs["xyaxes"], (1, 0, 0, 0, 1, 0))
        x = v[:3] / max(np.linalg.norm(v[:3]), 1e-12)
        y = v[3:6] - x * np.dot(x, v[3:6])
        y = y / max(np.linalg.norm(y), 1e-12)
        z = np.cross(x, y)
        m = np.stack([x, y, z], axis=1)
        qw = math.sqrt(max(np.trace(m) + 1.0, 1e-12)) / 2
        q = np.array([(m[2, 1] - m[1, 2]) / (4 * qw), (m[0, 2] - m[2, 0]) / (4 * qw),
                      (m[1, 0] - m[0, 1]) / (4 * qw), qw])
        return q / np.linalg.norm(q)
    return np.array([0.0, 0.0, 0.0, 1.0])


def _ellipsoid(a3) -> ColliderBuilder:
    """An ellipsoid geom: the convex hull of 26 Fibonacci-sphere points
    scaled by the semi-axes (it inscribes the surface) with the exact
    ellipsoid's mass properties at unit density (rapier3d-mjcf mass.rs)."""
    k = np.arange(26, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * k / 26.0)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * k
    pts = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
                   axis=1) * a3[None, :]
    cb = ColliderBuilder.convex_hull(pts)
    a, b, c = float(a3[0]), float(a3[1]), float(a3[2])
    vol = 4.0 / 3.0 * np.pi * a * b * c
    cb.mass_props_unit_density = MassProperties(
        vol, np.zeros(3), vol / 5.0 * np.array([b * b + c * c, a * a + c * c, a * a + b * b]),
        np.array([0.0, 0.0, 0.0, 1.0]))
    return cb


def _geom_collider(attrs, meshes: dict) -> Optional[ColliderBuilder]:
    """The collider of a geom (None for a type the reference does not read,
    or a mesh it did not load).  MJCF cylinders and capsules lie along +Z."""
    gtype = attrs.get("type", "sphere")
    size = _vec(attrs.get("size"), (0.0, 0.0, 0.0))
    fromto = attrs.get("fromto")
    if gtype == "plane":
        cb = ColliderBuilder.halfspace((0, 0, 1))    # the plane's normal: local +Z
    elif gtype == "sphere":
        cb = ColliderBuilder.ball(size[0])
    elif gtype == "box":
        cb = ColliderBuilder.cuboid(size[0], size[1], size[2])
    elif gtype == "ellipsoid":
        cb = _ellipsoid(np.asarray(size[:3], np.float64))
    elif gtype in ("capsule", "cylinder"):
        r = size[0]
        if fromto is not None:
            ft = _vec(fromto, (0, 0, 0, 0, 0, 1))
            a, b = ft[:3], ft[3:6]
            if gtype == "capsule":
                cb = ColliderBuilder.capsule_from_endpoints(a, b, r)
            else:
                d = b - a
                cb = ColliderBuilder.cylinder(np.linalg.norm(d) / 2, r)
                z = d / max(np.linalg.norm(d), 1e-12)
                c = np.cross(np.array([0.0, 1.0, 0.0]), z)
                dd = float(np.dot(np.array([0.0, 1.0, 0.0]), z))
                q = np.array([c[0], c[1], c[2], 1.0 + dd])
                q = (q / max(np.linalg.norm(q), 1e-12) if dd > -1 + 1e-9
                     else np.array([1.0, 0.0, 0.0, 0.0]))
                cb.translation = tuple((a + b) / 2)
                cb.rotation = tuple(q)
        else:
            hh = size[1] if len(size) > 1 else 0.5
            if gtype == "capsule":
                cb = ColliderBuilder.capsule_z(hh, r)
            else:
                cb = ColliderBuilder.cylinder(hh, r)      # the port's: along +Y
                cb.rotation = tuple(_axis_angle_quat((1, 0, 0), math.pi / 2))
    elif gtype == "mesh":
        m = meshes.get(attrs.get("mesh", ""))
        if m is None:
            return None
        cb = ColliderBuilder.trimesh(m[0], m[1])
    else:
        return None
    return _apply_geom_material(cb, attrs)


def _apply_geom_material(cb: ColliderBuilder, attrs) -> ColliderBuilder:
    """friction (its sliding term), density, mass, and contype /
    conaffinity as interaction groups (0 and 0: never collides)."""
    if "friction" in attrs:
        cb.friction = float(_vec(attrs["friction"], (1.0, 0.005, 0.0001))[0])
    if "density" in attrs:
        cb.density = float(attrs["density"])
    if "mass" in attrs:
        cb.mass = float(attrs["mass"])
    contype = int(attrs.get("contype", 1))
    conaffinity = int(attrs.get("conaffinity", 1))
    cb.collision_groups = ((contype & 0xFFFF) << 16) | (conaffinity & 0xFFFF)
    if contype == 0 and conaffinity == 0:
        cb.collision_groups = 0
    return cb


def load_mjcf(path_or_string: str, world: PhysicsWorld, *,
              root_translation=(0.0, 0.0, 0.0),
              use_multibody: bool = False) -> MjcfRobotHandles:
    """Parse an MJCF model (a file path, or the XML itself) and insert it
    into `world`, shifted by `root_translation`.  MJCF is Z-up: scenes built
    from it set gravity to (0, 0, -9.81).  `use_multibody=True` inserts the
    joints as reduced-coordinate multibody joints (rapier3d-mjcf
    insert_using_multibody_joints); `handles.joints` then maps joint names to
    pending multibody-joint ids and the handles read and drive the
    generalized coordinates.  Equality connects and welds are impulse joints
    in both forms."""
    if os.path.exists(path_or_string):
        root = ET.parse(path_or_string).getroot()
        base_dir = os.path.dirname(path_or_string)
    else:
        root = ET.fromstring(path_or_string)
        base_dir = "."
    assert root.tag == "mujoco", f"not an MJCF file (root <{root.tag}>)"
    _expand_includes(root, base_dir)

    compiler = root.find("compiler")
    angle_unit = compiler.get("angle", "degree") if compiler is not None else "degree"
    angle_scale = math.pi / 180.0 if angle_unit == "degree" else 1.0
    meshdir = compiler.get("meshdir", "") if compiler is not None else ""

    defaults = _Defaults()
    for d in root.findall("default"):
        defaults.parse(d)

    meshes = {}
    asset = root.find("asset")
    if asset is not None:
        for m in asset.findall("mesh"):
            fn = m.get("file", "")
            tri = load_mesh_file(os.path.join(base_dir, meshdir, fn))
            if tri is not None:
                meshes[m.get("name", os.path.splitext(fn)[0])] = (
                    tri[0] * _vec(m.get("scale"), (1, 1, 1)), tri[1])

    handles = MjcfRobotHandles(use_multibody=use_multibody)
    body_world: dict = {}    # body name -> (world pos, world rot) as assembled
    anchor = []

    def insert_joint(p_handle, child_handle, gb):
        if use_multibody:
            return world.insert_multibody_joint(p_handle, child_handle, gb)
        return world.insert_impulse_joint(p_handle, child_handle, gb)

    def world_anchor():
        """The fixed body at the origin that top-level jointed bodies (and
        equalities without a body2) attach to, made at first need."""
        if not anchor:
            anchor.append(world.insert_body(RigidBodyBuilder.fixed()))
        return anchor[0]

    def body_class(elem, inherited):
        return elem.get("childclass", elem.get("class", inherited))

    def joint_type(j, cls):
        return defaults.resolve("joint", j.attrib, j.get("class", cls)).get("type", "hinge")

    def insert_geoms(body_handle, elem, cls):
        for g in elem.findall("geom"):
            attrs = defaults.resolve("geom", g.attrib, g.get("class", cls))
            cb = _geom_collider(attrs, meshes)
            if cb is None:
                continue
            gpos = _vec(attrs.get("pos"), (0, 0, 0))
            grot = _orientation(attrs, angle_scale)
            base_pos, base_rot = np.asarray(cb.translation), np.asarray(cb.rotation)
            cb.translation = tuple(gpos + _quat_rotate(grot, base_pos))
            cb.rotation = tuple(_quat_mul(grot, base_rot))
            world.insert_collider(cb, body_handle)

    def walk(elem, parent_handle, parent_pos, parent_rot, cls):
        cls = body_class(elem, cls)
        for b in elem.findall("body"):
            bcls = body_class(b, cls)
            bpos = _vec(b.get("pos"), (0, 0, 0))
            brot = _orientation(b.attrib, angle_scale)
            wpos = parent_pos + _quat_rotate(parent_rot, bpos)
            wrot = _quat_mul(parent_rot, brot)
            joints = b.findall("joint")
            has_free = any(joint_type(j, bcls) == "free" for j in joints)
            fixed_to_parent = len(joints) == 0
            mocap = b.get("mocap", "false") in ("true", "1")
            if mocap:
                bb = RigidBodyBuilder.kinematic_position_based()
            elif fixed_to_parent and parent_handle is None:
                bb = RigidBodyBuilder.fixed()
            else:
                bb = RigidBodyBuilder.dynamic()
            bb.translation = tuple(wpos)
            bb.rotation = tuple(wrot)
            gravcomp = float(b.get("gravcomp", "0") or 0)
            if gravcomp != 0.0 and not mocap:
                bb.gravity_scale = 1.0 - gravcomp
            h = world.insert_body(bb)
            bname = b.get("name", f"body{h}")
            handles.bodies[bname] = h
            if gravcomp != 0.0:
                handles.gravcomp[bname] = gravcomp
            if mocap:
                handles.mocap.append(bname)
            body_world[bname] = (wpos, wrot)
            insert_geoms(h, b, bcls)
            for site in b.findall("site"):
                handles.sites[site.get("name", f"site{len(handles.sites)}")] = (
                    h, np.asarray(_vec(site.get("pos"), (0, 0, 0)), np.float64))

            # A top-level jointed body anchors to the fixed world body, in
            # world coordinates.
            p_handle, a_pos, a_rot = parent_handle, bpos, brot
            if parent_handle is None and joints and not has_free:
                p_handle, a_pos, a_rot = world_anchor(), wpos, wrot
            if fixed_to_parent and p_handle is not None and not mocap:
                gb = GenericJointBuilder.fixed()
                gb.with_local_anchor1(tuple(a_pos)).with_contacts_enabled(False)
                gb.local_frame_rot1 = tuple(_quat_mul(a_rot, np.asarray(gb.local_frame_rot1)))
                insert_joint(p_handle, h, gb)
            elif not has_free and joints and p_handle is not None:
                j = joints[0]
                attrs = defaults.resolve("joint", j.attrib, j.get("class", bcls))
                jtype = attrs.get("type", "hinge")
                jpos = _vec(attrs.get("pos"), (0, 0, 0))       # body-local
                jaxis = _vec(attrs.get("axis"), (0, 0, 1))     # body-local
                n_hinges = sum(1 for jj in joints if joint_type(jj, bcls) == "hinge")
                if jtype == "ball" or n_hinges > 1:
                    gb, ax_slot = GenericJointBuilder.spherical(), 3
                elif jtype == "hinge":
                    gb, ax_slot = GenericJointBuilder.revolute(jaxis), 3
                elif jtype == "slide":
                    gb, ax_slot = GenericJointBuilder.prismatic(jaxis), 0
                else:
                    gb, ax_slot = None, 0
                if gb is not None:
                    gb.with_local_anchor1(tuple(a_pos + _quat_rotate(a_rot, jpos)))
                    gb.with_local_anchor2(tuple(jpos))
                    gb.with_contacts_enabled(False)
                    if jtype != "ball":
                        # Frame 2 takes X onto the axis in the child; frame 1
                        # is the rest rotation composed with it.
                        gb.local_frame_rot1 = tuple(
                            _quat_mul(a_rot, np.asarray(gb.local_frame_rot2)))
                    if attrs.get("limited", "false") in ("true", "1") and "range" in attrs:
                        rng = _vec(attrs["range"], (0, 0))
                        scale = angle_scale if jtype != "slide" else 1.0
                        gb.with_limits(ax_slot, rng[0] * scale, rng[1] * scale)
                    if "damping" in attrs and float(attrs["damping"]) > 0:
                        gb.with_motor_velocity(ax_slot, 0.0, float(attrs["damping"]))
                    name = j.get("name", f"joint{h}")
                    handles.joints[name] = insert_joint(p_handle, h, gb)
                    handles.joint_axis[name] = ax_slot
                    handles.joint_order.append(name)
            walk(b, h, wpos, wrot, bcls)

    worldbody = root.find("worldbody")
    if worldbody is not None:
        if worldbody.findall("geom"):
            gh = world.insert_body(RigidBodyBuilder.fixed())
            handles.bodies["world"] = gh
            insert_geoms(gh, worldbody, "main")
        walk(worldbody, None, np.asarray(root_translation, float),
             np.array([0.0, 0.0, 0.0, 1.0]), "main")

    act = root.find("actuator")
    if act is not None:
        for a in act:
            if a.tag not in ("motor", "position", "velocity"):
                continue
            attrs = defaults.resolve(a.tag, a.attrib, a.get("class"))
            jname = attrs.get("joint", "")
            gear = float(_vec(attrs.get("gear"), (1.0,))[0])
            kp = float(attrs.get("kp", 0.0))
            kv = float(attrs.get("kv", 0.0))
            handles.actuators.append(MjcfActuator(
                a.get("name", f"act{len(handles.actuators)}"), a.tag, jname, gear, kp, kv))
            j = handles.joints.get(jname)
            if j is not None and world.state is None:
                ax = handles.joint_axis[jname]
                gbj = (world._pending_mb_joints if use_multibody else world._pending_joints)[j][0]
                if a.tag == "position":
                    gbj.with_motor_position(ax, 0.0, kp, kv if kv > 0 else kp * 0.1)
                elif a.tag == "velocity":
                    gbj.with_motor_velocity(ax, 0.0, kv if kv > 0 else 10.0)
                else:
                    gbj.with_motor_velocity(ax, 0.0, 0.0)

    # Fixed tendons and joint equalities become dof couplings (multibody
    # form only, as in the reference); connects and welds impulse joints
    # (rapier3d-mjcf conversion.rs:567-730).
    def add_coupling(jname_a, jname_b, ratio, offset):
        """q_a = ratio * q_b + offset."""
        if not use_multibody:
            return
        ends = []
        for jname in (jname_a, jname_b):
            j = handles.joints.get(jname)
            if j is None:
                return
            ends.append((world._pending_mb_joints[j][2], handles.joint_axis[jname]))
        (ca, aa), (cb_, ab) = ends
        world.insert_dof_coupling(ca, aa, cb_, ab, ratio, offset)
        handles.couplings.append((jname_a, jname_b, ratio, offset))

    tend = root.find("tendon")
    if tend is not None:
        for t in tend.findall("spatial"):
            names = [s.get("site", "") for s in t.findall("site")]
            names = [s for s in names if s in handles.sites]
            if len(names) >= 2:
                handles.spatial_tendons[
                    t.get("name", f"tendon{len(handles.spatial_tendons)}")] = names
        for t in tend.findall("fixed"):
            terms = [(tj.get("joint", ""), float(tj.get("coef", 1.0)))
                     for tj in t.findall("joint")]
            terms = [(j, c) for (j, c) in terms if j in handles.joints]
            handles.tendons[t.get("name", f"tendon{len(handles.tendons)}")] = terms
            # Co-actuation: q_k = (coef_k / coef_0) q_0.
            if len(terms) >= 2 and terms[0][1] != 0.0:
                j0, c0 = terms[0]
                for jk, ck in terms[1:]:
                    add_coupling(jk, j0, ck / c0, 0.0)

    eq = root.find("equality")
    if eq is not None:
        idq = np.array([0.0, 0.0, 0.0, 1.0])
        for e in eq:
            if e.get("active", "true") in ("false", "0"):
                continue
            if e.tag == "joint":
                # q2 = polycoef[1] q1 + polycoef[0] (the linear term only).
                poly = _vec(e.get("polycoef"), (0.0, 1.0, 0.0, 0.0, 0.0))
                j1, j2 = e.get("joint1", ""), e.get("joint2", "")
                if j2:
                    add_coupling(j2, j1, float(poly[1]), float(poly[0]))
            elif e.tag in ("connect", "weld"):
                b1n, b2n = e.get("body1", ""), e.get("body2", "")
                h1 = handles.bodies.get(b1n)
                h2 = handles.bodies.get(b2n) if b2n else world_anchor()
                if h1 is None or h2 is None:
                    continue
                p1, r1 = body_world.get(b1n, (np.zeros(3), idq))
                p2, r2 = body_world.get(b2n, (np.zeros(3), idq))   # no body2: the anchor
                if e.tag == "connect":
                    anchor_local = _vec(e.get("anchor"), (0, 0, 0))
                    wanchor = p1 + _quat_rotate(r1, anchor_local)
                    gb = GenericJointBuilder.spherical()
                    gb.with_local_anchor1(tuple(anchor_local))
                    gb.with_local_anchor2(tuple(_quat_rotate(_quat_conj(r2), wanchor - p2)))
                else:
                    gb = GenericJointBuilder.fixed()
                    gb.with_local_anchor1(tuple(_quat_rotate(_quat_conj(r1), p2 - p1)))
                    gb.local_frame_rot1 = tuple(_quat_mul(_quat_conj(r1), r2))
                gb.with_contacts_enabled(False)
                # Impulse joints even beside a multibody tree: an equality may
                # close a loop the reduced-coordinate tree cannot hold.
                name = e.get("name", f"eq{len(handles.equalities)}")
                handles.equalities[name] = world.insert_impulse_joint(h1, h2, gb)

    kf = root.find("keyframe")
    if kf is not None:
        for k in kf.findall("key"):
            kname = k.get("name", f"key{len(handles.keyframes)}")
            qpos = k.get("qpos")
            if qpos:
                handles.keyframes[kname] = np.asarray([float(x) for x in qpos.split()])
            mpos, mquat = k.get("mpos"), k.get("mquat")
            if mpos or mquat:
                handles.keyframes_mocap[kname] = (
                    np.asarray([float(x) for x in mpos.split()]) if mpos else None,
                    np.asarray([float(x) for x in mquat.split()]) if mquat else None)

    sens = root.find("sensor")
    if sens is not None:
        target_attr = {"jointpos": "joint", "jointvel": "joint", "framepos": "objname",
                       "tendonpos": "tendon"}
        for s in sens:
            if s.tag in target_attr:
                handles.sensors.append((s.get("name", s.tag), s.tag,
                                        s.get(target_attr[s.tag], "")))
    return handles
