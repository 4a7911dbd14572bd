"""MJCF (MuJoCo XML) loader, the subset the port carries (counterpart of
rapier_tpu.loaders.mjcf).

Covered: ``<compiler angle>``; the ``<worldbody>`` tree of ``<body name pos>``
elements; free joints, and hinge joints with ``axis``, ``pos``, ``limited``
and ``range``; box, capsule (``size`` with ``fromto``) and plane geoms with
``density`` and ``friction``; ``position``, ``motor`` and ``velocity``
actuators with ``joint``, ``kp``, ``kv`` and ``gear``.  Joints are inserted as
reduced-coordinate multibody joints (``use_multibody=True``) or as impulse
joints (``use_multibody=False``).  Every other element or attribute raises
NotImplementedError naming it, so nothing the reference would read is
dropped silently.

Semantics follow the reference loader: world geoms hang on a fixed body, a
body with a free joint is a free dynamic body (an articulation root), a
top-level hinged body is jointed to a fixed world anchor made at first need,
a hinge's frames put the joint axis on X and coincide at the assembled rest
pose, contacts between a body and its joint parent are disabled, MJCF
contype/conaffinity map to collision groups, and a position actuator
installs a PD motor (kv defaults to kp/10).
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from rapier_tpu_torch.world import (
    ColliderBuilder,
    GenericJointBuilder,
    PhysicsWorld,
    RigidBodyBuilder,
)
from rapier_tpu_torch.world import _np_quat_mul as _quat_mul
from rapier_tpu_torch.world import _np_quat_rotate as _quat_rotate

_ROOT_TAGS = {"compiler", "worldbody", "actuator"}
_ATTRS = {
    "mujoco": {"model"},
    "compiler": {"angle"},
    "worldbody": set(),
    "body": {"name", "pos"},
    "geom": {"name", "type", "size", "fromto", "density", "friction"},
    "joint": {"name", "type", "axis", "pos", "limited", "range"},
    "actuator": set(),
    "position": {"name", "joint", "kp", "kv", "gear"},
    "motor": {"name", "joint", "gear"},
    "velocity": {"name", "joint", "kv", "gear"},
}
_BODY_CHILDREN = {"body", "geom", "joint"}


def _unsupported(what: str):
    raise NotImplementedError(f"MJCF {what} is not ported")


def _check_attrs(elem):
    for a in elem.attrib:
        if a not in _ATTRS.get(elem.tag, set()):
            _unsupported(f"attribute {elem.tag}.{a}")


def _vec(s, default):
    if s is None:
        return np.asarray(default, float)
    return np.asarray([float(x) for x in s.split()], float)


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
    """Loaded-model handles (reference MjcfRobotHandles)."""

    bodies: dict = field(default_factory=dict)       # body name -> handle
    joints: dict = field(default_factory=dict)       # joint name -> joint id
    joint_axis: dict = field(default_factory=dict)   # joint name -> axis slot
    actuators: list = field(default_factory=list)    # [MjcfActuator]
    joint_order: list = field(default_factory=list)  # qpos order (1-dof joints)
    use_multibody: bool = True
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

    def apply_controls(self, world: PhysicsWorld, ctrl):
        """Drive the actuators: position -> motor target position, motor and
        velocity -> motor target velocity, each scaled by its gear.  Writes
        the world's (batch-of-one) state in place."""
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


def _geom_collider(attrs) -> ColliderBuilder:
    gtype = attrs.get("type", "sphere")
    size = _vec(attrs.get("size"), (0.0, 0.0, 0.0))
    if gtype == "plane":
        cb = ColliderBuilder.halfspace((0, 0, 1))   # plane normal = local +Z
    elif gtype == "box":
        cb = ColliderBuilder.cuboid(size[0], size[1], size[2])
    elif gtype == "capsule":
        if attrs.get("fromto") is None:
            _unsupported("capsule geom without fromto")
        ft = _vec(attrs["fromto"], (0, 0, 0, 0, 0, 1))
        cb = ColliderBuilder.capsule_from_endpoints(ft[:3], ft[3:6], size[0])
    else:
        _unsupported(f"geom type {gtype!r}")
    if "friction" in attrs:
        cb.friction = float(_vec(attrs["friction"], (1.0, 0.005, 0.0001))[0])
    if "density" in attrs:
        cb.density = float(attrs["density"])
    # contype = conaffinity = 1 -> interaction groups (reference hooks.rs).
    cb.collision_groups = (1 << 16) | 1
    return cb


def load_mjcf(xml: str, world: PhysicsWorld, *, use_multibody: bool = True
              ) -> MjcfRobotHandles:
    """Parse an MJCF model (an XML string) and insert it into `world`.
    MJCF is Z-up: scenes built from it set gravity to (0, 0, -9.81)."""
    root = ET.fromstring(xml)
    if root.tag != "mujoco":
        raise ValueError(f"not an MJCF document (root <{root.tag}>)")
    _check_attrs(root)
    for child in root:
        if child.tag not in _ROOT_TAGS:
            _unsupported(f"element <{child.tag}>")
        _check_attrs(child)
    compiler = root.find("compiler")
    angle_unit = compiler.get("angle", "degree") if compiler is not None else "degree"
    angle_scale = math.pi / 180.0 if angle_unit == "degree" else 1.0

    handles = MjcfRobotHandles(use_multibody=use_multibody)
    anchor = []

    def insert_joint(parent, child, gb):
        if use_multibody:
            return world.insert_multibody_joint(parent, child, gb)
        return world.insert_impulse_joint(parent, child, gb)

    def world_anchor():
        """The fixed body at the origin that top-level hinged bodies are
        jointed to, made at first need."""
        if not anchor:
            anchor.append(world.insert_body(RigidBodyBuilder.fixed()))
        return anchor[0]

    def insert_geoms(body_handle, elem):
        for g in elem.findall("geom"):
            _check_attrs(g)
            world.insert_collider(_geom_collider(g.attrib), body_handle)

    def walk(elem, parent_handle, parent_pos, parent_rot):
        for b in elem.findall("body"):
            _check_attrs(b)
            for c in b:
                if c.tag not in _BODY_CHILDREN:
                    _unsupported(f"element <{c.tag}> in a body")
            bpos = _vec(b.get("pos"), (0, 0, 0))
            brot = np.array([0.0, 0.0, 0.0, 1.0])
            wpos = parent_pos + _quat_rotate(parent_rot, bpos)
            wrot = _quat_mul(parent_rot, brot)
            joints = b.findall("joint")
            for j in joints:
                _check_attrs(j)
            types = [j.get("type", "hinge") for j in joints]
            has_free = "free" in types
            if not joints:
                _unsupported("body without a joint (fixed joint)")
            if len(joints) > 1:
                _unsupported("body with several joints")
            bb = RigidBodyBuilder.dynamic()
            bb.translation = tuple(wpos)
            bb.rotation = tuple(wrot)
            h = world.insert_body(bb)
            handles.bodies[b.get("name", f"body{h}")] = h
            insert_geoms(h, b)
            if not has_free:
                j = joints[0]
                if types[0] != "hinge":
                    _unsupported(f"joint type {types[0]!r}")
                # A top-level hinge anchors to the world body, in world
                # coordinates.
                p_handle, a_pos, a_rot = parent_handle, bpos, brot
                if parent_handle is None:
                    p_handle, a_pos, a_rot = world_anchor(), wpos, wrot
                jpos = _vec(j.get("pos"), (0, 0, 0))
                gb = GenericJointBuilder.revolute(_vec(j.get("axis"), (0, 0, 1)))
                gb.with_local_anchor1(tuple(a_pos + _quat_rotate(a_rot, jpos)))
                gb.with_local_anchor2(tuple(jpos))
                gb.with_contacts_enabled(False)
                gb.local_frame_rot1 = tuple(_quat_mul(a_rot, np.asarray(gb.local_frame_rot2)))
                if j.get("limited", "false") in ("true", "1") and "range" in j.attrib:
                    rng = _vec(j.get("range"), (0, 0))
                    gb.with_limits(3, rng[0] * angle_scale, rng[1] * angle_scale)
                name = j.get("name", f"joint{h}")
                handles.joints[name] = insert_joint(p_handle, h, gb)
                handles.joint_axis[name] = 3
                handles.joint_order.append(name)
            walk(b, h, wpos, wrot)

    worldbody = root.find("worldbody")
    if worldbody is not None:
        for c in worldbody:
            if c.tag not in ("body", "geom"):
                _unsupported(f"element <{c.tag}> in the worldbody")
        if worldbody.findall("geom"):
            gh = world.insert_body(RigidBodyBuilder.fixed())
            handles.bodies["world"] = gh
            insert_geoms(gh, worldbody)
        walk(worldbody, None, np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))

    act = root.find("actuator")
    if act is not None:
        for a in act:
            if a.tag not in ("motor", "position", "velocity"):
                _unsupported(f"actuator <{a.tag}>")
            _check_attrs(a)
            jname = a.get("joint", "")
            gear = float(_vec(a.get("gear"), (1.0,))[0])
            kp = float(a.get("kp", 0.0))
            kv = float(a.get("kv", 0.0))
            handles.actuators.append(MjcfActuator(
                a.get("name", f"act{len(handles.actuators)}"), a.tag, jname, gear, kp, kv))
            j = handles.joints.get(jname)
            if j is not None and world.state is None:
                ax = handles.joint_axis[jname]
                gbj = (world._pending_mb_joints if use_multibody
                       else world._pending_joints)[j][0]
                if a.tag == "position":
                    gbj.with_motor_position(ax, 0.0, kp, kv if kv > 0 else kp * 0.1)
                elif a.tag == "velocity":
                    gbj.with_motor_velocity(ax, 0.0, kv if kv > 0 else 10.0)
                else:
                    gbj.with_motor_velocity(ax, 0.0, 0.0)
    return handles
