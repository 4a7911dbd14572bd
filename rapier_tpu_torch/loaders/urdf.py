"""URDF robot loader (counterpart of rapier_tpu.loaders.urdf, after the
rapier3d-urdf crate, crates/rapier3d-urdf/src/lib.rs:78-556).

Each ``<link>`` becomes a rigid body (dynamic, or fixed for the root under
``fixed_base``), each ``<collision>`` geometry a collider on it (box, sphere,
cylinder, capsule, or a mesh file read by `loaders.meshfiles`: OBJ, STL,
Collada; a geometry it cannot read is skipped), and each ``<joint>`` an
impulse joint, or a reduced-coordinate multibody joint with
``use_multibody=True``: revolute and continuous (a hinge), prismatic and
fixed; floating and planar joints leave the child free.  A link's
``<inertial>`` mass is used only when it has no collider (as additional
mass).  Poses are assembled by walking the joints from each root link.
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from rapier_tpu_torch.loaders.meshfiles import load_mesh_file
from rapier_tpu_torch.world import (
    ColliderBuilder,
    GenericJointBuilder,
    PhysicsWorld,
    RigidBodyBuilder,
)
from rapier_tpu_torch.world import _np_quat_mul as _quat_mul
from rapier_tpu_torch.world import _np_quat_rotate as _quat_rotate


def _parse_vec(s: Optional[str], default=(0.0, 0.0, 0.0)):
    if not s:
        return np.asarray(default, float)
    return np.asarray([float(x) for x in s.split()], float)


def _rpy_to_quat(rpy):
    """URDF fixed-axis roll-pitch-yaw as a quaternion (x, y, z, w)."""
    r, p, y = rpy
    cr, sr = math.cos(r / 2), math.sin(r / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def _origin(elem):
    if elem is None:
        return np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])
    return _parse_vec(elem.get("xyz")), _rpy_to_quat(_parse_vec(elem.get("rpy")))


@dataclass
class UrdfRobotHandles:
    """Handles produced by loading (reference UrdfRobotHandles)."""

    bodies: dict = field(default_factory=dict)   # link name -> body handle
    joints: dict = field(default_factory=dict)   # joint name -> joint handle
    joint_names: list = field(default_factory=list)
    use_multibody: bool = False


def _geometry_collider(geom_elem, mesh_dir: str) -> Optional[ColliderBuilder]:
    """The collider of a ``<geometry>``: URDF cylinders and capsules lie
    along +Z (the port's cylinder along +Y is turned onto it); a box's size
    is its full extent."""
    box = geom_elem.find("box")
    if box is not None:
        size = _parse_vec(box.get("size"), (1, 1, 1))
        return ColliderBuilder.cuboid(size[0] / 2, size[1] / 2, size[2] / 2)
    sphere = geom_elem.find("sphere")
    if sphere is not None:
        return ColliderBuilder.ball(float(sphere.get("radius", 0.5)))
    cyl = geom_elem.find("cylinder")
    if cyl is not None:
        r = float(cyl.get("radius", 0.5))
        length = float(cyl.get("length", 1.0))
        return ColliderBuilder.cylinder(length / 2, r).with_rotation((math.pi / 2, 0.0, 0.0))
    capsule = geom_elem.find("capsule")
    if capsule is not None:
        r = float(capsule.get("radius", 0.5))
        length = float(capsule.get("length", 1.0))
        return ColliderBuilder.capsule_z(length / 2, r)
    mesh = geom_elem.find("mesh")
    if mesh is not None:
        fn = mesh.get("filename", "").replace("package://", "")
        path = fn if os.path.isabs(fn) else os.path.join(mesh_dir, fn)
        tri = load_mesh_file(path)
        if tri is not None:
            v, t = tri
            return ColliderBuilder.trimesh(v * _parse_vec(mesh.get("scale"), (1, 1, 1)), t)
    return None


def load_urdf(path_or_string: str, world: PhysicsWorld, *,
              root_translation=(0.0, 0.0, 0.0), fixed_base: bool = False,
              mesh_dir: Optional[str] = None,
              use_multibody: bool = False) -> UrdfRobotHandles:
    """Parse a URDF model (a file path, or the XML itself) and insert the
    robot into `world` (UrdfRobot::from_file with
    insert_using_impulse_joints, or insert_using_multibody_joints under
    `use_multibody`, where `handles.joints` holds pending multibody-joint
    ids: `world.multibody_link_of` maps their bodies to (tree, link) after
    build()).  Mesh files resolve against `mesh_dir`, by default the model
    file's directory."""
    if os.path.exists(path_or_string):
        root = ET.parse(path_or_string).getroot()
        mesh_dir = mesh_dir or os.path.dirname(path_or_string)
    else:
        root = ET.fromstring(path_or_string)
        mesh_dir = mesh_dir or "."
    assert root.tag == "robot", f"not a URDF file (root <{root.tag}>)"

    links = {link.get("name"): link for link in root.findall("link")}
    joints = root.findall("joint")
    children: dict = {}
    child_links = set()
    for j in joints:
        children.setdefault(j.find("parent").get("link"), []).append(j)
        child_links.add(j.find("child").get("link"))
    roots = [name for name in links if name not in child_links]

    handles = UrdfRobotHandles(use_multibody=use_multibody)

    def insert_link(name, pos, rot, is_root):
        link = links[name]
        bb = (RigidBodyBuilder.fixed() if (is_root and fixed_base)
              else RigidBodyBuilder.dynamic())
        bb.translation = tuple(pos)
        bb.rotation = tuple(rot)
        h = world.insert_body(bb)
        ncol = 0
        for col in link.findall("collision"):
            cpos, crot = _origin(col.find("origin"))
            cb = _geometry_collider(col.find("geometry"), mesh_dir)
            if cb is None:
                continue
            base_pos, base_rot = np.asarray(cb.translation), np.asarray(cb.rotation)
            cb.translation = tuple(cpos + _quat_rotate(crot, base_pos))
            cb.rotation = tuple(_quat_mul(crot, base_rot))
            world.insert_collider(cb, h)
            ncol += 1
        inertial = link.find("inertial")
        if inertial is not None:
            mass_el = inertial.find("mass")
            if mass_el is not None and ncol == 0:
                bb.additional_mass = float(mass_el.get("value", 0.0))
        handles.bodies[name] = h

    def walk(name, pos, rot, is_root):
        insert_link(name, pos, rot, is_root)
        for j in children.get(name, []):
            jpos, jrot = _origin(j.find("origin"))
            walk(j.find("child").get("link"), pos + _quat_rotate(rot, jpos),
                 _quat_mul(rot, jrot), False)

    for r in roots:
        walk(r, np.asarray(root_translation, float).copy(),
             np.array([0.0, 0.0, 0.0, 1.0]), True)

    for j in joints:
        jtype = j.get("type")
        pname = j.find("parent").get("link")
        cname = j.find("child").get("link")
        jpos, jrot = _origin(j.find("origin"))
        axis_el = j.find("axis")
        axis = _parse_vec(axis_el.get("xyz") if axis_el is not None else None, (1.0, 0.0, 0.0))
        # The axis lives in the joint (child-at-zero) frame: frame 2 takes
        # X onto it in the child, frame 1 is the joint origin's rotation
        # composed with it, so the frames coincide at q = 0.
        if jtype in ("revolute", "continuous"):
            gb = GenericJointBuilder.revolute(axis)
        elif jtype == "prismatic":
            gb = GenericJointBuilder.prismatic(axis)
        elif jtype == "fixed":
            gb = GenericJointBuilder.fixed()
        else:
            continue      # floating, planar or unknown: no joint
        gb.with_local_anchor1(tuple(jpos)).with_local_anchor2((0.0, 0.0, 0.0))
        gb.with_contacts_enabled(False)
        gb.local_frame_rot1 = tuple(_quat_mul(jrot, np.asarray(gb.local_frame_rot2)))
        limit = j.find("limit")
        if limit is not None and jtype in ("revolute", "prismatic"):
            lo = float(limit.get("lower", 0.0))
            hi = float(limit.get("upper", 0.0))
            if hi > lo:
                gb.with_limits(3 if jtype == "revolute" else 0, lo, hi)
        insert = world.insert_multibody_joint if use_multibody else world.insert_impulse_joint
        handles.joints[j.get("name")] = insert(handles.bodies[pname], handles.bodies[cname], gb)
        handles.joint_names.append(j.get("name"))
    return handles
