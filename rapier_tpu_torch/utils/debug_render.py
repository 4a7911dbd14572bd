"""Debug render export: line lists for bodies, colliders, joints and contacts
(counterpart of `rapier_tpu.utils.debug_render`; upstream's
DebugRenderPipeline, debug_render_pipeline.rs:53).

`debug_render(state)` returns numpy line segments (starts ``[K, 3]``, ends
``[K, 3]``, colors ``[K, 4]``) that a viewer can draw as they are.  The
port's state carries a leading scene axis, so it renders one scene of the
batch (`scene=`, 0 by default).  Each leaf it needs is copied to the host
once; the lines are built there, in the reference's order: collider
outlines (the sleep color on a sleeping body's colliders), trimesh and
heightfield wireframes from the shared triangle table, hull edges, body
axes, the contact normals of the active points of touching lanes, and the
joint lines.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from rapier_tpu_torch.types import ShapeType

_COLLIDER_COLOR = (0.2, 0.8, 0.3, 1.0)
_SLEEP_COLOR = (0.4, 0.4, 0.9, 1.0)
_CONTACT_COLOR = (0.9, 0.2, 0.2, 1.0)
_JOINT_COLOR = (0.9, 0.7, 0.1, 1.0)


class DebugRenderMode:
    """What to draw: upstream's DebugRenderMode bit flags
    (debug_render_pipeline.rs:12-40)."""

    COLLIDER_SHAPES = 1 << 0
    RIGID_BODY_AXES = 1 << 1
    IMPULSE_JOINTS = 1 << 2
    CONTACTS = 1 << 3
    DEFAULT = COLLIDER_SHAPES | IMPULSE_JOINTS | CONTACTS
    ALL = COLLIDER_SHAPES | RIGID_BODY_AXES | IMPULSE_JOINTS | CONTACTS


@dataclass
class DebugRenderStyle:
    """Colors and lengths (upstream's DebugRenderStyle,
    debug_render_style.rs)."""

    collider_color: tuple = _COLLIDER_COLOR
    sleep_color: tuple = _SLEEP_COLOR
    contact_color: tuple = _CONTACT_COLOR
    joint_color: tuple = _JOINT_COLOR
    contact_normal_length: float = 0.2
    body_axes_length: float = 0.5


def _q_rot(q, v):
    u, w = q[:3], q[3]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _shape_outline(st, prm):
    """A shape's outline in its local frame, as pairs of points."""
    segs = []
    if st == ShapeType.CUBOID or st == ShapeType.ROUND_CUBOID:
        h = prm[0:3]
        corners = np.array([
            [sx * h[0], sy * h[1], sz * h[2]]
            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
        ])
        edges = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7),
                 (5, 1), (5, 4), (5, 7), (6, 2), (6, 4), (6, 7)]
        segs = [(corners[a], corners[b]) for a, b in edges]
    elif st == ShapeType.BALL:
        r = prm[0]
        for axis in range(3):
            pts = []
            for k in range(17):
                a = 2 * math.pi * k / 16
                p = np.zeros(3)
                p[(axis + 1) % 3] = math.cos(a) * r
                p[(axis + 2) % 3] = math.sin(a) * r
                pts.append(p)
            segs += list(zip(pts[:-1], pts[1:]))
    elif st == ShapeType.CAPSULE:
        a, b, r = prm[0:3], prm[3:6], prm[6]
        d = b - a
        n = np.linalg.norm(d)
        u = d / n if n > 1e-9 else np.array([0, 1, 0.0])
        p1 = np.cross(u, [1, 0, 0])
        if np.linalg.norm(p1) < 1e-6:
            p1 = np.cross(u, [0, 1, 0])
        p1 /= np.linalg.norm(p1)
        p2 = np.cross(u, p1)
        for off in (p1 * r, -p1 * r, p2 * r, -p2 * r):
            segs.append((a + off, b + off))
        segs.append((a - u * r, b + u * r))
    elif st in (ShapeType.CYLINDER, ShapeType.CONE, ShapeType.ROUND_CYLINDER):
        hh, r = prm[0], prm[1]
        top_r = 0.0 if st == ShapeType.CONE else r
        for k in range(16):
            a0 = 2 * math.pi * k / 16
            a1 = 2 * math.pi * (k + 1) / 16
            b0 = np.array([math.cos(a0) * r, -hh, math.sin(a0) * r])
            b1 = np.array([math.cos(a1) * r, -hh, math.sin(a1) * r])
            segs.append((b0, b1))
            if top_r > 0:
                t0 = np.array([math.cos(a0) * top_r, hh, math.sin(a0) * top_r])
                t1 = np.array([math.cos(a1) * top_r, hh, math.sin(a1) * top_r])
                segs.append((t0, t1))
            if k % 4 == 0:
                tp = np.array([math.cos(a0) * top_r, hh, math.sin(a0) * top_r])
                segs.append((b0, tp))
    elif st == ShapeType.HALFSPACE:
        n = prm[0:3]
        t1 = np.cross(n, [1, 0, 0])
        if np.linalg.norm(t1) < 1e-6:
            t1 = np.cross(n, [0, 1, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        for k in range(-4, 5):
            segs.append((t1 * 10 + t2 * k * 2.5, -t1 * 10 + t2 * k * 2.5))
            segs.append((t2 * 10 + t1 * k * 2.5, -t2 * 10 + t1 * k * 2.5))
    return segs


def _hull_outline(verts_padded):
    """A convex hull's edges from its padded vertex slots, the faces rebuilt
    on the host with the world builder's hull code.  A hull that fails to
    rebuild draws nothing, as in the reference (ROADMAP R32)."""
    v = np.asarray(verts_padded, float)
    _, uniq_idx = np.unique(np.round(v, 6), axis=0, return_index=True)
    pts = v[np.sort(uniq_idx)]
    if len(pts) < 4:
        return [(a, b) for a in pts for b in pts if not np.array_equal(a, b)]
    try:
        from rapier_tpu_torch.world import _build_hull

        _, faces, verts, _, _ = _build_hull(pts, max(len(pts), 8))
        edges = set()
        for f in np.asarray(faces):
            for e in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
                edges.add((min(e), max(e)))
        return [(verts[a], verts[b]) for a, b in edges]
    except Exception:
        return []


def _host(x):
    """The one scene of a leaf, copied to the host once."""
    return x[0].detach().cpu().numpy()


def debug_render(state, *, render_contacts: bool = True, render_joints: bool = True,
                 mode: int = None, style: DebugRenderStyle = None, scene: int = 0):
    """(starts ``[K, 3]``, ends ``[K, 3]``, colors ``[K, 4]``): the world-space
    lines of scene `scene` of the batch `state`.

    `mode` is a DebugRenderMode bit mask (by default the colliders, and the
    contacts and joints as the two booleans say); `style` a
    DebugRenderStyle."""
    from rapier_tpu_torch.geometry.dispatch import collider_world_poses
    from rapier_tpu_torch.types import tree_map

    style = style or DebugRenderStyle()
    state = tree_map(lambda x: x[scene:scene + 1] if x.dim() else x, state)
    if mode is None:
        mode = DebugRenderMode.COLLIDER_SHAPES
        if render_contacts:
            mode |= DebugRenderMode.CONTACTS
        if render_joints:
            mode |= DebugRenderMode.IMPULSE_JOINTS

    bodies = state.bodies
    colliders = state.colliders
    w_pos, w_rot = collider_world_poses(bodies, colliders)
    w_pos, w_rot = _host(w_pos), _host(w_rot)
    st = _host(colliders.shape_type)
    prm = _host(colliders.shape_params)
    enabled = _host(colliders.enabled)
    parent = _host(colliders.parent)
    sleeping = _host(bodies.sleeping)

    starts, ends, colors = [], [], []
    mesh_tris = _host(state.meshes.triangles) if state.meshes is not None else None
    mesh_verts = _host(state.meshes.vertices) if state.meshes is not None else None
    hull_verts = _host(state.hulls.vertices) if state.hulls is not None else None
    if mode & DebugRenderMode.COLLIDER_SHAPES:
        for i in range(len(st)):
            if not enabled[i]:
                continue
            color = style.collider_color
            if parent[i] >= 0 and sleeping[parent[i]]:
                color = style.sleep_color
            sti = int(st[i])
            segs = _shape_outline(sti, prm[i])
            if sti in (int(ShapeType.TRIMESH), int(ShapeType.HEIGHTFIELD)) \
                    and mesh_tris is not None:
                t0, tc = int(prm[i][0]), int(prm[i][1])
                for tri in mesh_tris[t0:t0 + tc]:
                    if tri[0] < 0:
                        continue
                    va, vb, vc = mesh_verts[tri[0]], mesh_verts[tri[1]], mesh_verts[tri[2]]
                    segs += [(va, vb), (vb, vc), (vc, va)]
            elif sti == int(ShapeType.CONVEX) and hull_verts is not None:
                segs += _hull_outline(hull_verts[int(prm[i][0])])
            for a, b in segs:
                starts.append(w_pos[i] + _q_rot(w_rot[i], a))
                ends.append(w_pos[i] + _q_rot(w_rot[i], b))
                colors.append(color)

    pos = _host(bodies.pos)
    if mode & DebugRenderMode.RIGID_BODY_AXES:
        rot = _host(bodies.rot)
        en_b = _host(bodies.enabled)
        for i in range(len(pos)):
            if not en_b[i]:
                continue
            for ax in range(3):
                e = np.zeros(3)
                e[ax] = style.body_axes_length
                c4 = [0.0, 0.0, 0.0, 1.0]
                c4[ax] = 1.0
                starts.append(pos[i])
                ends.append(pos[i] + _q_rot(rot[i], e))
                colors.append(tuple(c4))

    if mode & DebugRenderMode.CONTACTS:
        c = state.contacts
        touching = _host(c.touching)
        pts = _host(c.point)          # [4, 3, P], lane last
        nrm = _host(c.normal)         # [3, P]
        act = _host(c.point_active)   # [4, P]
        for p in np.where(touching)[0]:
            for k in np.where(act[:, p])[0]:
                starts.append(pts[k, :, p])
                ends.append(pts[k, :, p] + nrm[:, p] * style.contact_normal_length)
                colors.append(style.contact_color)

    if mode & DebugRenderMode.IMPULSE_JOINTS and state.joints is not None:
        j = state.joints
        b1, b2 = _host(j.body1), _host(j.body2)
        en = _host(j.enabled)
        for k in np.where(en & (b1 >= 0))[0]:
            starts.append(pos[b1[k]])
            ends.append(pos[b2[k]])
            colors.append(style.joint_color)

    if not starts:
        return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 4))
    return np.asarray(starts), np.asarray(ends), np.asarray(colors)
