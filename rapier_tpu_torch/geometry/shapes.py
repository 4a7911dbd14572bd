"""Per-shape geometry over the padded parameter table (counterpart of
rapier_tpu.geometry.shapes; see its docstring for the ``shape_params``
layouts).  A halfspace (``[nx, ny, nz]``, unbounded) gets the AABB
half-extent `BIG` about its origin, as in the reference."""

from __future__ import annotations

import functools

import torch

from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import ShapeType

BIG = 1.0e10  # AABB half-extent of unbounded shapes (halfspace)


def _absm_vec(abs_m, v):
    """|R| @ v for ``[..., 3, 3]`` x ``[..., 3]``."""
    return torch.stack([
        abs_m[..., i, 0] * v[..., 0] + abs_m[..., i, 1] * v[..., 1]
        + abs_m[..., i, 2] * v[..., 2]
        for i in range(3)
    ], dim=-1)


def compute_aabbs(shape_type, shape_params, pos, rot):
    """Conservative world AABBs.  shape_type ``[..., C]``, shape_params
    ``[..., C, 12]``, pos ``[..., C, 3]``, rot ``[..., C, 4]`` ->
    (mins, maxs) ``[..., C, 3]``."""
    p = shape_params
    m = quat.to_matrix(rot)
    abs_m = torch.abs(m)
    he_cuboid = _absm_vec(abs_m, p[..., 0:3])
    he_round_cuboid = he_cuboid + p[..., 3:4]

    a_w = quat.rotate(rot, p[..., 0:3])
    b_w = quat.rotate(rot, p[..., 3:6])
    cap_center = 0.5 * (a_w + b_w)
    he_segment = torch.abs(a_w - cap_center)
    he_capsule = he_segment + p[..., 6:7]

    unit_y = torch.zeros_like(a_w)
    unit_y[..., 1] = 1.0
    axis = quat.rotate(rot, unit_y)
    disc = torch.sqrt(torch.clamp(1.0 - axis * axis, min=0.0))
    he_cyl = torch.abs(axis) * p[..., 0:1] + p[..., 1:2] * disc
    he_round_cyl = he_cyl + p[..., 2:3]

    ta = quat.rotate(rot, p[..., 0:3])
    tb = quat.rotate(rot, p[..., 3:6])
    tc = quat.rotate(rot, p[..., 6:9])
    tri_min = torch.minimum(torch.minimum(ta, tb), tc)
    tri_max = torch.maximum(torch.maximum(ta, tb), tc)

    mesh_c_l = 0.5 * (p[..., 2:5] + p[..., 5:8])
    mesh_he_l = 0.5 * (p[..., 5:8] - p[..., 2:5])
    he_mesh = _absm_vec(abs_m, mesh_he_l)
    mesh_center = quat.rotate(rot, mesh_c_l)

    st = shape_type[..., None]
    he = torch.full_like(he_cuboid, BIG)
    for types, val in (
        ((ShapeType.CONVEX,), he_mesh + p[..., 1:2]),
        ((ShapeType.TRIMESH, ShapeType.HEIGHTFIELD), he_mesh),
        ((ShapeType.ROUND_CYLINDER, ShapeType.ROUND_CONE), he_round_cyl),
        ((ShapeType.CYLINDER, ShapeType.CONE), he_cyl),
        ((ShapeType.SEGMENT,), he_segment),
        ((ShapeType.CAPSULE,), he_capsule),
        ((ShapeType.ROUND_CUBOID,), he_round_cuboid),
        ((ShapeType.CUBOID,), he_cuboid),
        ((ShapeType.BALL,), p[..., 0:1].expand_as(he)),
    ):
        sel = torch.zeros_like(st, dtype=torch.bool)
        for t in types:
            sel = sel | (st == int(t))
        he = torch.where(sel, val, he)

    zero = torch.zeros_like(cap_center)
    center_off = torch.where(
        (st == ShapeType.CAPSULE) | (st == ShapeType.SEGMENT), cap_center,
        torch.where((st == ShapeType.TRIMESH) | (st == ShapeType.HEIGHTFIELD)
                    | (st == ShapeType.CONVEX), mesh_center, zero))
    mins = pos + center_off - he
    maxs = pos + center_off + he
    is_tri = st == ShapeType.TRIANGLE
    mins = torch.where(is_tri, pos + tri_min, mins)
    maxs = torch.where(is_tri, pos + tri_max, maxs)
    return mins, maxs


@functools.lru_cache(maxsize=None)
def _axes(dtype, device):
    """The constant rows +Y and (1, 0, 1) on `device` (made once: a host
    tensor copied to the card every call would cost a transfer each)."""
    return (torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device),
            torch.tensor([1.0, 0.0, 1.0], dtype=dtype, device=device))


def _dot(a, b):
    """Row dot product over the last axis, ``[..., 3]`` -> ``[..., 1]``."""
    return (a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
            + a[..., 2:3] * b[..., 2:3])


def support_point(shape_type, shape_params, direction, hull_verts=None, types=None):
    """Support point of a convex shape in its local frame for a local
    `direction` (``[..., 3]``, not necessarily unit), the reference's
    `support_point` for every convex type.  Round shapes give the support of
    their inner shape (callers add the border radius along the direction).

    hull_verts: optional ``[..., V, 3]`` per-lane CONVEX vertex slots; a
    CONVEX lane then takes its vertex of largest dot product with the
    direction (the first of equal ones).  Without it, and for the types
    without a support (halfspace, meshes), the result is zeros, as the
    reference's fallthrough gives.

    types: optional collection of the shape types the lanes can hold (a
    census); the other types' branches are not computed.  Lanes of a type
    outside it get zeros."""
    p = shape_params
    d = direction
    dn = d / torch.clamp(torch.sqrt(_dot(d, d)), min=1e-12)
    unit_y, xz = _axes(d.dtype, d.device)

    def want(*ts):
        return types is None or any(int(t) in types for t in ts)

    a, b = p[..., 0:3], p[..., 3:6]
    pick_b = _dot(d, b - a) > 0
    hh, rad = p[..., 0:1], p[..., 1:2]
    branches = []
    if want(ShapeType.TRIANGLE):
        va, vb, vc = p[..., 0:3], p[..., 3:6], p[..., 6:9]
        da, db, dc = _dot(d, va), _dot(d, vb), _dot(d, vc)
        branches.append(((ShapeType.TRIANGLE,), torch.where(
            (da >= db) & (da >= dc), va, torch.where(db >= dc, vb, vc))))
    if want(ShapeType.CYLINDER, ShapeType.ROUND_CYLINDER, ShapeType.CONE, ShapeType.ROUND_CONE):
        d_xz = d * xz
        d_xz_n = d_xz / torch.clamp(torch.sqrt(_dot(d_xz, d_xz)), min=1e-12)
    if want(ShapeType.CONE, ShapeType.ROUND_CONE):
        apex = unit_y.expand(d.shape) * hh
        base_rim = d_xz_n * rad - hh * unit_y
        branches.append(((ShapeType.CONE, ShapeType.ROUND_CONE),
                         torch.where(_dot(d, apex) >= _dot(d, base_rim), apex, base_rim)))
    if want(ShapeType.CYLINDER, ShapeType.ROUND_CYLINDER):
        y_sign = torch.where(d[..., 1:2] >= 0, 1.0, -1.0)
        branches.append(((ShapeType.CYLINDER, ShapeType.ROUND_CYLINDER),
                         d_xz_n * rad + y_sign * hh * unit_y))
    sup_segment = torch.where(pick_b, b, a)
    if want(ShapeType.SEGMENT):
        branches.append(((ShapeType.SEGMENT,), sup_segment))
    if want(ShapeType.CAPSULE):
        branches.append(((ShapeType.CAPSULE,), sup_segment + dn * p[..., 6:7]))
    if want(ShapeType.CUBOID, ShapeType.ROUND_CUBOID):
        branches.append(((ShapeType.CUBOID, ShapeType.ROUND_CUBOID), torch.sign(d) * p[..., 0:3]))
    if want(ShapeType.BALL):
        branches.append(((ShapeType.BALL,), dn * p[..., 0:1]))

    st = shape_type[..., None]
    out = torch.zeros_like(d)
    for ts, val in branches:
        sel = st == int(ts[0])
        for t in ts[1:]:
            sel = sel | (st == int(t))
        out = torch.where(sel, val, out)
    if hull_verts is not None and want(ShapeType.CONVEX):
        hull_verts = hull_verts.expand(d.shape[:-1] + hull_verts.shape[-2:])
        dots = (hull_verts[..., 0] * d[..., None, 0] + hull_verts[..., 1] * d[..., None, 1]
                + hull_verts[..., 2] * d[..., None, 2])              # [..., V]
        best = torch.argmax(dots, dim=-1, keepdim=True)             # the first of equal
        sup_hull = torch.gather(hull_verts, -2, best.unsqueeze(-1).expand(
            best.shape + (3,))).squeeze(-2)
        out = torch.where(st == ShapeType.CONVEX, sup_hull, out)
    return out
