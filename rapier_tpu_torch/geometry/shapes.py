"""Per-shape geometry over the padded parameter table (counterpart of
rapier_tpu.geometry.shapes; see its docstring for the ``shape_params``
layouts).  A halfspace (``[nx, ny, nz]``, unbounded) gets the AABB
half-extent `BIG` about its origin, as in the reference."""

from __future__ import annotations

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


def support_point(shape_type, shape_params, direction):
    """Support point of a shape in its local frame for a local `direction`
    (``[..., 3]``, not necessarily unit), the reference's `support_point`
    for the shapes the port carries: ball, cuboid and capsule; other types
    give zeros, as the reference's fallthrough does."""
    p = shape_params
    d = direction
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    sup_ball = dn * p[..., 0:1]
    sup_cuboid = torch.sign(d) * p[..., 0:3]
    a, b, r = p[..., 0:3], p[..., 3:6], p[..., 6:7]
    pick_b = torch.sum(d * (b - a), dim=-1, keepdim=True) > 0
    sup_capsule = torch.where(pick_b, b, a) + dn * r
    st = shape_type[..., None]
    return torch.where(
        st == ShapeType.BALL, sup_ball,
        torch.where(st == ShapeType.CUBOID, sup_cuboid,
                    torch.where(st == ShapeType.CAPSULE, sup_capsule,
                                torch.zeros_like(d))))
