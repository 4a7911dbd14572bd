"""The generic convex-convex contact kernel: GJK/EPA and a support-patch
manifold (counterpart of rapier_tpu.geometry.narrowphase_convex).

It covers every convex pair without an analytic kernel (a cylinder, cone,
segment, round shape or hull against any convex shape):

1. the exact normal and signed distance from `gjk.contact_support_maps`;
2. the manifold from support points of both shapes sampled along the
   normal tilted towards 4 tangent directions: the flatter patch supplies
   the points, each point's depth is measured against the other shape's
   tangent plane, and the deepest is anchored to the exact distance.

Feature ids hash the quantised local support points (int32 arithmetic,
wrapping as the reference's), so they stay stable across steps for the
warmstart match.  `support_gap` is the cheap sampled-SAT separation
estimate (the reference's shape casts and CCD use it).

Lanes come FIRST here, as in `gjk.py`: vectors ``[L, 3]``, quaternions
``[L, 4]``, types ``[L]``, parameter rows ``[L, 12]``, hull vertex slots
``[L, V, 3]``; the returned `Manifold` is lane-first too (normal ``[L, 3]``,
point ``[L, 4, 3]``, dist, fid and valid ``[L, 4]``), the transpose of
`narrowphase.py`'s lane-last layout.
"""

from __future__ import annotations

import torch

from rapier_tpu_torch.geometry.gjk import contact_support_maps
from rapier_tpu_torch.geometry.narrowphase import Manifold
from rapier_tpu_torch.geometry.shapes import support_point
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import ShapeType

# Shapes this kernel accepts.
SUPPORTED = (
    ShapeType.BALL, ShapeType.CUBOID, ShapeType.CAPSULE, ShapeType.SEGMENT,
    ShapeType.CYLINDER, ShapeType.CONE, ShapeType.ROUND_CUBOID,
    ShapeType.ROUND_CYLINDER, ShapeType.ROUND_CONE, ShapeType.CONVEX,
)


def _border_radius(st, prm):
    """The round shapes' border radius (not the ball's or capsule's radius,
    which their support points include); ``prm [..., 12]``."""
    zero = torch.zeros_like(prm[..., 0])
    return torch.where(
        st == ShapeType.ROUND_CUBOID, prm[..., 3],
        torch.where((st == ShapeType.ROUND_CYLINDER) | (st == ShapeType.ROUND_CONE),
                    prm[..., 2],
                    torch.where(st == ShapeType.CONVEX, prm[..., 1], zero)))


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _col(x):
    return x.unsqueeze(-1)


def _support_world(p, r, st, prm, hull, d_w, types=None):
    """Support points for world directions ``d_w [L, S, 3]`` (S a lane):
    (world point, local point), both ``[L, S, 3]``."""
    s = d_w.shape[1]
    r_s = r.unsqueeze(1)
    h = None if hull is None else hull.unsqueeze(1)
    s_l = support_point(st.unsqueeze(1).expand(-1, s), prm.unsqueeze(1),
                        quat.inv_rotate(r_s, d_w), h, types)
    return quat.transform_point(p.unsqueeze(1), r_s, s_l), s_l


def support_gap(pA, rA, stA, prmA, pB, rB, stB, prmB, hullA=None, hullB=None, types=None):
    """Sampled-SAT separation estimate: (gap [L], axis [L, 3] A -> B) over
    16 axes (the centre line, both frames' axes and their crosses).
    `types`: the shape types the lanes can hold, None for all."""
    bA = _border_radius(stA, prmA)
    bB = _border_radius(stB, prmB)
    mA = quat.to_matrix(rA)
    mB = quat.to_matrix(rB)
    center = pB - pA
    axes = [center]
    for i in range(3):
        axes.append(mA[..., :, i])
        axes.append(mB[..., :, i])
    for i in range(3):
        for k in range(3):
            axes.append(quat.cross(mA[..., :, i], mB[..., :, k]))
    cand = torch.stack(axes, 1)                              # [L, 16, 3]
    norms = _norm(cand)
    cand = cand / _col(torch.clamp(norms, min=1e-9))
    degenerate = norms < 1e-6
    sgn = torch.where(_dot(cand, center.unsqueeze(1)) >= 0, 1.0, -1.0)
    cand = cand * _col(sgn)
    sb, _ = _support_world(pB, rB, stB, prmB, hullB, -cand, types)
    sa, _ = _support_world(pA, rA, stA, prmA, hullA, cand, types)
    gaps = _dot(cand, sb) - _dot(cand, sa) - _col(bA) - _col(bB)
    gaps = torch.where(degenerate, -1e10, gaps)
    best = torch.argmax(gaps, dim=1, keepdim=True)           # the first of equal
    axis = torch.gather(cand, 1, best.unsqueeze(-1).expand(-1, 1, 3)).squeeze(1)
    return torch.amax(gaps, dim=1), axis


def _var4(x):
    """Variance over the 4 samples of ``x [L, 4, 3]`` per coordinate, summed
    over the coordinates (jnp.var's order of operations)."""
    mean = (x[:, 0] + x[:, 1] + x[:, 2] + x[:, 3]) / 4.0
    c = x - mean.unsqueeze(1)
    c = c * c
    var = (c[:, 0] + c[:, 1] + c[:, 2] + c[:, 3]) / 4.0
    return var[:, 0] + var[:, 1] + var[:, 2]


def convex_convex(pA, rA, stA, prmA, pB, rB, stB, prmB, hullA=None, hullB=None,
                  types=None) -> Manifold:
    """The contact manifold of two convex shapes a lane (lane-first, see the
    module docstring); the normal points from A towards B.  `types`: the
    shape types the lanes can hold (a census), None for all."""
    bA = _border_radius(stA, prmA)
    bB = _border_radius(stB, prmB)
    dist, n, _, _ = contact_support_maps(pA, rA, stA, prmA, pB, rB, stB, prmB, hullA, hullB,
                                         types)

    ex = torch.zeros_like(n)
    ex[:, 0] = 1.0
    ey = torch.zeros_like(n)
    ey[:, 1] = 1.0
    t1 = quat.cross(n, ex)
    t1 = torch.where(_col(_norm(t1) < 1e-6), quat.cross(n, ey), t1)
    t1 = t1 / _col(torch.clamp(_norm(t1), min=1e-9))
    t2 = quat.cross(n, t1)
    eps = 0.04
    tilts = torch.stack([t1 + t2, t1 - t2, -t1 + t2, -t1 - t2], 1)   # [L, 4, 3]
    dA = n.unsqueeze(1) + eps * tilts
    nb = n.unsqueeze(1)
    sa, la = _support_world(pA, rA, stA, prmA, hullA, dA, types)
    sb, lb = _support_world(pB, rB, stB, prmB, hullB, -dA, types)
    sa4 = sa + nb * bA.view(-1, 1, 1)
    sb4 = sb - nb * bB.view(-1, 1, 1)

    # The smaller patch supplies the points: the contact region is bounded
    # by the smaller feature (a box corner on a wide face, a cylinder rim).
    use_a = _var4(sa4) <= _var4(sb4)
    plane_b, _ = _support_world(pB, rB, stB, prmB, hullB, -nb, types)
    plane_b = plane_b - nb * bB.view(-1, 1, 1)
    plane_a, _ = _support_world(pA, rA, stA, prmA, hullA, nb, types)
    plane_a = plane_a + nb * bA.view(-1, 1, 1)

    ua = use_a.view(-1, 1, 1)
    pts = torch.where(ua, sa4, sb4)
    local = torch.where(ua, la, lb)
    depth_a_side = _dot(sa4 - plane_b, nb)                   # [L, 4]
    depth_b_side = _dot(plane_a - sb4, nb)
    depths = torch.where(_col(use_a), depth_a_side, depth_b_side)
    half = torch.where(ua, 0.5, -0.5)
    mids = pts - half * _col(depths) * nb

    qs = torch.round(local * 1024.0).to(torch.int32)
    fid = (qs[..., 0] * 73856093) ^ (qs[..., 1] * 19349663) ^ (qs[..., 2] * 83492791)
    fid = torch.remainder(torch.abs(fid), 1000003)

    valids = []
    for k in range(4):
        dup = torch.zeros_like(use_a)
        for prev in range(k):
            dup = dup | (_norm(pts[:, k] - pts[:, prev]) < 1e-6)
        valids.append(~dup & torch.isfinite(depths[:, k]))
    valid = torch.stack(valids, 1)
    d = torch.where(valid, depths, 1e10)
    # Anchor the deepest point to the exact distance (the plane-based depth
    # can overestimate penetration on curved shapes).
    min_d = torch.amin(torch.where(valid, d, 1e10), dim=1, keepdim=True)
    d = torch.where(valid, d + (_col(dist) - min_d), d)
    return Manifold(normal=n, point=mids, dist=d, fid=fid.to(torch.int32), valid=valid)
