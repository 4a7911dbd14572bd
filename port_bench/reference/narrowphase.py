# Frozen copy of rapier_tpu_torch/geometry/narrowphase.py at commit 4adbf044245c; imports
# made relative to this package.  Do not edit: it is the benchmark's yardstick.
"""Analytic contact-manifold kernels over pair lanes (counterpart of
rapier_tpu.geometry.narrowphase).

The reference writes each kernel for ONE pair and `vmap`s it over the
lane-last axis.  Here every kernel is written directly over lanes: vectors
are ``[..., 3, P]``, per-point rows ``[..., 4, P]`` and per-point vectors
``[..., 4, 3, P]`` (component axis at -2, lanes last).  Conventions are the
reference's: the normal points from shape A towards shape B, dist < 0 is
penetration, the point is the midpoint of the two surface points, and
feature ids stay stable across steps for warmstart matching.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import quat
from .quat import cross_cl, dot_cl
from .types import ShapeType

MAXP = 4  # contact points per manifold (reference MAX_MANIFOLD_POINTS, 3D)


class Manifold(NamedTuple):
    normal: torch.Tensor  # [..., 3, P]
    point: torch.Tensor   # [..., 4, 3, P]
    dist: torch.Tensor    # [..., 4, P]
    fid: torch.Tensor     # [..., 4, P] int32
    valid: torch.Tensor   # [..., 4, P] bool (geometric validity)


def _c(a, i):
    return a[..., i, :]


def _unit_y(like):
    """Unit +Y vectors shaped like a ``[..., 3, P]`` tensor."""
    u = torch.zeros_like(like)
    u[..., 1, :] = 1.0
    return u


def _norm(v):
    return torch.sqrt(dot_cl(v, v))


def _safe_normalize(v, fallback=None, eps=1e-9):
    n = _norm(v)
    fb = _unit_y(v) if fallback is None else fallback
    return torch.where((n > eps).unsqueeze(-2), v / torch.clamp(n, min=eps).unsqueeze(-2),
                       fb), n


def _transform_point(p, r, v):
    return p + quat.rotate_cl(r, v)


def _inverse_transform_point(p, r, v):
    return quat.inv_rotate_cl(r, v - p)


def _manifold(normal, points, dists, fids, valids):
    """Stack per-point lists (length <= 4) into a Manifold, padding the
    missing points as inactive (point 0, dist 1e10, fid -1)."""
    lane = dists[0]
    while len(points) < MAXP:
        points.append(torch.zeros_like(normal))
        dists.append(torch.full_like(lane, 1e10))
        fids.append(torch.full_like(lane, -1, dtype=torch.int32))
        valids.append(torch.zeros_like(lane, dtype=torch.bool))
    return Manifold(
        normal=normal,
        point=torch.stack(points, dim=-3),
        dist=torch.stack(dists, dim=-2),
        fid=torch.stack([f.to(torch.int32) for f in fids], dim=-2),
        valid=torch.stack(valids, dim=-2),
    )


def _one_point(normal, point, dist):
    return _manifold(normal, [point], [dist],
                     [torch.zeros_like(dist, dtype=torch.int32)],
                     [torch.ones_like(dist, dtype=torch.bool)])


# ---------------------------------------------------------------------------
# ball vs ball
# ---------------------------------------------------------------------------


def ball_ball(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    ra, rb = _c(prmA, 0), _c(prmB, 0)
    n, dist_centers = _safe_normalize(pB - pA)
    dist = dist_centers - ra - rb
    sa = pA + n * ra.unsqueeze(-2)
    sb = pB - n * rb.unsqueeze(-2)
    return _one_point(n, 0.5 * (sa + sb), dist)


# ---------------------------------------------------------------------------
# point / segment helpers
# ---------------------------------------------------------------------------


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _closest_on_segment(a, b, p):
    ab = b - a
    t = dot_cl(p - a, ab) / torch.clamp(dot_cl(ab, ab), min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    return a + ab * t.unsqueeze(-2), t


def _closest_segment_segment(p1, q1, p2, q2):
    """Closest points between segments [p1,q1], [p2,q2] (Ericson 5.1.9,
    branch-free).  Returns (s, t, c1, c2)."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = dot_cl(d1, d1)
    e = dot_cl(d2, d2)
    f = dot_cl(d2, r)
    c = dot_cl(d1, r)
    b = dot_cl(d1, d2)
    denom = a * e - b * b
    s = torch.where(
        denom > 1e-12,
        torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-12), 0.0, 1.0),
        torch.zeros_like(denom))
    t = (b * s + f) / torch.clamp(e, min=1e-12)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(
        t != t_cl,
        torch.clamp((b * t_cl - c) / torch.clamp(a, min=1e-12), 0.0, 1.0), s)
    s = torch.where(a <= 1e-12, torch.zeros_like(s), s)
    t_cl = torch.where(e <= 1e-12, torch.zeros_like(t_cl), t_cl)
    c1 = p1 + d1 * s.unsqueeze(-2)
    c2 = p2 + d2 * t_cl.unsqueeze(-2)
    return s, t_cl, c1, c2


def _capsule_world_segment(p, r, prm):
    a = _transform_point(p, r, prm[..., 0:3, :])
    b = _transform_point(p, r, prm[..., 3:6, :])
    return a, b, _c(prm, 6)


# ---------------------------------------------------------------------------
# ball vs capsule / capsule vs capsule
# ---------------------------------------------------------------------------


def ball_capsule(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    rad_a = _c(prmA, 0)
    a, b, rad_b = _capsule_world_segment(pB, rB, prmB)
    q, _t = _closest_on_segment(a, b, pA)
    n, dc = _safe_normalize(q - pA)
    dist = dc - rad_a - rad_b
    sa = pA + n * rad_a.unsqueeze(-2)
    sb = q - n * rad_b.unsqueeze(-2)
    return _one_point(n, 0.5 * (sa + sb), dist)


def capsule_capsule(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    a1, b1, r1 = _capsule_world_segment(pA, rA, prmA)
    a2, b2, r2 = _capsule_world_segment(pB, rB, prmB)
    _s, _t, c1, c2 = _closest_segment_segment(a1, b1, a2, b2)
    n, dc = _safe_normalize(c2 - c1)
    r1v, r2v = r1.unsqueeze(-2), r2.unsqueeze(-2)
    dist0 = dc - r1 - r2
    p0 = 0.5 * ((c1 + n * r1v) + (c2 - n * r2v))

    # Near-parallel capsules: a second point from the other end of the
    # overlap region (parry gives 2-point manifolds for parallel capsules).
    d1 = b1 - a1
    d2 = b2 - a2
    cr = cross_cl(d1, d2)
    parallel = dot_cl(cr, cr) < 1e-6 * dot_cl(d1, d1) * dot_cl(d2, d2)
    len1 = _norm(d1)
    u = d1 / torch.clamp(len1, min=1e-12).unsqueeze(-2)
    ta = dot_cl(a2 - a1, u)
    tb = dot_cl(b2 - a1, u)
    zero = torch.zeros_like(ta)
    lo = _clip(torch.minimum(ta, tb), zero, len1)
    hi = _clip(torch.maximum(ta, tb), zero, len1)
    t_c1 = dot_cl(c1 - a1, u)
    t_far = torch.where(torch.abs(hi - t_c1) > torch.abs(lo - t_c1), hi, lo)
    p1b = a1 + u * t_far.unsqueeze(-2)
    q2b, _ = _closest_on_segment(a2, b2, p1b)
    _n2, dc2 = _safe_normalize(q2b - p1b, fallback=n)
    dist2 = dc2 - r1 - r2
    p1 = 0.5 * ((p1b + n * r1v) + (q2b - n * r2v))
    use2 = parallel & (hi - lo > 1e-6)
    return _manifold(
        n, [p0, p1], [dist0, torch.where(use2, dist2, torch.full_like(dist2, 1e10))],
        [torch.zeros_like(dist0, dtype=torch.int32),
         torch.ones_like(dist0, dtype=torch.int32)],
        [torch.ones_like(use2), use2])


# ---------------------------------------------------------------------------
# ball vs cuboid
# ---------------------------------------------------------------------------


def _point_box_signed(p_local, h):
    """Signed distance, outward normal and surface point of points vs boxes
    (box-local frame, ``[..., 3, P]``); inside points use the deepest face."""
    q = _clip(p_local, -h, h)
    outside_vec = p_local - q
    d_out = _norm(outside_vec)
    inside = d_out < 1e-12
    face_d = h - torch.abs(p_local)
    ax = torch.argmin(face_d, dim=-2, keepdim=True)
    oh = (torch.arange(3, device=h.device).view(3, 1) == ax).to(p_local.dtype)
    sgn = torch.where(dot_cl(oh, p_local) >= 0, 1.0, -1.0).unsqueeze(-2)
    n_in = oh * sgn
    surf_in = p_local * (1.0 - oh) + oh * sgn * h
    n_out = outside_vec / torch.clamp(d_out, min=1e-12).unsqueeze(-2)
    dist = torch.where(inside, -torch.amin(face_d, dim=-2), d_out)
    ins = inside.unsqueeze(-2)
    return dist, torch.where(ins, n_in, n_out), torch.where(ins, surf_in, q)


def ball_cuboid(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    rad = _c(prmA, 0)
    h = prmB[..., 0:3, :]
    c_local = _inverse_transform_point(pB, rB, pA)
    dist_c, n_local, surf_local = _point_box_signed(c_local, h)
    n = -quat.rotate_cl(rB, n_local)
    surf_w = _transform_point(pB, rB, surf_local)
    sa = pA + n * rad.unsqueeze(-2)
    return _one_point(n, 0.5 * (sa + surf_w), dist_c - rad)


# ---------------------------------------------------------------------------
# capsule vs cuboid
# ---------------------------------------------------------------------------


def capsule_cuboid(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    a, b, rad = _capsule_world_segment(pA, rA, prmA)
    h = prmB[..., 0:3, :]
    al = _inverse_transform_point(pB, rB, a)
    bl = _inverse_transform_point(pB, rB, b)

    def seg_point(t):
        return al + (bl - al) * t.unsqueeze(-2)

    # Golden-section search for the closest segment parameter, one probe
    # per iteration (reference narrowphase.py capsule_cuboid).
    gr = 0.6180339887498949
    lo = torch.zeros_like(rad)
    hi = torch.ones_like(rad)
    x1 = torch.full_like(rad, 1.0 - gr)
    x2 = torch.full_like(rad, gr)
    f1 = _point_box_signed(seg_point(x1), h)[0]
    f2 = _point_box_signed(seg_point(x2), h)[0]
    for _ in range(20):
        left = f1 < f2
        lo = torch.where(left, lo, x1)
        hi = torch.where(left, x2, hi)
        xp = torch.where(left, hi - gr * (hi - lo), lo + gr * (hi - lo))
        fp = _point_box_signed(seg_point(xp), h)[0]
        x1, f1, x2, f2 = (
            torch.where(left, xp, x2), torch.where(left, fp, f2),
            torch.where(left, x1, xp), torch.where(left, f1, fp),
        )
    cands = [0.5 * (lo + hi), torch.zeros_like(rad), torch.ones_like(rad)]

    dists, normals_l, surfs_l, pts_l = [], [], [], []
    for t in cands:
        pl = seg_point(t)
        d, n_l, surf_l = _point_box_signed(pl, h)
        dists.append(d - rad)
        normals_l.append(n_l)
        surfs_l.append(surf_l)
        pts_l.append(pl)

    # Candidates ranked by depth (ties by index), picked by one-hot sums.
    rank = [
        sum(((dists[j] < dists[i]) | ((dists[j] == dists[i]) & (j < i))).to(torch.int64)
            for j in range(3))
        for i in range(3)
    ]
    oh_rank = [[(rank[c] == s).to(rad.dtype) for c in range(3)] for s in range(3)]

    def pick3(rows, s):
        o = oh_rank[s]
        if rows[0].dim() > o[0].dim():
            o = [x.unsqueeze(-2) for x in o]
        return o[0] * rows[0] + o[1] * rows[1] + o[2] * rows[2]

    n_prim_l = pick3(normals_l, 0)
    n = -quat.rotate_cl(rB, n_prim_l)
    radv = rad.unsqueeze(-2)
    pts_w = [
        0.5 * ((_transform_point(pB, rB, pts_l[i]) + n * radv)
               + _transform_point(pB, rB, surfs_l[i]))
        for i in range(3)
    ]
    pts_sorted = [pick3(pts_w, s) for s in range(3)]
    dists_sorted = [pick3(dists, s) for s in range(3)]
    ndots = [dot_cl(normals_l[c], n_prim_l) for c in range(3)]
    nrm_dot = [pick3(ndots, s) for s in range(3)]
    fid_sorted = [oh_rank[s][1] + 2.0 * oh_rank[s][2] for s in range(3)]

    points, pdists, fids, valids = [], [], [], []
    for k in range(3):
        dup = torch.zeros_like(rad, dtype=torch.bool)
        for prev in range(k):
            dup = dup | (_norm(pts_sorted[k] - pts_sorted[prev]) < 1e-5)
        keep = (nrm_dot[k] > 0.98) & ~dup
        points.append(pts_sorted[k])
        pdists.append(torch.where(keep, dists_sorted[k],
                                  torch.full_like(rad, 1e10)))
        fids.append(fid_sorted[k].to(torch.int32))
        valids.append(keep)
    return _manifold(n, points, pdists, fids, valids)


# ---------------------------------------------------------------------------
# ball / capsule vs halfspace (analytic), convex vs halfspace (support)
# ---------------------------------------------------------------------------


def _plane_normal(rB, prmB):
    n_w, _ = _safe_normalize(quat.rotate_cl(rB, prmB[..., 0:3, :]))
    return n_w


def ball_halfspace(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    rad = _c(prmA, 0)
    n_w = _plane_normal(rB, prmB)
    depth = dot_cl(pA - pB, n_w) - rad
    surf = pA - n_w * rad.unsqueeze(-2)
    proj = surf - n_w * depth.unsqueeze(-2)
    return _one_point(-n_w, 0.5 * (surf + proj), depth)


def capsule_halfspace(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    a, b, rad = _capsule_world_segment(pA, rA, prmA)
    n_w = _plane_normal(rB, prmB)
    points, dists = [], []
    for e in (a, b):
        depth = dot_cl(e - pB, n_w) - rad
        surf = e - n_w * rad.unsqueeze(-2)
        proj = surf - n_w * depth.unsqueeze(-2)
        points.append(0.5 * (surf + proj))
        dists.append(depth)
    lane = dists[0]
    return _manifold(-n_w, points, dists,
                     [torch.zeros_like(lane, dtype=torch.int32),
                      torch.ones_like(lane, dtype=torch.int32)],
                     [torch.ones_like(lane, dtype=torch.bool)] * 2)


def convex_halfspace(pA, rA, stA, prmA, pB, rB, prmB, hullA=None, types=None) -> Manifold:
    """Convex shape A vs halfspace B: A's support function sampled along the
    plane normal tilted towards 4 tangent directions (a resting cuboid gives
    its 4 bottom corners, a lying capsule 2 distinct points).  Round shapes
    sample their inner shape, offset by the border.  Feature ids hash the
    quantised local support points, so they stay stable across steps.
    hullA: the CONVEX lanes' vertex slots, one row a lane ``[..., P, V, 3]``
    (None: a CONVEX lane has a zero support, as in the reference).  `types`:
    the shape types the lanes can hold (a census), None for all."""
    from .shapes import support_point

    n_w = _plane_normal(rB, prmB)
    ex = torch.zeros_like(n_w)
    ex[..., 0, :] = 1.0
    t1 = cross_cl(n_w, ex)
    t1_alt = cross_cl(n_w, _unit_y(n_w))
    t1 = torch.where((_norm(t1) < 1e-6).unsqueeze(-2), t1_alt, t1)
    t1, _ = _safe_normalize(t1)
    t2 = cross_cl(n_w, t1)
    eps = 0.04
    dirs_w = [-n_w + eps * (t1 + t2), -n_w + eps * (t1 - t2),
              -n_w + eps * (-t1 + t2), -n_w + eps * (-t1 - t2)]

    is_round = ((stA == ShapeType.ROUND_CUBOID) | (stA == ShapeType.ROUND_CYLINDER)
                | (stA == ShapeType.ROUND_CONE))
    zero = torch.zeros_like(_c(prmA, 0))
    border = torch.where(
        stA == ShapeType.ROUND_CUBOID, _c(prmA, 3),
        torch.where(is_round, _c(prmA, 2),
                    torch.where(stA == ShapeType.CONVEX, _c(prmA, 1), zero)))
    prm_rows = prmA.transpose(-1, -2)                  # [..., P, 12]
    sw, sl = [], []
    for d_w in dirs_w:
        d_l = quat.inv_rotate_cl(rA, d_w)
        s_l = support_point(stA, prm_rows, d_l.transpose(-1, -2), hullA,
                            types).transpose(-1, -2)
        sw.append(_transform_point(pA, rA, s_l))
        sl.append(s_l)
    bv = border.unsqueeze(-2)
    points, dists, fids, valids = [], [], [], []
    for k in range(4):
        depth = dot_cl(sw[k] - pB, n_w) - border
        qs = torch.round(sl[k] * 1024.0).to(torch.int32)
        fid = ((_c(qs, 0) * 73856093) ^ (_c(qs, 1) * 19349663)
               ^ (_c(qs, 2) * 83492791))
        fid = torch.remainder(torch.abs(fid), 1000003)
        dup = torch.zeros_like(depth, dtype=torch.bool)
        for prev in range(k):
            dup = dup | (_norm(sw[k] - sw[prev]) < 1e-6)
        keep = ~dup
        surf_a = sw[k] - n_w * bv
        proj = surf_a - n_w * depth.unsqueeze(-2)
        points.append(0.5 * (surf_a + proj))
        dists.append(torch.where(keep, depth, torch.full_like(depth, 1e10)))
        fids.append(fid)
        valids.append(keep)
    return _manifold(-n_w, points, dists, fids, valids)


def swapped(kernel):
    """Adapt a kernel written for (X, Y) order to (Y, X) lanes: swap the
    shape arguments and flip the resulting normal."""

    def run(pA, rA, prmA, pB, rB, prmB):
        man = kernel(pB, rB, prmB, pA, rA, prmA)
        return man._replace(normal=-man.normal)

    return run
