"""Trimesh / heightfield narrow phase: a convex shape against one triangle
(counterpart of rapier_tpu.geometry.narrowphase_mesh).

A broad-phase pair (convex, mesh) expands into `tris_per_pair` sub-lanes,
each holding one candidate triangle chosen by AABB-overlap ranking (the
mid-phase, `dispatch.compute_mesh_manifolds`), and each sub-lane gets its
own contact manifold from the kernels here.  Heightfields are triangulated
when the scene is built, so one path serves both.

The kernels are written over lanes, as those of `narrowphase.py`: vectors
``[..., 3, L]``, per-point rows ``[..., 4, L]``, lanes last.  A ball and a
capsule take their analytic kernels, every other convex type the
sampled-SAT kernel `convex_triangle` (a round shape on its inner shape plus
the border).  As in the reference, no hull table reaches these kernels: a
CONVEX collider's support is zero there, so it meets a mesh as a point plus
its border (ROADMAP R15).
"""

from __future__ import annotations

import torch

from rapier_tpu_torch.geometry.narrowphase import (
    Manifold,
    _manifold,
    _norm,
    _one_point,
    _safe_normalize,
    _transform_point,
)
from rapier_tpu_torch.geometry.narrowphase_convex import _border_radius as npc_border_radius
from rapier_tpu_torch.geometry.shapes import support_point
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.math.quat import cross_cl, dot_cl
from rapier_tpu_torch.types import ShapeType

MESH_TYPES = (ShapeType.TRIMESH, ShapeType.HEIGHTFIELD)
# The ternary search's first probes, which the reference computes from
# The first probes, 1/3 and 2/3, rounded once to the lanes' dtype (the
# later probes are the lanes' arithmetic).
_THIRD = 1.0 / 3.0
_TWO_THIRDS = 2.0 / 3.0


def is_mesh_type(t):
    return (t == ShapeType.TRIMESH) | (t == ShapeType.HEIGHTFIELD)


def _border_radius(stA, prmA):
    """`narrowphase_convex._border_radius` of lane-last parameters
    ``[..., 12, L]``."""
    return npc_border_radius(stA, prmA.transpose(-1, -2))


def _lane_rows(x):
    """``[..., d, L]`` -> ``[..., L, d]``: the row form of `support_point`."""
    return x.transpose(-1, -2)


def _support_world(pA, rA, stA, prmA, d_w, types=None):
    """A's support point for world directions ``d_w [..., S, 3, L]`` (S
    directions a lane): (world point, local point), both ``[..., S, 3, L]``.
    `types`: the shape types the lanes can hold, None for all."""
    d_l = quat.inv_rotate_cl(rA.unsqueeze(-3), d_w)
    s_l = _lane_rows(support_point(stA.unsqueeze(-2), _lane_rows(prmA).unsqueeze(-3),
                                   _lane_rows(d_l), types=types))
    return _transform_point(pA.unsqueeze(-3), rA.unsqueeze(-3), s_l), s_l


# ---------------------------------------------------------------------------
# point / segment vs triangle primitives
# ---------------------------------------------------------------------------


def closest_point_triangle(p, a, b, c):
    """Closest point on triangle abc to p (Ericson 5.1.5, branch-free; the
    regions are evaluated innermost first and overridden outward, the vertex
    regions last).  Vectors ``[..., 3, L]``; leading axes broadcast."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot_cl(ab, ap)
    d2 = dot_cl(ac, ap)
    bp = p - b
    d3 = dot_cl(ab, bp)
    d4 = dot_cl(ac, bp)
    cp = p - c
    d5 = dot_cl(ab, cp)
    d6 = dot_cl(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def col(x):
        return x.unsqueeze(-2)

    denom = torch.clamp(va + vb + vc, min=1e-30)
    res = a + ab * col(vb / denom) + ac * col(vc / denom)          # face interior
    w_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=1e-30), 0, 1)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    res = torch.where(col(on_bc), b + (c - b) * col(w_bc), res)
    w_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0, 1)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    res = torch.where(col(on_ac), a + ac * col(w_ac), res)
    v_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0, 1)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    res = torch.where(col(on_ab), a + ab * col(v_ab), res)
    res = torch.where(col((d6 >= 0) & (d5 <= d6)), c, res)
    res = torch.where(col((d3 >= 0) & (d4 <= d3)), b, res)
    return torch.where(col((d1 <= 0) & (d2 <= 0)), a, res)


def ball_triangle(pA, rA, prmA, v0, v1, v2) -> Manifold:
    rad = prmA[..., 0, :]
    q = closest_point_triangle(pA, v0, v1, v2)
    face = cross_cl(v1 - v0, v2 - v0)
    n, dc = _safe_normalize(q - pA, fallback=face)
    dist = dc - rad
    # Deep-centre case: the triangle's plane normal, oriented from A
    # towards the triangle.
    tn, _ = _safe_normalize(face)
    tn = torch.where((dot_cl(tn, pA - q) > 0).unsqueeze(-2), -tn, tn)
    n = torch.where((dc < 1e-9).unsqueeze(-2), tn, n)
    sa = pA + n * rad.unsqueeze(-2)
    return _one_point(n, 0.5 * (sa + q), dist)


def capsule_triangle(pA, rA, prmA, v0, v1, v2) -> Manifold:
    """The closest segment parameter by a 20-step ternary search (both
    probes of a step in one batched call), then three points: the search's,
    and the two endpoints."""
    a = _transform_point(pA, rA, prmA[..., 0:3, :])
    b = _transform_point(pA, rA, prmA[..., 3:6, :])
    rad = prmA[..., 6, :]
    seg = b - a

    def at(t):
        """Segment points at the parameters ``t [S, ..., L]``."""
        return a + seg * t.unsqueeze(-2)

    def point_dist(t):
        p = at(t)
        return _norm(p - closest_point_triangle(p, v0, v1, v2))

    lo = torch.zeros_like(rad)
    hi = torch.ones_like(rad)
    for i in range(20):
        if i == 0:
            m1, m2 = torch.full_like(rad, _THIRD), torch.full_like(rad, _TWO_THIRDS)
        else:
            m1 = lo + (hi - lo) / 3.0
            m2 = hi - (hi - lo) / 3.0
        d = point_dist(torch.stack([m1, m2]))
        go_right = d[0] > d[1]
        lo = torch.where(go_right, m1, lo)
        hi = torch.where(go_right, hi, m2)
    t_star = 0.5 * (lo + hi)

    cands = torch.stack([t_star, torch.zeros_like(rad), torch.ones_like(rad)])
    p = at(cands)                                      # [3, ..., 3, L]
    q = closest_point_triangle(p, v0, v1, v2)
    n, _ = _safe_normalize(q[0] - p[0], fallback=cross_cl(v1 - v0, v2 - v0))
    dist = dot_cl(q - p, n) - rad
    sa = p + n * rad.unsqueeze(-2)
    points, dists, fids, valids = [], [], [], []
    for k in range(3):
        dup = torch.zeros_like(rad, dtype=torch.bool)
        for prev in range(k):
            dup = dup | (torch.abs(cands[k] - cands[prev]) < 1e-4)
        points.append(0.5 * (sa[k] + q[k]))
        dists.append(torch.where(dup, torch.full_like(rad, 1e10), dist[k]))
        fids.append(torch.full_like(rad, k, dtype=torch.int32))
        valids.append(~dup)
    return _manifold(n, points, dists, fids, valids)


def _triangle_sat(pA, rA, stA, prmA, v0, v1, v2, types=None):
    """Sampled-SAT gap and axis between a convex shape and one triangle.
    Axes: the triangle normal, the centre line, A's frame axes and the
    crosses of A's axes with the triangle's edges, each oriented from A
    towards the triangle.  Returns (dist ``[..., L]``, n ``[..., 3, L]``):
    the core shared by `convex_triangle` and mesh CCD."""
    bA = _border_radius(stA, prmA)
    centroid = (v0 + v1 + v2) / 3.0
    tn, _ = _safe_normalize(cross_cl(v1 - v0, v2 - v0))
    mA = quat.to_matrix_cl(rA)                         # [..., 3, 3, L]
    center = centroid - pA

    edges = [v1 - v0, v2 - v1, v0 - v2]
    axes = [tn, center]
    for i in range(3):
        col = mA[..., :, i, :]
        axes.append(col)
        for e in edges:
            axes.append(cross_cl(col, e))
    cand = torch.stack(axes, dim=-3)                   # [..., 14, 3, L]
    norms = _norm(cand).unsqueeze(-2)
    cand = cand / torch.clamp(norms, min=1e-9)
    degenerate = norms[..., 0, :] < 1e-6
    sgn = torch.where(dot_cl(cand, center.unsqueeze(-3)) >= 0, 1.0, -1.0)
    cand = cand * sgn.unsqueeze(-2)

    sa, _ = _support_world(pA, rA, stA, prmA, cand, types)
    tri_min = torch.minimum(torch.minimum(dot_cl(v0.unsqueeze(-3), cand),
                                          dot_cl(v1.unsqueeze(-3), cand)),
                            dot_cl(v2.unsqueeze(-3), cand))
    gaps = tri_min - dot_cl(cand, sa) - bA.unsqueeze(-2)
    gaps = torch.where(degenerate, -1e10, gaps)
    best = torch.argmax(gaps, dim=-2, keepdim=True)    # the first of equal gaps
    n = torch.gather(cand, -3, best.unsqueeze(-2).expand(cand.shape[:-3] + (1, 3)
                                                         + cand.shape[-1:]))
    return torch.amax(gaps, dim=-2), n.squeeze(-3)


def triangle_gap(pA, rA, stA, prmA, v0, v1, v2):
    """Signed separation estimate of a convex shape against one triangle
    (for mesh CCD)."""
    return _triangle_sat(pA, rA, stA, prmA, v0, v1, v2)[0]


def convex_triangle(pA, rA, stA, prmA, v0, v1, v2, types=None) -> Manifold:
    """A convex shape against a triangle: the sampled-SAT axis, then a support
    patch of 4 points (A's support along the axis tilted towards 4 tangent
    directions), the deepest anchored to the SAT gap.  Feature ids hash the
    quantised local support points (int32, wrapping), so they stay stable
    across steps."""
    bA = _border_radius(stA, prmA)
    dist, n = _triangle_sat(pA, rA, stA, prmA, v0, v1, v2, types)

    ex = torch.zeros_like(n)
    ex[..., 0, :] = 1.0
    ey = torch.zeros_like(n)
    ey[..., 1, :] = 1.0
    t1 = cross_cl(n, ex)
    t1 = torch.where((_norm(t1) < 1e-6).unsqueeze(-2), cross_cl(n, ey), t1)
    t1 = t1 / torch.clamp(_norm(t1), min=1e-9).unsqueeze(-2)
    t2 = cross_cl(n, t1)
    eps = 0.04
    tilts = torch.stack([t1 + t2, t1 - t2, -t1 + t2, -t1 - t2], dim=-3)
    sw, sl = _support_world(pA, rA, stA, prmA, n.unsqueeze(-3) + eps * tilts, types)
    sw = sw + (n * bA.unsqueeze(-2)).unsqueeze(-3)     # [..., 4, 3, L]

    # Per-point separation along n (A -> triangle): from A's support point to
    # the plane through the triangle's vertex of least n-projection.
    proj = torch.stack([dot_cl(v, n) for v in (v0, v1, v2)], dim=-2)
    pick = torch.argmin(proj, dim=-2, keepdim=True)    # the first of equal
    verts = torch.stack([v0, v1, v2], dim=-3)
    tri_sup = torch.gather(verts, -3, pick.unsqueeze(-2).expand(
        verts.shape[:-3] + (1, 3) + verts.shape[-1:])).squeeze(-3)
    depths = dot_cl(tri_sup, n).unsqueeze(-2) - dot_cl(sw, n.unsqueeze(-3))

    qs = torch.round(sl * 1024.0).to(torch.int32)
    fid = ((qs[..., 0, :] * 73856093) ^ (qs[..., 1, :] * 19349663)
           ^ (qs[..., 2, :] * 83492791))
    fid = torch.remainder(torch.abs(fid), 1000003)

    points, dists, fids, valids = [], [], [], []
    for k in range(4):
        dup = torch.zeros_like(dist, dtype=torch.bool)
        for prev in range(k):
            dup = dup | (_norm(sw[..., k, :, :] - sw[..., prev, :, :]) < 1e-6)
        d = depths[..., k, :]
        points.append(sw[..., k, :, :] + (0.5 * d).unsqueeze(-2) * n)
        dists.append(torch.where(dup, torch.full_like(d, 1e10), d))
        fids.append(fid[..., k, :])
        valids.append(~dup)
    man = _manifold(n, points, dists, fids, valids)
    # Anchor the deepest point to the SAT gap.
    min_d = torch.amin(torch.where(man.valid, man.dist, 1e10), dim=-2, keepdim=True)
    return man._replace(dist=torch.where(man.valid, man.dist + (dist.unsqueeze(-2) - min_d),
                                         man.dist))
