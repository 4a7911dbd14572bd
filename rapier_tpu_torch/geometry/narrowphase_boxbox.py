"""Cuboid-cuboid contact manifold via SAT + reference-face clipping
(counterpart of rapier_tpu.geometry.narrowphase_boxbox.cuboid_cuboid_cl).

Lane-last and branch-free, as in the reference: the edge-axis SAT is a
closed-form 3x3 expression, only the selected reference face builds a
manifold, and the quad-rectangle clip enumerates the intersection polygon's
vertices as a masked candidate list.  Feature ids are the reference's bit
for bit: face points carry a quadrant code, edge contacts ``(1 << 28) +
edge index``.

Layouts: vectors ``[..., 3, P]``, 3x3 matrices ``[..., 3, 3, P]`` (row,
column, lane), per-corner vectors ``[..., 4, 3, P]``.
"""

from __future__ import annotations

import torch

from rapier_tpu_torch.geometry.narrowphase import (
    Manifold,
    _closest_segment_segment,
)
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.math.quat import cross_cl, dot_cl

_EDGE_BIAS_ABS = 1.0e-2
_REF_FACE_BIAS_ABS = 2.0e-3
_BIG = 1.0e10


def _e(m, i, j):
    return m[..., i, j, :]


def _m3v(m, v):
    """m @ v."""
    return torch.stack([
        _e(m, i, 0) * v[..., 0, :] + _e(m, i, 1) * v[..., 1, :]
        + _e(m, i, 2) * v[..., 2, :]
        for i in range(3)
    ], dim=-2)


def _m3tv(m, v):
    """m^T @ v."""
    return torch.stack([
        _e(m, 0, i) * v[..., 0, :] + _e(m, 1, i) * v[..., 1, :]
        + _e(m, 2, i) * v[..., 2, :]
        for i in range(3)
    ], dim=-2)


def _m3t_m3(a, b):
    """a^T b."""
    return torch.stack([
        torch.stack([
            _e(a, 0, i) * _e(b, 0, j) + _e(a, 1, i) * _e(b, 1, j)
            + _e(a, 2, i) * _e(b, 2, j)
            for j in range(3)
        ], dim=-2)
        for i in range(3)
    ], dim=-3)


def _m3_corners(m, cv):
    return torch.stack([_m3v(m, cv[..., c, :, :]) for c in range(4)], dim=-3)


def _corners_dot(cv, w):
    """Per-corner dot ``[..., 4, 3, P] . [..., 3, P] -> [..., 4, P]``."""
    return (cv[..., :, 0, :] * w[..., 0:1, :] + cv[..., :, 1, :] * w[..., 1:2, :]
            + cv[..., :, 2, :] * w[..., 2:3, :])


def _onehot3(idx, n=3):
    """``[..., P]`` int -> ``[..., n, P]`` float one-hot."""
    ids = torch.arange(n, device=idx.device).view(n, 1)
    return (ids == idx.unsqueeze(-2)).to(torch.float32)


def _face_candidates_cl(verts_uvd, hu, hv):
    """Vertices of (convex quad) ∩ (rectangle [-hu,hu]x[-hv,hv]) as a masked
    candidate list: verts ``[..., 4, 3, P]`` (u, v, depth), hu/hv
    ``[..., P]`` -> (pts ``[..., 12, 3, P]``, valid ``[..., 12, P]``)."""
    v0 = verts_uvd
    d = torch.roll(verts_uvd, -1, dims=-3) - v0

    def axis_window(p0, dp, h):
        tiny = torch.abs(dp) < 1e-12
        safe = torch.where(tiny, torch.ones_like(dp), dp)
        h = h.unsqueeze(-2)
        ta = (-h - p0) / safe
        tb = (h - p0) / safe
        lo = torch.minimum(ta, tb)
        hi = torch.maximum(ta, tb)
        inside = torch.abs(p0) <= h
        big = torch.full_like(lo, _BIG)
        lo = torch.where(tiny, torch.where(inside, -big, big), lo)
        hi = torch.where(tiny, torch.where(inside, big, -big), hi)
        return lo, hi

    lo_u, hi_u = axis_window(v0[..., :, 0, :], d[..., :, 0, :], hu)
    lo_v, hi_v = axis_window(v0[..., :, 1, :], d[..., :, 1, :], hv)
    t0 = torch.clamp(torch.maximum(lo_u, lo_v), min=0.0)
    t1 = torch.clamp(torch.minimum(hi_u, hi_v), max=1.0)
    hits = t0 <= t1
    pa = v0 + d * t0.unsqueeze(-2)
    pb = v0 + d * t1.unsqueeze(-2)

    # Rect corners inside the quad: consistent edge-cross signs.
    su = torch.tensor([1.0, -1.0, -1.0, 1.0], device=hu.device).view(4, 1)
    sv = torch.tensor([1.0, 1.0, -1.0, -1.0], device=hu.device).view(4, 1)
    corners = torch.stack([su * hu.unsqueeze(-2), sv * hv.unsqueeze(-2)],
                          dim=-2)                                # [..., 4, 2, P]
    rel = corners.unsqueeze(-4) - v0[..., :, None, :2, :]        # [..., 4e, 4c, 2, P]
    cross = (d[..., :, None, 0, :] * rel[..., 1, :]
             - d[..., :, None, 1, :] * rel[..., 0, :])           # [..., 4e, 4c, P]
    inside = torch.all(cross >= -1e-9, dim=-3) | torch.all(cross <= 1e-9, dim=-3)

    # Affine depth over the face from two edge vectors at vertex 0.
    e0, e1 = d[..., 0, :, :], -d[..., 3, :, :]
    det = e0[..., 0, :] * e1[..., 1, :] - e0[..., 1, :] * e1[..., 0, :]
    safe_det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    gu = (e0[..., 2, :] * e1[..., 1, :] - e1[..., 2, :] * e0[..., 1, :]) / safe_det
    gv = (e1[..., 2, :] * e0[..., 0, :] - e0[..., 2, :] * e1[..., 0, :]) / safe_det
    c_rel_u = corners[..., :, 0, :] - v0[..., 0, 0, :].unsqueeze(-2)
    c_rel_v = corners[..., :, 1, :] - v0[..., 0, 1, :].unsqueeze(-2)
    c_depth = (v0[..., 0, 2, :].unsqueeze(-2) + c_rel_u * gu.unsqueeze(-2)
               + c_rel_v * gv.unsqueeze(-2))
    c_uvd = torch.cat([corners, c_depth.unsqueeze(-2)], dim=-2)
    pts = torch.cat([pa, pb, c_uvd], dim=-3)
    valid = torch.cat([hits, hits, inside], dim=-2)
    return pts, valid


def _reduce_candidates_cl(pts_uvd, valid):
    """Deepest, farthest, then the two extremes across the first two:
    ``[..., 12, 3, P]`` -> (pts ``[..., 4, 3, P]``, keep ``[..., 4, P]``)."""
    n = pts_uvd.shape[-3]
    U, V = pts_uvd[..., :, 0, :], pts_uvd[..., :, 1, :]
    du = U.unsqueeze(-2) - U.unsqueeze(-3)                      # [..., i, j, P]
    dv = V.unsqueeze(-2) - V.unsqueeze(-3)
    k = torch.arange(n, device=U.device)
    earlier = (k.view(1, n) < k.view(n, 1)).unsqueeze(-1)       # j < i
    dup = (du * du + dv * dv < 1e-10) & valid.unsqueeze(-3) & earlier
    valid = valid & ~torch.any(dup, dim=-2)

    def pick(i):
        idx = i.unsqueeze(-2).unsqueeze(-2).expand(
            i.shape[:-1] + (1, 3, i.shape[-1]))
        pt = torch.gather(pts_uvd, -3, idx).squeeze(-3)
        ok = torch.gather(valid, -2, i.unsqueeze(-2)).squeeze(-2)
        return pt, ok

    big = torch.full_like(U, _BIG)
    i0 = torch.argmin(torch.where(valid, pts_uvd[..., :, 2, :], big), dim=-2)
    r0, v0 = pick(i0)
    p0u, p0v = r0[..., 0:1, :], r0[..., 1:2, :]
    dd = (U - p0u) ** 2 + (V - p0v) ** 2
    i1 = torch.argmax(torch.where(valid, dd, -big), dim=-2)
    r1, v1 = pick(i1)
    base_u = r1[..., 0:1, :] - p0u
    base_v = r1[..., 1:2, :] - p0v
    side = (U - p0u) * (-base_v) + (V - p0v) * base_u
    i2 = torch.argmax(torch.where(valid, side, -big), dim=-2)
    i3 = torch.argmin(torch.where(valid, side, big), dim=-2)
    r2, v2 = pick(i2)
    r3, v3 = pick(i3)

    sel = [i0, i1, i2, i3]
    out_valid = [v0, v1, v2, v3]
    keep = []
    for a in range(4):
        ka = out_valid[a]
        for b in range(a):
            ka = ka & (sel[a] != sel[b])
        keep.append(ka)
    return torch.stack([r0, r1, r2, r3], dim=-3), torch.stack(keep, dim=-2)


def cuboid_cuboid_cl(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    """Lane-last cuboid-cuboid SAT: pA/pB ``[..., 3, P]``, rA/rB
    ``[..., 4, P]``, prmA/prmB ``[..., 12, P]``."""
    hA = prmA[..., 0:3, :]
    hB = prmB[..., 0:3, :]
    mA = quat.to_matrix_cl(rA)
    mB = quat.to_matrix_cl(rB)

    R = _m3t_m3(mA, mB)
    t = _m3tv(mA, pB - pA)
    absR = torch.abs(R) + 1e-6

    # Face axes.
    sep_a = torch.abs(t) - (hA + _m3v(absR, hB))
    sep_b = torch.abs(_m3tv(R, t)) - (_m3tv(absR, hA) + hB)
    sep_a_best = torch.amax(sep_a, dim=-2)
    sep_b_best = torch.amax(sep_b, dim=-2)
    best_a = torch.argmax(sep_a, dim=-2)
    best_b = torch.argmax(sep_b, dim=-2)

    # Edge axes (closed form, rolled indices).
    r1i = [1, 2, 0]
    r2i = [2, 0, 1]
    hA1, hA2 = hA[..., r1i, :], hA[..., r2i, :]
    hB1, hB2 = hB[..., r1i, :], hB[..., r2i, :]
    absR_r1, absR_r2 = absR[..., r1i, :, :], absR[..., r2i, :, :]
    absR_c1, absR_c2 = absR[..., :, r1i, :], absR[..., :, r2i, :]
    R_r1, R_r2 = R[..., r1i, :, :], R[..., r2i, :, :]
    t1r, t2r = t[..., r1i, :], t[..., r2i, :]

    ra = hA1.unsqueeze(-2) * absR_r2 + hA2.unsqueeze(-2) * absR_r1
    rb = hB1.unsqueeze(-3) * absR_c2 + hB2.unsqueeze(-3) * absR_c1
    tl = t2r.unsqueeze(-2) * R_r1 - t1r.unsqueeze(-2) * R_r2
    length = torch.sqrt(torch.clamp(1.0 - R * R, min=1e-12))
    edge_sep = (torch.abs(tl) - ra - rb) / length
    edge_sep = torch.where(length < 1e-3, torch.full_like(edge_sep, -_BIG), edge_sep)

    scale = torch.minimum(torch.amin(hA, dim=-2), torch.amin(hB, dim=-2))
    lead = edge_sep.shape[:-3]
    P = edge_sep.shape[-1]
    e_flat = edge_sep.reshape(lead + (9, P))
    best_e = torch.argmax(e_flat, dim=-2)
    sep_e_best = torch.amax(e_flat, dim=-2)

    face_best = torch.maximum(sep_a_best, sep_b_best)
    use_edge = sep_e_best > face_best + _EDGE_BIAS_ABS * scale
    use_b_face = sep_b_best > sep_a_best + _REF_FACE_BIAS_ABS * scale

    # ===== Face-face manifold (selected reference box only) =====
    ub = use_b_face.unsqueeze(-2)
    ub3 = ub.unsqueeze(-2)
    h_ref = torch.where(ub, hB, hA)
    h_inc = torch.where(ub, hA, hB)
    R_ri = torch.where(ub3, R.transpose(-3, -2), R)
    t_ri = torch.where(ub, -_m3tv(R, t), t)
    axis = torch.where(use_b_face, best_b, best_a)

    one_hot = _onehot3(axis)
    t_ax = dot_cl(one_hot, t_ri)
    sgn = torch.where(t_ax >= 0, 1.0, -1.0)
    n_ref = one_hot * sgn.unsqueeze(-2)

    # Incident face: incident axis most anti-parallel to n_ref.
    d_inc = _m3tv(R_ri, n_ref)
    inc_axis = torch.argmax(torch.abs(d_inc), dim=-2)
    inc_oh = _onehot3(inc_axis)
    inc_n_local = inc_oh * (-torch.sign(dot_cl(inc_oh, d_inc))).unsqueeze(-2)

    eu = _onehot3((inc_axis + 1) % 3)
    ev = _onehot3((inc_axis + 2) % 3)
    hu_i = dot_cl(eu, h_inc).unsqueeze(-2)
    hv_i = dot_cl(ev, h_inc).unsqueeze(-2)
    center_l = inc_n_local * dot_cl(inc_oh, h_inc).unsqueeze(-2)
    corners_l = torch.stack([
        center_l + eu * hu_i + ev * hv_i,
        center_l - eu * hu_i + ev * hv_i,
        center_l - eu * hu_i - ev * hv_i,
        center_l + eu * hu_i - ev * hv_i,
    ], dim=-3)
    corners_r = _m3_corners(R_ri, corners_l) + t_ri.unsqueeze(-3)

    pick_u = _onehot3((axis + 1) % 3)
    pick_v = _onehot3((axis + 2) % 3)
    h_face = dot_cl(one_hot, h_ref)
    u = _corners_dot(corners_r, pick_u)
    v = _corners_dot(corners_r, pick_v)
    depth = _corners_dot(corners_r, n_ref) - h_face.unsqueeze(-2)
    verts_uvd = torch.stack([u, v, depth], dim=-2)
    cand, cand_valid = _face_candidates_cl(
        verts_uvd, dot_cl(pick_u, h_ref), dot_cl(pick_v, h_ref))
    pts4, keep_face = _reduce_candidates_cl(cand, cand_valid)

    pts_ref = (
        pts4[..., :, 0:1, :] * pick_u.unsqueeze(-3)
        + pts4[..., :, 1:2, :] * pick_v.unsqueeze(-3)
        + (h_face[..., None, None, :] + pts4[..., :, 2:3, :]) * n_ref.unsqueeze(-3)
    )
    dist_face = pts4[..., :, 2, :]
    mid_ref = pts_ref - 0.5 * dist_face.unsqueeze(-2) * n_ref.unsqueeze(-3)

    m_ref = torch.where(ub3, mB, mA)
    p_ref = torch.where(ub, pB, pA)
    n_w_ref = _m3v(m_ref, n_ref)
    n_face = torch.where(ub, -n_w_ref, n_w_ref)
    mid_face = _m3_corners(m_ref, mid_ref) + p_ref.unsqueeze(-3)

    # Quadrant feature ids around the manifold centroid.
    ex = torch.zeros_like(n_face)
    ex[..., 0, :] = 1.0
    ey = torch.zeros_like(n_face)
    ey[..., 1, :] = 1.0
    t1f = cross_cl(n_face, ex)
    t1f_alt = cross_cl(n_face, ey)
    t1f = torch.where((dot_cl(t1f, t1f) < 1e-6).unsqueeze(-2), t1f_alt, t1f)
    t1f = t1f / torch.clamp(torch.sqrt(dot_cl(t1f, t1f)), min=1e-9).unsqueeze(-2)
    t2f = cross_cl(n_face, t1f)
    keep_f = keep_face.to(torch.float32)
    nkeep = torch.clamp(keep_f[..., 0, :] + keep_f[..., 1, :] + keep_f[..., 2, :]
                        + keep_f[..., 3, :], min=1.0)
    wsum = mid_face * keep_f.unsqueeze(-2)
    centroid = (wsum[..., 0, :, :] + wsum[..., 1, :, :] + wsum[..., 2, :, :]
                + wsum[..., 3, :, :]) / nkeep.unsqueeze(-2)
    rel_c = mid_face - centroid.unsqueeze(-3)
    du_f = _corners_dot(rel_c, t1f)
    dv_f = _corners_dot(rel_c, t2f)
    fid_face = ((du_f > 0).to(torch.int32) + 2 * (dv_f > 0).to(torch.int32)
                + 4 * (torch.abs(du_f) > torch.abs(dv_f)).to(torch.int32))

    # ===== Edge-edge manifold =====
    ei = best_e // 3
    ej = best_e % 3
    sel_e = best_e.unsqueeze(-2)
    Lsel_r1 = torch.gather(R_r1.reshape(lead + (9, P)), -2, sel_e).squeeze(-2)
    Lsel_r2 = torch.gather(R_r2.reshape(lead + (9, P)), -2, sel_e).squeeze(-2)
    Lsel_len = torch.gather(length.reshape(lead + (9, P)), -2, sel_e).squeeze(-2)
    L = ((_onehot3((ei + 1) % 3) * (-Lsel_r2).unsqueeze(-2)
          + _onehot3((ei + 2) % 3) * Lsel_r1.unsqueeze(-2))
         / torch.clamp(Lsel_len, min=1e-12).unsqueeze(-2))
    L = torch.where((dot_cl(L, t) < 0).unsqueeze(-2), -L, L)

    one = torch.ones_like(L)
    sgnA = torch.sign(torch.where(torch.abs(L) < 1e-12, one, L))
    onehot_i = _onehot3(ei)
    cornerA = sgnA * hA * (1.0 - onehot_i)
    edgeA_a = cornerA - onehot_i * hA
    edgeA_b = cornerA + onehot_i * hA

    L_b = _m3tv(R, L)
    sgnB = torch.sign(torch.where(torch.abs(L_b) < 1e-12, one, -L_b))
    onehot_j = _onehot3(ej)
    cornerB_l = sgnB * hB * (1.0 - onehot_j)
    edgeB_a = _m3v(R, cornerB_l - onehot_j * hB) + t
    edgeB_b = _m3v(R, cornerB_l + onehot_j * hB) + t

    _, _, cA_f, cB_f = _closest_segment_segment(edgeA_a, edgeA_b, edgeB_a, edgeB_b)
    n_edge_w = _m3v(mA, L)
    mid_edge_w = _m3v(mA, 0.5 * (cA_f + cB_f)) + pA
    fid_edge = (1 << 28) + best_e.to(torch.int32)

    # ===== Select =====
    ue = use_edge.unsqueeze(-2)
    first = (torch.arange(4, device=L.device) == 0).view(4, 1)
    normal = torch.where(ue, n_edge_w, n_face)
    pts = torch.where(ue.unsqueeze(-2), mid_edge_w.unsqueeze(-3), mid_face)
    big = torch.full_like(dist_face, _BIG)
    dst = torch.where(
        ue, torch.where(first, sep_e_best.unsqueeze(-2), big),
        torch.where(keep_face, dist_face, big))
    fids = torch.where(
        ue, torch.where(first, fid_edge.unsqueeze(-2), -1), fid_face).to(torch.int32)
    valid = torch.where(ue, first.expand_as(keep_face), keep_face)
    return Manifold(normal=normal, point=pts, dist=dst, fid=fids, valid=valid)


def cuboid_cuboid(pA, rA, prmA, pB, rB, prmB) -> Manifold:
    """One cuboid pair (the reference's `cuboid_cuboid`): pA/pB ``[3]``,
    rA/rB ``[4]``, prmA/prmB ``[12]``, through `cuboid_cuboid_cl` on one
    lane.  Returns the reference's single-pair layout: normal ``[3]``, point
    ``[4, 3]``, dist, fid and valid ``[4]``."""
    m = cuboid_cuboid_cl(*(torch.as_tensor(x).unsqueeze(-1) for x in (pA, rA, prmA,
                                                                    pB, rB, prmB)))
    return Manifold(*(x[..., 0] for x in m))
