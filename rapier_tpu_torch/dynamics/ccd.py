"""Continuous collision detection: motion clamping by swept bisection
(counterpart of rapier_tpu.dynamics.ccd), over a batch of scenes.

`clamp_motions(bodies, colliders, params, meshes)` clamps the predicted
`next_pos` / `next_rot` of every fast CCD-enabled body to its first time of
impact along the step's motion, `params.max_ccd_substeps` passes a step.
The semantics are the reference's, lane by lane:

- A body is CCD-active when it is dynamic, enabled, has `ccd_enabled` and
  moves more than ``0.5 * length_unit * 0.05`` this step.
- Each collider sweeps an AABB over the step, grown to the bounding ball
  about its parent's COM where the parent turns more than 0.3 rad.
- Candidates are (CCD collider i, other collider j) with overlapping swept
  boxes, not on one body, j enabled and not a sensor, neither a mesh.  Each
  CCD collider keeps its MAX_PAIRS_PER_COLLIDER candidates of earliest
  swept-box entry time (a stable sort: ties keep collider order), then a
  scene keeps its first MAX_CCD_PAIRS in row-major (i, j) order.  Dropped
  candidates are counted (`StepEvents.ccd_overflow`).
- A pair's time of impact: its distance (exact GJK minus both border radii,
  -1e-3 where GJK finds intersection, the plane distance for a halfspace
  j) at t = 0 and at 16 coarse samples, then 16 bisections inside the first
  bracket whose end is touching; no impact when already touching at t = 0.
  Poses between the ends lerp the position and nlerp the rotation.
- (CCD collider, mesh) pairs take MAX_CCD_MESH_PAIRS lanes a scene, each
  against its TRIS_PER_CCD_PAIR triangles nearest the sweep's start among
  those the swept box overlaps, with `narrowphase_mesh.triangle_gap` as the
  distance.
- A body's motion is clamped to the least time of impact of its colliders.

The reference passes no hull table to the distance functions, so a CONVEX
collider sweeps as its origin dilated by its border radius (ROADMAP R17).

What is not carried over is the layout.  The reference builds dense
``[C, C]`` candidate tables and runs every pair of the 128-lane buffer.
Here the candidate rows are built only for the CCD-active colliders, the
pairs are the candidates that survive the caps, the 16 coarse samples and
t = 0 run as one GJK call over 17 lanes a pair, the bisections run only on
the pairs with an impact, and each distance branch (GJK or the plane) only
on the pairs that take it.  A lane's result does not depend on the other
lanes, so this is the reference's result on every lane.  A pass with no
candidate in any scene leaves every body as it is, as the reference's
does (every time of impact 1).
"""

from __future__ import annotations

import dataclasses

import torch

from rapier_tpu_torch.geometry import gjk, shapes
from rapier_tpu_torch.geometry.dispatch import _census, collider_world_poses
from rapier_tpu_torch.geometry.narrowphase_mesh import is_mesh_type, triangle_gap
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import BodyType, ShapeType

MAX_CCD_PAIRS = 128
MAX_PAIRS_PER_COLLIDER = 16   # per-collider fairness cap
MAX_CCD_MESH_PAIRS = 16       # (CCD convex, mesh) lanes a scene
TRIS_PER_CCD_PAIR = 8         # triangles nearest the sweep a mesh lane
_N_COARSE = 16
_BISECT_ITERS = 16


def _endpoint(bodies, colliders, b, c):
    """Collider c of scene b's motion over the step, a lane a row: the
    parent's start pose, its displacement and rotation delta (the end
    rotation's sign flipped onto the start's hemisphere), whether it has a
    parent, and the collider's local pose."""
    p = colliders.parent[b, c]
    bp = p.clamp(min=0)
    pos0, r0 = bodies.pos[b, bp], bodies.rot[b, bp]
    r1 = bodies.next_rot[b, bp]
    r1 = torch.where(torch.sum(r0 * r1, -1, keepdim=True) < 0, -r1, r1)
    return dict(pos0=pos0, dpos=bodies.next_pos[b, bp] - pos0, r0=r0, drot=r1 - r0,
                has=(p >= 0).unsqueeze(-1), local_pos=colliders.local_pos[b, c],
                local_rot=colliders.local_rot[b, c])


def _take(ep, idx):
    return ep if idx is None else {k: v[idx] for k, v in ep.items()}


def _pose_at(ep, t):
    """World pose ``[S, L, 3 / 4]`` of the endpoint lanes at times
    ``t [S, L]``: lerp of the position, nlerp of the rotation."""
    tt = t.unsqueeze(-1)
    ident = torch.zeros_like(ep["r0"])
    ident[..., 3] = 1.0
    pos_t = torch.where(ep["has"], ep["pos0"] + ep["dpos"] * tt, 0.0)
    rot_t = torch.where(ep["has"], quat.normalize(ep["r0"] + ep["drot"] * tt), ident)
    return quat.compose(pos_t, rot_t, ep["local_pos"], ep["local_rot"])


def _lanes(x, s):
    """Per-lane rows ``[L, ...]`` repeated over S samples, flattened."""
    return x.unsqueeze(0).expand((s,) + tuple(x.shape)).reshape((-1,) + tuple(x.shape[1:]))


def _convex_distance(A, B, tA, prmA, tB, prmB, types):
    """dist(t, idx): the signed distance of convex pair lanes (A's and B's
    skeletons by GJK, minus both border radii; -1e-3 where GJK finds
    intersection) at times ``t [S, l]`` of the lanes `idx` (None: all)."""
    border = gjk._border_radius(tA, prmA) + gjk._border_radius(tB, prmB)

    def dist(t, idx=None):
        s, l = t.shape
        pa, ra = _pose_at(_take(A, idx), t)
        pb, rb = _pose_at(_take(B, idx), t)
        pa, ra, pb, rb = (x.reshape(s * l, -1) for x in (pa, ra, pb, rb))
        sel = (lambda x: x) if idx is None else (lambda x: x[idx])
        supp = gjk.make_support(pa, ra, _lanes(sel(tA), s), _lanes(sel(prmA), s),
                                pb, rb, _lanes(sel(tB), s), _lanes(sel(prmB), s),
                                types=types)
        d0 = pb - pa
        unit_y = torch.zeros_like(d0)
        unit_y[:, 1] = 1.0
        d0 = torch.where((torch.linalg.norm(d0, dim=-1) < 1e-9).unsqueeze(-1), unit_y, d0)
        g = gjk.gjk(supp, d0)
        d = torch.where(g["intersect"], -1e-3, g["dist"] - _lanes(sel(border), s))
        return d.reshape(s, l)

    return dist


def _halfspace_distance(A, B, tA, prmA, prmB, types):
    """dist(t, idx) of lanes whose B is a halfspace: A's support along the
    plane's inward normal, its height over the plane."""
    def dist(t, idx=None):
        s, l = t.shape
        sel = (lambda x: x) if idx is None else (lambda x: x[idx])
        pa, ra = _pose_at(_take(A, idx), t)
        pb, rb = _pose_at(_take(B, idx), t)
        n_plane = quat.rotate(rb, sel(prmB)[:, 0:3].expand(s, l, 3))
        s_l = shapes.support_point(sel(tA).expand(s, l), sel(prmA).expand(s, l, 12),
                                   quat.inv_rotate(ra, -n_plane), types=types)
        return gjk._dot(n_plane, quat.transform_point(pa, ra, s_l) - pb)

    return dist


def _mesh_distance(A, M, tA, prmA, v0, v1, v2, tok):
    """dist(t, idx) of (convex, mesh) lanes: the least `triangle_gap` over
    the lane's kept triangles ``v0, v1, v2 [L, K, 3]`` (mesh-local; ``tok
    [L, K]``, others 1e10)."""
    def dist(t, idx=None):
        s, l = t.shape
        sel = (lambda x: x) if idx is None else (lambda x: x[idx])
        k = tok.shape[-1]
        pa, ra = _pose_at(_take(A, idx), t)
        pm, rm = _pose_at(_take(M, idx), t)
        pm, rm = pm.unsqueeze(2), rm.unsqueeze(2)
        vw = [quat.transform_point(pm, rm, sel(v).unsqueeze(0)) for v in (v0, v1, v2)]

        def lane_last(x):        # [S, l, K, d] -> [d, S * l * K]
            return x.reshape(-1, x.shape[-1]).transpose(0, 1)

        def per_tri(x):          # [S, l, d] -> [S, l, K, d]
            return x.unsqueeze(2).expand(s, l, k, x.shape[-1])

        gap = triangle_gap(lane_last(per_tri(pa)), lane_last(per_tri(ra)),
                           sel(tA).view(1, l, 1).expand(s, l, k).reshape(-1),
                           lane_last(per_tri(sel(prmA).expand(s, l, 12))),
                           *(lane_last(v) for v in vw))
        gap = torch.where(sel(tok).unsqueeze(0), gap.reshape(s, l, k), 1e10)
        return gap.amin(-1)

    return dist


def _time_of_impact(dist, n: int, device):
    """Each lane's time of impact ``[n]`` (1 where none) under `dist`:
    t = 0 and the coarse samples as one call, then the bisections on the
    lanes with an impact."""
    ts = torch.arange(0, _N_COARSE + 1, device=device, dtype=torch.float32) / _N_COARSE
    d = dist(ts.unsqueeze(1).expand(_N_COARSE + 1, n).contiguous())
    neg = d[1:] <= 0.0
    first = torch.argmax(neg.to(torch.int32), dim=0).to(torch.float32)
    seg = 1.0 / _N_COARSE
    hit = torch.any(neg, dim=0) & ~(d[0] <= 0.0)
    toi = torch.ones((n,), device=device)
    idx = torch.nonzero(hit).flatten()
    if idx.numel() == 0:
        return toi
    lo, hi = first[idx] * seg, (first[idx] + 1.0) * seg
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        gt = dist(mid.unsqueeze(0), idx)[0] > 0.0
        lo = torch.where(gt, mid, lo)
        hi = torch.where(gt, hi, mid)
    toi[idx] = lo
    return toi


def _compact_pairs(mask, rb, n_scenes: int, cap: int):
    """The True entries ``(row, j)`` of `mask` ``[R, C]`` (rows sorted by
    scene, then collider), in row-major order, each scene's first `cap`
    kept.  Returns (rows, js, overflow ``[B]`` int32)."""
    r, j = torch.nonzero(mask, as_tuple=True)
    b = rb[r]
    count = torch.bincount(b, minlength=n_scenes)
    start = torch.cumsum(count, 0) - count
    keep = torch.arange(b.numel(), device=b.device) - start[b] < cap
    return r[keep], j[keep], torch.clamp(count - cap, min=0).to(torch.int32)


def _rank_triangles(meshes, colliders, b, mi, mj, swept_min, swept_max, w_pos0, w_rot0,
                    ctr0):
    """Each mesh lane's TRIS_PER_CCD_PAIR triangles of the mesh whose box
    meets i's swept box (re-boxed in the mesh's frame at t = 0), nearest
    the sweep's start by centroid (a stable sort).  Returns mesh-local
    vertices ``v0, v1, v2 [L, K, 3]`` and ``ok [L, K]``."""
    tris = meshes.triangles.long()                              # [B, T, 3]
    verts = meshes.vertices

    def corner(k):
        idx = tris[..., k].clamp(min=0)
        return torch.gather(verts, 1, idx.unsqueeze(-1).expand(idx.shape + (3,)))

    tv0, tv1, tv2 = corner(0), corner(1), corner(2)
    tri_lo = torch.minimum(torch.minimum(tv0, tv1), tv2)[b]      # [L, T, 3]
    tri_hi = torch.maximum(torch.maximum(tv0, tv1), tv2)[b]
    tri_ctr = ((tv0 + tv1 + tv2) / 3.0)[b]
    tri_ok = (tris[..., 0] >= 0)[b]
    lo_w, hi_w = swept_min[b, mi], swept_max[b, mi]
    mp, mr = w_pos0[b, mj], w_rot0[b, mj]
    ctr = quat.inv_rotate(mr, 0.5 * (lo_w + hi_w) - mp)
    he_l = (torch.abs(quat.to_matrix(quat.conj(mr))) @ (0.5 * (hi_w - lo_w)).unsqueeze(-1)
            ).squeeze(-1)
    lo, hi = (ctr - he_l).unsqueeze(1), (ctr + he_l).unsqueeze(1)
    start = colliders.shape_params[b, mj, 0].to(torch.int64).unsqueeze(1)
    count = colliders.shape_params[b, mj, 1].to(torch.int64).unsqueeze(1)
    t_ids = torch.arange(tris.shape[1], device=tris.device)
    owned = (t_ids >= start) & (t_ids < start + count) & tri_ok
    ov = owned & torch.all((tri_lo <= hi) & (lo <= tri_hi), dim=-1)
    start_l = quat.inv_rotate(mr, ctr0[b, mi] - mp).unsqueeze(1)
    d = torch.linalg.norm(tri_ctr - start_l, dim=-1)
    order = torch.sort(torch.where(ov, d, torch.inf), dim=1, stable=True).indices
    kept = order[:, :TRIS_PER_CCD_PAIR]
    ok = torch.gather(ov, 1, kept)
    kept_tris = torch.gather(tris[b], 1, kept.unsqueeze(-1).expand(kept.shape + (3,)))
    vb = verts[b]

    def kept_corner(k):
        idx = kept_tris[..., k].clamp(min=0)
        return torch.gather(vb, 1, idx.unsqueeze(-1).expand(idx.shape + (3,)))

    return kept_corner(0), kept_corner(1), kept_corner(2), ok


def clamp_motions(bodies, colliders, params, meshes=None):
    """Clamp `next_pos` / `next_rot` of the fast CCD-enabled bodies to their
    first impact, `params.max_ccd_substeps` passes (each re-sweeps the
    motions the previous one clamped).  Returns (bodies, the candidates the
    caps dropped ``[B]`` int32, summed over the passes)."""
    total = torch.zeros(bodies.pos.shape[0], dtype=torch.int32, device=bodies.pos.device)
    for _ in range(max(1, int(params.max_ccd_substeps))):
        bodies, ovf = _clamp_pass(bodies, colliders, params, meshes)
        total = total + ovf
    return bodies, total


def _clamp_pass(bodies, colliders, params, meshes=None):
    """One motion-clamping pass over the batch."""
    bsz, n = bodies.body_type.shape
    dev = bodies.pos.device
    overflow = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    dyn = bodies.body_type == BodyType.DYNAMIC
    speed = torch.linalg.norm(bodies.next_pos - bodies.pos, dim=-1)
    ccd_active = bodies.ccd_enabled & dyn & bodies.enabled & (
        speed > 0.5 * float(params.length_unit) * 0.05)
    parent = colliders.parent
    safe_p = parent.clamp(min=0).long()
    coll_ccd = (parent >= 0) & torch.gather(ccd_active, 1, safe_p) & colliders.enabled
    rb, rc = torch.nonzero(coll_ccd, as_tuple=True)                 # CCD collider rows
    if rb.numel() == 0:
        return bodies, overflow

    w_pos0, w_rot0 = collider_world_poses(bodies, colliders)
    w_pos1, w_rot1 = collider_world_poses(
        dataclasses.replace(bodies, pos=bodies.next_pos, rot=bodies.next_rot), colliders)
    mins0, maxs0 = shapes.compute_aabbs(colliders.shape_type, colliders.shape_params,
                                        w_pos0, w_rot0)
    mins1, maxs1 = shapes.compute_aabbs(colliders.shape_type, colliders.shape_params,
                                        w_pos1, w_rot1)
    swept_min = torch.minimum(mins0, mins1)
    swept_max = torch.maximum(maxs0, maxs1)

    # Rotational sweep: a collider whose parent turns more than 0.3 rad this
    # step sweeps the bounding ball about the parent's COM over the motion.
    def rows(x):
        return torch.gather(x, 1, safe_p.view(safe_p.shape + (1,) * (x.dim() - 2)).expand(
            safe_p.shape + x.shape[2:]))

    dq = torch.abs(torch.sum(rows(bodies.rot) * rows(bodies.next_rot), dim=-1))
    ang = 2.0 * torch.arccos(torch.clamp(dq, 0.0, 1.0))
    rotating = ((parent >= 0) & (ang > 0.3)).unsqueeze(-1)
    com0 = rows(bodies.pos + quat.rotate(bodies.rot, bodies.local_com))
    com1 = rows(bodies.next_pos + quat.rotate(bodies.next_rot, bodies.local_com))
    ctr0 = 0.5 * (mins0 + maxs0)
    r_ball = (torch.linalg.norm(ctr0 - com0, dim=-1)
              + 0.5 * torch.linalg.norm(maxs0 - mins0, dim=-1)).unsqueeze(-1)
    swept_min = torch.where(rotating, torch.minimum(swept_min, torch.minimum(com0, com1)
                                                    - r_ball), swept_min)
    swept_max = torch.where(rotating, torch.maximum(swept_max, torch.maximum(com0, com1)
                                                    + r_ball), swept_max)

    # Candidate rows: (CCD collider i = (rb, rc), every collider j).
    c = parent.shape[1]
    smin_i, smax_i = swept_min[rb, rc].unsqueeze(1), swept_max[rb, rc].unsqueeze(1)
    overlap = torch.all((smin_i <= swept_max[rb]) & (swept_min[rb] <= smax_i), dim=-1)
    p_i = parent[rb, rc].unsqueeze(1)
    same_body = (parent[rb] == p_i) & (p_i >= 0)
    j_ids = torch.arange(c, device=dev)
    base = (colliders.enabled[rb] & overlap & ~same_body & (j_ids != rc.unsqueeze(1))
            & ~colliders.sensor[rb] & ~is_mesh_type(colliders.shape_type[rb, rc]).unsqueeze(1))
    mesh_j = is_mesh_type(colliders.shape_type[rb])
    cand = base & ~mesh_j

    # Per-collider fairness: each CCD collider keeps the candidates it
    # enters first along its motion (the swept-box slab test).
    ctr1 = 0.5 * (mins1 + maxs1)
    half0 = 0.5 * (maxs0 - mins0)
    motion = (ctr1 - ctr0)[rb, rc].unsqueeze(1)
    lo = swept_min[rb] - half0[rb, rc].unsqueeze(1) - ctr0[rb, rc].unsqueeze(1)
    hi = swept_max[rb] + half0[rb, rc].unsqueeze(1) - ctr0[rb, rc].unsqueeze(1)
    dsafe = torch.where(torch.abs(motion) < 1e-9, 1e-9, motion)
    t1, t2 = lo / dsafe, hi / dsafe
    entry = torch.clamp(torch.amax(torch.minimum(t1, t2), dim=-1), min=0.0)
    prio = torch.where(cand, entry, torch.inf)
    order = torch.sort(prio, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, j_ids.expand(order.shape))
    capped = cand & (rank < MAX_PAIRS_PER_COLLIDER)
    row_overflow = (cand & ~capped).sum(1)
    overflow = overflow + torch.zeros((bsz,), dtype=torch.int64, device=dev).scatter_add_(
        0, rb, row_overflow).to(torch.int32)
    pr, pj, ovf = _compact_pairs(capped, rb, bsz, MAX_CCD_PAIRS)
    overflow = overflow + ovf

    groups = []              # (lanes' bodies [l], their distance, lanes)
    if pr.numel():
        b, ci = rb[pr], rc[pr]
        hs = colliders.shape_type[b, pj] == ShapeType.HALFSPACE
        types = _census(params.shape_types_present)
        for sel, make in ((~hs, _convex_distance), (hs, _halfspace_distance)):
            idx = torch.nonzero(sel).flatten()
            if idx.numel() == 0:
                continue
            bi, i, j = b[idx], ci[idx], pj[idx]
            A = _endpoint(bodies, colliders, bi, i)
            B = _endpoint(bodies, colliders, bi, j)
            tA, prmA = colliders.shape_type[bi, i], colliders.shape_params[bi, i]
            prmB = colliders.shape_params[bi, j]
            dist = (make(A, B, tA, prmA, colliders.shape_type[bi, j], prmB, types)
                    if make is _convex_distance else make(A, B, tA, prmA, prmB, types))
            groups.append((bi, parent[bi, i], dist, idx.numel()))

    if meshes is not None:
        # (CCD convex, mesh) lanes against their nearest triangles.
        mr, mj, ovf_m = _compact_pairs(base & mesh_j, rb, bsz, MAX_CCD_MESH_PAIRS)
        overflow = overflow + ovf_m
        if mr.numel():
            b, mi = rb[mr], rc[mr]
            v0, v1, v2, tok = _rank_triangles(meshes, colliders, b, mi, mj, swept_min,
                                              swept_max, w_pos0, w_rot0, ctr0)
            dist = _mesh_distance(_endpoint(bodies, colliders, b, mi),
                                  _endpoint(bodies, colliders, b, mj),
                                  colliders.shape_type[b, mi], colliders.shape_params[b, mi],
                                  v0, v1, v2, tok)
            groups.append((b, parent[b, mi], dist, mr.numel()))

    if not groups:
        return bodies, overflow
    # Each body's least time of impact.
    body_toi = torch.ones((bsz * (n + 1),), device=dev)
    for bi, body, dist, count in groups:
        toi = _time_of_impact(dist, count, dev)
        body_toi.scatter_reduce_(0, (bi * (n + 1) + body).long(), toi, "amin")
    body_toi = body_toi.view(bsz, n + 1)[:, :n]

    clamp = (ccd_active & (body_toi < 1.0)).unsqueeze(-1)
    t = body_toi.unsqueeze(-1)
    r0, r1 = bodies.rot, bodies.next_rot
    r1f = torch.where(torch.sum(r0 * r1, -1, keepdim=True) < 0, -r1, r1)
    return dataclasses.replace(
        bodies,
        next_pos=torch.where(clamp, bodies.pos + (bodies.next_pos - bodies.pos) * t,
                             bodies.next_pos),
        next_rot=torch.where(clamp, quat.normalize(r0 + (r1f - r0) * t),
                             bodies.next_rot)), overflow
