"""Masked fixed-iteration GJK distance and EPA penetration depth over lanes
(counterpart of rapier_tpu.geometry.gjk).

Every function works on a batch of independent lanes, the lane axis FIRST:
vectors ``[L, 3]``, quaternions ``[L, 4]``, shape types ``[L]``, parameter
rows ``[L, 12]`` and hull vertex slots ``[L, V, 3]``.  A support map
``supp(d [L, 3]) -> (w, sa, sb)`` gives the support of A - B along each
lane's world direction with the witness points on A and B.

The semantics are the reference's, lane by lane:

- GJK runs GJK_ITERS iterations over a 4-slot simplex; a converged lane's
  state is frozen by masks (no lane leaves the loop early).  The closest
  point on the simplex is the feasible one of least distance among its 15
  faces (4 vertices, 6 edges, 4 triangles, the tetrahedron), the first of
  equal ones.
- EPA runs EPA_ITERS iterations on fixed tables of EPA_V vertices and EPA_F
  faces with validity masks.  Each iteration expands the valid face nearest
  the origin: the faces visible from the new support point are retired, and
  the horizon (their directed edges whose reverse is not itself a visible
  edge) is stitched to the new vertex, the k-th horizon edge into the k-th
  free face slot.  The reference finds the horizon with a ``[3F, 3F]``
  comparison and places the faces with one-hot rank products; here a
  per-lane bitmap of the visible directed edges (keyed ``a * EPA_V + b``)
  answers the reverse test with one lookup, and the slots come from the two
  cumulative-sum ranks by index.  Face indices are small integers, so both
  give exactly what the reference computes.
- Round shapes (and balls and capsules, whose inner shape is their point or
  segment skeleton) run on their inner shape; `contact_support_maps` adds
  the border radii.

`contact_support_maps` runs EPA only on the lanes GJK finds intersecting,
and the 1e-4-inflated retry only on the lanes whose exact pass finds no EPA
seed: a lane's result does not depend on the other lanes, so this is the
reference's result on every lane.

Under `counters.recording()` GJK and EPA each count their lane-iterations:
`gjk_useful` / `epa_useful` the lanes still active at each iteration,
`gjk_attempted` / `epa_attempted` every lane at every iteration.
"""

from __future__ import annotations

import functools

import torch

from rapier_tpu_torch.geometry.shapes import support_point
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import ShapeType
from rapier_tpu_torch.utils import counters

GJK_ITERS = 16
EPA_ITERS = 10
EPA_V = 16            # vertex slots (at most 5 seeded, +1 an iteration)
EPA_F = 40            # face slots (at most 6 seeded)
_EPS = 1e-9
_TOL = 1e-6

# Closest point on a simplex: its 15 faces, in the reference's order.
_SUBSETS = (
    [(0,), (1,), (2,), (3,)]
    + [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    + [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    + [(0, 1, 2, 3)]
)
_EDGE_I, _EDGE_J = (0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3)
_TRI_I, _TRI_J, _TRI_M = (0, 0, 0, 1), (1, 1, 2, 2), (2, 3, 3, 3)
_TET_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3), (0, 0, 0), (0, 0, 0))
_BIP_FACES = ((0, 1, 3), (1, 2, 3), (2, 0, 3), (1, 0, 4), (2, 1, 4), (0, 2, 4))


@functools.lru_cache(maxsize=None)
def _tables(device):
    """The subset and seed-face index tables on `device`."""
    order = torch.tensor([list(s) + [0] * (4 - len(s)) for s in _SUBSETS],
                         dtype=torch.long, device=device)
    size = torch.tensor([len(s) for s in _SUBSETS], dtype=torch.long, device=device)
    tet = torch.tensor(_TET_FACES, dtype=torch.long, device=device)
    bip = torch.tensor(_BIP_FACES, dtype=torch.long, device=device)
    # The last slot of each edge and triangle (a face exists when its last
    # slot is below nvalid).
    last = torch.tensor(_EDGE_J + _TRI_M, dtype=torch.long, device=device)
    return order, size, tet, bip, last


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _col(x):
    return x.unsqueeze(-1)


def _take(x, idx):
    """Rows ``x [L, N, ...]`` at ``idx [L, M]`` -> ``[L, M, ...]``."""
    view = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, view)


def _take1(x, idx):
    """Row ``x [L, N, ...]`` at ``idx [L]`` -> ``[L, ...]``."""
    return _take(x, idx.unsqueeze(1)).squeeze(1)


def _closest_on_simplex(W, nvalid):
    """Closest point to the origin on the simplex of the first `nvalid`
    rows of ``W [L, 4, 3]``.  Returns (dist2 [L], x [L, 3], lam [L, 4] the
    barycentric weights in slot layout, win [L] the index into _SUBSETS)."""
    L = W.shape[0]
    dt, dev = W.dtype, W.device
    nv = _col(nvalid)
    zero = torch.zeros((L, 1), dtype=dt, device=dev)
    slot = torch.arange(4, device=dev)
    last = _tables(dev)[4] < nv                              # [L, 10]

    # Vertices.
    d2_v = _dot(W, W)                                        # [L, 4]
    ok_v = slot < nv
    lam_v = torch.eye(4, dtype=dt, device=dev).expand(L, 4, 4)

    # Edges (i, j).
    ei, ej = _EDGE_I, _EDGE_J
    Wi = torch.stack([W[:, i] for i in ei], 1)               # [L, 6, 3]
    Wj = torch.stack([W[:, j] for j in ej], 1)
    e = Wj - Wi
    ee = _dot(e, e)
    t = -_dot(Wi, e) / torch.clamp(ee, min=_EPS)
    ok_e = last[:, :6] & (ee > _EPS) & (t >= 0.0) & (t <= 1.0)
    x_e = Wi + _col(t) * e
    d2_e = _dot(x_e, x_e)
    lam_e = []
    for k, (i, j) in enumerate(zip(ei, ej)):
        tk = t[:, k:k + 1]
        cols = [zero] * 4
        cols[i], cols[j] = 1 - tk, tk
        lam_e.append(torch.cat(cols, 1))
    lam_e = torch.stack(lam_e, 1)                            # [L, 6, 4]

    # Triangles (i, j, m).
    ti, tj, tm = _TRI_I, _TRI_J, _TRI_M
    Ti = torch.stack([W[:, i] for i in ti], 1)               # [L, 4, 3]
    e1 = torch.stack([W[:, j] for j in tj], 1) - Ti
    e2 = torch.stack([W[:, m] for m in tm], 1) - Ti
    a11, a22, a12 = _dot(e1, e1), _dot(e2, e2), _dot(e1, e2)
    b1, b2 = -_dot(Ti, e1), -_dot(Ti, e2)
    det = a11 * a22 - a12 * a12
    scale = torch.clamp(a11 * a22, min=_EPS)
    nd = torch.maximum(torch.abs(det), _EPS * scale)
    sd = torch.where(det < 0, -nd, nd)
    u = (b1 * a22 - b2 * a12) / sd
    v = (a11 * b2 - a12 * b1) / sd
    ok_t = (last[:, 6:] & (torch.abs(det) > _EPS * scale)
            & (u >= -_EPS) & (v >= -_EPS) & (u + v <= 1 + _EPS))
    x_t = Ti + _col(u) * e1 + _col(v) * e2
    d2_t = _dot(x_t, x_t)
    lam_t = []
    for k, (i, j, m) in enumerate(zip(ti, tj, tm)):
        uk, vk = u[:, k:k + 1], v[:, k:k + 1]
        cols = [zero] * 4
        cols[i], cols[j], cols[m] = 1 - uk - vk, uk, vk
        lam_t.append(torch.cat(cols, 1))
    lam_t = torch.stack(lam_t, 1)                            # [L, 4, 4]

    # The tetrahedron: its edge vectors as the columns of E, the adjugate's
    # rows as crosses of the columns, det(E) their triple product.
    c0, c1, c2 = W[:, 1] - W[:, 0], W[:, 2] - W[:, 0], W[:, 3] - W[:, 0]
    cof0, cof1, cof2 = quat.cross(c1, c2), quat.cross(c2, c0), quat.cross(c0, c1)
    det4 = _dot(c0, cof0)
    emax = torch.amax(torch.abs(torch.stack([c0, c1, c2], 1)), dim=(1, 2))
    scale4 = torch.clamp(emax ** 3, min=_EPS)
    nd4 = torch.maximum(torch.abs(det4), _EPS * scale4)
    sd4 = torch.where(det4 < 0, -nd4, nd4)
    w0 = -W[:, 0]
    t4 = torch.stack([_dot(cof0, w0), _dot(cof1, w0), _dot(cof2, w0)], 1) / _col(sd4)
    lam4 = torch.cat([1 - (t4[:, 0:1] + t4[:, 1:2] + t4[:, 2:3]), t4], 1)   # [L, 4]
    ok4 = ((nvalid > 3) & (torch.abs(det4) > _EPS * scale4)
           & torch.all(lam4 >= -_EPS, dim=1))

    d2 = torch.cat([d2_v, d2_e, d2_t, zero], 1)              # [L, 15]
    ok = torch.cat([ok_v, ok_e, ok_t, ok4.unsqueeze(1)], 1)
    lam = torch.cat([lam_v, lam_e, lam_t, lam4.unsqueeze(1)], 1)   # [L, 15, 4]
    score = torch.where(ok, d2, 1e30)
    win = torch.argmin(score, dim=1)                         # the first of equal
    lam_w = _take1(lam, win)
    x = (_col(lam_w[:, 0]) * W[:, 0] + _col(lam_w[:, 1]) * W[:, 1]
         + _col(lam_w[:, 2]) * W[:, 2] + _col(lam_w[:, 3]) * W[:, 3])
    return _take1(score, win), x, lam_w, win


def _combine(lam, rows):
    """``lam [L, 4]`` weights of the slot rows ``[L, 4, 3]``."""
    return (_col(lam[:, 0]) * rows[:, 0] + _col(lam[:, 1]) * rows[:, 1]
            + _col(lam[:, 2]) * rows[:, 2] + _col(lam[:, 3]) * rows[:, 3])


def gjk(supp, d0):
    """Fixed-iteration GJK on a Minkowski-difference support map, from the
    initial directions ``d0 [L, 3]``.  Returns a dict: dist [L] (>= 0),
    normal [L, 3] (A -> B, unit where separated), cpA, cpB [L, 3],
    intersect [L], and the terminal simplex (W, SA, SB [L, 4, 3], nvalid
    [L], win [L]) that seeds EPA."""
    L, dt, dev = d0.shape[0], d0.dtype, d0.device
    useful = torch.zeros((L,), dtype=torch.int32, device=dev) if counters.is_recording() else None
    order_tab, size_tab = _tables(dev)[:2]
    w0, sa0, sb0 = supp(d0)
    W = torch.zeros((L, 4, 3), dtype=dt, device=dev)
    SA, SB = torch.zeros_like(W), torch.zeros_like(W)
    W[:, 0], SA[:, 0], SB[:, 0] = w0, sa0, sb0
    nv = torch.ones((L,), dtype=torch.long, device=dev)
    active = torch.ones((L,), dtype=torch.bool, device=dev)
    inter = torch.zeros((L,), dtype=torch.bool, device=dev)
    slot = torch.arange(4, device=dev)
    for _ in range(GJK_ITERS):
        if useful is not None:
            useful += active
        d2, x, _lam, win = _closest_on_simplex(W, nv)
        inter_now = d2 < 1e-12
        w, sa, sb = supp(torch.where(_col(inter_now), d0, -x))
        # No-progress bound: every point of A - B is at least x.w / |x| away.
        conv = (d2 - _dot(x, w)) <= _TOL * torch.sqrt(torch.clamp(d2, min=_EPS))
        order = order_tab[win]                               # [L, 4]
        size = size_tab[win]
        keep = (slot < _col(size)).unsqueeze(-1)
        upd = active & ~inter_now & ~conv
        u3 = upd.view(L, 1, 1)
        W = torch.where(u3, torch.where(keep, _take(W, order), w.unsqueeze(1)), W)
        SA = torch.where(u3, torch.where(keep, _take(SA, order), sa.unsqueeze(1)), SA)
        SB = torch.where(u3, torch.where(keep, _take(SB, order), sb.unsqueeze(1)), SB)
        nv = torch.where(upd, torch.clamp(size + 1, max=4), nv)
        active = upd
        inter = inter | inter_now

    if useful is not None:
        counters.count("gjk_useful", useful.sum())
        counters.count("gjk_attempted", L * GJK_ITERS)
    d2, x, lam, win = _closest_on_simplex(W, nv)
    inter = inter | (d2 < 1e-12)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    normal = -x / _col(torch.clamp(dist, min=_EPS))
    return dict(dist=dist, normal=normal, cpA=_combine(lam, SA), cpB=_combine(lam, SB),
                intersect=inter, W=W, SA=SA, SB=SB, nvalid=nv, win=win)


def _face_geom(verts, vsum, nvert, fa, fb, fc):
    """Outward unit normals ``[L, F, 3]``, plane offsets and validity
    ``[L, F]`` of the faces (fa, fb, fc) ``[L, F]``."""
    va, vb, vc = _take(verts, fa), _take(verts, fb), _take(verts, fc)
    n = quat.cross(vb - va, vc - va)
    nn = _norm(n)
    ok = nn > _EPS
    n = n / _col(torch.clamp(nn, min=_EPS))
    centroid = vsum / _col(torch.clamp(nvert.to(verts.dtype), min=1.0))
    flip = _dot(n, va - centroid.unsqueeze(1)) < 0
    n = torch.where(_col(flip), -n, n)
    return n, _dot(n, va), ok


def epa(supp, g):
    """Fixed-capacity EPA seeded from the terminal GJK state `g` of
    intersecting lanes.  Returns (depth [L] >= 0, unit normal [L, 3] A -> B,
    cpA, cpB [L, 3], ok [L]); translating B by depth along the normal
    separates the shapes."""
    W, SA, SB, nv_simp = g["W"], g["SA"], g["SB"], g["nvalid"]
    L, dt, dev = W.shape[0], W.dtype, W.device
    tet_tab, bip_tab = _tables(dev)[2:4]
    V, F = EPA_V, EPA_F

    # Seed polytope.  k >= 3: the triangle of slots 0..2; k == 2: a third
    # point from a support orthogonal to the segment; k == 1 (touching at a
    # vertex): the degenerate seed guard catches it.
    e01 = W[:, 1] - W[:, 0]
    ax = torch.argmin(torch.abs(e01), dim=1)
    ortho = quat.cross(e01, torch.nn.functional.one_hot(ax, 3).to(dt))
    w2, sa2, sb2 = supp(ortho)
    need2 = _col(nv_simp < 3)
    t0, a0, b0 = W[:, 0], SA[:, 0], SB[:, 0]
    t1, a1, b1 = W[:, 1], SA[:, 1], SB[:, 1]
    t2 = torch.where(need2, w2, W[:, 2])
    a2 = torch.where(need2, sa2, SA[:, 2])
    b2 = torch.where(need2, sb2, SB[:, 2])
    n_t = quat.cross(t1 - t0, t2 - t0)
    n_norm = _norm(n_t)
    seed_ok = n_norm > _EPS
    n_t = n_t / _col(torch.clamp(n_norm, min=_EPS))
    wp, sap, sbp = supp(n_t)
    wm, sam, sbm = supp(-n_t)

    is_tet = nv_simp >= 4
    tet = _col(is_tet)
    rows = [(t0, a0, b0), (t1, a1, b1), (t2, a2, b2),
            (torch.where(tet, W[:, 3], wp), torch.where(tet, SA[:, 3], sap),
             torch.where(tet, SB[:, 3], sbp)),
            (wm, sam, sbm)]
    pad = torch.zeros((L, V - 5, 3), dtype=dt, device=dev)
    verts = torch.cat([torch.stack([r[0] for r in rows], 1), pad], 1)   # [L, V, 3]
    vA = torch.cat([torch.stack([r[1] for r in rows], 1), pad], 1)
    vB = torch.cat([torch.stack([r[2] for r in rows], 1), pad], 1)
    nvert = torch.where(is_tet, 4, 5)
    vmask = (torch.arange(5, device=dev) < _col(nvert)).to(dt)
    vsum = _col(vmask[:, 0]) * verts[:, 0]
    for i in range(1, 5):
        vsum = vsum + _col(vmask[:, i]) * verts[:, i]

    seed = torch.where(tet.unsqueeze(-1), tet_tab, bip_tab)           # [L, 6, 3]
    zf = torch.zeros((L, F - 6), dtype=torch.long, device=dev)
    fa = torch.cat([seed[..., 0], zf], 1)
    fb = torch.cat([seed[..., 1], zf], 1)
    fc = torch.cat([seed[..., 2], zf], 1)
    fidx = torch.arange(F, device=dev)
    fvalid = fidx < _col(torch.where(is_tet, 4, 6))
    fn, fd, fok = _face_geom(verts, vsum, nvert, fa, fb, fc)
    fvalid = fvalid & fok

    vidx = torch.arange(V, device=dev)
    active = seed_ok
    bn = torch.zeros((L, 3), dtype=dt, device=dev)
    bn[:, 1] = 1.0
    bdep = torch.zeros((L,), dtype=dt, device=dev)
    useful = torch.zeros((L,), dtype=torch.int32, device=dev) if counters.is_recording() else None
    for _ in range(EPA_ITERS):
        if useful is not None:
            useful += active
        score = torch.where(fvalid, fd, 1e30)
        bf = torch.argmin(score, dim=1)
        n = _take1(fn, bf)
        db = _take1(score, bf)
        w, sa, sb = supp(n)
        conv = (_dot(n, w) - db) <= _TOL
        have_face = torch.any(fvalid, dim=1)
        track = active & have_face
        bn = torch.where(_col(track), n, bn)
        bdep = torch.where(track, db, bdep)
        upd = active & ~conv & have_face

        # Faces visible from w retire; the horizon is their directed edges
        # whose reverse is not a visible edge.
        vis = fvalid & ((_dot(fn, w.unsqueeze(1)) - fd > 1e-7) | (fidx == _col(bf)))
        Ea = torch.cat([fa, fb, fc], 1)                      # [L, 3F]
        Eb = torch.cat([fb, fc, fa], 1)
        evis = torch.cat([vis, vis, vis], 1)
        seen = torch.zeros((L, V * V + 1), dtype=torch.bool, device=dev)
        seen.scatter_(1, torch.where(evis, Ea * V + Eb, V * V), True)
        horizon = evis & ~torch.gather(seen, 1, Eb * V + Ea)

        nvi = nvert
        at_new = (vidx == _col(nvi)).unsqueeze(-1)
        verts_n = torch.where(at_new, w.unsqueeze(1), verts)
        vA_n = torch.where(at_new, sa.unsqueeze(1), vA)
        vB_n = torch.where(at_new, sb.unsqueeze(1), vB)
        vsum_n = vsum + w
        nvert_n = torch.clamp(nvert + 1, max=V)

        # The k-th horizon edge goes to the k-th free face slot.
        fvalid_mid = fvalid & ~vis
        h_rank = torch.cumsum(horizon.to(torch.int32), 1) - 1
        free = ~fvalid_mid
        nfree = torch.sum(free.to(torch.int32), 1)
        okh = horizon & (h_rank < _col(nfree))
        free_slots = torch.sort(fvalid_mid.to(torch.int32), dim=1, stable=True).indices
        tgt = torch.where(okh, torch.gather(free_slots, 1, h_rank.clamp(0, F - 1).long()), F)
        written = torch.zeros((L, F + 1), dtype=torch.bool, device=dev)
        written = written.scatter_(1, tgt, True)[:, :F]
        # Slot F collects the edges that are not placed (their values race
        # there and are dropped); every placed edge owns its slot.
        fa_w = torch.zeros((L, F + 1), dtype=torch.long, device=dev).scatter_(1, tgt, Ea)
        fb_w = torch.zeros((L, F + 1), dtype=torch.long, device=dev).scatter_(1, tgt, Eb)
        fa_n = torch.where(written, fa_w[:, :F], fa)
        fb_n = torch.where(written, fb_w[:, :F], fb)
        fc_n = torch.where(written, _col(nvi), fc)
        fn_n, fd_n, fok_n = _face_geom(verts_n, vsum_n, nvert_n, fa_n, fb_n, fc_n)
        fvalid_n = (fvalid_mid | written) & (fok_n | ~written)
        fn_n = torch.where(_col(written), fn_n, fn)
        fd_n = torch.where(written, fd_n, fd)

        u1, u2 = _col(upd), upd.view(L, 1, 1)
        verts = torch.where(u2, verts_n, verts)
        vA = torch.where(u2, vA_n, vA)
        vB = torch.where(u2, vB_n, vB)
        vsum = torch.where(u1, vsum_n, vsum)
        nvert = torch.where(upd, nvert_n, nvert)
        fa = torch.where(u1, fa_n, fa)
        fb = torch.where(u1, fb_n, fb)
        fc = torch.where(u1, fc_n, fc)
        fn = torch.where(u2, fn_n, fn)
        fd = torch.where(u1, fd_n, fd)
        fvalid = torch.where(u1, fvalid_n, fvalid)
        active = upd
    if useful is not None:
        counters.count("epa_useful", useful.sum())
        counters.count("epa_attempted", L * EPA_ITERS)

    # Witness points: the origin projected onto the best face's triangle.
    score = torch.where(fvalid, fd, 1e30)
    bf = torch.argmin(score, dim=1)
    use_face = torch.any(fvalid, dim=1) & (torch.abs(_take1(fd, bf) - bdep) < 1e-5)
    n_fin = torch.where(_col(use_face), _take1(fn, bf), bn)
    ia, ib, ic = _take1(fa, bf), _take1(fb, bf), _take1(fc, bf)
    va, vb, vc = _take1(verts, ia), _take1(verts, ib), _take1(verts, ic)
    p = _col(bdep) * n_fin
    e1, e2 = vb - va, vc - va
    a11, a22, a12 = _dot(e1, e1), _dot(e2, e2), _dot(e1, e2)
    r = p - va
    det = torch.clamp(a11 * a22 - a12 * a12, min=_EPS)
    u = (_dot(r, e1) * a22 - _dot(r, e2) * a12) / det
    v = (a11 * _dot(r, e2) - a12 * _dot(r, e1)) / det
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.minimum(torch.clamp(v, min=0.0), 1.0 - u)
    l0 = 1.0 - u - v
    cpA = _col(l0) * _take1(vA, ia) + _col(u) * _take1(vA, ib) + _col(v) * _take1(vA, ic)
    cpB = _col(l0) * _take1(vB, ia) + _col(u) * _take1(vB, ib) + _col(v) * _take1(vB, ic)
    return bdep, n_fin, cpA, cpB, seed_ok


# ---------------------------------------------------------------------------
# Shape-pair entry point


def _border_radius(st, prm):
    """Dilation radius: the round shapes' borders PLUS the radius of balls
    and capsules, whose GJK/EPA inner shape is their point or segment
    skeleton (parry's RoundShape view)."""
    zero = torch.zeros_like(prm[..., 0])
    return torch.where(
        st == ShapeType.ROUND_CUBOID, prm[..., 3],
        torch.where(
            (st == ShapeType.ROUND_CYLINDER) | (st == ShapeType.ROUND_CONE), prm[..., 2],
            torch.where(
                st == ShapeType.CONVEX, prm[..., 1],
                torch.where(st == ShapeType.BALL, prm[..., 0],
                            torch.where(st == ShapeType.CAPSULE, prm[..., 6], zero)))))


def _inner_support(st, prm, d_local, hull, types=None):
    """Support of the shape's inner skeleton: a ball collapses to its
    centre, a capsule to its segment; every other shape is itself."""
    s = support_point(st, prm, d_local, hull, types)
    dn = d_local / _col(torch.clamp(_norm(d_local), min=_EPS))
    zero = torch.zeros_like(prm[..., 0])
    smooth_r = torch.where(st == ShapeType.BALL, prm[..., 0],
                           torch.where(st == ShapeType.CAPSULE, prm[..., 6], zero))
    return s - dn * _col(smooth_r)


def make_support(pA, rA, stA, prmA, pB, rB, stB, prmB, hullA=None, hullB=None,
                 types=None):
    """World-frame support map of A - B over the inner skeletons (border
    and smooth radii excluded; the caller adds them).  `types`: the shape
    types the lanes can hold (`support_point`), None for all."""

    def supp(d_w):
        la = _inner_support(stA, prmA, quat.inv_rotate(rA, d_w), hullA, types)
        lb = _inner_support(stB, prmB, quat.inv_rotate(rB, -d_w), hullB, types)
        sa = quat.transform_point(pA, rA, la)
        sb = quat.transform_point(pB, rB, lb)
        return sa - sb, sa, sb

    return supp


def _lanes(x, idx):
    """The lanes `idx` (None: all) of a lane-first tensor or of None."""
    return x if x is None or idx is None else x[idx]


def _epa_on(mask, supp_of, g, out):
    """Run EPA on the lanes of `mask` only and write (depth, normal, cpA,
    cpB, ok) into the full-width tuple `out`.  `supp_of(idx)` builds the
    support map of the lanes `idx`."""
    idx = torch.nonzero(mask).flatten()
    if idx.numel() == 0:
        return out
    sub = {k: v[idx] for k, v in g.items()}
    res = epa(supp_of(idx), sub)
    for full, part in zip(out, res):
        full[idx] = part
    return out


def contact_support_maps(pA, rA, stA, prmA, pB, rB, stB, prmB, hullA=None, hullB=None,
                         types=None):
    """Exact contact between two convex shapes a lane, via GJK (separated)
    and EPA (penetrating).  Returns (dist [L], normal [L, 3] A -> B, cpA,
    cpB [L, 3]): dist is the signed gap including the border radii, the
    witness points lie on the outer (rounded) surfaces.  `types`: the shape
    types the lanes can hold (`support_point`), None for all."""
    args = (pA, rA, stA, prmA, pB, rB, stB, prmB, hullA, hullB)
    L, dt, dev = pA.shape[0], pA.dtype, pA.device
    bA = _border_radius(stA, prmA)
    bB = _border_radius(stB, prmB)
    eps_inf = 1e-4

    def supp_of(idx=None, inflate=False):
        supp = make_support(*[_lanes(a, idx) for a in args], types=types)
        if not inflate:
            return supp

        # The difference inflated by a small ball: a shape pair touching
        # exactly (the origin on the Minkowski boundary, often at a vertex)
        # gets a strictly interior origin and an EPA seed.
        def supp_inf(d_w):
            w, sa, sb = supp(d_w)
            dn = d_w / _col(torch.clamp(_norm(d_w), min=_EPS))
            return w + eps_inf * dn, sa, sb

        return supp_inf

    unit_y = torch.zeros_like(pA)
    unit_y[:, 1] = 1.0
    d0 = pB - pA
    d0 = torch.where(_col(_norm(d0) < _EPS), unit_y, d0)
    with counters.span("gjk"):
        g = gjk(supp_of(), d0)

    def empty():
        return (torch.zeros((L,), dtype=dt, device=dev), unit_y.clone(),
                torch.zeros_like(pA), torch.zeros_like(pA),
                torch.zeros((L,), dtype=torch.bool, device=dev))

    inter = g["intersect"]
    with counters.span("epa"):
        depth, n_pen, cpA_p, cpB_p, epa_ok = _epa_on(inter, supp_of, g, empty())
    ok_pen = inter & epa_ok
    dist = torch.where(ok_pen, -depth, g["dist"]) - bA - bB

    # The retry only matters on intersecting lanes whose exact EPA had no
    # seed: GJK and EPA on the inflated difference, from the same d0.
    retry = inter & ~ok_pen
    n_inf = unit_y.clone()
    inf_ok = torch.zeros((L,), dtype=torch.bool, device=dev)
    idx = torch.nonzero(retry).flatten()
    if idx.numel():
        supp_inf = supp_of(idx, inflate=True)
        with counters.span("gjk"):
            g2 = gjk(supp_inf, d0[idx])
        with counters.span("epa"):
            _, n2, _, _, ok2 = epa(supp_inf, g2)
        n_inf[idx] = n2
        inf_ok[idx] = ok2 & g2["intersect"]
    # Last resort: the centre line.
    fallback_n = d0 / _col(torch.clamp(_norm(d0), min=_EPS))
    normal = torch.where(_col(ok_pen), n_pen,
                         torch.where(_col(inter & inf_ok), n_inf,
                                     torch.where(_col(inter), fallback_n, g["normal"])))
    cpA = torch.where(_col(ok_pen), cpA_p, g["cpA"]) + normal * _col(bA)
    cpB = torch.where(_col(ok_pen), cpB_p, g["cpB"]) - normal * _col(bB)
    return dist, normal, cpA, cpB
