"""Narrow-phase dispatcher (counterpart of rapier_tpu.geometry.dispatch).

Every present analytic kernel runs over the pair lanes and its result is
selected by the lanes' canonical shape-type pair.  The reference's staged
``[38, P]`` collider table and one-hot routes become direct gathers.  The
box-box kernel runs on a per-type index bucket whose width is the
reference's census-derived cap; lanes beyond the cap are dropped and counted
in `unsupported` exactly as the reference does.

Pair kernels: ball-ball, ball-cuboid, ball-capsule, capsule-capsule,
cuboid-capsule and cuboid-cuboid analytic; every other pair of convex shapes
(a cylinder, cone, segment, round shape or hull on either side) takes the
generic GJK/EPA kernel `narrowphase_convex.convex_convex`, on the lanes that
reach it only (gathered by index, their manifolds scattered back; the
reference runs it on a census-capped bucket, and the port drops and counts
the same lanes past that cap).  Against a halfspace (always put in slot B):
the analytic ball and capsule kernels, the support-sampling kernel for the
other convex shapes.  Pairs with a trimesh or heightfield leave this path:
`compute_mesh_manifolds` expands each (convex, mesh) pair into per-triangle
sub-lanes, and `concat_manifolds` appends them to the pair lanes.  A pair
with no kernel (a triangle collider) is counted in `unsupported`, as in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rapier_tpu_torch.geometry import narrowphase as nph
from rapier_tpu_torch.geometry import narrowphase_convex as npc
from rapier_tpu_torch.geometry import narrowphase_mesh as npm
from rapier_tpu_torch.geometry import shapes
from rapier_tpu_torch.geometry.narrowphase_boxbox import cuboid_cuboid_cl
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import BodyType, CoefficientCombineRule, ShapeType
from rapier_tpu_torch.utils.compaction import compact_indices
from rapier_tpu_torch.utils.counters import span, stage


class ManifoldBatch(NamedTuple):
    """Per-pair manifolds + solver metadata, lane axis LAST, leading scene
    axis ``[B, ...]`` (see the reference's ManifoldBatch)."""

    collider1: torch.Tensor         # [B, P]
    collider2: torch.Tensor         # [B, P]
    active_events_or: torch.Tensor  # [B, P]
    active_hooks_or: torch.Tensor   # [B, P]
    force_threshold: torch.Tensor   # [B, P]
    dyn1: torch.Tensor              # [B, P] bool
    dyn2: torch.Tensor              # [B, P] bool
    body1: torch.Tensor             # [B, P] (-1 = static environment)
    body2: torch.Tensor             # [B, P]
    pair_key: torch.Tensor          # [B, P]
    normal: torch.Tensor            # [B, 3, P]
    point: torch.Tensor             # [B, 4, 3, P]
    dist: torch.Tensor              # [B, 4, P]
    fid: torch.Tensor               # [B, 4, P] int32
    point_valid: torch.Tensor       # [B, 4, P]
    point_active: torch.Tensor      # [B, 4, P]
    valid: torch.Tensor             # [B, P]
    unsupported: torch.Tensor       # [B] int32
    solver_pair: torch.Tensor       # [B, P]
    touching: torch.Tensor          # [B, P]
    sensor: torch.Tensor            # [B, P]
    friction: torch.Tensor          # [B, P]
    restitution: torch.Tensor       # [B, P]
    rel_dominance: torch.Tensor     # [B, P]


def _combine_material(v1, v2, rule1, rule2):
    """CoefficientCombineRule: the greater enum value wins."""
    rule = torch.maximum(rule1, rule2)
    return torch.where(
        rule == CoefficientCombineRule.MIN, torch.minimum(v1, v2),
        torch.where(rule == CoefficientCombineRule.MULTIPLY, v1 * v2,
                    torch.where(rule == CoefficientCombineRule.MAX,
                                torch.maximum(v1, v2), (v1 + v2) * 0.5)))


def _rows(x, idx):
    """Gather rows ``x [B, N, ...]`` at ``idx [B, M]`` -> ``[B, M, ...]``."""
    idx = idx.long()
    view = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, view)


def collider_world_poses(bodies, colliders):
    """World pose of every collider: parent pose ∘ local pose."""
    parent = colliders.parent
    has = (parent >= 0).unsqueeze(-1)
    safe_p = parent.clamp(min=0)
    bp = torch.where(has, _rows(bodies.pos, safe_p), 0.0)
    ident = torch.zeros_like(colliders.local_rot)
    ident[..., 3] = 1.0
    br = torch.where(has, _rows(bodies.rot, safe_p), ident)
    return quat.compose(bp, br, colliders.local_pos, colliders.local_rot)


def parent_body_cols(bodies, parent):
    """Per-collider parent-body columns with parent < 0 defaulted:
    (body_type, mb_link, dominance, soft_ccd_prediction, linvel [B, C, 3])."""
    has = parent >= 0
    safe_p = parent.clamp(min=0)
    bt_c = torch.where(has, _rows(bodies.body_type, safe_p), int(BodyType.FIXED))
    mb_link_c = has & _rows(bodies.mb_link, safe_p)
    dom_c = _rows(bodies.dominance, safe_p)
    soft_c = torch.where(has, _rows(bodies.soft_ccd_prediction, safe_p), 0.0)
    linvel_c = torch.where(has.unsqueeze(-1), _rows(bodies.linvel, safe_p), 0.0)
    return bt_c, mb_link_c, dom_c, soft_c, linvel_c


_PAIR_KERNELS = {
    (ShapeType.BALL, ShapeType.BALL): nph.ball_ball,
    (ShapeType.BALL, ShapeType.CUBOID): nph.ball_cuboid,
    (ShapeType.BALL, ShapeType.CAPSULE): nph.ball_capsule,
    (ShapeType.CAPSULE, ShapeType.CAPSULE): nph.capsule_capsule,
    (ShapeType.CUBOID, ShapeType.CAPSULE): nph.swapped(nph.capsule_cuboid),
    (ShapeType.CUBOID, ShapeType.CUBOID): cuboid_cuboid_cl,
}
# Shape types the generic convex-halfspace kernel covers (the reference's
# _HALFSPACE_CONVEX less ball and capsule, which have analytic kernels).
_HALFSPACE_GENERIC = tuple(t for t in npc.SUPPORTED
                           if t not in (ShapeType.BALL, ShapeType.CAPSULE))
_BUCKETED = cuboid_cuboid_cl
_BUCKET_PAIR_FACTOR = 8


def bucket_cap(ta, tb, counts, p):
    """The reference's census-derived box-box bucket width."""
    if counts is None:
        return p
    ca = counts.get(int(ta), 0)
    cb = counts.get(int(tb), 0)
    est = ca if ta == tb else min(ca, cb)
    if est >= (1 << 28):
        return p
    cap = -(-est * _BUCKET_PAIR_FACTOR // 64) * 64
    return cap if cap * 2 <= p else p


def _census(present):
    """{shape type: colliders} from SimParams.shape_types_present ((type,
    count) pairs, or plain types of unknown count); None when empty."""
    if not present:
        return None
    counts = {}
    for entry in present:
        if isinstance(entry, tuple):
            counts[int(entry[0])] = int(entry[1])
        else:
            counts[int(entry)] = 1 << 30
    return counts


def _any_type(t, types):
    m = torch.zeros_like(t, dtype=torch.bool)
    for ty in types:
        m = m | (t == int(ty))
    return m


def _generic_cap(counts, pair_possible, p):
    """(need_cc, cap_cc): whether some present convex pair lacks an analytic
    kernel, and the reference's census-derived width of the GJK/EPA bucket
    (dispatch.py:422-459): 8 pair slots per collider of a type that meets
    such a pair, rounded up to 64, at least 64; the full width when unknown
    or when that is more than half of it."""
    if counts is None:
        return True, p
    pres = [int(t) for t in npc.SUPPORTED if int(t) in counts]

    def generic(a, b):
        return ((ShapeType(min(a, b)), ShapeType(max(a, b))) not in _PAIR_KERNELS
                and pair_possible(a, b))

    if not any(generic(a, b) for a in pres for b in pres):
        return False, p
    est = sum(counts.get(t, 0) for t in pres if any(generic(t, o) for o in pres))
    cap = min(p, max(64, -(-est * _BUCKET_PAIR_FACTOR // 64) * 64))
    return True, (p if cap * 2 > p else cap)


def _hull_index(t, prm):
    """A CONVEX lane's row of the hull table (shape_params[0]); 0 for the
    other lanes (unused)."""
    return torch.where(t == ShapeType.CONVEX, prm[..., 0, :].long(), 0)


def _convex_lanes(run, pA, rA, tA, prmA, pB, rB, tB, prmB, hull_vertices=None, types=None):
    """convex_convex on the lanes of `run` ``[B, P]`` only, gathered by
    index from the lane-last fields (`hull_vertices`: the scene's hull table
    ``[B, H, V, 3]``, or None; `types` the census's shape types, None for
    all).  Returns a lane-last Manifold with the reference's defaults on the
    other lanes (normal +Y, dist 1e10, fid -1, invalid)."""
    b, p = run.shape
    dev, ft = run.device, pA.dtype
    normal = torch.zeros((b, 3, p), dtype=ft, device=dev)
    normal[:, 1] = 1.0
    point = torch.zeros((b, 4, 3, p), dtype=ft, device=dev)
    dist = torch.full((b, 4, p), 1e10, dtype=ft, device=dev)
    fid = torch.full((b, 4, p), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros((b, 4, p), dtype=torch.bool, device=dev)
    bi, li = torch.nonzero(run, as_tuple=True)
    if bi.numel():
        def rows(x):
            return x[bi, ..., li] if x.dim() > 2 else x[bi, li]

        def hull(t, prm):
            if hull_vertices is None:
                return None
            return hull_vertices[bi, _hull_index(t, prm)[bi, li]]

        man = npc.convex_convex(rows(pA), rows(rA), rows(tA), rows(prmA),
                                rows(pB), rows(rB), rows(tB), rows(prmB),
                                hull(tA, prmA), hull(tB, prmB), types)
        normal[bi, :, li] = man.normal
        point[bi, :, :, li] = man.point
        dist[bi, :, li] = man.dist
        fid[bi, :, li] = man.fid
        valid[bi, :, li] = man.valid
    return nph.Manifold(normal=normal, point=point, dist=dist, fid=fid, valid=valid)


def _order_rank(t):
    """Canonical ordering rank: a halfspace always goes to the B slot."""
    return torch.where(t == ShapeType.HALFSPACE, 1000, t)


def _run_bucketed(kern, mask, cap, args):
    """Run a lane-last kernel on the first `cap` lanes of `mask`, scattered
    back to the full width.  Lanes outside the bucket get the reference's
    uncovered defaults.  Returns (manifold, dropped [B])."""
    src, bvalid, dropped = compact_indices(mask, cap)
    b, p = mask.shape

    def take(x):
        idx = src.view((b,) + (1,) * (x.dim() - 2) + (cap,)).expand(
            x.shape[:-1] + (cap,))
        return torch.gather(x, -1, idx)

    man_b = kern(*[take(a) for a in args])
    tgt = torch.where(bvalid, src, p)

    def put(x, default):
        full = default.to(x.dtype).expand(x.shape[:-1] + (p + 1,)).clone()
        idx = tgt.view((b,) + (1,) * (x.dim() - 2) + (cap,)).expand(x.shape)
        return full.scatter(-1, idx, x)[..., :p]

    dev = mask.device
    unit_y = torch.tensor([0.0, 1.0, 0.0], device=dev).view(3, 1)
    man = nph.Manifold(
        normal=put(man_b.normal, unit_y),
        point=put(man_b.point, torch.zeros((), device=dev)),
        dist=put(man_b.dist, torch.tensor(1e10, device=dev)),
        fid=put(man_b.fid, torch.tensor(-1, dtype=torch.int32, device=dev)),
        valid=put(man_b.valid, torch.tensor(False, device=dev)),
    )
    return man, dropped


def _soft_ccd_cols(soft, v, dt):
    """Parent linvel clamped to soft_ccd_prediction/dt (narrow_phase.rs
    :953-958) and the soft-CCD flag column."""
    inv_dt = 0.0 if dt == 0 else float(1.0 / float(dt))
    vmag = torch.linalg.norm(v, dim=-1, keepdim=True)
    cap = (soft * inv_dt).unsqueeze(-1)
    scale = torch.where((soft.unsqueeze(-1) > 0) & (vmag > cap),
                        cap / torch.clamp(vmag, min=1e-12), 1.0)
    return v * scale, soft


def compute_manifolds(bodies, colliders, c1, c2, pair_valid, prediction,
                      present: tuple = (), hulls=None, dt=None):
    """Contact manifolds for the ``[B, P]`` pair buffer (c1 < c2, -1 empty).

    `present` is the static shape-type census (SimParams.shape_types_present):
    kernels whose pair types cannot occur are skipped, and the box-box and
    GJK/EPA bucket widths derive from it.  Empty = unknown: every kernel
    runs.  `hulls` is the scene's `ConvexHulls` table (batched ``[B, H, V,
    3]``), needed when a CONVEX collider is present."""
    counts = _census(present)

    def has(t):
        return counts is None or int(t) in counts

    def pair_possible(ta, tb):
        if counts is None:
            return True
        ta, tb = int(ta), int(tb)
        if ta not in counts or tb not in counts:
            return False
        return ta != tb or counts[ta] >= 2

    with span("gather"):
        b, p = c1.shape
        n_coll = colliders.parent.shape[-1]
        w_pos, w_rot = collider_world_poses(bodies, colliders)
        s1 = c1.clamp(min=0).long()
        s2 = c2.clamp(min=0).long()

        parent = colliders.parent
        bt_c, mb_link_c, dom_raw, soft_c, linvel_c = parent_body_cols(bodies, parent)
        sdyn_c = (bt_c == BodyType.DYNAMIC) | mb_link_c
        dom_c = torch.where(sdyn_c, dom_raw, 127)
        sg = colliders.solver_groups
        if dt is None:
            soft_v, soft_flag_c = torch.zeros_like(linvel_c), torch.zeros_like(soft_c)
        else:
            soft_v, soft_flag_c = _soft_ccd_cols(soft_c, linvel_c, dt)

        def lanes(x, s):
            """Per-collider ``[B, C]`` / ``[B, C, d]`` -> lane-last ``[B, P]`` /
            ``[B, d, P]``."""
            r = _rows(x, s)
            return r if r.dim() == 2 else r.transpose(1, 2)

        def side(s):
            return dict(
                pos=lanes(w_pos, s), rot=lanes(w_rot, s),
                prm=lanes(colliders.shape_params, s),
                type=lanes(colliders.shape_type, s),
                friction=lanes(colliders.friction, s),
                restitution=lanes(colliders.restitution, s),
                fcomb=lanes(colliders.friction_combine, s),
                rcomb=lanes(colliders.restitution_combine, s),
                skin=lanes(colliders.contact_skin, s),
                sensor=lanes(colliders.sensor, s),
                sg_m=lanes(sg >> 16, s), sg_f=lanes(sg & 0xFFFF, s),
                parent=lanes(parent, s), dom=lanes(dom_c, s),
                events=lanes(colliders.active_events, s),
                hooks=lanes(colliders.active_hooks, s),
                thr=lanes(torch.clamp(colliders.contact_force_event_threshold,
                                      max=3.0e38), s),
                sdyn=lanes(sdyn_c, s),
                soft_v=lanes(soft_v, s), soft=lanes(soft_flag_c, s),
            )

        T1, T2 = side(s1), side(s2)
        flip = _order_rank(T1["type"]) > _order_rank(T2["type"])
        f3 = flip.unsqueeze(1)
        pA = torch.where(f3, T2["pos"], T1["pos"])
        rA = torch.where(f3, T2["rot"], T1["rot"])
        prmA = torch.where(f3, T2["prm"], T1["prm"])
        pB = torch.where(f3, T1["pos"], T2["pos"])
        rB = torch.where(f3, T1["rot"], T2["rot"])
        prmB = torch.where(f3, T1["prm"], T2["prm"])
        tA = torch.where(flip, T2["type"], T1["type"])
        tB = torch.where(flip, T1["type"], T2["type"])
        args = (pA, rA, prmA, pB, rB, prmB)

        hull_vertices = (hulls.vertices if hulls is not None and has(ShapeType.CONVEX)
                         else None)

        dev, ft = c1.device, pA.dtype
        normal = torch.zeros((b, 3, p), dtype=ft, device=dev)
        normal[:, 1] = 1.0
        point = torch.zeros((b, 4, 3, p), dtype=ft, device=dev)
        dist = torch.full((b, 4, p), 1e10, dtype=ft, device=dev)
        fid = torch.full((b, 4, p), -1, dtype=torch.int32, device=dev)
        pvalid = torch.zeros((b, 4, p), dtype=torch.bool, device=dev)
        matched = torch.zeros((b, p), dtype=torch.bool, device=dev)
        bucket_dropped = torch.zeros((b,), dtype=torch.int32, device=dev)

    def merge(mask, man):
        nonlocal normal, point, dist, fid, pvalid, matched
        with span("merge"):
            m2 = mask.unsqueeze(1)
            normal = torch.where(m2, man.normal, normal)
            point = torch.where(m2.unsqueeze(1), man.point, point)
            dist = torch.where(m2, man.dist, dist)
            fid = torch.where(m2, man.fid, fid)
            pvalid = torch.where(m2, man.valid, pvalid)
            matched = matched | mask

    for (ta, tb), kern in _PAIR_KERNELS.items():
        if not pair_possible(ta, tb):
            continue
        with span(f"{ta.name.lower()}_{tb.name.lower()}"):
            mask = pair_valid & (tA == ta) & (tB == tb)
            cap = bucket_cap(ta, tb, counts, p) if kern is _BUCKETED else p
            if cap < p:
                man, dropped = _run_bucketed(kern, mask, cap, args)
                bucket_dropped = bucket_dropped + dropped
            else:
                man = kern(*args)
        merge(mask, man)

    # The generic convex-convex fallback (reference dispatch.py:422-481):
    # the convex pairs no analytic kernel matched.  Lanes past the census
    # cap are dropped and counted, as the reference's bucket drops them;
    # GJK/EPA runs on the others only.
    need_cc, cap_cc = _generic_cap(counts, pair_possible, p)
    if need_cc:
        with stage("gjk_epa"):
            cc_mask = (pair_valid & ~matched & _any_type(tA, npc.SUPPORTED)
                       & _any_type(tB, npc.SUPPORTED))
            run = cc_mask
            if cap_cc < p:
                rank = torch.cumsum(cc_mask.to(torch.int32), dim=-1)
                run = cc_mask & (rank <= cap_cc)
                bucket_dropped = bucket_dropped + torch.clamp(
                    rank[:, -1] - cap_cc, min=0).to(torch.int32)
            merge(cc_mask, _convex_lanes(run, pA, rA, tA, prmA, pB, rB, tB, prmB,
                                         hull_vertices,
                                         None if counts is None else set(counts)))

    # Halfspace bucket (reference dispatch.py:485-510): analytic ball and
    # capsule kernels, the support-sampling kernel for the other convex
    # types.
    if has(ShapeType.HALFSPACE):
        with span("halfspace"):
            hs_mask = pair_valid & (tB == ShapeType.HALFSPACE)
            if has(ShapeType.BALL):
                merge(hs_mask & (tA == ShapeType.BALL), nph.ball_halfspace(*args))
            if has(ShapeType.CAPSULE):
                merge(hs_mask & (tA == ShapeType.CAPSULE), nph.capsule_halfspace(*args))
            hs_generic = [t for t in _HALFSPACE_GENERIC if has(t)]
            if hs_generic:
                conv_ok = torch.zeros_like(hs_mask)
                for t in hs_generic:
                    conv_ok = conv_ok | (tA == t)
                hull_rows = (None if hull_vertices is None
                             else _rows(hull_vertices, _hull_index(tA, prmA)))   # [B, P, V, 3]
                merge(hs_mask & conv_ok,
                      nph.convex_halfspace(pA, rA, tA, prmA, pB, rB, prmB, hull_rows,
                                           None if counts is None else set(counts)))

    # Restore the pair orientation: normal points collider1 -> collider2.
    normal = torch.where(f3, -normal, normal)
    dist = dist - (T1["skin"] + T2["skin"]).unsqueeze(1)

    # Soft-CCD prediction inflation (narrow_phase.rs:944-970).
    soft_flag = (T1["soft"] > 0.0) | (T2["soft"] > 0.0)
    dv = T1["soft_v"] - T2["soft_v"]
    rel_v = torch.sqrt(torch.clamp(
        dv[:, 0] ** 2 + dv[:, 1] ** 2 + dv[:, 2] ** 2, min=0.0))
    dt_f = 0.0 if dt is None else float(dt)
    pred = torch.full_like(rel_v, float(prediction))
    eff_prediction = torch.where(soft_flag, torch.maximum(pred, dt_f * rel_v), pred)
    point_active = pvalid & (dist < eff_prediction.unsqueeze(1))
    any_active = torch.any(point_active, dim=1)
    touching = pair_valid & any_active

    friction = _combine_material(T1["friction"], T2["friction"],
                                 T1["fcomb"], T2["fcomb"])
    restitution = _combine_material(T1["restitution"], T2["restitution"],
                                    T1["rcomb"], T2["rcomb"])
    b1 = torch.where(pair_valid, T1["parent"], -1)
    b2 = torch.where(pair_valid, T2["parent"], -1)
    dom1 = torch.where(b1 >= 0, T1["dom"], 127)
    dom2 = torch.where(b2 >= 0, T2["dom"], 127)
    sensor = T1["sensor"] | T2["sensor"]
    solver_groups_ok = (((T1["sg_m"] & T2["sg_f"]) != 0)
                        & ((T2["sg_m"] & T1["sg_f"]) != 0))
    dyn1 = (b1 >= 0) & T1["sdyn"]
    dyn2 = (b2 >= 0) & T2["sdyn"]
    solver_pair = (pair_valid & matched & ~sensor & solver_groups_ok
                   & (dyn1 | dyn2) & any_active)
    pair_key = torch.where(pair_valid, s1 * n_coll + s2, -1).to(torch.int32)
    # Pairs with a mesh go to compute_mesh_manifolds: they leave this batch
    # after the fields above were taken, as in the reference (dispatch.py
    # :573-578), so their lanes keep bodies and pair keys but no collider.
    if any(has(t) for t in npm.MESH_TYPES):
        pair_valid = pair_valid & ~(npm.is_mesh_type(T1["type"]) | npm.is_mesh_type(T2["type"]))
    pv = pair_valid.unsqueeze(1)
    return ManifoldBatch(
        collider1=torch.where(pair_valid, s1, -1).to(torch.int32),
        collider2=torch.where(pair_valid, s2, -1).to(torch.int32),
        active_events_or=(T1["events"] | T2["events"]).to(torch.int32),
        active_hooks_or=(T1["hooks"] | T2["hooks"]).to(torch.int32),
        force_threshold=torch.minimum(T1["thr"], T2["thr"]),
        dyn1=dyn1, dyn2=dyn2,
        body1=b1.to(torch.int32), body2=b2.to(torch.int32),
        pair_key=pair_key,
        normal=normal, point=point, dist=dist, fid=fid,
        point_valid=pvalid & pv,
        point_active=point_active & pv,
        valid=pair_valid & matched,
        unsupported=(torch.sum((pair_valid & ~matched).to(torch.int32), dim=-1)
                     + bucket_dropped).to(torch.int32),
        solver_pair=solver_pair,
        touching=touching,
        sensor=sensor & pair_valid,
        friction=friction, restitution=restitution,
        rel_dominance=(dom1 - dom2).to(torch.int32),
    )


def compute_mesh_manifolds(bodies, colliders, meshes, c1, c2, pair_valid, prediction,
                           max_mesh_pairs: int, tris_per_pair: int, present: tuple = ()):
    """Expand the (convex, mesh) broad-phase pairs into per-triangle
    manifolds (reference dispatch.py:607-794).

    The mesh pairs are compacted in pair order to `max_mesh_pairs` (those
    beyond are dropped, uncounted, as in the reference); each takes the
    `tris_per_pair` triangles of its mesh whose local AABBs overlap the
    convex shape's most (ties to the lower triangle index, as `lax.top_k`
    orders them).  Returns a ManifoldBatch of ``max_mesh_pairs *
    tris_per_pair`` lanes, row-major by (mesh pair, rank).  A lane's pair key
    encodes its triangle, ``lo * C + hi + (tri + 1) * C**2``, so the
    warmstart join matches it across steps; the int32 cast wraps a key past
    2**31 as the reference's int32 arithmetic does (`PhysicsWorld.build`
    refuses a scene whose keys would pass 2**32)."""
    pm, k = max_mesh_pairs, tris_per_pair
    bsz = c1.shape[0]
    n_coll = colliders.parent.shape[-1]
    w_pos, w_rot = collider_world_poses(bodies, colliders)
    s1 = c1.clamp(min=0).long()
    s2 = c2.clamp(min=0).long()
    m1 = npm.is_mesh_type(torch.gather(colliders.shape_type, 1, s1))
    m2 = npm.is_mesh_type(torch.gather(colliders.shape_type, 1, s2))
    is_mesh_pair = pair_valid & (m1 ^ m2)

    # The mesh pairs in pair order: convex side cA, mesh side cM; flip marks
    # the mesh as collider1 of the pair.
    src, lane_valid, _dropped = compact_indices(is_mesh_pair, pm)
    cA = torch.where(lane_valid, torch.gather(torch.where(m1, s2, s1), 1, src), 0)
    cM = torch.where(lane_valid, torch.gather(torch.where(m1, s1, s2), 1, src), 0)
    flip = lane_valid & torch.gather(m1, 1, src)

    # Mid-phase: rank the triangles by AABB overlap with the convex shape,
    # in the mesh collider's local frame.
    tris = meshes.triangles.long()                           # [B, T, 3]
    t_total = tris.shape[1]
    tv = [_rows(meshes.vertices, tris[..., i].clamp(min=0)) for i in range(3)]
    tri_min = torch.minimum(torch.minimum(tv[0], tv[1]), tv[2])    # [B, T, 3]
    tri_max = torch.maximum(torch.maximum(tv[0], tv[1]), tv[2])
    tri_ok = tris[..., 0] >= 0

    a_min, a_max = shapes.compute_aabbs(
        _rows(colliders.shape_type, cA), _rows(colliders.shape_params, cA),
        _rows(w_pos, cA), _rows(w_rot, cA))
    a_min = a_min - prediction
    a_max = a_max + prediction
    mp, mr = _rows(w_pos, cM), _rows(w_rot, cM)              # [B, pm, 3|4]
    ctr = quat.inv_rotate(mr, 0.5 * (a_min + a_max) - mp)
    he_l = shapes._absm_vec(torch.abs(quat.to_matrix(quat.conj(mr))), 0.5 * (a_max - a_min))
    lo = ctr - he_l
    hi = ctr + he_l
    prm_m = _rows(colliders.shape_params, cM)
    start = prm_m[..., 0].to(torch.int32).unsqueeze(-1)
    count = prm_m[..., 1].to(torch.int32).unsqueeze(-1)
    idx = torch.arange(t_total, dtype=torch.int32, device=c1.device)
    in_range = (idx >= start) & (idx < start + count) & tri_ok.unsqueeze(1)
    ok = torch.ones_like(in_range)
    score = torch.zeros(in_range.shape, dtype=lo.dtype, device=lo.device)
    for ax in range(3):                                      # [B, pm, T] each
        per_axis = (torch.minimum(hi[..., ax:ax + 1], tri_max[..., ax].unsqueeze(1))
                    - torch.maximum(lo[..., ax:ax + 1], tri_min[..., ax].unsqueeze(1)))
        # A planar mesh overlaps with exactly zero extent on one axis: the
        # test is >= 0 and the score sums the other overlaps.
        ok = ok & (per_axis >= 0.0)
        score = score + torch.clamp(per_axis, min=0.0) if ax else torch.clamp(per_axis, min=0.0)
        del per_axis
    score = torch.where(in_range & lane_valid.unsqueeze(-1) & ok, score, -1e10)
    # A stable descending sort keeps equal scores in index order, as
    # lax.top_k does; torch.topk promises no order among ties.
    top_score, top = torch.sort(score, dim=-1, descending=True, stable=True)
    del score, in_range, ok
    top, top_valid = top[..., :k], top_score[..., :k] > -1e9

    # Flatten to [pm * k] sub-lanes, row-major by (mesh pair, rank).
    lane_cA = cA.repeat_interleave(k, dim=1)
    lane_cM = cM.repeat_interleave(k, dim=1)
    lane_flip = flip.repeat_interleave(k, dim=1)
    lane_tri = top.reshape(bsz, pm * k)
    lane_ok = lane_valid.repeat_interleave(k, dim=1) & top_valid.reshape(bsz, pm * k)

    def lanes(x, c):
        """Per-collider ``[B, C, d]`` at lane colliders -> ``[B, d, L]``."""
        return _rows(x, c).transpose(1, 2)

    mpos, mrot = _rows(w_pos, lane_cM), _rows(w_rot, lane_cM)
    wv = [quat.transform_point(mpos, mrot, _rows(v, lane_tri)).transpose(1, 2) for v in tv]
    pA, rA = lanes(w_pos, lane_cA), lanes(w_rot, lane_cA)
    stA = _rows(colliders.shape_type, lane_cA)
    prmA = lanes(colliders.shape_params, lane_cA)

    dev, ft = c1.device, pA.dtype
    n_l = pm * k
    normal = torch.zeros((bsz, 3, n_l), dtype=ft, device=dev)
    normal[:, 1] = 1.0
    point = torch.zeros((bsz, 4, 3, n_l), dtype=ft, device=dev)
    dist = torch.full((bsz, 4, n_l), 1e10, dtype=ft, device=dev)
    fid = torch.full((bsz, 4, n_l), -1, dtype=torch.int32, device=dev)
    pvalid = torch.zeros((bsz, 4, n_l), dtype=torch.bool, device=dev)
    # Each kernel over every lane, the lane's shape type selecting (the
    # cuboid, and any other type, takes the convex kernel).
    counts = _census(present)
    types = None if counts is None else set(counts)
    is_ball, is_cap = stA == ShapeType.BALL, stA == ShapeType.CAPSULE
    for mask, kern in (
            (~is_ball & ~is_cap, lambda: npm.convex_triangle(pA, rA, stA, prmA, *wv,
                                                             types=types)),
            (is_cap, lambda: npm.capsule_triangle(pA, rA, prmA, *wv)),
            (is_ball, lambda: npm.ball_triangle(pA, rA, prmA, *wv))):
        man = kern()
        m2 = mask.unsqueeze(1)
        normal = torch.where(m2, man.normal, normal)
        point = torch.where(m2.unsqueeze(1), man.point, point)
        dist = torch.where(m2, man.dist, dist)
        fid = torch.where(m2, man.fid, fid)
        pvalid = torch.where(m2, man.valid, pvalid)
        del man

    # The kernels' normal points convex -> triangle: back to collider1 ->
    # collider2.
    normal = torch.where(lane_flip.unsqueeze(1), -normal, normal)
    dist = dist - (_rows(colliders.contact_skin, lane_cA)
                   + _rows(colliders.contact_skin, lane_cM)).unsqueeze(1)
    pvalid = pvalid & lane_ok.unsqueeze(1)
    point_active = pvalid & (dist < prediction)
    any_active = torch.any(point_active, dim=1)
    touching = lane_ok & any_active

    lo_c = torch.where(lane_flip, lane_cM, lane_cA)
    hi_c = torch.where(lane_flip, lane_cA, lane_cM)

    def both(x):
        return _rows(x, lo_c), _rows(x, hi_c)

    friction = _combine_material(*both(colliders.friction), *both(colliders.friction_combine))
    restitution = _combine_material(*both(colliders.restitution),
                                    *both(colliders.restitution_combine))
    p1, p2 = both(colliders.parent)
    b1 = torch.where(lane_ok, p1, -1)
    b2 = torch.where(lane_ok, p2, -1)

    def body_cols(b):
        has, safe = b >= 0, b.clamp(min=0)
        bt = torch.where(has, _rows(bodies.body_type, safe), int(BodyType.FIXED))
        sd = (bt == BodyType.DYNAMIC) | (has & _rows(bodies.mb_link, safe))
        dom = torch.where(sd, _rows(bodies.dominance, safe), 127)
        return sd, torch.where(has, dom, 127)

    sd1, dom1 = body_cols(b1)
    sd2, dom2 = body_cols(b2)
    sen1, sen2 = both(colliders.sensor)
    sensor = sen1 | sen2
    sg1, sg2 = both(colliders.solver_groups)
    solver_ok = (((sg1 >> 16) & (sg2 & 0xFFFF)) != 0) & (((sg2 >> 16) & (sg1 & 0xFFFF)) != 0)
    solver_pair = lane_ok & ~sensor & solver_ok & (sd1 | sd2) & any_active
    pair_key = torch.where(lane_ok, lo_c * n_coll + hi_c + (lane_tri + 1) * (n_coll * n_coll),
                           -1)
    ev1, ev2 = both(colliders.active_events)
    hk1, hk2 = both(colliders.active_hooks)
    th1, th2 = both(colliders.contact_force_event_threshold)
    return ManifoldBatch(
        collider1=torch.where(lane_ok, lo_c, -1).to(torch.int32),
        collider2=torch.where(lane_ok, hi_c, -1).to(torch.int32),
        active_events_or=(ev1 | ev2).to(torch.int32),
        active_hooks_or=(hk1 | hk2).to(torch.int32),
        force_threshold=torch.minimum(th1, th2),
        dyn1=(b1 >= 0) & sd1, dyn2=(b2 >= 0) & sd2,
        body1=b1.to(torch.int32), body2=b2.to(torch.int32),
        pair_key=pair_key.to(torch.int32),
        normal=normal, point=point, dist=dist, fid=fid,
        point_valid=pvalid, point_active=point_active,
        valid=lane_ok,
        unsupported=torch.zeros((bsz,), dtype=torch.int32, device=dev),
        solver_pair=solver_pair, touching=touching,
        sensor=sensor & lane_ok,
        friction=friction, restitution=restitution,
        rel_dominance=(dom1 - dom2).to(torch.int32),
    )


def concat_manifolds(a: ManifoldBatch, b: ManifoldBatch) -> ManifoldBatch:
    """Two manifold batches joined along the (last) pair-lane axis; their
    `unsupported` counts add."""
    return ManifoldBatch(*[
        x + y if name == "unsupported" else torch.cat([x, y], dim=-1)
        for name, x, y in zip(ManifoldBatch._fields, a, b)])
