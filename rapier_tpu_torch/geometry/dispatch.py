"""Narrow-phase dispatcher (counterpart of rapier_tpu.geometry.dispatch).

Every present analytic kernel runs over the pair lanes and its result is
selected by the lanes' canonical shape-type pair.  The reference's staged
``[38, P]`` collider table and one-hot routes become direct gathers.  The
box-box kernel runs on a per-type index bucket whose width is the
reference's census-derived cap; lanes beyond the cap are dropped and counted
in `unsupported` exactly as the reference does.

Ported pair kernels: ball-ball, ball-cuboid, ball-capsule, capsule-capsule,
cuboid-capsule and cuboid-cuboid, and ball, capsule and cuboid against a
halfspace (always put in slot B).  Any other shape type in the scene census
raises NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rapier_tpu_torch.geometry import narrowphase as nph
from rapier_tpu_torch.geometry.narrowphase_boxbox import cuboid_cuboid_cl
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import BodyType, CoefficientCombineRule, ShapeType
from rapier_tpu_torch.utils.compaction import compact_indices


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
_PORTED_TYPES = {int(ShapeType.BALL), int(ShapeType.CUBOID), int(ShapeType.CAPSULE),
                 int(ShapeType.HALFSPACE)}
# Shape types the generic convex-halfspace kernel covers in the port (the
# reference's _HALFSPACE_CONVEX less ball and capsule, which have analytic
# kernels, and less the types the port does not carry).
_HALFSPACE_GENERIC = (ShapeType.CUBOID,)
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
    if not present:
        return None
    counts = {}
    for entry in present:
        if isinstance(entry, tuple):
            counts[int(entry[0])] = int(entry[1])
        else:
            counts[int(entry)] = 1 << 30
    missing = set(counts) - _PORTED_TYPES
    if missing:
        names = ", ".join(ShapeType(t).name for t in sorted(missing))
        raise NotImplementedError(f"narrow phase for {names} is not ported")
    return counts


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
        full = default.expand(x.shape[:-1] + (p + 1,)).clone()
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
                      present: tuple = (), dt=None):
    """Contact manifolds for the ``[B, P]`` pair buffer (c1 < c2, -1 empty).

    `present` is the static shape-type census (SimParams.shape_types_present):
    kernels whose pair types cannot occur are skipped, and the box-box bucket
    width derives from it.  Empty = unknown: every ported kernel runs."""
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

    dev = c1.device
    normal = torch.zeros((b, 3, p), device=dev)
    normal[:, 1] = 1.0
    point = torch.zeros((b, 4, 3, p), device=dev)
    dist = torch.full((b, 4, p), 1e10, device=dev)
    fid = torch.full((b, 4, p), -1, dtype=torch.int32, device=dev)
    pvalid = torch.zeros((b, 4, p), dtype=torch.bool, device=dev)
    matched = torch.zeros((b, p), dtype=torch.bool, device=dev)
    bucket_dropped = torch.zeros((b,), dtype=torch.int32, device=dev)

    def merge(mask, man):
        nonlocal normal, point, dist, fid, pvalid, matched
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
        mask = pair_valid & (tA == ta) & (tB == tb)
        cap = bucket_cap(ta, tb, counts, p) if kern is _BUCKETED else p
        if cap < p:
            man, dropped = _run_bucketed(kern, mask, cap, args)
            bucket_dropped = bucket_dropped + dropped
        else:
            man = kern(*args)
        merge(mask, man)

    # Halfspace bucket (reference dispatch.py:485-510): analytic ball and
    # capsule kernels, the support-sampling kernel for the other convex
    # types.
    if has(ShapeType.HALFSPACE):
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
            merge(hs_mask & conv_ok,
                  nph.convex_halfspace(pA, rA, tA, prmA, pB, rB, prmB))

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
    pv = pair_valid.unsqueeze(1)
    return ManifoldBatch(
        collider1=torch.where(pair_valid, s1, -1).to(torch.int32),
        collider2=torch.where(pair_valid, s2, -1).to(torch.int32),
        active_events_or=(T1["events"] | T2["events"]).to(torch.int32),
        active_hooks_or=(T1["hooks"] | T2["hooks"]).to(torch.int32),
        force_threshold=torch.minimum(T1["thr"], T2["thr"]),
        dyn1=dyn1, dyn2=dyn2,
        body1=b1.to(torch.int32), body2=b2.to(torch.int32),
        pair_key=torch.where(pair_valid, s1 * n_coll + s2, -1).to(torch.int32),
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
