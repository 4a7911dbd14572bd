# Cut-down copy of rapier_tpu_torch/pipeline/physics_pipeline.py at commit
# 4adbf044245c: the contacts-only step (no multibodies, impulse joints, hooks,
# meshes or CCD) on the masked color sweep, the plain form of every contact
# solve the port takes (its contact-sweep kernel included).  Do not edit: it
# is the benchmark's yardstick.
"""One physics step of a batch of contact scenes, in plain PyTorch.

`step(state, params)` advances every scene of a `[B, ...]` `SceneState` (this
package's types) by params.dt: collider poses and fattened AABBs, the
all-pairs broad phase, the narrow phase (the analytic pair kernels, box-box
clipping, GJK/EPA for the other convex pairs), the warmstart join against the
contact cache, wake propagation, the masked Luby-colored TGS-soft sweep with
the twist friction model, writeback and integration, sleeping, and the new
contact cache.  Returns (new_state, StepEvents)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import broadphase, quat, shapes
from . import contact_constraints as cc
from . import velocity_solver as vs
from .coloring import color_constraints
from .compaction import compact_indices, gather_lanes
from .dispatch import collider_world_poses, compute_manifolds, parent_body_cols
from .routing import make_segment_plan
from .types import BodyType, Contacts, FrictionModel, SceneState, SimParams


class StepEvents(NamedTuple):
    broadphase_overflow: torch.Tensor  # [B] int32
    unsupported_pairs: torch.Tensor    # [B] int32
    solver_overflow: torch.Tensor      # [B] int32


def _lane_gather(x, idx):
    return torch.gather(x, -1, idx.unsqueeze(1).expand(x.shape[:-1] + idx.shape[-1:]))


def _match_previous(prev: Contacts, man):
    """Join the new pairs against the previous cache by pair key (sort and
    searchsorted), then per point by feature id; float32 rows at either
    precision."""
    ft = prev.warmstart_impulse.dtype
    new_keys = torch.where(man.valid, man.pair_key, -1).contiguous()
    old_keys = torch.where(prev.pair_key >= 0, prev.pair_key, -2)
    pn, po = new_keys.shape[-1], old_keys.shape[-1]
    tan_rows = prev.warmstart_tangent_impulse.float()
    stacked = torch.cat([
        prev.feature_id.float(),                       # 0:4
        prev.point_active.float(),                     # 4:8
        prev.warmstart_impulse.float(),                # 8:12
        prev.impulse.float(),                          # 12:16
        tan_rows,                                      # 16:18
        prev.warmstart_twist_impulse.float().unsqueeze(1),   # 18
        prev.touching.float().unsqueeze(1),            # 19
    ], dim=1)
    sk, order = torch.sort(old_keys, dim=-1, stable=True)
    pos = torch.clamp(torch.searchsorted(sk.contiguous(), new_keys), 0, po - 1)
    src = torch.gather(order, -1, pos)
    hit = torch.gather(sk, -1, pos) == new_keys
    matched = hit & man.valid
    J = torch.where(hit.unsqueeze(1), _lane_gather(stacked, src), 0.0)

    tkeys, _ = torch.sort(torch.where(man.valid & man.touching, man.pair_key, -3), dim=-1)
    tpos = torch.clamp(torch.searchsorted(tkeys.contiguous(), old_keys.contiguous()),
                       0, pn - 1)
    still = torch.gather(tkeys, -1, tpos) == old_keys

    old_fid = J[:, 0:4]
    old_pact = J[:, 4:8] > 0
    fmatch = ((man.fid.float().unsqueeze(2) == old_fid.unsqueeze(1))
              & old_pact.unsqueeze(1) & matched[:, None, None, :]
              & (man.fid >= 0).unsqueeze(2))
    pre = torch.cumsum(fmatch.int(), dim=2)
    first = (fmatch & (pre == 1)).float()

    def take(rows):
        return (first * rows.unsqueeze(1)).sum(dim=2)

    ws_normal = take(J[:, 8:12])
    prev_impulse = take(J[:, 12:16])
    ws_tan = J[:, 16:18] * matched.float().unsqueeze(1)
    ws_twist = torch.where(matched, J[:, 18], 0.0)
    prev_touching = matched & (J[:, 19] > 0)
    return (ws_normal.to(ft), ws_tan.to(ft), ws_twist.to(ft), prev_impulse.to(ft),
            prev_touching, matched, still)


def _fixed_point(flag, step_fn, max_iters: int):
    for _ in range(max_iters):
        nf = step_fn(flag)
        changed = bool(torch.any(nf != flag))
        flag = nf
        if not changed:
            break
    return flag


def _unsolved(man, ws_n, ws_t, ws_tw):
    return torch.cat([
        ws_n * man.point_active.to(ws_n.dtype), torch.zeros_like(ws_n), ws_t,
        torch.zeros_like(ws_t), ws_tw.unsqueeze(1), torch.zeros_like(ws_tw).unsqueeze(1)],
        dim=1)


def _scatter_back(imp, src, kvalid, default):
    p_lanes = default.shape[-1]
    tgt = torch.where(kvalid, src, p_lanes).unsqueeze(1).expand(imp.shape)
    full = torch.cat([default, torch.zeros_like(default[..., :1])], dim=-1)
    return full.scatter(-1, tgt, imp)[..., :p_lanes]


def _impulse_block(c):
    bsz, k = c.valid.shape
    twist = torch.stack([c.twist_impulse, c.twist_impulse_acc], dim=1)
    return torch.cat([c.impulse, c.impulse_acc, c.tan_impulse.reshape(bsz, -1, k),
                      c.tan_impulse_acc.reshape(bsz, -1, k), twist], dim=1)


def _solve_masked(bodies, sb, active, params, *, man, dyn1, dyn2, prev_imp, ws_n,
                  ws_t, ws_tw):
    """Touching lanes compacted to max_solver_pairs, Luby colors, the twist
    model's constraints, one masked pass over every lane a color."""
    n = bodies.body_type.shape[-1]
    p_lanes = man.body1.shape[-1]
    cap = params.max_solver_pairs
    compact = 0 < cap < p_lanes
    fields = ("body1", "body2", "rel_dominance", "solver_pair", "normal", "point",
              "point_active", "dist", "friction", "restitution")
    f32_route = compact and p_lanes * cap <= 1 << 20

    def rounded(x):
        return x.float().to(x.dtype) if f32_route and x.is_floating_point() else x

    if compact:
        src, kvalid, solver_overflow = compact_indices(man.solver_pair, cap)

        def take(x):
            return rounded(gather_lanes(x, src, kvalid))

        man_s = man._replace(**{f: take(getattr(man, f)) for f in fields})
        man_s = man_s._replace(
            body1=torch.where(kvalid, man_s.body1, -1),
            body2=torch.where(kvalid, man_s.body2, -1),
            solver_pair=kvalid,
            point_active=man_s.point_active & kvalid.unsqueeze(1))
        dyn1_s, dyn2_s = take(dyn1) & kvalid, take(dyn2) & kvalid
        prev_imp_s, ws_n_s, ws_t_s, ws_tw_s = (take(x) for x in (prev_imp, ws_n, ws_t, ws_tw))
    else:
        solver_overflow = torch.zeros_like(man.unsupported)
        man_s, dyn1_s, dyn2_s = man, dyn1, dyn2
        prev_imp_s, ws_n_s, ws_t_s, ws_tw_s = prev_imp, ws_n, ws_t, ws_tw

    color, num_colors = color_constraints(
        man_s.body1, man_s.body2, dyn1_s, dyn2_s, man_s.solver_pair, n, params.max_colors)
    cons = cc.generate(man_s, sb, prev_imp_s, color, n)
    cons = cons._replace(impulse=ws_n_s * cons.point_mask.to(ws_n_s.dtype), tan_impulse=ws_t_s,
                         twist_impulse=ws_tw_s)
    route = cc.RoutePlan(seg_pair=make_segment_plan(torch.cat([cons.b1, cons.b2], dim=-1),
                                                    n + 1))
    sb, cons, _ = vs.solve(bodies, sb, cons, num_colors, active, params, route, None, cc)
    imp = _impulse_block(cons)
    if compact:
        imp = _scatter_back(rounded(imp), src, kvalid, _unsolved(man, ws_n, ws_t, ws_tw))
    return sb, imp, solver_overflow


def step(state: SceneState, params: SimParams):
    """Advance every scene of the batch by params.dt; (new_state, StepEvents)."""
    if (state.joints is not None or state.meshes is not None
            or params.friction_model == int(FrictionModel.COULOMB) or params.enable_ccd):
        raise ValueError("the reference step covers contact scenes of convex shapes "
                         "under the twist friction model, without CCD")
    bodies = state.bodies
    colliders = state.colliders
    bsz, n = bodies.body_type.shape
    if state.contacts.max_pairs * (n + 1) > 2**24 or n * n > 2**24:
        raise ValueError("the reference step covers scenes below the blocked solve's size")
    dt = float(params.dt)
    inv_dt = float(params.inv_dt())

    # Kinematic velocity interpolation.
    kin_pos = ((bodies.body_type == BodyType.KINEMATIC_POSITION_BASED)
               & ~bodies.mb_link).unsqueeze(-1)
    com_now = bodies.pos + quat.rotate(bodies.rot, bodies.local_com)
    com_next = bodies.next_pos + quat.rotate(bodies.next_rot, bodies.local_com)
    kin_linvel = (com_next - com_now) * inv_dt
    dq = quat.mul(bodies.next_rot, quat.conj(bodies.rot))
    dq = torch.where(dq[..., 3:4] < 0, -dq, dq)
    vnorm = torch.linalg.norm(dq[..., :3], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vnorm, dq[..., 3:4])
    kin_angvel = dq[..., :3] / torch.clamp(vnorm, min=1e-12) * (angle * inv_dt)
    bodies = dataclasses.replace(
        bodies,
        linvel=torch.where(kin_pos, kin_linvel, bodies.linvel),
        angvel=torch.where(kin_pos, kin_angvel, bodies.angvel))

    # Broad phase over AABBs with margins.
    w_pos, w_rot = collider_world_poses(bodies, colliders)
    mins, maxs = shapes.compute_aabbs(colliders.shape_type, colliders.shape_params, w_pos, w_rot)
    _, _, _, soft_pred, linvel_c = parent_body_cols(bodies, colliders.parent)
    soft_margin = torch.minimum(torch.linalg.norm(linvel_c, dim=-1) * dt, soft_pred)
    margin = (colliders.contact_skin
              + float(params.real(0.5) * params.prediction_distance())
              + float(params.real(0.01) * params.real(params.length_unit))
              + soft_margin).unsqueeze(-1)
    mins = mins - margin
    maxs = maxs + margin
    bp_body_type = torch.where(bodies.mb_link, int(BodyType.DYNAMIC), bodies.body_type)
    c1, c2, pair_valid, bp_overflow = broadphase.find_pairs(
        mins, maxs, colliders, bp_body_type, state.contacts.max_pairs,
        params.broad_phase, params.sap_window)

    # Narrow phase.
    prediction = float(params.prediction_distance())
    man = compute_manifolds(bodies, colliders, c1, c2, pair_valid, prediction,
                            present=params.shape_types_present, hulls=state.hulls, dt=params.dt)

    # Warmstart join.
    ws_n, ws_t, ws_tw, prev_imp, prev_touch, _matched, _still = _match_previous(
        state.contacts, man)
    started = man.touching & ~prev_touch

    # Wake on contact start, then awake propagation over touching pairs.
    dyn = bodies.body_type == BodyType.DYNAMIC
    sent = n
    edge_dd = man.touching & (man.body1 >= 0) & (man.body2 >= 0) & man.dyn1 & man.dyn2
    t1 = torch.where(edge_dd, man.body1, sent).long()
    t2 = torch.where(edge_dd, man.body2, sent).long()
    zero_n1 = torch.zeros((bsz, n + 1), dtype=torch.int32, device=bodies.pos.device)

    def neighbor_or(flag):
        ext = torch.cat([flag, torch.zeros_like(flag[:, :1])], dim=1).int()
        a = zero_n1.scatter_reduce(1, t1, torch.gather(ext, 1, t2), "amax")
        a = a.scatter_reduce(1, t2, torch.gather(ext, 1, t1), "amax")
        return a[:, :n] > 0

    def scatter_started(mask):
        s1 = torch.where(mask & (man.body1 >= 0), man.body1, sent).long()
        s2 = torch.where(mask & (man.body2 >= 0), man.body2, sent).long()
        m = mask.int()
        w = zero_n1.scatter_reduce(1, s1, m, "amax").scatter_reduce(1, s2, m, "amax")
        return w[:, :n] > 0

    sleeping = bodies.sleeping & dyn
    if params.sleeping_enabled:
        woke = scatter_started(started)
        awake = (dyn & ~sleeping) | (woke & dyn)
        awake = _fixed_point(awake, lambda f: f | (neighbor_or(f) & dyn),
                             params.sleep_propagation_iters)
        sleeping = dyn & ~awake
    bodies = dataclasses.replace(bodies, sleeping=sleeping)

    # Solve.
    active = bodies.enabled & ~sleeping
    sb = vs.make_solver_bodies(bodies, active, params)
    slp_ext = torch.cat([sleeping, torch.zeros_like(sleeping[:, :1])], dim=1)

    def asleep(b):
        return (b >= 0) & torch.gather(slp_ext, 1, torch.where(b >= 0, b, sent).long())

    asleep1, asleep2 = asleep(man.body1), asleep(man.body2)
    man = man._replace(solver_pair=man.solver_pair & ~asleep1 & ~asleep2)
    sb, imp, solver_overflow = _solve_masked(
        bodies, sb, active, params, man=man, dyn1=man.dyn1 & ~asleep1,
        dyn2=man.dyn2 & ~asleep2, prev_imp=prev_imp, ws_n=ws_n, ws_t=ws_t, ws_tw=ws_tw)
    bodies = vs.writeback(bodies, sb, active, params)
    bodies = dataclasses.replace(bodies, pos=bodies.next_pos,
                                 rot=quat.normalize(bodies.next_rot))

    # Sleeping.
    if params.sleeping_enabled:
        lin_sq = torch.sum(bodies.linvel ** 2, dim=-1)
        ang_sq = torch.sum(bodies.angvel ** 2, dim=-1)
        t = params.real
        lin_th = float(t(params.sleep_linear_threshold) * t(params.length_unit))
        sat = float(params.sleep_angular_threshold)
        quiet = (lin_sq < lin_th * lin_th) & (ang_sq < sat * sat)
        timer = torch.where(quiet, bodies.sleep_timer + dt, 0.0)
        eligible = dyn & bodies.can_sleep & bodies.enabled & (
            timer >= float(params.time_until_sleep))
        elig = _fixed_point(eligible | ~dyn, lambda f: f & ~neighbor_or(~f),
                            params.sleep_propagation_iters)
        new_sleeping = dyn & eligible & elig
        ns = new_sleeping.unsqueeze(-1)
        bodies = dataclasses.replace(
            bodies, sleeping=new_sleeping, sleep_timer=timer,
            linvel=torch.where(ns, 0.0, bodies.linvel),
            angvel=torch.where(ns, 0.0, bodies.angvel))

    # The new contact cache.
    impulse, impulse_acc = imp[:, 0:4], imp[:, 4:8]
    pmask = man.point_active.to(impulse.dtype)
    contacts = Contacts(
        pair_key=torch.where(man.valid, man.pair_key, -1),
        body1=man.body1, body2=man.body2,
        collider1=man.collider1, collider2=man.collider2,
        normal=man.normal, point=man.point, dist=man.dist,
        feature_id=man.fid, point_active=man.point_active,
        num_points=torch.sum(man.point_active.int(), dim=1, dtype=torch.int32),
        active=man.valid, touching=man.touching,
        warmstart_impulse=impulse,
        warmstart_tangent_impulse=imp[:, 8:10],
        warmstart_twist_impulse=imp[:, 12],
        impulse=(impulse_acc + impulse) * pmask,
        tangent_impulse=imp[:, 10:12] + imp[:, 8:10],
        friction=man.friction, restitution=man.restitution,
        events_or=man.active_events_or,
    )
    new_state = SceneState(bodies=bodies, colliders=colliders, contacts=contacts,
                           step_count=state.step_count + 1, hulls=state.hulls)
    return new_state, StepEvents(bp_overflow, man.unsupported, solver_overflow)
