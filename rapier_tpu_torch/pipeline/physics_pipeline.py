"""The PhysicsPipeline step over a batch of scenes (counterpart of
rapier_tpu.pipeline.physics_pipeline.step).

`step(state, params)` takes a `SceneState` whose every leaf has a leading
scene axis ``[B, ...]`` and advances all B scenes by ``params.dt``: multibody
forward dynamics (phase A), kinematic velocities, AABBs with margins, the
broad phase (all pairs, SAP or the grid), the narrow phase (with the mesh
narrow phase's per-triangle lanes after the pair lanes), the warmstart
join against the contact cache, the contact filter of impulse joints and
link-parent pairs, started/stopped events, wake propagation over contacts
and joints, the link mobility install (phase B), the joint and contact
solve, writeback, the multibody impulse absorption with joint integration
(phase C), CCD motion clamping (`dynamics/ccd.py`, when params.enable_ccd),
sleeping, and the new contact cache with `StepEvents`.

The contact solve takes the reference's path for the scene (`solve_path`,
physics_pipeline.py:554-562, :664-667): the contact-sweep kernel (the
reference's Pallas kernel; a CUDA kernel on the card) where its gate holds;
otherwise, above DENSE_ROUTE_ELEMS lane x body elements, the blocked solve of
large scenes, and below it the masked color sweep.  solver_backend="jax"
never takes the kernel, nor does a scene with the 2x2 block solve
(PhysicsWorld2D).  A scene with impulse joints, or with the Coulomb friction
model, takes the masked sweep at any size: the joints' colored passes run
before the contact passes.

Every convex shape of the reference is carried: the analytic pair kernels,
the generic GJK/EPA fallback (`geometry/narrowphase_convex.py`), the
halfspace kernels and the convex hulls (the `hulls` slot).  User hooks
(`pipeline/hooks.py`) apply after the narrow phase and before the warmstart
join, as the reference's do (:291-327); they do not change the solve path, so
a hooked scene takes the kernel where the gate picks it.  A float64 scene
(`precision.set_precision("f64")`) runs every phase in float64 and takes the
kernel's float64 build where a float32 scene of its shapes takes the kernel;
it rounds through float32 where the reference does (ROADMAP R31), on every
route.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rapier_tpu_torch.dynamics import multibody as mbmod
from rapier_tpu_torch.dynamics.ccd import clamp_motions
from rapier_tpu_torch.dynamics.solver import velocity_solver as vs
from rapier_tpu_torch.dynamics.solver import contact_constraints as cc
from rapier_tpu_torch.dynamics.solver import contact_constraints_coulomb as ccc
from rapier_tpu_torch.dynamics.solver import joint_constraints as jc
from rapier_tpu_torch.dynamics.solver.coloring import (
    color_constraints,
    color_constraints_blocked,
    solve_caps,
)
from rapier_tpu_torch.dynamics.solver.contact_sweep import (
    kernel_fits,
    solve_from_manifolds,
    vmem_feasible,
)
from rapier_tpu_torch.geometry import broadphase, shapes
from rapier_tpu_torch.geometry.dispatch import (
    ManifoldBatch,
    collider_world_poses,
    compute_manifolds,
    compute_mesh_manifolds,
    concat_manifolds,
    parent_body_cols,
)
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.pipeline.hooks import apply_contact_filter, apply_contact_modifier
from rapier_tpu_torch.types import (
    ACTIVE_EVENTS_COLLISION,
    ACTIVE_EVENTS_CONTACT_FORCE,
    BodyType,
    Contacts,
    FrictionModel,
    SceneState,
    SimParams,
)
from rapier_tpu_torch.utils.compaction import compact_indices, gather_lanes
from rapier_tpu_torch.utils.counters import span, stage
from rapier_tpu_torch.utils.routing import make_segment_plan, take_lanes

# Lane x body elements above which the reference routes by segment plans and
# solves large scenes blocked (rapier_tpu/utils/routing.py:33).
DENSE_ROUTE_ELEMS = 2**24


class StepEvents(NamedTuple):
    """Collision events as dense per-pair arrays, ``[B, P]`` (see the
    reference's StepEvents)."""

    started_pairs: torch.Tensor
    stopped_keys: torch.Tensor
    stopped: torch.Tensor
    force_events: torch.Tensor
    force_magnitude: torch.Tensor
    total_force: torch.Tensor          # [B, 3, P]
    max_force_direction: torch.Tensor  # [B, 3, P]
    max_force_magnitude: torch.Tensor
    sensor_pairs: torch.Tensor
    intersecting: torch.Tensor
    broadphase_overflow: torch.Tensor  # [B] int32
    unsupported_pairs: torch.Tensor    # [B] int32
    ccd_overflow: torch.Tensor         # [B] int32
    solver_overflow: torch.Tensor      # [B] int32


def _lane_gather(x, idx):
    """``x [B, R, Po]`` at ``idx [B, Pn]`` -> ``[B, R, Pn]``."""
    return torch.gather(x, -1, idx.unsqueeze(1).expand(x.shape[:-1] + idx.shape[-1:]))


def _match_previous(prev: Contacts, man: ManifoldBatch):
    """Join the new pairs against the previous step's cache by pair key (the
    reference's sort + searchsorted form; keys are unique, so it equals the
    dense join).  Returns matched warmstart impulses, previous totals (for
    is_bouncy), previous `touching`, the match mask and `still` (old pairs
    still touching).  The tangent warmstart is a manifold's pair ``[B, 2,
    P]`` (twist model), or under FrictionModel.COULOMB a pair per point
    ``[B, 4, 2, P]`` routed by the same feature match as the normal
    impulses (:105-107, :171-176).  The joined rows are float32 at either
    precision, as the reference's stacked join is (:111-120): at f64 the
    warmstart values round through float32 (ROADMAP R31), and the results
    return at the cache's dtype."""
    ft = prev.warmstart_impulse.dtype
    new_keys = torch.where(man.valid, man.pair_key, -1).contiguous()
    old_keys = torch.where(prev.pair_key >= 0, prev.pair_key, -2)
    bsz, pn, po = new_keys.shape[0], new_keys.shape[-1], old_keys.shape[-1]
    per_point = prev.warmstart_tangent_impulse.dim() == 4
    tan_rows = prev.warmstart_tangent_impulse.reshape(bsz, -1, po).float()
    nt = tan_rows.shape[1]
    stacked = torch.cat([
        prev.feature_id.float(),                       # 0:4
        prev.point_active.float(),                     # 4:8
        prev.warmstart_impulse.float(),                # 8:12
        prev.impulse.float(),                          # 12:16
        tan_rows,                                      # 16:16+nt
        prev.warmstart_twist_impulse.float().unsqueeze(1),   # 16+nt
        prev.touching.float().unsqueeze(1),            # 17+nt
    ], dim=1)

    sk, order = torch.sort(old_keys, dim=-1, stable=True)
    pos = torch.clamp(torch.searchsorted(sk.contiguous(), new_keys), 0, po - 1)
    src = torch.gather(order, -1, pos)
    hit = torch.gather(sk, -1, pos) == new_keys
    matched = hit & man.valid
    J = torch.where(hit.unsqueeze(1), _lane_gather(stacked, src), 0.0)

    tkeys, _ = torch.sort(torch.where(man.valid & man.touching, man.pair_key, -3),
                          dim=-1)
    tpos = torch.clamp(torch.searchsorted(tkeys.contiguous(), old_keys.contiguous()),
                       0, pn - 1)
    still = torch.gather(tkeys, -1, tpos) == old_keys

    # Per-point feature-id matching (4 new x 4 old), first old match per new
    # point.  Ids compare as f32, as the reference's joined rows carry them.
    old_fid = J[:, 0:4]
    old_pact = J[:, 4:8] > 0
    fmatch = (
        (man.fid.float().unsqueeze(2) == old_fid.unsqueeze(1))
        & old_pact.unsqueeze(1)
        & matched[:, None, None, :]
        & (man.fid >= 0).unsqueeze(2)
    )                                                  # [B, 4new, 4old, P]
    pre = torch.cumsum(fmatch.int(), dim=2)
    first = (fmatch & (pre == 1)).float()

    def take(rows):
        return (first * rows.unsqueeze(1)).sum(dim=2)

    ws_normal = take(J[:, 8:12])
    prev_impulse = take(J[:, 12:16])
    if per_point:
        old_tan = J[:, 16:16 + nt].reshape(bsz, 4, 2, pn)   # [B, 4old, 2, P]
        ws_tan = (first.unsqueeze(3) * old_tan.unsqueeze(1)).sum(dim=2)
    else:
        ws_tan = J[:, 16:18] * matched.float().unsqueeze(1)
    ws_twist = torch.where(matched, J[:, 16 + nt], 0.0)
    prev_touching = matched & (J[:, 17 + nt] > 0)
    return (ws_normal.to(ft), ws_tan.to(ft), ws_twist.to(ft), prev_impulse.to(ft),
            prev_touching, matched, still)


def solve_path(state: SceneState, params: SimParams) -> str:
    """Which contact solve the reference takes for this scene
    (physics_pipeline.py:554-562, :664-667), refusing first what the port
    does not carry.  Returns "kernel" (the contact-sweep kernel, the
    reference's Pallas path), "blocked" (the blocked solve, above the dense
    routing limit) or "masked" (the masked color sweep, and every scene
    with impulse joints or the Coulomb friction model).  A float64 scene
    takes the kernel's float64 build where a float32 scene of its shapes
    takes the kernel, and where that build's body tables and fixed words fit
    a block's shared memory (`kernel_fits`); the reference's gate sends
    every float64 scene to its masked or blocked solve (:557), whose result
    the kernel's computes."""
    coulomb = params.friction_model == int(FrictionModel.COULOMB)
    if coulomb != (state.contacts.warmstart_tangent_impulse.dim() == 4):
        raise ValueError("the contact cache's tangent layout does not match the friction "
                         "model (empty_contacts(per_point_tangent=...))")
    if state.joints is not None or coulomb:
        return "masked"
    n = state.bodies.body_type.shape[-1]
    p_lanes = state.contacts.max_pairs
    cap = params.max_solver_pairs
    k_lanes = cap if 0 < cap < p_lanes else p_lanes
    f64 = state.bodies.pos.dtype == torch.float64
    # "auto" takes the kernel, as the reference does on its TPU; the kernel
    # has no 2x2 block solve.
    if (params.solver_backend != "jax" and not params.block_solver_2x2
            and vmem_feasible(p_lanes, n + 1)
            and (not f64 or kernel_fits(k_lanes, n + 1, params.max_colors, f64=True))):
        return "kernel"
    return "blocked" if p_lanes * (n + 1) > DENSE_ROUTE_ELEMS else "masked"


def _fixed_point(flag, step_fn, max_iters: int):
    """Iterate flag -> step_fn(flag) until no scene changes or `max_iters`
    hops.  A converged scene is a fixed point of step_fn, so every scene
    reaches the same result as when iterated alone."""
    for _ in range(max_iters):
        nf = step_fn(flag)
        changed = bool(torch.any(nf != flag))
        flag = nf
        if not changed:
            break
    return flag


def _unsolved(man, ws_n, ws_t, ws_tw):
    """The impulse block ``[B, 14, P]`` a lane keeps when no solve sees it:
    its matched warmstart values, zero accumulators (:646-663)."""
    return torch.cat([
        ws_n * man.point_active.to(ws_n.dtype), torch.zeros_like(ws_n), ws_t,
        torch.zeros_like(ws_t), ws_tw.unsqueeze(1), torch.zeros_like(ws_tw).unsqueeze(1)],
        dim=1)


def _scatter_back(imp, src, kvalid, default):
    """Compacted impulse lanes ``[B, 14, K]`` back to their pair lanes of
    `default` ``[B, 14, P]``; invalid slots write to a dropped column."""
    p_lanes = default.shape[-1]
    tgt = torch.where(kvalid, src, p_lanes).unsqueeze(1).expand(imp.shape)
    full = torch.cat([default, torch.zeros_like(default[..., :1])], dim=-1)
    return full.scatter(-1, tgt, imp)[..., :p_lanes]


# Route elements (pair lanes x solver lanes) up to which the reference
# compacts by a float32 matmul (:811-832, :899-913).
_F32_ROUTE_ELEMS = 1 << 20


def _f32_rounding(f32_route: bool):
    """What the compaction does to a routed tensor: where the reference
    routes by its float32 matmul, a float tensor rounds through float32
    (ROADMAP R31: at f64 its lanes and the impulses routed back; at f32 a
    no-op); anything else passes as it is."""
    def rounded(x):
        return x.float().to(x.dtype) if f32_route and x.is_floating_point() else x
    return rounded


def _impulse_block(c):
    """``[B, 10 + 2T, K]``: the normal impulses and their accumulators, the T
    tangent rows of each (2, or 8 under the Coulomb model), the twist impulse
    and its accumulator (zero under the Coulomb model, which has none)."""
    bsz, k = c.valid.shape
    if isinstance(c, ccc.CoulombConstraints):
        twist = torch.zeros_like(c.impulse[:, :2])
    else:
        twist = torch.stack([c.twist_impulse, c.twist_impulse_acc], dim=1)
    return torch.cat([c.impulse, c.impulse_acc, c.tan_impulse.reshape(bsz, -1, k),
                      c.tan_impulse_acc.reshape(bsz, -1, k), twist], dim=1)


def _solve_kernel(bodies, sb, active, params, *, man, dyn1, dyn2, prev_imp, ws_n,
                  ws_t, ws_tw):
    """The contact-sweep kernel's path (physics_pipeline.py:568-663): the
    touching lanes compacted to max_solver_pairs, Luby colors, the kernel.
    At float64 the compaction rounds the routed floats and the impulses
    routed back through float32 where `_solve_masked` does, and the kernel
    takes the constraints' float32 `cfm_factor` (ROADMAP R31; each a no-op
    at float32).  Returns (sb, impulse block ``[B, 14, P]``, solver_overflow
    ``[B]``, None: no joint rows)."""
    n = bodies.body_type.shape[-1]
    sent = n
    si = vs.substep_inputs(bodies, sb, active, params)
    p_lanes = man.body1.shape[-1]
    b1s = torch.where((man.body1 >= 0) & (man.rel_dominance <= 0), man.body1, sent)
    b2s = torch.where((man.body2 >= 0) & (man.rel_dominance >= 0), man.body2, sent)
    lanes = dict(
        valid=man.solver_pair, dyn1=dyn1, dyn2=dyn2, normal=man.normal,
        point=man.point, point_active=man.point_active, dist=man.dist,
        friction=man.friction, restitution=man.restitution,
        prev_impulse=prev_imp, ws_n=ws_n * man.point_active.to(ws_n.dtype),
        ws_t=ws_t, ws_tw=ws_tw)
    cap = params.max_solver_pairs
    compact = 0 < cap < p_lanes
    rounded = _f32_rounding(compact and p_lanes * cap <= _F32_ROUTE_ELEMS)
    with span("compaction"):
        if compact:
            # Stream-compact the touching lanes: the solve then works K =
            # cap lanes.  Overflowing lanes are dropped for this step and
            # counted.
            src, kvalid, solver_overflow = compact_indices(man.solver_pair, cap)
            lanes = {k: rounded(gather_lanes(v, src, kvalid)) for k, v in lanes.items()}
            lanes["valid"] = kvalid
            b1s = gather_lanes(b1s, src, kvalid, fill=sent)
            b2s = gather_lanes(b2s, src, kvalid, fill=sent)
        else:
            solver_overflow = torch.zeros_like(man.unsupported)

    with span("coloring"):
        color, num_colors = color_constraints(
            b1s, b2s, lanes["dyn1"], lanes["dyn2"], lanes["valid"], n, params.max_colors)
    with span("sweep"):
        sb, imp = solve_from_manifolds(
            sb, b1=b1s, b2=b2s, color=color, num_colors=num_colors,
            dv_inc=si["dv_inc"], dw_inc=si["dw_inc"], move_mask=si["move_mask"],
            dt_sub=si["dt_sub"], inv_dt_sub=si["inv_dt_sub"],
            erp_inv_dt=si["erp_inv_dt"], cfm_factor=float(np.float32(si["cfm_factor"])),
            allowed_lin_err=float(params.allowed_linear_error()),
            max_corrective_velocity=float(params.max_corrective_velocity()),
            warmstart_coeff=float(params.warmstart_coefficient),
            n_sub=si["n_sub"], pgs_iters=params.num_internal_pgs_iterations,
            stab_iters=params.num_internal_stabilization_iterations,
            max_colors=params.max_colors, **lanes)
    if compact:
        imp = _scatter_back(rounded(imp), src, kvalid, _unsolved(man, ws_n, ws_t, ws_tw))
    return sb, imp, solver_overflow, None


def _solve_blocked(bodies, sb, active, params, *, man, dyn1, dyn2, prev_imp, ws_n,
                   ws_t, ws_tw):
    """The blocked solve of large scenes (physics_pipeline.py:664-797): the
    capped Luby coloring lays the touching lanes out in contiguous per-color
    blocks, and each Gauss-Seidel pass runs one block.  The Jacobi tail block
    holds every lane the Luby rounds leave (`solve_caps`; the reference drops
    those past its cap, ROADMAP R7).  Returns (sb, impulse block
    ``[B, 14, P]``, solver_overflow ``[B]``: lanes that got no slot, None:
    no joint rows)."""
    n = bodies.body_type.shape[-1]
    sent = n
    p_lanes = man.body1.shape[-1]
    cap = params.max_solver_pairs
    caps = solve_caps(cap if 0 < cap < p_lanes else p_lanes, p_lanes, params.max_colors)
    starts = [sum(caps[:i]) for i in range(len(caps))]
    w_total = sum(caps)
    with span("coloring"):
        _, slot, solver_overflow = color_constraints_blocked(
            man.body1, man.body2, dyn1, dyn2, man.solver_pair, n, caps)

    # Slot -> pair lane: slots are unique; unslotted lanes all write the
    # cut-off column w_total.
    lane_ids = torch.arange(p_lanes, device=slot.device).expand(slot.shape)
    blk_src = torch.full((slot.shape[0], w_total + 1), p_lanes, dtype=torch.int64,
                         device=slot.device)
    blk_src = blk_src.scatter(1, torch.clamp(slot, max=w_total).long(),
                              lane_ids)[:, :w_total]
    slot_valid = blk_src < p_lanes
    srcc = torch.clamp(blk_src, max=p_lanes - 1)

    def rt(x, neutral=0):
        return gather_lanes(x, srcc, slot_valid, fill=neutral)

    bb1, bb2, rdom = rt(man.body1, -1), rt(man.body2, -1), rt(man.rel_dominance)
    b1s = torch.where((bb1 >= 0) & (rdom <= 0), bb1, sent)
    b2s = torch.where((bb2 >= 0) & (rdom >= 0), bb2, sent)

    # One warmstart plan over all slots; per block an inverse gather (each
    # body meets at most one lane-endpoint of a conflict-free block), and
    # for the Jacobi tail block a segment sum.
    route = cc.RoutePlan(seg_pair=make_segment_plan(torch.cat([b1s, b2s], dim=-1), n + 1))
    blocks = []
    for ci, (s0, width) in enumerate(zip(starts, caps)):
        segp = make_segment_plan(
            torch.cat([b1s[:, s0:s0 + width], b2s[:, s0:s0 + width]], dim=-1), n + 1)
        if ci < len(caps) - 1:
            first = torch.gather(segp.perm, 1, torch.clamp(segp.starts, max=2 * width - 1))
            inv = torch.where(segp.ends > segp.starts, first, 2 * width)
            blocks.append((ci, s0, width, cc.RoutePlan(inv_pair=inv)))
        else:
            blocks.append((ci, s0, width, cc.RoutePlan(seg_pair=segp)))
    color_of_slot = torch.repeat_interleave(
        torch.arange(len(caps), device=slot.device), torch.tensor(caps, device=slot.device),
        output_size=w_total).expand(slot.shape[0], w_total)

    pact_b = rt(man.point_active, False)
    cons = cc.generate_from(
        b1s, b2s, rt(man.solver_pair, False), color_of_slot, rt(man.normal),
        rt(man.point), pact_b, rt(man.dist, 1e10), rt(man.friction),
        rt(man.restitution), sb, rt(prev_imp))
    cons = cons._replace(impulse=rt(ws_n) * pact_b.to(ws_n.dtype), tan_impulse=rt(ws_t),
                         twist_impulse=rt(ws_tw))
    with span("color_passes"):
        sb, cons = vs.solve_blocked(bodies, sb, cons, blocks, route, active, params)

    # Back to the pair lanes; lanes without a slot keep their warmstart.
    has_slot = (slot < w_total).unsqueeze(1)
    imp = take_lanes(_impulse_block(cons), torch.clamp(slot, max=w_total - 1).long())
    imp = torch.where(has_slot, imp, _unsolved(man, ws_n, ws_t, ws_tw))
    return sb, imp, solver_overflow, None


def _solve_masked(bodies, sb, active, params, *, man, dyn1, dyn2, prev_imp, ws_n,
                  ws_t, ws_tw, joints=None):
    """The masked sweep (physics_pipeline.py:798-936): the touching lanes
    compacted to max_solver_pairs (not under the Coulomb model, :804), Luby
    colors, the friction model's constraints (:861-872), and one masked
    pass over every lane per color, after the passes of the joint colors
    where `joints` (a `velocity_solver.JointSolve`) is given.  Returns (sb,
    impulse block (`_impulse_block`) over the P lanes, solver_overflow
    ``[B]``, the last substep's joint rows or None)."""
    n = bodies.body_type.shape[-1]
    p_lanes = man.body1.shape[-1]
    cap = params.max_solver_pairs
    coulomb = params.friction_model == int(FrictionModel.COULOMB)
    compact = not coulomb and 0 < cap < p_lanes
    fields = ("body1", "body2", "rel_dominance", "solver_pair", "normal", "point",
              "point_active", "dist", "friction", "restitution")
    rounded = _f32_rounding(compact and p_lanes * cap <= _F32_ROUTE_ELEMS)

    with span("compaction"):
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
            prev_imp_s, ws_n_s, ws_t_s, ws_tw_s = (take(x)
                                                   for x in (prev_imp, ws_n, ws_t, ws_tw))
        else:
            solver_overflow = torch.zeros_like(man.unsupported)
            man_s, dyn1_s, dyn2_s = man, dyn1, dyn2
            prev_imp_s, ws_n_s, ws_t_s, ws_tw_s = prev_imp, ws_n, ws_t, ws_tw

    with span("coloring"):
        color, num_colors = color_constraints(
            man_s.body1, man_s.body2, dyn1_s, dyn2_s, man_s.solver_pair, n, params.max_colors)
    with span("constraints"):
        if coulomb:
            cc_mod = ccc
            cons = ccc.generate(man_s, sb, prev_imp_s, color, n)
            pmask = cons.point_mask.to(ws_n_s.dtype)
            cons = cons._replace(impulse=ws_n_s * pmask,
                                 tan_impulse=ws_t_s * pmask.unsqueeze(2))
        else:
            cc_mod = cc
            cons = cc.generate(man_s, sb, prev_imp_s, color, n)
            cons = cons._replace(impulse=ws_n_s * cons.point_mask.to(ws_n_s.dtype),
                                 tan_impulse=ws_t_s, twist_impulse=ws_tw_s)
        route = cc.RoutePlan(seg_pair=make_segment_plan(torch.cat([cons.b1, cons.b2], dim=-1),
                                                        n + 1))
    with span("color_passes"):
        sb, cons, rows = vs.solve(bodies, sb, cons, num_colors, active, params, route,
                                  joints, cc_mod)
    imp = _impulse_block(cons)
    if compact:
        imp = _scatter_back(rounded(imp), src, kvalid, _unsolved(man, ws_n, ws_t, ws_tw))
    return sb, imp, solver_overflow, rows


def step(state: SceneState, params: SimParams, hooks=None):
    """Advance every scene of the batch by params.dt.  Returns
    (new_state, StepEvents).  `hooks`: an optional
    `pipeline.hooks.PhysicsHooks`.  Under `counters.recording()` the step
    is one span, its stages the spans under it."""
    with span("step", new_step=True):
        return _step(state, params, hooks)


def _step(state: SceneState, params: SimParams, hooks):
    path = solve_path(state, params)
    bodies = state.bodies
    colliders = state.colliders
    bsz, n = bodies.body_type.shape
    dev = bodies.pos.device
    dt = float(params.dt)
    inv_dt = float(params.inv_dt())

    with span("prologue"):
        # 0. Multibody phase A (physics_pipeline.py:206-213): forward
        #    dynamics -> tentative qd; the tentative link velocities J qd land
        #    in the bodies.  Joint integration and FK follow the contact solve
        #    (phase C).
        multibodies = state.multibodies
        mb_aux = None
        if multibodies is not None:
            multibodies, bodies, mb_aux = mbmod.predict_velocities(
                multibodies, bodies, params.gravity, dt)

        # 1. Kinematic velocity interpolation (physics_pipeline.rs:412-438);
        #    multibody links take their velocities from phase A.
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

    # 2. Broad phase, AABBs with margins (physics_pipeline.py:244-260).
    with stage("broad_phase"):
        w_pos, w_rot = collider_world_poses(bodies, colliders)
        mins, maxs = shapes.compute_aabbs(
            colliders.shape_type, colliders.shape_params, w_pos, w_rot)
        _, _, _, soft_pred, linvel_c = parent_body_cols(bodies, colliders.parent)
        soft_margin = torch.minimum(torch.linalg.norm(linvel_c, dim=-1) * dt, soft_pred)
        margin = (colliders.contact_skin
                  + float(params.real(0.5) * params.prediction_distance())
                  + float(params.real(0.01) * params.real(params.length_unit))
                  + soft_margin).unsqueeze(-1)
        mins = mins - margin
        maxs = maxs + margin
        # The mesh narrow phase's sub-lanes take the last max_mesh_pairs x
        # tris_per_pair lanes of the pair buffer (:261-265).
        mesh_lanes = (params.max_mesh_pairs * params.tris_per_pair
                      if state.meshes is not None else 0)
        convex_pairs = state.contacts.max_pairs - mesh_lanes
        if convex_pairs <= 0:
            raise ValueError(f"max_pairs {state.contacts.max_pairs} leaves no lane beside "
                             f"the {mesh_lanes} mesh lanes")
        bp_body_type = torch.where(bodies.mb_link, int(BodyType.DYNAMIC), bodies.body_type)
        c1, c2, pair_valid, bp_overflow = broadphase.find_pairs(
            mins, maxs, colliders, bp_body_type, convex_pairs,
            params.broad_phase, params.sap_window)

    # 3. Narrow phase: the convex pairs, then the (convex, mesh) pairs'
    #    per-triangle lanes (:277-289).
    prediction = float(params.prediction_distance())
    with stage("narrow_phase"):
        man = compute_manifolds(
            bodies, colliders, c1, c2, pair_valid, prediction,
            present=params.shape_types_present, hulls=state.hulls, dt=params.dt)
    if state.meshes is not None:
        with stage("mesh_narrow_phase"):
            man = concat_manifolds(man, compute_mesh_manifolds(
                bodies, colliders, state.meshes, c1, c2, pair_valid, prediction,
                params.max_mesh_pairs, params.tris_per_pair,
                present=params.shape_types_present))

    # User hooks on the pairs whose colliders flag them (either collider):
    # the filter drops pairs from the solve, the modifier rewrites their
    # solver payload (physics_pipeline.py:291-327).
    if hooks is not None:
        with span("hooks"):
            man = apply_contact_filter(hooks, bodies, colliders, man)
            man = apply_contact_modifier(hooks, bodies, colliders, man)

    # 4. Warmstart matching + events bookkeeping.
    with stage("contact_match"):
        ws_n, ws_t, ws_tw, prev_imp, prev_touch, _matched, still = _match_previous(
            state.contacts, man)
        started = man.touching & ~prev_touch

        # Pairs of bodies joined by an impulse joint, or of a link and its
        # parent, with contacts disabled leave the solve
        # (physics_pipeline.py:337-369): one table of pair keys.
        joints = state.joints
        imax = torch.iinfo(torch.int32).max
        jkeys = []
        if joints is not None:
            jb1 = torch.minimum(joints.body1, joints.body2)
            jb2 = torch.maximum(joints.body1, joints.body2)
            no_c = joints.enabled & ~joints.contacts_enabled & (jb1 >= 0)
            jkeys.append(torch.where(no_c, jb1 * n + jb2, imax))
        if multibodies is not None:
            lb = multibodies.link_body                            # [B, M, L]
            lp = torch.clamp(multibodies.link_parent, 0, multibodies.l - 1).long()
            pb = torch.gather(lb, -1, lp)
            no_c = (multibodies.link_valid & ~multibodies.contacts_enabled
                    & (multibodies.link_parent >= 0) & (lb >= 0) & (pb >= 0) & (pb != lb))
            jkeys.append(torch.where(no_c, torch.minimum(lb, pb) * n + torch.maximum(lb, pb),
                                     imax).reshape(bsz, -1))
        if jkeys:
            jkeys = torch.cat(jkeys, dim=-1)
            mb1 = torch.minimum(man.body1, man.body2)
            mb2 = torch.maximum(man.body1, man.body2)
            mkey = torch.where(mb1 >= 0, mb1 * n + mb2, -1)
            blocked = torch.any(mkey.unsqueeze(-1) == jkeys.unsqueeze(-2), dim=-1)
            man = man._replace(solver_pair=man.solver_pair & ~blocked)
        prev_c = state.contacts
        stopped = prev_c.touching & ~still & (prev_c.pair_key >= 0)

    # 5. Wake-up on contact start + awake propagation over the
    #    dynamic-dynamic graph of touching pairs and enabled joints
    #    (physics_pipeline.py:380-499).
    with stage("wake"):
        dyn = bodies.body_type == BodyType.DYNAMIC
        sent = n

        def is_dyn(b):
            """Dynamic body at each id ``[B, K]`` (False for padding, -1)."""
            return (b >= 0) & torch.gather(dyn, 1, b.clamp(min=0).long())

        eb1, eb2 = man.body1, man.body2
        emask = man.touching & (eb1 >= 0) & (eb2 >= 0)
        edyn = man.dyn1 & man.dyn2
        if joints is not None:
            eb1 = torch.cat([eb1, joints.body1], dim=-1)
            eb2 = torch.cat([eb2, joints.body2], dim=-1)
            emask = torch.cat([emask, joints.enabled & (joints.body1 >= 0)
                               & (joints.body2 >= 0)], dim=-1)
            edyn = torch.cat([edyn, is_dyn(joints.body1) & is_dyn(joints.body2)], dim=-1)
        edge_dd = emask & edyn
        t1 = torch.where(edge_dd, eb1, sent).long()
        t2 = torch.where(edge_dd, eb2, sent).long()
        # Large scenes (:409-426, :454-466): the touching edges, and the lanes
        # that start touching, are compacted to max_solver_pairs before they
        # propagate; edges beyond the cap are dropped for this step, as in the
        # reference.
        e_lanes = t1.shape[-1]
        cap_e = params.max_solver_pairs
        dense = e_lanes * (n + 1) <= DENSE_ROUTE_ELEMS and n * n <= DENSE_ROUTE_ELEMS
        compact_edges = 0 < cap_e < e_lanes and not dense
        compact_started = compact_edges and not (
            cap_e * (n + 1) <= DENSE_ROUTE_ELEMS and n * n <= DENSE_ROUTE_ELEMS)
        if compact_edges:
            esrc, evalid, _ = compact_indices(edge_dd, cap_e)
            t1 = gather_lanes(t1, esrc, evalid, fill=sent)
            t2 = gather_lanes(t2, esrc, evalid, fill=sent)
        zero_n1 = torch.zeros((bsz, n + 1), dtype=torch.int32, device=dev)

        def neighbor_or(flag):
            """OR of `flag` over each body's graph neighbours."""
            ext = torch.cat([flag, torch.zeros_like(flag[:, :1])], dim=1).int()
            a = zero_n1.scatter_reduce(1, t1, torch.gather(ext, 1, t2), "amax")
            a = a.scatter_reduce(1, t2, torch.gather(ext, 1, t1), "amax")
            return a[:, :n] > 0

        def scatter_started(mask):
            s1 = torch.where(mask & (man.body1 >= 0), man.body1, sent).long()
            s2 = torch.where(mask & (man.body2 >= 0), man.body2, sent).long()
            if compact_started:
                ssrc, mask, _ = compact_indices(mask, cap_e)
                s1 = gather_lanes(s1, ssrc, mask, fill=sent)
                s2 = gather_lanes(s2, ssrc, mask, fill=sent)
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

    # 6. Solve.
    with span("solver_bodies"):
        active = bodies.enabled & ~sleeping
        sb = vs.make_solver_bodies(bodies, active, params)
        if multibodies is not None:
            # Phase B (physics_pipeline.py:506-511): link columns take their
            # articulated mobility.
            sb = mbmod.install_link_mobility(sb, multibodies, mb_aux, bodies)
        slp_ext = torch.cat([sleeping, torch.zeros_like(sleeping[:, :1])], dim=1)

        def asleep(b):
            return (b >= 0) & torch.gather(slp_ext, 1, torch.where(b >= 0, b, sent).long())

        asleep1, asleep2 = asleep(man.body1), asleep(man.body2)
        solver_pair = man.solver_pair & ~asleep1 & ~asleep2
        man = man._replace(solver_pair=solver_pair)
        dyn1 = man.dyn1 & ~asleep1
        dyn2 = man.dyn2 & ~asleep2

    lanes = dict(man=man, dyn1=dyn1, dyn2=dyn2, prev_imp=prev_imp, ws_n=ws_n, ws_t=ws_t,
                 ws_tw=ws_tw)
    solve = {"kernel": _solve_kernel, "blocked": _solve_blocked,
             "masked": _solve_masked}[path]
    with stage("solve"):
        if joints is not None:
            # Joint colors over the dynamic bodies (:881-890); the scene's
            # sleeping bodies do not change them.
            with span("joint_coloring"):
                jcolor, n_jcolors = color_constraints(
                    joints.body1, joints.body2, is_dyn(joints.body1), is_dyn(joints.body2),
                    joints.enabled & (joints.body1 >= 0), n, params.max_colors)
                lanes["joints"] = vs.JointSolve(joints, jcolor, int(n_jcolors.max()))
        sb, imp, solver_overflow, joint_rows = solve(bodies, sb, active, params, **lanes)
    # The writeback, phase C, CCD and the pose advance: one span, CCD's
    # stage under it.
    with span("writeback"):
        if joint_rows is not None:
            # The last substep's impulses (:897-898).
            joints = dataclasses.replace(
                joints, impulses=jc.full_slots(joint_rows.impulse, joint_rows.slots))
        bodies = vs.writeback(bodies, sb, active, params)
        if multibodies is not None:
            # Phase C (physics_pipeline.py:939-946): link velocity deltas
            # into generalized space, joint integration, FK, the links' next
            # poses.
            multibodies, bodies = mbmod.absorb_contact_impulses(
                multibodies, bodies, sb, mb_aux, dt)

        # 7. CCD motion clamping (physics_pipeline.py:949-958), then advance
        #    to the final positions.
        ccd_overflow = torch.zeros((bsz,), dtype=torch.int32, device=dev)
        if params.enable_ccd:
            with stage("ccd"):
                bodies, ccd_overflow = clamp_motions(bodies, colliders, params, state.meshes)
        bodies = dataclasses.replace(bodies, pos=bodies.next_pos,
                                     rot=quat.normalize(bodies.next_rot))

    # 8. Sleeping (post-solve velocities, island-free propagation).
    with stage("sleep"):
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
            new_sleeping = (dyn & eligible & elig)
            ns = new_sleeping.unsqueeze(-1)
            bodies = dataclasses.replace(
                bodies, sleeping=new_sleeping, sleep_timer=timer,
                linvel=torch.where(ns, 0.0, bodies.linvel),
                angvel=torch.where(ns, 0.0, bodies.angvel))

    with span("contact_cache"):
        # 9. Persist the contact cache; events.  The tangent rows keep the
        #    cache's layout: a pair a manifold, or (Coulomb) a pair a point.
        tan_shape = state.contacts.warmstart_tangent_impulse.shape
        nt = (imp.shape[1] - 10) // 2
        impulse, impulse_acc = imp[:, 0:4], imp[:, 4:8]
        tan_impulse = imp[:, 8:8 + nt].reshape(tan_shape)
        tan_impulse_acc = imp[:, 8 + nt:8 + 2 * nt].reshape(tan_shape)
        total_normal = impulse_acc + impulse
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
            warmstart_tangent_impulse=tan_impulse,
            warmstart_twist_impulse=imp[:, 8 + 2 * nt],
            impulse=total_normal * pmask,
            tangent_impulse=tan_impulse_acc + tan_impulse,
            friction=man.friction, restitution=man.restitution,
            events_or=man.active_events_or,
        )
        force_mag = torch.sum(total_normal * pmask, dim=1) * inv_dt
        collision_gate = (man.active_events_or & ACTIVE_EVENTS_COLLISION) != 0
        force_gate = (man.active_events_or & ACTIVE_EVENTS_CONTACT_FORCE) != 0
        new_state = SceneState(bodies=bodies, colliders=colliders, contacts=contacts,
                               step_count=state.step_count + 1, multibodies=multibodies,
                               joints=joints, meshes=state.meshes, hulls=state.hulls)
        events = StepEvents(
            started_pairs=started & collision_gate,
            stopped_keys=prev_c.pair_key,
            stopped=stopped & ((prev_c.events_or & ACTIVE_EVENTS_COLLISION) != 0),
            force_events=man.touching & (force_mag > man.force_threshold) & force_gate,
            force_magnitude=force_mag,
            total_force=man.normal * force_mag.unsqueeze(1),
            max_force_direction=man.normal,
            max_force_magnitude=force_mag,
            sensor_pairs=man.sensor,
            intersecting=man.sensor & man.touching,
            broadphase_overflow=bp_overflow,
            unsupported_pairs=man.unsupported,
            ccd_overflow=ccd_overflow,
            solver_overflow=solver_overflow,
        )
    return new_state, events
