"""Solver-body preparation and writeback for the TGS-soft step
(counterpart of rapier_tpu.dynamics.solver.velocity_solver).

Substep dt = dt / num_solver_iterations (island_solver.rs:50-54).  The
kernel path's substep loop lives with the contact-solve kernel
(`contact_sweep.py`); this module builds its inputs, writes its results back,
and holds the substep loops of the two non-kernel paths: `solve`, the masked
color sweep over every lane (with the impulse joints' rows, where a scene
has joints), and `solve_blocked`, one pass per static color block.  Body
arrays are ``[B, N, ...]``; solver bodies are component-leading ``[B, d,
N+1]`` with a zeroed sentinel column N.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rapier_tpu_torch.dynamics.solver import contact_constraints as cc
from rapier_tpu_torch.dynamics.solver import joint_constraints as jc
from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import (
    LOCK_ROTATION_X,
    LOCK_TRANSLATION_X,
    BodyType,
    SimParams,
    spring_cfm_factor,
    spring_erp_inv_dt,
)
from rapier_tpu_torch.utils import counters
from rapier_tpu_torch.utils.counters import stage


class JointSolve(NamedTuple):
    """The impulse joints of a step as the solve takes them."""

    joints: object             # types.Joints, ``[B, J, ...]``
    color: torch.Tensor        # [B, J] Luby colors
    n_colors: int              # the batch's largest color count


def _unlocked(bodies, first_bit):
    bits = torch.tensor([first_bit, first_bit << 1, first_bit << 2],
                        device=bodies.locked_axes.device)
    return (bodies.locked_axes.unsqueeze(-1) & bits) == 0


def effective_inv_mass(bodies, active):
    """Per-axis effective inverse mass ``[B, N, 3]``, locked translations
    and non-dynamic or inactive bodies zeroed."""
    im = bodies.inv_mass.unsqueeze(-1) * _unlocked(bodies, LOCK_TRANSLATION_X)
    dyn = (bodies.body_type == BodyType.DYNAMIC) & active
    return torch.where(dyn.unsqueeze(-1), im, 0.0)


def effective_world_inv_inertia(bodies, active):
    """World-frame effective inverse inertia ``[B, N, 3, 3]`` with locked
    rotation rows and columns zeroed."""
    m = quat.to_matrix(quat.mul(bodies.rot, bodies.principal_frame))
    md = m * bodies.inv_principal_inertia.unsqueeze(-2)
    ii = torch.stack([
        torch.stack([
            md[..., i, 0] * m[..., k, 0] + md[..., i, 1] * m[..., k, 1]
            + md[..., i, 2] * m[..., k, 2]
            for k in range(3)
        ], dim=-1)
        for i in range(3)
    ], dim=-2)
    unlocked = _unlocked(bodies, LOCK_ROTATION_X).to(ii.dtype)
    ii = ii * unlocked.unsqueeze(-1) * unlocked.unsqueeze(-2)
    dyn = (bodies.body_type == BodyType.DYNAMIC) & active
    return torch.where(dyn[..., None, None], ii, 0.0)


def gyroscopic_angvel(bodies, dt):
    """Momentum-preserving explicit gyroscopic term (rigid_body.rs:1443-1462)."""
    rot_world = quat.mul(bodies.rot, bodies.principal_frame)
    w_local = quat.inv_rotate(rot_world, bodies.angvel)
    ipi = bodies.inv_principal_inertia
    inertia = torch.where(ipi > 0, 1.0 / torch.clamp(ipi, min=1e-30), 0.0)
    momentum = inertia * w_local
    total = momentum + (-quat.cross(w_local, momentum) * dt)
    tot_sq = torch.sum(total * total, dim=-1, keepdim=True)
    cur_sq = torch.sum(momentum * momentum, dim=-1, keepdim=True)
    capped = total * torch.sqrt(cur_sq / torch.clamp(tot_sq, min=1e-30))
    new_w = quat.rotate(rot_world, ipi * capped)
    ok = ((tot_sq[..., 0] > 0.0) & bodies.gyro_enabled
          & (bodies.body_type == BodyType.DYNAMIC))
    return torch.where(ok.unsqueeze(-1), new_w, bodies.angvel)


def _is_kinematic(bodies):
    return ((bodies.body_type == BodyType.KINEMATIC_POSITION_BASED)
            | (bodies.body_type == BodyType.KINEMATIC_VELOCITY_BASED))


def _cl(x, pad_row):
    """``[B, N, d]`` + pad row -> component-leading ``[B, d, N+1]``."""
    pad = pad_row.to(x).expand(x.shape[0], 1, x.shape[-1])
    return torch.cat([x, pad], dim=1).transpose(1, 2).contiguous()


def make_solver_bodies(bodies, active, params: SimParams) -> SolverBodies:
    """The N+1 solver-body tables (SolverBodies::copy_from,
    solver_body.rs:95-128): pose at COM, gyroscopic angular velocity, im/ii
    zeroed for non-dynamic bodies."""
    bsz, n = bodies.body_type.shape
    im = effective_inv_mass(bodies, active)
    ii = effective_world_inv_inertia(bodies, active)
    com = bodies.pos + quat.rotate(bodies.rot, bodies.local_com)
    angvel = gyroscopic_angvel(bodies, float(params.dt))
    moving = (active & ((bodies.body_type == BodyType.DYNAMIC)
                        | _is_kinematic(bodies))).unsqueeze(-1)
    zero3 = torch.zeros((1, 3))
    ii_ext = torch.cat([ii, ii.new_zeros((bsz, 1, 3, 3))], dim=1)
    return SolverBodies(
        v_lin=_cl(torch.where(moving, bodies.linvel, 0.0), zero3),
        v_ang=_cl(torch.where(moving, angvel, 0.0), zero3),
        com=_cl(com, zero3),
        rot=_cl(bodies.rot, torch.tensor([[0.0, 0.0, 0.0, 1.0]])),
        im=_cl(im, zero3),
        ii=ii_ext.permute(0, 2, 3, 1).contiguous(),
    )


def velocity_increments(bodies, sb: SolverBodies, active, params, dt_sub):
    """Per-substep external velocity increments (gravity + persistent
    forces, velocity_solver.rs:115-122) as ``[B, 3, N+1]`` tables."""
    dyn = (active & (bodies.body_type == BodyType.DYNAMIC)).unsqueeze(-1)
    im = sb.im[..., :-1].transpose(1, 2)                       # [B, N, 3]
    unlocked = (im > 0).to(im.dtype)
    gravity = torch.as_tensor(np.asarray(params.gravity), dtype=im.dtype, device=im.device)
    grav = gravity * bodies.gravity_scale.unsqueeze(-1) * unlocked
    dv = (grav + bodies.force * im) * dt_sub
    iiv = sb.ii[..., :-1]                                      # [B, 3, 3, N]
    tq = bodies.torque
    dw = torch.stack([
        iiv[:, i, 0] * tq[..., 0] + iiv[:, i, 1] * tq[..., 1]
        + iiv[:, i, 2] * tq[..., 2]
        for i in range(3)
    ], dim=-1) * dt_sub
    zero3 = torch.zeros((1, 3))
    return (_cl(torch.where(dyn, dv, 0.0), zero3),
            _cl(torch.where(dyn, dw, 0.0), zero3))


def substep_inputs(bodies, sb, active, params: SimParams):
    """The substep rates, soft-constraint coefficients, per-substep
    velocity increments and the mover mask ``[B, N+1]``.  Rates are values
    of the params' own dtype (`SimParams.real`) carried as Python floats."""
    t = params.real
    n_sub = int(params.num_solver_iterations)
    dt_sub = t(params.dt / t(n_sub))
    inv_dt_sub = t(0.0) if dt_sub == 0 else t(t(1.0) / dt_sub)
    nf, dr = params.contact_natural_frequency, params.contact_damping_ratio
    dv_inc, dw_inc = velocity_increments(bodies, sb, active, params, float(dt_sub))
    move = active & ((bodies.body_type == BodyType.DYNAMIC) | _is_kinematic(bodies))
    move_mask = torch.cat(
        [move, torch.zeros_like(move[:, :1])], dim=1)
    return dict(
        n_sub=n_sub, dt_sub=float(dt_sub), inv_dt_sub=float(inv_dt_sub),
        erp_inv_dt=float(spring_erp_inv_dt(nf, dr, dt_sub)),
        cfm_factor=float(spring_cfm_factor(nf, dr, dt_sub)),
        dv_inc=dv_inc, dw_inc=dw_inc, move_mask=move_mask,
    )


def integrate_poses(sb: SolverBodies, move_mask, dt_sub) -> SolverBodies:
    """Linearised pose integration of the movers ``move_mask [B, N+1]``
    (velocity_solver.rs:213-238)."""
    move = move_mask.unsqueeze(1)
    com = sb.com + torch.where(move, sb.v_lin * dt_sub, 0.0)
    rot = torch.where(move, quat.integrate_linearized_cl(sb.rot, sb.v_ang, dt_sub),
                      sb.rot)
    return sb._replace(com=com, rot=rot)


def _substeps(bodies, sb, constraints, active, params: SimParams, route, sweep,
              joints: JointSolve = None, cc_mod=cc):
    """The TGS-soft substep loop around `sweep(constraints, sb, use_bias)`:
    external increments, the joint rows rebuilt from the current poses
    (joint_constraint_builder.rs:66-106), the soft-rhs update and warmstart
    of the friction model `cc_mod` (warmstart through `route`), the biased
    sweeps, pose integration, the bias-free sweeps; in each iteration the
    joint sweep runs before the contact sweep.  Returns (sb, constraints,
    the last substep's joint rows or None)."""
    si = substep_inputs(bodies, sb, active, params)
    n = bodies.body_type.shape[-1]
    rows = jroute = None

    def joint_sweep(rows, s, use_bias):
        with stage("joints"):
            for ci in range(joints.n_colors):
                rows, s = jc.solve_color(rows, s, ci, use_bias=use_bias, route=jroute)
        return rows, s

    for _ in range(si["n_sub"]):
        sb = sb._replace(v_lin=sb.v_lin + si["dv_inc"], v_ang=sb.v_ang + si["dw_inc"])
        if joints is not None:
            with stage("joints"):
                rows = jc.build_rows(joints.joints, sb, joints.color, si["dt_sub"],
                                     si["inv_dt_sub"], n, params.joint_slots)
                if jroute is None:
                    jroute = jc.segment_route(rows.b1, rows.b2, n)
        constraints = cc_mod.update(
            constraints, sb, cfm_factor=si["cfm_factor"], inv_dt=si["inv_dt_sub"],
            allowed_lin_err=float(params.allowed_linear_error()),
            erp_inv_dt=si["erp_inv_dt"],
            max_corrective_velocity=float(params.max_corrective_velocity()),
            warmstart_coeff=float(params.warmstart_coefficient))
        sb = cc_mod.warmstart(constraints, sb, route)
        for _ in range(params.num_internal_pgs_iterations):
            if joints is not None:
                rows, sb = joint_sweep(rows, sb, True)
            constraints, sb = sweep(constraints, sb, True)
        sb = integrate_poses(sb, si["move_mask"], si["dt_sub"])
        for _ in range(params.num_internal_stabilization_iterations):
            if joints is not None:
                rows, sb = joint_sweep(rows, sb, False)
            constraints, sb = sweep(constraints, sb, False)
    return sb, constraints, rows


def solve(bodies, sb: SolverBodies, constraints, num_colors, active,
          params: SimParams, route, joints: JointSolve = None, cc_mod=cc):
    """The masked sweep (velocity_solver.py:178-254): each pass solves one
    color over every lane, masked; with `joints`, the joint colors' passes
    precede the contact passes of every iteration.  `cc_mod` is the friction
    model's module (`contact_constraints`, or `contact_constraints_coulomb`
    for FrictionModel.COULOMB); the 2x2 block solve applies to the twist
    model only (:199-211).  Every scene sweeps the batch's largest color
    count; colors past a scene's own are empty and change nothing.  Returns
    (sb, constraints, the last substep's joint rows or None).
    Under `counters.recording()` it counts the pass lanes: `masked_useful`
    the valid lanes (each has one color, so a sweep solves each once),
    `masked_attempted` every lane of every pass, each over every sweep."""
    ncol = int(torch.max(num_colors)) if num_colors.numel() else 0
    if counters.is_recording():
        sweeps = int(params.num_solver_iterations) * (
            params.num_internal_pgs_iterations + params.num_internal_stabilization_iterations)
        counters.count("masked_useful", constraints.valid.sum() * sweeps)
        counters.count("masked_attempted", constraints.valid.numel() * ncol * sweeps)
    block = {"block_2x2": True} if params.block_solver_2x2 and cc_mod is cc else {}

    def sweep(cons, s, use_bias):
        for ci in range(ncol):
            cons, s = cc_mod.solve_color(cons, s, ci, use_bias=use_bias, route=route, **block)
        return cons, s

    return _substeps(bodies, sb, constraints, active, params, route, sweep, joints, cc_mod)


def _slice_lanes(c: cc.ContactConstraints, start: int, width: int):
    """A static lane-axis slice (a view) of every per-lane constraint field."""
    return type(c)(*(v if not isinstance(v, torch.Tensor) else v[..., start:start + width]
                     for v in c))


def solve_blocked(bodies, sb: SolverBodies, constraints, blocks, route, active,
                  params: SimParams):
    """The TGS-soft substep loop over a blocked lane layout
    (velocity_solver.py:257-322).  `blocks` lists (color id, start, width,
    RoutePlan) of contiguous static blocks covering the lanes in order; a
    pass solves one block's lanes and scatters through its plan.  `route`
    routes the warmstart over all lanes.  A 2D scene (block_solver_2x2)
    solves its passes with the 2x2 block solve, as `solve` does: the
    reference's blocked passes drop the flag (velocity_solver.py:291-293,
    ROADMAP R10), which the port does not copy.  Returns (sb,
    constraints)."""

    def sweep(cons, s, use_bias):
        parts = []
        for ci, s0, width, route_c in blocks:
            c_sl, s = cc.solve_color(_slice_lanes(cons, s0, width), s, ci,
                                     use_bias=use_bias, route=route_c,
                                     block_2x2=params.block_solver_2x2)
            parts.append(c_sl)
        # A pass reads only its own block's impulses, so the blocks' new
        # impulses join once the sweep is done.
        return cons._replace(**{
            f: torch.cat([getattr(p, f) for p in parts], dim=-1)
            for f in ("impulse", "tan_impulse", "twist_impulse")}), s

    sb, constraints, _ = _substeps(bodies, sb, constraints, active, params, route, sweep)
    return sb, constraints


def writeback(bodies, sb: SolverBodies, active, params: SimParams):
    """Write solver results back to the bodies (velocity_solver.rs:291-351):
    damping once with the full dt; next pose from the COM pose."""
    dt = float(params.dt)
    dyn = (active & (bodies.body_type == BodyType.DYNAMIC)).unsqueeze(-1)
    lin_f = 1.0 / (1.0 + dt * bodies.linear_damping)
    ang_f = 1.0 / (1.0 + dt * bodies.angular_damping)
    sb_vlin = sb.v_lin[..., :-1].transpose(1, 2)
    sb_vang = sb.v_ang[..., :-1].transpose(1, 2)
    linvel = torch.where(dyn, sb_vlin * lin_f.unsqueeze(-1), bodies.linvel)
    angvel = torch.where(dyn, sb_vang * ang_f.unsqueeze(-1), bodies.angvel)

    rot = sb.rot[..., :-1].transpose(1, 2)
    pos = sb.com[..., :-1].transpose(1, 2) - quat.rotate(rot, bodies.local_com)
    move = (active & ((bodies.body_type == BodyType.DYNAMIC)
                      | (bodies.body_type == BodyType.KINEMATIC_VELOCITY_BASED))
            ).unsqueeze(-1)
    kin_pos = (bodies.body_type == BodyType.KINEMATIC_POSITION_BASED).unsqueeze(-1)
    next_pos = torch.where(move, pos, torch.where(kin_pos, bodies.next_pos, bodies.pos))
    next_rot = torch.where(move, rot, torch.where(kin_pos, bodies.next_rot, bodies.rot))
    return dataclasses.replace(bodies, linvel=linvel, angvel=angvel,
                               next_pos=next_pos, next_rot=next_rot)
