"""Contact constraints, Coulomb friction model (FrictionModel.COULOMB):
counterpart of rapier_tpu.dynamics.solver.contact_constraints_coulomb.

The reference's ContactWithCoulombFriction
(contact_with_coulomb_friction.rs:323): per contact point one normal row (the
twist model's normal math) and one coupled tangent pair whose friction limit
is that point's own normal impulse, solved in the same pass (:456-476).  No
twist row.  The module mirrors `contact_constraints` (generation, the
per-substep update, the warmstart, one Gauss-Seidel color pass), so the
substep loops of `velocity_solver` take either; its per-point tangent fields
grow a point axis: ``[B, 4, 2, 3, K]`` torque directions, ``[B, 4, 3, K]``
effective-mass triplets, ``[B, 4, 2, K]`` impulses.  Gathers and scatters
are those of `contact_constraints` (`gather_cols`, `scatter_add_pair`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rapier_tpu_torch.dynamics.solver.contact_constraints import (
    RoutePlan,
    SolverBodies,
    _ii_mul,
    _normal_row,
    compute_tangent_directions,
    gather_cols,
    scatter_add_pair,
)
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.math.quat import cross_cl, dot_cl, rotate_cl


class CoulombConstraints(NamedTuple):
    """Per-manifold lanes (lane axis LAST), a tangent pair per point."""

    b1: torch.Tensor                  # [B, K]
    b2: torch.Tensor                  # [B, K]
    valid: torch.Tensor               # [B, K] bool
    color: torch.Tensor               # [B, K]
    dir1: torch.Tensor                # [B, 3, K]
    tangent1: torch.Tensor            # [B, 3, K]
    im1: torch.Tensor                 # [B, 3, K]
    im2: torch.Tensor                 # [B, 3, K]
    limit: torch.Tensor               # [B, K] friction coefficient
    point_mask: torch.Tensor          # [B, 4, K] bool
    torque_dir1: torch.Tensor         # [B, 4, 3, K]
    torque_dir2: torch.Tensor         # [B, 4, 3, K]
    ii_torque_dir1: torch.Tensor      # [B, 4, 3, K]
    ii_torque_dir2: torch.Tensor      # [B, 4, 3, K]
    r: torch.Tensor                   # [B, 4, K]
    local_p1: torch.Tensor            # [B, 4, 3, K]
    local_p2: torch.Tensor            # [B, 4, 3, K]
    dist0: torch.Tensor               # [B, 4, K]
    normal_vel_rhs: torch.Tensor      # [B, 4, K]
    rhs: torch.Tensor                 # [B, 4, K]
    rhs_wo_bias: torch.Tensor         # [B, 4, K]
    impulse: torch.Tensor             # [B, 4, K]
    impulse_acc: torch.Tensor         # [B, 4, K]
    tan_torque_dir1: torch.Tensor     # [B, 4, 2, 3, K]
    tan_torque_dir2: torch.Tensor     # [B, 4, 2, 3, K]
    tan_ii_torque_dir1: torch.Tensor  # [B, 4, 2, 3, K]
    tan_ii_torque_dir2: torch.Tensor  # [B, 4, 2, 3, K]
    tan_r: torch.Tensor               # [B, 4, 3, K] (r0, r1, r01 coupling)
    tan_rhs: torch.Tensor             # [B, 4, 2, K]
    tan_rhs_wo_bias: torch.Tensor     # [B, 4, 2, K]
    tan_impulse: torch.Tensor         # [B, 4, 2, K]
    tan_impulse_acc: torch.Tensor     # [B, 4, 2, K]
    cfm_factor: float                 # set by update


def generate(man, sb: SolverBodies, prev_impulse, color, n_bodies: int):
    """Constraint lanes from a ManifoldBatch (contact_with_coulomb_friction.rs
    :48-250): an endpoint that is absent or dominated becomes the sentinel N.
    Impulses start at zero; the caller injects the matched warmstart."""
    sent = n_bodies
    b1 = torch.where((man.body1 >= 0) & (man.rel_dominance <= 0), man.body1, sent)
    b2 = torch.where((man.body2 >= 0) & (man.rel_dominance >= 0), man.body2, sent)
    bsz = b1.shape[0]
    n1 = sb.v_lin.shape[-1]
    big = torch.cat([sb.v_lin, sb.v_ang, sb.com, sb.rot, sb.im,
                     sb.ii.reshape(bsz, 9, n1)], dim=1)        # [B, 25, N+1]
    G1, G2 = gather_cols(big, b1), gather_cols(big, b2)
    v1l, w1, com1, rot1, im1, ii1_r = (
        G1[:, 0:3], G1[:, 3:6], G1[:, 6:9], G1[:, 9:13], G1[:, 13:16], G1[:, 16:25])
    v2l, w2, com2, rot2, im2, ii2_r = (
        G2[:, 0:3], G2[:, 3:6], G2[:, 6:9], G2[:, 9:13], G2[:, 13:16], G2[:, 16:25])
    ii1 = [[ii1_r[:, 3 * a + c] for c in range(3)] for a in range(3)]
    ii2 = [[ii2_r[:, 3 * a + c] for c in range(3)] for a in range(3)]

    dir1 = -man.normal
    tangent1 = compute_tangent_directions(dir1, v1l, v2l)
    tans = (tangent1, cross_cl(dir1, tangent1))
    imsum = im1 + im2
    dir_im = dot_cl(dir1, imsum * dir1)

    td1_k, td2_k, iitd1_k, iitd2_k = [], [], [], []
    denom_k, proj_k, lp1_k, lp2_k = [], [], [], []
    ttd1_k, ttd2_k, tiitd1_k, tiitd2_k, tr_k = [], [], [], [], []
    for kk in range(4):
        pk = man.point[:, kk]
        dp1 = pk - com1
        dp2 = pk - com2
        vel1 = v1l + cross_cl(w1, dp1)
        vel2 = v2l + cross_cl(w2, dp2)
        td1 = cross_cl(dp1, dir1)
        td2 = cross_cl(dp2, -dir1)
        iitd1 = _ii_mul(ii1, td1)
        iitd2 = _ii_mul(ii2, td2)
        denom_k.append(dir_im + dot_cl(iitd1, td1) + dot_cl(iitd2, td2))
        proj_k.append(dot_cl(vel1 - vel2, dir1))
        lp1_k.append(quat.inv_rotate_cl(rot1, dp1))
        lp2_k.append(quat.inv_rotate_cl(rot2, dp2))
        td1_k.append(td1)
        td2_k.append(td2)
        iitd1_k.append(iitd1)
        iitd2_k.append(iitd2)

        # This point's tangent pair (contact_constraint_element.rs).
        ttd1_j, ttd2_j, tiitd1_j, tiitd2_j, tr_j = [], [], [], [], []
        for tan in tans:
            tt1 = cross_cl(dp1, tan)
            tt2 = cross_cl(dp2, -tan)
            ti1 = _ii_mul(ii1, tt1)
            ti2 = _ii_mul(ii2, tt2)
            tr_j.append(dot_cl(tan, imsum * tan) + dot_cl(ti1, tt1) + dot_cl(ti2, tt2))
            ttd1_j.append(tt1)
            ttd2_j.append(tt2)
            tiitd1_j.append(ti1)
            tiitd2_j.append(ti2)
        coupling = 2.0 * (dot_cl(tiitd1_j[0], ttd1_j[1]) + dot_cl(tiitd2_j[0], ttd2_j[1]))
        ttd1_k.append(torch.stack(ttd1_j, dim=1))
        ttd2_k.append(torch.stack(ttd2_j, dim=1))
        tiitd1_k.append(torch.stack(tiitd1_j, dim=1))
        tiitd2_k.append(torch.stack(tiitd2_j, dim=1))
        tr_k.append(torch.stack([tr_j[0], tr_j[1], coupling], dim=1))

    r = 1.0 / torch.clamp(torch.stack(denom_k, dim=1), min=1e-12)
    proj_vel = torch.stack(proj_k, dim=1)
    rest = man.restitution.unsqueeze(1)
    # A contact new this step bounces whenever restitution > 0, a persisting
    # one only at restitution >= 1.
    is_bouncy = torch.where(prev_impulse == 0.0, (rest > 0.0).to(rest.dtype),
                            (rest >= 1.0).to(rest.dtype))
    normal_vel_rhs = is_bouncy * rest * proj_vel

    z4 = torch.zeros_like(man.dist)
    z42 = torch.zeros_like(z4).unsqueeze(2).expand(-1, -1, 2, -1).contiguous()
    return CoulombConstraints(
        b1=b1, b2=b2, valid=man.solver_pair, color=color,
        dir1=dir1, tangent1=tangent1, im1=im1, im2=im2,
        limit=man.friction, point_mask=man.point_active,
        torque_dir1=torch.stack(td1_k, dim=1), torque_dir2=torch.stack(td2_k, dim=1),
        ii_torque_dir1=torch.stack(iitd1_k, dim=1),
        ii_torque_dir2=torch.stack(iitd2_k, dim=1),
        r=r, local_p1=torch.stack(lp1_k, dim=1), local_p2=torch.stack(lp2_k, dim=1),
        dist0=man.dist, normal_vel_rhs=normal_vel_rhs,
        rhs=z4, rhs_wo_bias=z4, impulse=z4, impulse_acc=z4,
        tan_torque_dir1=torch.stack(ttd1_k, dim=1),
        tan_torque_dir2=torch.stack(ttd2_k, dim=1),
        tan_ii_torque_dir1=torch.stack(tiitd1_k, dim=1),
        tan_ii_torque_dir2=torch.stack(tiitd2_k, dim=1),
        tan_r=torch.stack(tr_k, dim=1), tan_rhs=z42, tan_rhs_wo_bias=z42,
        tan_impulse=z42, tan_impulse_acc=z42,
        cfm_factor=1.0,
    )


def update(c: CoulombConstraints, sb: SolverBodies, *, cfm_factor, inv_dt,
           allowed_lin_err, erp_inv_dt, max_corrective_velocity,
           warmstart_coeff) -> CoulombConstraints:
    """Per-substep soft rhs from the current solver poses
    (contact_with_coulomb_friction.rs:251-318); rates are per SUBSTEP."""
    pose = torch.cat([sb.com, sb.rot], dim=1)
    P1, P2 = gather_cols(pose, c.b1), gather_cols(pose, c.b2)
    com1, rot1 = P1[:, 0:3], P1[:, 3:7]
    com2, rot2 = P2[:, 0:3], P2[:, 3:7]
    tans = (c.tangent1, cross_cl(c.dir1, c.tangent1))

    dist_k, bias_k = [], []
    for kk in range(4):
        p1 = com1 + rotate_cl(rot1, c.local_p1[:, kk])
        p2 = com2 + rotate_cl(rot2, c.local_p2[:, kk])
        dist_k.append(dot_cl(p1 - p2, c.dir1))
        dp = p1 - p2
        bias_k.append(torch.stack([dot_cl(dp, tans[0]) * inv_dt,
                                   dot_cl(dp, tans[1]) * inv_dt], dim=1))
    dist = c.dist0 + torch.stack(dist_k, dim=1)
    rhs_wo_bias = c.normal_vel_rhs + torch.clamp(dist, min=0.0) * inv_dt
    rhs_bias = torch.clamp((dist + allowed_lin_err) * erp_inv_dt,
                           -max_corrective_velocity, 0.0)
    return c._replace(
        rhs=rhs_wo_bias + rhs_bias, rhs_wo_bias=rhs_wo_bias,
        impulse_acc=c.impulse_acc + c.impulse,
        impulse=c.impulse * warmstart_coeff,
        tan_rhs=c.tan_rhs_wo_bias + torch.stack(bias_k, dim=1),
        tan_impulse_acc=c.tan_impulse_acc + c.tan_impulse,
        tan_impulse=c.tan_impulse * warmstart_coeff,
        cfm_factor=float(np.float32(cfm_factor)),   # float32, as the reference stores it (:231)
    )


def warmstart(c: CoulombConstraints, sb: SolverBodies,
              route: RoutePlan = None) -> SolverBodies:
    """Apply the cached impulses of ALL lanes' active points to the body
    velocities (a pure accumulation)."""
    act = (c.valid.unsqueeze(1) & c.point_mask).to(c.impulse.dtype)
    imp = c.impulse * act
    imp_sum = imp[:, 0] + imp[:, 1] + imp[:, 2] + imp[:, 3]
    dv1 = c.dir1 * c.im1 * imp_sum.unsqueeze(1)
    dv2 = -c.dir1 * c.im2 * imp_sum.unsqueeze(1)
    dw1 = sum(c.ii_torque_dir1[:, kk] * imp[:, kk].unsqueeze(1) for kk in range(4))
    dw2 = sum(c.ii_torque_dir2[:, kk] * imp[:, kk].unsqueeze(1) for kk in range(4))

    tans = (c.tangent1, cross_cl(c.dir1, c.tangent1))
    for kk in range(4):
        t0 = (c.tan_impulse[:, kk, 0] * act[:, kk]).unsqueeze(1)
        t1 = (c.tan_impulse[:, kk, 1] * act[:, kk]).unsqueeze(1)
        lin = tans[0] * t0 + tans[1] * t1
        dv1 = dv1 + lin * c.im1
        dv2 = dv2 - lin * c.im2
        dw1 = dw1 + c.tan_ii_torque_dir1[:, kk, 0] * t0 + c.tan_ii_torque_dir1[:, kk, 1] * t1
        dw2 = dw2 + c.tan_ii_torque_dir2[:, kk, 0] * t0 + c.tan_ii_torque_dir2[:, kk, 1] * t1

    vw = scatter_add_pair(torch.cat([sb.v_lin, sb.v_ang], dim=1), c.b1, c.b2,
                          torch.cat([dv1, dw1], dim=1), torch.cat([dv2, dw2], dim=1),
                          route)
    return sb._replace(v_lin=vw[:, 0:3], v_ang=vw[:, 3:6])


def solve_color(c: CoulombConstraints, sb: SolverBodies, color_id, *,
                use_bias: bool, route: RoutePlan = None):
    """One Gauss-Seidel pass over the lanes of one color
    (contact_with_coulomb_friction.rs:385-470): the normal points in order,
    then each point's coupled tangent pair, its limit the friction times
    that point's normal impulse of this pass."""
    mask = c.valid & (c.color == color_id)
    fmask = mask.to(c.impulse.dtype)

    vw = torch.cat([sb.v_lin, sb.v_ang], dim=1)
    V1, V2 = gather_cols(vw, c.b1), gather_cols(vw, c.b2)
    v1, w1, v2, w2 = V1[:, 0:3], V1[:, 3:6], V2[:, 0:3], V2[:, 3:6]
    v1_0, w1_0, v2_0, w2_0 = v1, w1, v2, w2

    # cfm softens the biased sweeps only.
    cfm = c.cfm_factor if use_bias else 1.0
    rhs = c.rhs if use_bias else c.rhs_wo_bias
    tan_rhs = c.tan_rhs if use_bias else c.tan_rhs_wo_bias

    imp_rows = [c.impulse[:, kk] for kk in range(4)]
    for kk in range(4):
        pm = (mask & c.point_mask[:, kk]).to(c.impulse.dtype)
        imp_rows[kk], v1, w1, v2, w2 = _normal_row(c, kk, pm, imp_rows[kk], v1, w1, v2, w2,
                                                   rhs, cfm)

    tans = (c.tangent1, cross_cl(c.dir1, c.tangent1))
    tan_rows = []
    for kk in range(4):
        pm = (mask & c.point_mask[:, kk]).to(c.impulse.dtype)
        limit = c.limit * imp_rows[kk]
        ttd1, ttd2 = c.tan_torque_dir1[:, kk], c.tan_torque_dir2[:, kk]
        d0 = (dot_cl(tans[0], v1) + dot_cl(ttd1[:, 0], w1)
              - dot_cl(tans[0], v2) + dot_cl(ttd2[:, 0], w2) + tan_rhs[:, kk, 0])
        d1 = (dot_cl(tans[1], v1) + dot_cl(ttd1[:, 1], w1)
              - dot_cl(tans[1], v2) + dot_cl(ttd2[:, 1], w2) + tan_rhs[:, kk, 1])
        d00, d11, d01 = d0 * d0, d1 * d1, d0 * d1
        tr = c.tan_r[:, kk]
        denom = d00 * tr[:, 0] + d11 * tr[:, 1] + d01 * tr[:, 2]
        inv_lhs = (d00 + d11) / torch.where(torch.abs(denom) < 1e-12,
                                            torch.full_like(denom, 1e-12), denom)
        old = c.tan_impulse[:, kk]
        new_t0 = old[:, 0] - inv_lhs * d0
        new_t1 = old[:, 1] - inv_lhs * d1
        t_norm = torch.sqrt(new_t0 * new_t0 + new_t1 * new_t1)
        scale = torch.where(t_norm > limit, limit / torch.clamp(t_norm, min=1e-12),
                            torch.ones_like(t_norm))
        dl0 = ((new_t0 * scale - old[:, 0]) * pm).unsqueeze(1)
        dl1 = ((new_t1 * scale - old[:, 1]) * pm).unsqueeze(1)
        tan_rows.append(torch.stack([old[:, 0] + dl0[:, 0], old[:, 1] + dl1[:, 0]], dim=1))
        lin = tans[0] * dl0 + tans[1] * dl1
        v1 = v1 + lin * c.im1
        v2 = v2 - lin * c.im2
        w1 = w1 + c.tan_ii_torque_dir1[:, kk, 0] * dl0 + c.tan_ii_torque_dir1[:, kk, 1] * dl1
        w2 = w2 + c.tan_ii_torque_dir2[:, kk, 0] * dl0 + c.tan_ii_torque_dir2[:, kk, 1] * dl1

    m = fmask.unsqueeze(1)
    vw = scatter_add_pair(
        vw, c.b1, c.b2,
        torch.cat([(v1 - v1_0) * m, (w1 - w1_0) * m], dim=1),
        torch.cat([(v2 - v2_0) * m, (w2 - w2_0) * m], dim=1), route)
    c = c._replace(
        impulse=torch.where(mask.unsqueeze(1), torch.stack(imp_rows, dim=1), c.impulse),
        tan_impulse=torch.where(mask[:, None, None], torch.stack(tan_rows, dim=1),
                                c.tan_impulse),
    )
    return c, sb._replace(v_lin=vw[:, 0:3], v_ang=vw[:, 3:6])
