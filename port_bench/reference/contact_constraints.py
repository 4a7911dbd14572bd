# Frozen copy of rapier_tpu_torch/dynamics/solver/contact_constraints.py at commit 4adbf044245c; imports
# made relative to this package.  Do not edit: it is the benchmark's yardstick.
"""Contact constraints, twist friction model: TGS-soft sequential impulses
over colored lanes (counterpart of
rapier_tpu.dynamics.solver.contact_constraints).

This is the plain PyTorch version of the contact solve: generation
(contact_with_twist_friction.rs:48-250), the per-substep update (:251-330),
the warmstart and one Gauss-Seidel color pass
(contact_constraint_element.rs).  Lanes carry a leading scene axis and keep
the pair lane LAST (``[B, 3, K]``, ``[B, 4, K]``, ``[B, 4, 3, K]``); body
gathers and scatters are indexing on the ``[B, d, N+1]`` solver-body tables,
whose last column N is a zeroed sentinel absorbing static endpoints.

Endpoint scatters come in two forms.  Without a `RoutePlan` they are
`Tensor.scatter_add`, which adds in lane order on the CPU: the kernel's plain
version, which the kernel matches bit for bit.  The non-kernel solve paths
pass a `RoutePlan`, whose sums have a fixed order on the card too: a sorted
segment sum, or for a conflict-free color block one inverse gather.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import quat
from .quat import cross_cl, dot_cl, rotate_cl
from .routing import SegmentPlan, segment_sum


class SolverBodies(NamedTuple):
    """SoA solver bodies, component-leading, sized N+1 (sentinel last)."""

    v_lin: torch.Tensor  # [B, 3, N+1]
    v_ang: torch.Tensor  # [B, 3, N+1]
    com: torch.Tensor    # [B, 3, N+1]
    rot: torch.Tensor    # [B, 4, N+1]
    im: torch.Tensor     # [B, 3, N+1] effective inverse mass per axis
    ii: torch.Tensor     # [B, 3, 3, N+1] effective world inverse inertia


class ContactConstraints(NamedTuple):
    """Per-manifold constraint lanes (lane axis LAST) with up to 4 points."""

    b1: torch.Tensor                  # [B, K] solver body (sentinel = static)
    b2: torch.Tensor                  # [B, K]
    valid: torch.Tensor               # [B, K] bool
    color: torch.Tensor               # [B, K]
    dir1: torch.Tensor                # [B, 3, K] (= -normal)
    tangent1: torch.Tensor            # [B, 3, K]
    im1: torch.Tensor                 # [B, 3, K]
    im2: torch.Tensor                 # [B, 3, K]
    limit: torch.Tensor               # [B, K] friction coefficient
    point_mask: torch.Tensor          # [B, 4, K] bool
    torque_dir1: torch.Tensor         # [B, 4, 3, K]
    torque_dir2: torch.Tensor         # [B, 4, 3, K]
    ii_torque_dir1: torch.Tensor      # [B, 4, 3, K]
    ii_torque_dir2: torch.Tensor      # [B, 4, 3, K]
    r: torch.Tensor                   # [B, 4, K] projected mass
    local_p1: torch.Tensor            # [B, 4, 3, K]
    local_p2: torch.Tensor            # [B, 4, 3, K]
    dist0: torch.Tensor               # [B, 4, K]
    normal_vel_rhs: torch.Tensor      # [B, 4, K]
    rhs: torch.Tensor                 # [B, 4, K]
    rhs_wo_bias: torch.Tensor         # [B, 4, K]
    impulse: torch.Tensor             # [B, 4, K]
    impulse_acc: torch.Tensor         # [B, 4, K]
    tan_torque_dir1: torch.Tensor     # [B, 2, 3, K]
    tan_torque_dir2: torch.Tensor     # [B, 2, 3, K]
    tan_ii_torque_dir1: torch.Tensor  # [B, 2, 3, K]
    tan_ii_torque_dir2: torch.Tensor  # [B, 2, 3, K]
    tan_r: torch.Tensor               # [B, 3, K] (r0, r1, r01 coupling)
    tan_rhs: torch.Tensor             # [B, 2, K]
    tan_rhs_wo_bias: torch.Tensor     # [B, 2, K]
    tan_impulse: torch.Tensor         # [B, 2, K]
    tan_impulse_acc: torch.Tensor     # [B, 2, K]
    local_fc1: torch.Tensor           # [B, 3, K] friction-center anchors
    local_fc2: torch.Tensor           # [B, 3, K]
    twist_ii_dir1: torch.Tensor       # [B, 3, K]
    twist_ii_dir2: torch.Tensor       # [B, 3, K]
    twist_r: torch.Tensor             # [B, K]
    twist_dists: torch.Tensor         # [B, 4, K]
    twist_impulse: torch.Tensor       # [B, K]
    twist_impulse_acc: torch.Tensor   # [B, K]
    cfm_factor: float                 # set by update


class RoutePlan(NamedTuple):
    """Fixed-order endpoint scatter of K lanes into ``[B, d, N+1]`` tables
    (the reference's RoutePlan, contact_constraints.py:91-111): one of

    - seg_pair: a segment plan over the concatenated endpoints [b1; b2],
      which sums every lane-endpoint's delta into its body;
    - inv_pair ``[B, N+1]``: for a block whose lanes share no body, the one
      delta column in [0, 2K) each body receives, 2K for none."""

    seg_pair: SegmentPlan = None
    inv_pair: torch.Tensor = None


def gather_cols(table, idx):
    """Lane gather: ``table [B, d, N+1]`` at ``idx [B, K]`` -> ``[B, d, K]``."""
    ix = idx.long().unsqueeze(1).expand(table.shape[:-1] + (idx.shape[-1],))
    return torch.gather(table, -1, ix)


def scatter_add_pair(table, b1, b2, v1, v2, route: RoutePlan = None):
    """``table [B, d, N+1]`` += deltas of both endpoints, endpoint-1 lanes
    first (the reference's fused [2K, N+1] route order), through `route`
    where one is given."""
    vals = torch.cat([v1, v2], dim=-1)
    if route is None:
        idx = torch.cat([b1, b2], dim=-1).long().unsqueeze(1)
        return table.scatter_add(-1, idx.expand(vals.shape), vals)
    if route.inv_pair is not None:
        vals = torch.cat([vals, torch.zeros_like(vals[..., :1])], dim=-1)
        return table + gather_cols(vals, route.inv_pair)
    return table + segment_sum(vals, route.seg_pair)


def _ii_mul(ii, v):
    """Per-lane ``[3][3]`` of ``[B, K]`` times ``[B, 3, K]``."""
    return torch.stack([
        ii[a][0] * v[:, 0] + ii[a][1] * v[:, 1] + ii[a][2] * v[:, 2]
        for a in range(3)
    ], dim=1)


def compute_tangent_directions(dir1, linvel1, linvel2):
    """Tangent along the relative linear velocity projected on the contact
    plane; orthonormal fallback below 1e-4 (contact_constraint/mod.rs)."""
    rel = linvel1 - linvel2
    tan = rel - dir1 * dot_cl(dir1, rel).unsqueeze(-2)
    norm = torch.sqrt(dot_cl(tan, tan)).unsqueeze(-2)
    tan_n = tan / torch.clamp(norm, min=1e-12)
    zero = torch.zeros_like(dir1[..., 0, :])
    d0, d1, d2 = dir1[..., 0, :], dir1[..., 1, :], dir1[..., 2, :]
    a = torch.stack([zero, d2, -d1], dim=-2)
    b = torch.stack([-d2, zero, d0], dim=-2)
    a_len = torch.sqrt(dot_cl(a, a)).unsqueeze(-2)
    fb = torch.where(a_len > 1e-6, a, b)
    fb = fb / torch.clamp(torch.sqrt(dot_cl(fb, fb)).unsqueeze(-2), min=1e-12)
    return torch.where(norm < 1e-4, fb, tan_n)


def generate(man, sb: SolverBodies, prev_impulse, color, n_bodies: int):
    """Constraint lanes from a ManifoldBatch (contact_constraints.py:311-327):
    an endpoint that is absent or dominated becomes the sentinel N."""
    sent = n_bodies
    b1 = torch.where((man.body1 >= 0) & (man.rel_dominance <= 0), man.body1, sent)
    b2 = torch.where((man.body2 >= 0) & (man.rel_dominance >= 0), man.body2, sent)
    return generate_from(b1, b2, man.solver_pair, color, man.normal, man.point,
                         man.point_active, man.dist, man.friction, man.restitution,
                         sb, prev_impulse)


def generate_from(b1, b2, valid, color, normal, point, point_active, dist,
                  friction, restitution, sb: SolverBodies, prev_impulse):
    """Build constraint lanes from resolved solver-body endpoints.  Impulses
    start at zero; the caller injects the matched warmstart impulses."""
    bsz, k = b1.shape
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

    dir1 = -normal
    tangent1 = compute_tangent_directions(dir1, v1l, v2l)
    tangent2 = cross_cl(dir1, tangent1)

    fmask = point_active.to(normal.dtype)
    npts = fmask[:, 0] + fmask[:, 1] + fmask[:, 2] + fmask[:, 3]
    inv_np = 1.0 / torch.clamp(npts, min=1.0)

    td1_k, td2_k, iitd1_k, iitd2_k = [], [], [], []
    denom_k, proj_k, lp1_k, lp2_k = [], [], [], []
    imsum = im1 + im2
    dir_im = dot_cl(dir1, imsum * dir1)
    for kk in range(4):
        pk = point[:, kk]
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

    r = 1.0 / torch.clamp(torch.stack(denom_k, dim=1), min=1e-12)
    proj_vel = torch.stack(proj_k, dim=1)
    rest = restitution.unsqueeze(1)
    # `prev_impulse == 0` exactly: a contact new this step bounces whenever
    # restitution > 0, a persisting one only at restitution >= 1.
    is_bouncy = torch.where(prev_impulse == 0.0, (rest > 0.0).to(rest.dtype),
                            (rest >= 1.0).to(rest.dtype))
    normal_vel_rhs = is_bouncy * rest * proj_vel

    fc = sum(point[:, kk] * fmask[:, kk].unsqueeze(1) for kk in range(4)) \
        * inv_np.unsqueeze(1)
    local_fc1 = quat.inv_rotate_cl(rot1, fc - com1)
    local_fc2 = quat.inv_rotate_cl(rot2, fc - com2)
    twist_dists = torch.stack([
        torch.where(
            point_active[:, kk],
            torch.sqrt(torch.clamp(dot_cl(fc - point[:, kk], fc - point[:, kk]),
                                   min=0.0)),
            torch.zeros_like(npts))
        for kk in range(4)
    ], dim=1)

    dfp1 = fc - com1
    dfp2 = fc - com2
    ttd1_j, ttd2_j, tiitd1_j, tiitd2_j, tr_j = [], [], [], [], []
    for tan in (tangent1, tangent2):
        ttd1 = cross_cl(dfp1, tan)
        ttd2 = cross_cl(dfp2, -tan)
        tiitd1 = _ii_mul(ii1, ttd1)
        tiitd2 = _ii_mul(ii2, ttd2)
        tr_j.append(dot_cl(tan, imsum * tan) + dot_cl(tiitd1, ttd1)
                    + dot_cl(tiitd2, ttd2))
        ttd1_j.append(ttd1)
        ttd2_j.append(ttd2)
        tiitd1_j.append(tiitd1)
        tiitd2_j.append(tiitd2)
    tr_coupling = 2.0 * (dot_cl(tiitd1_j[0], ttd1_j[1])
                         + dot_cl(tiitd2_j[0], ttd2_j[1]))

    twist_ii1 = _ii_mul(ii1, dir1)
    twist_ii2 = _ii_mul(ii2, -dir1)
    twist_r = 1.0 / torch.clamp(
        dot_cl(twist_ii1, dir1) + dot_cl(twist_ii2, -dir1), min=1e-12)

    z4 = torch.zeros_like(dist)
    z2 = torch.zeros_like(dist[:, :2])
    z1 = torch.zeros_like(npts)
    return ContactConstraints(
        b1=b1, b2=b2, valid=valid, color=color,
        dir1=dir1, tangent1=tangent1, im1=im1, im2=im2,
        limit=friction, point_mask=point_active,
        torque_dir1=torch.stack(td1_k, dim=1), torque_dir2=torch.stack(td2_k, dim=1),
        ii_torque_dir1=torch.stack(iitd1_k, dim=1),
        ii_torque_dir2=torch.stack(iitd2_k, dim=1),
        r=r, local_p1=torch.stack(lp1_k, dim=1), local_p2=torch.stack(lp2_k, dim=1),
        dist0=dist, normal_vel_rhs=normal_vel_rhs,
        rhs=z4, rhs_wo_bias=z4, impulse=z4, impulse_acc=z4,
        tan_torque_dir1=torch.stack(ttd1_j, dim=1),
        tan_torque_dir2=torch.stack(ttd2_j, dim=1),
        tan_ii_torque_dir1=torch.stack(tiitd1_j, dim=1),
        tan_ii_torque_dir2=torch.stack(tiitd2_j, dim=1),
        tan_r=torch.stack([tr_j[0], tr_j[1], tr_coupling], dim=1),
        tan_rhs=z2, tan_rhs_wo_bias=z2, tan_impulse=z2, tan_impulse_acc=z2,
        local_fc1=local_fc1, local_fc2=local_fc2,
        twist_ii_dir1=twist_ii1, twist_ii_dir2=twist_ii2,
        twist_r=twist_r, twist_dists=twist_dists,
        twist_impulse=z1, twist_impulse_acc=z1,
        cfm_factor=1.0,
    )


def update(c: ContactConstraints, sb: SolverBodies, *, cfm_factor, inv_dt,
           allowed_lin_err, erp_inv_dt, max_corrective_velocity,
           warmstart_coeff) -> ContactConstraints:
    """Per-substep soft-constraint rhs from the current solver poses
    (contact_with_twist_friction.rs:251-330); rates are per SUBSTEP."""
    pose = torch.cat([sb.com, sb.rot], dim=1)
    P1, P2 = gather_cols(pose, c.b1), gather_cols(pose, c.b2)
    com1, rot1 = P1[:, 0:3], P1[:, 3:7]
    com2, rot2 = P2[:, 0:3], P2[:, 3:7]

    dist = c.dist0 + torch.stack([
        dot_cl((com1 + rotate_cl(rot1, c.local_p1[:, kk]))
               - (com2 + rotate_cl(rot2, c.local_p2[:, kk])), c.dir1)
        for kk in range(4)
    ], dim=1)
    rhs_wo_bias = c.normal_vel_rhs + torch.clamp(dist, min=0.0) * inv_dt
    rhs_bias = torch.clamp((dist + allowed_lin_err) * erp_inv_dt,
                           -max_corrective_velocity, 0.0)

    fc1 = com1 + rotate_cl(rot1, c.local_fc1)
    fc2 = com2 + rotate_cl(rot2, c.local_fc2)
    tangent2 = cross_cl(c.dir1, c.tangent1)
    dfc = fc1 - fc2
    bias_t = torch.stack([dot_cl(dfc, c.tangent1), dot_cl(dfc, tangent2)],
                         dim=1) * inv_dt
    return c._replace(
        rhs=rhs_wo_bias + rhs_bias, rhs_wo_bias=rhs_wo_bias,
        impulse=c.impulse * warmstart_coeff,
        impulse_acc=c.impulse_acc + c.impulse,
        tan_rhs=c.tan_rhs_wo_bias + bias_t,
        tan_impulse=c.tan_impulse * warmstart_coeff,
        tan_impulse_acc=c.tan_impulse_acc + c.tan_impulse,
        twist_impulse=c.twist_impulse * warmstart_coeff,
        twist_impulse_acc=c.twist_impulse_acc + c.twist_impulse,
        cfm_factor=float(np.float32(cfm_factor)),   # float32, as the reference stores it (:619)
    )


def warmstart(c: ContactConstraints, sb: SolverBodies,
              route: RoutePlan = None) -> SolverBodies:
    """Apply the cached impulses of ALL lanes to body velocities (a pure
    accumulation, so no coloring is needed)."""
    act = (c.valid.unsqueeze(1) & c.point_mask).to(c.impulse.dtype)
    imp = c.impulse * act
    imp_sum = imp[:, 0] + imp[:, 1] + imp[:, 2] + imp[:, 3]

    dv1 = c.dir1 * c.im1 * imp_sum.unsqueeze(1)
    dv2 = -c.dir1 * c.im2 * imp_sum.unsqueeze(1)
    dw1 = sum(c.ii_torque_dir1[:, kk] * imp[:, kk].unsqueeze(1) for kk in range(4))
    dw2 = sum(c.ii_torque_dir2[:, kk] * imp[:, kk].unsqueeze(1) for kk in range(4))

    vmask = c.valid.to(c.impulse.dtype)
    t2 = cross_cl(c.dir1, c.tangent1)
    ti = c.tan_impulse * vmask.unsqueeze(1)
    tan_lin = c.tangent1 * ti[:, 0:1] + t2 * ti[:, 1:2]
    dv1 = dv1 + tan_lin * c.im1
    dv2 = dv2 - tan_lin * c.im2
    dw1 = dw1 + c.tan_ii_torque_dir1[:, 0] * ti[:, 0:1] \
        + c.tan_ii_torque_dir1[:, 1] * ti[:, 1:2]
    dw2 = dw2 + c.tan_ii_torque_dir2[:, 0] * ti[:, 0:1] \
        + c.tan_ii_torque_dir2[:, 1] * ti[:, 1:2]
    wi = (c.twist_impulse * vmask).unsqueeze(1)
    dw1 = dw1 + c.twist_ii_dir1 * wi
    dw2 = dw2 + c.twist_ii_dir2 * wi

    vw = scatter_add_pair(torch.cat([sb.v_lin, sb.v_ang], dim=1), c.b1, c.b2,
                          torch.cat([dv1, dw1], dim=1), torch.cat([dv2, dw2], dim=1),
                          route)
    return sb._replace(v_lin=vw[:, 0:3], v_ang=vw[:, 3:6])


def _normal_row(c, kk, pm, imp, v1, w1, v2, w2, rhs, cfm):
    """Point `kk`'s normal row on the lanes of ``pm [B, K]`` (0 or 1): the
    new impulse and velocities."""
    dvel = (dot_cl(c.dir1, v1) + dot_cl(c.torque_dir1[:, kk], w1)
            - dot_cl(c.dir1, v2) + dot_cl(c.torque_dir2[:, kk], w2)
            + rhs[:, kk])
    new_imp = cfm * torch.clamp(imp - c.r[:, kk] * dvel, min=0.0)
    dl = ((new_imp - imp) * pm).unsqueeze(1)
    return (imp + dl[:, 0], v1 + c.dir1 * c.im1 * dl, w1 + c.ii_torque_dir1[:, kk] * dl,
            v2 - c.dir1 * c.im2 * dl, w2 + c.ii_torque_dir2[:, kk] * dl)


def _block_pair(c, mask, imp_rows, v1, w1, v2, w2, rhs, cfm):
    """Points 0 and 1 of the lanes in `mask` (contact_constraint_element.rs
    :290-319, solve_mlcp_two_constraints; reference contact_constraints.py
    :676-760): where both points are active, one coupled 2x2 MLCP whose
    cases are tried in the reference's order (both impulses positive, only
    point 0's, only point 1's, both zero, else the old impulses kept); a
    singular pair (det <= 0) solves point 0 alone.  Elsewhere the two
    points are solved one after the other.  Returns (impulses of points 0
    and 1, v1, w1, v2, w2)."""
    pair_ok = mask & c.point_mask[:, 0] & c.point_mask[:, 1]

    # Sequential candidates for points 0 and 1 on the lanes not paired.
    seq = [imp_rows[0], imp_rows[1], v1, w1, v2, w2]
    for kk in range(2):
        pm = (mask & c.point_mask[:, kk] & ~pair_ok).to(c.impulse.dtype)
        seq[kk], *seq[2:] = _normal_row(c, kk, pm, seq[kk], *seq[2:], rhs, cfm)

    # The block candidate on the paired lanes.
    dvel_lin = dot_cl(c.dir1, v1) - dot_cl(c.dir1, v2)
    dva = (dvel_lin + dot_cl(c.torque_dir1[:, 0], w1)
           + dot_cl(c.torque_dir2[:, 0], w2) + rhs[:, 0])
    dvb = (dvel_lin + dot_cl(c.torque_dir1[:, 1], w1)
           + dot_cl(c.torque_dir2[:, 1], w2) + rhs[:, 1])
    r0, r1 = c.r[:, 0], c.r[:, 1]
    m11 = 1.0 / torch.clamp(r0, min=1e-12)
    m22 = 1.0 / torch.clamp(r1, min=1e-12)
    m12 = (dot_cl(c.dir1 * (c.im1 + c.im2), c.dir1)
           + dot_cl(c.ii_torque_dir1[:, 0], c.torque_dir1[:, 1])
           + dot_cl(c.ii_torque_dir2[:, 0], c.torque_dir2[:, 1]))
    det = m11 * m22 - m12 * m12
    invertible = det > 0.0
    safe_det = torch.where(invertible, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    # A singular pair keeps point 0's row alone (the reference zeroes the
    # redundant row's matrix elements).
    inv11 = torch.where(invertible, m22 / safe_det, r0)
    inv22 = torch.where(invertible, m11 / safe_det, zero)
    inv12 = torch.where(invertible, -m12 / safe_det, zero)
    k12 = torch.where(invertible, m12, zero)

    prev0, prev1 = imp_rows[0], imp_rows[1]
    n0x = prev0 - (inv11 * dva + inv12 * dvb)
    n0y = prev1 - (inv12 * dva + inv22 * dvb)
    n1x = prev0 - r0 * dva
    n2y = prev1 - r1 * dvb
    keep0 = (n0x >= 0.0) & (n0y >= 0.0)
    keep1 = (n1x >= 0.0) & (dvb + k12 * n1x >= 0.0)
    keep2 = (n2y >= 0.0) & (dva + k12 * n2y >= 0.0)
    keep3 = (dva >= 0.0) & (dvb >= 0.0)
    selx = torch.where(keep0, cfm * n0x, torch.where(
        keep1, cfm * n1x, torch.where(keep2 | keep3, zero, prev0)))
    sely = torch.where(keep0, cfm * n0y, torch.where(
        keep1, zero, torch.where(keep2, cfm * n2y, torch.where(keep3, zero, prev1))))
    fpair = pair_ok.to(c.impulse.dtype)
    dl0 = ((selx - prev0) * fpair).unsqueeze(1)
    dl1 = ((sely - prev1) * fpair).unsqueeze(1)
    blk = (v1 + c.dir1 * c.im1 * (dl0 + dl1),
           w1 + c.ii_torque_dir1[:, 0] * dl0 + c.ii_torque_dir1[:, 1] * dl1,
           v2 - c.dir1 * c.im2 * (dl0 + dl1),
           w2 + c.ii_torque_dir2[:, 0] * dl0 + c.ii_torque_dir2[:, 1] * dl1)

    sel = fpair.unsqueeze(1)
    v1, w1, v2, w2 = (b * sel + s * (1.0 - sel) for b, s in zip(blk, seq[2:]))
    return (torch.where(pair_ok, prev0 + dl0[:, 0], seq[0]),
            torch.where(pair_ok, prev1 + dl1[:, 0], seq[1]), v1, w1, v2, w2)


def solve_color(c: ContactConstraints, sb: SolverBodies, color_id, *,
                use_bias: bool, route: RoutePlan = None, block_2x2: bool = False):
    """One Gauss-Seidel pass over the lanes of one color
    (contact_with_twist_friction.rs:395-460): normal points in order, then
    the coupled tangent pair, then twist.  Lanes of one color share no
    dynamic body, so the scatter-add of their deltas is conflict-free; in the
    overflow color it accumulates (Jacobi), as in the reference.

    `block_2x2` solves points 0 and 1 as one coupled 2x2 MLCP
    (`_block_pair`), the 2D block solver (BLOCK_SOLVER_ENABLED,
    integration_parameters.rs:9) that PhysicsWorld2D turns on; points 2-3
    follow one at a time."""
    mask = c.valid & (c.color == color_id)
    fmask = mask.to(c.impulse.dtype)

    vw = torch.cat([sb.v_lin, sb.v_ang], dim=1)
    V1, V2 = gather_cols(vw, c.b1), gather_cols(vw, c.b2)
    v1, w1, v2, w2 = V1[:, 0:3], V1[:, 3:6], V2[:, 0:3], V2[:, 3:6]
    v1_0, w1_0, v2_0, w2_0 = v1, w1, v2, w2

    # cfm softens the biased sweeps only.
    cfm = c.cfm_factor if use_bias else 1.0
    rhs = c.rhs if use_bias else c.rhs_wo_bias

    imp_rows = [c.impulse[:, kk] for kk in range(4)]
    start_k = 0
    if block_2x2:
        start_k = 2
        imp_rows[0], imp_rows[1], v1, w1, v2, w2 = _block_pair(
            c, mask, imp_rows, v1, w1, v2, w2, rhs, cfm)
    for kk in range(start_k, 4):
        pm = (mask & c.point_mask[:, kk]).to(c.impulse.dtype)
        imp_rows[kk], v1, w1, v2, w2 = _normal_row(c, kk, pm, imp_rows[kk], v1, w1, v2, w2,
                                                   rhs, cfm)
    impulses = torch.stack(imp_rows, dim=1)

    # Friction limits scale with the solved normal impulses.
    act = c.point_mask.to(c.impulse.dtype)
    act_rows = [act[:, kk] * imp_rows[kk] for kk in range(4)]
    tangent_limit = (act_rows[0] + act_rows[1] + act_rows[2] + act_rows[3]) * c.limit
    twist_limit = sum(act_rows[kk] * c.twist_dists[:, kk] for kk in range(4)) * c.limit

    # Coupled 2-D tangent solve (contact_constraint_element.rs:161-203).
    t2 = cross_cl(c.dir1, c.tangent1)
    tan_rhs = c.tan_rhs if use_bias else c.tan_rhs_wo_bias
    d0 = (dot_cl(c.tangent1, v1) + dot_cl(c.tan_torque_dir1[:, 0], w1)
          - dot_cl(c.tangent1, v2) + dot_cl(c.tan_torque_dir2[:, 0], w2)
          + tan_rhs[:, 0])
    d1 = (dot_cl(t2, v1) + dot_cl(c.tan_torque_dir1[:, 1], w1)
          - dot_cl(t2, v2) + dot_cl(c.tan_torque_dir2[:, 1], w2)
          + tan_rhs[:, 1])
    d00, d11, d01 = d0 * d0, d1 * d1, d0 * d1
    denom = d00 * c.tan_r[:, 0] + d11 * c.tan_r[:, 1] + d01 * c.tan_r[:, 2]
    inv_lhs = (d00 + d11) / torch.where(torch.abs(denom) < 1e-12,
                                        torch.full_like(denom, 1e-12), denom)
    new_t0 = c.tan_impulse[:, 0] - inv_lhs * d0
    new_t1 = c.tan_impulse[:, 1] - inv_lhs * d1
    t_norm = torch.sqrt(new_t0 * new_t0 + new_t1 * new_t1)
    scale = torch.where(t_norm > tangent_limit,
                        tangent_limit / torch.clamp(t_norm, min=1e-12),
                        torch.ones_like(t_norm))
    new_t = torch.stack([new_t0 * scale, new_t1 * scale], dim=1)
    dl_t = (new_t - c.tan_impulse) * fmask.unsqueeze(1)
    tan_impulse = c.tan_impulse + dl_t

    dvt = c.tangent1 * dl_t[:, 0:1] + t2 * dl_t[:, 1:2]
    v1 = v1 + dvt * c.im1
    v2 = v2 - dvt * c.im2
    w1 = w1 + c.tan_ii_torque_dir1[:, 0] * dl_t[:, 0:1] \
        + c.tan_ii_torque_dir1[:, 1] * dl_t[:, 1:2]
    w2 = w2 + c.tan_ii_torque_dir2[:, 0] * dl_t[:, 0:1] \
        + c.tan_ii_torque_dir2[:, 1] * dl_t[:, 1:2]

    # Twist (only with >= 2 points), clamped to the twist limit.
    npts = act[:, 0] + act[:, 1] + act[:, 2] + act[:, 3]
    has_twist = (npts > 1.5).to(c.impulse.dtype)
    dvel_tw = dot_cl(c.dir1, w1 - w2)
    new_tw = torch.clamp(c.twist_impulse - c.twist_r * dvel_tw,
                         -twist_limit, twist_limit)
    dl_tw = (new_tw - c.twist_impulse) * fmask * has_twist
    twist_impulse = c.twist_impulse + dl_tw
    w1 = w1 + c.twist_ii_dir1 * dl_tw.unsqueeze(1)
    w2 = w2 + c.twist_ii_dir2 * dl_tw.unsqueeze(1)

    m = fmask.unsqueeze(1)
    vw = scatter_add_pair(
        vw, c.b1, c.b2,
        torch.cat([(v1 - v1_0) * m, (w1 - w1_0) * m], dim=1),
        torch.cat([(v2 - v2_0) * m, (w2 - w2_0) * m], dim=1), route)
    c = c._replace(
        impulse=torch.where(mask.unsqueeze(1), impulses, c.impulse),
        tan_impulse=torch.where(mask.unsqueeze(1), tan_impulse, c.tan_impulse),
        twist_impulse=torch.where(mask, twist_impulse, c.twist_impulse),
    )
    return c, sb._replace(v_lin=vw[:, 0:3], v_ang=vw[:, 3:6])
