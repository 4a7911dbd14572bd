"""Impulse-joint constraint rows: the axis-based lock / limit / motor model
(counterpart of rapier_tpu.dynamics.solver.joint_constraints).

Rows are rebuilt from the solver poses every substep
(joint_constraint_builder.rs:66-106), orthogonalized with masked modified
Gram-Schmidt, solved in order within a joint and colored across joints.
Every tensor carries a leading scene axis and keeps the reference's
row-major joint layout: ``[B, J]``, ``[B, J, R]``, ``[B, J, R, 3]``.

Row slots per joint (masked when unused):

| slots | row                                            |
|-------|------------------------------------------------|
| 0-2   | angular motor (axes 3..5)                      |
| 3-5   | linear motor (axes 0..2)                       |
| 6     | coupled linear motor                           |
| 7-9   | angular lock                                   |
| 10-12 | linear lock                                    |
| 13-15 | angular limit                                  |
| 16-18 | linear limit                                   |
| 19    | coupled linear limit                           |
| 20    | coupled angular limit (spherical swing limits) |

Group A (slots 0-6) and group B (7-20) are orthogonalized apart, as the
reference's two finalize_constraints calls are.

A slot no joint uses carries a zero row: it changes no velocity and no
other row, and its impulse stays 0.  Which slots a joint uses follows from
its table's axis bits alone (`slot_activity`), so `PhysicsWorld.build`
takes the set once (`used_slots`, into `SimParams.joint_slots`);
`build_rows` computes every slot and keeps those (`JointRows.slots`), and
the Gram-Schmidt pass and `solve_color` work only those.  `full_slots` puts
a kept-slot tensor back into the 21-slot layout.

Body gathers are indexing; the velocity deltas of a color reach their
bodies through a fixed-order segment sum (`utils/routing.py`), so a body
that two joints of the Luby overflow color share sums both deltas (Jacobi
within that color, as the reference's one-hot matmul does) in the same
order on every run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rapier_tpu_torch.dynamics.solver.contact_constraints import (
    RoutePlan,
    gather_cols,
    scatter_add_pair,
)
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import (
    JOINT_ANG_AXES,
    JOINT_LIN_AXES,
    MAX_JOINT_ROWS,
    MotorModel,
    spring_erp_inv_dt,
)
from rapier_tpu_torch.utils.routing import make_segment_plan

R = MAX_JOINT_ROWS
_BIG = 3.0e38
_GROUP_B = 7   # first slot of the second Gram-Schmidt group


class JointRows(NamedTuple):
    """One substep's rows over the kept slots ``S = len(slots)``."""

    b1: torch.Tensor           # [B, J] solver body (sentinel N for padding)
    b2: torch.Tensor           # [B, J]
    valid: torch.Tensor        # [B, J] bool
    color: torch.Tensor        # [B, J]
    im1: torch.Tensor          # [B, J, 3]
    im2: torch.Tensor          # [B, J, 3]
    lin_jac: torch.Tensor      # [B, J, S, 3]
    ang_jac1: torch.Tensor     # [B, J, S, 3]
    ang_jac2: torch.Tensor     # [B, J, S, 3]
    ii_ang_jac1: torch.Tensor  # [B, J, S, 3]
    ii_ang_jac2: torch.Tensor  # [B, J, S, 3]
    rhs: torch.Tensor          # [B, J, S]
    rhs_wo_bias: torch.Tensor  # [B, J, S]
    cfm_gain: torch.Tensor     # [B, J, S]
    inv_lhs: torch.Tensor      # [B, J, S]
    lo: torch.Tensor           # [B, J, S]
    hi: torch.Tensor           # [B, J, S]
    impulse: torch.Tensor      # [B, J, S]
    active: torch.Tensor       # [B, J, S] bool
    slots: tuple               # the kept slot ids, ascending
    # The solve's packed forms: the row's velocity jacobian over
    # (v1, w1, v2, w2), and the velocity change of a unit impulse.
    jac: torch.Tensor          # [B, J, S, 12]
    mob: torch.Tensor          # [B, J, S, 12]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _bits(mask, first: int, count: int):
    """Bits first..first+count-1 of ``mask [B, J]`` as ``[B, J, count]`` bool."""
    sh = torch.arange(first, first + count, device=mask.device, dtype=mask.dtype)
    return ((mask.unsqueeze(-1) >> sh) & 1) == 1


def _inv(x):
    return torch.where(x == 0.0, 0.0, 1.0 / torch.where(x == 0.0, 1.0, x))


def motor_coefficients(model, stiffness, damping, dt):
    """MotorModel::combine_coefficients (motor_model.rs:37-56).
    Returns (erp_inv_dt, cfm_coeff, cfm_gain)."""
    erp_inv_dt = stiffness * _inv(dt * stiffness + damping)
    base = _inv(dt * dt * stiffness + dt * damping)
    accel = model == int(MotorModel.ACCELERATION_BASED)
    return erp_inv_dt, torch.where(accel, base, 0.0), torch.where(accel, 0.0, base)


def spring_cfm_coeff(natural_frequency, damping_ratio, dt):
    """SpringCoefficients::cfm_coeff (integration_parameters.rs:96-111)."""
    erp = dt * spring_erp_inv_dt(natural_frequency, damping_ratio, dt)
    safe = torch.where(erp == 0.0, 1.0, erp)
    inv_erp_m1 = 1.0 / safe - 1.0
    coeff = inv_erp_m1 * inv_erp_m1 / (
        (1.0 + inv_erp_m1) * 4.0 * damping_ratio * damping_ratio)
    return torch.where(erp == 0.0, 0.0, coeff)


def _rows(table, idx):
    """``table [B, d, N+1]`` at ``idx [B, J]`` -> ``[B, J, d]``."""
    return gather_cols(table, idx).transpose(1, 2)


def _coupled_lin(ax, cm1, cm2, lin_err, coupled_b):
    """The coupled linear direction (slots 6 and 19): the jacobians summed
    over the coupled linear axes, weighted by the error along each, then
    normalized.  Returns (lj, aj1, aj2, dist, first coupled axis [B, J, 1])."""
    cbits = _bits(coupled_b, 0, 3)
    coeff = _dot(ax, lin_err.unsqueeze(-2)) * cbits        # [B, J, 3]
    lj, aj1, aj2 = (torch.zeros_like(lin_err) for _ in range(3))
    for a in range(3):
        c = coeff[..., a:a + 1]
        lj = lj + ax[..., a, :] * c
        aj1 = aj1 + cm1[..., a, :] * c
        aj2 = aj2 + cm2[..., a, :] * c
    dist = torch.linalg.norm(lj, dim=-1)
    inv_d = (1.0 / torch.clamp(dist, min=1e-12)).unsqueeze(-1)
    fa = torch.argmax(cbits.to(torch.int32), dim=-1, keepdim=True)
    return lj * inv_d, aj1 * inv_d, aj2 * inv_d, dist, fa


def _one(x):
    """A single slot's ``[B, J]`` or ``[B, J, 3]`` value as a group of one."""
    return x.unsqueeze(-2) if x.dim() == 3 else x.unsqueeze(-1)


def slot_activity(joints):
    """``[..., J, 21]`` bool: the row slots each joint uses (set_row's
    activity masks), from the joint table's axis bits and `enabled`."""
    locked_b = joints.locked_axes
    motor_b = joints.motor_axes & ~locked_b
    limit_b = joints.limit_axes & ~locked_b
    coupled_b = joints.coupled_axes
    ang_coupled = (coupled_b >> 3) & 0b111
    n_ang = (ang_coupled & 1) + ((ang_coupled >> 1) & 1) + ((ang_coupled >> 2) & 1)
    lin_motor_c = (motor_b & coupled_b & JOINT_LIN_AXES) != 0
    act = torch.cat([
        _bits(motor_b & ~coupled_b, 3, 3),                    # 0-2
        _bits(motor_b & ~coupled_b, 0, 3),                    # 3-5
        lin_motor_c.unsqueeze(-1),                            # 6
        _bits(locked_b, 3, 3),                                # 7-9
        _bits(locked_b, 0, 3),                                # 10-12
        _bits(limit_b & ~coupled_b, 3, 3),                    # 13-15
        _bits(limit_b & ~coupled_b, 0, 3),                    # 16-18
        (((limit_b & coupled_b & JOINT_LIN_AXES) != 0) & ~lin_motor_c).unsqueeze(-1),
        (((limit_b & coupled_b & JOINT_ANG_AXES) != 0) & (n_ang == 2)).unsqueeze(-1),
    ], dim=-1)
    valid = joints.enabled & (joints.body1 >= 0) & (joints.body2 >= 0)
    return act & valid.unsqueeze(-1)


def used_slots(joints) -> tuple:
    """The row slots some joint of the table uses, ascending (a host read)."""
    used = slot_activity(joints).reshape(-1, R).any(dim=0)
    return tuple(torch.nonzero(used).flatten().tolist())


def build_rows(joints, sb, color, dt, inv_dt, n_bodies: int, slots: tuple) -> JointRows:
    """The row slots `slots` (`used_slots` of the table, or more) from the
    current solver poses (one substep)."""
    sent = n_bodies
    b1 = torch.where(joints.body1 >= 0, joints.body1, sent).long()
    b2 = torch.where(joints.body2 >= 0, joints.body2, sent).long()
    valid = joints.enabled & (joints.body1 >= 0) & (joints.body2 >= 0)

    com1, rot1, im1 = _rows(sb.com, b1), _rows(sb.rot, b1), _rows(sb.im, b1)
    com2, rot2, im2 = _rows(sb.com, b2), _rows(sb.rot, b2), _rows(sb.im, b2)
    ii1 = gather_cols(sb.ii.flatten(1, 2), b1).transpose(1, 2).unflatten(-1, (3, 3))
    ii2 = gather_cols(sb.ii.flatten(1, 2), b2).transpose(1, 2).unflatten(-1, (3, 3))

    # Joint frames in world space (local anchors are in COM space).
    f1_pos = com1 + quat.rotate(rot1, joints.local_pos1)
    f1_rot = quat.mul(rot1, joints.local_rot1)
    f2_pos = com2 + quat.rotate(rot2, joints.local_pos2)
    f2_rot = quat.mul(rot2, joints.local_rot2)
    basis = quat.to_matrix(f1_rot)                  # [B, J, 3, 3], columns = axes
    ax = basis.transpose(-1, -2)                    # rows = axes
    lin_err = f2_pos - f1_pos
    proj = _dot(ax, lin_err.unsqueeze(-2))          # [B, J, 3] error along each axis

    # Frame 1's centre snaps to frame 2 along the locked linear axes
    # (joint_constraint_builder.rs:247-260).
    locked_b = joints.locked_axes
    lockf = _bits(locked_b, 0, 3).to(lin_err.dtype)
    new_c1 = f2_pos
    for i in range(3):
        new_c1 = new_c1 - ax[..., i, :] * (proj[..., i] * lockf[..., i]).unsqueeze(-1)
    r1 = (new_c1 - com1).unsqueeze(-2).expand_as(ax)
    r2 = (f2_pos - com2).unsqueeze(-2).expand_as(ax)
    cm1 = quat.cross(r1, ax)                        # rows: r1 x axis_i
    cm2 = quat.cross(r2, ax)

    # Angular error q_err = q1^-1 q2, shortest-path sign corrected.
    q_err = quat.mul(quat.conj(f1_rot), f2_rot)
    sgn = torch.where(torch.sum(f1_rot * f2_rot, dim=-1, keepdim=True) >= 0, 1.0, -1.0)
    q_err = q_err * sgn
    v_err, w_err = q_err[..., :3], q_err[..., 3]
    # Row i of the angular basis: R1 (0.5 (w e_i - e_i x v)), the jacobian of
    # imag(q_err) w.r.t. (w2 - w1).
    eye = torch.eye(3, device=v_err.device).expand(ax.shape)
    cols = 0.5 * (w_err[..., None, None] * eye
                  - quat.cross(eye, v_err.unsqueeze(-2).expand_as(ax)))
    angax = torch.einsum("...ab,...ib->...ia", basis, cols)

    erp_j = spring_erp_inv_dt(joints.softness_frequency, joints.softness_damping, dt)
    cfm_j = spring_cfm_coeff(joints.softness_frequency, joints.softness_damping, dt)
    erp3, cfm3 = erp_j.unsqueeze(-1), cfm_j.unsqueeze(-1)

    limit_b = joints.limit_axes & ~locked_b
    coupled_b = joints.coupled_axes
    # +-inf default limits would poison arithmetic in rows that are computed
    # but masked off: clamp to finite sentinels.
    lmin = torch.clamp(joints.limit_min, -1e9, 1e9)
    lmax = torch.clamp(joints.limit_max, -1e9, 1e9)
    mmax = torch.clamp(joints.motor_max_force, 0.0, 3.0e38)
    model, stiff, damp = joints.motor_model, joints.motor_stiffness, joints.motor_damping
    tpos, tvel = joints.motor_target_pos, joints.motor_target_vel

    bsz, nj = valid.shape
    z3 = torch.zeros_like(proj)                       # [B, J, 3]
    zv3 = torch.zeros_like(ax)                        # [B, J, 3, 3]
    big3 = torch.full_like(proj, _BIG)
    groups = []   # per slot group: (lin, ang1, ang2, rwb, rb, cfm_c, cfm_g, lo, hi)

    # Slots 0-2: angular motors.
    m_erp, m_cc, m_cg = motor_coefficients(model[..., 3:], stiff[..., 3:], damp[..., 3:], dt)
    s_err = torch.asin(torch.clamp(v_err, -1.0, 1.0)) * 2.0 - tpos[..., 3:]
    s_comp = s_err - torch.sign(s_err) * (2.0 * math.pi)
    s_err = torch.where(torch.abs(s_err) < torch.abs(s_comp), s_err, s_comp)
    rwb = torch.where(m_erp != 0.0, s_err * m_erp, 0.0) - tvel[..., 3:]
    max_imp = mmax[..., 3:] * dt
    groups.append((zv3, ax, ax, rwb, z3, m_cc, m_cg, -max_imp, max_imp))

    # Slots 3-5: linear motors.
    m_erp, m_cc, m_cg = motor_coefficients(model[..., :3], stiff[..., :3], damp[..., :3], dt)
    rwb = torch.where(m_erp != 0.0, (proj - tpos[..., :3]) * m_erp, 0.0)
    tv = tvel[..., :3]
    tv_cl = torch.clamp(tv, (lmin[..., :3] - proj) * inv_dt, (lmax[..., :3] - proj) * inv_dt)
    rwb = rwb - torch.where(_bits(limit_b, 0, 3), tv_cl, tv)
    max_imp = mmax[..., :3] * dt
    groups.append((ax, cm1, cm2, rwb, z3, m_cc, m_cg, -max_imp, max_imp))

    # Slot 6: coupled linear motor, parameters from the first coupled axis.
    lj, aj1, aj2, dist, fa = _coupled_lin(ax, cm1, cm2, lin_err, coupled_b)

    def take(arr):
        return torch.gather(arr, -1, fa)[..., 0]

    m_erp, m_cc, m_cg = motor_coefficients(take(model), take(stiff), take(damp), dt)
    rwb = torch.where(m_erp != 0.0, (dist - take(tpos)) * m_erp, 0.0)
    tv = take(tvel)
    tv_cl = torch.clamp(tv, (take(lmin) - dist) * inv_dt, (take(lmax) - dist) * inv_dt)
    has_lim = ((limit_b.unsqueeze(-1) >> fa) & 1)[..., 0] == 1
    rwb = rwb - torch.where(has_lim, tv_cl, tv)
    max_imp = take(mmax) * dt
    zero = torch.zeros_like(dist)
    groups.append(tuple(map(_one, (lj, aj1, aj2, rwb, zero, m_cc, m_cg, -max_imp, max_imp))))
    lin_coupled = (lj, aj1, aj2, dist, take(lmax))

    # Slots 7-9: angular locks.
    groups.append((zv3, angax, angax, z3, v_err * erp3, cfm3.expand_as(z3), z3,
                   -big3, big3))

    # Slots 10-12: linear locks.
    groups.append((ax, cm1, cm2, z3, proj * erp3, cfm3.expand_as(z3), z3, -big3, big3))

    # Slots 13-15: angular limits.
    s_min = torch.sin(lmin[..., 3:] * 0.5)
    s_max = torch.sin(lmax[..., 3:] * 0.5)
    rb = (torch.clamp(v_err - s_max, min=0.0) - torch.clamp(s_min - v_err, min=0.0)) * erp3
    groups.append((zv3, angax, angax, z3, rb, cfm3.expand_as(z3), z3,
                   torch.where(v_err <= s_min, -_BIG, 0.0),
                   torch.where(s_max <= v_err, _BIG, 0.0)))

    # Slots 16-18: linear limits.
    rb = (torch.clamp(proj - lmax[..., :3], min=0.0)
          - torch.clamp(lmin[..., :3] - proj, min=0.0)) * erp3
    groups.append((ax, cm1, cm2, z3, rb, cfm3.expand_as(z3), z3,
                   torch.where(proj <= lmin[..., :3], -_BIG, 0.0),
                   torch.where(lmax[..., :3] <= proj, _BIG, 0.0)))

    # Slot 19: coupled linear limit.
    lj, aj1, aj2, dist, lmax_c = lin_coupled
    groups.append(tuple(map(_one, (
        lj, aj1, aj2, torch.clamp(dist - lmax_c, max=0.0) * inv_dt,
        torch.clamp(dist - lmax_c, min=0.0) * erp_j, cfm_j, zero, zero,
        torch.full_like(dist, _BIG)))))

    # Slot 20: coupled angular limit (joint_constraint_builder.rs:814-874):
    # with exactly two coupled angular axes, the arc angle between the two
    # frames' non-coupled axis.
    ang_coupled = (coupled_b >> 3) & 0b111
    nc = torch.where((ang_coupled & 1) == 0, 0,
                     torch.where((ang_coupled & 2) == 0, 1,
                                 torch.where((ang_coupled & 4) == 0, 2, 0)))
    pick = nc.long()[..., None, None].expand(bsz, nj, 1, 3)
    axis1 = torch.gather(ax, -2, pick)[..., 0, :]
    axis2 = torch.gather(quat.to_matrix(f2_rot).transpose(-1, -2), -2, pick)[..., 0, :]
    cr = quat.cross(axis1, axis2)
    s = torch.linalg.norm(cr, dim=-1)
    angle = torch.atan2(s, torch.clamp(_dot(axis1, axis2), -1.0, 1.0))
    ex = torch.tensor([1.0, 0.0, 0.0], device=axis1.device).expand_as(axis1)
    ey = torch.tensor([0.0, 1.0, 0.0], device=axis1.device).expand_as(axis1)
    fx, fy = quat.cross(axis1, ex), quat.cross(axis1, ey)
    fb = torch.where((torch.sum(fx * fx, dim=-1) > 1e-8).unsqueeze(-1), fx, fy)
    aj = torch.where(
        (s > 1e-8).unsqueeze(-1), cr / torch.clamp(s, min=1e-12).unsqueeze(-1),
        fb / torch.clamp(torch.linalg.norm(fb, dim=-1, keepdim=True), min=1e-9))
    fa_c = torch.where((ang_coupled & 1) != 0, 3,
                       torch.where((ang_coupled & 2) != 0, 4, 5)).long().unsqueeze(-1)
    lmin_c = torch.gather(lmin, -1, fa_c)[..., 0]
    lmax_c = torch.gather(lmax, -1, fa_c)[..., 0]
    rb = (torch.clamp(angle - lmax_c, min=0.0) - torch.clamp(lmin_c - angle, min=0.0)) * erp_j
    groups.append(tuple(map(_one, (
        torch.zeros_like(aj), aj, aj, zero, rb, cfm_j, zero,
        torch.where(angle <= lmin_c, -_BIG, 0.0), torch.where(lmax_c <= angle, _BIG, 0.0)))))

    # Stack the slots; set_row's masking: an inactive row is zero, and
    # non-finite payloads are cleaned.
    (lin_jac, ang_jac1, ang_jac2, rwb, rb, cfm_c, cfm_g, lo, hi) = (
        torch.cat(parts, dim=2) for parts in zip(*groups))
    idx = torch.tensor(slots, dtype=torch.long, device=valid.device)
    active = slot_activity(joints)[:, :, idx]
    af = active.to(lin_jac.dtype)

    def clean(x):
        x = x[:, :, idx]
        if x.dim() == 4:
            return torch.where(torch.isfinite(x), x, 0.0) * af.unsqueeze(-1)
        return torch.where(torch.isfinite(x), x, 0.0) * af

    lin_jac, ang_jac1, ang_jac2 = clean(lin_jac), clean(ang_jac1), clean(ang_jac2)
    rhs_wo_bias, rhs_bias, cfm_coeff, cfm_gain = clean(rwb), clean(rb), clean(cfm_c), clean(cfm_g)
    lo = torch.where(active, torch.clamp(lo[:, :, idx], min=-_BIG), 0.0)
    hi = torch.where(active, torch.clamp(hi[:, :, idx], max=_BIG), 0.0)

    ii_ang_jac1 = torch.einsum("...ab,...rb->...ra", ii1, ang_jac1)
    ii_ang_jac2 = torch.einsum("...ab,...rb->...ra", ii2, ang_jac2)

    # Masked modified Gram-Schmidt per group (finalize_constraints): row p's
    # projection leaves every later row of its group at once.
    imsum = (im1 + im2).unsqueeze(-2)
    rhs = rhs_wo_bias + rhs_bias
    inv_lhs = torch.zeros_like(rhs)
    n_a = sum(1 for s_ in slots if s_ < _GROUP_B)
    for start, end in ((0, n_a), (n_a, len(slots))):
        for p in range(start, end):
            lj, a1, a2 = lin_jac[:, :, p], ang_jac1[:, :, p], ang_jac2[:, :, p]
            ia1, ia2 = ii_ang_jac1[:, :, p], ii_ang_jac2[:, :, p]
            imlj = imsum[:, :, 0] * lj
            dot_jj = _dot(lj, imlj) + _dot(ia1, a1) + _dot(ia2, a2)
            cg = dot_jj * cfm_coeff[:, :, p] + cfm_gain[:, :, p]
            inv_dot_jj = torch.where(dot_jj > 1e-12, 1.0 / torch.clamp(dot_jj, min=1e-12), 0.0)
            inv_lhs[:, :, p] = torch.where(dot_jj + cg > 1e-12,
                                           1.0 / torch.clamp(dot_jj + cg, min=1e-12), 0.0)
            cfm_gain[:, :, p] = cg
            if p + 1 == end:
                continue
            sl = slice(p + 1, end)
            unbounded = (lo[:, :, p] <= -_BIG) & (hi[:, :, p] >= _BIG) & active[:, :, p]
            dot_ij = (_dot(lin_jac[:, :, sl], imlj.unsqueeze(-2))
                      + _dot(ii_ang_jac1[:, :, sl], a1.unsqueeze(-2))
                      + _dot(ii_ang_jac2[:, :, sl], a2.unsqueeze(-2)))
            coeff = torch.where(unbounded.unsqueeze(-1) & active[:, :, sl],
                                dot_ij * inv_dot_jj.unsqueeze(-1), 0.0)
            c3 = coeff.unsqueeze(-1)
            lin_jac[:, :, sl] -= lj.unsqueeze(-2) * c3
            ang_jac1[:, :, sl] -= a1.unsqueeze(-2) * c3
            ang_jac2[:, :, sl] -= a2.unsqueeze(-2) * c3
            ii_ang_jac1[:, :, sl] -= ia1.unsqueeze(-2) * c3
            ii_ang_jac2[:, :, sl] -= ia2.unsqueeze(-2) * c3
            rhs[:, :, sl] -= rhs[:, :, p:p + 1] * coeff
            rhs_wo_bias[:, :, sl] -= rhs_wo_bias[:, :, p:p + 1] * coeff

    # dvel = lin . (v2 - v1) + ang2 . w2 - ang1 . w1; a unit impulse moves
    # v1 by lin * im1, w1 by ii ang1, v2 by -lin * im2, w2 by -ii ang2.
    jac = torch.cat([-lin_jac, -ang_jac1, lin_jac, ang_jac2], dim=-1)
    mob = torch.cat([lin_jac * im1.unsqueeze(-2), ii_ang_jac1,
                     -lin_jac * im2.unsqueeze(-2), -ii_ang_jac2], dim=-1)
    return JointRows(
        b1=b1, b2=b2, valid=valid, color=color, im1=im1, im2=im2,
        lin_jac=lin_jac, ang_jac1=ang_jac1, ang_jac2=ang_jac2,
        ii_ang_jac1=ii_ang_jac1, ii_ang_jac2=ii_ang_jac2,
        rhs=rhs, rhs_wo_bias=rhs_wo_bias, cfm_gain=cfm_gain, inv_lhs=inv_lhs,
        lo=lo, hi=hi, impulse=torch.zeros_like(rhs), active=active, slots=slots,
        jac=jac, mob=mob)


def full_slots(x, slots):
    """A kept-slot tensor ``[B, J, S, ...]`` in the 21-slot layout, zero
    (False) in the slots left out."""
    out = x.new_zeros(x.shape[:2] + (R,) + x.shape[3:])
    out[:, :, list(slots)] = x
    return out


def segment_route(b1, b2, n_bodies: int) -> RoutePlan:
    """The fixed-order scatter of the deltas of joints with solver bodies
    ``b1, b2 [B, J]`` into the ``[B, d, N+1]`` body tables (built once a
    step: the joints' bodies do not change)."""
    return RoutePlan(seg_pair=make_segment_plan(torch.cat([b1, b2], dim=-1), n_bodies + 1))


def solve_color(rows: JointRows, sb, color_id, *, use_bias: bool, route: RoutePlan):
    """Solve the kept row slots of the joints of one color in order
    (joint_velocity_constraint.rs:101-123 solve_generic)."""
    if not rows.slots:
        return rows, sb
    mask = rows.valid & (rows.color == color_id)
    vw = torch.cat([sb.v_lin, sb.v_ang], dim=1)                  # [B, 6, N+1]
    vel0 = torch.cat([gather_cols(vw, rows.b1), gather_cols(vw, rows.b2)],
                     dim=1).transpose(1, 2)                       # [B, J, 12]
    vel = vel0
    act = (mask.unsqueeze(-1) & rows.active).to(vel.dtype)
    rhs_all = rows.rhs if use_bias else rows.rhs_wo_bias
    imps = list(rows.impulse.unbind(-1))
    for r in range(len(rows.slots)):
        imp = imps[r]
        rhs = _dot(rows.jac[:, :, r], vel) + rhs_all[:, :, r]
        total = torch.clamp(
            imp + rows.inv_lhs[:, :, r] * (rhs - rows.cfm_gain[:, :, r] * imp),
            rows.lo[:, :, r], rows.hi[:, :, r])
        dl = (total - imp) * act[:, :, r]
        imps[r] = imp + dl
        vel = vel + rows.mob[:, :, r] * dl.unsqueeze(-1)

    d = ((vel - vel0) * mask.unsqueeze(-1).to(vel.dtype)).transpose(1, 2)   # [B, 12, J]
    vw = scatter_add_pair(vw, rows.b1, rows.b2, d[:, 0:6], d[:, 6:12], route)
    impulse = torch.where(mask.unsqueeze(-1), torch.stack(imps, dim=-1), rows.impulse)
    return rows._replace(impulse=impulse), sb._replace(v_lin=vw[:, 0:3], v_ang=vw[:, 3:6])
