"""Reduced-coordinate multibody articulations (counterpart of
rapier_tpu.dynamics.multibody).

Every function takes the reference's per-scene arrays with a leading scene
axis: articulation fields are ``[B, M, L, ...]`` (M articulations of L padded
link slots, link 0 the root, parents before children), generalized vectors
``[B, M, L*6]`` in the fixed 6-slots-per-link layout with a free-axis mask,
body fields ``[B, N, ...]`` and solver-body tables ``[B, d, N+1]``.  The
arithmetic follows the reference term by term: forward kinematics, body
Jacobians by the parent-shift recursion, the augmented generalized mass
matrix, generalized forces (gravity, motors, limits, springs, damping,
armature), a Cholesky forward-dynamics solve, the dof couplings' projection
(`apply_couplings`), joint-space integration, the standalone sub-step
(`step_multibodies`), the three phases of two-way contact coupling around
the contact solve (A `predict_velocities`, B `install_link_mobility`, C
`absorb_contact_impulses`) and damped-least-squares inverse kinematics
(`inverse_kinematics`).

The reference computes all of this in plain `jnp`, outside its Pallas
kernels, so plain torch ops are the port: `cho_factor`/`cho_solve` become
`torch.linalg.cholesky`/`torch.cholesky_solve`, `jnp.linalg.solve`
`torch.linalg.solve`, the fixed-iteration `fori_loop` a Python loop, and
the one-hot routing einsums stay einsums (a one-hot product is exact).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from rapier_tpu_torch.math import quat

SPATIAL = 6


@dataclass
class Multibodies:
    """SoA articulation state, per scene ``[M, L, ...]`` (see the reference's
    Multibodies for the meaning of each field)."""

    link_valid: Any          # [M, L] bool
    link_parent: Any         # [M, L] int32
    link_body: Any           # [M, L] int32 (-1 pad)
    locked_axes: Any         # [M, L] int32 JointAxesMask bits
    kinematic: Any           # [M, L] bool
    contacts_enabled: Any    # [M, L] bool
    local_pos1: Any          # [M, L, 3]
    local_rot1: Any          # [M, L, 4]
    local_pos2: Any          # [M, L, 3]
    local_rot2: Any          # [M, L, 4]
    q: Any                   # [M, L, 6]
    joint_rot: Any           # [M, L, 4]
    qd: Any                  # [M, L*6]
    armature: Any            # [M, L, 6]
    damping: Any             # [M, L, 6]
    spring_stiffness: Any    # [M, L, 6]
    spring_ref: Any          # [M, L, 6]
    limit_min: Any           # [M, L, 6]
    limit_max: Any           # [M, L, 6]
    motor_target_pos: Any    # [M, L, 6]
    motor_target_vel: Any    # [M, L, 6]
    motor_stiffness: Any     # [M, L, 6]
    motor_damping: Any       # [M, L, 6]
    motor_max_force: Any     # [M, L, 6]
    coupling_a: Any          # [M, K] int32 (-1 inactive)
    coupling_b: Any          # [M, K] int32
    coupling_ratio: Any      # [M, K]
    coupling_offset: Any     # [M, K]

    @property
    def m(self) -> int:
        return self.link_valid.shape[-2]

    @property
    def l(self) -> int:
        return self.link_valid.shape[-1]

    @property
    def d6(self) -> int:
        return self.l * SPATIAL

    def replace(self, **kw) -> "Multibodies":
        return Multibodies(**{**vars(self), **kw})


def empty_multibodies(m: int, l: int, k_couplings: int = 4) -> Multibodies:
    """Host-side (numpy) empty articulation table, as the reference's."""
    def f(*s):
        return np.zeros(s, np.float32)

    qid = np.zeros((m, l, 4), np.float32)
    qid[..., 3] = 1.0
    return Multibodies(
        link_valid=np.zeros((m, l), bool),
        link_parent=np.zeros((m, l), np.int32),
        link_body=np.full((m, l), -1, np.int32),
        locked_axes=np.full((m, l), 0b111111, np.int32),
        kinematic=np.zeros((m, l), bool),
        contacts_enabled=np.ones((m, l), bool),
        local_pos1=f(m, l, 3), local_rot1=qid.copy(),
        local_pos2=f(m, l, 3), local_rot2=qid.copy(),
        q=f(m, l, 6), joint_rot=qid.copy(), qd=f(m, l * SPATIAL),
        armature=f(m, l, 6), damping=f(m, l, 6),
        spring_stiffness=f(m, l, 6), spring_ref=f(m, l, 6),
        limit_min=np.full((m, l, 6), -np.inf, np.float32),
        limit_max=np.full((m, l, 6), np.inf, np.float32),
        motor_target_pos=f(m, l, 6), motor_target_vel=f(m, l, 6),
        motor_stiffness=f(m, l, 6), motor_damping=f(m, l, 6),
        motor_max_force=np.full((m, l, 6), 3.4e38, np.float32),
        coupling_a=np.full((m, k_couplings), -1, np.int32),
        coupling_b=np.full((m, k_couplings), -1, np.int32),
        coupling_ratio=np.ones((m, k_couplings), np.float32),
        coupling_offset=f(m, k_couplings),
    )


def free_mask(mb: Multibodies) -> torch.Tensor:
    """``[B, M, L, 6]`` (the table's float dtype): 1 where the axis slot is a
    live generalized dof."""
    bits = torch.arange(6, dtype=mb.locked_axes.dtype, device=mb.locked_axes.device)
    locked = (mb.locked_axes.unsqueeze(-1) >> bits) & 1
    return (1 - locked).to(mb.q.dtype) * mb.link_valid.unsqueeze(-1)


def _cross_mat(v):
    """``[..., 3]`` -> ``[..., 3, 3]`` cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def _matvec(m, v):
    """``[..., a, b] @ [..., b]`` -> ``[..., a]``."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _take_link(x, idx):
    """``x [B, M, i, ...]`` at per-articulation link ``idx [B, M]``."""
    view = idx.long().view(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 2, view.expand(idx.shape + (1,) + x.shape[3:])).squeeze(2)


def _parent(mb: Multibodies, i: int):
    return torch.clamp(mb.link_parent[..., i], 0, i - 1)


def body_to_parent(mb: Multibodies):
    """Per-link child->parent pose (local_frame1 * T(lin) * R(joint_rot) *
    local_frame2^-1).  Returns (pos ``[B, M, L, 3]``, rot ``[B, M, L, 4]``)."""
    fm = free_mask(mb)
    lin = mb.q[..., :3] * fm[..., :3]
    inv_rot2 = quat.conj(mb.local_rot2)
    rot_jf2 = quat.mul(mb.joint_rot, inv_rot2)
    t_jf2 = quat.rotate(mb.joint_rot, quat.rotate(inv_rot2, -mb.local_pos2))
    t = lin + t_jf2
    pos = mb.local_pos1 + quat.rotate(mb.local_rot1, t)
    rot = quat.mul(mb.local_rot1, rot_jf2)
    return pos, rot


def forward_kinematics(mb: Multibodies, bodies, root_pos, root_rot):
    """Link world poses by walking the tree.  root_pos/rot ``[B, M, 3/4]``
    (fixed roots keep the body pose; free roots read it from q).  Returns
    (l2w_pos ``[B, M, L, 3]``, l2w_rot ``[B, M, L, 4]``)."""
    bp_pos, bp_rot = body_to_parent(mb)
    use_q_root = (torch.sum(free_mask(mb)[..., 0, :], dim=-1) > 0).unsqueeze(-1)
    pos_list = [torch.where(use_q_root, bp_pos[..., 0, :], root_pos)]
    rot_list = [torch.where(use_q_root, bp_rot[..., 0, :], root_rot)]
    for i in range(1, mb.l):
        par = _parent(mb, i)
        pp = _take_link(torch.stack(pos_list, dim=2), par)
        pr = _take_link(torch.stack(rot_list, dim=2), par)
        pos_list.append(pp + quat.rotate(pr, bp_pos[..., i, :]))
        rot_list.append(quat.mul(pr, bp_rot[..., i, :]))
    return torch.stack(pos_list, dim=2), torch.stack(rot_list, dim=2)


def _link_onehot(mb: Multibodies, valid, n: int):
    """``[B, M, L, N]`` link->body routing matrix + ``[B, N]`` is-link."""
    lb = torch.clamp(mb.link_body, 0, n - 1).long()
    ids = torch.arange(n, device=lb.device)
    oh = (lb.unsqueeze(-1) == ids).to(mb.q.dtype) * valid.unsqueeze(-1)
    return oh, torch.einsum("bmln->bn", oh) > 0


def _link_mass_props(mb: Multibodies, bodies):
    """Per-link mass, principal inertia, principal frame, local com and the
    valid mask, gathered from the body table (padded links get zeros)."""
    n = bodies.pos.shape[-2]
    valid = (mb.link_body >= 0) & mb.link_valid
    oh, _ = _link_onehot(mb, valid, n)
    inv_mass = torch.einsum("bmln,bn->bml", oh, bodies.inv_mass)
    mass = torch.where(inv_mass > 0, 1.0 / torch.clamp(inv_mass, min=1e-30), 0.0)
    local_com = torch.einsum("bmln,bnj->bmlj", oh, bodies.local_com)
    inv_pi = torch.einsum("bmln,bnj->bmlj", oh, bodies.inv_principal_inertia)
    pframe = torch.einsum("bmln,bnj->bmlj", oh, bodies.principal_frame)
    principal = torch.where(inv_pi > 0, 1.0 / torch.clamp(inv_pi, min=1e-30), 0.0)
    return mass, principal, pframe, local_com, valid


def _world_inertia(rot, pframe, principal):
    """I_world = R diag(I) R^T with R = link_rot * principal_frame."""
    mat = quat.to_matrix(quat.mul(rot, pframe))
    return torch.einsum("...ij,...j,...kj->...ik", mat, principal, mat)


def compute_jacobians(mb: Multibodies, l2w_pos, l2w_rot, bodies):
    """Body Jacobians ``[B, M, L, 6, D6]`` (rows: linear at the link COM,
    then angular; column k = link slot k // 6, axis k % 6), plus the link
    coms, joint anchors and mass properties."""
    bsz, m, l, d6 = mb.link_valid.shape[0], mb.m, mb.l, mb.d6
    dev, ft = l2w_pos.device, l2w_pos.dtype
    fm = free_mask(mb)
    mass, principal, pframe, local_com, valid = _link_mass_props(mb, bodies)
    coms = l2w_pos + quat.rotate(l2w_rot, local_com)
    anchors = l2w_pos + quat.rotate(l2w_rot, mb.local_pos2)

    jac_list = []
    for i in range(l):
        if i == 0:
            jac_parent = torch.zeros((bsz, m, SPATIAL, d6), dtype=ft, device=dev)
            par_rot = quat.identity((bsz, m), device=dev, dtype=ft)
            shift02 = torch.zeros((bsz, m, 3), dtype=ft, device=dev)
        else:
            par = _parent(mb, i)
            jac_parent = _take_link(torch.stack(jac_list, dim=2), par)
            par_rot = _take_link(l2w_rot[:, :, :i], par)
            shift02 = anchors[:, :, i] - _take_link(coms[:, :, :i], par)

        # v rows += (shift02^x)^T w rows.
        jv = jac_parent[..., :3, :] + (-_cross_mat(shift02)) @ jac_parent[..., 3:, :]
        jw = jac_parent[..., 3:, :]

        # Joint columns in this link's slots, in parent_rot * local_frame1.
        rotm = quat.to_matrix(quat.mul(par_rot, mb.local_rot1[:, :, i]))
        jcols = torch.zeros((bsz, m, SPATIAL, d6), dtype=ft, device=dev)
        jcols[..., 0:3, i * SPATIAL:i * SPATIAL + 3] = rotm * fm[:, :, i, None, :3]
        jcols[..., 3:6, i * SPATIAL + 3:(i + 1) * SPATIAL] = rotm * fm[:, :, i, None, 3:]
        jv = jv + jcols[..., :3, :]
        jw = jw + jcols[..., 3:, :]

        # Shift the velocity rows from the joint anchor to the link COM.
        shift23 = coms[:, :, i] - anchors[:, :, i]
        jv = jv + (-_cross_mat(shift23)) @ jw
        jac_list.append(torch.cat([jv, jw], dim=-2) * valid[:, :, i, None, None])

    jac = torch.stack(jac_list, dim=2)
    return jac, coms, anchors, mass, principal, pframe, valid


def live_mask(mb: Multibodies) -> torch.Tensor:
    """``[B, M, D6]`` f32: 1 where the flat dof slot is free and not
    kinematic."""
    fm = free_mask(mb).flatten(-2)
    kin = torch.repeat_interleave(mb.kinematic.to(fm.dtype), SPATIAL, dim=-1)
    return fm * (1.0 - kin)


def mass_matrix(mb: Multibodies, jac, l2w_rot, mass, principal, pframe,
                valid, body_angvel, dt):
    """Augmented generalized mass matrix ``[B, M, D6, D6]``: sum_l J^T M J
    with the gyroscopic derivative (dt), armature, implicit damping and motor
    damping (dt), implicit springs and motor stiffness (dt^2); locked and
    padded slots get identity rows."""
    d6 = mb.d6
    iw = _world_inertia(l2w_rot, pframe, principal)
    w = body_angvel
    gyro = _cross_mat(w) @ iw - _cross_mat(_matvec(iw, w))
    iw_aug = iw + gyro * dt
    jv = jac[..., :3, :]
    jw = jac[..., 3:, :]
    a = (torch.einsum("bmlak,bml,bmlaj->bmkj", jv, mass, jv)
         + torch.einsum("bmlak,bmlac,bmlcj->bmkj", jw, iw_aug, jw))
    live = live_mask(mb)
    diag_extra = (
        mb.armature.flatten(-2)
        + (mb.damping.flatten(-2) + mb.motor_damping.flatten(-2)) * dt
        + (mb.spring_stiffness.flatten(-2) + mb.motor_stiffness.flatten(-2)) * dt * dt
    )
    a = a * live.unsqueeze(-1) * live.unsqueeze(-2)
    diag = diag_extra * live + (1.0 - live)
    return a + torch.eye(d6, dtype=a.dtype, device=a.device) * diag.unsqueeze(-2)


def velocities_from_qd(mb: Multibodies, jac, qd=None):
    """Per-link world velocities ``[B, M, L, 6]`` = J qd."""
    qd = mb.qd if qd is None else qd
    return torch.einsum("bmlak,bmk->bmla", jac, qd)


def generalized_forces(mb: Multibodies, jac, coms, anchors, l2w_rot, mass,
                       principal, pframe, valid, bodies, gravity, dt):
    """Right-hand side of the forward-dynamics solve: J^T of the external
    and velocity-product forces, minus damping and springs, plus the clamped
    PD motors, masked to the live dofs."""
    bsz, m, l, d6 = mb.link_valid.shape[0], mb.m, mb.l, mb.d6
    dev = jac.device
    vel = velocities_from_qd(mb, jac)
    v_ang = vel[..., 3:]

    # Joint velocities (world) from each link's own-slot columns.
    qd_slots = mb.qd.reshape(bsz, m, l, SPATIAL)
    own_cols = torch.stack(
        [jac[:, :, i, :, i * SPATIAL:(i + 1) * SPATIAL] for i in range(l)], dim=2)
    jvel = torch.einsum("bmlas,bmls->bmla", own_cols, qd_slots)

    acc_list = []
    for i in range(l):
        if i == 0:
            acc = torch.zeros((bsz, m, SPATIAL), dtype=mb.q.dtype, device=dev)
        else:
            par = _parent(mb, i)
            acc_p = _take_link(torch.stack(acc_list, dim=2), par)
            w_p = _take_link(v_ang[:, :, :i], par)
            com_p = _take_link(coms[:, :, :i], par)
            shift02 = anchors[:, :, i] - com_p
            acc_lin = (
                acc_p[..., :3]
                + 2.0 * quat.cross(w_p, jvel[:, :, i, :3])
                + quat.cross(w_p, quat.cross(w_p, shift02))
                + quat.cross(acc_p[..., 3:], shift02)
            )
            acc_ang = acc_p[..., 3:] + quat.cross(w_p, jvel[:, :, i, 3:])
            acc = torch.cat([acc_lin, acc_ang], dim=-1)
        shift23 = coms[:, :, i] - anchors[:, :, i]
        w_i = v_ang[:, :, i]
        acc_lin2 = (acc[..., :3] + quat.cross(w_i, quat.cross(w_i, shift23))
                    + quat.cross(acc[..., 3:], shift23))
        acc_list.append(torch.cat([acc_lin2, acc[..., 3:]], dim=-1))
    accs = torch.stack(acc_list, dim=2)

    iw = _world_inertia(l2w_rot, pframe, principal)
    gyro = quat.cross(v_ang, _matvec(iw, v_ang))

    n = bodies.pos.shape[-2]
    oh, _ = _link_onehot(mb, valid, n)
    f_user = torch.einsum("bmln,bnj->bmlj", oh, bodies.force)
    t_user = torch.einsum("bmln,bnj->bmlj", oh, bodies.torque)
    gscale = torch.einsum("bmln,bn->bml", oh, bodies.gravity_scale)
    g = torch.as_tensor(np.asarray(gravity), dtype=mass.dtype, device=dev)
    f_ext_lin = (f_user + mass.unsqueeze(-1) * g * gscale.unsqueeze(-1)
                 - mass.unsqueeze(-1) * accs[..., :3])
    f_ext_ang = t_user - gyro - _matvec(iw, accs[..., 3:])
    f_spatial = torch.cat([f_ext_lin, f_ext_ang], dim=-1)
    tau = torch.einsum("bmlak,bmla->bmk", jac, f_spatial)

    q_flat = mb.q.flatten(-2)
    k = mb.spring_stiffness.flatten(-2)
    tau = (tau - mb.damping.flatten(-2) * mb.qd
           - k * (q_flat - mb.spring_ref.flatten(-2)) - k * dt * mb.qd)

    # Clamped PD motors; the position error at the predicted coordinate.
    ms = mb.motor_stiffness.flatten(-2)
    md = mb.motor_damping.flatten(-2)
    tmax = torch.clamp(mb.motor_max_force.flatten(-2), max=3.4e38)
    tau_motor = (ms * (mb.motor_target_pos.flatten(-2) - q_flat - dt * mb.qd)
                 + md * (mb.motor_target_vel.flatten(-2) - mb.qd))
    tau = tau + torch.minimum(torch.maximum(tau_motor, -tmax), tmax)
    return tau * live_mask(mb)


def forward_dynamics(mb: Multibodies, bodies, gravity, dt, root_pos, root_rot):
    """One generalized-coordinate dynamics update: (qdd ``[B, M, D6]``, aux
    with the poses, Jacobians and the Cholesky factor for reuse)."""
    l2w_pos, l2w_rot = forward_kinematics(mb, bodies, root_pos, root_rot)
    jac, coms, anchors, mass, principal, pframe, valid = compute_jacobians(
        mb, l2w_pos, l2w_rot, bodies)
    vel = velocities_from_qd(mb, jac)
    a = mass_matrix(mb, jac, l2w_rot, mass, principal, pframe, valid,
                    vel[..., 3:], dt)
    tau = generalized_forces(mb, jac, coms, anchors, l2w_rot, mass, principal,
                             pframe, valid, bodies, gravity, dt)
    chol = torch.linalg.cholesky(a + torch.eye(mb.d6, dtype=a.dtype, device=a.device) * 1e-9)
    qdd = torch.cholesky_solve(tau.unsqueeze(-1), chol).squeeze(-1)
    aux = dict(l2w_pos=l2w_pos, l2w_rot=l2w_rot, jac=jac, coms=coms,
               mass_mat=a, chol=chol, valid=valid)
    return qdd, aux


def apply_couplings(mb: Multibodies, qd, chol):
    """Project qd ``[B, M, D6]`` onto the dof couplings qd[a] = ratio * qd[b]
    in the mass-matrix metric: qd + A^-1 C^T lambda with C (qd + A^-1 C^T
    lambda) = 0, A's Cholesky factor `chol` from phase A.  Inactive slots get
    unit diagonals (plus 1e-9 on every diagonal) so the small solve stays
    regular; `coupling_offset` is a position-level term the velocity
    projection does not use.  Without an active coupling in the batch the
    projection is the identity, and qd is returned as it is."""
    d6, kc = mb.d6, mb.coupling_a.shape[-1]
    act = (mb.coupling_a >= 0) & (mb.coupling_b >= 0)                # [B, M, K]
    if not bool(torch.any(act)):
        return qd
    eye = torch.arange(d6, device=qd.device)
    ia = torch.clamp(mb.coupling_a, 0, d6 - 1).unsqueeze(-1)
    ib = torch.clamp(mb.coupling_b, 0, d6 - 1).unsqueeze(-1)
    ft = qd.dtype
    rows = ((ia == eye).to(ft)
            - mb.coupling_ratio.unsqueeze(-1) * (ib == eye).to(ft)
            ) * act.unsqueeze(-1)                                  # [B, M, K, D6]
    viol = torch.einsum("bmkd,bmd->bmk", rows, qd)
    aic = torch.cholesky_solve(rows.transpose(-1, -2), chol)       # [B, M, D6, K]
    s = torch.einsum("bmkd,bmdj->bmkj", rows, aic)
    inact = 1.0 - act.to(ft)
    s = s + torch.eye(kc, dtype=ft, device=qd.device) * (1e-9 + inact).unsqueeze(-2)
    lam = torch.linalg.solve(s, -viol.unsqueeze(-1)).squeeze(-1) * act
    return qd + torch.einsum("bmdj,bmj->bmd", aic, lam)


def integrate(mb: Multibodies, dt) -> Multibodies:
    """Joint-space integration: linear slots accumulate; one free angular
    axis rebuilds an axis-angle rotation, three compose a scaled-axis update;
    limits project the coordinates and stop the clipped dofs."""
    bsz, m, l = mb.link_valid.shape[0], mb.m, mb.l
    fm = free_mask(mb)
    qd_slots = mb.qd.reshape(bsz, m, l, SPATIAL) * fm
    q_new = mb.q + qd_slots * dt

    ang_free = fm[..., 3:]
    n_ang = torch.sum(ang_free, dim=-1, keepdim=True)
    axis = ang_free / torch.clamp(torch.linalg.norm(ang_free, dim=-1, keepdim=True),
                                  min=1e-9)
    rot1 = quat.from_axis_angle(axis, torch.sum(q_new[..., 3:] * ang_free, dim=-1))
    rot3 = quat.mul(quat.from_scaled_axis(qd_slots[..., 3:] * dt), mb.joint_rot)
    joint_rot = torch.where(n_ang > 2.5, rot3,
                            torch.where(n_ang > 0.5, rot1, mb.joint_rot))

    q_lim = torch.minimum(torch.maximum(q_new, mb.limit_min), mb.limit_max)
    clipped = (q_lim != q_new) & (fm > 0) & (n_ang < 2.5)
    q_new = torch.where(clipped, q_lim, q_new)
    rot1c = quat.from_axis_angle(axis, torch.sum(q_new[..., 3:] * ang_free, dim=-1))
    joint_rot = torch.where((n_ang > 0.5) & (n_ang < 2.5), rot1c, joint_rot)
    qd_new = torch.where(clipped, 0.0, qd_slots).reshape(bsz, m, mb.d6)
    return mb.replace(q=q_new, joint_rot=quat.normalize(joint_rot), qd=qd_new)


def write_back_bodies(mb: Multibodies, bodies, l2w_pos, l2w_rot, jac, valid,
                      next_only: bool = False):
    """Write link poses (body origin = link pose) and velocities (COM) into
    the rigid bodies; `next_only` writes only the next pose."""
    n = bodies.pos.shape[-2]
    oh, is_link = _link_onehot(mb, valid, n)
    il = is_link.unsqueeze(-1)

    def scatter(x):
        return torch.einsum("bmln,bmlk->bnk", oh, x)

    vel = velocities_from_qd(mb, jac)
    pos = torch.where(il, scatter(l2w_pos), bodies.pos)
    rotq = scatter(l2w_rot)
    rotq = rotq / torch.clamp(torch.linalg.norm(rotq, dim=-1, keepdim=True), min=1e-9)
    rot = torch.where(il, rotq, bodies.rot)
    out = dataclasses.replace(
        bodies,
        next_pos=torch.where(il, pos, bodies.next_pos),
        next_rot=torch.where(il, rot, bodies.next_rot))
    if next_only:
        return out
    return dataclasses.replace(
        out, pos=pos, rot=rot,
        linvel=torch.where(il, scatter(vel[..., :3]), bodies.linvel),
        angvel=torch.where(il, scatter(vel[..., 3:]), bodies.angvel))


def _root_pose(mb: Multibodies, bodies):
    n = bodies.pos.shape[-2]
    lb0 = torch.clamp(mb.link_body[..., 0], 0, n - 1).long()      # [B, M]
    root_pos = torch.gather(bodies.pos, 1, lb0.unsqueeze(-1).expand(lb0.shape + (3,)))
    root_rot = torch.gather(bodies.rot, 1, lb0.unsqueeze(-1).expand(lb0.shape + (4,)))
    return root_pos, root_rot


def step_multibodies(mb: Multibodies, bodies, gravity, dt, next_only: bool = False):
    """A multibody sub-step on its own: forward dynamics, the qd update, the
    couplings, joint integration, FK and the links' bodies (their next pose
    only with `next_only`).  Returns (mb, bodies, aux)."""
    root_pos, root_rot = _root_pose(mb, bodies)
    qdd, aux = forward_dynamics(mb, bodies, gravity, dt, root_pos, root_rot)
    mb = integrate(mb.replace(qd=apply_couplings(mb, mb.qd + qdd * dt, aux["chol"])), dt)
    l2w_pos, l2w_rot = forward_kinematics(mb, bodies, root_pos, root_rot)
    jac, _c, _a, _m, _pr, _pf, valid = compute_jacobians(mb, l2w_pos, l2w_rot, bodies)
    bodies = write_back_bodies(mb, bodies, l2w_pos, l2w_rot, jac, valid, next_only=next_only)
    return mb, bodies, aux


def predict_velocities(mb: Multibodies, bodies, gravity, dt):
    """Phase A: forward dynamics at the current pose -> tentative qd; the
    tentative link velocities J qd land in the bodies (poses not advanced).
    Returns (mb, bodies, aux)."""
    n = bodies.pos.shape[-2]
    root_pos, root_rot = _root_pose(mb, bodies)
    qdd, aux = forward_dynamics(mb, bodies, gravity, dt, root_pos, root_rot)
    qd = apply_couplings(mb, mb.qd + qdd * dt, aux["chol"])
    mb = mb.replace(qd=qd)
    vel = velocities_from_qd(mb, aux["jac"])
    oh, is_link = _link_onehot(mb, aux["valid"], n)
    il = is_link.unsqueeze(-1)
    bodies = dataclasses.replace(
        bodies,
        linvel=torch.where(il, torch.einsum("bmln,bmlk->bnk", oh, vel[..., :3]),
                           bodies.linvel),
        angvel=torch.where(il, torch.einsum("bmln,bmlk->bnk", oh, vel[..., 3:]),
                           bodies.angvel))
    aux["root_pos"] = root_pos
    aux["root_rot"] = root_rot
    return mb, bodies, aux


def link_mobility(mb: Multibodies, aux):
    """Articulated per-link mobility blocks Phi_ll = J_l A^-1 J_l^T: (im
    ``[B, M, L, 3]`` linear diagonal, ii ``[B, M, L, 3, 3]`` angular block)."""
    jac, chol = aux["jac"], aux["chol"]
    bsz, m, l, _, d6 = jac.shape
    jt = jac.reshape(bsz, m, l * SPATIAL, d6)
    x = torch.cholesky_solve(jt.transpose(-1, -2), chol).reshape(bsz, m, d6, l, SPATIAL)
    phi = torch.einsum("bmlad,bmdlc->bmlac", jac, x)
    phi = phi * aux["valid"][..., None, None]
    im_links = torch.clamp(torch.diagonal(phi[..., :3, :3], dim1=-2, dim2=-1), min=0.0)
    return im_links, phi[..., 3:, 3:]


def install_link_mobility(sb, mb: Multibodies, aux, bodies):
    """Phase B: the link columns of the solver-body tables ``[B, 3, N+1]`` /
    ``[B, 3, 3, N+1]`` take their articulated mobility."""
    n = bodies.pos.shape[-2]
    im_l, ii_l = link_mobility(mb, aux)
    oh, is_link = _link_onehot(mb, aux["valid"], n)
    im_n = torch.einsum("bmln,bmlk->bkn", oh, im_l)
    ii_n = torch.einsum("bmln,bmlac->bacn", oh, ii_l)
    ext = torch.cat([is_link, torch.zeros_like(is_link[:, :1])], dim=1)
    im = torch.where(ext.unsqueeze(1),
                     torch.cat([im_n, torch.zeros_like(im_n[..., :1])], dim=-1), sb.im)
    ii = torch.where(ext[:, None, None],
                     torch.cat([ii_n, torch.zeros_like(ii_n[..., :1])], dim=-1), sb.ii)
    return sb._replace(im=im, ii=ii)


def absorb_contact_impulses(mb: Multibodies, bodies, sb, aux, dt):
    """Phase C: dqd = A^-1 J^T M (v_post - J qd) from the solved link
    velocities, then joint integration, FK and the links' next poses and
    final velocities.  Returns (mb, bodies)."""
    n = bodies.pos.shape[-2]
    jac, chol, valid = aux["jac"], aux["chol"], aux["valid"]
    vel_t = velocities_from_qd(mb, jac)
    oh, is_link = _link_onehot(mb, valid, n)
    v_post_lin = torch.einsum("bmln,bkn->bmlk", oh, sb.v_lin[..., :n])
    v_post_ang = torch.einsum("bmln,bkn->bmlk", oh, sb.v_ang[..., :n])
    dv_lin = v_post_lin - vel_t[..., :3]
    dv_ang = v_post_ang - vel_t[..., 3:]

    mass, principal, pframe, _lc, _v = _link_mass_props(mb, bodies)
    iw = _world_inertia(aux["l2w_rot"], pframe, principal)
    p = torch.cat([mass.unsqueeze(-1) * dv_lin, _matvec(iw, dv_ang)], dim=-1)
    tau = torch.einsum("bmlak,bmla->bmk", jac, p)
    dqd = torch.cholesky_solve(tau.unsqueeze(-1), chol).squeeze(-1) * live_mask(mb)
    mb = mb.replace(qd=apply_couplings(mb, mb.qd + dqd, chol))
    mb = integrate(mb, dt)

    l2w_pos, l2w_rot = forward_kinematics(mb, bodies, aux["root_pos"], aux["root_rot"])
    jac2, _c, _a, _m, _pr, _pf, valid2 = compute_jacobians(mb, l2w_pos, l2w_rot, bodies)
    bodies = write_back_bodies(mb, bodies, l2w_pos, l2w_rot, jac2, valid2,
                               next_only=True)
    vel_f = velocities_from_qd(mb, jac2)
    il = is_link.unsqueeze(-1)
    bodies = dataclasses.replace(
        bodies,
        linvel=torch.where(il, torch.einsum("bmln,bmlk->bnk", oh, vel_f[..., :3]),
                           bodies.linvel),
        angvel=torch.where(il, torch.einsum("bmln,bmlk->bnk", oh, vel_f[..., 3:]),
                           bodies.angvel))
    return mb, bodies


def inverse_kinematics(mb: Multibodies, bodies, target_link, target_pos, target_rot, *,
                       damping: float = 1.0, max_iters: int = 10,
                       constrained_axes: int = 0b111111, eps_linear: float = 1.0e-3,
                       eps_angular: float = 1.0e-3, joint_can_move=None) -> Multibodies:
    """Move each articulation's `target_link` towards a world pose by
    `max_iters` damped-least-squares steps dq = J^T (J J^T + damping^2 I)^-1
    delta, each realised through the joint-space integrator (limits hold).

    target_link ``[B, M]`` (-1 leaves the articulation as it is),
    target_pos ``[B, M, 3]`` (the link body's origin), target_rot ``[B, M,
    4]``; `constrained_axes` the JointAxesMask bits of the pose axes solved
    for; `joint_can_move` ``[B, M, L]`` bool, False freezing a link's dofs.
    An articulation within eps_linear and eps_angular stops moving.  Returns
    the Multibodies with new q and joint_rot and qd as it was."""
    l = mb.l
    dev, ft = mb.q.device, mb.q.dtype
    act = target_link >= 0                                           # [B, M]
    link_oh = (torch.clamp(target_link, 0, l - 1).unsqueeze(-1)
               == torch.arange(l, device=dev)).to(ft) * act.unsqueeze(-1)
    axes = torch.tensor([float((constrained_axes >> k) & 1) for k in range(SPATIAL)],
                        dtype=ft, device=dev)
    if joint_can_move is None:
        col_mask = torch.ones(mb.qd.shape, dtype=ft, device=dev)
    else:
        col_mask = torch.repeat_interleave(joint_can_move.to(ft), SPATIAL, dim=-1)
    root_pos, root_rot = _root_pose(mb, bodies)
    saved_qd = mb.qd
    reg = (damping * damping) * torch.eye(SPATIAL, dtype=ft, device=dev)
    for _ in range(max_iters):
        l2w_pos, l2w_rot = forward_kinematics(mb, bodies, root_pos, root_rot)
        jac, coms, _a, _m, _pr, _pf, _v = compute_jacobians(mb, l2w_pos, l2w_rot, bodies)
        # The target link's rows, the linear ones moved from its COM to its
        # origin (v_o = v_com + w x (o - com)).
        jt = torch.einsum("bml,bmlak->bmak", link_oh, jac)          # [B, M, 6, D6]
        r = torch.einsum("bml,bmlk->bmk", link_oh, l2w_pos - coms)
        jt = torch.cat([jt[..., :3, :] + (-_cross_mat(r)) @ jt[..., 3:, :], jt[..., 3:, :]],
                       dim=-2) * col_mask.unsqueeze(-2)
        pose_p = torch.einsum("bml,bmlk->bmk", link_oh, l2w_pos)
        pose_r = quat.normalize(torch.einsum("bml,bmlk->bmk", link_oh, l2w_rot))
        delta = torch.cat([target_pos - pose_p,
                           quat.to_scaled_axis(quat.mul(target_rot, quat.conj(pose_r)))],
                          dim=-1) * axes
        live = act & ((torch.linalg.norm(delta[..., :3], dim=-1) > eps_linear)
                      | (torch.linalg.norm(delta[..., 3:], dim=-1) > eps_angular))
        jj = torch.einsum("bmak,bmck->bmac", jt, jt) + reg
        y = torch.linalg.solve(jj, delta.unsqueeze(-1)).squeeze(-1)
        dq = torch.einsum("bmak,bma->bmk", jt, y) * live.unsqueeze(-1).to(ft)
        mb = integrate(mb.replace(qd=dq), 1.0).replace(qd=mb.qd)
    return mb.replace(qd=saved_qd)
