"""PD / PID pose-tracking controllers for dynamic bodies (counterpart of
rapier_tpu.control.pid, the reference's PdController / PidController,
pid_controller.rs:14, :56).

The force and torque that drive each body towards a target pose and
velocity.  Gains are accelerations (scaled by mass and inertia), as the
reference's default.  Bodies and targets are ``[B, N, ...]``: every body of
every scene is controlled at once.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import BodyType

# Axis mask bits (the reference's PdErrors axes): linear xyz, angular xyz.
AXES_LIN = 0b000111
AXES_ANG = 0b111000
AXES_ALL = 0b111111


@dataclass(frozen=True)
class PdGains:
    lin_kp: float = 60.0
    lin_kd: float = 6.0
    ang_kp: float = 60.0
    ang_kd: float = 6.0
    axes: int = AXES_ALL


def rotation_error(rot, target_rot):
    """Rotation vector (axis x angle) taking `rot` to `target_rot`
    (``[..., 4]`` -> ``[..., 3]``)."""
    dq = quat.mul(target_rot, quat.conj(rot))
    dq = torch.where(dq[..., 3:4] < 0, -dq, dq)
    v = dq[..., :3]
    s = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(s[..., 0], dq[..., 3])
    return v / torch.clamp(s, min=1e-12) * angle.unsqueeze(-1)


def _mask(axes: int, shift: int, like):
    return torch.tensor([float(bool(axes & (1 << (shift + i)))) for i in range(3)],
                        dtype=like.dtype, device=like.device)


def _mass(bodies):
    im = bodies.inv_mass
    return torch.where(im > 0, 1.0 / torch.clamp(im, min=1e-12), 0.0)


def pd_force_and_torque(bodies, target_pos, target_rot, target_linvel, target_angvel,
                        gains: PdGains = PdGains()):
    """(force, torque) ``[B, N, 3]`` towards the targets (PdController);
    zero for bodies that are not dynamic."""
    lin_err = target_pos - bodies.pos
    ang_err = rotation_error(bodies.rot, target_rot)
    acc_lin = gains.lin_kp * lin_err + gains.lin_kd * (target_linvel - bodies.linvel)
    acc_ang = gains.ang_kp * ang_err + gains.ang_kd * (target_angvel - bodies.angvel)
    force = acc_lin * _mass(bodies).unsqueeze(-1) * _mask(gains.axes, 0, acc_lin)
    # Torque through the world inertia tensor R diag(I) R^T.
    m = quat.to_matrix(quat.mul(bodies.rot, bodies.principal_frame))
    ipi = bodies.inv_principal_inertia
    inertia = torch.where(ipi > 0, 1.0 / torch.clamp(ipi, min=1e-12), 0.0)
    i_world = torch.einsum("...ij,...j,...kj->...ik", m, inertia, m)
    torque = torch.einsum("...ij,...j->...i", i_world, acc_ang * _mask(gains.axes, 3, acc_ang))
    dyn = (bodies.body_type == BodyType.DYNAMIC).unsqueeze(-1)
    return torch.where(dyn, force, 0.0), torch.where(dyn, torque, 0.0)


@dataclass
class PidState:
    """Integral accumulators of the PID variant (PidController), ``[B, N, 3]``."""

    lin_integral: torch.Tensor
    ang_integral: torch.Tensor


def pid_force_and_torque(bodies, state: PidState, target_pos, target_rot, target_linvel,
                         target_angvel, dt, gains: PdGains = PdGains(), ki_lin: float = 0.0,
                         ki_ang: float = 0.0):
    """PID = PD + integral terms: (force, torque, new PidState)."""
    force, torque = pd_force_and_torque(bodies, target_pos, target_rot, target_linvel,
                                        target_angvel, gains)
    lin_i = state.lin_integral + (target_pos - bodies.pos) * dt
    ang_i = state.ang_integral + rotation_error(bodies.rot, target_rot) * dt
    force = force + ki_lin * lin_i * _mass(bodies).unsqueeze(-1)
    torque = torque + ki_ang * ang_i
    return force, torque, PidState(lin_integral=lin_i, ang_integral=ang_i)
