"""Quaternion and rigid-transform math (counterpart of rapier_tpu.math.quat).

Quaternions are ``(x, y, z, w)``.  The row-major functions take the
component axis LAST (``[..., 4]`` / ``[..., 3]``).  The ``_cl`` functions
take the component axis at dim -2 with the lane axis last (``[..., 3, P]``),
the reference's component-leading layout behind any leading scene axes.
"""

from __future__ import annotations

import torch


def identity(shape=(), device="cpu", dtype=torch.float32) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def from_axis_angle(axis, angle):
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = angle * 0.5
    s = torch.sin(half)
    return torch.cat([axis * s[..., None], torch.cos(half)[..., None]], dim=-1)


def from_scaled_axis(v, eps: float = 1e-12):
    angle = torch.linalg.norm(v, dim=-1, keepdim=True)
    axis = v / torch.clamp(angle, min=eps)
    half = angle * 0.5
    s = torch.where(angle > eps, torch.sin(half), torch.zeros_like(half))
    return torch.cat([axis * s, torch.cos(half)], dim=-1)


def to_scaled_axis(q, eps: float = 1e-9):
    q = torch.where(q[..., 3:4] < 0.0, -q, q)
    v = q[..., :3]
    s = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(s, q[..., 3:4])
    factor = torch.where(s < 1e-6, torch.full_like(s, 2.0),
                         angle / torch.clamp(s, min=eps))
    return v * factor


def mul(a, b):
    """Hamilton product a ⊗ b."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def normalize(q, eps: float = 1e-12):
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx],
                       dim=-1)


def rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q (q v q*)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def inv_rotate(q, v):
    return rotate(conj(q), v)


def to_matrix(q):
    """Quaternion -> rotation matrix ``[..., 3, 3]``."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def integrate_linearized(q, angvel, dt):
    """q' = normalize((ω·dt/2, 1) ⊗ q) (rigid_body_components.rs:805-819)."""
    h = angvel * (dt * 0.5)
    dq = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    return normalize(mul(dq, q))


def transform_point(pos, rot, p):
    return pos + rotate(rot, p)


def inverse_transform_point(pos, rot, p):
    return inv_rotate(rot, p - pos)


def compose(pos1, rot1, pos2, rot2):
    return pos1 + rotate(rot1, pos2), mul(rot1, rot2)


# -- component-leading (component axis at dim -2, lanes last) ---------------


def _c(a, i):
    return a[..., i, :]


def cross_cl(a, b):
    ax, ay, az = _c(a, 0), _c(a, 1), _c(a, 2)
    bx, by, bz = _c(b, 0), _c(b, 1), _c(b, 2)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx],
                       dim=-2)


def dot_cl(a, b):
    return _c(a, 0) * _c(b, 0) + _c(a, 1) * _c(b, 1) + _c(a, 2) * _c(b, 2)


def rotate_cl(q, v):
    u = q[..., :3, :]
    w = q[..., 3:4, :]
    t = 2.0 * cross_cl(u, v)
    return v + w * t + cross_cl(u, t)


def inv_rotate_cl(q, v):
    return rotate_cl(torch.cat([-q[..., :3, :], q[..., 3:4, :]], dim=-2), v)


def to_matrix_cl(q):
    """``[..., 4, P]`` -> ``[..., 3, 3, P]``."""
    x, y, z, w = _c(q, 0), _c(q, 1), _c(q, 2), _c(q, 3)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-2)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-2)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-2)
    return torch.stack([row0, row1, row2], dim=-3)


def mul_cl(a, b):
    ax, ay, az, aw = _c(a, 0), _c(a, 1), _c(a, 2), _c(a, 3)
    bx, by, bz, bw = _c(b, 0), _c(b, 1), _c(b, 2), _c(b, 3)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-2)


def normalize_cl(q, eps: float = 1e-12):
    n2 = _c(q, 0) * _c(q, 0) + _c(q, 1) * _c(q, 1) + _c(q, 2) * _c(q, 2) \
        + _c(q, 3) * _c(q, 3)
    return q / torch.clamp(torch.sqrt(n2), min=eps).unsqueeze(-2)


def integrate_linearized_cl(q, angvel, dt):
    h = angvel * (dt * 0.5)
    dq = torch.cat([h, torch.ones_like(h[..., :1, :])], dim=-2)
    return normalize_cl(mul_cl(dq, q))
