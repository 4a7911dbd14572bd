"""Host-side (numpy) analytic mass properties per shape.

Counterpart of rapier_tpu.geometry.mass_properties for the shapes the port
covers (ball, cuboid, capsule at any endpoints; a halfspace has no mass).  Runs at scene-build time; the results are
accumulated onto the parent bodies by `combine`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from rapier_tpu_torch.types import ShapeType


@dataclass
class MassProperties:
    mass: float
    com: np.ndarray                # (3,) collider-local
    principal_inertia: np.ndarray  # (3,) about COM, principal frame
    principal_frame: np.ndarray    # (4,) quaternion (x, y, z, w)


def _identity_quat():
    return np.array([0.0, 0.0, 0.0, 1.0])


def _quat_from_two_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Shortest-arc quaternion rotating unit vector a onto unit vector b."""
    c = np.cross(a, b)
    d = float(np.dot(a, b))
    if d < -1.0 + 1e-9:
        perp = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(perp) < 1e-9:
            perp = np.cross(a, [0.0, 1.0, 0.0])
        perp /= np.linalg.norm(perp)
        return np.array([perp[0], perp[1], perp[2], 0.0])
    q = np.array([c[0], c[1], c[2], 1.0 + d])
    return q / np.linalg.norm(q)


def shape_mass_properties(shape_type: int, params: np.ndarray,
                          density: float) -> MassProperties:
    """Analytic mass properties of a ball, cuboid or capsule; a halfspace
    contributes no mass."""
    st = ShapeType(shape_type)
    if st == ShapeType.HALFSPACE:
        return MassProperties(0.0, np.zeros(3), np.zeros(3), _identity_quat())
    if st == ShapeType.BALL:
        r = float(params[0])
        m = density * 4.0 / 3.0 * math.pi * r**3
        i = 2.0 / 5.0 * m * r * r
        return MassProperties(m, np.zeros(3), np.full(3, i), _identity_quat())
    if st == ShapeType.CUBOID:
        hx, hy, hz = float(params[0]), float(params[1]), float(params[2])
        m = density * 8.0 * hx * hy * hz
        ix = m / 3.0 * (hy * hy + hz * hz)
        iy = m / 3.0 * (hx * hx + hz * hz)
        iz = m / 3.0 * (hx * hx + hy * hy)
        return MassProperties(m, np.zeros(3), np.array([ix, iy, iz]),
                              _identity_quat())
    if st == ShapeType.CAPSULE:
        a, b = params[0:3].astype(float), params[3:6].astype(float)
        r = float(params[6])
        h = float(np.linalg.norm(b - a))
        mc = density * math.pi * r * r * h
        ms = density * 4.0 / 3.0 * math.pi * r**3
        m = mc + ms
        i_axis = mc * r * r / 2.0 + ms * 2.0 / 5.0 * r * r
        i_perp = (
            mc * (h * h / 12.0 + r * r / 4.0)
            + ms * (2.0 / 5.0 * r * r + h * h / 4.0 + 3.0 / 8.0 * h * r)
        )
        com = 0.5 * (a + b)
        if h > 1e-12:
            frame = _quat_from_two_vectors(np.array([0.0, 1.0, 0.0]), (b - a) / h)
        else:
            frame = _identity_quat()
        return MassProperties(m, com, np.array([i_perp, i_axis, i_perp]), frame)
    raise NotImplementedError(f"mass properties of {st.name} are not ported")


def _quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    u, w = q[:3], q[3]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _rot_matrix(q) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _inertia_tensor(mp: MassProperties) -> np.ndarray:
    rm = _rot_matrix(mp.principal_frame)
    return rm @ np.diag(mp.principal_inertia) @ rm.T


def combine(parts: list) -> MassProperties:
    """Sum shape mass properties given at (pos, rot) poses in a body frame;
    returns body-frame properties with a diagonalised principal frame."""
    total_m = 0.0
    com = np.zeros(3)
    for mp, pos, rot in parts:
        total_m += mp.mass
        com += mp.mass * (pos + _quat_rotate(rot, mp.com))
    if total_m <= 0.0:
        return MassProperties(0.0, np.zeros(3), np.zeros(3), _identity_quat())
    com /= total_m

    itot = np.zeros((3, 3))
    for mp, pos, rot in parts:
        if mp.mass <= 0.0:
            continue
        rm = _rot_matrix(rot)
        i_local = rm @ _inertia_tensor(mp) @ rm.T
        d = pos + _quat_rotate(rot, mp.com) - com
        itot += i_local + mp.mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    evals, evecs = np.linalg.eigh(itot)
    if np.linalg.det(evecs) < 0:
        evecs[:, 0] = -evecs[:, 0]
    tr = np.trace(evecs)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (evecs[2, 1] - evecs[1, 2]) / s
        qy = (evecs[0, 2] - evecs[2, 0]) / s
        qz = (evecs[1, 0] - evecs[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(evecs)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(evecs[i, i] - evecs[j, j] - evecs[k, k] + 1.0, 1e-12)) * 2
        qv = [0.0, 0.0, 0.0]
        qv[i] = 0.25 * s
        qw = (evecs[k, j] - evecs[j, k]) / s
        qv[j] = (evecs[j, i] + evecs[i, j]) / s
        qv[k] = (evecs[k, i] + evecs[i, k]) / s
        qx, qy, qz = qv
    q = np.array([qx, qy, qz, qw])
    q /= np.linalg.norm(q)
    return MassProperties(total_m, com, np.maximum(evals, 0.0), q)
