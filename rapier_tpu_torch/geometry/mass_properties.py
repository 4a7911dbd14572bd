"""Host-side (numpy) analytic mass properties per shape.

Counterpart of rapier_tpu.geometry.mass_properties: ball, cuboid, capsule
at any endpoints, cylinder and cone (the round cuboid inflated by its
border, the round cylinder and round cone ignoring theirs, as the reference
approximates them), and triangle meshes by the divergence theorem
(`mesh_mass_properties`; a heightfield's open surface included, as the
reference computes it, and a convex hull's faces reoriented outward); flat
and unbounded shapes have no mass.  Runs at scene-build time; the results
are accumulated onto the parent bodies by `combine`.
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
    """Analytic mass properties of one shape at `density`.  Flat and
    unbounded shapes (segment, triangle, halfspace) have none, nor does the
    parameter row of a mesh or hull (`PhysicsWorld.build` calls
    `mesh_mass_properties` with its geometry)."""
    zero = MassProperties(0.0, np.zeros(3), np.zeros(3), _identity_quat())
    st = ShapeType(shape_type)
    if st == ShapeType.BALL:
        r = float(params[0])
        m = density * 4.0 / 3.0 * math.pi * r**3
        i = 2.0 / 5.0 * m * r * r
        return MassProperties(m, np.zeros(3), np.full(3, i), _identity_quat())
    if st in (ShapeType.CUBOID, ShapeType.ROUND_CUBOID):
        hx, hy, hz = float(params[0]), float(params[1]), float(params[2])
        if st == ShapeType.ROUND_CUBOID:
            br = float(params[3])
            hx, hy, hz = hx + br, hy + br, hz + br
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
    if st in (ShapeType.CYLINDER, ShapeType.ROUND_CYLINDER):
        hh, r = float(params[0]), float(params[1])
        big_h = 2.0 * hh
        m = density * math.pi * r * r * big_h
        i_axis = m * r * r / 2.0
        i_perp = m * (3.0 * r * r + big_h * big_h) / 12.0
        return MassProperties(m, np.zeros(3), np.array([i_perp, i_axis, i_perp]),
                              _identity_quat())
    if st in (ShapeType.CONE, ShapeType.ROUND_CONE):
        hh, r = float(params[0]), float(params[1])
        big_h = 2.0 * hh
        m = density * math.pi * r * r * big_h / 3.0
        # The centre of mass a quarter of the height above the base (-hh).
        com = np.array([0.0, -hh + big_h / 4.0, 0.0])
        i_axis = 3.0 / 10.0 * m * r * r
        i_perp = m * (3.0 / 20.0 * r * r + 3.0 / 80.0 * big_h * big_h)
        return MassProperties(m, com, np.array([i_perp, i_axis, i_perp]),
                              _identity_quat())
    return zero


def mesh_mass_properties(vertices: np.ndarray, triangles: np.ndarray,
                         density: float, assume_convex: bool = False) -> MassProperties:
    """Mass properties of a triangle mesh by the divergence theorem (the
    reference's mesh_mass_properties, parry's MassProperties::from_trimesh):
    signed tetrahedra against the origin, so the winding must be consistent
    and the surface closed for a physical result; an open surface (a
    heightfield) gives what the same sums give.  `assume_convex` reorients
    each face outward from the centroid."""
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64).copy()
    if assume_convex:
        centroid = v[np.unique(t)].mean(axis=0)
        a0, b0, c0 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
        n = np.cross(b0 - a0, c0 - a0)
        flip = np.einsum("ij,ij->i", n, (a0 + b0 + c0) / 3.0 - centroid) < 0
        t[flip] = t[flip][:, [0, 2, 1]]
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]

    # Signed volume of each origin tetrahedron: det([a b c]) / 6.
    d6 = np.einsum("ij,ij->i", a, np.cross(b, c))
    vol = d6.sum() / 6.0
    if vol < 0:   # inward winding: flip
        a, c = c, a
        d6 = -d6
        vol = -vol
    if vol < 1e-12:
        return MassProperties(0.0, np.zeros(3), np.zeros(3), _identity_quat())

    com = (d6[:, None] * (a + b + c)).sum(axis=0) / (4.0 * d6.sum())
    mass = density * vol

    # Inertia by the canonical tetrahedron integrals (Blow & Binstock 2004).
    def subexp(w0, w1, w2):
        f1 = w0 + w1 + w2
        f2 = w0 * w0 + w1 * (w0 + w1) + w2 * f1
        f3 = w0 * w0 * w0 + w0 * w0 * w1 + w0 * w1 * w1 + w1 * w1 * w1 + w2 * f2
        g0 = f2 + w0 * (f1 + w0)
        g1 = f2 + w1 * (f1 + w1)
        g2 = f2 + w2 * (f1 + w2)
        return f1, f2, f3, g0, g1, g2

    x0, y0, z0 = (a - com).T
    x1, y1, z1 = (b - com).T
    x2, y2, z2 = (c - com).T
    _, _, fx3, gx0, gx1, gx2 = subexp(x0, x1, x2)
    _, _, fy3, gy0, gy1, gy2 = subexp(y0, y1, y2)
    _, _, fz3, gz0, gz1, gz2 = subexp(z0, z1, z2)
    d0 = (y1 - y0) * (z2 - z0) - (y2 - y0) * (z1 - z0)
    d1 = (z1 - z0) * (x2 - x0) - (z2 - z0) * (x1 - x0)
    d2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)

    intg_x2 = (d0 * fx3).sum() / 60.0
    intg_y2 = (d1 * fy3).sum() / 60.0
    intg_z2 = (d2 * fz3).sum() / 60.0
    intg_xy = (d0 * (y0 * gx0 + y1 * gx1 + y2 * gx2)).sum() / 120.0
    intg_yz = (d1 * (z0 * gy0 + z1 * gy1 + z2 * gy2)).sum() / 120.0
    intg_zx = (d2 * (x0 * gz0 + x1 * gz1 + x2 * gz2)).sum() / 120.0

    ixx = density * (intg_y2 + intg_z2)
    iyy = density * (intg_x2 + intg_z2)
    izz = density * (intg_x2 + intg_y2)
    ixy = -density * intg_xy
    iyz = -density * intg_yz
    izx = -density * intg_zx
    i_mat = np.array([[ixx, ixy, izx], [ixy, iyy, iyz], [izx, iyz, izz]])
    evals, evecs = np.linalg.eigh(i_mat)
    if np.linalg.det(evecs) < 0:
        evecs[:, 0] = -evecs[:, 0]
    m = evecs
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = math.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        qw = (m[k, j] - m[j, k]) / s
        qx, qy, qz = q[0], q[1], q[2]
    frame = np.array([qx, qy, qz, qw], np.float32)
    n = np.linalg.norm(frame)
    frame = frame / n if n > 1e-9 else _identity_quat()
    return MassProperties(float(mass), com.astype(np.float32),
                          np.maximum(evals, 0.0).astype(np.float32), frame)


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
