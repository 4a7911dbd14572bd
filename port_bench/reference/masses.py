"""Mass properties at unit density of the shapes the configurations' scenes
use, as rapier approximates them (a round cylinder as its inner cylinder, a
cone with its centre of mass a quarter of its height above the base), and the
shape ids of the port's `ShapeType` that a built state stores.  Each
configuration's plain layout (`configs/<name>.py`) builds on these."""

from __future__ import annotations

import math

BALL, CUBOID, CAPSULE, CONE, ROUND_CYLINDER = 0, 1, 2, 5, 9


def _mass(shape, prm):
    """(mass, principal inertia (x, y, z), centre of mass) at unit density."""
    if shape == BALL:
        r = prm[0]
        m = 4.0 / 3.0 * math.pi * r ** 3
        return m, (0.4 * m * r * r,) * 3, (0.0, 0.0, 0.0)
    if shape == CUBOID:
        hx, hy, hz = prm
        m = 8.0 * hx * hy * hz
        return m, (m / 3 * (hy * hy + hz * hz), m / 3 * (hx * hx + hz * hz),
                   m / 3 * (hx * hx + hy * hy)), (0.0, 0.0, 0.0)
    if shape == CAPSULE:
        hh, r = prm[4], prm[6]
        h = 2.0 * hh
        mc, ms = math.pi * r * r * h, 4.0 / 3.0 * math.pi * r ** 3
        ia = mc * r * r / 2 + ms * 0.4 * r * r
        ip = mc * (h * h / 12 + r * r / 4) + ms * (0.4 * r * r + h * h / 4 + 3 / 8 * h * r)
        return mc + ms, (ip, ia, ip), (0.0, 0.0, 0.0)
    if shape == ROUND_CYLINDER:
        hh, r = prm[0], prm[1]
        m = math.pi * r * r * 2 * hh
        return m, (m * (3 * r * r + 4 * hh * hh) / 12, m * r * r / 2,
                   m * (3 * r * r + 4 * hh * hh) / 12), (0.0, 0.0, 0.0)
    if shape == CONE:
        hh, r = prm[0], prm[1]
        m = math.pi * r * r * 2 * hh / 3
        ip = m * (3 / 20 * r * r + 3 / 80 * 4 * hh * hh)
        return m, (ip, 0.3 * m * r * r, ip), (0.0, -hh / 2, 0.0)
    raise ValueError(f"no mass properties for shape {shape}")


def capsule_y(hh, r):
    """A capsule along local y: (shape, params) as the built state stores them."""
    return CAPSULE, (0.0, -hh, 0.0, 0.0, hh, 0.0, r)


def with_masses(bodies):
    """`bodies` (dicts with pos, shape, params, dynamic) with mass, inertia
    (principal, x y z) and com added to the dynamic ones."""
    for b in bodies:
        if b["dynamic"]:
            b["mass"], b["inertia"], b["com"] = _mass(b["shape"], b["params"])
    return bodies
