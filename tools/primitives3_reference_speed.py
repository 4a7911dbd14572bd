"""The reference's (rapier_tpu, JAX) run of one primitives3 scene on the
CPU: `rapier_tpu_torch.scenes.primitives3_world(5, 5)` built with the
reference's builders, max_pairs 512, max_solver_pairs 256,
solver_backend="pallas", stepped 120 steps; prints every 10 steps the
fastest body's speed, the bodies' lowest and highest centre, and the
step's unsupported pairs and overflows.  chip_smoke.py's phase 12 bounds
the port's fastest body after its untimed steps by twice this run's at
that step.

    JAX_PLATFORMS=cpu python tools/primitives3_reference_speed.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

import rapier_tpu.world as rw  # noqa: E402


def primitives3(num_layers, grid, rad=1.0, **kw):
    """The scene of `rapier_tpu_torch.scenes.primitives3_world`, with the
    reference's builders."""
    w = rw.PhysicsWorld(**kw)
    g = w.insert_body(rw.RigidBodyBuilder.fixed().with_translation((0.0, -2.1, 0.0)))
    w.insert_collider(rw.ColliderBuilder.cuboid(100.1, 2.1, 100.1), g)
    shift, offset, cb = 3.0 * rad, 0.0, rw.ColliderBuilder
    center = shift * (grid // 2)
    for j in range(num_layers):
        for i in range(grid):
            for k in range(grid):
                b = w.insert_body(rw.RigidBodyBuilder.dynamic().with_translation(
                    (i * shift - center + offset, j * shift + shift / 2.0 + 3.0,
                     k * shift - center + offset)))
                kind = j % 5
                w.insert_collider(
                    cb.ball(rad) if kind == 1 else cb.round_cylinder(rad, rad, rad / 10.0)
                    if kind == 2 else cb.cone(rad, rad) if kind == 3 else cb.capsule_y(rad, rad),
                    b)
        offset -= 0.05 * rad * (grid - 1)
    return w


def main():
    w = primitives3(5, 5, max_pairs=512)
    w.params = w.params.replace(solver_backend="pallas", max_solver_pairs=256)
    w.build()
    n = 1 + 5 * 5 * 5
    for s in range(1, 121):
        w.step(1)
        if s % 10 == 0:
            v = np.asarray(w.state.bodies.linvel)[1:n]
            y = np.asarray(w.state.bodies.pos)[1:n, 1]
            ev = w.last_events
            print(f"step {s}: fastest body {float(np.linalg.norm(v, axis=1).max()):.4f} m/s, "
                  f"heights {float(y.min()):.4f} to {float(y.max()):.4f}, unsupported "
                  f"{int(ev.unsupported_pairs)}, broad-phase overflow "
                  f"{int(ev.broadphase_overflow)}, solver overflow {int(ev.solver_overflow)}",
                  flush=True)


if __name__ == "__main__":
    main()
