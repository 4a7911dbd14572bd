"""The reference's tests/test_2d_core.py scenarios on rapier_tpu_torch, on the CPU
(ROADMAP queue 1 item 2).

Each test builds its scene with the port's builders (`device="cpu"`), steps
it with the port's `PhysicsWorld` and keeps the reference test's own checks
and thresholds; batched leaves are read as ``[0, ...]`` (the port's state is
a batch of one scene).  Tests marked slow are so because the reference marks
the whole file slow (tests/conftest.py `_SLOW_MODULES`); the unmarked ones
run in tier-1 (none).

test_far_pyramid_stands_at_f64 is held on the port in
tests/test_torch_precision_scenes.py, beside the other f64 scenarios.
"""

import numpy as np
import pytest

from rapier_tpu_torch.world2d import (
    ColliderBuilder2D,
    PhysicsWorld2D,
    RigidBodyBuilder2D,
    pin_slot_joint_2d,
    revolute_joint_2d,
)


@pytest.mark.slow
def test_disc_inertia_is_2d():
    # Disc: m = pi r^2 rho, I = m r^2 / 2 (NOT the sphere's 2 m r^2 / 5).
    w = PhysicsWorld2D(device="cpu")
    b = w.insert_body(RigidBodyBuilder2D.dynamic())
    w.insert_collider(ColliderBuilder2D.ball(0.5).with_density(2.0), b)
    w.build()
    m = np.pi * 0.25 * 2.0
    i_z = 0.5 * m * 0.25
    np.testing.assert_allclose(
        1.0 / float(np.asarray(w.state.bodies.inv_mass[0])[b]), m, rtol=1e-5)
    np.testing.assert_allclose(
        1.0 / float(np.asarray(w.state.bodies.inv_principal_inertia[0])[b, 2]),
        i_z, rtol=1e-5)


@pytest.mark.slow
def test_box_inertia_is_2d():
    w = PhysicsWorld2D(device="cpu")
    b = w.insert_body(RigidBodyBuilder2D.dynamic())
    w.insert_collider(ColliderBuilder2D.cuboid(0.5, 0.3).with_density(1.0), b)
    w.build()
    m = 4 * 0.5 * 0.3
    i_z = m * (0.25 + 0.09) / 3.0
    np.testing.assert_allclose(
        1.0 / float(np.asarray(w.state.bodies.inv_principal_inertia[0])[b, 2]),
        i_z, rtol=1e-5)


@pytest.mark.slow
def test_pin_slot_joint_slides_and_spins():
    # PinSlot: slides along x and rotates, but cannot leave the slot line.
    w = PhysicsWorld2D(device="cpu", gravity=(0.0, -9.81))
    anchor = w.insert_body(RigidBodyBuilder2D.fixed().with_translation((0, 2)))
    b = w.insert_body(
        RigidBodyBuilder2D.dynamic().with_translation((0.0, 2.0))
        .with_linvel((2.0, 0.0)).with_angvel_scalar(5.0))
    w.insert_collider(ColliderBuilder2D.cuboid(0.3, 0.1).with_density(1.0), b)
    w.insert_impulse_joint(anchor, b, pin_slot_joint_2d(axis=(1.0, 0.0)))
    w.build()
    w.step(60)
    p = w.body_translation2(b)
    assert abs(p[1] - 2.0) < 1e-2, f"left the slot line: y={p[1]}"
    assert p[0] > 0.5, f"slide blocked: x={p[0]}"
    assert abs(w.body_rotation_angle(b)) > 0.5, "rotation was constrained"


@pytest.mark.slow
def test_revolute_2d_pendulum_conserves_anchor():
    w = PhysicsWorld2D(device="cpu")
    pivot = w.insert_body(RigidBodyBuilder2D.fixed().with_translation((0, 3)))
    bob = w.insert_body(RigidBodyBuilder2D.dynamic().with_translation((1, 3)))
    w.insert_collider(ColliderBuilder2D.ball(0.2).with_density(1.0), bob)
    w.insert_impulse_joint(
        pivot, bob, revolute_joint_2d(anchor2=(-1.0, 0.0)))
    w.build()
    w.step(120)
    p = w.body_translation2(bob)
    r = np.linalg.norm(p - np.array([0.0, 3.0]))
    assert abs(r - 1.0) < 5e-2, f"pendulum radius drifted: {r}"


@pytest.mark.slow
def test_inv_pyramid2_collapses_as_the_reference_does():
    """examples2d/inv_pyramid2.rs (downsized): an UPSIDE-DOWN pyramid —
    one box at the bottom, wider rows above — balances on its single
    support when built symmetrically (torque balance through the stack).

    The reference fails its own check here (ROADMAP R26: its top row ends
    at ~0.50); the port, built the same way, falls the same way, so this
    port test expects the collapse: every top box ends more than 1.0 below
    its start."""
    w = PhysicsWorld2D(device="cpu")
    g = w.insert_body(RigidBodyBuilder2D.fixed().with_translation((0, -0.1)))
    w.insert_collider(ColliderBuilder2D.cuboid(20.0, 0.1), g)
    half = 0.5
    rows = 3
    tops = []
    for row in range(rows):           # row 0 = single bottom box
        n = row + 1
        y = half + row * 2 * half
        for i in range(n):
            x = (i - (n - 1) / 2.0) * 2 * half
            b = w.insert_body(
                RigidBodyBuilder2D.dynamic().with_translation((x, y)))
            w.insert_collider(ColliderBuilder2D.cuboid(half, half), b)
            if row == rows - 1:
                tops.append((b, x, y))
    w.build()
    w.step(300)
    for b, x0, y0 in tops:
        p = np.asarray(w.body_translation2(b))
        assert p[1] < y0 - 1.0, f"inverse pyramid stood, unlike the reference's: y={p[1]}"


@pytest.mark.slow
def test_restitution2_bounce_heights_order():
    """examples2d/restitution2.rs: balls with increasing restitution
    rebound to strictly increasing heights."""
    w = PhysicsWorld2D(device="cpu")
    g = w.insert_body(RigidBodyBuilder2D.fixed().with_translation((0, -0.1)))
    w.insert_collider(ColliderBuilder2D.cuboid(20.0, 0.1).with_restitution(1.0), g)
    balls = []
    for i, e in enumerate((0.2, 0.5, 0.8)):
        b = w.insert_body(
            RigidBodyBuilder2D.dynamic().with_translation((i * 2.0 - 2.0, 3.0)))
        w.insert_collider(
            ColliderBuilder2D.ball(0.3).with_restitution(e), b)
        balls.append(b)
    w.build()
    peaks = [0.0] * 3
    bounced = [False] * 3
    for _ in range(240):
        w.step()
        for i, b in enumerate(balls):
            vy = float(np.asarray(w.body_linvel2(b))[1])
            y = float(np.asarray(w.body_translation2(b))[1])
            if vy > 0.1:
                bounced[i] = True
            if bounced[i]:
                peaks[i] = max(peaks[i], y)
    assert all(bounced), f"not all balls bounced: {bounced}"
    assert peaks[0] < peaks[1] < peaks[2], \
        f"bounce heights must order with restitution: {peaks}"
