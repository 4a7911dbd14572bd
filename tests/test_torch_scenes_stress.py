"""The reference's tests/test_stress_scenes.py scenarios on rapier_tpu_torch, on the CPU
(ROADMAP queue 1 item 2).

Each test builds its scene with the port's builders (`device="cpu"`), steps
it with the port's `PhysicsWorld` and keeps the reference test's own checks
and thresholds; batched leaves are read as ``[0, ...]`` (the port's state is
a batch of one scene).  Tests marked slow are so because the reference marks
the whole file slow (tests/conftest.py `_SLOW_MODULES`); the unmarked ones
run in tier-1 (none).
"""

import numpy as np
import pytest

from rapier_tpu_torch.world import (
    ColliderBuilder,
    GenericJointBuilder,
    PhysicsWorld,
    RigidBodyBuilder,
)


@pytest.mark.slow
def test_balls3_grid_settles():
    """stress_tests/balls3.rs: ball grid, bottom layer fixed; upper layers
    fall onto it and settle finite without explosion."""
    num, rad = 4, 1.0
    shift = rad * 2.0 + 1.0
    w = PhysicsWorld(device="cpu", max_pairs=2048)
    hs = []
    for i in range(num):
        for j in range(3):
            for k in range(num):
                x = i * shift - shift * num / 2
                y = j * shift + shift / 2
                z = k * shift - shift * num / 2
                bb = (RigidBodyBuilder.fixed() if j == 0
                      else RigidBodyBuilder.dynamic())
                b = w.insert_body(bb.with_translation((x, y, z)))
                w.insert_collider(ColliderBuilder.ball(rad).with_density(0.477), b)
                hs.append((b, j))
    w.build()
    w.step(180)
    for b, j in hs:
        p = np.asarray(w.body_translation(b))
        assert np.isfinite(p).all()
        assert p[1] > 0.4, f"ball fell through the fixed layer: {p}"


@pytest.mark.slow
def test_many_sleep3_stays_asleep():
    """stress_tests/many_sleep3.rs: bodies spawned SLEEPING stay asleep (no
    spurious wakes) and never move."""
    num, rad = 4, 1.0
    shift = rad * 2.0 + 1.0
    w = PhysicsWorld(device="cpu", max_pairs=2048)
    hs = []
    for i in range(num):
        for j in range(1, 3):           # dynamic layers only, spawned asleep
            for k in range(num):
                bb = RigidBodyBuilder.dynamic().with_translation(
                    (i * shift, j * shift + shift / 2, k * shift))
                bb.sleeping = True
                b = w.insert_body(bb)
                w.insert_collider(ColliderBuilder.ball(rad).with_density(0.477), b)
                hs.append(b)
    w.build()
    p0 = [np.asarray(w.body_translation(b)).copy() for b in hs]
    w.step(60)
    for b, q in zip(hs, p0):
        assert w.body_is_sleeping(b), f"body {b} woke with no interaction"
        np.testing.assert_array_equal(np.asarray(w.body_translation(b)), q)


@pytest.mark.slow
def test_many_static3_dynamic_rests_on_static_grid():
    """stress_tests/many_static3.rs: a sea of FIXED colliders + a thin
    dynamic layer on top; the dynamics settle on the static field."""
    num, rad = 5, 1.0
    shift = rad * 2.0 + 1.0
    w = PhysicsWorld(device="cpu", max_pairs=2048)
    dyn = []
    for i in range(num):
        for j in range(2):
            for k in range(num):
                fixed = j < 1
                bb = (RigidBodyBuilder.fixed() if fixed
                      else RigidBodyBuilder.dynamic())
                b = w.insert_body(bb.with_translation(
                    (i * shift, j * shift + shift / 2, k * shift)))
                w.insert_collider(ColliderBuilder.ball(rad).with_density(0.477), b)
                if not fixed:
                    dyn.append(b)
    w.build()
    w.step(240)
    for b in dyn:
        p = np.asarray(w.body_translation(b))
        assert np.isfinite(p).all()
        assert p[1] > 1.0, f"dynamic ball fell through the static grid: {p}"


@pytest.mark.slow
def test_joint_ball3_net_holds():
    """stress_tests/joint_ball3.rs: a spherical-joint net with fixed corner
    anchors; the net sags but every joint gap stays bounded."""
    num, rad, shift = 5, 0.4, 1.0
    w = PhysicsWorld(device="cpu", max_pairs=2048)
    handles = []
    for k in range(num):
        for i in range(num):
            fixed = i == 0 and (k % 4 == 0 or k == num - 1)
            bb = (RigidBodyBuilder.fixed() if fixed
                  else RigidBodyBuilder.dynamic())
            b = w.insert_body(bb.with_translation((k * shift, 0.0, i * shift)))
            w.insert_collider(
                ColliderBuilder.ball(rad).with_density(1.0)
                .with_collision_groups(0), b)
            if i > 0:
                jb = GenericJointBuilder.spherical()
                jb.with_local_anchor2((0.0, 0.0, -shift))
                w.insert_impulse_joint(handles[-1], b, jb)
            if k > 0:
                jb = GenericJointBuilder.spherical()
                jb.with_local_anchor2((-shift, 0.0, 0.0))
                w.insert_impulse_joint(handles[len(handles) - num], b, jb)
            handles.append(b)
    w.build()
    w.step(180)
    ps = np.stack([np.asarray(w.body_translation(b)) for b in handles])
    assert np.isfinite(ps).all()
    # Neighbor gaps stay near the 1.0 rest length (joints hold the net).
    for k in range(num):
        for i in range(1, num):
            gap = np.linalg.norm(ps[k * num + i] - ps[k * num + i - 1])
            assert gap < 1.6, f"net tore at ({k},{i}): gap={gap}"


@pytest.mark.slow
def test_joint_motor_position3_reaches_targets():
    """joint_motor_position3.rs: revolute motors drive rectangles to their
    target angles (position motor, stiffness 1000 damping 150)."""
    w = PhysicsWorld(device="cpu")
    ground = w.insert_body(RigidBodyBuilder.fixed())
    targets = []
    arms = []
    for num in range(0, 5):
        x = -6.0 + 1.5 * num
        b = w.insert_body(
            RigidBodyBuilder.dynamic().with_translation((x, 2.0, 0.0)))
        w.insert_collider(ColliderBuilder.cuboid(0.1, 0.5, 0.1), b)
        target = -np.pi + np.pi / 4.0 * num
        jb = GenericJointBuilder.revolute((0.0, 0.0, 1.0))
        jb.with_local_anchor1((x, 1.5, 0.0))
        jb.with_local_anchor2((0.0, -0.5, 0.0))
        jb.with_motor_position(3, target, 1000.0, 150.0)
        w.insert_impulse_joint(ground, b, jb)
        targets.append(target)
        arms.append(b)
    w.build()
    w.step(300)
    for b, target in zip(arms, targets):
        q = np.asarray(w.body_rotation(b))
        angle = 2.0 * np.arctan2(q[2], q[3])
        # Compare angles on the circle (target -pi == +pi).
        diff = np.arctan2(np.sin(angle - target), np.cos(angle - target))
        assert abs(diff) < 0.15, (
            f"motor target {target:+.2f} reached {angle:+.2f}")


@pytest.mark.slow
def test_capsules3_pile_settles():
    """stress_tests/capsules3.rs: capsule pile on fixed bottom layer."""
    num, rad = 3, 0.5
    shift = rad * 4.0
    w = PhysicsWorld(device="cpu", max_pairs=2048)
    hs = []
    for i in range(num):
        for j in range(3):
            for k in range(num):
                bb = (RigidBodyBuilder.fixed() if j == 0
                      else RigidBodyBuilder.dynamic())
                b = w.insert_body(bb.with_translation(
                    (i * shift, j * shift + shift / 2, k * shift)))
                w.insert_collider(
                    ColliderBuilder.capsule_y(0.5, rad).with_density(1.0), b)
                hs.append(b)
    w.build()
    w.step(240)
    for b in hs:
        p = np.asarray(w.body_translation(b))
        assert np.isfinite(p).all()
        assert p[1] > 0.2, f"capsule fell through: {p}"
