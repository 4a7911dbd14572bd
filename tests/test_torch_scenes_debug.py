"""The reference's tests/test_debug_scenes.py scenarios on rapier_tpu_torch, on the CPU
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
from rapier_tpu_torch.types import SimParams


def _p(w, b):
    return np.asarray(w.body_translation(b))


@pytest.mark.slow
def test_debug_two_cubes3_rests():
    """debug_two_cubes3.rs: a dynamic cube dropped on an identical fixed
    cube rests exactly one edge-length up."""
    w = PhysicsWorld(device="cpu")
    d = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 2, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.5, 0.5, 0.5), d)
    f = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.cuboid(0.5, 0.5, 0.5), f)
    w.build()
    w.step(240)
    p = _p(w, d)
    assert abs(p[1] - 1.0) < 0.05, f"cube rests at {p[1]}, expected 1.0"
    assert abs(p[0]) < 0.05 and abs(p[2]) < 0.05
    assert w.body_is_sleeping(d)


@pytest.mark.slow
def test_debug_cylinder3_thin_ground():
    """debug_cylinder3.rs: 'EPA returns an incorrect contact normal,
    resulting in the cylinder falling through the floor' — the repro for
    the exact-GJK/EPA path (geometry/gjk.py): a cylinder on a very large,
    very thin cuboid must rest, not sink."""
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -0.1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(100.1, 0.1, 100.1), g)
    c = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 4.5, 0)))
    w.insert_collider(ColliderBuilder.cylinder(1.0, 1.0), c)
    w.build()
    w.step(300)
    p = _p(w, c)
    assert abs(p[1] - 1.0) < 0.08, f"cylinder should rest at y=1, got {p[1]}"
    assert np.isfinite(p).all()


@pytest.mark.slow
def test_debug_pop3_depenetrates_smoothly():
    """debug_pop3.rs: a cube spawned 1.0 deep inside the ground must rise
    out gradually (max_corrective_velocity clamping), not 'pop'."""
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -10, 0)))
    w.insert_collider(ColliderBuilder.cuboid(10, 10, 10), g)
    bb = RigidBodyBuilder.dynamic()     # center at y=0: 1.0 deep
    bb.can_sleep = False
    b = w.insert_body(bb)
    w.insert_collider(ColliderBuilder.cuboid(1, 1, 1), b)
    w.build()
    max_y, max_vy = -1e9, 0.0
    for _ in range(240):
        w.step()
        max_y = max(max_y, float(_p(w, b)[1]))
        max_vy = max(max_vy, float(np.asarray(w.body_linvel(b))[1]))
    y = float(_p(w, b)[1])
    assert 0.9 < y < 1.1, f"cube should rest at y=1 after depenetration: {y}"
    assert max_y < 1.4, f"cube overshot while popping out: max_y={max_y}"
    assert max_vy < 6.0, f"depenetration flung the cube: vy={max_vy}"


@pytest.mark.slow
def test_debug_friction3_high_friction_box_stops():
    """debug_friction3.rs: a friction-1.5 box sliding at 50 m/s on a
    friction-1.5 ground brakes to rest (mu*g ~ 14.7 m/s^2 => ~3.4 s)."""
    w = PhysicsWorld(device="cpu", max_pairs=512)
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(
        ColliderBuilder.cuboid(100.0, 0.1, 100.0).with_friction(1.5), g)
    rot = (0.0, 0.3, 0.0)               # scaled-axis, like the reference
    b = w.insert_body(
        RigidBodyBuilder.dynamic().with_translation((0, 1.1, 0))
        .with_rotation(rot))
    w.insert_collider(
        ColliderBuilder.cuboid(2.0, 1.0, 3.0).with_friction(1.5), b)
    w.build()
    # linvel = rotation * Z * 50
    c, s = np.cos(0.3), np.sin(0.3)
    w.set_linvel(b, (s * 50.0, 0.0, c * 50.0))
    w.step(270)
    v = np.asarray(w.body_linvel(b))
    assert np.linalg.norm(v) < 1.0, f"friction never stopped the box: {v}"
    p = _p(w, b)
    assert 0.9 < p[1] < 1.3 and np.isfinite(p).all()


@pytest.mark.slow
def test_newton_cradle3_momentum_returns():
    """newton_cradle3.rs: five restitution-1 pendulum balls; the launched
    end ball swings back and the impact propagates to the far ball."""
    radius, length, n = 0.5, 5.0, 5
    w = PhysicsWorld(device="cpu")
    balls = []
    for i in range(n):
        pos = np.array([i * 2.2 * radius, 0.0, 0.0])
        anchor = w.insert_body(
            RigidBodyBuilder.fixed().with_translation(tuple(pos + [0, length, 0])))
        vel = (7.0, 0.0, 0.0) if i == n - 1 else (0.0, 0.0, 0.0)
        b = w.insert_body(
            RigidBodyBuilder.dynamic().with_translation(tuple(pos))
            .with_linvel(vel))
        w.insert_collider(ColliderBuilder.ball(radius).with_restitution(1.0), b)
        jb = GenericJointBuilder.spherical().with_local_anchor2((0.0, length, 0.0))
        w.insert_impulse_joint(anchor, b, jb)
        balls.append(b)
    w.build()
    far_vx_min = 0.0
    for _ in range(260):
        w.step()
        far_vx_min = min(far_vx_min, float(np.asarray(w.body_linvel(balls[0]))[0]))
        # Pendulum constraint: every ball stays ~length from its anchor.
        for i, b in enumerate(balls):
            anchor = np.array([i * 2.2 * radius, length, 0.0])
            d = np.linalg.norm(_p(w, b) - anchor)
            assert abs(d - length) < 0.25, f"rope stretched: {d}"
    assert far_vx_min < -1.0, (
        f"impact never propagated to the far ball: min vx={far_vx_min}")


@pytest.mark.slow
def test_debug_long_chain3_holds():
    """debug_long_chain3.rs (downsized 100->30): a long spherical-joint
    ball chain swings under gravity without tearing or stretching."""
    n, rad = 30, 0.2
    shift = rad * 2.2
    w = PhysicsWorld(device="cpu", max_pairs=2048)
    hs = []
    for i in range(n):
        bb = (RigidBodyBuilder.fixed() if i == 0 else RigidBodyBuilder.dynamic())
        b = w.insert_body(bb.with_translation((0.0, 0.0, i * shift)))
        w.insert_collider(ColliderBuilder.ball(rad), b)
        if i == 1:
            jb = GenericJointBuilder.spherical().with_local_anchor2((0, 0, -shift))
            w.insert_impulse_joint(hs[-1], b, jb)
        elif i > 1:
            jb = (GenericJointBuilder.spherical()
                  .with_local_anchor1((0, 0, shift / 2))
                  .with_local_anchor2((0, 0, -shift / 2)))
            w.insert_impulse_joint(hs[-1], b, jb)
        hs.append(b)
    w.build()
    w.step(240)
    ps = np.stack([_p(w, b) for b in hs])
    assert np.isfinite(ps).all()
    gaps = np.linalg.norm(np.diff(ps, axis=0), axis=1)
    assert gaps.max() < shift * 1.6, f"chain tore: max gap {gaps.max()}"
    total = gaps.sum()
    assert total < n * shift * 1.25, f"chain stretched: {total}"


@pytest.mark.slow
def test_debug_chain_high_mass_ratio3():
    """debug_chain_high_mass_ratio3.rs (downsized 17->10): a ball chain
    with a 10x-radius (1000x mass) end ball; the reference bumps
    additional_solver_iterations to 16 — our batched solver raises the
    global iteration count instead (documented divergence: per-island
    iteration escalation has no island axis here)."""
    n, rad = 10, 0.2
    w = PhysicsWorld(device="cpu", params=SimParams(num_solver_iterations=16),
                     max_pairs=2048)
    hs = []
    z = 0.0
    for i in range(n):
        ball_rad = rad * 10.0 if i == n - 1 else rad
        shift1 = rad * 1.1
        shift2 = ball_rad + rad * 0.1
        z = 0.0 if i == 0 else (i - 1) * 2.0 * shift1 + shift1 + shift2
        bb = (RigidBodyBuilder.fixed() if i == 0 else RigidBodyBuilder.dynamic())
        b = w.insert_body(bb.with_translation((0.0, 0.0, z)))
        w.insert_collider(ColliderBuilder.ball(ball_rad), b)
        if i == 1:
            jb = GenericJointBuilder.spherical().with_local_anchor2(
                (0, 0, -shift1 * 2.0))
            w.insert_impulse_joint(hs[-1], b, jb)
        elif i > 1:
            jb = (GenericJointBuilder.spherical()
                  .with_local_anchor1((0, 0, shift1))
                  .with_local_anchor2((0, 0, -shift2)))
            w.insert_impulse_joint(hs[-1], b, jb)
        hs.append(b)
    w.build()
    w.step(200)
    ps = np.stack([_p(w, b) for b in hs])
    assert np.isfinite(ps).all()
    # The heavy end ball must still hang off the chain, not rip free:
    # every link pair stays within 2x its rest separation.
    rest = [np.linalg.norm(np.array([0, 0, 1]) * 0)]  # placeholder
    gaps = np.linalg.norm(np.diff(ps, axis=0), axis=1)
    assert gaps[-1] < (rad * 10 + rad * 0.1 + rad * 1.1) * 2.0, (
        f"heavy ball tore off: gap {gaps[-1]}")
    assert gaps[:-1].max() < rad * 2.2 * 2.0, f"chain tore: {gaps[:-1].max()}"


@pytest.mark.slow
def test_locked_rotations3():
    """locked_rotations3.rs: a body with locked translations and only-x
    rotations never translates; a lock_rotations capsule falls keeping its
    tilted orientation."""
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -0.1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(5.0, 0.1, 5.0), g)
    rect = w.insert_body(
        RigidBodyBuilder.dynamic().with_translation((0, 3, 0))
        .lock_translations().enabled_rotations(True, False, False))
    w.insert_collider(ColliderBuilder.cuboid(0.2, 0.6, 2.0), rect)
    tilt = (1.0, 0.0, 0.0)              # scaled-axis x * 1.0
    cap = w.insert_body(
        RigidBodyBuilder.dynamic().with_translation((0, 5, 0))
        .with_rotation(tilt).lock_rotations())
    w.insert_collider(ColliderBuilder.capsule_y(0.6, 0.4), cap)
    q0 = np.asarray(w._pending_bodies[cap].rotation)
    w.build()
    w.step(240)
    assert np.allclose(_p(w, rect), [0, 3, 0], atol=1e-4), (
        f"locked translations moved: {_p(w, rect)}")
    q = np.asarray(w.body_rotation(cap))
    assert abs(float(np.dot(q, q0))) > 0.9999, f"locked rotation drifted: {q}"
    p = _p(w, cap)
    assert np.isfinite(p).all() and p[1] > 0.3


@pytest.mark.slow
def test_gyroscopic3_dzhanibekov():
    """gyroscopic3.rs: a T-shaped compound spinning about its intermediate
    axis with gyroscopic forces enabled tumbles (Dzhanibekov effect); the
    same body with gyro disabled keeps its angular velocity exactly."""
    def build(gyro: bool):
        w = PhysicsWorld(device="cpu", gravity=(0, 0, 0))
        bb = RigidBodyBuilder.dynamic().with_angvel((0.0, 20.0, 0.1))
        bb.gravity_scale = 0.0
        bb.gyroscopic_forces_enabled = gyro
        bb.can_sleep = False
        b = w.insert_body(bb)
        w.insert_collider(ColliderBuilder.compound([
            ((0.0, 0.0, 0.0), (0, 0, 0, 1), ColliderBuilder.cuboid(2.0, 0.2, 0.2)),
            ((0.0, 0.8, 0.0), (0, 0, 0, 1), ColliderBuilder.cuboid(0.2, 0.4, 0.2)),
        ]), b)
        w.build()
        return w, b

    w, b = build(gyro=True)
    max_wx = 0.0
    for _ in range(420):
        w.step()
        av = np.asarray(w.body_angvel(b))
        assert np.isfinite(av).all() and np.linalg.norm(av) < 80.0
        max_wx = max(max_wx, abs(float(av[0])), abs(float(av[2])))
    assert max_wx > 1.0, (
        f"no gyroscopic tumble (max transverse angvel {max_wx})")

    w2, b2 = build(gyro=False)
    w2.step(60)
    av2 = np.asarray(w2.body_angvel(b2))
    np.testing.assert_allclose(av2, [0.0, 20.0, 0.1], atol=1e-3)


@pytest.mark.slow
def test_restitution3_rebound_ordering():
    """restitution3.rs: balls of restitution 0/0.5/1.0 dropped on a
    restitution-1 ground — rebound apex orders with restitution and the
    e=1 ball returns near its drop height (AVERAGE combine)."""
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -1, 0)))
    w.insert_collider(
        ColliderBuilder.cuboid(20.0, 1.0, 2.0).with_restitution(1.0), g)
    h0, rad = 10.0, 0.5
    balls = []
    for i, e in enumerate((0.0, 0.5, 1.0)):
        b = w.insert_body(
            RigidBodyBuilder.dynamic().with_translation((i * 3.0 - 3.0, h0, 0)))
        w.insert_collider(ColliderBuilder.ball(rad).with_restitution(e), b)
        balls.append(b)
    w.build()
    apex = [0.0, 0.0, 0.0]
    bounced = [False] * 3
    for _ in range(400):
        w.step()
        for i, b in enumerate(balls):
            vy = float(np.asarray(w.body_linvel(b))[1])
            if vy > 0.1:
                bounced[i] = True
            if bounced[i]:
                apex[i] = max(apex[i], float(_p(w, b)[1]))
    # eff restitution (AVERAGE): 0.5, 0.75, 1.0 -> apex ~ e^2 * h0.
    assert apex[2] > apex[1] > apex[0], f"apex ordering wrong: {apex}"
    assert apex[2] > 0.7 * h0, f"e=1 ball lost too much energy: {apex[2]}"
    assert apex[0] < 0.45 * h0, f"e=0.5-combined ball kept too much: {apex[0]}"


@pytest.mark.slow
def test_collision_groups3():
    """collision_groups3.rs: a GREEN cube falls through the BLUE-only
    platform and lands on the GREEN-only platform below it."""
    GREEN = (1 << 16) | 1
    BLUE = (2 << 16) | 2
    w = PhysicsWorld(device="cpu")
    floor = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -0.1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(5.0, 0.1, 5.0), floor)
    w.insert_collider(
        ColliderBuilder.cuboid(1.0, 0.1, 1.0).with_translation((0, 1.1, 0))
        .with_collision_groups(GREEN), floor)
    w.insert_collider(
        ColliderBuilder.cuboid(1.0, 0.1, 1.0).with_translation((0, 2.1, 0))
        .with_collision_groups(BLUE), floor)
    rad = 0.1
    green_cube = w.insert_body(
        RigidBodyBuilder.dynamic().with_translation((0.3, 3.0, 0.0)))
    w.insert_collider(
        ColliderBuilder.cuboid(rad, rad, rad).with_collision_groups(GREEN),
        green_cube)
    blue_cube = w.insert_body(
        RigidBodyBuilder.dynamic().with_translation((-0.3, 3.0, 0.0)))
    w.insert_collider(
        ColliderBuilder.cuboid(rad, rad, rad).with_collision_groups(BLUE),
        blue_cube)
    w.build()
    w.step(240)
    # Platform translations are relative to the floor body at y=-0.1, so
    # the platform tops sit at 1.1 and 2.1 world; cubes rest rad above.
    gy = float(_p(w, green_cube)[1])
    by = float(_p(w, blue_cube)[1])
    assert abs(gy - (1.1 + rad)) < 0.05, (
        f"green cube should rest on the green platform (y~1.2): {gy}")
    assert abs(by - (2.1 + rad)) < 0.05, (
        f"blue cube should rest on the blue platform (y~2.2): {by}")


@pytest.mark.slow
def test_stress_joint_revolute3_grid():
    """stress_tests/joint_revolute3.rs (downsized): a revolute-joint
    zig-zag net anchored at a fixed cube holds together under gravity."""
    rad, shift = 0.4, 2.0
    w = PhysicsWorld(device="cpu", max_pairs=2048)
    ground = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.cuboid(rad, rad, rad), ground)
    curr = ground
    all_bodies = []
    for i in range(3):
        z = i * shift * 2.0 + shift
        positions = [(0.0, 0.0, z), (shift, 0.0, z),
                     (shift, 0.0, z + shift), (0.0, 0.0, z + shift)]
        handles = []
        for pos in positions:
            b = w.insert_body(RigidBodyBuilder.dynamic().with_translation(pos))
            w.insert_collider(ColliderBuilder.cuboid(rad, rad, rad), b)
            handles.append(b)
        X, Z = (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)
        revs = [
            (GenericJointBuilder.revolute(Z), (0.0, 0.0, -shift)),
            (GenericJointBuilder.revolute(X), (-shift, 0.0, 0.0)),
            (GenericJointBuilder.revolute(Z), (0.0, 0.0, -shift)),
            (GenericJointBuilder.revolute(X), (shift, 0.0, 0.0)),
        ]
        parents = [curr, handles[0], handles[1], handles[2]]
        for (jb, a2), pa, ch in zip(revs, parents, handles):
            w.insert_impulse_joint(pa, ch, jb.with_local_anchor2(a2))
        all_bodies.extend(handles)
        curr = handles[3]
    w.build()
    w.step(240)
    ps = np.stack([_p(w, b) for b in all_bodies])
    assert np.isfinite(ps).all()
    # Every jointed pair stays within 1.5x its rest offset (net holds).
    assert np.linalg.norm(ps[0]) < shift * 1.5, "net detached from anchor"
    for k in range(len(all_bodies) - 1):
        gap = np.linalg.norm(ps[k + 1] - ps[k])
        assert gap < shift * 2.5, f"net tore at link {k}: {gap}"
