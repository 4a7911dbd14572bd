"""The reference's tests/test_example_scenes.py scenarios on rapier_tpu_torch, on the CPU
(ROADMAP queue 1 item 2).

Each test builds its scene with the port's builders (`device="cpu"`), steps
it with the port's `PhysicsWorld` and keeps the reference test's own checks
and thresholds; batched leaves are read as ``[0, ...]`` (the port's state is
a batch of one scene).  Tests marked slow are so because the reference marks
the whole file slow (tests/conftest.py `_SLOW_MODULES`); the unmarked ones
run in tier-1 (test_one_way_platforms3).
"""

import numpy as np
import pytest

from rapier_tpu_torch.pipeline.hooks import one_way_platform_hook
from rapier_tpu_torch.world import (
    ColliderBuilder,
    GenericJointBuilder,
    PhysicsWorld,
    RigidBodyBuilder,
)


def _p(w, b):
    return np.asarray(w.body_translation(b))


def _ground(w, size=50.0, height=0.1):
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -height, 0)))
    w.insert_collider(ColliderBuilder.cuboid(size, height, size), g)
    return g


@pytest.mark.slow
def test_boxes3_grid_settles():
    """examples3d/boxes3.rs (downsized 3x3x3): a lattice of falling cubes
    settles into resting layers on the ground with no tunnelling."""
    w = PhysicsWorld(device="cpu")
    _ground(w)
    rad, shift = 0.5, 1.0 + 1e-3
    handles = []
    for i in range(3):
        for j in range(3):
            for k in range(3):
                h = w.insert_body(RigidBodyBuilder.dynamic().with_translation(
                    (i * shift - 1.0, 2.0 + j * shift, k * shift - 1.0)))
                w.insert_collider(ColliderBuilder.cuboid(rad, rad, rad), h)
                handles.append(h)
    w.build()
    w.step(300)
    ys = np.array([_p(w, h)[1] for h in handles])
    assert np.isfinite(ys).all()
    assert (ys > rad - 0.1).all(), f"box sank below ground: min y={ys.min()}"
    assert ys.max() < 3 * shift + rad + 0.1, "boxes should form <=3 layers"


@pytest.mark.slow
def test_domino3_chain_reaction():
    """examples3d/domino3.rs (downsized to one straight run): the first
    tipped domino knocks every later one over."""
    w = PhysicsWorld(device="cpu")
    _ground(w)
    n, spacing = 6, 0.9
    doms = []
    for i in range(n):
        bb = RigidBodyBuilder.dynamic().with_translation((i * spacing, 1.0, 0))
        if i == 0:
            bb = bb.with_angvel((0.0, 0.0, -3.0))  # tip toward +x
        b = w.insert_body(bb)
        w.insert_collider(ColliderBuilder.cuboid(0.1, 1.0, 0.4), b)
        doms.append(b)
    w.build()
    w.step(600)
    # Fallen dominoes shingle on each other (spacing 0.9 < height 2.0):
    # every center drops well below standing height 1.0; the last one,
    # with nothing to lean on, lies nearly flat.
    for i, d in enumerate(doms):
        y = float(_p(w, d)[1])
        assert y < 0.95, f"domino {i} still standing (y={y})"
    assert float(_p(w, doms[-1])[1]) < 0.4, "last domino never fell flat"


@pytest.mark.slow
def test_platform3_kinematic_carries_box():
    """examples3d/platform3.rs: a kinematic platform drives through its
    next-position target; a box resting on it rides along."""
    w = PhysicsWorld(device="cpu")
    plat = w.insert_body(
        RigidBodyBuilder.kinematic_position_based().with_translation((0, 0, 0)))
    w.insert_collider(ColliderBuilder.cuboid(2.0, 0.1, 2.0), plat)
    box = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 0.61, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.5, 0.5, 0.5), box)
    w.build()
    dt = float(w.params.dt)
    y = 0.0
    for _ in range(120):
        y += 0.5 * dt                      # platform rises at 0.5 m/s
        w.set_next_kinematic_translation(plat, (0.0, y, 0.0))
        w.step()
    py, by = float(_p(w, plat)[1]), float(_p(w, box)[1])
    assert abs(py - y) < 1e-3, "kinematic platform must track its target"
    assert abs(by - (py + 0.6)) < 0.08, f"box fell off the platform: {by} vs {py}"


def test_one_way_platforms3():
    """examples3d/one_way_platforms3.rs: a contact-filter hook keeps
    contacts whose normal pushes +y — a ball dropped from above lands on
    the platform; a ball thrown from below passes through it."""
    hooks = one_way_platform_hook((0.0, 1.0, 0.0))
    w = PhysicsWorld(device="cpu", hooks=hooks)
    from rapier_tpu_torch.types import ACTIVE_HOOKS_FILTER_CONTACT_PAIR

    plat = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 0, 0)))
    w.insert_collider(
        ColliderBuilder.cuboid(5.0, 0.1, 5.0)
        .with_active_hooks(ACTIVE_HOOKS_FILTER_CONTACT_PAIR), plat)
    above = w.insert_body(RigidBodyBuilder.dynamic().with_translation((1, 3, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5), above)
    below = w.insert_body(
        RigidBodyBuilder.dynamic()
        .with_translation((-1, -3, 0)).with_linvel((0, 14.0, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5), below)
    w.build()
    max_below_y = -1e9
    for _ in range(150):
        w.step()
        max_below_y = max(max_below_y, float(_p(w, below)[1]))
    assert float(_p(w, above)[1]) > 0.4, "ball from above must land on platform"
    assert max_below_y > 1.0, "ball from below must pass through the platform"


@pytest.mark.slow
def test_sensor3_intersection_events():
    """examples3d/sensor3.rs: a falling ball enters then exits a sensor
    volume; the intersection graph reflects both transitions."""
    w = PhysicsWorld(device="cpu")
    s = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 3, 0)))
    w.insert_collider(ColliderBuilder.ball(1.0).with_sensor(True), s)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 8, 0)))
    bc = w.insert_collider(ColliderBuilder.ball(0.3), b)
    w.build()
    was_inside = False
    for _ in range(240):
        w.step()
        if len(w.intersection_pairs_with(bc)) > 0:
            was_inside = True
    assert was_inside, "ball never intersected the sensor"
    assert len(w.intersection_pairs_with(bc)) == 0, \
        "intersection must end after the ball falls past the sensor"


@pytest.mark.slow
def test_rope_joints3_hangs_at_length():
    """examples3d/rope_joints3.rs: a ball on a rope joint free-falls until
    the rope goes taut, then hangs at the rope length."""
    w = PhysicsWorld(device="cpu")
    anchor = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 5, 0)))
    ball = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 4, 0)))
    w.insert_collider(ColliderBuilder.ball(0.3), ball)
    w.insert_impulse_joint(anchor, ball, GenericJointBuilder.rope(2.0))
    w.build()
    w.step(300)
    d = np.linalg.norm(_p(w, ball) - np.array([0, 5, 0]))
    assert abs(d - 2.0) < 0.1, f"ball should hang at rope length 2, got {d}"


@pytest.mark.slow
def test_spring_joints3_critical_damping_settles():
    """examples3d/spring_joints3.rs: a critically-damped spring settles a
    hanging ball near the gravity-stretched equilibrium without ringing."""
    w = PhysicsWorld(device="cpu")
    anchor = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 5, 0)))
    ball = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 4.0, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5), ball)
    mass = 4.0 / 3.0 * np.pi * 0.5**3  # density 1 ball
    k = 1.0e3
    c = 2.0 * np.sqrt(k * mass)
    w.insert_impulse_joint(
        anchor, ball, GenericJointBuilder.spring(1.0, k, c))
    w.build()
    w.step(240)
    eq = 1.0 + mass * 9.81 / k          # rest length + static stretch
    d = float(np.linalg.norm(_p(w, ball) - np.array([0, 5, 0])))
    v = float(np.linalg.norm(np.asarray(w.body_linvel(ball))))
    assert abs(d - eq) < 0.05, f"spring length {d}, expected ~{eq}"
    assert v < 0.05, f"critically damped spring still moving: |v|={v}"


@pytest.mark.slow
def test_joint_fixed3_chain_is_rigid():
    """examples3d/joint_fixed3.rs (downsized): a horizontal chain of
    fixed joints transmits no relative motion — the links keep their
    build-time offsets (up to solver compliance) while hanging."""
    w = PhysicsWorld(device="cpu")
    root = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 4, 0)))
    prev, bodies = root, []
    for i in range(4):
        b = w.insert_body(
            RigidBodyBuilder.dynamic().with_translation((0.6 * (i + 1), 4, 0)))
        w.insert_collider(ColliderBuilder.cuboid(0.25, 0.1, 0.1), b)
        j = GenericJointBuilder.fixed()
        j.local_anchor1 = (0.3, 0.0, 0.0) if i else (0.3, 0.0, 0.0)
        j.local_anchor2 = (-0.3, 0.0, 0.0)
        w.insert_impulse_joint(prev, b, j)
        prev = b
        bodies.append(b)
    w.build()
    w.step(240)
    for i, b in enumerate(bodies):
        p = _p(w, b)
        ref = np.array([0.6 * (i + 1), 4.0, 0.0])
        assert np.linalg.norm(p - ref) < 0.12, \
            f"fixed-joint link {i} sagged to {p} (expected ~{ref})"


@pytest.mark.slow
def test_joint_prismatic3_slides_to_limit():
    """examples3d/joint_prismatic3.rs: a gravity-driven prismatic slider
    along a tilted axis stops exactly at its configured limit."""
    w = PhysicsWorld(device="cpu")
    root = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 5, 0)))
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 5, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.2, 0.2, 0.2), b)
    j = GenericJointBuilder.prismatic((0.0, -1.0, 0.0)).with_limits(0, -0.0, 1.5)
    w.insert_impulse_joint(root, b, j)
    w.build()
    w.step(240)
    p = _p(w, b)
    assert abs(p[1] - 3.5) < 0.05, f"slider should rest at y=3.5, got {p[1]}"
    assert abs(p[0]) < 1e-3 and abs(p[2]) < 1e-3, "slider left its axis"


@pytest.mark.slow
def test_compound3_cross_rests():
    """examples3d/compound3.rs: a compound cross (two overlapping cuboids)
    falls and rests on the ground at the height of its widest child."""
    w = PhysicsWorld(device="cpu")
    _ground(w)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 3, 0)))
    cross = ColliderBuilder.compound([
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), ColliderBuilder.cuboid(1.0, 0.2, 0.2)),
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), ColliderBuilder.cuboid(0.2, 0.2, 1.0)),
    ])
    w.insert_collider(cross, b)
    w.build()
    w.step(240)
    p = _p(w, b)
    assert abs(p[1] - 0.2) < 0.05, f"cross should rest at y=0.2, got {p[1]}"


@pytest.mark.slow
def test_trimesh3_ball_rests_on_mesh():
    """examples3d/trimesh3.rs: a ball dropped on a trimesh terrain comes to
    rest on a face instead of tunnelling through."""
    w = PhysicsWorld(device="cpu")
    # A shallow 4-quad valley: floor line y=0 along z at x=0, walls rising
    # to y=0.5 at |x|=2 — the dropped ball rolls to the valley floor and
    # stays (a ball on a tent would roll off the edge).
    verts = np.array([
        [-2, 0.5, -2], [0, 0, -2], [2, 0.5, -2],
        [-2, 0.5,  2], [0, 0,  2], [2, 0.5,  2],
    ], np.float32)
    tris = np.array([
        [0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4],
    ], np.int32)
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.trimesh(verts, tris), g)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0.6, 3, 0)))
    w.insert_collider(ColliderBuilder.ball(0.3), b)
    w.build()
    w.step(400)
    p = _p(w, b)
    assert np.isfinite(p).all()
    assert p[1] > 0.2, f"ball tunnelled through the trimesh: y={p[1]}"
    assert p[1] < 0.6, f"ball never settled into the valley: y={p[1]}"
    assert abs(p[0]) < 0.6, f"ball should roll toward the valley floor: x={p[0]}"


@pytest.mark.slow
def test_damping3_ordering():
    """examples3d/damping3.rs: in zero gravity, higher linear damping
    travels strictly less far; higher angular damping spins down harder."""
    w = PhysicsWorld(device="cpu", gravity=(0, 0, 0))
    hs = []
    for i, (ld, ad) in enumerate([(0.5, 8.0), (4.0, 0.5)]):
        bb = RigidBodyBuilder.dynamic().with_translation((0, float(i * 5), 0))
        bb = bb.with_linvel((10.0, 0, 0)).with_angvel((0, 0, 20.0))
        bb.linear_damping = ld
        bb.angular_damping = ad
        h = w.insert_body(bb)
        w.insert_collider(ColliderBuilder.cuboid(0.2, 0.2, 0.2), h)
        hs.append(h)
    w.build()
    w.step(120)
    x_low_damp = float(_p(w, hs[0])[0])
    x_high_damp = float(_p(w, hs[1])[0])
    assert x_low_damp > x_high_damp + 1.0, \
        f"linear damping ordering violated: {x_low_damp} vs {x_high_damp}"
    wz0 = abs(float(w.body_angvel(hs[0])[2]))
    wz1 = abs(float(w.body_angvel(hs[1])[2]))
    assert wz0 < wz1, "angular damping ordering violated"


@pytest.mark.slow
def test_many_pyramids3_all_stand():
    """examples3d/stress_tests/many_pyramids3.rs (downsized 2x2 grid of
    5-stack pyramids): every pyramid keeps its apex near its own column."""
    w = PhysicsWorld(device="cpu")
    _ground(w, size=60.0)
    half, shift = 0.5, 1.25
    apexes = []
    n = 5
    for gx in range(2):
        for gz in range(2):
            ox, oz = gx * 12.0 - 6.0, gz * 12.0 - 6.0
            for i in range(n):
                for j in range(i, n):
                    for k in range(i, n):
                        x = ox + i * shift / 2 + (k - i) * shift - n * half
                        y = i * shift + half
                        z = oz + i * shift / 2 + (j - i) * shift - n * half
                        b = w.insert_body(
                            RigidBodyBuilder.dynamic().with_translation((x, y, z)))
                        w.insert_collider(
                            ColliderBuilder.cuboid(half, half, half), b)
                        if i == n - 1:
                            apexes.append((b, ox, oz))
    w.build()
    w.step(300)
    # Apex (i=j=k=4) is built at (ox, 4*shift+half, oz); after the 0.25/layer
    # settling drop it rests near (ox, 4.5, oz).
    for b, ox, oz in apexes:
        p = _p(w, b)
        assert p[1] > 3.5, f"pyramid apex collapsed: y={p[1]}"
        assert abs(p[0] - ox) < 1.5 and abs(p[2] - oz) < 1.5, \
            f"apex slid off its pyramid: {p} (expected near ({ox}, ., {oz}))"


@pytest.mark.slow
def test_keva3_plank_tower_stands():
    """examples3d/keva3.rs (downsized): alternating orthogonal layers of
    slender planks stay stacked — the plank tower neither sinks nor
    topples at default iteration counts."""
    w = PhysicsWorld(device="cpu")
    _ground(w)
    hx, hy, hz = 1.0, 0.1, 0.25
    tops = []
    for layer in range(4):
        y = hy + layer * 2 * hy + layer * 1e-3
        for s in (-0.6, 0.6):
            if layer % 2 == 0:
                bb = RigidBodyBuilder.dynamic().with_translation((0, y, s))
                cb = ColliderBuilder.cuboid(hx, hy, hz)
            else:
                bb = RigidBodyBuilder.dynamic().with_translation((s, y, 0))
                cb = ColliderBuilder.cuboid(hz, hy, hx)
            b = w.insert_body(bb)
            w.insert_collider(cb, b)
            if layer == 3:
                tops.append((b, y))
    w.build()
    w.step(300)
    for b, y0 in tops:
        p = _p(w, b)
        assert abs(p[1] - y0) < 0.08, f"top plank moved: y={p[1]} (built {y0})"
        assert abs(p[0]) < 0.75 and abs(p[2]) < 0.75


@pytest.mark.slow
def test_stacks3_tower_stands():
    """examples3d/stacks3.rs (one 8-box tower): a vertical box stack holds
    its height; the top box stays within a half-extent of its column."""
    w = PhysicsWorld(device="cpu")
    _ground(w)
    half = 0.5
    boxes = []
    for i in range(8):
        b = w.insert_body(RigidBodyBuilder.dynamic().with_translation(
            (0, half + i * (2 * half + 1e-3), 0)))
        w.insert_collider(ColliderBuilder.cuboid(half, half, half), b)
        boxes.append(b)
    w.build()
    w.step(300)
    top = _p(w, boxes[-1])
    assert abs(top[1] - 7.5) < 0.1, f"tower sank: top at {top[1]}"
    assert abs(top[0]) < half and abs(top[2]) < half, "tower leaned over"


@pytest.mark.slow
def test_fountain3_runtime_spawns():
    """examples3d/fountain3.rs (downsized): balls inserted at runtime every
    few steps all stay finite and above the ground — the arena/handle path
    under continuous insertion."""
    w = PhysicsWorld(device="cpu", body_capacity=64, collider_capacity=64, max_pairs=512)
    _ground(w, size=20.0)
    w.build()
    spawned = []
    rng = np.random.default_rng(7)
    for i in range(120):
        if i % 12 == 0 and len(spawned) < 10:
            jx, jz = rng.uniform(-0.2, 0.2, 2)
            h = w.insert_body_runtime(
                RigidBodyBuilder.dynamic()
                .with_translation((jx, 6.0, jz))
                .with_linvel((jx * 4, 2.0, jz * 4)))
            w.insert_collider_runtime(ColliderBuilder.ball(0.4), h)
            spawned.append(h)
    w.step(180)
    assert len(spawned) == 10
    for h in spawned:
        p = _p(w, h)
        assert np.isfinite(p).all()
        assert p[1] > 0.25, f"spawned ball sank: y={p[1]}"
