"""What an articulated, actuated configuration needs of the harness: start
offsets in the ground plane that keep an articulation whole (and leave the
contact cells' start bit for bit as it was), the policy's actions in the
loop, and a reference package and parameters of the configuration's own."""

import numpy as np
import pytest
import torch

from port_bench import run
from port_bench.tests import robot_bench

SEED = 2**41 + 2024


def bits(x):
    return x.contiguous().view(torch.int64 if x.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("cell, sizes", [
    ("mixed_primitives.e150", dict(num_layers=2, grid=2)),
    ("primitives3.e150", dict(num_layers=1, grid=2)),
    ("mixed_primitives.e150-f64", dict(num_layers=2, grid=2)),
])
def test_the_contact_cells_get_the_old_offsets_bit_for_bit(bench, f32, cell, sizes):
    """The old draw, written out: each dynamic body on its own, x and z."""
    from rapier_tpu_torch.scenes import replicate_scene

    files = run.cell_files(bench, cell)
    cfg, traffic = dict(files["config"], scenes=3, **sizes), files["traffic"]
    state, params, one, robot = run.build_batch(cfg, traffic, SEED, "cpu")
    assert robot is None
    amp = traffic["jitter_rad"] * cfg["rad"]
    dyn = (one.bodies.body_type == 0).nonzero().flatten()
    old = (np.random.default_rng([SEED % 2**64, 2]).random((3, len(dyn), 2)) * 2.0 - 1.0) * amp
    jit = torch.as_tensor(old)
    want = replicate_scene(one, 3).bodies.pos.clone()
    want[:, dyn, 0] += jit[..., 0].to(want.dtype)
    want[:, dyn, 2] += jit[..., 1].to(want.dtype)
    assert torch.equal(bits(state.bodies.pos), bits(want))
    layout = files["layout"].layout(**{k: cfg[k] for k in cfg["builder_args"]})
    moved, off = run.start_offsets(SEED, 3, [lb["dynamic"] for lb in layout],
                                   range(len(layout)), amp)
    assert moved.tolist() == dyn.tolist() and np.array_equal(off, old)
    assert run.ground_axes(params.gravity) == (0, 2)


TWO_ROBOTS = """
<mujoco model="two">
  <compiler angle="radian"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1"/>
    <body name="a" pos="0 0 0.5">
      <joint type="free"/>
      <geom type="box" size="0.1 0.1 0.1"/>
      <body name="a_leg" pos="0.1 0 -0.1">
        <joint name="a_hip" type="hinge" axis="0 1 0" limited="true" range="-1 0.6"/>
        <geom type="capsule" fromto="0 0 0  0 0 -0.2" size="0.03"/>
      </body>
    </body>
    <body name="b" pos="1 0 0.5">
      <joint type="free"/>
      <geom type="box" size="0.1 0.1 0.1"/>
      <body name="b_leg" pos="0.1 0 -0.1">
        <joint name="b_hip" type="hinge" axis="1 0 0"/>
        <geom type="capsule" fromto="0 0 0  0 0 -0.2" size="0.03"/>
      </body>
    </body>
    <body name="ball" pos="2 0 0.3">
      <joint type="free"/>
      <geom type="sphere" size="0.1"/>
    </body>
  </worldbody>
  <actuator>
    <position name="a_servo" joint="a_hip" kp="50"/>
    <motor name="b_motor" joint="b_hip" gear="2"/>
  </actuator>
</mujoco>
"""


@pytest.fixture
def two_robots(monkeypatch, f32):
    """A Z-up world of two free-rooted articulations (a servo on a limited
    hinge, a motor with gear 2 on a free one) and a free ball, as a builder
    of `rapier_tpu_torch.scenes`."""
    from rapier_tpu_torch import scenes
    from rapier_tpu_torch.loaders.mjcf import load_mjcf

    def two_robots_world(max_pairs, device):
        w = scenes.PhysicsWorld(gravity=(0.0, 0.0, -9.81), max_pairs=max_pairs, device=device)
        return w, load_mjcf(TWO_ROBOTS, w, use_multibody=True)

    monkeypatch.setattr(scenes, "two_robots_world", two_robots_world, raising=False)
    cfg = dict(builder="two_robots_world", builder_args=[], rad=0.1, max_pairs=64,
               max_solver_pairs=0, scenes=5)
    traffic = dict(precision="f32", jitter_rad=0.5, actions=dict(every=1, scale=0.5))
    return cfg, traffic


def test_a_z_up_world_moves_each_articulation_whole_in_x_and_y(two_robots):
    from rapier_tpu_torch.scenes import replicate_scene

    cfg, traffic = two_robots
    state, params, one, _ = run.build_batch(cfg, traffic, SEED, "cpu")
    assert run.ground_axes(params.gravity) == (0, 1)
    trees = one.multibodies.link_body.tolist()
    assert [len([b for b in t if b >= 0]) for t in trees] == [2, 2]
    movable, root = run.articulation_roots(one)
    d = (state.bodies.pos - replicate_scene(one, 5).bodies.pos).double()
    assert d[..., 2].abs().max() == 0 and d[:, 0].abs().max() == 0       # z, the floor
    for tree in trees:
        r = tree[0]
        assert all(root[b] == r for b in tree) and movable[tree].all()
        for b in tree:          # the same offset, rounded once at each body's position
            assert torch.allclose(d[:, b], d[:, r], rtol=0, atol=1e-7)
        # A free root's coordinates move with its body.
        q = state.multibodies.q[:, trees.index(tree), 0, :3] - one.multibodies.q[
            trees.index(tree), 0, :3]
        assert torch.equal(q, d[:, r].to(q.dtype))
    ball = [b for b in range(len(root)) if movable[b] and root[b] == b and b not in
            (trees[0][0], trees[1][0])]
    assert len(ball) == 1
    offs = torch.stack([d[:, trees[0][0]], d[:, trees[1][0]], d[:, ball[0]]])[..., :2]
    assert offs.abs().min() > 0 and offs.abs().max() <= 0.05 * (1 + 1e-6)
    assert not torch.equal(offs[0], offs[1])


def quadruped(scenes=3, every=1, scale=0.5, seed=SEED):
    cfg = dict(builder="quadruped_world", builder_args=["use_multibody"], use_multibody=True,
               rad=0.25, max_pairs=128, max_solver_pairs=0, scenes=scenes)
    traffic = dict(precision="f32", jitter_rad=0.2, actions=dict(every=every, scale=scale))
    state, params, one, robot = run.build_batch(cfg, traffic, seed, "cpu")
    return state, params, robot, run.Actions(robot, traffic["actions"], seed, scenes)


def test_actions_land_in_the_actuated_slots(two_robots, f32):
    cfg, traffic = two_robots
    state, _, one, robot = run.build_batch(cfg, traffic, SEED, "cpu")
    acts = run.Actions(robot, traffic["actions"], SEED, cfg["scenes"])
    mb = state.multibodies
    start = {f: getattr(mb, f).clone() for f in ("motor_target_pos", "motor_target_vel")}
    acts(state)
    u = run.Actions(robot, traffic["actions"], SEED, cfg["scenes"]).draw()
    assert u.abs().max() <= 1.0 and u.std() > 0.3
    # The servo on a limited hinge (-1, 0.6): the middle plus u 0.5 the
    # half-range; the motor: u 0.5 times its gear of 2.
    slots = {}
    for field, cols, index in robot.writes:
        for c, slot in zip(range(cols.start, cols.stop), zip(*(i.tolist() for i in index))):
            slots[(field, slot)] = c
    a_leg, b_leg = (tuple(one.multibodies.link_body[t].tolist()).index(
        robot.handles.bodies[n]) for t, n in ((0, "a_leg"), (1, "b_leg")))
    assert set(slots) == {("motor_target_pos", (0, a_leg, 3)), ("motor_target_vel", (1, b_leg, 3))}
    for (field, (t, link, axis)), c in slots.items():
        got = getattr(mb, field)[:, t, link, axis]
        if field == "motor_target_pos":
            want = (torch.tensor(-0.2) + u[:, c] * (0.5 * 0.8)) * 1.0
            assert got.min() >= -0.6 and got.max() <= 0.2
        else:
            want = u[:, c] * 0.5 * 2.0
        assert torch.allclose(got, want, rtol=0, atol=1e-6)
        getattr(mb, field)[:, t, link, axis] = start[field][:, t, link, axis]
    for f, x in start.items():                    # nothing else was written
        assert torch.equal(getattr(mb, f), x)


def test_the_same_seed_draws_the_same_targets(f32):
    def targets(seed):
        state, _, _, acts = quadruped(seed=seed)
        acts(state)
        first = state.multibodies.motor_target_pos.clone()
        acts(state)
        return first, state.multibodies.motor_target_pos

    a, b = targets(SEED), targets(SEED)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], targets(SEED + 1)[0])
    assert (a[0][..., 3] != 0).sum() == 3 * 8          # 8 servos a scene


def test_the_loop_holds_targets_between_draws_and_resets_to_the_start(f32):
    """every 2, an episode of 3, scenes at offsets 0, 1, 2: scene (3 - t) % 3
    resets before step t, and a draw comes at t = 0, 2 and 4."""
    state, params, _, acts = quadruped(every=2)
    start = state.multibodies.motor_target_pos.clone()
    seen = []

    def step(s, p):
        seen.append(s.multibodies.motor_target_pos.clone())
        z = torch.zeros(s.bodies.pos.shape[0], dtype=torch.int32)
        return s, type("Events", (), dict(broadphase_overflow=z, solver_overflow=z,
                                          unsupported_pairs=z))()

    loop = run.Loop(state, params, [0, 1, 2], 3, step, acts)
    for _ in range(3):
        loop()
    _, (before3, _) = loop(keep=[0, 2])
    _, (before4, _) = loop(keep=[1])
    w0, t1, w2, t3, w4 = seen
    assert not torch.equal(w0[0], start[0]) and not torch.equal(w2[1], w0[1])
    assert torch.equal(t1[:2], w0[:2]) and torch.equal(t1[2], start[2])     # held; reset
    assert torch.equal(t3[1:], w2[1:]) and torch.equal(t3[0], start[0])
    assert not torch.equal(w4[1], t3[1])
    assert torch.equal(before3.multibodies.motor_target_pos, t3[[0, 2]])
    assert torch.equal(before4.multibodies.motor_target_pos, w4[[1]])


def test_a_robot_with_its_own_reference_runs_from_new_files(tmp_path, f32):
    """A configuration, layout, traffic with actions, limits and reference
    package, all new files in a bench directory of their own: the run reads
    correct, its reference saw the world's Z-up gravity, the articulations
    and the targets the policy wrote."""
    bench = robot_bench.write(tmp_path, scenes=4, episode_steps=6, every=2)
    out, checks, found = run.run_cell(bench, robot_bench.CELL, SEED, 1.0, False, device="cpu",
                                      root=tmp_path)
    assert out["correct"] and out["failed"] == 0 and found["samples"] == 6, checks
    assert checks["start_pos_gap_m"]["value"] < 1e-6 and checks["start_shape_gap"]["value"] < 1e-6
    params, states = robot_bench.seen(tmp_path)
    assert [float(g) for g in params[0].gravity] == pytest.approx([0.0, 0.0, -9.81])
    targets = torch.cat([s.multibodies.motor_target_pos for s in states])
    assert targets.shape[0] == 6 and (targets[..., 3] != 0).any()
    assert set(out["metrics"]) == {"env_steps_per_s", "setup_s"}     # no card: no peak
