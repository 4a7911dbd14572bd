"""The impulse-joint step of rapier_tpu_torch against rapier_tpu's.

Two scenes, each batched over B = 2 with scene 1's dynamic bodies moved by
seeded noise (every joint starts with an error to correct), 20 steps:

- joints3, the joint zoo of examples/joints3.py (`scenes.joints3_world`,
  built with the port's builders; the numpy state goes to both packages):
  a revolute chain, a prismatic slider with a position motor and limits, a
  fixed-joint lattice and a spherical rope with swing limits;
- the quadruped as eight impulse joints with PD servos on a halfspace floor
  (`quadruped_world(use_multibody=False)`), scene 1's servo targets also
  moved; its feet touch the floor from the first step.

The reference runs `jax.vmap(step)` under jit; a scene with joints takes its
masked JAX sweep whatever the backend, as the port's takes its masked sweep.
Its joint rows unroll, so its compile takes ~50 s a substep on a CPU.  So
both scenes run 1 substep here (tests/test_torch_joint_substeps.py runs the
scenes' own 4) and share one compiled step (`joint_starts`: equal
capacities, the quadruped's joint table padded to joints3's 24 with
disabled joints, one shape census).  At every step: pair keys and touching
flags equal, positions and rotations within 1e-4, velocities within 1e-3,
and `joints.impulses` within 1e-3 of the step's largest impulse.  The port
builds only the row slots its joint table uses (`SimParams.joint_slots`, as
`PhysicsWorld.build` sets it).
"""

import dataclasses

import numpy as np
import pytest

from test_torch_common import (
    assert_joint_impulses_agree,
    assert_trajectories_agree,
    joint_rollouts,
    joint_starts,
    joint_step,
)

N_STEPS = 20
SUBSTEPS = 1


@pytest.fixture(scope="module")
def starts():
    """{scene: (numpy batch, reference params)}, one static configuration."""
    return joint_starts(SUBSTEPS)


@pytest.fixture(scope="module")
def trajectories(starts):
    return joint_rollouts(starts, N_STEPS, joint_step())


@pytest.mark.parametrize("scene", ["joints3", "quadruped"])
def test_joint_scene_takes_the_masked_sweep(trajectories, starts, scene):
    path, _ref, port = trajectories[scene]
    assert path == "masked"
    assert starts[scene][0].joints.n == 24 and port[-1].joints is not None


@pytest.mark.parametrize("scene", ["joints3", "quadruped"])
def test_bodies_agree_with_reference(trajectories, scene):
    _path, ref, port = trajectories[scene]
    touching = assert_trajectories_agree(ref, port)
    if scene == "quadruped":
        assert touching >= 4          # the feet stay on the floor


@pytest.mark.parametrize("scene", ["joints3", "quadruped"])
def test_joint_impulses_agree_with_reference(trajectories, scene):
    _path, ref, port = trajectories[scene]
    assert_joint_impulses_agree(ref, port)


@pytest.mark.parametrize("scene", ["joints3", "quadruped"])
def test_joint_table_is_carried_unchanged(trajectories, starts, scene):
    _path, _ref, port = trajectories[scene]
    start = starts[scene][0]
    for f in dataclasses.fields(port[-1].joints):
        if f.name != "impulses":
            assert np.array_equal(getattr(port[-1].joints, f.name),
                                  getattr(start.joints, f.name)), f.name
