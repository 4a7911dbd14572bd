"""The impulse-joint step of rapier_tpu_torch against rapier_tpu's at the
scenes' own 4 substeps, beside a witness of how far the reference departs
from itself.

tests/test_torch_joint_step.py holds both joint scenes to the reference at
1 substep.  Here they run 4 substeps a step, as on the card, so the port's
row rebuild from each substep's poses and its kept row slots
(`SimParams.joint_slots`) run four times a step.  The reference's step
compiles once for both scenes (`joint_starts`; ~4 minutes on a CPU).  Over
20 steps from the same start:

- pair keys and touching flags equal, positions and rotations within 1e-4,
  velocities within 1e-3, at every step;
- `joints.impulses`: the port's largest gap from the reference, as a share
  of that step's largest impulse, is no larger than the reference's own
  largest gap from a second reference run whose start differs by 1 ulp in
  one body's height (body 1: joints3's first chain link, the quadruped's
  trunk).  At 4 substeps that witness parts joints3's by more than the 1e-3
  of the largest impulse that the 1-substep file holds (2.7e-3 at step 6;
  the port's largest is 1.6e-3, at step 19): ROADMAP R9.
"""

import numpy as np
import pytest

from test_torch_common import (
    assert_joint_impulses_agree,
    assert_trajectories_agree,
    joint_rollouts,
    joint_starts,
    joint_step,
    reference_rollout,
)

N_STEPS = 20
SUBSTEPS = 4
NUDGED_BODY = 1


def _nudged(batch, params):
    """`batch` with body NUDGED_BODY 1 ulp higher (along gravity's axis)
    in every scene."""
    import jax

    out = jax.tree.map(np.array, batch)
    up = int(np.argmax(np.abs(np.asarray(params.gravity))))
    for name in ("pos", "next_pos"):
        a = getattr(out.bodies, name)
        a[:, NUDGED_BODY, up] = np.nextafter(a[:, NUDGED_BODY, up], np.float32(np.inf))
    return out


@pytest.fixture(scope="module")
def runs():
    """{scene: (reference, reference from the nudged start, port)}."""
    starts = joint_starts(SUBSTEPS)
    f = joint_step()
    traj = joint_rollouts(starts, N_STEPS, f)
    return {name: (traj[name][1],
                   reference_rollout(f, _nudged(batch, params), params, N_STEPS),
                   traj[name][2])
            for name, (batch, params) in starts.items()}


def _impulse_shares(ref, other):
    """Per step: the largest |other - ref| joint impulse over the step's
    largest reference impulse."""
    out = []
    for rs, os_ in zip(ref, other):
        r = np.asarray(rs.joints.impulses)
        out.append(float(np.abs(np.asarray(os_.joints.impulses) - r).max() / np.abs(r).max()))
    return np.array(out)


@pytest.mark.parametrize("scene", ["joints3", "quadruped"])
def test_bodies_agree_with_reference_at_four_substeps(runs, scene):
    ref, _nudged_ref, port = runs[scene]
    touching = assert_trajectories_agree(ref, port)
    if scene == "quadruped":
        assert touching >= 4          # the feet stay on the floor


@pytest.mark.parametrize("scene", ["joints3", "quadruped"])
def test_joint_impulses_part_no_farther_than_the_reference_from_itself(runs, scene):
    ref, nudged_ref, port = runs[scene]
    port_gap, witness = _impulse_shares(ref, port), _impulse_shares(ref, nudged_ref)
    if scene == "quadruped":          # it holds the 1-substep tolerance too
        assert_joint_impulses_agree(ref, port)
    assert port_gap.max() <= witness.max(), (
        f"the port parts from the reference by {port_gap.max():.3e} of the largest "
        f"impulse (step {port_gap.argmax() + 1}); a 1-ulp nudge parts the reference "
        f"from itself by {witness.max():.3e}")
