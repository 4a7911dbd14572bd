"""The blocked solve's Jacobi tail against the reference, on a pile where the
reference's own layout would drop lanes.

The port's blocked layout (`coloring.solve_caps`) widens the last block, the
Jacobi tail that takes every lane the Luby rounds leave, to all P pair
lanes; the reference's (`block_caps`) stops it at its cap and drops the
lanes past it for the step (ROADMAP R7).  Here the reference is given the
widened layout by monkeypatching its `block_caps`, and both packages step a
pile where more than 256 lanes reach the tail: the stack-8 pyramid (204
boxes, P = 1,664 lanes) with 2 colors and max_solver_pairs 1,024, so the
tail's own cap is 256, and once the pile has landed the reference's layout
drops some 50-120 lanes a step.  B = 2 (scene 1 perturbed by seeded noise),
one substep, the dense-routing limits at 0 in both packages, as in
tests/test_torch_large_scene.py, and its tolerances: positions 1e-4,
velocities 1e-3, pair keys and touching flags equal.
"""

import pytest

import rapier_tpu.dynamics.solver.coloring as jcol
import rapier_tpu.types as jt
import test_torch_common as tp
from rapier_tpu.scenes import pyramid3_world
import rapier_tpu_torch.dynamics.solver.coloring as pcol
import rapier_tpu_torch.pipeline.physics_pipeline as pp
from rapier_tpu_torch.types import from_numpy

STACK = 8
MAX_COLORS = 2
MAX_SOLVER_PAIRS = 1024
SETTLE = 40
N_STEPS = 8


def test_widened_tail_matches_reference(monkeypatch):
    w = pyramid3_world(stack_height=STACK)
    w.params = w.params.replace(broad_phase=int(jt.BroadPhaseKind.GRID),
                                solver_backend="jax", max_colors=MAX_COLORS,
                                num_solver_iterations=1, max_solver_pairs=MAX_SOLVER_PAIRS)
    batch, jparams = tp.perturbed_batch(w, (1.0, 1.0, 1.0), 3)
    tp.blocked_thresholds(monkeypatch)
    p_lanes = batch.contacts.pair_key.shape[-1]
    reference_caps = jcol.block_caps

    def widened(total, max_colors, min_cap=256):
        caps = reference_caps(total, max_colors, min_cap)
        return caps[:-1] + (max(caps[-1], p_lanes),)

    monkeypatch.setattr(jcol, "block_caps", widened)
    assert widened(MAX_SOLVER_PAIRS, MAX_COLORS) == pcol.solve_caps(
        MAX_SOLVER_PAIRS, p_lanes, MAX_COLORS)
    assert reference_caps(MAX_SOLVER_PAIRS, MAX_COLORS)[-1] == 256

    params = from_numpy(jparams)
    state = from_numpy(batch)
    for _ in range(SETTLE):
        state, _ = pp.step(state, params)

    # Per port step: the fewest lanes in the tail over the scenes, and the
    # fewest the reference's own layout would drop.
    seen = []
    coloring = pp.color_constraints_blocked

    def record(b1, b2, dyn1, dyn2, valid, n, caps):
        out = coloring(b1, b2, dyn1, dyn2, valid, n, caps)
        dropped = coloring(b1, b2, dyn1, dyn2, valid, n,
                           reference_caps(MAX_SOLVER_PAIRS, MAX_COLORS))[2]
        seen.append((int((out[0] == len(caps) - 1).sum(-1).min()), int(dropped.min())))
        return out

    monkeypatch.setattr(pp, "color_constraints_blocked", record)
    path, ref, port = tp.rollouts(tp.to_reference(state), jparams, N_STEPS)
    assert path == "blocked"
    assert len(seen) == N_STEPS
    assert min(t for t, _ in seen) > 256, seen
    assert min(d for _, d in seen) > 0, seen
    assert tp.assert_trajectories_agree(ref, port) > 300
