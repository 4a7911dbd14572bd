"""rapier_tpu_torch's non-kernel contact solves against the reference: the
blocked solve of large scenes and the masked color sweep.

The blocked solve runs above DENSE_ROUTE_ELEMS lane x body elements (a
1,496-box pyramid and up); here the threshold is set to 0 in both packages,
as tests/test_large_scene_routing.py does for the reference, so a 14-box
pyramid takes it.  Both packages step the same numpy batch of B = 2 scenes
(scene 1 perturbed by seeded noise).  To keep the reference's compile short
the pyramid runs 8 colors and one substep, so one step unrolls 16 block
passes.  Tolerances: positions 1e-4, velocities 1e-3 per step (summation
order only: XLA contracts multiply-adds, and the segment sums add in another
order); pair keys and touching flags equal.  The 14 compared steps follow a
30-step settle, while the upper levels land, and are free of threshold ties
(ROADMAP R1b); later steps of this pile amplify any 1e-6 difference about
twofold a step, the port against itself as much as against the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rapier_tpu.types as jt
import rapier_tpu.utils.routing as jrt
import test_torch_common as tp
from rapier_tpu.dynamics.solver import contact_constraints as jcc
from rapier_tpu.dynamics.solver import velocity_solver as jvs
from rapier_tpu.scenes import pyramid3_world, stack_world
import rapier_tpu_torch.pipeline.physics_pipeline as pp
from rapier_tpu_torch.dynamics.solver import velocity_solver as pvs
from rapier_tpu_torch.types import from_numpy

B = 2
N_STEPS = 14
PYRAMID_SETTLE = 30


@pytest.fixture(scope="module")
def pyramid():
    """The stack-3 pyramid on the grid broad phase, settled by the port's
    kernel path: (reference numpy batch, reference params)."""
    w = pyramid3_world(stack_height=3)
    w.params = w.params.replace(broad_phase=int(jt.BroadPhaseKind.GRID),
                                solver_backend="jax", max_colors=8,
                                num_solver_iterations=1)
    batch, jparams = tp.perturbed_batch(w, (1.0, 1.0, 1.0), 7)
    params = from_numpy(jparams)
    state = from_numpy(batch)
    for _ in range(PYRAMID_SETTLE):
        state, _ = pp.step(state, params.replace(solver_backend="auto"))
    return tp.to_reference(state), jparams


def test_blocked_step_matches_reference(pyramid):
    start, jparams = pyramid
    with pytest.MonkeyPatch.context() as mp:
        tp.blocked_thresholds(mp)
        path, ref, port = tp.rollouts(start, jparams, N_STEPS)
    assert path == "blocked"
    # Box-box and box-ground lanes touch in every compared step.
    assert tp.assert_trajectories_agree(ref, port) > 30


def test_masked_sweep_step_matches_reference():
    batch, jparams = tp.perturbed_batch(stack_world(n=6), (1.0, 0.0, 1.0), 11)
    jparams = jparams.replace(solver_backend="jax")
    path, ref, port = tp.rollouts(batch, jparams, N_STEPS)
    assert path == "masked"
    assert tp.assert_trajectories_agree(ref, port) >= 12


def _ref_blocks(b1s, b2s, caps, n):
    """The reference pipeline's blocked routing (physics_pipeline.py:720-755)."""
    oh1 = jcc.RoutePlan(b1s, None, jrt.make_segment_plan(jnp.concatenate([b1s, b2s]), n + 1))
    blocks, s0 = [], 0
    for ci, w in enumerate(caps):
        b1c, b2c = b1s[s0:s0 + w], b2s[s0:s0 + w]
        segp = jrt.make_segment_plan(jnp.concatenate([b1c, b2c]), n + 1)
        if ci < len(caps) - 1:
            inv = jnp.where(segp.ends > segp.starts,
                            jnp.take(segp.perm, jnp.minimum(segp.starts, 2 * w - 1)), 2 * w)
            blocks.append((ci, s0, w, jcc.RoutePlan(b1c, None, None, inv),
                           jcc.RoutePlan(b2c, None)))
        else:
            blocks.append((ci, s0, w, jcc.RoutePlan(b1c, None, segp), jcc.RoutePlan(b2c, None)))
        s0 += w
    return blocks, oh1, jcc.RoutePlan(b2s, None)


def test_solve_blocked_alone_matches_reference(pyramid, monkeypatch):
    """One blocked solve on identical inputs (the port's step's own): body
    velocities within 1e-5, impulses within 1e-4."""
    start, jparams = pyramid
    tp.blocked_thresholds(monkeypatch)
    captured = {}
    solve_blocked = pvs.solve_blocked

    def record(bodies, sb, cons, blocks, route, active, params):
        out = solve_blocked(bodies, sb, cons, blocks, route, active, params)
        captured.update(bodies=bodies, sb=sb, cons=cons, blocks=blocks, active=active, out=out)
        return out

    monkeypatch.setattr(pvs, "solve_blocked", record)
    pp.step(from_numpy(start), from_numpy(jparams))
    bodies, sb, cons = captured["bodies"], captured["sb"], captured["cons"]
    caps = tuple(w for _, _, w, _ in captured["blocks"])
    n = bodies.pos.shape[1]
    sb_out, cons_out = captured["out"]
    assert int(cons.valid.sum()) > 30
    for s in range(B):
        rb = jt.Bodies(**{
            name: jnp.asarray(np.asarray(getattr(bodies, name)[s]).astype(
                np.asarray(getattr(start.bodies, name)).dtype))
            for name in jt.Bodies.__dataclass_fields__})
        rsb = jcc.SolverBodies(*(jnp.asarray(x[s].numpy()) for x in sb))
        rcons = jcc.ContactConstraints(**{
            name: (jnp.float32(v) if not isinstance(v, torch.Tensor) else jnp.asarray(
                v[s].numpy().astype(np.int32) if v.dtype == torch.int64 else v[s].numpy()))
            for name, v in cons._asdict().items()})
        blocks, oh1, oh2 = _ref_blocks(rcons.b1, rcons.b2, caps, n)
        ref_sb, ref_cons = jvs.solve_blocked(rb, rsb, rcons, blocks, oh1, oh2,
                                             jnp.asarray(captured["active"][s].numpy()), jparams)
        for name in ("v_lin", "v_ang"):
            tp.assert_close(getattr(sb_out, name)[s], getattr(ref_sb, name), 1e-5,
                            f"scene {s} {name}")
        for name in ("impulse", "impulse_acc", "tan_impulse", "tan_impulse_acc",
                     "twist_impulse", "twist_impulse_acc"):
            tp.assert_close(getattr(cons_out, name)[s], getattr(ref_cons, name), 1e-4,
                            f"scene {s} {name}")


@pytest.mark.parametrize("name, kw", [
    ("pyramid3_world", dict(stack_height=3)),
    ("stack_world", dict(n=4)),
    ("pyramid_world", dict(base_count=4)),
])
def test_scene_builds_match_reference(name, kw):
    import dataclasses

    import rapier_tpu.scenes as jscenes
    import rapier_tpu_torch.scenes as pscenes

    rw, pw = getattr(jscenes, name)(**kw), getattr(pscenes, name)(device="cpu", **kw)
    rs, ps = rw.build(), pw.build()
    assert pw.params.shape_types_present == rw.params.shape_types_present
    for part in ("bodies", "colliders", "contacts"):
        r, p = getattr(rs, part), getattr(ps, part)
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert a.dtype == d.dtype and np.array_equal(a, d), f"{part}.{f.name}"
