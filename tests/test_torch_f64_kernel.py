"""The contact-sweep kernel's route at f64 against the masked route at f64,
on the CPU (where the kernel route runs the kernel's plain version): the
bench scene at 2 layers of 3 x 3 (max_pairs 512, max_solver_pairs 256),
built at f64 and settled 45 steps.

- Trajectories: 10 steps on each route from the settled state, held to the
  f64 parity rule (`test_torch_common.f64_compare`) with the masked route's
  own 1-ulp witness (its run from the state with one body's height 1 ulp
  higher).
- The float32 roundings of ROADMAP R31: the kernel route compacts its lanes
  as the masked route does, bit for bit, and hands back float32-valued
  impulses and the constraints' float32 `cfm_factor`.
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu_torch import precision
from rapier_tpu_torch.pipeline import physics_pipeline as pp

SETTLE = 45
STEPS = 10


@functools.lru_cache(maxsize=None)
def _settled():
    """(state, params) of the bench at 2 layers of 3 x 3 at f64, settled."""
    from rapier_tpu_torch.scenes import mixed_primitives_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    precision.set_precision("f64")
    try:
        w = mixed_primitives_world(2, 3, max_pairs=512, device="cpu")
        w.params = w.params.replace(max_solver_pairs=256)
        state = from_numpy(replicate_scene(w.build(), 1))
    finally:
        precision.set_precision("f32")
    assert pp.solve_path(state, w.params) == "kernel"
    for _ in range(SETTLE):
        state, _ = pp.step(state, w.params)
    assert state.bodies.pos.dtype == torch.float64
    assert int(state.contacts.touching.sum()) >= 9
    return state, w.params


def _masked(params):
    return params.replace(solver_backend="jax")


def test_kernel_route_matches_the_masked_route_at_f64():
    from rapier_tpu_torch.types import tree_map

    state, params = _settled()
    assert pp.solve_path(state, _masked(params)) == "masked"
    witness = tree_map(lambda x: x.clone(), state)
    for name in ("pos", "next_pos"):
        x = getattr(witness.bodies, name)
        x[0, 1, 1] = torch.nextafter(x[0, 1, 1], torch.tensor(np.inf, dtype=x.dtype))
    kernel, _ = tp.port_f64_rollout(state, params, STEPS)
    masked, _ = tp.port_f64_rollout(state, _masked(params), STEPS)
    wit, _ = tp.port_f64_rollout(witness, _masked(params), STEPS)
    tp.f64_compare(masked, kernel, wit, tp.F64_FIELDS, "kernel route against masked route")
    assert tp.trajectory_gap(masked, wit, ("bodies.pos",))["bodies.pos"] > 0


def _f32_valued(x):
    return bool(torch.equal(x.float().double(), x))


def test_kernel_route_rounds_as_the_masked_route_at_f64(monkeypatch):
    """One step on each route: the kernel's compacted lanes equal the
    masked route's bit for bit (its float fields rounded through float32,
    R31), the kernel takes the constraints' float32 `cfm_factor`, and both
    routes route float32-valued impulse blocks back to the pair lanes."""
    state, params = _settled()
    got = {}
    solve = pp.solve_from_manifolds

    def kernel_inputs(sb, **kw):
        got["kernel"] = kw
        return solve(sb, **kw)

    generate, masked_solve, scatter_back = pp.cc.generate, pp.vs.solve, pp._scatter_back

    def masked_lanes(man, sb, prev_impulse, color, n):
        got["man"], got["prev_impulse"] = man, prev_impulse
        return generate(man, sb, prev_impulse, color, n)

    def masked_constraints(bodies, sb, cons, *a, **k):
        got["cons"] = cons
        return masked_solve(bodies, sb, cons, *a, **k)

    def routed_back(imp, *a):
        got.setdefault("routed", []).append(imp)
        return scatter_back(imp, *a)

    monkeypatch.setattr(pp, "_scatter_back", routed_back)
    monkeypatch.setattr(pp, "solve_from_manifolds", kernel_inputs)
    monkeypatch.setattr(pp.cc, "generate", masked_lanes)
    monkeypatch.setattr(pp.vs, "solve", masked_constraints)
    pp.step(state, params)
    pp.step(state, _masked(params))
    k, man, cons = got["kernel"], got["man"], got["cons"]
    pairs = dict(normal=man.normal, point=man.point, dist=man.dist, friction=man.friction,
                 restitution=man.restitution, prev_impulse=got["prev_impulse"],
                 ws_n=cons.impulse, ws_t=cons.tan_impulse, ws_tw=cons.twist_impulse)
    assert int(k["valid"].sum()) >= 9 and torch.equal(k["valid"], man.solver_pair)
    for name, masked in pairs.items():
        assert k[name].dtype == torch.float64, name
        assert torch.equal(k[name], masked), name
        assert _f32_valued(k[name]), name
    assert not _f32_valued(state.bodies.pos)
    assert k["cfm_factor"] == float(np.float32(k["cfm_factor"]))
    assert len(got["routed"]) == 2
    for imp in got["routed"]:
        assert imp.dtype == torch.float64 and _f32_valued(imp)
