"""The port's contact solve against the reference's Pallas contact sweep.

One step's solve inputs are captured from the reference pipeline (the
vmapped step on the parity batch in contact; scene 1 differs from scene 0)
and fed to `pallas_sweep.solve_from_manifolds(..., interpret=True)`, as
tests/test_pallas_sweep.py runs it on the CPU, and to the port's plain
version.  Body tables agree to 1e-5 and the impulse block to 1e-4
(summation order).  The CUDA kernel itself runs on the card only:
chip_smoke.py and tests/test_torch_cuda.py hold it against this plain
version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu.dynamics.solver import pallas_sweep
from rapier_tpu.pipeline import physics_pipeline as jpp
from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

SCALARS = ("dt_sub", "inv_dt_sub", "erp_inv_dt", "cfm_factor", "allowed_lin_err",
           "max_corrective_velocity", "warmstart_coeff")
STATIC = dict(n_sub=4, pgs_iters=1, stab_iters=1, max_colors=16)


@pytest.fixture(scope="module")
def captured():
    """Per-scene solve_from_manifolds arguments of one reference step."""
    calls = []

    def record(sb, **kw):
        arrays = {k: v for k, v in kw.items() if k not in
                  ("n_sub", "pgs_iters", "stab_iters", "interpret", "max_colors")}
        jax.debug.callback(
            lambda s, a: calls.append((jax.tree.map(np.asarray, s),
                                       jax.tree.map(np.asarray, a))), sb, arrays)
        return sb, jnp.zeros((14, kw["b1"].shape[0]))

    _, jparams = tp.jax_world()
    state = jax.tree.map(jnp.asarray, tp.settled_batch())
    original = pallas_sweep.solve_from_manifolds
    pallas_sweep.solve_from_manifolds = record
    try:
        out = jax.jit(jax.vmap(jpp.step, in_axes=(0, None)))(state, jparams)
        jax.block_until_ready(out)
    finally:
        pallas_sweep.solve_from_manifolds = original
    assert len(calls) == tp.B
    sb = jax.tree.map(lambda *xs: np.stack(xs), *[c[0] for c in calls])
    kw = {k: np.stack([c[1][k] for c in calls]) for k in calls[0][1]}
    return sb, kw


@pytest.fixture(scope="module")
def reference_solve():
    def solve(sb, lanes, scalars):
        return pallas_sweep.solve_from_manifolds(sb, **lanes, **scalars,
                                                 interpret=True, **STATIC)
    return jax.jit(jax.vmap(solve, in_axes=(0, 0, None)))


def _both(sb, kw, reference_solve):
    lanes = {k: v for k, v in kw.items() if k not in SCALARS}
    scalars = {k: kw[k][0] for k in SCALARS}
    ref_sb, ref_imp = reference_solve(
        jax.tree.map(jnp.asarray, sb), jax.tree.map(jnp.asarray, lanes),
        jax.tree.map(jnp.asarray, scalars))
    port_sb = SolverBodies(*(torch.from_numpy(np.array(x)) for x in sb))
    got_sb, got_imp = cs.solve_from_manifolds(
        port_sb, **{k: torch.from_numpy(np.array(v)) for k, v in lanes.items()},
        **{k: float(v) for k, v in scalars.items()}, **STATIC)
    for name, r, g in zip(ref_sb._fields, ref_sb, got_sb):
        tp.assert_close(g.numpy(), r, 1e-5, f"sb.{name}")
    tp.assert_close(got_imp.numpy(), ref_imp, 1e-4, "impulse block")
    return got_sb, got_imp


def test_plain_matches_pallas_kernel(captured, reference_solve):
    sb, kw = captured
    assert int(kw["valid"].sum()) > 0, "no solver lanes in the captured step"
    # The scenes of the batch differ, so per-scene results are exercised.
    assert not np.array_equal(kw["point"][0], kw["point"][1])
    got_sb, got_imp = _both(sb, kw, reference_solve)
    assert not torch.equal(got_imp[0], got_imp[1])


def test_overflow_color(captured, reference_solve):
    """A constructed case: per scene, four solver lanes made to share one
    dynamic body and moved into the Luby overflow color max_colors - 1,
    whose lanes accumulate their deltas (Jacobi) instead of Gauss-Seidel."""
    sb, kw = captured
    kw = {k: v.copy() for k, v in kw.items()}
    mc = STATIC["max_colors"]
    for s in range(tp.B):
        lanes = np.flatnonzero(kw["valid"][s])[:4]
        assert len(lanes) == 4 and kw["dyn2"][s, lanes[0]]
        kw["b2"][s, lanes] = kw["b2"][s, lanes[0]]
        kw["dyn2"][s, lanes] = True
        kw["color"][s, lanes] = mc - 1
    kw["num_colors"][:] = mc
    _both(sb, kw, reference_solve)


def _torch_args(kw):
    return {k: (float(v[0]) if k in SCALARS else torch.from_numpy(np.array(v)))
            for k, v in kw.items()}


def _drop_lanes(kw):
    """The captured inputs with every other valid lane of each scene marked
    invalid; returns (inputs, the dropped lanes' mask [B, K])."""
    kw = {k: v.copy() for k, v in kw.items()}
    dropped = np.zeros_like(kw["valid"])
    for s in range(tp.B):
        dropped[s, np.flatnonzero(kw["valid"][s])[::2]] = True
    kw["valid"] = kw["valid"] & ~dropped
    assert dropped.any() and kw["valid"].any()
    return kw, dropped


def test_unsolved_lanes_take_the_closed_form(captured):
    """The impulse rows of a lane that is not valid are a closed form of its
    warmstart inputs; the kernels write them so, without solving the lane."""
    sb, kw = captured
    kw, _ = _drop_lanes(kw)
    port_sb = SolverBodies(*(torch.from_numpy(np.array(x)) for x in sb))
    args = _torch_args(kw)
    _, imp = cs.solve_plain(port_sb, **args, **STATIC)
    closed = tp.unsolved_impulses(args["ws_n"], args["ws_t"], args["ws_tw"],
                                  args["point_active"], args["warmstart_coeff"],
                                  STATIC["n_sub"])
    invalid = ~args["valid"].unsqueeze(1).expand_as(imp)
    assert int(invalid.sum()) > 0
    assert torch.equal(imp[invalid], closed[invalid])


def test_unsolved_lane_geometry_changes_nothing(captured):
    """Changing an invalid lane's normal, points, friction and distances
    leaves the body tables and the solved lanes' impulses as they were: the
    kernels may skip such lanes."""
    sb, kw = captured
    kw, dropped = _drop_lanes(kw)
    port_sb = SolverBodies(*(torch.from_numpy(np.array(x)) for x in sb))
    sb_a, imp_a = cs.solve_plain(port_sb, **_torch_args(kw), **STATIC)
    rng = np.random.default_rng(11)
    moved = {k: v.copy() for k, v in kw.items()}
    for name in ("normal", "point", "friction", "dist"):
        noise = rng.normal(0.0, 0.5, moved[name].shape).astype(moved[name].dtype)
        moved[name] = np.where(dropped[(slice(None),) + (None,) * (moved[name].ndim - 2)],
                               moved[name] + noise, moved[name])
    assert not np.array_equal(moved["normal"], kw["normal"])
    sb_b, imp_b = cs.solve_plain(port_sb, **_torch_args(moved), **STATIC)
    assert all(torch.equal(x, y) for x, y in zip(sb_a, sb_b))
    valid = torch.from_numpy(kw["valid"]).unsqueeze(1).expand_as(imp_a)
    assert torch.equal(imp_a[valid], imp_b[valid])


def test_cpu_tensors_run_the_plain_version(captured):
    sb, kw = captured
    port_sb = SolverBodies(*(torch.from_numpy(np.array(x)) for x in sb))
    args = {k: (float(v[0]) if k in SCALARS else torch.from_numpy(np.array(v)))
            for k, v in kw.items()}
    launches = cs.KERNEL.launches
    a = cs.solve_from_manifolds(port_sb, **args, **STATIC)
    b = cs.solve_plain(port_sb, **args, **STATIC)
    assert cs.KERNEL.launches == launches
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert torch.equal(a[1], b[1])


def test_kernel_launch_rejects_non_cuda_tensors():
    b, k, n1 = 2, 128, 33
    with pytest.raises(ValueError, match="CUDA"):
        cs.KERNEL.launch(torch.zeros(b, cs.MAN_ROWS, k), torch.zeros(b, 4, k, dtype=torch.int32),
                         torch.zeros(b, cs.BODY_ROWS, n1), torch.zeros(b, n1, dtype=torch.int32),
                         torch.zeros(b, dtype=torch.int32), n_sub=4, pgs_iters=1,
                         stab_iters=1, max_colors=16, scalars=(0.0,) * 7)


def test_unsupported_device_raises(captured):
    sb, kw = captured
    meta_sb = SolverBodies(*(torch.empty(x.shape, device="meta") for x in sb))
    args = {k: (float(v[0]) if k in SCALARS else torch.from_numpy(np.array(v)))
            for k, v in kw.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        cs.solve_from_manifolds(meta_sb, **args, **STATIC)
