"""Shared inputs for the rapier_tpu_torch parity tests (tests/test_torch_*.py);
this module holds no tests of its own.

Every parity test uses ONE scene shape, so the JAX step compiles for a single
shape: `mixed_primitives_world(num_layers=3, grid=3, max_pairs=256)` with
`max_solver_pairs=128`, batched over B = 2 scenes whose dynamic bodies are
shifted apart by seeded numpy noise in scene 1.  `settled_batch()` advances
that batch with the port until the bodies touch down, so the geometry
and solver tests see real manifolds.  States cross between the packages as
numpy leaves.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

B = 2
# The bottom layer lands after ~38 steps: at 40, 18 pairs touch.  The 20
# steps after it stay free of threshold ties (a contact point at the
# capsule-cuboid dedup distance or the prediction distance), which longer
# free runs meet: XLA contracts multiply-adds into FMAs, so the reference
# rounds differently from the port and such a tie can fall either way.
SETTLE_STEPS = 40
MAX_SOLVER_PAIRS = 128


@functools.lru_cache(maxsize=None)
def jax_world():
    """(reference SceneState with numpy leaves, reference SimParams)."""
    from rapier_tpu.scenes import mixed_primitives_world

    w = mixed_primitives_world(num_layers=3, grid=3, max_pairs=256)
    w.params = w.params.replace(max_solver_pairs=MAX_SOLVER_PAIRS,
                                solver_backend="pallas")
    return w.build(), w.params


def port_params():
    from rapier_tpu_torch.types import from_numpy

    return from_numpy(jax_world()[1])


def initial_batch():
    """The reference's batched numpy state; scene 1 perturbed."""
    from rapier_tpu.scenes import replicate_scene

    state, _ = jax_world()
    batch = replicate_scene(state, B)
    rng = np.random.default_rng(1234)
    dyn = np.asarray(state.bodies.body_type) == 0
    noise = rng.normal(0.0, 0.05, (int(dyn.sum()), 3)).astype(np.float32)
    for name in ("pos", "next_pos"):
        arr = getattr(batch.bodies, name)
        arr[1, dyn] += noise
    return batch


def to_reference(state):
    """A port state (numpy or tensor leaves) as a reference SceneState with
    numpy leaves of the reference's dtypes."""
    import rapier_tpu.types as jt
    from rapier_tpu_torch.types import to_numpy

    ref_state, _ = jax_world()
    np_state = to_numpy(state)
    parts = {}
    for name, cls in (("bodies", jt.Bodies), ("colliders", jt.Colliders),
                      ("contacts", jt.Contacts)):
        ref_part = getattr(ref_state, name)
        parts[name] = cls(**{
            f.name: np.asarray(getattr(getattr(np_state, name), f.name)).astype(
                np.asarray(getattr(ref_part, f.name)).dtype)
            for f in dataclasses.fields(cls)
        })
    return jt.SceneState(step_count=np.asarray(np_state.step_count, np.int32),
                         **parts)


@functools.lru_cache(maxsize=None)
def settled_batch(steps: int = SETTLE_STEPS):
    """The batch after `steps` port steps: bodies in contact, a warm contact
    cache.  Returned as a reference SceneState with numpy leaves."""
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.types import from_numpy

    params = port_params()
    state = from_numpy(initial_batch())
    for _ in range(steps):
        state, _ = step(state, params)
    return to_reference(state)


def assert_equal(actual, desired, what, mask=None):
    a, d = np.asarray(actual), np.asarray(desired)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    if mask is not None:
        a, d = a[mask], d[mask]
    bad = np.flatnonzero(a.astype(np.int64) != d.astype(np.int64))
    assert bad.size == 0, f"{what}: {bad.size} of {a.size} differ"


def assert_close(actual, desired, atol, what, mask=None):
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    if mask is not None:
        a, d = a[mask], d[mask]
    err = float(np.max(np.abs(a - d))) if a.size else 0.0
    assert err <= atol, f"{what}: max |diff| {err:.3e} > {atol}"


def unsolved_impulses(ws_n, ws_t, ws_tw, point_active, warmstart_coeff, n_sub):
    """The impulse block ``[B, 14, K]`` of lanes that no color pass solves,
    in float32: generation sets their impulses from the warmstart (normal
    rows masked by the active points), and each substep adds them to the
    accumulators and decays them by `warmstart_coeff`."""
    import torch

    imp = [ws_n * point_active.to(ws_n.dtype), ws_t, ws_tw.unsqueeze(1)]
    acc = [torch.zeros_like(x) for x in imp]
    for _ in range(n_sub):
        acc = [a + x for a, x in zip(acc, imp)]
        imp = [x * warmstart_coeff for x in imp]
    return torch.cat([imp[0], acc[0], imp[1], acc[1], imp[2], acc[2]], dim=1)


def perturbed_batch(world, noise_axes, seed):
    """(reference numpy batch of B scenes of `world`, scene 1's dynamic
    bodies moved by seeded noise along `noise_axes`; reference params)."""
    import rapier_tpu.types as jt
    from rapier_tpu.scenes import replicate_scene

    state = world.build()
    batch = replicate_scene(state, B)
    rng = np.random.default_rng(seed)
    dyn = np.asarray(state.bodies.body_type) == int(jt.BodyType.DYNAMIC)
    noise = rng.normal(0.0, 0.02, (int(dyn.sum()), 3)).astype(np.float32)
    noise *= np.asarray(noise_axes, np.float32)
    for name in ("pos", "next_pos"):
        getattr(batch.bodies, name)[1, dyn] += noise
    return batch, world.params


def blocked_thresholds(mp):
    """Send every scene of both packages down the large-scene paths (set
    the dense-routing limits to 0 through the monkeypatch `mp`)."""
    import rapier_tpu.dynamics.solver.coloring as jcol
    import rapier_tpu.pipeline.physics_pipeline as jpp
    import rapier_tpu.utils.routing as jrt
    import rapier_tpu_torch.pipeline.physics_pipeline as pp

    for mod, name in ((jrt, "DENSE_ROUTE_ELEMS"), (jrt, "DENSE_JOIN_ELEMS"),
                      (jpp, "_DENSE_ROUTE_ELEMS"), (jpp, "_DENSE_JOIN_ELEMS"),
                      (jcol, "DENSE_ROUTE_ELEMS"), (pp, "DENSE_ROUTE_ELEMS")):
        mp.setattr(mod, name, 0)


def rollouts(start, jparams, n_steps):
    """`n_steps` steps of the reference (jit of the vmapped step) and of the
    port from the numpy batch `start`: (the port's solve path, reference
    states, port states), each state with numpy leaves.  The port's steps
    must not overflow."""
    import jax
    import jax.numpy as jnp
    import rapier_tpu.pipeline.physics_pipeline as jpp
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.types import from_numpy, to_numpy

    f = jax.jit(jax.vmap(jpp.step, in_axes=(0, None)))
    js = jax.tree.map(jnp.asarray, start)
    ref = []
    for _ in range(n_steps):
        js, _ = f(js, jparams)
        ref.append(jax.tree.map(np.asarray, js))
    params = from_numpy(jparams)
    ps = from_numpy(start)
    path = pp.solve_path(ps, params)
    port = []
    for _ in range(n_steps):
        ps, ev = pp.step(ps, params)
        assert int(ev.solver_overflow.max()) == 0 and int(ev.broadphase_overflow.max()) == 0
        port.append(to_numpy(ps))
    return path, ref, port


def assert_trajectories_agree(ref, port):
    """Pair keys and touching flags equal, positions and rotations within
    1e-4, velocities within 1e-3, at every step.  Returns the fewest
    touching lanes of any step."""
    touching = 0
    for t, (rs, ps) in enumerate(zip(ref, port)):
        assert_equal(ps.contacts.pair_key, rs.contacts.pair_key, f"step {t + 1} pair_key")
        assert_equal(ps.contacts.touching, rs.contacts.touching, f"step {t + 1} touching")
        assert_close(ps.bodies.pos, rs.bodies.pos, 1e-4, f"step {t + 1} pos")
        assert_close(ps.bodies.rot, rs.bodies.rot, 1e-4, f"step {t + 1} rot")
        assert_close(ps.bodies.linvel, rs.bodies.linvel, 1e-3, f"step {t + 1} linvel")
        assert_close(ps.bodies.angvel, rs.bodies.angvel, 1e-3, f"step {t + 1} angvel")
        touching = min(touching or 10**9, int(np.sum(rs.contacts.touching)))
    return touching
