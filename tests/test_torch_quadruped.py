"""The batched quadruped path of rapier_tpu_torch against rapier_tpu.

`quadruped_world(use_multibody=True)` (10 bodies, a halfspace floor, one
9-link articulation) batched over B = 2 scenes, scene 1 perturbed by seeded
numpy noise on the trunk position and the servo targets.  The reference runs
`jax.vmap(step)` with solver_backend="pallas" (its kernel in interpret mode
on the CPU); the port runs its batched step with the plain solve.

Tolerances: positions and rotations 1e-4, velocities and generalized
velocities 1e-3 (accumulation order only; the two agree to ~1e-7 over these
60 steps, which cover the whole fall with no threshold tie).  Discrete
outputs (touching pairs, overflow counters) are equal.  The trunk falls to
0.050 in both: the reference's fault R5 (ROADMAP), which the port must
reproduce, not repair.

The dispatcher's halfspace bucket is held to the reference on the
quadruped's colliders at step 30: 1e-5 on points, normals and distances,
feature ids and validity equal.  The halfspace kernels, the cuboid support
point and the halfspace's AABB and mass are in tests/test_torch_halfspace.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapier_tpu_torch.types import from_numpy, to_numpy

B = 2
N_STEPS = 60
TRUNK = 1   # body handle of the trunk (body 0 is the world body of the floor)


@functools.lru_cache(maxsize=None)
def _batch():
    """(reference numpy batch, reference params)."""
    from rapier_tpu.scenes import quadruped_world, replicate_scene

    w, robot = quadruped_world(use_multibody=True)
    assert robot.bodies["trunk"] == TRUNK
    w.params = w.params.replace(solver_backend="pallas")
    batch = replicate_scene(w.build(), B)
    rng = np.random.default_rng(11)
    d = rng.normal(0, 0.01, 3).astype(np.float32)
    batch.multibodies.q[1, 0, 0, :3] += d
    batch.bodies.pos[1, TRUNK] += d
    batch.bodies.next_pos[1, TRUNK] += d
    batch.multibodies.motor_target_pos[1, 0, 1:, 3] += rng.normal(
        0, 0.05, 8).astype(np.float32)
    return batch, w.params


@pytest.fixture(scope="module")
def trajectories():
    from rapier_tpu.pipeline.physics_pipeline import step as jax_step
    from rapier_tpu_torch.pipeline.physics_pipeline import step as port_step

    batch, jparams = _batch()
    f = jax.jit(jax.vmap(jax_step, in_axes=(0, None)))
    js = jax.tree.map(jnp.asarray, batch)
    ps = from_numpy(batch)
    params = from_numpy(jparams)
    ref, port = [], []
    for _ in range(N_STEPS):
        js, jev = f(js, jparams)
        ps, pev = port_step(ps, params)
        ref.append((jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jev)))
        port.append((to_numpy(ps), pev))
    return ref, port


def _close(actual, desired, atol, what):
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    err = float(np.max(np.abs(a - d)))
    assert err <= atol, f"{what}: max |diff| {err:.3e} > {atol}"


def test_trajectory_matches_reference(trajectories):
    ref, port = trajectories
    for t, ((rs, _), (ps, _)) in enumerate(zip(ref, port)):
        for name, tol in (("pos", 1e-4), ("rot", 1e-4), ("linvel", 1e-3),
                          ("angvel", 1e-3)):
            _close(getattr(ps.bodies, name), getattr(rs.bodies, name), tol,
                   f"step {t + 1} bodies.{name}")
        _close(ps.multibodies.q, rs.multibodies.q, 1e-4, f"step {t + 1} q")
        _close(ps.multibodies.qd, rs.multibodies.qd, 1e-3, f"step {t + 1} qd")


def test_discrete_outputs_equal(trajectories):
    ref, port = trajectories
    for t, ((rs, rev), (ps, pev)) in enumerate(zip(ref, port)):
        for name in ("pair_key", "touching", "point_active"):
            assert np.array_equal(getattr(ps.contacts, name),
                                  getattr(rs.contacts, name)), (t + 1, name)
        for name in ("broadphase_overflow", "unsupported_pairs", "solver_overflow",
                     "started_pairs", "stopped"):
            assert np.array_equal(getattr(pev, name).numpy(),
                                  np.asarray(getattr(rev, name))), (t + 1, name)
    assert int(np.sum(port[-1][0].contacts.touching[0])) == 17


def test_trunk_falls_as_in_the_reference(trajectories):
    """R5: the reference's quadruped does not stand; its trunk drops onto the
    floor (0.050 at step 60, the trunk's half height).  The port must fall
    the same way."""
    ref, port = trajectories
    z_ref = ref[-1][0].bodies.pos[:, TRUNK, 2]
    z_port = port[-1][0].bodies.pos[:, TRUNK, 2]
    _close(z_port, z_ref, 1e-3, "trunk height at step 60")
    assert 0.045 < float(z_port[0]) < 0.055, z_port


# ---------------------------------------------------------------------------
# Halfspace geometry.
# ---------------------------------------------------------------------------

def test_dispatch_halfspace_bucket_matches_reference(trajectories):
    """compute_manifolds on every collider pair of the quadruped at step 30
    (feet on the floor): canonical order with the halfspace in slot B, the
    analytic and support-sampling halfspace kernels, and the other pairs."""
    from rapier_tpu.geometry import dispatch as ref_dispatch
    from rapier_tpu_torch.geometry import dispatch as port_dispatch

    jparams = _batch()[1]
    state = trajectories[0][29][0]
    c = state.colliders.parent.shape[-1]
    n_real = 10
    pairs = [(i, j) for i in range(n_real) for j in range(i + 1, n_real)]
    c1 = np.full((B, 128), -1, np.int32)
    c2 = np.full((B, 128), -1, np.int32)
    c1[:, :len(pairs)] = [i for i, _ in pairs]
    c2[:, :len(pairs)] = [j for _, j in pairs]
    valid = c1 >= 0
    assert c >= n_real
    pred = float(jparams.prediction_distance())

    def ref_fn(bodies, colliders, c1, c2, valid):
        return ref_dispatch.compute_manifolds(
            bodies, colliders, c1, c2, valid, pred,
            present=jparams.shape_types_present, dt=jparams.dt)

    ref = jax.tree.map(np.asarray, jax.vmap(ref_fn)(
        jax.tree.map(jnp.asarray, state.bodies), jax.tree.map(jnp.asarray, state.colliders),
        jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(valid)))
    ps = from_numpy(state)
    port = port_dispatch.compute_manifolds(
        ps.bodies, ps.colliders, torch.from_numpy(c1), torch.from_numpy(c2),
        torch.from_numpy(valid), pred, present=jparams.shape_types_present,
        dt=jparams.dt)
    for name in ("normal", "point", "dist"):
        _close(getattr(port, name).numpy(), getattr(ref, name), 1e-5, f"manifold {name}")
    for name in ("fid", "point_active", "valid", "touching", "solver_pair", "unsupported",
                 "body1", "body2", "dyn1", "dyn2"):
        assert np.array_equal(getattr(port, name).numpy(), getattr(ref, name)), name
    floor_lanes = valid & (c1 == 0)
    assert int(np.sum(np.asarray(ref.touching) & floor_lanes)) >= 4
