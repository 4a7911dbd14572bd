"""Scene sharding (`rapier_tpu_torch.parallel.sharding`) on the CPU.

- tests/test_sharding.py carried over: identical scenes of a vmapped
  (here: batched) step give identical rows; 16 `stack_world(n=2)` scenes
  through `shard_batch` and `make_sharded_step` on a mesh of one device,
  which needs no process group; `make_mesh(None)` raises.
- 2 and 4 gloo ranks, spawned: each steps its block of 16 stack_world(n=2)
  scenes and of 8 narrow bench scenes (both seeded apart scene by scene);
  the state gathered on rank 0 is bitwise equal to the unsharded step's.
- Against the reference's `make_sharded_step` on its 8-device virtual CPU
  mesh, both with solver_backend="jax": positions and rotations within
  1e-4, velocities within 1e-3 (the step-parity tolerances of
  tests/test_torch_common.py), pair keys and touching flags equal.
"""

import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu_torch.parallel import sharding as sh
from rapier_tpu_torch.types import from_numpy, to_numpy

STEPS = 5


def _batch(world, n, seed):
    """`n` copies of the world's scene, each dynamic body moved by seeded
    noise (numpy leaves)."""
    from rapier_tpu_torch.scenes import replicate_scene

    state = world.build()
    batch = replicate_scene(state, n)
    dyn = np.asarray(state.bodies.body_type) == 0
    noise = np.random.default_rng(seed).normal(0.0, 0.02, (n, int(dyn.sum()), 3))
    for name in ("pos", "next_pos"):
        getattr(batch.bodies, name)[:, dyn] += noise.astype(np.float32)
    return batch


def _stack(n=16):
    from rapier_tpu_torch.scenes import stack_world

    w = stack_world(n=2, device="cpu")
    return _batch(w, n, seed=5), w.params


def _bench(n=8):
    from rapier_tpu_torch.scenes import mixed_primitives_world

    w = mixed_primitives_world(2, 3, max_pairs=128, device="cpu")
    w.params = w.params.replace(max_solver_pairs=64)
    return _batch(w, n, seed=6), w.params


def _unsharded(batch, params, steps=STEPS):
    state = from_numpy(batch)
    for _ in range(steps):
        state, _ = sh.batched_step(state, params)
    return state


def test_vmap_batch_steps():
    from rapier_tpu_torch.scenes import replicate_scene, stack_world

    w = stack_world(n=2, device="cpu")
    batch = from_numpy(replicate_scene(w.build(), 4))
    new_state, _ = sh.batched_step(batch, w.params)
    assert new_state.bodies.pos.shape[0] == 4
    p = new_state.bodies.pos.numpy()
    np.testing.assert_array_equal(p[0], p[1])


def test_sharded_step_on_a_one_device_mesh():
    """A mesh of one device needs no process group; donate=False leaves the
    input intact."""
    assert not torch.distributed.is_initialized()
    mesh = sh.make_mesh(["cpu"])
    assert mesh.size == 1 and mesh.rank == 0
    batch, params = _stack()
    block = sh.shard_batch(from_numpy(batch), mesh)
    before = sh.state_digest(block)
    step_fn = sh.make_sharded_step(mesh, donate=False)
    new_state, _ = step_fn(block, params)
    assert sh.state_digest(block) == before
    assert bool(torch.isfinite(new_state.bodies.pos).all())
    assert sh.state_digest(sh.gather_batch(new_state, mesh)) == sh.state_digest(
        _unsharded(batch, params, 1))


def test_make_mesh_needs_devices_and_a_group():
    with pytest.raises(ValueError):
        sh.make_mesh(None)
    with pytest.raises(RuntimeError):
        sh.make_mesh(["cpu", "cpu"])
    mesh = sh.SceneMesh(tuple(torch.device("cpu") for _ in range(4)), "scenes", 1)
    assert sh.block(16, mesh) == (4, 8)
    with pytest.raises(ValueError):      # the reference refuses such a batch too
        sh.block(10, mesh)


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_ranks_bitwise_equal_to_the_unsharded_step(ranks):
    for batch, params in (_stack(), _bench()):
        stats, _ = sh.sharded_rollout(batch, params, STEPS, ["cpu"] * ranks,
                                      return_state=True)
        assert [s["scenes"] for s in stats] == [batch.bodies.pos.shape[0] // ranks] * ranks
        assert all(s["overflow"] == 0 for s in stats)
        ref = _unsharded(batch, params)
        assert stats[0]["digest"] == sh.state_digest(ref)
        got = stats[0]["state"]
        for part in ("bodies", "contacts"):
            for f, v in vars(getattr(to_numpy(ref), part)).items():
                assert np.array_equal(np.asarray(getattr(getattr(got, part), f)), v), (part, f)


def test_against_the_reference_sharded_step():
    """16 stack_world(n=2) scenes: the reference's sharded step on its
    8-device virtual CPU mesh against the port's sharded step over 2 ranks,
    both with solver_backend="jax"."""
    import jax
    import jax.numpy as jnp
    from rapier_tpu.parallel.sharding import make_mesh, make_sharded_step, shard_batch

    batch, params = _stack()
    params = params.replace(solver_backend="jax")
    cpus = jax.devices("cpu")
    assert len(cpus) >= 8
    mesh = make_mesh(cpus[:8])
    step_fn = make_sharded_step(mesh, donate=False)
    jparams = tp.reference_params(params)
    js = shard_batch(jax.tree.map(jnp.asarray, tp.to_reference(from_numpy(batch))), mesh)
    ref = []
    for _ in range(STEPS):
        js, _ = step_fn(js, jparams)
        ref.append(jax.tree.map(np.asarray, js))
    stats, _ = sh.sharded_rollout(batch, params, STEPS, ["cpu", "cpu"], return_state=True)
    port = stats[0]["state"]
    assert stats[0]["digest"] == sh.state_digest(_unsharded(batch, params))
    tp.assert_trajectories_agree(ref[-1:], [port])
