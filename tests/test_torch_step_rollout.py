"""rapier_tpu_torch's batched step against the reference's vmapped step.

The reference runs with solver_backend="pallas" (the TPU main path's
semantics; the Pallas kernel runs in interpret mode on the CPU).  Tolerances
are those of tests/test_pallas_sweep.py: positions 1e-4, velocities 1e-3
(accumulation order only); the contact cache after 20 steps 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_common as tp
from rapier_tpu.pipeline.physics_pipeline import step as jax_step
from rapier_tpu_torch.pipeline.physics_pipeline import step as port_step
from rapier_tpu_torch.types import from_numpy, to_numpy

N_STEPS = 20
CACHE_FLOATS = ("warmstart_impulse", "warmstart_tangent_impulse",
                "warmstart_twist_impulse", "impulse", "tangent_impulse")


@pytest.fixture(scope="module")
def rollouts():
    """20 steps of both packages from the same settled batch."""
    start = tp.settled_batch()
    _, jparams = tp.jax_world()
    f = jax.jit(jax.vmap(jax_step, in_axes=(0, None)))
    js = jax.tree.map(jnp.asarray, start)
    ref = []
    for _ in range(N_STEPS):
        js, jev = f(js, jparams)
        ref.append((jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, jev)))
    params = tp.port_params()
    ps = from_numpy(start)
    port = []
    for _ in range(N_STEPS):
        ps, pev = port_step(ps, params)
        port.append((to_numpy(ps), pev))
    return ref, port


def test_first_step_discrete_outputs_equal(rollouts):
    ref, port = rollouts
    (rs, rev), (ps, pev) = ref[0], port[0]
    rc, pc = rs.contacts, ps.contacts
    for name in ("pair_key", "body1", "body2", "collider1", "collider2",
                 "point_active", "num_points", "active", "touching", "events_or"):
        tp.assert_equal(getattr(pc, name), getattr(rc, name), f"contacts.{name}")
    # Feature ids of geometrically valid points; slots the box-box reduction
    # drops hold tie-broken leftovers (dist 1e10) in both packages.
    valid_pt = (np.asarray(rc.dist) < 1e9) | (np.asarray(pc.dist) < 1e9)
    tp.assert_equal(pc.feature_id, rc.feature_id, "contacts.feature_id", valid_pt)
    tp.assert_equal(ps.bodies.sleeping, rs.bodies.sleeping, "bodies.sleeping")
    assert int(np.sum(rc.touching)) > 0, "the parity batch has no contacts"
    for name in ("started_pairs", "stopped", "stopped_keys", "force_events",
                 "sensor_pairs", "broadphase_overflow", "unsupported_pairs",
                 "solver_overflow"):
        tp.assert_equal(getattr(pev, name).numpy(), getattr(rev, name), f"events.{name}")


def test_trajectory_matches_reference(rollouts):
    ref, port = rollouts
    for t, ((rs, _), (ps, _)) in enumerate(zip(ref, port)):
        rb, pb = rs.bodies, ps.bodies
        tp.assert_close(pb.pos, rb.pos, 1e-4, f"step {t + 1} pos")
        tp.assert_close(pb.rot, rb.rot, 1e-4, f"step {t + 1} rot")
        tp.assert_close(pb.linvel, rb.linvel, 1e-3, f"step {t + 1} linvel")
        tp.assert_close(pb.angvel, rb.angvel, 1e-3, f"step {t + 1} angvel")


def test_contact_cache_after_20_steps(rollouts):
    ref, port = rollouts
    rc, pc = ref[-1][0].contacts, port[-1][0].contacts
    tp.assert_equal(pc.pair_key, rc.pair_key, "contacts.pair_key")
    for name in CACHE_FLOATS:
        tp.assert_close(getattr(pc, name), getattr(rc, name), 1e-3, f"contacts.{name}")
