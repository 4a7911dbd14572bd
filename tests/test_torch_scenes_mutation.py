"""The reference's tests/test_mutation.py scenarios on rapier_tpu_torch, on the CPU
(ROADMAP queue 1 item 2).

Each test builds its scene with the port's builders (`device="cpu"`), steps
it with the port's `PhysicsWorld` and keeps the reference test's own checks
and thresholds; batched leaves are read as ``[0, ...]`` (the port's state is
a batch of one scene).  Tests marked slow are so because the reference marks
the whole file slow (tests/conftest.py `_SLOW_MODULES`); the unmarked ones
run in tier-1 (none).
"""

import numpy as np
import pytest

from rapier_tpu_torch.world import (
    BodyHandle,
    ColliderBuilder,
    PhysicsWorld,
    RigidBodyBuilder,
)


def _ground_world():
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(20, 1, 20), g)
    return w


@pytest.mark.slow
def test_runtime_insert_body_falls_and_rests():
    w = _ground_world()
    w.build()
    w.step(5)
    h = w.insert_body_runtime(
        RigidBodyBuilder.dynamic().with_translation((0, 2.0, 0))
    )
    w.insert_collider_runtime(ColliderBuilder.ball(0.5), h)
    w.step(240)
    p = np.asarray(w.body_translation(h))
    assert abs(p[1] - 0.5) < 0.03, f"runtime ball rest height {p}"


@pytest.mark.slow
def test_removal_before_step():
    """physics_pipeline.rs:852-903: removing a body before the next step
    leaves a consistent world — the box stacked on it falls to the ground."""
    w = _ground_world()
    bottom = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 0.5, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.5, 0.5, 0.5), bottom)
    top = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 1.5, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.5, 0.5, 0.5), top)
    w.build()
    w.remove_body_runtime(bottom)
    w.step(240)
    p_top = np.asarray(w.body_translation(top))
    assert abs(p_top[1] - 0.5) < 0.05, f"top box should land on ground: {p_top}"


@pytest.mark.slow
def test_stale_handle_raises_and_slot_reuse():
    w = _ground_world()
    w.build()
    h1 = w.insert_body_runtime(
        RigidBodyBuilder.dynamic().with_translation((0, 2, 0))
    )
    c1 = w.insert_collider_runtime(ColliderBuilder.ball(0.3), h1)
    w.remove_body_runtime(h1)
    h2 = w.insert_body_runtime(
        RigidBodyBuilder.dynamic().with_translation((3, 2, 0))
    )
    # Freed slot is recycled deterministically with a bumped generation.
    assert h2.index == h1.index
    assert h2.generation == h1.generation + 1
    with pytest.raises(AssertionError):
        w.remove_body_runtime(h1)      # stale handle
    # The live handle still works as an index.
    p = np.asarray(w.body_translation(h2))
    np.testing.assert_allclose(p, [3, 2, 0])


@pytest.mark.slow
def test_remove_collider_updates_mass():
    w = _ground_world()
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 5, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5).with_density(1.0), b)
    w.build()
    m0 = 1.0 / float(np.asarray(w.state.bodies.inv_mass[0])[b])
    c2 = w.insert_collider_runtime(
        ColliderBuilder.ball(0.5).with_density(1.0), b
    )
    m1 = 1.0 / float(np.asarray(w.state.bodies.inv_mass[0])[b])
    np.testing.assert_allclose(m1, 2 * m0, rtol=1e-4)
    w.remove_collider_runtime(c2)
    m2 = 1.0 / float(np.asarray(w.state.bodies.inv_mass[0])[b])
    np.testing.assert_allclose(m2, m0, rtol=1e-4)


@pytest.mark.slow
def test_grow_past_capacity():
    w = _ground_world()
    w.build()
    n_cap = w.state.bodies.n
    hs = []
    for i in range(n_cap + 4):   # force at least one growth reallocation
        h = w.insert_body_runtime(
            RigidBodyBuilder.dynamic().with_translation((i * 2.0, 1.0, 0))
        )
        w.insert_collider_runtime(ColliderBuilder.ball(0.4), h)
        hs.append(h)
    assert w.state.bodies.n > n_cap
    w.step(60)
    for h in hs[:3]:
        assert np.isfinite(np.asarray(w.body_translation(h))).all()
