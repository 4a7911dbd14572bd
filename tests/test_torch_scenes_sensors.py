"""The reference's tests/test_sensors_collision_types.py scenarios on rapier_tpu_torch, on the CPU
(ROADMAP queue 1 item 2).

Each test builds its scene with the port's builders (`device="cpu"`), steps
it with the port's `PhysicsWorld` and keeps the reference test's own checks
and thresholds; batched leaves are read as ``[0, ...]`` (the port's state is
a batch of one scene).  Tests marked slow are so because the reference marks
the whole file slow (tests/conftest.py `_SLOW_MODULES`); the unmarked ones
run in tier-1 (test_active_collision_types_kinematic_fixed, test_collision_pipeline_cd_only).
"""

import numpy as np
import pytest

from rapier_tpu_torch.types import ACTIVE_EVENTS_COLLISION, ActiveCollisionTypes
from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder


@pytest.mark.slow
def test_sensor_intersection_enter_exit():
    # A ball falls through a floating sensor box: intersection starts while
    # passing through and stops after, and the sensor exerts NO forces.
    w = PhysicsWorld(device="cpu")
    sensor_body = w.insert_body(
        RigidBodyBuilder.fixed().with_translation((0, 2.0, 0)))
    cs = w.insert_collider(
        ColliderBuilder.cuboid(2.0, 0.5, 2.0).as_sensor()
        ._set(active_events=ACTIVE_EVENTS_COLLISION),
        sensor_body,
    )
    ball = w.insert_body(
        RigidBodyBuilder.dynamic().with_translation((0, 5.0, 0)))
    cb = w.insert_collider(ColliderBuilder.ball(0.3), ball)
    w.build()

    saw_inside = saw_started = saw_stopped = False
    for _ in range(120):
        w.step()
        ev = w.last_events
        inter = np.asarray(ev.intersecting)
        if inter.any():
            saw_inside = True
            assert w.is_intersecting(cs, cb)
            assert (np.asarray(ev.sensor_pairs) & inter).any()
        if (np.asarray(ev.started_pairs) & np.asarray(ev.sensor_pairs)).any():
            saw_started = True
        if np.asarray(ev.stopped).any():
            saw_stopped = True
    assert saw_inside and saw_started and saw_stopped
    # Free fall the whole way: the sensor never pushed back.
    p = np.asarray(w.body_translation(ball))
    assert p[1] < 1.0, f"sensor blocked the ball at y={p[1]}"
    assert not w.is_intersecting(cs, cb)


def test_active_collision_types_kinematic_fixed():
    # Default mask: kinematic-vs-fixed pairs are filtered in the broad phase.
    # Opting one collider into KINEMATIC_FIXED makes the pair touch
    # (collider_components.rs:282 test() — either side may allow it).
    def run(opt_in: bool):
        w = PhysicsWorld(device="cpu", gravity=(0, 0, 0))
        wall = w.insert_body(RigidBodyBuilder.fixed())
        cb = ColliderBuilder.cuboid(0.5, 2.0, 2.0)
        if opt_in:
            cb = cb.with_active_collision_types(
                ActiveCollisionTypes.DYNAMIC_DYNAMIC
                | ActiveCollisionTypes.DYNAMIC_KINEMATIC
                | ActiveCollisionTypes.DYNAMIC_FIXED
                | ActiveCollisionTypes.KINEMATIC_FIXED
            )
        w.insert_collider(cb, wall)
        kin = w.insert_body(
            RigidBodyBuilder.kinematic_velocity_based()
            .with_translation((-2.0, 0, 0)).with_linvel((1.0, 0, 0)))
        w.insert_collider(ColliderBuilder.ball(0.5), kin)
        w.build()
        w.step(150)  # kinematic body drives into/through the wall
        touching = np.asarray(w.state.contacts.touching[0]).any()
        p = np.asarray(w.body_translation(kin))
        return touching, p

    touched_default, p_default = run(False)
    touched_opt, p_opt = run(True)
    assert not touched_default, "kinematic-fixed pair leaked past the filter"
    assert touched_opt, "KINEMATIC_FIXED opt-in did not produce contacts"
    # Contacts never deflect a kinematic body (infinite effective mass).
    np.testing.assert_allclose(p_opt, p_default, atol=1e-5)


def test_collision_pipeline_cd_only():
    # CollisionPipeline: detects, reports events/intersections, moves NOTHING.
    w = PhysicsWorld(device="cpu")
    ground = w.insert_body(RigidBodyBuilder.fixed())
    cg = w.insert_collider(
        ColliderBuilder.cuboid(5, 0.5, 5)
        ._set(active_events=ACTIVE_EVENTS_COLLISION), ground)
    probe = w.insert_body(
        RigidBodyBuilder.dynamic().with_translation((0, 0.6, 0)))
    cp = w.insert_collider(
        ColliderBuilder.ball(0.3).as_sensor()
        ._set(active_events=ACTIVE_EVENTS_COLLISION), probe)
    w.build()
    p0 = np.asarray(w.body_translation(probe)).copy()

    w.collide()
    assert (np.asarray(w.last_events.started_pairs)).any()
    assert w.is_intersecting(cg, cp)
    # Re-collide: the pair persists, no new started event, nothing moved.
    w.collide()
    assert not np.asarray(w.last_events.started_pairs).any()
    np.testing.assert_array_equal(np.asarray(w.body_translation(probe)), p0)
    assert np.asarray(w.body_linvel(probe)).sum() == 0.0
