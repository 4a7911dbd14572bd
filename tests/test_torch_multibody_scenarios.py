"""The reference's multibody scenarios (tests/test_multibody.py: a free
two-link multibody resting on the ground, an arm blocked by a fixed wall,
links pushing a rigid ball, a position motor reaching its target, the joint
spring's equilibrium) and examples/multibody_arm.py (alone and with its dof
coupling) on rapier_tpu_torch alone, with the reference's thresholds.  The
multibody functions against the reference are in
tests/test_torch_multibody.py.
"""

import numpy as np
import torch

_ALL = 0b111111


def _rev_z():
    from rapier_tpu_torch.world import GenericJointBuilder

    return GenericJointBuilder(locked_axes=_ALL & ~(1 << 5))


def _set_angle(w, link, theta):
    mb = w.state.multibodies
    mb.q[0, 0, link, 5] = theta
    mb.joint_rot[0, 0, link] = torch.tensor([0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)])


def test_twoway_free_multibody_rests_on_ground():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    ground = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(20, 1, 20), ground)
    root = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 1.0, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5).with_density(1.0), root)
    child = w.insert_body(RigidBodyBuilder.dynamic().with_translation((1.2, 1.0, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5).with_density(1.0), child)
    w.insert_multibody_joint(root, child, _rev_z().with_local_anchor1((1.2, 0, 0)))
    w.step(240)
    for h in (root, child):
        p = w.body_translation(h)
        assert np.isfinite(p).all()
        assert 0.3 < p[1] < 0.7, f"link should rest ON the floor, y={p[1]}"


def test_twoway_arm_blocked_by_fixed_wall():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    root = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 2.0, 0)))
    arm = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 1.0, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.1, 1.0, 0.1).with_density(5.0), arm)
    w.insert_multibody_joint(root, arm, _rev_z().with_local_anchor2((0.0, 1.0, 0.0)))
    wall = w.insert_body(RigidBodyBuilder.fixed().with_translation((1.0, 0.6, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.2, 0.6, 2.0), wall)
    w.build()
    _set_angle(w, 1, 0.6)
    w.step(300)
    q = w.multibody_q(0)
    assert np.isfinite(q).all()
    tip = w.body_translation(arm)
    assert tip[0] < 0.95, f"arm sank into the fixed wall, tip x={tip[0]}"
    assert abs(q[1, 5]) < 2.5, f"arm swung through the wall, q={q[1, 5]}"


def test_pipeline_links_push_rigid_bodies():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    ground = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(20, 1, 20), ground)
    root = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 2.0, 0)))
    arm = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 1.0, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.1, 1.0, 0.1).with_density(5.0), arm)
    w.insert_multibody_joint(root, arm, _rev_z().with_local_anchor2((0.0, 1.0, 0.0)))
    ball = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0.8, 0.3, 0)))
    w.insert_collider(ColliderBuilder.ball(0.3), ball)
    w.build()
    _set_angle(w, 1, 1.2)
    w.step(120)
    p = w.body_translation(ball)
    assert np.isfinite(p).all()
    assert abs(p[0]) > 1.0, f"ball should be knocked away, at {p}"
    assert np.isfinite(w.multibody_q(0)).all()


def test_motor_position_reaches_target():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    root = w.insert_body(RigidBodyBuilder.fixed())
    bob = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, -1.0, 0)))
    w.insert_collider(ColliderBuilder.ball(0.1).with_density(100.0), bob)
    w.insert_multibody_joint(root, bob, _rev_z().with_local_anchor2((0.0, 1.0, 0.0)))
    w.build()
    mb = w.state.multibodies
    mb.motor_target_pos[0, 0, 1, 5] = 0.8
    mb.motor_stiffness[0, 0, 1, 5] = 50.0
    mb.motor_damping[0, 0, 1, 5] = 5.0
    w.step(600)
    q = w.multibody_q(0)
    assert abs(q[1, 5] - 0.8) < 0.1, q[1, 5]


def test_joint_spring_equilibrium():
    """tests/test_multibody.py's spring: a prismatic-y slot with a spring
    and damping settles at q = -m g / k."""
    from rapier_tpu_torch.world import (ColliderBuilder, GenericJointBuilder, PhysicsWorld,
                                        RigidBodyBuilder)

    w = PhysicsWorld(device="cpu")
    root = w.insert_body(RigidBodyBuilder.fixed())
    slider = w.insert_body(RigidBodyBuilder.dynamic())
    w.insert_collider(ColliderBuilder.ball(0.1).with_density(100.0), slider)
    k = 500.0
    jb = GenericJointBuilder(locked_axes=_ALL & ~(1 << 1))
    w.insert_multibody_joint(root, slider, jb.with_joint_spring(1, k, 0.0)
                             .with_joint_damping(1, 20.0))
    w.step(240)
    m = 100.0 * 4.0 / 3.0 * np.pi * 0.1 ** 3
    np.testing.assert_allclose(w.multibody_q(0)[1, 1], -m * 9.81 / k, rtol=1e-2, atol=1e-4)


def test_multibody_arm_example():
    """examples/multibody_arm.py's own checks on `scenes.multibody_arm_world`
    after its 300 steps: the shoulder past -0.9 rad, the ball knocked off
    its pedestal."""
    from rapier_tpu_torch.scenes import multibody_arm_world

    w, h = multibody_arm_world(device="cpu")
    w.step(300)
    q = w.multibody_q(0)
    p = w.body_translation(h["ball"])
    assert np.isfinite(q).all() and np.isfinite(p).all()
    assert q[1, 5] < -0.9, q[1, 5]
    assert abs(p[0] - 1.8) > 0.4 or p[1] < 0.6, p


def test_coupled_arm_holds_its_coupling():
    """The arm with the elbow's velocity coupled to -1 x the shoulder's:
    after 60 steps the coupling holds within 1e-3 relative."""
    from rapier_tpu_torch.scenes import multibody_arm_world

    w, _ = multibody_arm_world(coupled=True, device="cpu")
    w.step(60)
    qd = w.multibody_qd(0)
    assert abs(qd[2, 5] + qd[1, 5]) <= 1e-3 * max(abs(qd[1, 5]), 1e-2), qd[1:, 5]
    assert abs(qd[1, 5]) > 1e-2
