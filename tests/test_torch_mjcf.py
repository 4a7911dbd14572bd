"""rapier_tpu_torch.loaders.mjcf against rapier_tpu.loaders.mjcf.

The quadruped model (scenes._quadruped_xml) goes through both loaders: the
handles (body, joint and actuator names, joint axes, articulation slots), the
built state (bodies, colliders, contact cache and the multibody table with
limits and servo gains) and the parameters must be equal exactly; both are
host-side numpy.  Controls applied through the handles land in the same
motor-target slots.  Elements and attributes outside the port's subset
raise NotImplementedError naming them.  The impulse-joint form is held to
the reference in tests/test_torch_joints.py.
"""

import dataclasses

import numpy as np
import pytest


def _worlds():
    from rapier_tpu.scenes import quadruped_world as ref_world
    from rapier_tpu_torch.scenes import quadruped_world as port_world

    rw, rh = ref_world(use_multibody=True)
    pw, ph = port_world(use_multibody=True, device="cpu")
    return rw, rh, pw, ph


@pytest.fixture(scope="module")
def built():
    rw, rh, pw, ph = _worlds()
    return rw, rh, rw.build(), pw, ph, pw.build()


def test_xml_matches_reference():
    from rapier_tpu.scenes import _quadruped_xml as ref_xml
    from rapier_tpu_torch.scenes import _quadruped_xml as port_xml

    assert port_xml() == ref_xml()


def test_handles_match_reference(built):
    rw, rh, _rs, pw, ph, _ps = built
    assert ph.bodies == rh.bodies
    assert ph.joints == rh.joints
    assert ph.joint_axis == rh.joint_axis
    assert ph.joint_order == rh.joint_order
    assert [dataclasses.astuple(a) for a in ph.actuators] == [
        (a.name, a.kind, a.joint, a.gear, a.kp, a.kv) for a in rh.actuators]
    for name in rh.joints:
        assert ph._mb_slot(pw, name) == rh._mb_slot(rw, name), name


def test_built_state_matches_reference(built):
    rw, _rh, rs, pw, _ph, ps = built
    for part in ("bodies", "colliders", "contacts", "multibodies"):
        r, p = getattr(rs, part), getattr(ps, part)
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert a.dtype == d.dtype and np.array_equal(a, d), f"{part}.{f.name}"
    assert pw.params.shape_types_present == rw.params.shape_types_present
    assert pw._mb_trees == rw._mb_trees


def test_limits_and_servo_gains(built):
    _rw, _rh, _rs, _pw, _ph, ps = built
    mb = ps.multibodies
    hips, knees = [1, 2, 3, 4], [5, 6, 7, 8]       # BFS link order
    np.testing.assert_array_equal(mb.limit_min[0, hips, 3], np.float32(-1.2))
    np.testing.assert_array_equal(mb.limit_max[0, knees, 3], np.float32(1.6))
    np.testing.assert_array_equal(mb.motor_stiffness[0, 1:, 3], np.float32(80.0))
    np.testing.assert_array_equal(mb.motor_damping[0, 1:, 3], np.float32(8.0))
    assert not mb.contacts_enabled[0, 1:].any()


def test_apply_controls_matches_reference():
    import jax.numpy as jnp

    rw, rh, pw, ph = _worlds()
    rw.build()
    pw.build()
    ctrl = np.random.default_rng(5).uniform(-1, 1, len(rh.actuators))
    rh.apply_controls(rw, ctrl)
    ph.apply_controls(pw, ctrl)
    ref = np.asarray(jnp.asarray(rw.state.multibodies.motor_target_pos))
    port = pw.state.multibodies.motor_target_pos[0].numpy()
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("xml, what", [
    ('<mujoco><option timestep="0.01"/></mujoco>', "<option>"),
    ('<mujoco><default/></mujoco>', "<default>"),
    ('<mujoco><worldbody><body pos="0 0 1" euler="0 0 1">'
     '<joint type="free"/></body></worldbody></mujoco>', "body.euler"),
    ('<mujoco><worldbody><body><joint type="free"/>'
     '<geom type="sphere" size="0.1"/></body></worldbody></mujoco>', "geom type 'sphere'"),
    ('<mujoco><worldbody><body><joint type="free"/><body>'
     '<joint type="slide"/></body></body></worldbody></mujoco>', "joint type 'slide'"),
    ('<mujoco><worldbody><body><joint type="free"/><body>'
     '<joint type="hinge" damping="1"/></body></body></worldbody></mujoco>', "joint.damping"),
    ('<mujoco><worldbody><body><joint type="free"/><body/></body></worldbody></mujoco>',
     "fixed joint"),
    ('<mujoco><actuator><general joint="j"/></actuator></mujoco>', "<general>"),
])
def test_outside_the_subset_raises(xml, what):
    from rapier_tpu_torch.loaders.mjcf import load_mjcf
    from rapier_tpu_torch.world import PhysicsWorld

    with pytest.raises(NotImplementedError, match=what.replace("(", r"\(")):
        load_mjcf(xml, PhysicsWorld(device="cpu"))


def test_world_multibody_accessors_match_reference():
    """multibody_q / multibody_qd / set_multibody_motor_targets on the built
    quadruped, against the reference world's."""
    import jax.numpy as jnp

    rw, rh, pw, ph = _worlds()
    rw.build()
    pw.build()
    np.testing.assert_array_equal(pw.multibody_q(0), np.asarray(rw.multibody_q(0)))
    np.testing.assert_array_equal(pw.multibody_qd(0), np.asarray(rw.multibody_qd(0)))
    ti, li = ph._mb_slot(pw, "rr_knee")
    for w in (rw, pw):
        w.set_multibody_motor_targets(ti, li, 3, target_pos=0.7, target_vel=-0.2)
    for name in ("motor_target_pos", "motor_target_vel"):
        np.testing.assert_array_equal(
            getattr(pw.state.multibodies, name)[0].numpy(),
            np.asarray(jnp.asarray(getattr(rw.state.multibodies, name))))
