"""rapier_tpu_torch.loaders.mjcf against rapier_tpu.loaders.mjcf.

The quadruped model (scenes._quadruped_xml) goes through both loaders: the
handles (body, joint and actuator names, joint axes, articulation slots), the
built state (bodies, colliders, contact cache and the multibody table with
limits and servo gains) and the parameters must be equal exactly; both are
host-side numpy.  Controls applied through the handles land in the same
motor-target slots.  So do the reference's own models (tests/test_mjcf.py:
defaults, includes from files, keyframes, sensors, tendons, equalities,
gravcomp, mocap, sites, the ellipsoid) in both joint forms, a file with
every orientation, geom type and joint type, and the handles' methods on one
shared state.  `load_mjcf` defaults to impulse joints, as the reference does;
what the reference ignores the port ignores.  The impulse-joint quadruped is
held to the reference in tests/test_torch_joints.py.
"""

import dataclasses

import numpy as np
import pytest

from rapier_tpu_torch.scenes import MJCF_MODELS


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
    """The elements the port's first subset refused (`what`) now load as
    the reference loads them: read (orientations, sphere geoms, slide
    joints, joint damping, a jointless body welded to its parent) or
    ignored without a word (<option>, an empty <default>, a <general>
    actuator); the same handles and built state in both joint forms."""
    for use_multibody in (False, True):
        assert_loaded_equal(*_load(xml, use_multibody=use_multibody))


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


# ---------------------------------------------------------------------------
# The reference's own models (tests/test_mjcf.py:9-312) and the rest of the
# loader
# ---------------------------------------------------------------------------

PENDULUM = """
<mujoco model="pendulum">
  <compiler angle="degree"/>
  <default>
    <geom friction="0.8"/>
    <default class="small">
      <geom friction="0.3"/>
    </default>
  </default>
  <worldbody>
    <geom type="plane" size="10 10 0.1"/>
    <body name="base" pos="0 0 1">
      <geom type="box" size="0.1 0.1 0.1"/>
      <body name="arm" pos="0.0 0 -0.1">
        <joint name="swing" type="hinge" axis="0 1 0" pos="0 0 0"
               limited="true" range="-90 90"/>
        <geom type="capsule" fromto="0 0 0  0 0 -0.5" size="0.04" class="small"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <velocity name="drive" joint="swing" kv="50"/>
  </actuator>
</mujoco>
"""

ARM_PART = """
<mujoco>
  <worldbody>
    <body name="upper" pos="0 0 1">
      <joint name="shoulder" type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.5" size="0.05"/>
    </body>
  </worldbody>
  <sensor>
    <jointpos name="q_shoulder" joint="shoulder"/>
    <jointvel name="dq_shoulder" joint="shoulder"/>
    <framepos name="p_upper" objname="upper"/>
  </sensor>
  <keyframe>
    <key name="home" qpos="0.5"/>
  </keyframe>
</mujoco>
"""

# Every orientation, geom type and joint type the loader reads, equalities of
# each kind beside the tree, defaults by class and childclass, a jointless
# nested body, several hinges on one body (a ball joint), damping, slide
# limits, motor gears, a disabled equality and a geom that never collides.
ZOO = """
<mujoco>
  <compiler angle="radian"/>
  <default>
    <joint damping="0.5"/>
    <default class="soft"><geom friction="0.2 0.01 0.001" density="300"/></default>
    <default class="stiff"><joint damping="2"/><geom contype="0" conaffinity="0"/></default>
  </default>
  <worldbody>
    <geom type="plane" size="5 5 0.1" quat="1 0 0 0"/>
    <body name="post" pos="0 0 0.5" euler="0.1 0.2 0.3">
      <geom type="cylinder" size="0.05 0.5"/>
    </body>
    <body name="torso" pos="0 0 1.5" axisangle="0 0 1 0.4" childclass="soft">
      <joint name="root" type="free"/>
      <geom type="box" size="0.2 0.1 0.3" pos="0 0 0.05" zaxis="0 1 1"/>
      <geom type="ellipsoid" size="0.1 0.15 0.2" mass="2"/>
      <body name="neck" pos="0 0 0.4" xyaxes="0 1 0 -1 0 0">
        <joint name="tilt" type="ball"/>
        <geom type="sphere" size="0.1"/>
        <site name="eye" pos="0.05 0 0"/>
      </body>
      <body name="hip" pos="0.2 0 -0.3" quat="0.9 0 0.4 0">
        <joint name="hx" type="hinge" axis="1 0 0"/>
        <joint name="hy" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.05 0.2"/>
        <body name="shin" pos="0 0 -0.4" class="stiff">
          <joint name="knee" type="slide" axis="0 0 1" limited="true" range="-0.1 0.1"/>
          <geom type="cylinder" fromto="0 0 0 0.1 0 -0.3" size="0.04"/>
          <body name="foot" pos="0 0 -0.35">
            <geom type="box" size="0.1 0.05 0.02"/>
          </body>
        </body>
      </body>
      <body name="arm" pos="-0.2 0 0">
        <joint name="elbow" type="hinge" axis="0 1 0" limited="true" range="-1 1"
               pos="0 0 0.05"/>
        <geom type="capsule" fromto="0 0 0 -0.3 0 0" size="0.04"/>
        <body name="hand" pos="-0.35 0 0">
          <joint name="wrist" type="hinge" axis="0 0 1"/>
          <geom type="sphere" size="0.05"/>
          <geom type="unknown" size="1"/>
        </body>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="m_elbow" joint="elbow" gear="3"/>
    <position name="p_wrist" joint="wrist" kp="20"/>
    <velocity name="v_knee" joint="knee"/>
    <general name="g" joint="elbow"/>
  </actuator>
  <tendon>
    <fixed name="pair"><joint joint="elbow" coef="2"/><joint joint="wrist" coef="-1"/></fixed>
    <spatial name="gaze"><site site="eye"/><site site="nowhere"/></spatial>
  </tendon>
  <equality>
    <joint name="eq_j" joint1="elbow" joint2="wrist" polycoef="0.1 0.5 0 0 0"/>
    <connect name="tether" body1="hand" anchor="0 0 0.1"/>
    <weld name="bolt" body1="foot" body2="post"/>
    <weld name="off" body1="neck" body2="post" active="false"/>
  </equality>
  <keyframe><key name="pose" qpos="0.3 -0.2 0.05"/></keyframe>
  <sensor>
    <jointpos name="s_elbow" joint="elbow"/>
    <framepos name="s_hand" objname="hand"/>
    <accelerometer name="acc" site="eye"/>
  </sensor>
</mujoco>
"""

# tests/test_mjcf.py's tendon, connect and gravcomp-mocap models, as the
# port's scenes carry them for chip_smoke.py.
TAIL = MJCF_MODELS["gravcomp_mocap"]
MODELS = {"pendulum": PENDULUM, "keyframe_sensors": ARM_PART,
          "tendon": MJCF_MODELS["tendon"], "connect": MJCF_MODELS["connect"],
          "gravcomp_mocap_ellipsoid": TAIL, "zoo": ZOO}


def _load(xml, **kw):
    """The model through both loaders: (ref world, ref handles, ref state,
    port world, port handles, port state)."""
    from rapier_tpu.loaders.mjcf import load_mjcf as ref_load
    from rapier_tpu.world import PhysicsWorld as RefWorld
    from rapier_tpu_torch.loaders.mjcf import load_mjcf
    from rapier_tpu_torch.world import PhysicsWorld

    rw = RefWorld(gravity=(0, 0, -9.81))
    pw = PhysicsWorld(gravity=(0, 0, -9.81), device="cpu")
    rh, ph = ref_load(xml, rw, **kw), load_mjcf(xml, pw, **kw)
    return rw, rh, rw.build(), pw, ph, pw.build()


def _equal(a, d):
    if isinstance(d, dict):
        return a.keys() == d.keys() and all(_equal(a[k], d[k]) for k in d)
    if isinstance(d, (list, tuple)):
        return len(a) == len(d) and all(_equal(x, y) for x, y in zip(a, d))
    if dataclasses.is_dataclass(d):
        return _equal(dataclasses.astuple(a), dataclasses.astuple(d))
    if isinstance(d, np.ndarray) or isinstance(a, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(d))
    return a == d


HANDLE_FIELDS = ("bodies", "joints", "joint_axis", "actuators", "joint_order", "keyframes",
                 "sensors", "tendons", "couplings", "equalities", "gravcomp", "mocap",
                 "sites", "spatial_tendons", "keyframes_mocap", "use_multibody")


def assert_loaded_equal(rw, rh, rs, pw, ph, ps):
    for name in HANDLE_FIELDS:
        assert _equal(getattr(ph, name), getattr(rh, name)), name
    for part in ("bodies", "colliders", "contacts", "joints", "multibodies", "meshes", "hulls"):
        r, p = getattr(rs, part), getattr(ps, part)
        assert (r is None) == (p is None), part
        if p is None:
            continue
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert a.shape == d.shape and np.array_equal(a, d, equal_nan=True), \
                f"{part}.{f.name}"
    assert pw.params.shape_types_present == rw.params.shape_types_present
    assert pw._mb_trees == getattr(rw, "_mb_trees", [])
    for name in ph.joints if ph.use_multibody else ():
        assert ph._mb_slot(pw, name) == rh._mb_slot(rw, name), name


@pytest.mark.parametrize("use_multibody", [False, True])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_models_match_reference(model, use_multibody):
    assert_loaded_equal(*_load(MODELS[model], use_multibody=use_multibody))


def test_load_mjcf_defaults_to_impulse_joints():
    """No keyword: impulse joints in both packages (the port's first subset
    defaulted to multibody joints)."""
    rw, rh, rs, pw, ph, ps = _load(PENDULUM)
    assert not ph.use_multibody and not rh.use_multibody
    assert ps.joints is not None and ps.multibodies is None
    assert rs.joints is not None and rs.multibodies is None
    assert_loaded_equal(rw, rh, rs, pw, ph, ps)


def test_include_meshdir_and_root_translation(tmp_path):
    """A model file that includes another (which includes a third, with a
    <default>), its mesh assets under <compiler meshdir> (an OBJ, scaled,
    and a missing file), loaded by path and shifted by root_translation."""
    (tmp_path / "parts").mkdir()
    (tmp_path / "assets").mkdir()
    (tmp_path / "assets" / "wedge.obj").write_text(
        "v 0 0 0\nv 0.2 0 0\nv 0 0.2 0\nv 0 0 0.2\nf 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    (tmp_path / "parts" / "defaults.xml").write_text(
        '<mujoco><default><geom density="800"/></default></mujoco>')
    rock = ('<body name="rock" pos="1 0 0.5"><joint type="free"/>'
            '<geom type="mesh" mesh="wedge"/><geom type="mesh" mesh="gone"/></body>')
    (tmp_path / "parts" / "arm.xml").write_text(
        ARM_PART.replace("<mujoco>", '<mujoco><include file="defaults.xml"/>')
        .replace("</worldbody>", rock + "</worldbody>"))
    (tmp_path / "scene.xml").write_text("""
<mujoco>
  <compiler meshdir="assets"/>
  <asset>
    <mesh name="wedge" file="wedge.obj" scale="1 2 1"/>
    <mesh file="gone.stl"/>
  </asset>
  <include file="parts/arm.xml"/>
  <include file="parts/none.xml"/>
</mujoco>
""")
    for use_multibody in (False, True):
        loaded = _load(str(tmp_path / "scene.xml"), use_multibody=use_multibody,
                       root_translation=(0.5, -0.5, 0.25))
        assert_loaded_equal(*loaded)
        pw, ph, ps = loaded[3:]
        assert "home" in ph.keyframes and len(ph.sensors) == 3
        assert ps.meshes is not None
        np.testing.assert_allclose(pw.body_translation(ph.bodies["upper"]), [0.5, -0.5, 1.25])


def test_second_worldbody_is_ignored(tmp_path):
    """R23: the loader reads the first <worldbody> (and the first
    <actuator>, <sensor>, ...) of the expanded document only, so a model
    whose include brings a second one loses it, in both packages."""
    (tmp_path / "arm.xml").write_text(ARM_PART)
    (tmp_path / "scene.xml").write_text("""
<mujoco>
  <worldbody><body name="crate" pos="0 0 2"><joint type="free"/>
    <geom type="box" size="0.1 0.1 0.1"/></body></worldbody>
  <include file="arm.xml"/>
</mujoco>
""")
    loaded = _load(str(tmp_path / "scene.xml"))
    assert_loaded_equal(*loaded)
    ph = loaded[4]
    assert "crate" in ph.bodies and "upper" not in ph.bodies and "shoulder" not in ph.joints
    assert len(ph.sensors) == 3 and "home" in ph.keyframes     # their own sections


def _to_reference_state(rw, pw):
    """The port world's state, every part, as the reference world's."""
    import rapier_tpu.dynamics.multibody as rmb
    from rapier_tpu_torch.types import tree_map
    from test_torch_common import to_reference

    state = tree_map(lambda x: x[0], pw.state)
    rs = to_reference(state)
    if state.multibodies is not None:
        rs = rs.replace(multibodies=rmb.Multibodies(**{
            f.name: getattr(state.multibodies, f.name).numpy().copy()
            for f in dataclasses.fields(rmb.Multibodies)}))
    rw.state = rs


def _assert_state_equal(rw, pw, what):
    for part in ("bodies", "joints", "multibodies"):
        r, p = getattr(rw.state, part), getattr(pw.state, part)
        if p is None:
            continue
        for f in dataclasses.fields(p):
            a, d = getattr(p, f.name)[0].numpy(), np.asarray(getattr(r, f.name))
            assert np.array_equal(a.astype(d.dtype), d, equal_nan=True), \
                f"{what}: {part}.{f.name}"


@pytest.mark.parametrize("use_multibody", [False, True])
def test_keyframe_and_sensors_match_reference(use_multibody):
    """apply_keyframe (a multibody teleport, or position motors for the
    impulse form), then the sensors, on one shared state; the port's steps
    handed to the reference give the same readings."""
    rw, rh, _rs, pw, ph, _ps = _load(ARM_PART, use_multibody=use_multibody)
    rh.apply_keyframe(rw, "home")
    ph.apply_keyframe(pw, "home")
    _assert_state_equal(rw, pw, "keyframe")
    pw.step(5)
    _to_reference_state(rw, pw)
    got, want = ph.read_sensors(pw), rh.read_sensors(rw)
    assert got.keys() == want.keys() == {"q_shoulder", "dq_shoulder", "p_upper"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mocap_gravcomp_tendon_methods_match_reference():
    """The gravcomp, mocap and spatial-tendon model: the keyframe's mocap
    pose, set_mocap_pose, apply_gravity_compensation after the scales were
    edited, site positions, the tendon length and its sensor."""
    import jax
    import jax.numpy as jnp

    rw, rh, _rs, pw, ph, _ps = _load(TAIL)
    rw.state = jax.tree.map(jnp.asarray, rw.state)      # as after a step (R24)
    for h, w in ((rh, rw), (ph, pw)):
        h.apply_keyframe(w, "home")
    _assert_state_equal(rw, pw, "keyframe")
    np.testing.assert_allclose(pw.body_translation(ph.bodies["target"]), [0.5, 0.5, 2.0])
    pw.state.bodies.gravity_scale[0] = 0.25
    _to_reference_state(rw, pw)
    rw.state = jax.tree.map(jnp.asarray, rw.state)
    for h, w in ((rh, rw), (ph, pw)):
        h.apply_gravity_compensation(w)
        h.set_mocap_pose(w, "target", (1.0, 0.0, 1.0), (0.0, 0.0, 0.6, 0.8))
    _assert_state_equal(rw, pw, "mocap and gravcomp")
    assert float(pw.state.bodies.gravity_scale[0, ph.bodies["float"]]) == 0.0
    for site in ("s_base", "s_tip"):
        np.testing.assert_array_equal(ph.site_position(pw, site), rh.site_position(rw, site))
    assert ph.tendon_length(pw, "cable") == rh.tendon_length(rw, "cable")
    assert ph.read_sensors(pw) == rh.read_sensors(rw)


def test_mocap_pose_before_the_first_step():
    """R24, not copied: the reference's set_mocap_pose (and so a keyframe's
    mocap poses) indexes with `.at`, which a world not yet stepped (numpy
    leaves) lacks; the port's writes its tensors from the start."""
    rw, rh, _rs, pw, ph, _ps = _load(TAIL)
    with pytest.raises(AttributeError):
        rh.apply_keyframe(rw, "home")
    ph.apply_keyframe(pw, "home")
    np.testing.assert_array_equal(pw.body_translation(ph.bodies["target"]),
                                  np.float32([0.5, 0.5, 2.0]))
    np.testing.assert_array_equal(pw.state.bodies.next_rot[0, ph.bodies["target"]].numpy(),
                                  np.float32([0, 0, 0, 1]))


def test_zoo_controls_and_keyframe_match_reference():
    """The zoo's actuators (motor gear, position, velocity) and its keyframe
    on the impulse joints, on one shared state."""
    rw, rh, _rs, pw, ph, _ps = _load(ZOO)
    for h, w in ((rh, rw), (ph, pw)):
        h.apply_controls(w, [0.5, -0.25, 0.75])
        h.apply_keyframe(w, "pose")
    _assert_state_equal(rw, pw, "controls and keyframe")
    assert ph.read_sensors(pw).keys() == rh.read_sensors(rw).keys()
