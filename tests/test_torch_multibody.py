"""rapier_tpu_torch.dynamics.multibody against rapier_tpu.dynamics.multibody.

Inputs: the quadruped articulation (9 links, free root) built by the
reference, batched over B = 2 scenes whose generalized coordinates,
velocities, motor targets and body forces are drawn from a seeded numpy
generator (scene 1 differs from scene 0).  Each reference function runs
under `jax.vmap` over the scene axis on the same numpy inputs.

Tolerances (absolute, on float32 arithmetic whose summation order differs):
forward kinematics, Jacobians and the mass matrix 1e-5; generalized forces,
accelerations, velocities and the mobility blocks 1e-4 relative to the
largest magnitude of the compared array (qdd reaches ~1e3 under the servos).

The last four tests run the reference's multibody contact scenarios
(tests/test_multibody.py) on the port alone, with the reference's own
thresholds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapier_tpu.dynamics import multibody as ref_mb
from rapier_tpu_torch.dynamics import multibody as port_mb
from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

B = 2
DT = np.float32(1.0 / 60.0)
TOL_GEOM = 1e-5
TOL_DYN = 1e-4


@functools.lru_cache(maxsize=None)
def _inputs():
    """(reference Multibodies, reference Bodies, gravity) with numpy leaves
    [B, ...]: the quadruped with seeded random coordinates."""
    from rapier_tpu.scenes import quadruped_world, replicate_scene

    w, _ = quadruped_world(use_multibody=True)
    state = replicate_scene(w.build(), B)
    rng = np.random.default_rng(2024)
    mb = state.multibodies
    q = np.array(mb.q)
    jr = np.array(mb.joint_rot)
    ang = rng.uniform(-0.9, 0.9, (B, 8)).astype(np.float32)
    q[:, 0, 1:, 3] = ang
    jr[:, 0, 1:] = 0.0
    jr[:, 0, 1:, 0] = np.sin(ang / 2)
    jr[:, 0, 1:, 3] = np.cos(ang / 2)
    q[:, 0, 0, :3] += rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    root = rng.normal(0, 0.2, (B, 4)).astype(np.float32)
    root[:, 3] += 1.0
    jr[:, 0, 0] = root / np.linalg.norm(root, axis=-1, keepdims=True)
    qd = rng.normal(0, 0.5, np.shape(mb.qd)).astype(np.float32)
    tp = np.array(mb.motor_target_pos)
    tp[:, 0, 1:, 3] = rng.uniform(-0.5, 0.5, (B, 8)).astype(np.float32)
    mb = mb.replace(q=q, joint_rot=jr, qd=qd, motor_target_pos=tp)
    bodies = state.bodies
    bodies = bodies.replace(
        force=rng.normal(0, 1.0, np.shape(bodies.force)).astype(np.float32),
        torque=rng.normal(0, 0.1, np.shape(bodies.torque)).astype(np.float32))
    return mb, bodies, np.asarray(w.params.gravity, np.float32)


def _to_port_mb(mb):
    return port_mb.Multibodies(**{
        f.name: torch.from_numpy(np.array(getattr(mb, f.name)))
        for f in dataclasses.fields(port_mb.Multibodies)})


def _to_port_bodies(bodies):
    from rapier_tpu_torch.types import Bodies

    return Bodies(**{f.name: torch.from_numpy(np.array(getattr(bodies, f.name)))
                     for f in dataclasses.fields(Bodies)})


def _vmap(fn, *args):
    return jax.vmap(fn)(*[jax.tree.map(jnp.asarray, a) for a in args])


def _close(actual, desired, atol, what, relative=False):
    a = np.asarray(actual.detach().numpy() if torch.is_tensor(actual) else actual,
                   np.float64)
    d = np.asarray(desired, np.float64)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    scale = max(1.0, float(np.max(np.abs(d)))) if relative else 1.0
    err = float(np.max(np.abs(a - d))) if a.size else 0.0
    assert err <= atol * scale, f"{what}: max |diff| {err:.3e} > {atol * scale:.3e}"


@pytest.fixture(scope="module")
def inputs():
    mb, bodies, g = _inputs()
    return dict(ref_mb=mb, ref_bodies=bodies, g=g,
                mb=_to_port_mb(mb), bodies=_to_port_bodies(bodies))


@pytest.fixture(scope="module")
def ref_dyn(inputs):
    """The reference's forward dynamics at the random state (per scene)."""
    mb, bodies, g = inputs["ref_mb"], inputs["ref_bodies"], inputs["g"]

    def fd(mb, bodies):
        n = bodies.pos.shape[0]
        lb0 = jnp.clip(mb.link_body[:, 0], 0, n - 1)
        return ref_mb.forward_dynamics(mb, bodies, jnp.asarray(g), DT,
                                       bodies.pos[lb0], bodies.rot[lb0])

    qdd, aux = _vmap(fd, mb, bodies)
    return jax.tree.map(np.asarray, (qdd, aux))


@pytest.fixture(scope="module")
def port_dyn(inputs):
    mb, bodies = inputs["mb"], inputs["bodies"]
    root_pos, root_rot = port_mb._root_pose(mb, bodies)
    return port_mb.forward_dynamics(mb, bodies, inputs["g"], float(DT),
                                    root_pos, root_rot)


def test_masks_equal(inputs):
    ref_free = _vmap(ref_mb.free_mask, inputs["ref_mb"])
    ref_live = _vmap(ref_mb.live_mask, inputs["ref_mb"])
    assert np.array_equal(port_mb.free_mask(inputs["mb"]).numpy(), np.asarray(ref_free))
    assert np.array_equal(port_mb.live_mask(inputs["mb"]).numpy(), np.asarray(ref_live))


def test_body_to_parent_and_forward_kinematics(inputs, ref_dyn, port_dyn):
    rp, rr = _vmap(ref_mb.body_to_parent, inputs["ref_mb"])
    pp, pr = port_mb.body_to_parent(inputs["mb"])
    _close(pp, rp, TOL_GEOM, "body_to_parent pos")
    _close(pr, rr, TOL_GEOM, "body_to_parent rot")
    _close(port_dyn[1]["l2w_pos"], ref_dyn[1]["l2w_pos"], TOL_GEOM, "l2w_pos")
    _close(port_dyn[1]["l2w_rot"], ref_dyn[1]["l2w_rot"], TOL_GEOM, "l2w_rot")


def test_jacobians_and_mass_matrix(inputs, ref_dyn, port_dyn):
    _close(port_dyn[1]["jac"], ref_dyn[1]["jac"], TOL_GEOM, "jacobians")
    _close(port_dyn[1]["coms"], ref_dyn[1]["coms"], TOL_GEOM, "link coms")
    _close(port_dyn[1]["mass_mat"], ref_dyn[1]["mass_mat"], TOL_GEOM, "mass matrix")
    assert np.array_equal(port_dyn[1]["valid"].numpy(), ref_dyn[1]["valid"])


def test_link_mass_props_and_world_inertia(inputs):
    ref = _vmap(ref_mb._link_mass_props, inputs["ref_mb"], inputs["ref_bodies"])
    port = port_mb._link_mass_props(inputs["mb"], inputs["bodies"])
    for name, a, d in zip(("mass", "principal", "pframe", "local_com"), port, ref):
        _close(a, d, TOL_GEOM, name, relative=True)
    rot = port_mb.forward_kinematics(inputs["mb"], None, *port_mb._root_pose(
        inputs["mb"], inputs["bodies"]))[1]
    iw_ref = ref_mb._world_inertia(jnp.asarray(rot.numpy()), jnp.asarray(ref[2]),
                                   jnp.asarray(ref[1]))
    _close(port_mb._world_inertia(rot, port[2], port[1]), iw_ref, TOL_GEOM,
           "world inertia", relative=True)


def test_generalized_forces_and_qdd(inputs, ref_dyn, port_dyn):
    g = inputs["g"]

    def tau_ref(mb, bodies, aux):
        mass, principal, pframe, _lc, valid = ref_mb._link_mass_props(mb, bodies)
        anchors = aux["l2w_pos"] + jax.vmap(jax.vmap(
            lambda r, p: ref_mb.quat.rotate(r, p)))(aux["l2w_rot"], mb.local_pos2)
        return ref_mb.generalized_forces(mb, aux["jac"], aux["coms"], anchors,
                                         aux["l2w_rot"], mass, principal, pframe,
                                         valid, bodies, jnp.asarray(g), DT)

    aux_r = {k: ref_dyn[1][k] for k in ("l2w_pos", "l2w_rot", "jac", "coms")}
    ref_tau = _vmap(tau_ref, inputs["ref_mb"], inputs["ref_bodies"], aux_r)
    mb, bodies = inputs["mb"], inputs["bodies"]
    aux = port_dyn[1]
    mass, principal, pframe, _lc, valid = port_mb._link_mass_props(mb, bodies)
    anchors = aux["l2w_pos"] + port_mb.quat.rotate(aux["l2w_rot"], mb.local_pos2)
    tau = port_mb.generalized_forces(mb, aux["jac"], aux["coms"], anchors,
                                     aux["l2w_rot"], mass, principal, pframe, valid,
                                     bodies, g, float(DT))
    _close(tau, ref_tau, TOL_DYN, "generalized forces", relative=True)
    _close(port_dyn[0], ref_dyn[0], TOL_DYN, "qdd", relative=True)


def test_velocities_and_integrate(inputs, ref_dyn, port_dyn):
    vel_r = _vmap(ref_mb.velocities_from_qd, inputs["ref_mb"], ref_dyn[1]["jac"])
    _close(port_mb.velocities_from_qd(inputs["mb"], port_dyn[1]["jac"]), vel_r,
           TOL_DYN, "link velocities", relative=True)
    ref_int = _vmap(lambda mb: ref_mb.integrate(mb, DT), inputs["ref_mb"])
    port_int = port_mb.integrate(inputs["mb"], float(DT))
    for name in ("q", "joint_rot", "qd"):
        _close(getattr(port_int, name), getattr(ref_int, name), TOL_GEOM,
               f"integrate {name}")


def test_integrate_projects_limits(inputs):
    """Coordinates driven past the hinge limits are clipped and stopped."""
    qd_r = np.array(inputs["ref_mb"].qd)
    qd_r[:, 0, 6 + 3::6] = 120.0                  # +2 rad in one step
    ref = _vmap(lambda mb: ref_mb.integrate(mb, DT), inputs["ref_mb"].replace(qd=qd_r))
    port = port_mb.integrate(inputs["mb"].replace(qd=torch.from_numpy(qd_r)), float(DT))
    assert np.max(np.asarray(ref.q)[:, 0, 1:, 3]) <= np.float32(1.6)
    for name in ("q", "joint_rot", "qd"):
        _close(getattr(port, name), getattr(ref, name), TOL_GEOM, f"limited {name}")


def test_write_back_bodies(inputs, ref_dyn, port_dyn):
    for next_only in (False, True):
        ref = _vmap(lambda mb, b, p, r, j, v: ref_mb.write_back_bodies(
            mb, b, p, r, j, v, next_only=next_only), inputs["ref_mb"],
            inputs["ref_bodies"], ref_dyn[1]["l2w_pos"], ref_dyn[1]["l2w_rot"],
            ref_dyn[1]["jac"], ref_dyn[1]["valid"])
        a = port_dyn[1]
        port = port_mb.write_back_bodies(inputs["mb"], inputs["bodies"], a["l2w_pos"],
                                         a["l2w_rot"], a["jac"], a["valid"],
                                         next_only=next_only)
        for name in ("pos", "rot", "next_pos", "next_rot"):
            _close(getattr(port, name), getattr(ref, name), TOL_GEOM,
                   f"write_back {name} (next_only={next_only})")
        for name in ("linvel", "angvel"):
            _close(getattr(port, name), getattr(ref, name), TOL_DYN,
                   f"write_back {name}", relative=True)


@pytest.fixture(scope="module")
def phases(inputs):
    """Phases A, B and C of both packages on the same inputs; solver-body
    tables with seeded random velocities stand in for the contact solve."""
    g = inputs["g"]
    rng = np.random.default_rng(99)
    n1 = np.shape(inputs["ref_bodies"].pos)[1] + 1
    sbn = dict(v_lin=rng.normal(0, 0.3, (B, 3, n1)), v_ang=rng.normal(0, 0.3, (B, 3, n1)),
               com=rng.normal(0, 1, (B, 3, n1)), rot=rng.normal(0, 1, (B, 4, n1)),
               im=rng.uniform(0, 1, (B, 3, n1)), ii=rng.normal(0, 1, (B, 3, 3, n1)))
    sbn = {k: v.astype(np.float32) for k, v in sbn.items()}

    def ref_run(mb, bodies, sb):
        from rapier_tpu.dynamics.solver.contact_constraints import SolverBodies as RSB

        mb, bodies, aux = ref_mb.predict_velocities(mb, bodies, jnp.asarray(g), DT)
        sb2 = ref_mb.install_link_mobility(RSB(**sb), mb, aux, bodies)
        mb_c, bodies_c = ref_mb.absorb_contact_impulses(mb, bodies, RSB(**sb), aux, DT)
        im, ii = ref_mb.link_mobility(mb, aux)
        return mb, bodies, sb2, mb_c, bodies_c, im, ii

    ref = jax.tree.map(np.asarray, _vmap(ref_run, inputs["ref_mb"],
                                         inputs["ref_bodies"], sbn))
    sb = SolverBodies(**{k: torch.from_numpy(v) for k, v in sbn.items()})
    mb, bodies, aux = port_mb.predict_velocities(inputs["mb"], inputs["bodies"], g,
                                                 float(DT))
    sb2 = port_mb.install_link_mobility(sb, mb, aux, bodies)
    mb_c, bodies_c = port_mb.absorb_contact_impulses(mb, bodies, sb, aux, float(DT))
    im, ii = port_mb.link_mobility(mb, aux)
    return ref, (mb, bodies, sb2, mb_c, bodies_c, im, ii)


def test_predict_velocities(phases):
    (rmb, rb, *_), (pmb, pb, *_) = phases
    _close(pmb.qd, rmb.qd, TOL_DYN, "phase A qd", relative=True)
    _close(pb.linvel, rb.linvel, TOL_DYN, "phase A linvel", relative=True)
    _close(pb.angvel, rb.angvel, TOL_DYN, "phase A angvel", relative=True)


def test_link_mobility_and_install(phases):
    ref, port = phases
    _close(port[5], ref[5], TOL_DYN, "mobility im", relative=True)
    _close(port[6], ref[6], TOL_DYN, "mobility ii", relative=True)
    _close(port[2].im, ref[2].im, TOL_DYN, "installed im", relative=True)
    _close(port[2].ii, ref[2].ii, TOL_DYN, "installed ii", relative=True)


def test_absorb_contact_impulses(phases):
    ref, port = phases
    rmb, rb, pmb, pb = ref[3], ref[4], port[3], port[4]
    _close(pmb.qd, rmb.qd, TOL_DYN, "phase C qd", relative=True)
    for name in ("q", "joint_rot"):
        _close(getattr(pmb, name), getattr(rmb, name), TOL_DYN, f"phase C {name}")
    for name in ("next_pos", "next_rot"):
        _close(getattr(pb, name), getattr(rb, name), TOL_DYN, f"phase C {name}")
    for name in ("linvel", "angvel"):
        _close(getattr(pb, name), getattr(rb, name), TOL_DYN, f"phase C {name}",
               relative=True)


def test_active_coupling_raises(inputs):
    mb = inputs["mb"]
    ca = mb.coupling_a.clone()
    cb = mb.coupling_b.clone()
    ca[:, 0, 0], cb[:, 0, 0] = 9, 15
    with pytest.raises(NotImplementedError, match="couplings"):
        port_mb.apply_couplings(mb.replace(coupling_a=ca, coupling_b=cb),
                                mb.qd, None)


# ---------------------------------------------------------------------------
# The reference's multibody contact scenarios (tests/test_multibody.py), on
# the port alone with the reference's thresholds.
# ---------------------------------------------------------------------------

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
