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

The dof couplings, the standalone sub-step and inverse kinematics are
held to the reference on the same inputs; the builder setters and
`insert_dof_coupling` to the reference's world.  The coupled velocity ratio
and inverse kinematics of tests/test_multibody.py run on the port alone,
with their own thresholds; its contact, motor and spring scenarios and
examples/multibody_arm.py are in tests/test_torch_multibody_scenarios.py.
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


# Coupling slots (a dof, b dof, ratio) over the quadruped's hinge dofs (link
# i's slot i * 6 + 3): 1 active slot; 2 active among 2 inactive (slot 1 has
# no a, slot 3 no b); all 4 active.
_HINGE = [i * 6 + 3 for i in range(1, 9)]
COUPLINGS = {
    "one": [(_HINGE[1], _HINGE[0], 0.5)],
    "two_of_four": [(_HINGE[2], _HINGE[3], -1.0), (-1, _HINGE[4], 2.0),
                    (_HINGE[5], _HINGE[6], 0.75), (_HINGE[7], -1, 1.0)],
    "four": [(_HINGE[1], _HINGE[0], 0.5), (_HINGE[3], _HINGE[2], -1.0),
             (_HINGE[5], _HINGE[4], 1.5), (_HINGE[7], _HINGE[6], -0.25)],
}


def _coupled(mb, slots, to):
    """`mb` (either package's, numpy or tensor leaves) with the coupling
    slots filled for both scenes; scene 1's ratios scaled by 1.1."""
    ca = np.full((B, 1, 4), -1, np.int32)
    cb = np.full((B, 1, 4), -1, np.int32)
    cr = np.ones((B, 1, 4), np.float32)
    for k, (a, b, r) in enumerate(slots):
        ca[:, 0, k], cb[:, 0, k] = a, b
        cr[:, 0, k] = (r, 1.1 * r)
    return mb.replace(coupling_a=to(ca), coupling_b=to(cb), coupling_ratio=to(cr))


@pytest.mark.parametrize("which", list(COUPLINGS))
def test_apply_couplings(inputs, ref_dyn, port_dyn, which):
    """The mass-metric projection against the reference's on the tentative
    qd of phase A, with its Cholesky factor; every active slot then holds
    qd[a] = ratio * qd[b]."""
    slots = COUPLINGS[which]
    rmb = _coupled(inputs["ref_mb"], slots, np.asarray)
    pmb = _coupled(inputs["mb"], slots, torch.from_numpy)
    qd_r = np.asarray(inputs["ref_mb"].qd) + ref_dyn[0] * DT
    ref = np.asarray(jax.vmap(ref_mb.apply_couplings)(
        jax.tree.map(jnp.asarray, rmb), jnp.asarray(qd_r), jnp.asarray(ref_dyn[1]["chol"])))
    qd_p = inputs["mb"].qd + port_dyn[0] * float(DT)
    port = port_mb.apply_couplings(pmb, qd_p, port_dyn[1]["chol"])
    _close(port, ref, TOL_DYN, f"coupled qd ({which})", relative=True)
    out = port.numpy()
    for k, (a, b, r) in enumerate(slots):
        if a >= 0 and b >= 0:
            for s_ in range(B):
                ratio = np.float32(r) * (1.0 if s_ == 0 else np.float32(1.1))
                assert abs(out[s_, 0, a] - ratio * out[s_, 0, b]) <= 1e-4 * max(
                    1.0, abs(out[s_, 0, b])), (which, k, s_)


def test_inactive_couplings_leave_qd_as_it_is(inputs, port_dyn):
    qd = inputs["mb"].qd + port_dyn[0] * float(DT)
    assert port_mb.apply_couplings(inputs["mb"], qd, port_dyn[1]["chol"]) is qd


def test_step_multibodies(inputs):
    """The standalone sub-step (forward dynamics, couplings, integration,
    FK, the links' bodies) against the reference's, with two couplings."""
    g = inputs["g"]
    rmb = _coupled(inputs["ref_mb"], COUPLINGS["two_of_four"], np.asarray)
    pmb = _coupled(inputs["mb"], COUPLINGS["two_of_four"], torch.from_numpy)
    for next_only in (False, True):
        ref = jax.tree.map(np.asarray, _vmap(
            lambda mb, b: ref_mb.step_multibodies(mb, b, jnp.asarray(g), DT,
                                                  next_only=next_only)[:2],
            rmb, inputs["ref_bodies"]))
        port = port_mb.step_multibodies(pmb, inputs["bodies"], g, float(DT),
                                        next_only=next_only)
        for name in ("q", "joint_rot"):
            _close(getattr(port[0], name), getattr(ref[0], name), TOL_DYN,
                   f"step_multibodies {name}")
        _close(port[0].qd, ref[0].qd, TOL_DYN, "step_multibodies qd", relative=True)
        for name in ("pos", "rot", "next_pos", "next_rot"):
            _close(getattr(port[1], name), getattr(ref[1], name), TOL_DYN,
                   f"step_multibodies {name} (next_only={next_only})")
        for name in ("linvel", "angvel"):
            _close(getattr(port[1], name), getattr(ref[1], name), TOL_DYN,
                   f"step_multibodies {name}", relative=True)


# ---------------------------------------------------------------------------
# Builders, couplings and inverse kinematics.
# ---------------------------------------------------------------------------

_ALL = 0b111111


def _rev_z():
    from rapier_tpu_torch.world import GenericJointBuilder

    return GenericJointBuilder(locked_axes=_ALL & ~(1 << 5))


def _both_worlds(build):
    """`build(PhysicsWorld, RigidBodyBuilder, ColliderBuilder,
    GenericJointBuilder, world kwargs)` run against each package: (the
    reference's built state, the port's)."""
    import rapier_tpu.world as rw
    import rapier_tpu_torch.world as pw

    out = []
    for mod, kw in ((rw, {}), (pw, {"device": "cpu"})):
        w = build(mod.PhysicsWorld, mod.RigidBodyBuilder, mod.ColliderBuilder,
                  mod.GenericJointBuilder, kw)
        out.append(w.build())
    return out


def _three_links(PW, RB, CB, GJ, kw):
    w = PW(**kw)
    prev = w.insert_body(RB.fixed())
    links = []
    for i in range(3):
        b = w.insert_body(RB.dynamic().with_translation((0, -(i + 1), 0)))
        w.insert_collider(CB.ball(0.1).with_density(50.0), b)
        jb = GJ(locked_axes=_ALL & ~(1 << 5)).with_local_anchor2((0, 1, 0))
        jb = jb.with_armature(5, 0.05 * (i + 1)).with_joint_damping(5, 0.5 + i)
        jb = jb.with_joint_spring(5, 10.0 * (i + 1), 0.1 * i)
        w.insert_multibody_joint(prev, b, jb)
        links.append(b)
        prev = b
    w.insert_dof_coupling(links[1], 5, links[0], 5, -1.0, 0.25)
    w.insert_dof_coupling(links[2], 5, links[1], 5, 0.5)
    return w


def test_builders_and_couplings_build_as_the_reference():
    ref, port = _both_worlds(_three_links)
    for f in dataclasses.fields(port_mb.Multibodies):
        a = np.asarray(getattr(port.multibodies, f.name))
        d = np.asarray(getattr(ref.multibodies, f.name))
        assert a.shape == d.shape and np.array_equal(a, d), f.name
    assert port.multibodies.coupling_a.tolist()[0][:2] == [2 * 6 + 5, 3 * 6 + 5]


def test_dof_coupling_velocity_ratio():
    """tests/test_multibody.py:125 on the port: qd[link2] = 2 * qd[link1]
    holds after 30 steps from a kick."""
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    root = w.insert_body(RigidBodyBuilder.fixed())
    b1 = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, -1, 0)))
    w.insert_collider(ColliderBuilder.ball(0.1).with_density(100.0), b1)
    b2 = w.insert_body(RigidBodyBuilder.dynamic().with_translation((1, -1, 0)))
    w.insert_collider(ColliderBuilder.ball(0.1).with_density(100.0), b2)
    w.insert_multibody_joint(root, b1, _rev_z().with_local_anchor2((0, 1, 0)))
    w.insert_multibody_joint(
        root, b2, _rev_z().with_local_anchor1((1, 0, 0)).with_local_anchor2((0, 1, 0)))
    w.insert_dof_coupling(b2, 5, b1, 5, 2.0)
    w.build()
    qd = w.state.multibodies.qd
    qd[0, 0, 1 * 6 + 5] = 1.0
    qd[0, 0, 2 * 6 + 5] = 2.0
    w.step(30)
    qd = w.state.multibodies.qd[0, 0].numpy()
    np.testing.assert_allclose(qd[2 * 6 + 5], 2.0 * qd[1 * 6 + 5], rtol=1e-3, atol=1e-5)


def _chain(links: int):
    """tests/test_multibody.py's IK chain: `links` revolute segments of
    length 1 hanging from a fixed root; (reference state, port state), B = 2."""
    from rapier_tpu.scenes import replicate_scene

    def build(PW, RB, CB, GJ, kw):
        w = PW(**kw)
        prev = w.insert_body(RB.fixed())
        for i in range(links):
            b = w.insert_body(RB.dynamic().with_translation((0, -(i + 1), 0)))
            w.insert_collider(CB.ball(0.1).with_density(50.0), b)
            w.insert_multibody_joint(prev, b, GJ(locked_axes=_ALL & ~(1 << 5))
                                     .with_local_anchor2((0, 1, 0)))
            prev = b
        return w

    ref, _ = _both_worlds(build)
    return replicate_scene(ref, B)


IK_CASES = {
    # (links, target link, targets per scene, constrained axes, frozen link)
    "position": (4, 4, [(2.0, -2.0, 0.0), (1.5, -2.5, 0.0)], 0b000111, None),
    "frozen": (3, 3, [(1.0, -2.2, 0.0), (0.8, -2.4, 0.0)], 0b000111, 1),
    "pose": (4, 4, [(2.0, -2.0, 0.0), (1.5, -2.5, 0.0)], 0b111111, None),
}


def _ik(which, package):
    """Inverse kinematics of IK_CASES[which] by `package` ("ref" or
    "port"): the state and the resulting q and joint_rot, numpy."""
    links, tl, targets, axes, frozen = IK_CASES[which]
    state = _chain(links)
    m, l = np.shape(state.multibodies.link_valid)[1:]
    tid = np.full((B, m), tl, np.int32)
    tpos = np.asarray(targets, np.float32).reshape(B, m, 3)
    trot = np.zeros((B, m, 4), np.float32)
    trot[..., 2] = np.sin(0.4)
    trot[..., 3] = np.cos(0.4)
    can = np.ones((B, m, l), bool)
    if frozen is not None:
        can[:, 0, frozen] = False
    kw = dict(damping=0.5, max_iters=40, constrained_axes=axes)
    if package == "ref":
        out = jax.vmap(lambda mb, b, a, p, r, c: ref_mb.inverse_kinematics(
            mb, b, a, p, r, joint_can_move=c, **kw))(
            *[jax.tree.map(jnp.asarray, x) for x in (state.multibodies, state.bodies, tid,
                                                     tpos, trot, can)])
    else:
        out = port_mb.inverse_kinematics(
            _to_port_mb(state.multibodies), _to_port_bodies(state.bodies),
            torch.from_numpy(tid), torch.from_numpy(tpos), torch.from_numpy(trot),
            joint_can_move=torch.from_numpy(can), **kw)
    return state, np.asarray(out.q), np.asarray(out.joint_rot), np.asarray(out.qd)


@pytest.mark.parametrize("which", list(IK_CASES))
def test_inverse_kinematics_matches_reference(which):
    state, q_r, jr_r, _ = _ik(which, "ref")
    _, q_p, jr_p, qd_p = _ik(which, "port")
    _close(q_p, q_r, TOL_DYN, f"IK q ({which})")
    _close(jr_p, jr_r, TOL_DYN, f"IK joint_rot ({which})")
    assert np.array_equal(qd_p, np.asarray(state.multibodies.qd))


@pytest.mark.parametrize("which", ["position", "frozen"])
def test_inverse_kinematics_scenarios(which):
    """tests/test_multibody.py:252-311 on the port: the end link's origin
    within 2e-3 of a reachable target; a frozen joint does not move while
    the rest of the chain does."""
    links, tl, targets, _, frozen = IK_CASES[which]
    state, q, jr, _ = _ik(which, "port")
    mb = _to_port_mb(state.multibodies).replace(q=torch.from_numpy(q),
                                                joint_rot=torch.from_numpy(jr))
    bodies = _to_port_bodies(state.bodies)
    l2w_pos, _ = port_mb.forward_kinematics(mb, bodies, *port_mb._root_pose(mb, bodies))
    if frozen is None:
        for s_ in range(B):
            end = l2w_pos[s_, 0, tl].numpy()
            assert np.linalg.norm(end - np.asarray(targets[s_])) < 2e-3, (s_, end)
    else:
        assert np.all(np.abs(q[:, 0, frozen, 5]) < 1e-7), "frozen joint moved"
        assert np.all(np.abs(q[:, 0, 2, 5]) + np.abs(q[:, 0, 3, 5]) > 0.1), "chain did not move"


