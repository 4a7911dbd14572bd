"""Impulse joints of rapier_tpu_torch against rapier_tpu, function by function.

- Builders: every typed builder, the rope, the spring, swing limits and the
  motor force cap give the reference's fields, and the built joint table
  (with the anchors shifted into COM space) equals the reference's exactly.
- `build_rows` on seeded joints of every kind (both motor models, limits
  active and inactive, padding) over seeded solver bodies, B = 2 scenes,
  the joint frames near coincidence (errors ~0.03 and ~0.05 rad) as the
  solver keeps them: every row field at all 21 slots within 1e-5 relative,
  1e-6 absolute.
- `solve_color` over those rows, colors 0-4 with an overflow color holding
  three joints on one body, biased then bias-free: velocities and impulses
  within 1e-5 of the largest magnitude (at least 1).

Both run twice.  In float64 (the reference under `jax.enable_x64`) they
hold the formulas to the tolerances above.  In float32, the precision both
packages run at, some rows come out of a near-dependent Gram-Schmidt or of
a small difference of positions times 1/dt, and there rounding alone (XLA
contracts multiply-adds into FMAs, PyTorch does not) moves either package
past 1e-5 of the exact rows.  So in float32 each field's largest error
against the float64 run, in units of the tolerance above, must be at most
1 or at most twice the reference's own.
- The MJCF quadruped as impulse joints: handles and the built state equal
  the reference's exactly; `apply_controls`, `joint_value` and
  `joint_velocity` equal the reference's on a seeded state, in both joint
  forms, and a top-level hinge joins a world anchor as the reference's does.
- `solve_path` sends every scene with joints to the masked sweep.

Whole steps of joints3 and the impulse-joint quadruped are held to the
reference in tests/test_torch_joint_step.py.

The reference runs eagerly (no jit) on one scene at a time.
"""

import dataclasses

import numpy as np
import pytest
import torch

B, N, J = 2, 8, 16


def _assert_rel(actual, desired, what, rtol=1e-5, atol=1e-6):
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    bad = np.abs(a - d) > atol + rtol * np.abs(d)
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {a.size} apart, worst "
                           f"{float(np.max(np.abs(a - d))):.3e}")


def _assert_scaled(actual, desired, what, tol=1e-5):
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    scale = max(1.0, float(np.max(np.abs(d))))
    err = float(np.max(np.abs(a - d)))
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol} x {scale:.3f}"


def _fields(builder):
    return {f.name: getattr(builder, f.name) for f in dataclasses.fields(builder)}


def _builders(mod):
    """The same joints from either package's builders."""
    return [
        mod.FixedJointBuilder(),
        mod.RevoluteJointBuilder((0.3, -1.0, 0.2)).with_limits(3, -0.4, 0.7),
        mod.PrismaticJointBuilder((0, 1, 0)).with_limits(0, -2.0, 2.0)
        .with_motor_position(0, 1.5, 200.0, 20.0).with_motor_max_force(0, 35.0),
        mod.SphericalJointBuilder().with_swing_limits(0.1, 0.5, twist_axis=1),
        mod.RopeJointBuilder(1.25),
        mod.SpringJointBuilder(0.5, 40.0, 2.0),
        mod.GenericJointBuilder(locked_axes=0b110110).with_motor_velocity(3, 1.5, 4.0)
        .with_local_anchor1((0.1, 0.2, 0.3)).with_local_anchor2((-0.2, 0, 0.1))
        .with_contacts_enabled(False),
    ]


def test_builders_match_reference():
    import rapier_tpu.world as ref
    import rapier_tpu_torch.world as port

    for pb, rb in zip(_builders(port), _builders(ref)):
        pf, rf = _fields(pb), _fields(rb)
        for name, value in pf.items():
            assert np.array_equal(np.asarray(value), np.asarray(rf[name])), name


def _table_world(mod, **kw):
    """Two bodies with off-centre colliders (a COM away from the origin)
    joined by every builder, and each builder again from a fixed body to
    the first: 14 joints."""
    w = mod.PhysicsWorld(**kw)
    g = w.insert_body(mod.RigidBodyBuilder.fixed().with_translation((19, 6, 0)))
    a = w.insert_body(mod.RigidBodyBuilder.dynamic().with_translation((20, 5, 0)))
    w.insert_collider(mod.ColliderBuilder.cuboid(0.3, 0.2, 0.1).with_translation((0.2, 0, 0)), a)
    b = w.insert_body(mod.RigidBodyBuilder.dynamic().with_translation((21, 5, 0)))
    w.insert_collider(mod.ColliderBuilder.ball(0.2).with_translation((0, -0.1, 0.3)), b)
    for jb in _builders(mod):
        w.insert_impulse_joint(a, b, jb.with_local_anchor1((0.5, 0, 0)))
    for jb in _builders(mod):
        w.insert_impulse_joint(g, a, jb.with_local_anchor2((-0.4, 0.1, 0)))
    return w


def test_built_joint_table_matches_reference():
    import rapier_tpu.world as ref
    import rapier_tpu_torch.world as port

    rs = _table_world(ref).build()
    ps = _table_world(port, device="cpu").build()
    assert np.abs(np.asarray(ps.bodies.local_com)).max() > 0.05
    for part in ("bodies", "colliders", "joints"):
        r, p = getattr(rs, part), getattr(ps, part)
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert a.dtype == d.dtype and np.array_equal(a, d), f"{part}.{f.name}"
    assert ps.joints.n == 16          # 14 rounded up to 8


def test_state_with_joints_crosses_both_ways():
    import rapier_tpu.world as ref
    from rapier_tpu_torch.types import from_numpy, to_numpy

    rs = _table_world(ref).build()
    back = to_numpy(from_numpy(rs))
    for f in dataclasses.fields(back.joints):
        assert np.array_equal(getattr(back.joints, f.name),
                              np.asarray(getattr(rs.joints, f.name))), f.name


# ---------------------------------------------------------------------------
# build_rows and solve_color on seeded inputs.
# ---------------------------------------------------------------------------

def _random_quat(rng, shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz])


def _qrot(q, v):
    u, w = q[:3], q[3]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _qconj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _seeded_joints(seed=3):
    """``[B, J]`` joint tables (numpy) of every kind over `_seeded_bodies`:
    the typed builders, random generic masks with motors of both models and
    limits, padding.  Frame 2 lies within ~0.03 and ~0.05 rad of frame 1."""
    import rapier_tpu_torch.world as port
    from rapier_tpu_torch.types import empty_joints

    rng = np.random.default_rng(seed)
    sb = _seeded_bodies()
    tables = []
    for s in range(B):
        t = {k: np.asarray(v).copy() for k, v in vars(empty_joints(J)).items()}
        kinds = _builders(port) + [
            port.GenericJointBuilder(locked_axes=int(rng.integers(0, 64)),
                                     limit_axes=int(rng.integers(0, 64)),
                                     motor_axes=int(rng.integers(0, 64)),
                                     coupled_axes=int(rng.choice([0, 0b011000, 0b000111])))
            for _ in range(6)]
        for i, jb in enumerate(kinds):
            b1, b2 = rng.choice(N - 1, 2, replace=False)
            if i in (2, 9, 12):
                # Joints 2, 9 and 12 share body 7: the overflow color below.
                b1 = N - 1
            t["body1"][i], t["body2"][i] = b1, b2
            rot1, rot2 = sb["rot"][s, :, b1], sb["rot"][s, :, b2]
            lp1, lr1 = rng.normal(0, 0.3, 3), _random_quat(rng, ())
            f1_pos = sb["com"][s, :, b1] + _qrot(rot1, lp1)
            f2_pos = f1_pos + rng.normal(0, 0.03, 3)
            f2_rot = _qmul(_qmul(rot1, lr1), [*rng.normal(0, 0.025, 3), 1.0])
            f2_rot /= np.linalg.norm(f2_rot)
            t["local_pos1"][i], t["local_rot1"][i] = lp1, lr1
            t["local_pos2"][i] = _qrot(_qconj(rot2), f2_pos - sb["com"][s, :, b2])
            t["local_rot2"][i] = _qmul(_qconj(rot2), f2_rot)
            for name in ("locked_axes", "limit_axes", "motor_axes", "coupled_axes"):
                t[name][i] = getattr(jb, name)
            lo = rng.uniform(-0.1, 0.05, 6)
            t["limit_min"][i] = np.where(rng.random(6) < 0.8, lo, -np.inf)
            t["limit_max"][i] = np.where(rng.random(6) < 0.8, lo + rng.uniform(0.02, 0.15, 6),
                                         np.inf)
            t["motor_target_pos"][i] = rng.normal(0, 1, 6)
            t["motor_target_vel"][i] = rng.normal(0, 1, 6)
            t["motor_stiffness"][i] = np.where(rng.random(6) < 0.7, rng.uniform(0, 300, 6), 0)
            t["motor_damping"][i] = np.where(rng.random(6) < 0.7, rng.uniform(0, 30, 6), 0)
            t["motor_max_force"][i] = np.where(rng.random(6) < 0.5, rng.uniform(1, 100, 6),
                                               3.4e38)
            t["motor_model"][i] = rng.integers(0, 2, 6)
            t["softness_frequency"][i] = rng.choice([1.0e6, 30.0])
            t["enabled"][i] = i != 5
        tables.append(t)
    return {k: np.stack([t[k] for t in tables]) for k in tables[0]}


def _seeded_bodies(seed=4):
    rng = np.random.default_rng(seed)
    n1 = N + 1
    m = rng.normal(size=(B, 3, 3, n1))
    ii = np.einsum("bijn,bkjn->bikn", m, m) * 0.5
    im = np.repeat(rng.uniform(0.2, 2.0, (B, 1, n1)), 3, axis=1)
    im[:, :, 0] = 0.0          # body 0 fixed
    ii[..., 0] = 0.0
    sb = dict(v_lin=rng.normal(size=(B, 3, n1)), v_ang=rng.normal(size=(B, 3, n1)),
              com=rng.normal(0, 0.5, (B, 3, n1)),
              rot=np.moveaxis(_random_quat(rng, (B, n1)), -1, 1), im=im, ii=ii)
    for k, v in sb.items():
        v = v.astype(np.float32)
        v[..., N] = 0.0
        if k == "rot":
            v[:, 3, N] = 1.0
        sb[k] = v
    return sb


COLOR = np.array([[0, 1, 3, 2, 0, 1, 2, 0, 1, 3, 2, 0, 3, 1, 4, 4]] * B, np.int32)
DT, INV_DT = np.float32(1.0 / 240.0), np.float32(240.0)


ROW_FIELDS = ("b1", "b2", "valid", "color", "im1", "im2", "lin_jac", "ang_jac1",
              "ang_jac2", "ii_ang_jac1", "ii_ang_jac2", "rhs", "rhs_wo_bias", "cfm_gain",
              "inv_lhs", "lo", "hi", "impulse", "active")


def _solve_colors(rows, sb, solve):
    """Colors 0-4 biased, then bias-free, through `solve(rows, sb, ci,
    use_bias)`; returns the (rows, sb) after each pass."""
    out = []
    for use_bias in (True, False):
        for ci in range(5):
            rows, sb = solve(rows, sb, ci, use_bias)
            out.append((rows, sb))
    return out


def _run_both(dtype):
    """(reference [(rows, sb)] per pass, stacked over scenes; the port's)
    with the built rows first, in `dtype`."""
    import jax
    import jax.numpy as jnp
    import rapier_tpu.dynamics.solver.joint_constraints as rjc
    import rapier_tpu.types as rt
    from rapier_tpu.dynamics.solver.contact_constraints import SolverBodies as RSB
    from rapier_tpu_torch.dynamics.solver import joint_constraints as jc
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies
    from rapier_tpu_torch.types import Joints

    jt, sbn = _seeded_joints(), _seeded_bodies()

    def cast(v):
        return v.astype(dtype) if v.dtype == np.float32 else v

    with jax.enable_x64(dtype == np.float64):
        per_scene = []
        for s in range(B):
            joints = rt.Joints(**{k: jnp.asarray(cast(v[s])) for k, v in jt.items()})
            sb = RSB(**{k: jnp.asarray(cast(v[s])) for k, v in sbn.items()})
            rows = rjc.build_rows(joints, sb, jnp.asarray(COLOR[s]), dtype(DT), dtype(INV_DT), N)
            per_scene.append([(rows, sb)] + _solve_colors(
                rows, sb, lambda r, b, ci, ub: rjc.solve_color(r, b, ci, use_bias=ub)))
        ref = [jax.tree.map(lambda *x: np.stack([np.asarray(y) for y in x]), *passes)
               for passes in zip(*per_scene)]
    pj = Joints(**{k: torch.from_numpy(cast(v)) for k, v in jt.items()})
    psb = SolverBodies(**{k: torch.from_numpy(cast(v)) for k, v in sbn.items()})
    rows = jc.build_rows(pj, psb, torch.from_numpy(COLOR), float(DT), float(INV_DT), N,
                         jc.used_slots(pj))
    route = jc.segment_route(rows.b1, rows.b2, N)
    port = [(rows, psb)] + _solve_colors(
        rows, psb, lambda r, b, ci, ub: jc.solve_color(r, b, ci, use_bias=ub, route=route))
    return ref, port


@pytest.fixture(scope="module")
def runs():
    """{dtype name: (reference passes, port passes)}."""
    return {name: _run_both(dt) for name, dt in (("f64", np.float64), ("f32", np.float32))}


def _port_field(rows, field):
    from rapier_tpu_torch.dynamics.solver import joint_constraints as jc

    x = getattr(rows, field)
    if x.dim() >= 3 and x.shape[2] == len(rows.slots):
        x = jc.full_slots(x, rows.slots)
    return x.numpy()


def _pass_values(ref, port):
    """[(what, port value, reference value)] of every pass: the built rows'
    fields, then each solve pass's velocities and impulses."""
    (r_rows, _), (p_rows, _) = ref[0], port[0]
    out = [(f, _port_field(p_rows, f), np.asarray(getattr(r_rows, f))) for f in ROW_FIELDS]
    for i, ((r_rows, r_sb), (p_rows, p_sb)) in enumerate(zip(ref[1:], port[1:])):
        for name in ("v_lin", "v_ang"):
            out.append((f"pass {i} {name}", getattr(p_sb, name).numpy(),
                        np.asarray(getattr(r_sb, name))))
        out.append((f"pass {i} impulse", _port_field(p_rows, "impulse"),
                    np.asarray(r_rows.impulse)))
    return out


def test_seeded_joints_cover_every_row(runs):
    ref, port = runs["f32"]
    ref_rows, prows = ref[0][0], port[0][0]
    used = np.asarray(ref_rows.active).any(axis=(0, 1))
    assert used.all(), np.flatnonzero(~used)
    assert prows.slots == tuple(range(21))
    # Limits both inside their range (bounds 0) and violated (one-sided).
    lo, act = np.asarray(ref_rows.lo)[..., 13:19], np.asarray(ref_rows.active)[..., 13:19]
    assert (lo[act] == 0).any() and (lo[act] < -1e38).any()


@pytest.mark.parametrize("field", ROW_FIELDS)
def test_build_rows_matches_reference(runs, field):
    ref, port = runs["f64"]
    _assert_rel(_port_field(port[0][0], field), np.asarray(getattr(ref[0][0], field)), field)


def test_kept_slots_are_the_used_ones():
    """A batch that uses few slots keeps only those, and the rows agree with
    the 21-slot rows at them (a revolute chain: slots 8-12 and its limit)."""
    import rapier_tpu_torch.world as port
    from rapier_tpu_torch.dynamics.solver import joint_constraints as jc
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies
    from rapier_tpu_torch.types import Joints

    jt, sbn = _seeded_joints(), _seeded_bodies()
    rev = port.RevoluteJointBuilder((0, 0, 1)).with_limits(3, -0.5, 0.5)
    for name in ("locked_axes", "limit_axes", "motor_axes", "coupled_axes"):
        jt[name][:] = getattr(rev, name)
    pj = Joints(**{k: torch.from_numpy(v) for k, v in jt.items()})
    psb = SolverBodies(**{k: torch.from_numpy(v) for k, v in sbn.items()})
    color = torch.from_numpy(COLOR)
    slots = jc.used_slots(pj)
    assert slots == (8, 9, 10, 11, 12, 13)
    rows = jc.build_rows(pj, psb, color, float(DT), float(INV_DT), N, slots)
    full = jc.build_rows(pj, psb, color, float(DT), float(INV_DT), N, tuple(range(21)))
    for f in ("lin_jac", "ang_jac2", "ii_ang_jac1", "rhs", "inv_lhs", "lo", "hi"):
        assert torch.equal(jc.full_slots(getattr(rows, f), rows.slots), getattr(full, f)), f


def test_build_takes_the_joint_slot_census():
    """`PhysicsWorld.build` keeps the slots its joint table uses in
    `SimParams.joint_slots`; parameters from the reference keep all 21."""
    import rapier_tpu.types as rt
    from rapier_tpu_torch.dynamics.solver import joint_constraints as jc
    from rapier_tpu_torch.scenes import joints3_world
    from rapier_tpu_torch.types import from_numpy

    w, _ = joints3_world(device="cpu")
    w.build()
    # Revolute / fixed / prismatic / spherical locks, the slider's motor and
    # limit, the rope's swing limit.
    assert w.params.joint_slots == jc.used_slots(w.state.joints) == (3, 7, 8, 9, 10, 11, 12, 16, 20)
    assert from_numpy(rt.SimParams()).joint_slots == tuple(range(21))


def test_solve_color_matches_reference(runs):
    ref, port = runs["f64"]
    # The overflow color 3 holds joints 2, 9 and 12, all on body 7.
    jt = _seeded_joints()
    assert (COLOR[:, [2, 9, 12]] == 3).all() and (jt["body1"][:, [2, 9, 12]] == N - 1).all()
    for what, p, r in _pass_values(ref, port)[len(ROW_FIELDS):]:
        _assert_scaled(p, r, what)
    assert float(np.abs(port[-1][0].impulse.numpy()).max()) > 0.1


def test_float32_rounding_as_close_as_the_reference(runs):
    """In float32 each field's largest error against the float64 run, in
    units of the tolerance, is at most 1 or twice the reference's."""
    exact = [r for _, _, r in _pass_values(*runs["f64"])]
    for (what, p32, r32), r64 in zip(_pass_values(*runs["f32"]), exact):
        p32, r32, r64 = (np.asarray(x, np.float64) for x in (p32, r32, r64))
        if what in ROW_FIELDS:
            tol = 1e-6 + 1e-5 * np.abs(r64)
        else:
            tol = 1e-5 * max(1.0, float(np.abs(r64).max()))
        port, ref = np.max(np.abs(p32 - r64) / tol), np.max(np.abs(r32 - r64) / tol)
        assert port <= max(1.0, 2.0 * ref), f"{what}: port {port:.3f}, reference {ref:.3f}"


def test_motor_and_spring_coefficients_match_reference():
    import jax.numpy as jnp
    import rapier_tpu.dynamics.solver.joint_constraints as rjc
    from rapier_tpu_torch.dynamics.solver import joint_constraints as jc

    rng = np.random.default_rng(8)
    model = rng.integers(0, 2, 64).astype(np.int32)
    stiff = np.where(rng.random(64) < 0.3, 0.0, rng.uniform(0, 500, 64)).astype(np.float32)
    damp = np.where(rng.random(64) < 0.3, 0.0, rng.uniform(0, 50, 64)).astype(np.float32)
    ref = rjc.motor_coefficients(jnp.asarray(model), jnp.asarray(stiff), jnp.asarray(damp), DT)
    port = jc.motor_coefficients(torch.from_numpy(model), torch.from_numpy(stiff),
                                 torch.from_numpy(damp), float(DT))
    for r, p in zip(ref, port):
        _assert_rel(p.numpy(), np.asarray(r), "motor coefficients")
    freq = rng.choice([0.0, 5.0, 30.0, 1.0e6], 64).astype(np.float32)
    ratio = rng.uniform(0.1, 5.0, 64).astype(np.float32)
    _assert_rel(jc.spring_cfm_coeff(torch.from_numpy(freq), torch.from_numpy(ratio),
                                    float(DT)).numpy(),
                np.asarray(rjc.spring_cfm_coeff(jnp.asarray(freq), jnp.asarray(ratio), DT)),
                "spring cfm coefficient")


# ---------------------------------------------------------------------------
# The MJCF quadruped as impulse joints; the solve gate.
# ---------------------------------------------------------------------------

def _quadrupeds(use_multibody=False):
    from rapier_tpu.scenes import quadruped_world as ref_world
    from rapier_tpu_torch.scenes import quadruped_world as port_world

    rw, rh = ref_world(use_multibody=use_multibody)
    pw, ph = port_world(use_multibody=use_multibody, device="cpu")
    return rw, rh, pw, ph


def test_mjcf_impulse_form_matches_reference():
    rw, rh, pw, ph = _quadrupeds()
    rs, ps = rw.build(), pw.build()
    assert ph.bodies == rh.bodies and ph.joints == rh.joints
    assert ph.joint_axis == rh.joint_axis and ph.joint_order == rh.joint_order
    assert not ph.use_multibody and ps.multibodies is None and ps.joints.n == 8
    for part in ("bodies", "colliders", "contacts", "joints"):
        r, p = getattr(rs, part), getattr(ps, part)
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert a.dtype == d.dtype and np.array_equal(a, d), f"{part}.{f.name}"
    np.testing.assert_array_equal(ps.joints.motor_stiffness[:, 3], np.float32(80.0))
    assert pw.params.shape_types_present == rw.params.shape_types_present


@pytest.mark.parametrize("use_multibody", [False, True])
def test_mjcf_accessors_match_reference(use_multibody):
    """apply_controls, then joint_value and joint_velocity of every joint on
    a state with seeded body poses and velocities (impulse joints) or seeded
    generalized coordinates and velocities (the articulation)."""
    import jax.numpy as jnp

    rw, rh, pw, ph = _quadrupeds(use_multibody)
    rw.build()
    pw.build()
    rng = np.random.default_rng(21)
    ctrl = rng.uniform(-1, 1, len(rh.actuators))
    rh.apply_controls(rw, ctrl)
    ph.apply_controls(pw, ctrl)
    part = "multibodies" if use_multibody else "joints"
    for name in ("motor_target_pos", "motor_target_vel"):
        np.testing.assert_array_equal(
            getattr(getattr(pw.state, part), name)[0].numpy(),
            np.asarray(jnp.asarray(getattr(getattr(rw.state, part), name))))
    if use_multibody:
        mb = pw.state.multibodies
        new = {k: rng.normal(size=tuple(getattr(mb, k).shape[1:])).astype(np.float32)
               for k in ("q", "qd")}
        rw.state = rw.state.replace(multibodies=rw.state.multibodies.replace(**new))
        for k, v in new.items():
            getattr(mb, k)[0] = torch.from_numpy(v)
    else:
        nb = pw.state.bodies.pos.shape[1]
        new = dict(pos=rng.normal(0, 0.3, (nb, 3)), rot=_random_quat(rng, (nb,)),
                   linvel=rng.normal(size=(nb, 3)), angvel=rng.normal(size=(nb, 3)))
        new = {k: v.astype(np.float32) for k, v in new.items()}
        rw.state = rw.state.replace(bodies=rw.state.bodies.replace(**new))
        for k, v in new.items():
            getattr(pw.state.bodies, k)[0] = torch.from_numpy(v)
    for name in rh.joint_order:
        assert ph.joint_value(pw, name) == rh.joint_value(rw, name), name
        assert ph.joint_velocity(pw, name) == rh.joint_velocity(rw, name), name


@pytest.mark.parametrize("use_multibody", [False, True])
def test_mjcf_top_level_hinge_matches_reference(use_multibody):
    """A top-level hinged body joins a fixed world anchor made at first need
    (both joint forms)."""
    from rapier_tpu.loaders.mjcf import load_mjcf as ref_load
    from rapier_tpu.world import PhysicsWorld as RefWorld
    from rapier_tpu_torch.loaders.mjcf import load_mjcf
    from rapier_tpu_torch.world import PhysicsWorld

    xml = ('<mujoco><compiler angle="radian"/><worldbody>'
           '<geom type="plane" size="5 5 0.1"/>'
           '<body name="arm" pos="0.1 0.2 1.0"><joint name="j0" type="hinge" axis="1 0 0"'
           ' pos="0 0 0.1" limited="true" range="-1 1"/>'
           '<geom type="box" size="0.1 0.1 0.3" density="500"/>'
           '<body name="fore" pos="0 0 -0.6"><joint name="j1" type="hinge" axis="0 1 0"/>'
           '<geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.05"/></body></body>'
           '</worldbody><actuator><position joint="j0" kp="50"/></actuator></mujoco>')
    rw, pw = RefWorld(gravity=(0, 0, -9.81)), PhysicsWorld(gravity=(0, 0, -9.81), device="cpu")
    rh = ref_load(xml, rw, use_multibody=use_multibody)
    ph = load_mjcf(xml, pw, use_multibody=use_multibody)
    assert ph.bodies == rh.bodies and ph.joints == rh.joints
    rs, ps = rw.build(), pw.build()
    for part in ("bodies", "colliders", "multibodies" if use_multibody else "joints"):
        r, p = getattr(rs, part), getattr(ps, part)
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert np.array_equal(a, d), f"{part}.{f.name}"


def test_joint_scenes_take_the_masked_sweep(monkeypatch):
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.scenes import joints3_world
    from rapier_tpu_torch.types import from_numpy

    w, _ = joints3_world(device="cpu", max_pairs=1024)
    state = from_numpy(w.build())
    no_joints = dataclasses.replace(state, joints=None)
    for backend in ("auto", "pallas", "jax"):
        params = w.params.replace(solver_backend=backend)
        assert pp.solve_path(state, params) == "masked"
    assert pp.solve_path(no_joints, w.params) == "kernel"
    # Above the routing limit a scene without joints is solved blocked.
    monkeypatch.setattr(pp, "DENSE_ROUTE_ELEMS", 0)
    assert pp.solve_path(no_joints, w.params.replace(solver_backend="jax")) == "blocked"
    assert pp.solve_path(state, w.params.replace(solver_backend="jax")) == "masked"
    assert pp.solve_path(state, w.params) == "masked"
