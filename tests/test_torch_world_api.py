"""rapier_tpu_torch.world's runtime API against rapier_tpu.world's.

The reference's own scenarios (tests/test_mutation.py, test_nan_guard.py,
test_world_api.py) run through both packages on the CPU.  Runtime insert and
remove, the body setters, growth past capacity and the snapshot files are
host-side in both, so every state leaf, the handle generations, the free
lists and `params.shape_types_present` must be equal exactly after each
call.  The readers take one contact state, stepped by the port and handed to
both.  The NaN guard runs the reference's own `step` and guard on the port's
physics (its jitted step replaced by the port's), so both guards see the
same states.  One stepped run mutates mid-run against the reference's
`PhysicsWorld.step` (its only two step compiles: before and after the
runtime insertion changes the shape census).  The last tests pin the
reference faults the port copies (ROADMAP R18-R21, R25) and the one it does
not (R22).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_common import to_reference


def _ref_state(port_state):
    """A port state's scene 0 as a reference SceneState with numpy leaves."""
    from rapier_tpu_torch.types import tree_map

    return to_reference(tree_map(lambda x: x[0], port_state))


def _modules():
    import rapier_tpu.world as ref
    import rapier_tpu_torch.world as port

    return ref, port


def _world(m, **kw):
    if m.__name__.startswith("rapier_tpu_torch"):
        kw.setdefault("device", "cpu")
    return m.PhysicsWorld(**kw)


def _ground(m, w):
    g = w.insert_body(m.RigidBodyBuilder.fixed().with_translation((0, -1, 0)))
    w.insert_collider(m.ColliderBuilder.cuboid(20, 1, 20), g)
    return g


def _both(make, **kw):
    """`make(module, world)` on a world of each package, then build():
    (reference world, its result, port world, its result)."""
    ref, port = _modules()
    out = []
    for m in (ref, port):
        w = _world(m, **kw)
        r = make(m, w)
        w.build()
        out += [w, r]
    return out


def _leaf(x):
    a = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
    return a if a.dtype == bool else a.astype(np.float64)


def assert_worlds_equal(rw, pw, what):
    """Every body, collider, contact and joint leaf (scene 0 of the port's),
    the mutation bookkeeping and the shape census."""
    for part in ("bodies", "colliders", "contacts", "joints"):
        r, p = getattr(rw.state, part), getattr(pw.state, part)
        assert (r is None) == (p is None), (what, part)
        if p is None:
            continue
        for f in dataclasses.fields(p):
            a, d = _leaf(getattr(p, f.name)[0]), _leaf(getattr(r, f.name))
            assert a.shape == d.shape, (what, part, f.name, a.shape, d.shape)
            assert np.array_equal(a, d, equal_nan=True), (what, part, f.name)
    if getattr(rw, "_body_gen", None) is not None:
        np.testing.assert_array_equal(pw._body_gen, rw._body_gen, err_msg=what)
        np.testing.assert_array_equal(pw._collider_gen, rw._collider_gen, err_msg=what)
        assert pw._free_bodies == rw._free_bodies, what
        assert pw._free_colliders == rw._free_colliders, what
        assert list(pw._collider_meta) == list(rw._collider_meta), what
    assert pw.params.shape_types_present == rw.params.shape_types_present, what


def _same_handle(hr, hp):
    assert (hp.index, hp.generation) == (hr.index, hr.generation)


# ---------------------------------------------------------------------------
# The builders' new setters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [(True, False, True), (False, False, True),
                                   (False, True, False)])
def test_builder_setters_match_reference(flags):
    ref, port = _modules()
    for rb, pb in ((ref.RigidBodyBuilder.dynamic().lock_translations(),
                    port.RigidBodyBuilder.dynamic().lock_translations()),
                   (ref.RigidBodyBuilder.dynamic().lock_rotations(),
                    port.RigidBodyBuilder.dynamic().lock_rotations())):
        assert pb.enabled_rotations(*flags).locked_axes == \
            rb.enabled_rotations(*flags).locked_axes
        assert pb.enabled_translations(*flags).locked_axes == \
            rb.enabled_translations(*flags).locked_axes
    for sensor in (True, False):
        assert port.ColliderBuilder.ball(1.0).with_sensor(sensor).sensor == \
            ref.ColliderBuilder.ball(1.0).with_sensor(sensor).sensor


def test_body_handle_indexes_and_is_immutable():
    _ref, port = _modules()
    h = port.BodyHandle(2, 3)
    t = torch.arange(12.0).reshape(1, 4, 3)
    assert torch.equal(t[0, h], t[0, 2]) and np.arange(4)[h] == 2 and int(h) == 2
    assert h == port.BodyHandle(2, 3) and h != port.BodyHandle(2, 4)
    assert len({h, port.BodyHandle(2, 3)}) == 1
    with pytest.raises(AttributeError):
        h.index = 1


# ---------------------------------------------------------------------------
# tests/test_mutation.py's scenarios, leaf for leaf
# ---------------------------------------------------------------------------


def _stack(m, w):
    _ground(m, w)
    bottom = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0, 0.5, 0)))
    w.insert_collider(m.ColliderBuilder.ball(0.5), bottom)
    top = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0, 1.5, 0)))
    w.insert_collider(m.ColliderBuilder.ball(0.5), top)
    return bottom, top


def test_removal_before_step():
    """physics_pipeline.rs:852-903: removing a body before the next step
    leaves a consistent world; the ball stacked on it lands on the ground
    (the port steps it)."""
    rw, (rb, rt), pw, (pb, pt) = _both(_stack)
    rw.remove_body_runtime(rb)
    pw.remove_body_runtime(pb)
    assert_worlds_equal(rw, pw, "removed")
    pw.step(60)
    assert abs(float(pw.body_translation(pt)[1]) - 0.5) < 0.05


def test_stale_handle_raises_and_slot_reuse():
    ref, port = _modules()
    rw, _, pw, _ = _both(_ground)
    hs = {}
    for m, w in ((ref, rw), (port, pw)):
        h1 = w.insert_body_runtime(m.RigidBodyBuilder.dynamic().with_translation((0, 2, 0)))
        c1 = w.insert_collider_runtime(m.ColliderBuilder.ball(0.3), h1)
        w.remove_body_runtime(h1)
        h2 = w.insert_body_runtime(m.RigidBodyBuilder.dynamic().with_translation((3, 2, 0)))
        with pytest.raises(AssertionError):
            w.remove_body_runtime(h1)
        with pytest.raises(AssertionError):
            w.remove_collider_runtime(c1)
        hs[m] = (h1, c1, h2)
    for hr, hp in zip(hs[ref], hs[port]):
        _same_handle(hr, hp)
    h1, _c1, h2 = hs[port]
    assert h2.index == h1.index and h2.generation == h1.generation + 1
    np.testing.assert_array_equal(pw.body_translation(h2), [3, 2, 0])
    assert_worlds_equal(rw, pw, "reused")


def test_remove_collider_updates_mass():
    ref, port = _modules()

    def make(m, w):
        _ground(m, w)
        b = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0, 5, 0)))
        w.insert_collider(m.ColliderBuilder.ball(0.5).with_density(1.0), b)
        return b

    rw, rb, pw, pb = _both(make)
    m0 = 1.0 / float(pw.state.bodies.inv_mass[0, pb])
    cr = rw.insert_collider_runtime(ref.ColliderBuilder.ball(0.5).with_density(1.0), rb)
    cp = pw.insert_collider_runtime(port.ColliderBuilder.ball(0.5).with_density(1.0), pb)
    _same_handle(cr, cp)
    assert_worlds_equal(rw, pw, "inserted")
    np.testing.assert_allclose(1.0 / float(pw.state.bodies.inv_mass[0, pb]), 2 * m0, rtol=1e-4)
    # An off-centre capsule moves the centre of mass; its removal restores it.
    cr2 = rw.insert_collider_runtime(
        ref.ColliderBuilder.capsule_y(0.3, 0.2).with_translation((0.4, 0, 0)), rb)
    cp2 = pw.insert_collider_runtime(
        port.ColliderBuilder.capsule_y(0.3, 0.2).with_translation((0.4, 0, 0)), pb)
    assert_worlds_equal(rw, pw, "capsule inserted")
    for w, c in ((rw, cr2), (pw, cp2), (rw, cr), (pw, cp)):
        w.remove_collider_runtime(c)
    assert_worlds_equal(rw, pw, "removed")
    np.testing.assert_allclose(1.0 / float(pw.state.bodies.inv_mass[0, pb]), m0, rtol=1e-4)


def test_grow_past_capacity():
    """Past the capacity both tables grow by 8 slots; the leaves keep the
    reference's shapes and values, and the port steps the grown world."""
    ref, port = _modules()
    rw, _, pw, _ = _both(_ground)
    n_cap = pw.state.bodies.n
    hs = []
    for i in range(n_cap + 4):
        for m, w in ((ref, rw), (port, pw)):
            h = w.insert_body_runtime(
                m.RigidBodyBuilder.dynamic().with_translation((i * 2.0, 1.0, 0)))
            w.insert_collider_runtime(m.ColliderBuilder.ball(0.4), h)
        hs.append(h)
    assert pw.state.bodies.n == rw.state.bodies.n == n_cap + 8
    assert pw.state.colliders.n == rw.state.colliders.n
    assert_worlds_equal(rw, pw, "grown")
    pw.step(20)
    assert all(np.isfinite(pw.body_translation(h)).all() for h in hs)


def test_setters_match_reference():
    """set_linvel, apply_impulse, add_force, reset_forces, wake_up and
    set_next_kinematic_translation, each by int or handle."""
    ref, port = _modules()
    rw, (rb, rt), pw, (pb, pt) = _both(_stack)
    hr = rw.insert_body_runtime(ref.RigidBodyBuilder.kinematic_position_based())
    hp = pw.insert_body_runtime(port.RigidBodyBuilder.kinematic_position_based())
    rw.insert_collider_runtime(ref.ColliderBuilder.ball(0.2), hr)
    pw.insert_collider_runtime(port.ColliderBuilder.ball(0.2), hp)
    calls = [
        ("set_linvel", lambda w, b, t, h: w.set_linvel(b, (1.0, -2.0, 0.5))),
        ("apply_impulse", lambda w, b, t, h: w.apply_impulse(t, (0.3, 0.0, -0.7))),
        ("add_force", lambda w, b, t, h: w.add_force(b, (0.0, 4.0, 1.0), wake_up=False)),
        ("add_force twice", lambda w, b, t, h: w.add_force(b, (0.5, 0.0, 0.0))),
        ("reset_forces", lambda w, b, t, h: w.reset_forces(b)),
        ("wake_up", lambda w, b, t, h: w.wake_up(t)),
        ("kinematic target", lambda w, b, t, h: w.set_next_kinematic_translation(
            h, (0.0, 3.0, 0.25))),
        ("set_linvel by handle", lambda w, b, t, h: w.set_linvel(h, (0.0, 0.0, 2.0), False)),
    ]
    for what, call in calls:
        call(rw, rb, rt, hr)
        call(pw, pb, pt, hp)
        assert_worlds_equal(rw, pw, what)


def test_remove_body_disables_its_impulse_joints():
    ref, port = _modules()

    def make(m, w):
        g = _ground(m, w)
        a = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0, 2, 0)))
        w.insert_collider(m.ColliderBuilder.ball(0.2), a)
        b = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((1, 2, 0)))
        w.insert_collider(m.ColliderBuilder.ball(0.2), b)
        w.insert_impulse_joint(g, a, m.GenericJointBuilder.spherical())
        w.insert_impulse_joint(a, b, m.GenericJointBuilder.fixed())
        return a

    rw, ra, pw, pa = _both(make)
    rw.remove_body_runtime(ra)
    pw.remove_body_runtime(pa)
    assert_worlds_equal(rw, pw, "removed")
    assert not pw.state.joints.enabled[0, :2].any()


def test_mutating_run_matches_reference_step():
    """One run that mutates mid-run, stepped by the reference's
    `PhysicsWorld.step` and the port's: 10 steps, then a body removed, a
    ball inserted at runtime and a velocity set, then 10 steps.  Positions
    within 1e-4, velocities within 1e-3, pair keys equal, every step."""
    ref, port = _modules()

    def make(m, w):
        _ground(m, w)
        hs = []
        for i, y in enumerate((0.5, 1.6, 2.7)):
            h = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0.1 * i, y, 0)))
            w.insert_collider(m.ColliderBuilder.ball(0.5), h)
            hs.append(h)
        return hs

    rw, rh, pw, ph = _both(make)
    for w in (rw, pw):      # the masked sweep in both: the reference's cheapest compile
        w.params = w.params.replace(solver_backend="jax")

    def check(what):
        rs, ps = rw.state, pw.state
        np.testing.assert_allclose(ps.bodies.pos[0].numpy(), np.asarray(rs.bodies.pos),
                                   atol=1e-4, err_msg=what)
        for name in ("linvel", "angvel"):
            np.testing.assert_allclose(getattr(ps.bodies, name)[0].numpy(),
                                       np.asarray(getattr(rs.bodies, name)), atol=1e-3,
                                       err_msg=f"{what} {name}")
        np.testing.assert_array_equal(ps.contacts.pair_key[0].numpy(),
                                      np.asarray(rs.contacts.pair_key), err_msg=what)

    for k in range(10):
        rw.step()
        pw.step()
        check(f"step {k + 1}")
    rw.remove_body_runtime(rh[0])
    pw.remove_body_runtime(ph[0])
    hr = rw.insert_body_runtime(ref.RigidBodyBuilder.dynamic().with_translation((1.5, 1.0, 0)))
    hp = pw.insert_body_runtime(port.RigidBodyBuilder.dynamic().with_translation((1.5, 1.0, 0)))
    rw.insert_collider_runtime(ref.ColliderBuilder.ball(0.3), hr)
    pw.insert_collider_runtime(port.ColliderBuilder.ball(0.3), hp)
    rw.set_linvel(rh[2], (0.5, 0.0, 0.0))
    pw.set_linvel(ph[2], (0.5, 0.0, 0.0))
    _same_handle(hr, hp)
    for k in range(10):
        rw.step()
        pw.step()
        check(f"step {k + 11}")
    assert float(pw.body_translation(hp)[1]) < 1.0      # the inserted ball fell


# ---------------------------------------------------------------------------
# tests/test_nan_guard.py's scenarios: the reference's step and guard on the
# port's physics
# ---------------------------------------------------------------------------


def _ball(m, w):
    _ground(m, w)
    b = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0, 2, 0)))
    w.insert_collider(m.ColliderBuilder.ball(0.5), b)
    return b


def _guarded(**kw):
    """Both worlds, the reference's jitted step replaced by the port's
    pipeline step on the same state."""
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.scenes import replicate_scene
    from rapier_tpu_torch.types import from_numpy

    rw, rb, pw, pb = _both(_ball, **kw)
    params = pw.params

    def port_step(state, _params):
        new, events = step(from_numpy(replicate_scene(state, 1)), params)
        return _ref_state(new), events

    rw._jit_step = port_step
    rw.state = _ref_state(pw.state)
    return rw, rb, pw, pb


def _poison(rw, pw, b):
    pos = np.array(rw.state.bodies.pos)
    pos[b, 1] = np.nan
    rw.state = rw.state.replace(bodies=rw.state.bodies.replace(pos=pos))
    pw.state.bodies.pos[0, b, 1] = float("nan")


def _guard_state(rw, pw, what):
    assert (pw.nan_rollbacks, pw._nan_tick) == (rw.nan_rollbacks, rw._nan_tick), what
    for name in ("pos", "linvel", "angvel", "rot"):
        a = getattr(pw.state.bodies, name)[0].numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(rw.state.bodies, name)),
                                      err_msg=f"{what} {name}")


def test_nan_trap_raises():
    rw, rb, pw, pb = _guarded(nan_policy="trap", nan_check_every=1)
    for w in (rw, pw):
        w.step(2)
    _guard_state(rw, pw, "before")
    _poison(rw, pw, pb)
    for w in (rw, pw):
        with pytest.raises(FloatingPointError):
            w.step(1)
    _guard_state(rw, pw, "trapped")


@pytest.mark.parametrize("every", [1, 3])
def test_nan_rollback_restores_last_finite(every):
    """The guard restores the last state that passed a check, bitwise,
    counts the rollback, and stepping goes on; with every = 3 the NaN
    survives two steps before the check sees it."""
    rw, rb, pw, pb = _guarded(nan_policy="rollback", nan_check_every=every)
    for w in (rw, pw):
        w.step(6)
    _guard_state(rw, pw, "before")
    kept = pw._last_finite.bodies.pos.clone()
    _poison(rw, pw, pb)
    assert torch.equal(pw._last_finite.bodies.pos, kept)    # a copy, not the state
    for w in (rw, pw):
        w.step(every)
    assert pw.nan_rollbacks == 1
    _guard_state(rw, pw, "rolled back")
    assert torch.equal(pw.state.bodies.pos, kept)
    for w in (rw, pw):
        w.step(3)
    _guard_state(rw, pw, "after")
    assert np.isfinite(pw.body_translation(pb)).all()


def test_nan_ignore_is_default_and_free():
    ref, port = _modules()
    pw = _world(port)
    pb = _ball(port, pw)
    assert pw.nan_policy == _world(ref).nan_policy == "ignore"
    pw.build()
    pw.step(3)
    assert pw._nan_tick == 0 and pw._last_finite is None
    assert np.isfinite(pw.body_translation(pb)).all()


# ---------------------------------------------------------------------------
# tests/test_world_api.py's scenarios: the readers on one shared contact
# state, snapshots in memory and on disk
# ---------------------------------------------------------------------------


def _settled_make(m, w):
    _ground(m, w)
    b = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0, 0.6, 0)))
    w.insert_collider(m.ColliderBuilder.cuboid(0.5, 0.5, 0.5), b)
    s = w.insert_body(m.RigidBodyBuilder.fixed().with_translation((0, 0.5, 0)))
    w.insert_collider(m.ColliderBuilder.ball(2.0).as_sensor(), s)
    return b


@pytest.fixture(scope="module")
def settled():
    """The settled box and sensor ball of tests/test_world_api.py, stepped
    30 steps by the port; the reference world holds the same state."""
    rw, rb, pw, pb = _both(_settled_make)
    pw.step(30)
    rw.state = _ref_state(pw.state)
    return rw, pw, pb


def test_contact_readers_match_reference(settled):
    rw, pw, _b = settled
    for c in range(3):
        np.testing.assert_array_equal(pw.contact_pairs_with(c), rw.contact_pairs_with(c))
        got, want = pw.contacts_with(c), rw.contacts_with(c)
        assert [g[0] for g in got] == [w_[0] for w_ in want]
        for g, w_ in zip(got, want):
            for a, d in zip(g[1:], w_[1:]):
                np.testing.assert_array_equal(a, d)
    others = [c[0] for c in pw.contacts_with(1)]
    assert 0 in others                                      # the box on the ground
    assert np.all(pw.contacts_with(1)[others.index(0)][3] < 0.01)


def test_sensor_intersections_match_reference(settled):
    rw, pw, _b = settled
    rpairs = [tuple(int(x) for x in p) for p in rw.intersection_pairs()]
    assert pw.intersection_pairs() == rpairs
    for c in range(3):
        assert pw.intersection_pairs_with(c) == rw.intersection_pairs_with(c)
    assert 2 in pw.intersection_pairs_with(1)               # the sensor ball holds the box
    for a, b in ((1, 2), (2, 1), (0, 1), (0, 2)):
        assert pw.is_intersecting(a, b) == rw.is_intersecting(a, b)
    assert pw.is_intersecting(2, 1)


def test_snapshot_is_a_copy(settled):
    """The port writes its tensors in place: a snapshot (and what restore
    installs) must not move with the world."""
    _rw, pw, b = settled
    snap = pw.snapshot()
    keep = snap.bodies.linvel.clone()
    pw.set_linvel(b, (5.0, 0.0, 0.0))
    assert torch.equal(snap.bodies.linvel, keep)
    pw.restore(snap)
    pw.set_linvel(b, (6.0, 0.0, 0.0))
    assert torch.equal(snap.bodies.linvel, keep)
    pw.restore(snap)
    assert torch.equal(pw.state.bodies.linvel, keep)


def test_snapshot_file_roundtrip(settled, tmp_path):
    """save, 10 steps, load: the saved state back bitwise, and the same 10
    steps again give the same state bitwise.  The reference's save and load
    of the same state give the same leaves."""
    rw, pw, b = settled
    pw.save_snapshot(str(tmp_path / "port.npz"))
    saved = pw.snapshot()
    pw.step(10)
    moved = pw.snapshot()
    pw.load_snapshot(str(tmp_path / "port.npz"))
    for a, d in zip(_leaves(pw.state), _leaves(saved)):
        assert a.dtype == d.dtype and torch.equal(a, d)
    pw.step(10)
    for a, d in zip(_leaves(pw.state), _leaves(moved)):
        assert torch.equal(a, d)
    rw.state = _ref_state(saved)
    rw.save_snapshot(str(tmp_path / "ref.npz"))
    rw.load_snapshot(str(tmp_path / "ref.npz"))
    pw.load_snapshot(str(tmp_path / "port.npz"))
    assert_worlds_equal(rw, pw, "loaded")


def _leaves(state):
    from rapier_tpu_torch.world import _state_leaves

    return _state_leaves(state)


@pytest.mark.parametrize("other", ["capacities", "joints"])
def test_snapshot_mismatched_world_rejected(settled, tmp_path, other):
    """A world of other capacities (leaf shapes) or with impulse joints
    (structure) refuses the file, as the reference's does, before writing
    anything."""
    ref, port = _modules()
    rw, pw, _b = settled
    rw.state = _ref_state(pw.state)
    rw.save_snapshot(str(tmp_path / "ref.npz"))
    pw.save_snapshot(str(tmp_path / "port.npz"))
    for m, path in ((ref, "ref.npz"), (port, "port.npz")):
        kw = dict(body_capacity=64, collider_capacity=64) if other == "capacities" else {}
        w = _world(m, **kw)
        g = w.insert_body(m.RigidBodyBuilder.fixed())
        w.insert_collider(m.ColliderBuilder.cuboid(1, 1, 1), g)
        if other == "joints":
            b = w.insert_body(m.RigidBodyBuilder.dynamic())
            w.insert_impulse_joint(g, b, m.GenericJointBuilder.fixed())
        w.build()
        before = [np.array(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
                  for x in _leaves(w.state)] if m is port else None
        with pytest.raises(ValueError, match="mismatch"):
            w.load_snapshot(str(tmp_path / path))
        if m is port:
            for a, d in zip(_leaves(w.state), before):
                np.testing.assert_array_equal(a.numpy(), d)


# ---------------------------------------------------------------------------
# The reference faults the port copies (ROADMAP R18-R21, R25), and one it
# does not (R22)
# ---------------------------------------------------------------------------


def test_reused_body_slot_keeps_stale_fields():
    """R18: insert_body_runtime writes 20 fields; a reused slot keeps the
    removed body's force, torque, CCD flag, soft-CCD distance, principal
    frame and user data, in both packages."""
    ref, port = _modules()

    def make(m, w):
        _ground(m, w)
        b = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0, 2, 0))
                          ._set(ccd_enabled=True, soft_ccd_prediction=0.25, user_data=7))
        w.insert_collider(m.ColliderBuilder.cuboid(0.2, 0.4, 0.1).with_rotation(
            (0.3, 0.2, 0.1)), b)
        return b

    rw, rb, pw, pb = _both(make)
    for w, b in ((rw, rb), (pw, pb)):
        w.add_force(b, (1.0, 2.0, 3.0))
        w.remove_body_runtime(b)
    frame = pw.state.bodies.principal_frame[0, pb].clone()
    hr = rw.insert_body_runtime(ref.RigidBodyBuilder.dynamic())
    hp = pw.insert_body_runtime(port.RigidBodyBuilder.dynamic())
    assert hp.index == pb
    assert_worlds_equal(rw, pw, "reused")
    bodies = pw.state.bodies
    assert bodies.force[0, hp].tolist() == [1.0, 2.0, 3.0]
    assert bool(bodies.ccd_enabled[0, hp]) and int(bodies.user_data[0, hp]) == 7
    assert float(bodies.soft_ccd_prediction[0, hp]) == 0.25
    assert torch.equal(bodies.principal_frame[0, hp], frame)


def test_runtime_body_in_2d_world_is_not_plane_locked():
    """R21: PhysicsWorld2D overrides insert_body only: a body inserted at
    runtime gets no plane lock (insert_body adds it to a 3D builder), and a
    2D collider inserted at runtime gives its body 3D mass properties."""
    import rapier_tpu.world2d as r2
    import rapier_tpu_torch.world2d as p2

    worlds = []
    for m in (r2, p2):
        w = m.PhysicsWorld2D(**({} if m is r2 else {"device": "cpu"}))
        g = w.insert_body(m.RigidBodyBuilder2D.fixed())
        w.insert_collider(m.ColliderBuilder2D.cuboid(10.0, 0.5), g)
        b = w.insert_body(m.RigidBodyBuilder.dynamic().with_translation((0.0, 2.0, 0.0)))
        w.insert_collider(m.ColliderBuilder2D.ball(0.5), b)
        w.build()
        h = w.insert_body_runtime(m.RigidBodyBuilder.dynamic().with_translation((2.0, 2.0, 0.0)))
        w.insert_collider_runtime(m.ColliderBuilder2D.ball(0.5), h)
        worlds.append((w, b, h))
    (rw, _, _), (pw, b, h) = worlds
    assert_worlds_equal(rw, pw, "2d runtime insert")
    bodies = pw.state.bodies
    assert int(bodies.locked_axes[0, h]) == 0 != int(bodies.locked_axes[0, b])
    assert float(bodies.inv_mass[0, h]) != float(bodies.inv_mass[0, b])


def test_reused_collider_slot_meets_the_old_contacts():
    """R19: the contact cache keeps a removed collider's lanes until the
    next step; a collider inserted into the freed slot before that reads
    them as its own contacts, in both packages."""
    ref, port = _modules()
    rw, rb, pw, pb = _both(_ball)
    pw.step(40)                          # the ball rests on the ground
    rw.state = _ref_state(pw.state)
    slot = 1
    assert len(pw.contact_pairs_with(slot)) == 1
    for m, w, b in ((ref, rw, rb), (port, pw, pb)):
        w.remove_collider_runtime(slot)
        h = w.insert_body_runtime(m.RigidBodyBuilder.dynamic().with_translation((9, 9, 0)))
        c = w.insert_collider_runtime(m.ColliderBuilder.ball(0.1), h)
        assert c.index == slot
    assert_worlds_equal(rw, pw, "reused collider slot")
    np.testing.assert_array_equal(pw.contact_pairs_with(slot), rw.contact_pairs_with(slot))
    assert len(pw.contact_pairs_with(slot)) == 1         # a ball far away, "touching"


def test_growth_puts_next_rot_into_rot_and_principal_frame():
    """R20: the reference grows the body table into `empty_bodies`' arrays,
    where rot, principal_frame and next_rot are one array: after growth the
    old rows of all three hold next_rot.  A turned box's principal frame
    (identity before) becomes its orientation, in both packages."""
    ref, port = _modules()

    def make(m, w):
        _ground(m, w)
        for i in range(7):
            b = w.insert_body(m.RigidBodyBuilder.dynamic()
                              .with_translation((2.0 * i, 3, 0)).with_rotation((0.0, 0.4, 0.3)))
            w.insert_collider(m.ColliderBuilder.cuboid(0.5, 0.2, 0.1), b)

    rw, _, pw, _ = _both(make)
    assert pw.state.bodies.n == 8                          # full
    bodies = pw.state.bodies
    bodies.next_rot[0, 2] = torch.tensor([0.0, 0.6, 0.0, 0.8])
    rw.state = rw.state.replace(bodies=rw.state.bodies.replace(
        next_rot=bodies.next_rot[0].numpy().copy()))
    frame_before = bodies.principal_frame[0].clone()
    for m, w in ((ref, rw), (port, pw)):
        w.insert_body_runtime(m.RigidBodyBuilder.dynamic())     # grows
    assert pw.state.bodies.n == 16
    assert_worlds_equal(rw, pw, "grown")
    grown = pw.state.bodies
    assert torch.equal(grown.principal_frame[0, :8], grown.next_rot[0, :8])
    assert torch.equal(grown.rot[0, :8], grown.next_rot[0, :8])
    assert not torch.equal(grown.principal_frame[0, 2], frame_before[2])


def test_apply_impulse_by_handle():
    """R22, not copied: the reference's apply_impulse indexes its device
    arrays with the handle itself, which JAX refuses; the port's takes a
    handle, with the reference's result by int."""
    ref, port = _modules()
    rw, _, pw, _ = _both(_ground)
    hr = rw.insert_body_runtime(ref.RigidBodyBuilder.dynamic())
    hp = pw.insert_body_runtime(port.RigidBodyBuilder.dynamic())
    rw.insert_collider_runtime(ref.ColliderBuilder.ball(0.5), hr)
    pw.insert_collider_runtime(port.ColliderBuilder.ball(0.5), hp)
    import jax.numpy as jnp

    rw.state = rw.state.replace(bodies=rw.state.bodies.replace(
        inv_mass=jnp.asarray(rw.state.bodies.inv_mass)))
    with pytest.raises(IndexError):
        rw.apply_impulse(hr, (1.0, 0.0, 0.0))
    rw.apply_impulse(hr.index, (1.0, 0.0, 0.0))
    pw.apply_impulse(hp, (1.0, 0.0, 0.0))
    np.testing.assert_array_equal(pw.body_linvel(hp), np.asarray(rw.state.bodies.linvel[hr.index]))


def test_collider_growth_rekeys_the_contact_cache(monkeypatch):
    """R25: pair keys are lo * C + hi (reference dispatch.py:571), so a
    collider growth changes every cached key whose lower collider is not 0:
    on the step after it the box-on-box lane matches no cached lane (its
    warmstart starts from zero), while the box-on-ground lane (lower
    collider 0) keeps its key and its match."""
    import rapier_tpu_torch.pipeline.physics_pipeline as pp

    _ref, port = _modules()
    match = pp._match_previous
    matched = {}

    def record(prev, man):
        out = match(prev, man)
        matched.update({(int(a), int(b)): bool(m) for a, b, m, v in zip(
            man.collider1[0].tolist(), man.collider2[0].tolist(), out[5][0].tolist(),
            man.valid[0].tolist()) if v})
        return out

    by_capacity = {}
    for extra in (5, 6):                         # 5 fill the free slots, the 6th grows
        w = _world(port)
        _ground(port, w)
        for y in (0.5, 1.5):
            b = w.insert_body(port.RigidBodyBuilder.dynamic().with_translation((0, y, 0)))
            w.insert_collider(port.ColliderBuilder.cuboid(0.5, 0.5, 0.5), b)
        w.build()
        w.step(40)                               # the boxes rest, their cache warm
        for _ in range(extra):
            w.insert_collider_runtime(port.ColliderBuilder.ball(0.1)._set(enabled=False))
        matched.clear()
        monkeypatch.setattr(pp, "_match_previous", record)
        w.step()
        monkeypatch.setattr(pp, "_match_previous", match)
        by_capacity[w.state.colliders.n] = dict(matched)
    kept, grown = by_capacity[8], by_capacity[16]
    assert kept[(0, 1)] and kept[(1, 2)]
    assert grown[(0, 1)] and not grown[(1, 2)]
