"""rapier_tpu_torch's controllers (control/character.py, control/pid.py,
control/vehicle.py) against rapier_tpu.control on the CPU.

`move_shape` runs the cases of tests/test_controllers.py (a free move, a
move blocked by a wall, a slide along it, the snap to ground, a step onto a
ledge) in one reference compile: the walled scene and the ledge scene share
their capacities and are vmapped with the cases, under options that turn on
autostep and the snap (so one compiled loop takes every branch).  The port
takes them as one batch of scenes.  `solve_character_collision_impulses`
runs on tests/test_controllers.py's push scene, `update_vehicle` once on
each ground kind (a halfspace and a cuboid), the PD and PID forces on
seeded bodies.

Tolerances: translations, forces and velocities 1e-5 relative (of each
quantity's largest magnitude), flags exact.  The moves come from shape
casts whose last bisection sample may fall either way within GJK's error
(tests/test_torch_queries_shapes.py): a move is held to the search's final
bracket, and the reference's own run from starts 1 ulp apart where it
differs.  The file keeps to 8 tests (tests/test_torch_queries.py says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu.control import character as jc
from rapier_tpu.control import pid as jpid
from rapier_tpu.control import vehicle as jv
from rapier_tpu.types import ShapeType
from rapier_tpu_torch.control import character as pc
from rapier_tpu_torch.control import pid as ppid
from rapier_tpu_torch.control import vehicle as pv
from rapier_tpu_torch.scenes import replicate_scene
from rapier_tpu_torch.types import from_numpy

CAPSULE = np.array([0.0, -0.4, 0.0, 0.0, 0.4, 0.0, 0.3] + [0.0] * 5, np.float32)
OPTIONS = dict(snap_to_ground=0.3, autostep_max_height=0.35, autostep_min_width=0.3)
# (scene, start, desired): tests/test_controllers.py's cases.
MOVES = {
    "free": (0, (0.0, 1.0, 0.0), (0.5, 0.0, 0.0)),
    "blocked": (0, (0.0, 1.0, 0.0), (5.0, 0.0, 0.0)),
    "slide": (0, (2.3, 1.0, 0.0), (1.0, 0.0, 1.0)),
    "snap": (0, (0.0, 0.8, 0.0), (0.2, 0.0, 0.0)),
    "fall": (0, (1.0, 1.6, 0.0), (0.1, -0.8, 0.2)),
    "ledge": (1, (0.0, 0.76, 0.0), (1.6, 0.0, 0.0)),
    "ledge_diagonal": (1, (0.0, 0.76, 0.4), (1.3, 0.0, 0.6)),
}


def _scenes():
    """The walled scene and the ledge scene (the same capacities), as one
    reference batch of numpy leaves."""
    from rapier_tpu.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    walled = PhysicsWorld()
    g = walled.insert_body(RigidBodyBuilder.fixed())
    walled.insert_collider(ColliderBuilder.halfspace((0, 1, 0)), g)
    wall = walled.insert_body(RigidBodyBuilder.fixed().with_translation((3, 1, 0)))
    walled.insert_collider(ColliderBuilder.cuboid(0.2, 2.0, 5.0), wall)
    ledge = PhysicsWorld()
    g = ledge.insert_body(RigidBodyBuilder.fixed().with_translation((0, -0.5, 0)))
    ledge.insert_collider(ColliderBuilder.cuboid(20, 0.5, 20), g)
    step = ledge.insert_body(RigidBodyBuilder.fixed().with_translation((2.0, 0.1, 0)))
    ledge.insert_collider(ColliderBuilder.cuboid(1.0, 0.1, 5.0), step)
    states = [walled.build(), ledge.build()]
    return jax.tree.map(lambda *x: np.stack(x), *states)


@functools.lru_cache(maxsize=None)
def move_results():
    """(the reference's moves and their start witnesses, the port's), one
    row a case."""
    both_np = _scenes()
    both = jax.tree.map(jnp.asarray, both_np)
    names = sorted(MOVES)
    sc = np.array([MOVES[n][0] for n in names])
    start = np.array([MOVES[n][1] for n in names], np.float32)
    want = np.array([MOVES[n][2] for n in names], np.float32)
    opts = jc.CharacterControllerOptions(**OPTIONS)

    @jax.jit
    def ref(start, want):
        def one(s_idx, p, d):
            b = jax.tree.map(lambda x: x[s_idx], both.bodies)
            c = jax.tree.map(lambda x: x[s_idx], both.colliders)
            return jc.move_shape(b, c, int(ShapeType.CAPSULE), jnp.asarray(CAPSULE), p,
                                 jnp.array([0.0, 0.0, 0.0, 1.0]), d, opts)
        return jax.vmap(one)(jnp.asarray(sc), start, want)

    r = jax.tree.map(np.asarray, ref(jnp.asarray(start), jnp.asarray(want)))
    batch = from_numpy(jax.tree.map(lambda x: x[sc], both_np))
    p = pc.move_shape(batch.bodies, batch.colliders, int(ShapeType.CAPSULE), CAPSULE,
                      torch.from_numpy(start), torch.tensor([0.0, 0.0, 0.0, 1.0]),
                      torch.from_numpy(want), pc.CharacterControllerOptions(**OPTIONS))
    keys = ("translation", "grounded", "hit_obstacle", "remaining")
    port = [getattr(p, k).numpy() for k in keys]
    bracket = 2 * (np.linalg.norm(want, axis=1) + opts.offset) / 8 / 2 ** 12
    tols = (np.maximum(tp.QUERY_TOL, bracket), 0, 0, np.maximum(tp.QUERY_TOL, bracket))
    bad = ~tp.rows_close(port, [getattr(r, k) for k in keys], tols)
    wit = tp.lazy_witnesses(ref, (start, want), r, bad)
    return names, keys, r, wit, port, tols


def test_move_shape_matches_reference():
    names, keys, r, wit, port, tols = move_results()
    for case in names:
        rows = np.array(names) == case
        tp.assert_rows_with_witnesses(port, [getattr(r, k) for k in keys],
                                      [[getattr(w, k) for k in keys] for w in wit], tols, case,
                                      mask=rows, share=0.0)


def test_moves_take_every_branch():
    """The cases reach what tests/test_controllers.py checks: blocked at the
    wall, a slide, grounded by the snap, a step onto the ledge."""
    names, _, r, _, _, _ = move_results()
    row = {n: i for i, n in enumerate(names)}
    assert r.hit_obstacle[row["blocked"]] and 2.3 < r.translation[row["blocked"], 0] < 2.52
    assert r.translation[row["slide"], 2] > 0.8
    assert r.grounded[row["snap"]] and r.translation[row["snap"], 1] < -0.05
    assert r.translation[row["ledge"], 1] > 0.1 and r.translation[row["ledge"], 0] > 1.2


def _push_world(package):
    import importlib

    w_mod = importlib.import_module(f"{package}.world")
    rb, cb = w_mod.RigidBodyBuilder, w_mod.ColliderBuilder
    w = w_mod.PhysicsWorld(**({"device": "cpu"} if package == "rapier_tpu_torch" else {}))
    g = w.insert_body(rb.fixed().with_translation((0, -1, 0)))
    w.insert_collider(cb.cuboid(20, 1, 20).with_friction(0.1), g)
    box = w.insert_body(rb.dynamic().with_translation((1.0, 0.4, 0.0))
                        .with_rotation((0.0, 0.3, 0.0)))
    w.insert_collider(cb.cuboid(0.4, 0.4, 0.4).with_friction(0.1), box)
    ball = w.insert_body(rb.dynamic().with_translation((0.35, 0.6, 0.65)))
    w.insert_collider(cb.ball(0.3), ball)
    w.build()
    return w


@pytest.mark.parametrize("mass", [80.0, 0.3])
def test_collision_impulses_match_reference(mass):
    """The push of test_character_pushes_dynamic_box, a second dynamic body
    (a ball) beside the box, at a heavy and a light character."""
    w = _push_world("rapier_tpu")
    s = w.state
    pos = np.array([0.33, 0.75, 0.0], np.float32)
    rem = np.array([0.31, 0.02, 0.05], np.float32)
    opts = jc.CharacterControllerOptions()
    ref = jc.solve_character_collision_impulses(
        s.bodies, s.colliders, int(ShapeType.CAPSULE), CAPSULE, pos,
        np.array([0.0, 0.0, 0.0, 1.0], np.float32), rem, 1.0 / 60.0, mass, opts)
    ps = from_numpy(replicate_scene(s, 1))
    got = pc.solve_character_collision_impulses(
        ps.bodies, ps.colliders, int(ShapeType.CAPSULE), CAPSULE, torch.from_numpy(pos),
        torch.tensor([0.0, 0.0, 0.0, 1.0]), torch.from_numpy(rem), 1.0 / 60.0, mass,
        pc.CharacterControllerOptions())
    for f in ("linvel", "angvel"):
        r = np.asarray(getattr(ref, f))
        assert np.abs(r).max() > 0.1
        tp.assert_close(getattr(got, f)[0], r, tp.QUERY_TOL * np.abs(r).max(), f)
    for f in ("sleeping", "sleep_timer"):
        tp.assert_equal(getattr(got, f)[0], getattr(ref, f), f)


def _seeded_bodies(seed):
    """A scene's bodies with seeded poses, velocities and masses (numpy)."""
    from rapier_tpu.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    rng = np.random.default_rng(seed)
    w = PhysicsWorld()
    for i in range(7):
        q = rng.normal(size=4)
        b = (RigidBodyBuilder.dynamic() if i % 3 else RigidBodyBuilder.fixed()).with_translation(
            tuple(rng.normal(size=3))).with_rotation(tuple(q / np.linalg.norm(q))).with_linvel(
            tuple(rng.normal(size=3))).with_angvel(tuple(rng.normal(size=3)))
        h = w.insert_body(b)
        w.insert_collider(ColliderBuilder.cuboid(*rng.uniform(0.2, 1.0, 3)), h)
    return w.build().bodies, rng


def test_pd_and_pid_match_reference():
    bodies, rng = _seeded_bodies(8)
    n = bodies.pos.shape[0]
    q = rng.normal(size=(n, 4))
    targets = [rng.normal(size=(n, 3)), q / np.linalg.norm(q, axis=1, keepdims=True),
               rng.normal(size=(n, 3)), rng.normal(size=(n, 3))]
    targets = [t.astype(np.float32) for t in targets]
    pb = from_numpy(replicate_scene(_wrap(bodies), 1)).bodies
    pt = [torch.from_numpy(t)[None] for t in targets]
    for axes in (jpid.AXES_ALL, jpid.AXES_LIN, 0b101010):
        gains = dict(lin_kp=30.0, lin_kd=10.0, ang_kp=20.0, ang_kd=4.0, axes=axes)
        rf, rt = jpid.pd_force_and_torque(jax.tree.map(jnp.asarray, bodies), *targets,
                                          jpid.PdGains(**gains))
        gf, gt = ppid.pd_force_and_torque(pb, *pt, ppid.PdGains(**gains))
        for g, r, what in ((gf, rf, "force"), (gt, rt, "torque")):
            r = np.asarray(r)
            tp.assert_close(g[0], r, tp.QUERY_TOL * max(1.0, np.abs(r).max()), what)
    zero = np.zeros((n, 3), np.float32)
    r_state = jpid.PidState(lin_integral=zero + 0.1, ang_integral=zero - 0.2)
    p_state = ppid.PidState(lin_integral=torch.from_numpy(zero + 0.1)[None],
                            ang_integral=torch.from_numpy(zero - 0.2)[None])
    for _ in range(3):
        rf, rt, r_state = jpid.pid_force_and_torque(
            jax.tree.map(jnp.asarray, bodies), r_state, *targets, 1.0 / 60.0, ki_lin=2.0,
            ki_ang=3.0)
        gf, gt, p_state = ppid.pid_force_and_torque(pb, p_state, *pt, 1.0 / 60.0, ki_lin=2.0,
                                                    ki_ang=3.0)
    for g, r, what in ((gf, rf, "force"), (gt, rt, "torque"),
                       (p_state.lin_integral, r_state.lin_integral, "integral")):
        r = np.asarray(r)
        tp.assert_close(g[0], r, tp.QUERY_TOL * max(1.0, np.abs(r).max()), what)


def _wrap(bodies):
    """A reference SceneState around `bodies` (the other parts empty)."""
    import rapier_tpu.types as jt

    n = bodies.pos.shape[0]
    return jt.SceneState(bodies=bodies, colliders=jt.empty_colliders(1),
                         contacts=jt.empty_contacts(128), step_count=np.int32(0))


@pytest.mark.parametrize("ground", ["halfspace", "cuboid"])
def test_update_vehicle_matches_reference(ground):
    """One update of a tilted, moving chassis over each ground kind, with
    steering, engine force on the rear wheels and brakes on the front."""
    from rapier_tpu.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld()
    if ground == "halfspace":
        g = w.insert_body(RigidBodyBuilder.fixed())
        w.insert_collider(ColliderBuilder.halfspace((0.05, 1, 0)).with_friction(1.0), g)
    else:
        g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -0.5, 0)))
        w.insert_collider(ColliderBuilder.cuboid(200, 0.5, 200).with_friction(1.0), g)
    chassis = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0.1, 0.5, 0.2))
                            .with_rotation((0.05, 0.3, -0.04)).with_linvel((0.4, -0.3, -1.2))
                            .with_angvel((0.1, 0.2, -0.3)))
    w.insert_collider(ColliderBuilder.cuboid(0.6, 0.2, 1.0).with_density(3.0), chassis)
    s = w.build()
    conns = [(-0.5, 0.0, -0.8), (0.5, 0.0, -0.8), (-0.5, 0.0, 0.8), (0.5, 0.0, 0.8)]
    controls = dict(engine_force=np.array([0.0, 0.0, 6.0, 6.0], np.float32),
                    brake=np.array([0.5, 0.5, 0.0, 0.0], np.float32),
                    steering=np.array([0.35, 0.3, 0.0, 0.0], np.float32))
    ref = jv.update_vehicle(jax.tree.map(jnp.asarray, s.bodies),
                            jax.tree.map(jnp.asarray, s.colliders), chassis,
                            jv.default_wheels(conns, radius=0.25, rest_length=0.3),
                            dt=1.0 / 60.0, **{k: jnp.asarray(v) for k, v in controls.items()})
    ps = from_numpy(replicate_scene(s, 1))
    got = pv.update_vehicle(ps.bodies, ps.colliders, chassis,
                            pv.default_wheels(conns, radius=0.25, rest_length=0.3,
                                              device="cpu"),
                            dt=1.0 / 60.0, **controls)
    assert np.asarray(ref.in_contact).sum() >= 3
    for f in ("in_contact", "ground_collider"):
        tp.assert_equal(getattr(got, f)[0], getattr(ref, f), f)
    for f in ("linvel", "angvel", "suspension_length"):
        r = np.asarray(getattr(ref, f))
        tp.assert_close(getattr(got, f)[0], r, tp.QUERY_TOL * max(1.0, np.abs(r).max()), f)
