"""rapier_tpu_torch's step on mesh scenes against the reference's, on the CPU.

The reference runs with solver_backend="pallas" (the TPU main path's
semantics; its Pallas kernel in interpret mode), the port's step on the same
numpy state.  heightfield3 (examples/heightfield3.py) in contact: its
bodies are set down just above the field and settled by the port, then both
packages take STEPS steps, the reference's step compiled for one scene.
Bodies within 1e-4 (positions, rotations) and 1e-3 (velocities), the
contact cache's impulses within 1e-3 of the step's largest, pair keys and
touching flags exact (lane order: the convex pair lanes, then the mesh
lanes).  The long resting runs of tests/test_mesh.py and
tests/test_example_scenes.py::test_trimesh3_ball_rests_on_mesh are marked
slow, as the reference's `test_mesh` module is.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu.pipeline.physics_pipeline import step as jax_step
from rapier_tpu_torch.pipeline.physics_pipeline import solve_path, step as port_step
from rapier_tpu_torch.types import from_numpy, to_numpy

SETTLE = 15      # port steps before the comparison: every body on the field
STEPS = 8
# The reference's step compiles in ~55 s at the scene's 4 substeps and ~30 s
# at 1 on a CPU, so the parity runs take 1 substep, as
# tests/test_torch_s2d_step.py's do; one scene unbatched (the reference's
# `PhysicsWorld.step`, its Pallas `_kernel`) traces and compiles in ~25 s,
# a vmapped batch in ~41 s.
SUBSTEPS = 1


def _field_height(verts, tris, x, z):
    """The triangulated field's height under (x, z), numpy."""
    for t in tris:
        a, b, c = verts[t].astype(np.float64)
        m = np.array([[b[0] - a[0], c[0] - a[0]], [b[2] - a[2], c[2] - a[2]]])
        u, w = np.linalg.solve(m, [x - a[0], z - a[2]])
        if u >= -1e-9 and w >= -1e-9 and u + w <= 1 + 1e-9:
            return a[1] + u * (b[1] - a[1]) + w * (c[1] - a[1])
    raise ValueError((x, z))


@functools.lru_cache(maxsize=None)
def start_scene():
    """(numpy state of one heightfield3 scene, with a leading scene axis of
    1, after SETTLE port steps; the reference's SimParams).  The bodies
    start 0.05 above the field where their lowest point lies, so they touch
    it within a few steps."""
    from rapier_tpu_torch.scenes import heightfield3_world, replicate_scene

    w, handles = heightfield3_world(device="cpu")
    w.params = w.params.replace(solver_backend="pallas", num_solver_iterations=SUBSTEPS)
    verts, tris = w._pending_colliders[0][0].mesh
    state = replicate_scene(w.build(), 1)
    for i, b in enumerate(handles["bodies"]):
        x, _, z = state.bodies.pos[0, b]
        y = _field_height(verts, tris, x, z) + (0.4, 0.35, 0.5)[i % 3] + 0.05
        for name in ("pos", "next_pos"):
            getattr(state.bodies, name)[0, b] = (x, y, z)
    ps = from_numpy(state)
    for _ in range(SETTLE):
        ps, _ = port_step(ps, w.params)
    return tp.to_reference(ps), tp.reference_params(w.params)


@functools.lru_cache(maxsize=None)
def rollouts():
    """STEPS steps of both packages from `start_scene()`: the reference's
    step on the scene unbatched, compiled with XLA's backend optimisations
    off (at the default level XLA:CPU miscompiles the vmapped
    `_triangle_sat`, and some cuboid lanes get a wrong SAT gap, ROADMAP R14;
    at level 0 they equal the float64 gap and the reference's own one-lane
    result); the port's on a batch of one.  Returns (the port's solve path,
    reference states, port states), numpy, each with the scene axis."""
    start, jparams = start_scene()
    js = jax.tree.map(lambda x: jnp.asarray(x[0]), start)
    compiled = jax.jit(jax_step).lower(js, jparams).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    ref = []
    for _ in range(STEPS):
        js, _ = compiled(js, jparams)
        ref.append(jax.tree.map(lambda x: np.asarray(x)[None], js))
    params = from_numpy(jparams)
    ps = from_numpy(start)
    path = solve_path(ps, params)
    port = []
    for _ in range(STEPS):
        ps, ev = port_step(ps, params)
        assert int(ev.solver_overflow.max()) == 0 and int(ev.broadphase_overflow.max()) == 0
        port.append(to_numpy(ps))
    return path, ref, port


def test_heightfield3_takes_the_kernel_path():
    """The reference's gate: a contacts-only mesh scene takes the contact
    kernel (K = 640 lanes: 128 pair lanes and 64 x 8 mesh lanes)."""
    start, jparams = start_scene()
    ps = from_numpy(start)
    assert ps.contacts.max_pairs == 640
    assert solve_path(ps, from_numpy(jparams)) == "kernel"


def test_heightfield3_steps_match_reference():
    path, ref, port = rollouts()
    assert path == "kernel"
    touching = tp.assert_trajectories_agree(ref, port)
    mesh_touching = min(int(np.sum(rs.contacts.touching[:, 128:])) for rs in ref)
    assert mesh_touching >= 10, mesh_touching   # most bodies on the field
    assert touching >= mesh_touching
    for t, (rs, ps) in enumerate(zip(ref, port)):
        tp.assert_contact_impulses_agree(rs, ps, f"step {t + 1}")


def test_heightfield3_contact_cache_lanes():
    """Lane by lane after the last step: colliders, bodies and feature ids
    of the active points exact; the geometry of the active points within
    1e-4 (capsule lanes carry the ternary search's spread, see
    tests/test_torch_mesh.py)."""
    _, ref, port = rollouts()
    rc, pc = ref[-1].contacts, port[-1].contacts
    for name in ("collider1", "collider2", "body1", "body2", "active", "num_points",
                 "point_active"):
        tp.assert_equal(getattr(pc, name), getattr(rc, name), f"contacts.{name}")
    act = np.asarray(rc.point_active)
    tp.assert_equal(np.asarray(pc.feature_id)[act], np.asarray(rc.feature_id)[act],
                    "contacts.feature_id")
    tp.assert_close(np.asarray(pc.dist)[act], np.asarray(rc.dist)[act], 1e-4, "contacts.dist")


def test_two_runs_bitwise_equal():
    start, jparams = start_scene()
    params = from_numpy(jparams)
    runs = []
    for _ in range(2):
        s = from_numpy(start)
        for _ in range(3):
            s, _ = port_step(s, params)
        runs.append(s)
    for part in ("bodies", "contacts"):
        a, b = getattr(runs[0], part), getattr(runs[1], part)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"{part}.{f.name}"


def test_mesh_pairs_past_the_cap_are_dropped_uncounted():
    """More (convex, mesh) pairs than max_mesh_pairs: the pairs past it get
    no lane and no event counts them (ROADMAP R12), as in the reference's
    compute_mesh_manifolds (tests/test_torch_mesh.py holds the two to each
    other): of two balls over a flat quad, the second falls through it."""
    from rapier_tpu_torch.world import ColliderBuilder, RigidBodyBuilder

    w = _world()
    w.params = w.params.replace(max_mesh_pairs=1)
    g = w.insert_body(RigidBodyBuilder.fixed())
    verts = [(-10.0, 0.0, -10.0), (10.0, 0.0, -10.0), (10.0, 0.0, 10.0), (-10.0, 0.0, 10.0)]
    w.insert_collider(ColliderBuilder.trimesh(verts, [(0, 2, 1), (0, 3, 2)]), g)
    balls = [w.insert(RigidBodyBuilder.dynamic().with_translation((x, 0.52, 0.0)),
                      ColliderBuilder.ball(0.5)) for x in (-2.0, 2.0)]
    w.build()
    for _ in range(30):
        w.step()
        assert int(w.last_events.unsupported_pairs.max()) == 0
        assert int(w.last_events.broadphase_overflow.max()) == 0
    y = [float(w.body_translation(b)[1]) for b in balls]
    assert abs(y[0] - 0.5) < 2e-2 and y[1] < -0.5, y


# ---------------------------------------------------------------------------
# The long resting runs (tests/test_mesh.py, tests/test_example_scenes.py)
# ---------------------------------------------------------------------------


def _world():
    from rapier_tpu_torch.world import PhysicsWorld

    return PhysicsWorld(device="cpu")


def _flat_quad_world(collider, at):
    from rapier_tpu_torch.world import ColliderBuilder, RigidBodyBuilder

    w = _world()
    g = w.insert_body(RigidBodyBuilder.fixed())
    verts = [(-10.0, 0.0, -10.0), (10.0, 0.0, -10.0), (10.0, 0.0, 10.0), (-10.0, 0.0, 10.0)]
    w.insert_collider(ColliderBuilder.trimesh(verts, [(0, 2, 1), (0, 3, 2)]), g)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation(at))
    w.insert_collider(collider, b)
    w.build()
    return w, b


@pytest.mark.slow
def test_ball_rests_on_trimesh():
    from rapier_tpu_torch.world import ColliderBuilder

    w, b = _flat_quad_world(ColliderBuilder.ball(0.5), (0.5, 2, 0.3))
    w.step(240)
    p = w.body_translation(b)
    assert abs(p[1] - 0.5) < 2e-2, p


@pytest.mark.slow
def test_box_rests_on_trimesh():
    from rapier_tpu_torch.world import ColliderBuilder

    w, b = _flat_quad_world(ColliderBuilder.cuboid(0.5, 0.5, 0.5).with_friction(0.6),
                            (0.0, 2, 0.0))
    w.step(300)
    p = w.body_translation(b)
    assert abs(p[1] - 0.5) < 3e-2, p
    assert abs(p[0]) < 0.1 and abs(p[2]) < 0.1


@pytest.mark.slow
def test_capsule_rests_on_trimesh():
    from rapier_tpu_torch.world import ColliderBuilder

    w, b = _flat_quad_world(ColliderBuilder.capsule_x(0.5, 0.25), (0.2, 2, 0.1))
    w.step(300)
    p = w.body_translation(b)
    assert abs(p[1] - 0.25) < 3e-2, p


@pytest.mark.slow
def test_heightfield_slope_and_valley():
    from rapier_tpu_torch.world import ColliderBuilder, RigidBodyBuilder

    w = _world()
    g = w.insert_body(RigidBodyBuilder.fixed())
    nr = nc = 9
    heights = np.zeros((nr, nc))
    for c in range(nc):
        heights[:, c] = abs(c - nc // 2) / (nc // 2)
    w.insert_collider(ColliderBuilder.heightfield(heights, (16.0, 2.0, 16.0)), g)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((3.0, 3.0, 0.0)))
    w.insert_collider(ColliderBuilder.ball(0.5), b)
    w.build()
    w.step(420)
    p = w.body_translation(b)
    assert np.isfinite(p).all()
    assert abs(p[0]) < 3.0
    assert p[1] > 0.2


@pytest.mark.slow
def test_trimesh3_ball_rests_on_mesh():
    from rapier_tpu_torch.scenes import trimesh3_world

    w, h = trimesh3_world(device="cpu")
    w.build()
    w.step(400)
    p = w.body_translation(h["ball"])
    assert np.isfinite(p).all()
    assert 0.2 < p[1] < 0.6, p
    assert abs(p[0]) < 0.6, p


@pytest.mark.slow
def test_heightfield3_example_checks():
    """examples/heightfield3.py's own checks after its 300 steps."""
    from rapier_tpu_torch.scenes import heightfield3_world

    w, h = heightfield3_world(device="cpu")
    w.build()
    w.step(300)
    ys = np.array([w.body_translation(b)[1] for b in h["bodies"]])
    assert np.isfinite(ys).all()
    assert (ys > -2.5).all() and (ys < 3.0).all(), ys
