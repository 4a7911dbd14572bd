"""rapier_tpu_torch's step with CCD against the reference's, on the CPU.

The parity runs: the four scenes of tests/test_ccd.py (the wall ball, the
ccd3 flavour, the trimesh quad, the spinning rod) and `scenes.ccd3_world`
cut to 2 walls of 3-high pyramids.  The reference's step with CCD traces
and compiles in ~3 minutes on a CPU (its CCD pass alone ~2), so every scene
shares ONE compile: 16 bodies, 16 colliders, 192 pair lanes, the same
static parameters (1 solver substep, solver_backend="pallas", 8 mesh pairs,
one shape census for all) and a mesh table of one shape in every state (a
scene without a mesh collider has no mesh pair, so the table does not
change it).  The compile runs with XLA's backend optimisations off
(ROADMAP R14: at the default level XLA:CPU miscompiles the mesh lanes'
vmapped `_triangle_sat`).  Each step of the port starts from the
reference's state of the step before (a free run parts on rounding ties,
ROADMAP R1b, and a 1000 m/s ball amplifies them); bodies within 1e-4 in
position and rotation and 1e-3 relative to the scene's fastest body in
velocity, the pair keys and touching flags exact, and `ccd_overflow`
equal, at every step.  tests/test_ccd.py's scenarios on the port alone are
in tests/test_torch_ccd_scenarios.py.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rapier_tpu.types as jt
import test_torch_common as tp
from rapier_tpu.pipeline.physics_pipeline import step as jax_step
from rapier_tpu.world import ColliderBuilder as RCB
from rapier_tpu.world import PhysicsWorld as RWorld
from rapier_tpu.world import RigidBodyBuilder as RRB
from rapier_tpu_torch.pipeline.physics_pipeline import solve_path, step as port_step
from rapier_tpu_torch.types import ShapeType, from_numpy, to_numpy

CAP = dict(body_capacity=16, collider_capacity=16, max_pairs=192)
MESH_SLOTS = 8
CENSUS = tuple((int(t), 16) for t in sorted((ShapeType.BALL, ShapeType.CUBOID,
                                            ShapeType.CAPSULE, ShapeType.TRIMESH)))
POS_TOL, VEL_TOL = 1e-4, 1e-3


def _params(gravity):
    return jt.SimParams(gravity=np.asarray(gravity, np.float32), enable_ccd=True,
                        num_solver_iterations=1, solver_backend="pallas", max_mesh_pairs=8,
                        shape_types_present=CENSUS)


def _ball_at_wall(mesh: bool):
    w = RWorld(gravity=(0, 0, 0), **CAP)
    g = w.insert_body(RRB.fixed())
    if mesh:
        verts = [(0, -5, -5), (0, 5, -5), (0, 5, 5), (0, -5, 5)]
        w.insert_collider(RCB.trimesh(verts, [(0, 1, 2), (0, 2, 3)]), g)
    else:
        w.insert_collider(RCB.cuboid(0.1, 5, 5), g)
    bb = RRB.dynamic().with_translation((-5, 0, 0)).with_linvel((100, 0, 0))
    bb.ccd_enabled = True
    w.insert_collider(RCB.ball(0.5), w.insert_body(bb))
    return w, (0, 0, 0)


def _ccd3_flavour():
    w = RWorld(**CAP)
    g = w.insert_body(RRB.fixed().with_translation((0, -0.1, 0)))
    w.insert_collider(RCB.cuboid(200.0, 0.1, 10.0), g)
    for wall_x in (20.0, 30.0):
        for iy in range(4):
            b = w.insert_body(RRB.dynamic().with_translation((wall_x, 0.5 + iy, 0.0)))
            w.insert_collider(RCB.cuboid(0.5, 0.5, 1.0), b)
    bb = RRB.dynamic().with_translation((0.0, 2.0, 0.0)).with_linvel((1000.0, 0.0, 0.0))
    bb.ccd_enabled = True
    w.insert_collider(RCB.ball(0.5).with_density(10.0), w.insert_body(bb))
    return w, (0.0, -9.81, 0.0)


def _rod():
    w = RWorld(gravity=(0, 0, 0), **CAP)
    wall = w.insert_body(RRB.fixed().with_translation((0.65, 0.0, 0.0)))
    w.insert_collider(RCB.cuboid(0.05, 3.0, 3.0), wall)
    rb = RRB.dynamic().with_linvel((3.0, 0.0, 0.0))._set(angvel=(0.0, 0.0, float(np.pi * 60)))
    rb = rb.with_rotation((0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)))
    rb.ccd_enabled = True
    w.insert_collider(RCB.capsule_x(0.5, 0.1), w.insert_body(rb))
    return w, (0, 0, 0)


def _with_mesh_table(state):
    if state.meshes is not None:
        assert np.shape(state.meshes.triangles)[-2] == MESH_SLOTS
        return state
    return dataclasses.replace(state, meshes=jt.empty_meshes(MESH_SLOTS, MESH_SLOTS))


def _reduced_ccd3():
    """`scenes.ccd3_world` at 2 walls of 3-high pyramids, built by the port,
    as a reference state."""
    from rapier_tpu_torch.scenes import ccd3_world, replicate_scene

    w, _ = ccd3_world(walls=2, rows=3, device="cpu", **CAP)
    state = tp.to_reference(replicate_scene(w.build(), 1))
    return jax.tree.map(lambda x: np.asarray(x)[0], state), (0.0, -9.81, 0.0)


SCENES = {"wall": (lambda: _ball_at_wall(False), 6),
          "ccd3_flavour": (_ccd3_flavour, 10),
          "trimesh": (lambda: _ball_at_wall(True), 6),
          "rod": (_rod, 3),
          "ccd3_world": (_reduced_ccd3, 12)}


def start(name):
    make, _ = SCENES[name]
    built = make()
    if name == "ccd3_world":
        state, gravity = built
    else:
        w, gravity = built
        state = w.build()
    return _with_mesh_table(state), _params(gravity)


@functools.lru_cache(maxsize=None)
def _compiled():
    state, params = start("trimesh")
    js = jax.tree.map(jnp.asarray, state)
    return jax.jit(jax_step).lower(js, params).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def runs(name):
    """The reference's run of the scene and, at each step, the port's step
    from the reference's state before it: ([reference (state, events)],
    [port (state, events)], the port's solve path), numpy with a scene axis
    of 1."""
    from rapier_tpu.scenes import replicate_scene

    state, jparams = start(name)
    params = from_numpy(jparams)
    js = jax.tree.map(jnp.asarray, state)
    ref, port = [], []
    path = solve_path(from_numpy(replicate_scene(state, 1)), params)
    for _ in range(SCENES[name][1]):
        before = replicate_scene(jax.tree.map(np.asarray, js), 1)
        ps, pev = port_step(from_numpy(before), params)
        port.append((to_numpy(ps), pev))
        js, jev = _compiled()(js, jparams)
        ref.append((replicate_scene(jax.tree.map(np.asarray, js), 1), jev))
    return ref, port, path


@pytest.mark.parametrize("name", list(SCENES))
def test_ccd_steps_match_reference(name):
    ref, port, path = runs(name)
    assert path == "kernel"
    for k, ((rs, rev), (ps, pev)) in enumerate(zip(ref, port)):
        rb, pb = rs.bodies, ps.bodies
        tp.assert_close(pb.pos, rb.pos, POS_TOL, f"{name} step {k} pos")
        tp.assert_close(pb.rot, rb.rot, POS_TOL, f"{name} step {k} rot")
        scale = max(1.0, float(np.abs(rb.linvel).max()))
        tp.assert_close(pb.linvel, rb.linvel, VEL_TOL * scale, f"{name} step {k} linvel")
        tp.assert_close(pb.angvel, rb.angvel, VEL_TOL * max(1.0, float(np.abs(rb.angvel).max())),
                        f"{name} step {k} angvel")
        tp.assert_equal(ps.contacts.pair_key, rs.contacts.pair_key, f"{name} step {k} keys")
        tp.assert_equal(ps.contacts.touching, rs.contacts.touching, f"{name} step {k} touching")
        assert int(pev.ccd_overflow[0]) == int(rev.ccd_overflow), (name, k)


def test_parity_runs_exercise_the_clamp():
    """Without CCD the port's step from the same states parts from the
    reference's by more than 0.1 in some body's position or rotation in
    every run: the clamp decides these steps."""
    from rapier_tpu.scenes import replicate_scene

    for name in SCENES:
        ref, _, _ = runs(name)
        state, jparams = start(name)
        params = from_numpy(jparams).replace(enable_ccd=False)
        gaps = []
        before = replicate_scene(state, 1)
        for rs, _ in ref:
            ps, _ = port_step(from_numpy(before), params)
            free = to_numpy(ps).bodies
            gaps.append(max(float(np.abs(free.pos - rs.bodies.pos).max()),
                            float(np.abs(free.rot - rs.bodies.rot).max())))
            before = rs
        assert max(gaps) > 0.1, (name, gaps)
