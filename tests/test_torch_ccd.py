"""rapier_tpu_torch.dynamics.ccd.clamp_motions against the reference's, on
the CPU.

Each case is built by the reference's PhysicsWorld at one capacity (48
bodies and colliders) and stepped by the port; the bodies that reach CCD in
each step (their predicted `next_pos` / `next_rot` before the clamp) are
captured, and both packages clamp them: the port's `clamp_motions`, the
reference's `_clamp_pass` (its `clamp_motions` runs it
`max_ccd_substeps` times in a Python loop and sums the overflow; here the
same loop drives one jitted pass).  The reference's pass traces and
compiles in ~2 minutes on a CPU (33 unrolled GJK calls), so every case
shares ONE compile: equal capacities, and a mesh table of one shape in
every state (a scene without a mesh collider has no mesh candidate, so the
table does not change its result; the port gets None there, as its step
gives it).  The compile runs with XLA's backend optimisations off, as
tests/test_torch_mesh_step.py's does: at the default level XLA:CPU
miscompiles the vmapped `_triangle_sat` that the mesh lanes call (ROADMAP
R14).

Held: the clamped positions within 1e-5 plus one bisection interval of the
body's motion (16**-1 * 2**-16 of its displacement), the rotations within
1e-5 plus that interval of the rotation's change, each body's time of
impact (its clamped fraction of the motion) within 1e-5 plus one interval,
which bodies are clamped, and the overflow counts exactly.  A body past
these is on a rounding tie (a coarse sample whose distance lies at 0 within
rounding, which XLA's multiply-add contraction, ROADMAP R1b, can put on
the other side): it is held to the reference run from the start with that
body's position 1 ulp higher or lower in x, which must itself part from
the reference's result.
"""

from __future__ import annotations

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rapier_tpu.types as jt
import test_torch_common as tp
from rapier_tpu.dynamics import ccd as ref_ccd
from rapier_tpu.world import ColliderBuilder as RCB
from rapier_tpu.world import PhysicsWorld as RWorld
from rapier_tpu.world import RigidBodyBuilder as RRB
from rapier_tpu_torch.dynamics import ccd as port_ccd
from rapier_tpu_torch.pipeline import physics_pipeline as pp
from rapier_tpu_torch.types import from_numpy, to_numpy

CAP = dict(body_capacity=48, collider_capacity=48)
MESH_SLOTS = 8                   # vertex and triangle rows of every mesh table
POS_TOL = 1e-5
INTERVAL = 1.0 / 16 / 2**16      # one bisection interval, a fraction of the step


def _ccd(builder, on=True):
    builder.ccd_enabled = on
    return builder


def _wall(w, x=0.0, half=0.1):
    g = w.insert_body(RRB.fixed().with_translation((x, 0.0, 0.0)))
    w.insert_collider(RCB.cuboid(half, 5, 5), g)


def _case_wall():
    """tests/test_ccd.py's wall ball: 100 m/s at a 0.2-thick wall."""
    w = RWorld(gravity=(0, 0, 0), **CAP)
    _wall(w)
    b = w.insert_body(_ccd(RRB.dynamic().with_translation((-5, 0, 0)).with_linvel((100, 0, 0))))
    w.insert_collider(RCB.ball(0.5), b)
    return w, 6


def _case_ccd3():
    """tests/test_ccd.py's ccd3 flavour: a density-10 ball at 1000 m/s
    through two walls of four boxes."""
    w = RWorld(**CAP)
    g = w.insert_body(RRB.fixed().with_translation((0, -0.1, 0)))
    w.insert_collider(RCB.cuboid(200.0, 0.1, 10.0), g)
    for wall_x in (20.0, 30.0):
        for iy in range(4):
            b = w.insert_body(RRB.dynamic().with_translation((wall_x, 0.5 + iy, 0.0)))
            w.insert_collider(RCB.cuboid(0.5, 0.5, 1.0), b)
    ball = w.insert_body(_ccd(RRB.dynamic().with_translation((0.0, 2.0, 0.0))
                              .with_linvel((1000.0, 0.0, 0.0))))
    w.insert_collider(RCB.ball(0.5).with_density(10.0), ball)
    return w, 10


def _case_trimesh():
    """tests/test_ccd.py's trimesh quad: 100 m/s at a two-triangle wall."""
    w = RWorld(gravity=(0, 0, 0), **CAP)
    wall = w.insert_body(RRB.fixed())
    verts = [(0, -5, -5), (0, 5, -5), (0, 5, 5), (0, -5, 5)]
    w.insert_collider(RCB.trimesh(verts, [(0, 1, 2), (0, 2, 3)]), wall)
    b = w.insert_body(_ccd(RRB.dynamic().with_translation((-5, 0, 0)).with_linvel((100, 0, 0))))
    w.insert_collider(RCB.ball(0.5), b)
    return w, 6


def _case_rod():
    """tests/test_ccd.py's spinning rod: half a turn a step, its tip through
    a thin wall between the step's two poses."""
    w = RWorld(gravity=(0, 0, 0), **CAP)
    wall = w.insert_body(RRB.fixed().with_translation((0.65, 0.0, 0.0)))
    w.insert_collider(RCB.cuboid(0.05, 3.0, 3.0), wall)
    rb = RRB.dynamic().with_linvel((3.0, 0.0, 0.0))
    rb = rb._set(angvel=(0.0, 0.0, float(np.pi * 60.0)))
    rb = rb.with_rotation((0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)))
    rod = w.insert_body(_ccd(rb))
    w.insert_collider(RCB.capsule_x(0.5, 0.1), rod)
    return w, 3


SHELL = 18                        # tied obstacles around the shell ball


def _case_fairness():
    """The caps.  (a) A CCD ball of radius 0.3 at the origin, at 6 m/s
    along +x (0.1 a step: the coarse samples do not step over the small
    obstacles), among SHELL balls of radius 0.05 on a shell of radius 0.36
    about it in its forward half, 0.01 from touching: all of them overlap
    its start box, so their entry times tie at 0, and the per-collider cap
    keeps the first 16 in collider order.  The one it would hit first (the
    least distance from its path) is the last inserted, so it is dropped in
    both packages.  (b) 8 CCD balls in a row at z = 5 at 900 m/s through 17
    small cubes: 24 candidates each (the cubes and the other balls), 16
    kept.  9 x 16 = 144 > 128: the scene's last 16 (row-major) are dropped
    too."""
    w = RWorld(gravity=(0, 0, 0), **CAP)
    ball = w.insert_body(_ccd(RRB.dynamic().with_linvel((6.0, 0.0, 0.0))))
    w.insert_collider(RCB.ball(0.3), ball)
    shell = w.insert_body(RRB.fixed())
    # Off-axis distances, the last the least (the first hit); from 0.09 up
    # each centre lies within 0.35 ahead, so the start boxes overlap.
    radii = np.linspace(0.30, 0.09, SHELL)
    for k, r in enumerate(radii):
        phi = 2.0 * np.pi * k / SHELL
        x = float(np.sqrt(0.36 ** 2 - r ** 2))
        w.insert_collider(RCB.ball(0.05).with_translation(
            (x, float(r * np.cos(phi)), float(r * np.sin(phi)))), shell)
    for j in range(8):
        b = w.insert_body(_ccd(RRB.dynamic().with_translation((-10.0 - 0.7 * j, 0.0, 5.0))
                               .with_linvel((900.0, 0.0, 0.0))))
        w.insert_collider(RCB.ball(0.3), b)
    cubes = w.insert_body(RRB.fixed())
    for k in range(17):
        w.insert_collider(RCB.cuboid(0.1, 0.1, 0.1).with_translation(
            (-8.6 + 0.5 * k, 0.0, 5.0)), cubes)
    return w, 1


def _case_halfspace():
    """A ball and a tilted cuboid, both CCD, falling at 600 m/s onto a
    halfspace (its plane distance branch)."""
    w = RWorld(gravity=(0, 0, 0), **CAP)
    g = w.insert_body(RRB.fixed())
    w.insert_collider(RCB.halfspace((0.1, 1.0, 0.0)), g)
    b = w.insert_body(_ccd(RRB.dynamic().with_translation((0, 6.0, 0)).with_linvel(
        (0.0, -600.0, 0.0))))
    w.insert_collider(RCB.ball(0.5), b)
    c = w.insert_body(_ccd(RRB.dynamic().with_translation((3.0, 7.0, 0)).with_linvel(
        (0.0, -600.0, 0.0)).with_rotation((0.3, 0.2, 0.1))))
    w.insert_collider(RCB.cuboid(0.5, 0.3, 0.4), c)
    return w, 2


HULL_WALL_FACE = -0.05


def _case_hull():
    """A unit-cube convex hull, CCD, at 100 m/s at a thin wall whose face
    is at x = HULL_WALL_FACE (ROADMAP R17)."""
    w = RWorld(gravity=(0, 0, 0), **CAP)
    g = w.insert_body(RRB.fixed())
    w.insert_collider(RCB.cuboid(0.05, 5, 5), g)
    b = w.insert_body(_ccd(RRB.dynamic().with_translation((-3.0, 0, 0)).with_linvel(
        (100.0, 0, 0))))
    w.insert_collider(RCB.convex_hull(
        [(x, y, z) for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]), b)
    return w, 2


CASES = {"wall": _case_wall, "ccd3_flavour": _case_ccd3, "trimesh": _case_trimesh,
         "rod": _case_rod, "fairness": _case_fairness, "halfspace": _case_halfspace,
         "hull": _case_hull}


def _mesh_table(state):
    """The state's mesh table padded to MESH_SLOTS rows, or an empty one."""
    if state.meshes is None:
        return jt.empty_meshes(MESH_SLOTS, MESH_SLOTS)
    v, t = np.asarray(state.meshes.vertices), np.asarray(state.meshes.triangles)
    assert v.shape[-2] <= MESH_SLOTS and t.shape[-2] <= MESH_SLOTS
    return jt.MeshData(vertices=np.pad(v, ((0, MESH_SLOTS - len(v)), (0, 0))),
                       triangles=np.pad(t, ((0, MESH_SLOTS - len(t)), (0, 0)),
                                        constant_values=-1))


@functools.lru_cache(maxsize=None)
def captures(name, substeps: int = 1):
    """(the port's params, [(port state of one scene whose bodies are the
    clamp's input, its mesh table for the reference)]): every step of the
    case's run on the port."""
    from rapier_tpu.scenes import replicate_scene

    w, steps = CASES[name]()
    state = w.build()
    params = from_numpy(w.params).replace(max_ccd_substeps=substeps)
    assert params.enable_ccd
    meshes = _mesh_table(state)
    now = from_numpy(replicate_scene(state, 1))
    seen = []
    original = pp.clamp_motions

    def spy(bodies, colliders, p, m):
        seen.append(to_numpy(dataclasses.replace(now, bodies=bodies)))
        return original(bodies, colliders, p, m)

    with mock.patch.object(pp, "clamp_motions", spy):
        for _ in range(steps):
            now, ev = pp.step(now, params)
            assert int(ev.broadphase_overflow.max()) == 0
    return params, [(x, meshes) for x in seen]


@functools.lru_cache(maxsize=None)
def _reference_pass():
    """The reference's clamp pass, jitted once for every case's shape
    (`_clamp_pass` reads only params.length_unit), backend optimisations
    off (R14)."""
    params = jt.SimParams()
    w, _ = _case_trimesh()
    state = w.build()
    args = (jax.tree.map(jnp.asarray, state.bodies), jax.tree.map(jnp.asarray, state.colliders),
            jax.tree.map(jnp.asarray, _mesh_table(state)))
    return jax.jit(lambda b, c, m: ref_ccd._clamp_pass(b, c, params, m)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def reference_clamp(state, meshes, substeps: int):
    """The reference's clamp_motions on one port state (numpy, scene axis
    of 1): (next_pos, next_rot, overflow)."""
    ref = tp.to_reference(state)
    bodies = jax.tree.map(lambda x: jnp.asarray(x[0]), ref.bodies)
    colliders = jax.tree.map(lambda x: jnp.asarray(x[0]), ref.colliders)
    m = jax.tree.map(jnp.asarray, meshes)
    total = 0
    for _ in range(max(1, substeps)):
        bodies, ovf = _reference_pass()(bodies, colliders, m)
        total += int(ovf)
    return np.asarray(bodies.next_pos), np.asarray(bodies.next_rot), total


def port_clamp(state, params):
    s = from_numpy(state)
    bodies, ovf = port_ccd.clamp_motions(s.bodies, s.colliders, params, s.meshes)
    return bodies.next_pos[0].numpy(), bodies.next_rot[0].numpy(), int(ovf[0])


def _nudged(state, body, direction):
    """`state` with body's x (position and prediction) 1 ulp further along
    `direction`."""
    b = state.bodies
    pos, nxt = np.array(b.pos), np.array(b.next_pos)
    for a in (pos, nxt):
        a[0, body, 0] = np.nextafter(a[0, body, 0], np.float32(direction * np.inf))
    return dataclasses.replace(state, bodies=dataclasses.replace(b, pos=pos, next_pos=nxt))


def _verdict(state, params, meshes):
    """(bodies clamped by the port, worst position gap in units of the
    tolerance, overflow (port, reference)); asserts the clamp agrees with the
    reference or, body by body, with a 1-ulp witness."""
    b = state.bodies
    pos, nxt0, rot = b.pos[0], b.next_pos[0], b.rot[0]
    p_pos, p_rot, p_ovf = port_clamp(state, params)
    r_pos, r_rot, r_ovf = reference_clamp(state, meshes, params.max_ccd_substeps)
    disp = np.linalg.norm(nxt0 - pos, axis=-1)
    r1 = b.next_rot[0]
    r1 = np.where(np.sum(rot * r1, -1, keepdims=True) < 0, -r1, r1)
    tol_p = POS_TOL + INTERVAL * disp
    tol_r = POS_TOL + INTERVAL * np.linalg.norm(r1 - rot, axis=-1)

    def toi(x):
        return np.where(disp > 0, np.sum((x - pos) * (nxt0 - pos), -1)
                        / np.maximum(disp * disp, 1e-30), 1.0)

    def gaps(pp_, pr_, rp_, rr_):
        return np.maximum.reduce([np.abs(pp_ - rp_).max(-1) / tol_p,
                                  np.abs(pr_ - rr_).max(-1) / tol_r,
                                  np.abs(toi(pp_) - toi(rp_)) / (POS_TOL + INTERVAL)])

    g = gaps(p_pos, p_rot, r_pos, r_rot)
    for body in np.flatnonzero(g > 1.0):
        witnesses = []
        for d in (1, -1):
            w_pos, w_rot, _ = reference_clamp(_nudged(state, body, d), meshes,
                                              params.max_ccd_substeps)
            witnesses.append((gaps(p_pos, p_rot, w_pos, w_rot)[body],
                              gaps(w_pos, w_rot, r_pos, r_rot)[body]))
        ok = [port_gap <= 1.0 and tie_gap > 1.0 for port_gap, tie_gap in witnesses]
        assert any(ok), (f"body {body}: clamp {p_pos[body]} vs the reference's {r_pos[body]} "
                         f"(gap {g[body]:.2f} tolerances; 1-ulp witnesses {witnesses})")
    clamped_p = np.any(p_pos != nxt0, -1)
    clamped_r = np.any(r_pos != nxt0, -1)
    assert np.array_equal(clamped_p, clamped_r), (np.flatnonzero(clamped_p),
                                                  np.flatnonzero(clamped_r))
    assert p_ovf == r_ovf, (p_ovf, r_ovf)
    return clamped_p, float(np.max(g, initial=0.0)), p_ovf


@pytest.mark.parametrize("name", ["wall", "ccd3_flavour", "trimesh", "rod", "halfspace"])
def test_clamp_matches_reference(name):
    params, caps = captures(name)
    clamped_steps = 0
    for state, meshes in caps:
        clamped, worst, ovf = _verdict(state, params, meshes)
        clamped_steps += bool(clamped.any())
        assert ovf == 0
    print(f"{name}: {len(caps)} steps, {clamped_steps} clamped")
    assert clamped_steps >= 1


def test_fairness_caps_and_entry_ties():
    """The per-collider cap with 18 entry-time ties (the stable order drops
    the two last inserted, among them the first obstacle on the path), and
    the scene's cap of 128: 2 + 8 x 8 row drops and 144 - 128 global."""
    params, caps = captures("fairness")
    state, meshes = caps[0]
    clamped, _, ovf = _verdict(state, params, meshes)
    assert ovf == 2 + 8 * 8 + (9 * 16 - 128)
    assert clamped[0]                           # the shell ball hits a kept obstacle


def test_two_substeps():
    """max_ccd_substeps = 2: the second pass re-sweeps the motions the
    first clamped; the overflow sums over both."""
    params, caps = captures("fairness", substeps=2)
    assert params.max_ccd_substeps == 2
    state, meshes = caps[0]
    _, _, ovf = _verdict(state, params, meshes)
    assert ovf > 2 + 8 * 8 + (9 * 16 - 128)


def test_hull_sweeps_as_its_centre_plus_border():
    """ROADMAP R17: the reference's CCD distance passes no hull table, so a
    CONVEX collider's support is its origin: the unit-cube hull is clamped
    when its centre, not its face, reaches the wall, in both packages."""
    params, caps = captures("hull")
    hits = []
    for state, meshes in caps:
        clamped, _, _ = _verdict(state, params, meshes)
        if clamped.any():
            hits.append(port_clamp(state, params)[0][1, 0])
    assert hits and abs(hits[0] - HULL_WALL_FACE) < 1e-3, hits
