"""rapier_tpu_torch's step on generic convex scenes against the reference's,
on the CPU.

The reference runs with solver_backend="pallas" (the TPU main path's
semantics; its Pallas kernel in interpret mode), compiled for one scene with
XLA's backend optimisations off (at the default level XLA:CPU miscompiles
the vmapped triangle SAT, ROADMAP R14, and the step vmaps GJK/EPA over the
pair lanes the same way); the port steps a batch of one from the same numpy
state.  Two scenes:

- a small primitives3 (`scenes.primitives3_world(5, 2)`: 20 bodies, one
  j % 5 cycle of capsules, balls, round cylinders and cones), stepped by the
  port for P3_SETTLE steps, until its layers have fallen onto each other;
- the convex zoo (`scenes.convex_zoo_world`: a cylinder, round cuboid,
  round cone, hull, compound cross, voxel run and cone on a ground cuboid,
  and a round cylinder on a halfspace ramp), settled for ZOO_SETTLE.

Then STEPS steps of both: pair keys and touching flags exact, positions and
rotations within 1e-4, velocities within 1e-3, the contact cache's impulses
within 1e-3 of the step's largest (test_torch_common).  The windows are
short and chosen without ties (R1b, R16): GJK/EPA's support ties and XLA's
FMAs part a free run of a pile eventually.  From other starts the runs part
at a tie within 8 steps: primitives3 from step 50 by 5.7e-4 at step 7,
where the reference started 1 ulp higher in every body parts from itself by
5.2e-3; the zoo from step 10 by 5.7e-3 at step 6, where that witness parts
by 5.7e-3; the zoo from step 30 by 4.0e-2 at step 7: there EPA on the
cylinder's cap against the ground's face returns a depth of 0.306 in the
port and in the reference's `contact_support_maps` called on that lane
alone (float64: 0.035), while the reference's compiled step rounds its way
to 0.025 (ROADMAP R16).  The zoo scene is also built with the reference's own builders and
must equal the port's build.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_common as tp
from rapier_tpu.pipeline.physics_pipeline import step as jax_step
from rapier_tpu_torch.pipeline.physics_pipeline import solve_path, step as port_step
from rapier_tpu_torch.types import from_numpy, to_numpy

P3_SETTLE = 100
ZOO_SETTLE = 15
STEPS = 6
# One substep keeps the reference's compile short, as in
# tests/test_torch_mesh_step.py.
SUBSTEPS = 1


def _zoo_reference_world():
    """`scenes.convex_zoo_world` with the reference's builders."""
    import rapier_tpu.world as rw
    from rapier_tpu_torch.scenes import CUBE_POINTS

    cb, rb = rw.ColliderBuilder, rw.RigidBodyBuilder
    w = rw.PhysicsWorld()
    g = w.insert_body(rb.fixed().with_translation((0.0, -1.0, 0.0)))
    w.insert_collider(cb.cuboid(20.0, 1.0, 20.0), g)
    r = w.insert_body(rb.fixed().with_translation((-10.0, 0.0, 0.0)))
    w.insert_collider(cb.halfspace((0.3, 1.0, 0.0)), r)
    n = np.array([0.3, 1.0, 0.0]) / np.hypot(0.3, 1.0)
    on_ramp = np.array([-13.0, 0.9, 0.0]) + n * 0.35
    ident = (0.0, 0.0, 0.0, 1.0)
    for name, (x, y, z), c in (
            ("cylinder", (0.0, 0.5, 0.0), cb.cylinder(0.5, 0.5)),
            ("round_cuboid", (2.0, 0.4, 0.0), cb.round_cuboid(0.4, 0.3, 0.4, 0.1)),
            ("round_cone", (4.0, 0.55, 0.0), cb.round_cone(0.5, 0.5, 0.05)),
            ("hull", (0.0, 0.5, 3.0), cb.convex_hull(CUBE_POINTS)),
            ("cross", (3.0, 0.2, 3.0), cb.compound([
                ((0.0, 0.0, 0.0), ident, cb.cuboid(0.8, 0.2, 0.2)),
                ((0.0, 0.0, 0.0), ident, cb.cuboid(0.2, 0.2, 0.8))])),
            ("voxels", (-2.0, 0.25, 6.0), cb.voxels([(i * 0.5, 0.0, 0.0) for i in range(4)], 0.5)),
            ("cone", (-3.0, 0.5, 0.0), cb.cone(0.5, 0.5)),
            ("on_ramp", tuple(on_ramp), cb.round_cylinder(0.3, 0.5, 0.05))):
        body = rb.dynamic().with_translation((x, y + 0.02, z))
        if name == "on_ramp":
            body = body.with_rotation((0.0, 0.0, -float(np.arctan(0.3))))
        w.insert_collider(c, w.insert_body(body))
    return w


def test_zoo_builds_as_the_reference_builds_it():
    from rapier_tpu_torch.scenes import convex_zoo_world

    ps = convex_zoo_world(device="cpu")[0].build()
    rs = _zoo_reference_world().build()
    for part in ("bodies", "colliders", "hulls"):
        p, r = getattr(ps, part), getattr(rs, part)
        for name in vars(p):
            a, d = np.asarray(getattr(p, name)), np.asarray(getattr(r, name))
            if np.issubdtype(d.dtype, np.floating):
                np.testing.assert_allclose(a, d, rtol=1e-6, atol=1e-7, err_msg=f"{part}.{name}")
            else:
                assert np.array_equal(a.astype(np.int64), d.astype(np.int64)), f"{part}.{name}"


@functools.lru_cache(maxsize=None)
def start_scene(which):
    """(numpy state of one scene with a leading scene axis of 1 after the
    port's settling steps, the reference's SimParams)."""
    from rapier_tpu_torch.scenes import convex_zoo_world, primitives3_world, replicate_scene

    if which == "primitives3":
        w, _ = primitives3_world(5, 2, device="cpu")
        settle = P3_SETTLE
    else:
        w, _ = convex_zoo_world(device="cpu")
        settle = ZOO_SETTLE
    w.params = w.params.replace(solver_backend="pallas", num_solver_iterations=SUBSTEPS)
    ps = from_numpy(replicate_scene(w.build(), 1))
    for _ in range(settle):
        ps, _ = port_step(ps, w.params)
    return tp.to_reference(ps), tp.reference_params(w.params)


@functools.lru_cache(maxsize=None)
def rollouts(which):
    start, jparams = start_scene(which)
    js = jax.tree.map(lambda x: jnp.asarray(x[0]), start)
    compiled = jax.jit(jax_step).lower(js, jparams).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    ref = []
    for _ in range(STEPS):
        js, ev = compiled(js, jparams)
        assert int(ev.unsupported_pairs) == 0
        ref.append(jax.tree.map(lambda x: np.asarray(x)[None], js))
    params = from_numpy(jparams)
    ps = from_numpy(start)
    path = solve_path(ps, params)
    port = []
    for _ in range(STEPS):
        ps, ev = port_step(ps, params)
        assert int(ev.solver_overflow.max()) == 0 and int(ev.broadphase_overflow.max()) == 0
        assert int(ev.unsupported_pairs.max()) == 0
        port.append(to_numpy(ps))
    return path, ref, port


@pytest.mark.parametrize("which", ["primitives3", "zoo"])
def test_steps_match_reference(which):
    path, ref, port = rollouts(which)
    assert path == "kernel"
    touching = tp.assert_trajectories_agree(ref, port)
    # In contact at every step: the small pile still tumbles at step 100
    # (1-8 m/s at one substep), so a few of its pairs touch at a time.
    assert touching >= (4 if which == "primitives3" else 8), touching
    for t, (rs, ps) in enumerate(zip(ref, port)):
        tp.assert_contact_impulses_agree(rs, ps, f"{which} step {t + 1}")


def test_hull_table_rides_along():
    """The hull table passes through the step unchanged, in both packages."""
    start, _ = start_scene("zoo")
    _, ref, port = rollouts("zoo")
    for rs, ps in zip(ref, port):
        assert np.array_equal(ps.hulls.vertices, np.asarray(start.hulls.vertices))
        assert np.array_equal(np.asarray(rs.hulls.vertices), np.asarray(start.hulls.vertices))


# ---------------------------------------------------------------------------
# ROADMAP R2: s2d_arch
# ---------------------------------------------------------------------------

ARCH_STEPS = 300


def _arch_world(mod2d, **kw):
    """tests/test_s2d.py::test_s2d_arch's scene (examples2d/s2d_arch.rs): 17
    convex voussoirs (2D polygons) and 4 boxes on the keystone, on a ground
    cuboid; built with the 2D world module `mod2d`.  Returns (world,
    voussoir handles, the keystone, the top box)."""
    ps1 = np.array([[16.0, 0.0], [14.93803712795643, 5.133601056842984],
                    [13.79871746027416, 10.24928069555078], [12.56252963284711, 15.34107019122473],
                    [11.20040987372525, 20.39856541571217], [9.66521217819836, 25.40369899225096],
                    [7.87179930638133, 30.3179337000085], [5.635199558196225, 35.03820717801641],
                    [2.405937953536585, 39.09554102558315]]) * 0.25
    ps2 = np.array([[24.0, 0.0], [22.33619528222415, 6.02299846205841],
                    [20.54936888969905, 12.00964361211476], [18.60854610798073, 17.9470321677465],
                    [16.46769273811807, 23.81367936585418], [14.05325025774858, 29.57079353071012],
                    [11.23551045834022, 35.13775818285372], [7.752568160730571, 40.30450679009583],
                    [3.016931552701656, 44.28891593799322]]) * 0.25
    friction = 0.6
    rb, cb = mod2d.RigidBodyBuilder2D, mod2d.ColliderBuilder2D
    w = mod2d.PhysicsWorld2D(**kw)
    ground = w.insert_body(rb.fixed().with_translation((0, -1)))
    w.insert_collider(cb.cuboid(100.0, 1.0).with_friction(friction), ground)
    voussoirs = []
    polys = [[ps1[i], ps2[i], ps2[i + 1], ps1[i + 1]] for i in range(8)]
    polys += [[(-ps2[i][0], ps2[i][1]), (-ps1[i][0], ps1[i][1]),
               (-ps1[i + 1][0], ps1[i + 1][1]), (-ps2[i + 1][0], ps2[i + 1][1])] for i in range(8)]
    polys.append([ps1[8], ps2[8], (-ps1[8][0], ps1[8][1]), (-ps2[8][0], ps2[8][1])])
    for pts in polys:
        b = w.insert_body(rb.dynamic())
        w.insert_collider(cb.convex_hull(pts).with_friction(friction), b)
        voussoirs.append(b)
    stack = []
    for i in range(4):
        b = w.insert_body(rb.dynamic().with_translation((0.0, 0.5 + ps2[8][1] + 1.0 * i)))
        w.insert_collider(cb.cuboid(2.0, 0.5).with_friction(friction), b)
        stack.append(b)
    return w, voussoirs, voussoirs[-1], stack[-1]


@pytest.mark.slow
def test_arch_fails_its_check_as_the_reference_does():
    """R2: the reference marks s2d_arch xfail (every voussoir within 0.15 of
    its start after 300 steps fails: the arch spreads).  The port, built
    the same way, fails the same check: its worst voussoir drift is past
    0.15 as the reference's is, and both worlds build the same polygon mass
    properties.  ~3 minutes on a CPU (300 steps of each package), hence
    slow."""
    import rapier_tpu.world2d as rw2
    import rapier_tpu_torch.world2d as pw2

    drifts = []
    for mod, kw in ((rw2, {}), (pw2, {"device": "cpu"})):
        w, vs, _, _ = _arch_world(mod, **kw)
        w.build()
        start = {b: np.asarray(w.body_translation2(b)).copy() for b in vs}
        w.step(ARCH_STEPS)
        drifts.append(max(float(np.linalg.norm(np.asarray(w.body_translation2(b)) - start[b]))
                          for b in vs))
    ref_drift, port_drift = drifts
    assert ref_drift >= 0.15, ref_drift
    assert port_drift >= 0.15, port_drift
