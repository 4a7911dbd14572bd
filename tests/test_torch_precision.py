"""The f64 axis (`rapier_tpu_torch.precision`) against the reference's.

Tolerances:
- f64 parity (`test_torch_common.f64_compare`): at each step, every
  compared field of the port within F64_WITNESS_FACTOR (16) times the
  largest gap of the reference's own 1-ulp witness (the reference at f64
  from the same state with one body's height 1 ulp higher) at that step,
  or F64_ULPS (64) float64 ulps of the field's largest
  magnitude (of the largest contact impulse, for the impulses), whichever
  is larger.  The witness gaps here are ~1e-16 to
  ~1e-6 (the far pyramid's landing amplifies them), far below float32's
  1e-4.
- Built states: the port's build at f64 equals the reference's bit for bit
  (both round their inputs through float32 where ROADMAP R31 says).
- Dtypes: every floating leaf of the state and of StepEvents is float64
  after a step of each scene family at f64.

The reference runs at f64 in a subprocess (`test_torch_common.reference_f64`):
its `set_precision("f64")` turns on jax_enable_x64 for the whole process.
"""

import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu_torch import precision
from rapier_tpu_torch.pipeline.physics_pipeline import solve_path, step
from rapier_tpu_torch.types import from_numpy

BENCH_SETTLE = 45      # the bottom layer lands after ~38 steps
BENCH_STEPS = 10
FAR_SETTLE = 30        # the bottom row lands at ~21 steps
FAR_STEPS = 9          # at step 10 a z-twin point-order tie (R11) parts the piles
BENCH_BUILD = ("from rapier_tpu.scenes import mixed_primitives_world\n"
               "world = mixed_primitives_world(2, 3, max_pairs=512)\n"
               "world.params = world.params.replace(max_solver_pairs=256)\n")


@pytest.fixture
def f64():
    """The f64 axis for one test, always restored."""
    precision.set_precision("f64")
    try:
        yield
    finally:
        precision.set_precision("f32")


def _families():
    from rapier_tpu_torch import scenes

    return dict(
        bench=lambda: scenes.mixed_primitives_world(2, 3, max_pairs=128, device="cpu"),
        pyramid=lambda: scenes.pyramid3_world(stack_height=3, device="cpu"),
        stack=lambda: scenes.stack_world(3, device="cpu"),
        quadruped=lambda: scenes.quadruped_world(device="cpu"),
        quadruped_impulse=lambda: scenes.quadruped_world(use_multibody=False, device="cpu"),
        joints3=lambda: scenes.joints3_world(device="cpu"),
        s2d_far_pyramid=lambda: scenes.s2d_far_pyramid_world(device="cpu"),
        s2d_coulomb_stack=lambda: scenes.s2d_coulomb_stack_world(device="cpu"),
        heightfield3=lambda: scenes.heightfield3_world(device="cpu"),
        trimesh3=lambda: scenes.trimesh3_world(device="cpu"),
        primitives3=lambda: scenes.primitives3_world(2, 2, device="cpu"),
        convex_zoo=lambda: scenes.convex_zoo_world(device="cpu"),
        ccd3=lambda: scenes.ccd3_world(device="cpu"),
        multibody_arm=lambda: scenes.multibody_arm_world(coupled=True, device="cpu"),
        one_way_platforms3=lambda: scenes.one_way_platforms3_world(device="cpu"),
        vehicle=lambda: scenes.vehicle_world(device="cpu"),
        character=lambda: scenes.character_world(device="cpu"),
        urdf_pendulum=lambda: scenes.urdf_pendulum_world(device="cpu"),
    )


def _float_leaves(state):
    import dataclasses

    out = {}
    for part in ("bodies", "colliders", "contacts", "joints", "multibodies", "meshes",
                 "hulls"):
        p = getattr(state, part)
        if p is None:
            continue
        for f in dataclasses.fields(p):
            v = getattr(p, f.name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                out[f"{part}.{f.name}"] = v.dtype
    return out


def test_every_scene_family_steps_at_f64(f64):
    """Each scene family built at f64 takes the solve route its float32
    build takes (the contact-sweep kernel's float64 build where the float32
    one would run) and steps once on the CPU with every floating leaf of the
    state and of the events float64."""
    for name, make in _families().items():
        precision.set_precision("f32")
        r32 = make()
        w32 = r32[0] if isinstance(r32, tuple) else r32
        w32.build()
        precision.set_precision("f64")
        r = make()
        w = r[0] if isinstance(r, tuple) else r
        w.build()
        assert w.params.dt.dtype == np.float64, name
        assert solve_path(w.state, w.params) == solve_path(w32.state, w32.params), name
        w.step(1)
        bad = {k: v for k, v in _float_leaves(w.state).items() if v != torch.float64}
        bad.update({f"events.{k}": v.dtype for k, v in w.last_events._asdict().items()
                    if v.is_floating_point() and v.dtype != torch.float64})
        assert not bad, (name, bad)
        assert bool(torch.isfinite(w.state.bodies.pos).all()), name


def test_the_gate_routes_f64_off_the_kernel(f64):
    """solve_path: an f64 scene takes the route a float32 scene of its
    shapes takes, at every backend and size rule (the kernel's float64
    build where the float32 kernel would run), except off the kernel where
    the float64 body table and fixed words do not fit a block's shared
    memory: such a scene keeps the masked solve.  A float32 world built
    before the switch keeps stepping at float32."""
    import dataclasses

    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.dynamics.solver import contact_sweep as cs
    from rapier_tpu_torch.scenes import replicate_scene
    from rapier_tpu_torch.types import empty_scene, tree_map

    start = tp.settled_batch()
    s32 = from_numpy(start)
    s64 = tree_map(lambda x: x.double() if x.is_floating_point() else x, s32)
    assert s64.bodies.pos.dtype == torch.float64
    base = tp.port_params()
    for backend in ("auto", "pallas", "jax"):
        params = base.replace(solver_backend=backend)
        assert solve_path(s32, params) == ("masked" if backend == "jax" else "kernel")
        assert solve_path(s64, params) == solve_path(s32, params), backend
    limit = pp.DENSE_ROUTE_ELEMS
    try:
        pp.DENSE_ROUTE_ELEMS = 0
        for backend in ("auto", "pallas", "jax"):
            params = base.replace(solver_backend=backend)
            assert solve_path(s32, params) == ("blocked" if backend == "jax" else "kernel")
            assert solve_path(s64, params) == solve_path(s32, params), backend
    finally:
        pp.DENSE_ROUTE_ELEMS = limit
    # 1,199 bodies at K = 256: the float32 tables fit a block, the float64
    # ones do not.
    n1, k = 1200, 256
    assert cs.kernel_fits(k, n1, base.max_colors) and not cs.kernel_fits(k, n1, base.max_colors,
                                                                         f64=True)
    params = base.replace(max_solver_pairs=0)
    wide = {}
    for kind in ("f32", "f64"):
        precision.set_precision(kind)
        wide[kind] = from_numpy(replicate_scene(empty_scene(n1 - 1, 8, k), 1))
    assert wide["f64"].bodies.pos.dtype == torch.float64
    assert solve_path(wide["f32"], params) == "kernel"
    assert solve_path(wide["f64"], params) == "masked"
    # A float32 world built before the switch keeps stepping at float32.
    precision.set_precision("f32")
    from rapier_tpu_torch.scenes import stack_world

    w = stack_world(2, device="cpu")
    w.build()
    precision.set_precision("f64")
    w.step(2)
    assert w.state.bodies.pos.dtype == torch.float32
    assert all(v == torch.float32 for v in _float_leaves(w.state).values())
    assert dataclasses.replace(w.params).dt.dtype == np.float32


def test_precision_module():
    assert not precision.is_f64() and precision.FLOAT == torch.float32
    precision.set_precision("f64")
    try:
        assert precision.is_f64() and precision.FLOAT == torch.float64
        assert precision.NP_FLOAT is np.float64
        from rapier_tpu_torch.types import SimParams, empty_bodies

        p = SimParams()
        assert p.dt.dtype == np.float64 and p.gravity.dtype == np.float64
        assert p.inv_dt().dtype == np.float64 and p.prediction_distance().dtype == np.float64
        assert empty_bodies(8).pos.dtype == np.float64
    finally:
        precision.set_precision("f32")
    assert SimParams().dt.dtype == np.float32
    with pytest.raises(ValueError):
        precision.set_precision("f16")


def test_world_api_and_queries_at_f64(f64, tmp_path):
    """The world's runtime API and the queries at f64: runtime inserts past
    the capacity (growth), a snapshot and a restore, a save and a load, the
    NaN guard's rollback, the query methods and a character move; every
    floating leaf and every query result float64."""
    from rapier_tpu_torch.geometry import queries
    from rapier_tpu_torch.scenes import character_world
    from rapier_tpu_torch.types import ShapeType
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w, _ = character_world(device="cpu")
    w.nan_policy, w.nan_check_every = "rollback", 1
    w.build()
    w.step(2)
    cap = w.state.bodies.pos.shape[1]
    for i in range(cap - w.n_bodies + 1):
        h = w.insert_body_runtime(RigidBodyBuilder.dynamic().with_translation((i, 6.0, 2.0)))
        w.insert_collider_runtime(ColliderBuilder.ball(0.2), h)
    assert w.state.bodies.pos.shape[1] > cap
    snap = w.snapshot()
    w.step(2)
    w.restore(snap)
    w.save_snapshot(str(tmp_path / "s.npz"))
    w.load_snapshot(str(tmp_path / "s.npz"))
    w.step(1)
    before = w.state.bodies.pos.clone()
    w.set_linvel(h, (float("nan"), 0.0, 0.0))
    w.step(1)
    assert w.nan_rollbacks == 1 and torch.equal(w.state.bodies.pos, before)
    results = [w.cast_ray((0.0, 5.0, 0.0), (0.0, -1.0, 0.0)),
               w.project_point((0.3, 2.0, 0.1)),
               w.cast_shape(ShapeType.BALL, [0.3], (0, 5, 0), (0, 0, 0, 1), (0, -1, 0), 10.0),
               w.cast_shape_nonlinear(ShapeType.CUBOID, [0.3, 0.3, 0.3], (0, 5, 0),
                                      (0, 0, 0, 1), (0, -1, 0), (0, 1, 0), 10.0),
               w.move_character(ShapeType.CAPSULE, [0, -0.3, 0, 0, 0.3, 0, 0.2], (0, 1, 0),
                                (0, 0, 0, 1), (0.1, -0.05, 0), character_mass=10.0)]
    s = w.state
    rays = queries.cast_ray(s.bodies, s.colliders, torch.tensor([[[1.0, 5.0, 0.0]]]),
                            torch.tensor([[[0.0, -1.0, 0.0]]]))
    for r in results + [rays]:
        for x in r:
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                assert x.dtype == torch.float64, r
    w.step(1)
    assert all(v == torch.float64 for v in _float_leaves(w.state).values())


def test_bench_matches_the_reference_at_f64(f64, tmp_path):
    """The bench scene at 2 layers of 3 x 3 (the bench's max_pairs 512 and
    max_solver_pairs 256): the port's kernel route at f64 (on the CPU its
    plain version, with the masked route's float32 lane routing, R31)
    against the reference's masked route at f64.  Built at f64 as the
    reference builds it, settled 45 steps by the port, then 10 steps in
    both packages."""
    from rapier_tpu_torch.scenes import mixed_primitives_world, replicate_scene

    w = mixed_primitives_world(2, 3, max_pairs=512, device="cpu")
    w.params = w.params.replace(max_solver_pairs=256)
    built = w.build()
    state = from_numpy(replicate_scene(built, 1))
    for _ in range(BENCH_SETTLE):
        state, _ = step(state, w.params)
    assert int(state.contacts.touching.sum()) >= 9
    out = tp.reference_f64(tmp_path, state=state, params=w.params, steps=BENCH_STEPS,
                           witness=(0, 1, 1), build=BENCH_BUILD)
    for k, v in out["built"].items():
        part, f = k.split(".")
        mine = np.asarray(getattr(getattr(built, part), f))
        assert mine.dtype == v.dtype and np.array_equal(mine, v), k
    for k, v in out["built_params"].items():
        if hasattr(w.params, k):
            assert np.array_equal(np.asarray(getattr(w.params, k)), v), k
    assert solve_path(state, w.params) == "kernel"
    port, _ = tp.port_f64_rollout(state, w.params, BENCH_STEPS)
    tp.f64_compare(out["reference"], port, out["witness"], tp.F64_FIELDS, "bench")


def test_far_pyramid_matches_the_reference_at_f64(f64, tmp_path):
    """Upstream's far pyramid (55 boxes at (1e5, -8e4), the 2x2 block solve)
    at f64: settled 30 steps by the port, the rows landing, then 9 steps in
    both packages."""
    from rapier_tpu_torch.scenes import replicate_scene, s2d_far_pyramid_world

    w, _ = s2d_far_pyramid_world(device="cpu")
    state = from_numpy(replicate_scene(w.build(), 1))
    for _ in range(FAR_SETTLE):
        state, _ = step(state, w.params)
    out = tp.reference_f64(tmp_path, state=state, params=w.params, steps=FAR_STEPS,
                           witness=(0, 1, 1))
    port, _ = tp.port_f64_rollout(state, w.params, FAR_STEPS)
    tp.f64_compare(out["reference"], port, out["witness"], tp.F64_FIELDS, "far pyramid")
    assert int(np.sum(out["reference"][-1]["contacts.touching"])) > 0


def test_empty_scene_at_both_precisions(monkeypatch):
    """`types.empty_scene` against the reference's: the same leaves, shapes
    and dtypes at f32 and f64 (the reference's constructors read its
    precision module's NP_FLOAT, set here without its x64 switch)."""
    import dataclasses

    import rapier_tpu.precision as jprec
    import rapier_tpu.types as jt
    from rapier_tpu_torch import types as pt

    for kind, npf in (("f32", np.float32), ("f64", np.float64)):
        monkeypatch.setattr(jprec, "NP_FLOAT", npf)
        precision.set_precision(kind)
        try:
            mine, ref = pt.empty_scene(16, 24, 128), jt.empty_scene(16, 24, 128)
        finally:
            precision.set_precision("f32")
        for part in ("bodies", "colliders", "contacts"):
            for f in dataclasses.fields(getattr(ref, part)):
                r = np.asarray(getattr(getattr(ref, part), f.name))
                m = np.asarray(getattr(getattr(mine, part), f.name))
                assert m.shape == r.shape and m.dtype == r.dtype, (kind, part, f.name)
                assert np.array_equal(m, r), (kind, part, f.name)
        assert mine.joints is None and mine.meshes is None and mine.hulls is None
