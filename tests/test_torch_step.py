"""rapier_tpu_torch's batched step: bitwise reruns, the bench scene's build
against the reference's, `PhysicsWorld.step`, and the solve path's gate and
refusals.  The 20-step rollout against the reference's vmapped step is in
tests/test_torch_step_rollout.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu_torch.pipeline.physics_pipeline import step as port_step
from rapier_tpu_torch.types import FrictionModel, from_numpy


def test_two_runs_bitwise_equal():
    params = tp.port_params()
    runs = []
    for _ in range(2):
        s = from_numpy(tp.settled_batch())
        for _ in range(5):
            s, _ = port_step(s, params)
        runs.append(s)
    for part in ("bodies", "contacts"):
        a, b = getattr(runs[0], part), getattr(runs[1], part)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"{part}.{f.name}"


def test_build_matches_reference_for_bench_scene():
    from rapier_tpu.scenes import mixed_primitives_world as ref_world
    from rapier_tpu_torch.scenes import mixed_primitives_world as port_world

    rw = ref_world(num_layers=4, grid=5, max_pairs=512)
    pw = port_world(num_layers=4, grid=5, max_pairs=512, device="cpu")
    rs, ps = rw.build(), pw.build()
    assert pw.params.shape_types_present == rw.params.shape_types_present
    for part in ("bodies", "colliders", "contacts"):
        r, p = getattr(rs, part), getattr(ps, part)
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert a.dtype == d.dtype and np.array_equal(a, d), f"{part}.{f.name}"
    assert ps.bodies.pos.shape == (104, 3)   # 101 bodies padded to 104


def test_world_step_ball_comes_to_rest():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0.0, -1.0, 0.0)))
    w.insert_collider(ColliderBuilder.cuboid(50.0, 1.0, 50.0), g)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0.0, 2.0, 0.0)))
    w.insert_collider(ColliderBuilder.ball(0.5), b)
    w.step(240)
    y = float(w.body_translation(b)[1])
    assert abs(y - 0.5) < 0.01, y
    assert w.body_is_sleeping(b)
    assert int(w.last_events.unsupported_pairs.max()) == 0


def test_world_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for another
    device; building the world records the device without touching CUDA."""
    from rapier_tpu_torch.scenes import mixed_primitives_world, quadruped_world
    from rapier_tpu_torch.world import PhysicsWorld

    for w in (PhysicsWorld(), mixed_primitives_world(num_layers=1, grid=2),
              quadruped_world()[0]):
        assert w.device == torch.device("cuda")


def _empty_batch(n_bodies, max_pairs):
    from rapier_tpu_torch.scenes import replicate_scene
    from rapier_tpu_torch.types import (
        SceneState, empty_bodies, empty_colliders, empty_contacts)

    state = SceneState(bodies=empty_bodies(n_bodies), colliders=empty_colliders(8),
                       contacts=empty_contacts(max_pairs))
    return from_numpy(replicate_scene(state, 1))


def _reference_path(p_lanes, n_bodies, backend="auto"):
    """The reference's solve path for a contacts-only f32 scene
    (physics_pipeline.py:554-562, :664-667, as on its TPU)."""
    from rapier_tpu.dynamics.solver.pallas_sweep import vmem_feasible as ref_feasible
    from rapier_tpu.utils.routing import DENSE_ROUTE_ELEMS

    if backend != "jax" and ref_feasible(p_lanes, n_bodies + 1):
        return "kernel"
    return "blocked" if p_lanes * (n_bodies + 1) > DENSE_ROUTE_ELEMS else "masked"


def _steps_finite_on(path, state, params):
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path

    n, p_lanes = state.bodies.pos.shape[1], state.contacts.max_pairs
    assert solve_path(state, params) == path
    assert _reference_path(p_lanes, n, params.solver_backend) == path
    s, ev = port_step(state, params)
    for name in ("pos", "rot", "linvel", "angvel"):
        assert bool(torch.isfinite(getattr(s.bodies, name)).all()), name
    assert int(ev.solver_overflow.max()) == 0
    return s


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of large lane counts: with a thread per
    core in each of several test workers, the threads of each large op wait
    on one another (minutes instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_step_refuses_a_scene_over_the_kernel_limit(one_thread):
    """500 bodies with 2048 pair lanes need ~15 MB of the reference kernel's
    10 MiB: the scene steps on the masked sweep, as in the reference (the
    port refused it until the masked sweep was ported)."""
    from rapier_tpu_torch.dynamics.solver.contact_sweep import vmem_feasible
    from rapier_tpu_torch.types import SimParams

    assert not vmem_feasible(2048, 501)
    _steps_finite_on("masked", _empty_batch(500, 2048), SimParams())


def test_step_refuses_the_jax_backend():
    """solver_backend="jax" never takes the kernel: the parity batch steps on
    the masked sweep (formerly refused)."""
    s = _steps_finite_on("masked", from_numpy(tp.settled_batch()),
                         tp.port_params().replace(solver_backend="jax"))
    assert int(s.contacts.touching.sum()) > 0


def test_step_names_the_blocked_solve_above_the_routing_limit(one_thread):
    from rapier_tpu_torch.types import SimParams

    # 131072 lanes x 129 columns is above 2**24; the reference's own vmem
    # gate fails first and its blocked solve takes the scene.
    _steps_finite_on("blocked", _empty_batch(128, 131072), SimParams())


@pytest.mark.parametrize("change, what", [
    (dict(friction_model=int(FrictionModel.COULOMB)), "COULOMB"),
    (dict(block_solver_2x2=True), "2x2 block solver"),
    (dict(enable_ccd=True), "CCD"),
])
def test_step_refuses_what_is_not_ported(change, what):
    """CCD, the Coulomb model and the 2x2 block solve are ported.  The
    Coulomb model is refused on a contact cache built for the twist model
    (its tangent layout); the 2x2 block solve takes the masked sweep, not
    the kernel; a CCD scene (every body CCD-enabled) takes the reference's
    path for the scene, the kernel, and steps finitely."""
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path

    state, params = from_numpy(tp.settled_batch()), tp.port_params().replace(**change)
    if what != "COULOMB":
        if what == "CCD":
            state.bodies.ccd_enabled[:] = True
        assert solve_path(state, params) == ("masked" if what == "2x2 block solver"
                                             else "kernel")
        s, ev = port_step(state, params)
        assert bool(torch.isfinite(s.bodies.pos).all())
        assert int(ev.ccd_overflow.max()) == 0
        return
    with pytest.raises(ValueError, match="tangent layout"):
        port_step(state, params)


def test_step_refuses_f64():
    """A float64 batch never takes the kernel route, even under
    solver_backend="pallas" (the reference's gate, physics_pipeline.py:557):
    it steps on the masked sweep and stays float64."""
    from rapier_tpu_torch.pipeline.physics_pipeline import solve_path
    from rapier_tpu_torch.types import tree_map

    state = tree_map(lambda x: x.double() if x.is_floating_point() else x,
                     from_numpy(tp.settled_batch()))
    params = tp.port_params()
    assert params.solver_backend == "pallas"
    assert solve_path(state, params) == "masked"
    s, _ = port_step(state, params)
    assert s.bodies.pos.dtype == torch.float64 and bool(torch.isfinite(s.bodies.pos).all())


def test_parity_shape_takes_the_kernel_path():
    from rapier_tpu_torch.dynamics.solver.contact_sweep import vmem_feasible

    start = tp.settled_batch()
    n1 = np.shape(start.bodies.pos)[-2] + 1
    assert vmem_feasible(np.shape(start.contacts.pair_key)[-1], n1)
    s, ev = port_step(from_numpy(start), tp.port_params())
    assert bool(torch.isfinite(s.bodies.pos).all())
