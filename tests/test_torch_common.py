"""Shared inputs for the rapier_tpu_torch parity tests (tests/test_torch_*.py);
this module holds no tests of its own.

Every parity test uses ONE scene shape, so the JAX step compiles for a single
shape: `mixed_primitives_world(num_layers=3, grid=3, max_pairs=256)` with
`max_solver_pairs=128`, batched over B = 2 scenes whose dynamic bodies are
shifted apart by seeded numpy noise in scene 1.  `settled_batch()` advances
that batch with the port until the bodies touch down, so the geometry
and solver tests see real manifolds.  States cross between the packages as
numpy leaves.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np

B = 2
# The bottom layer lands after ~38 steps: at 40, 18 pairs touch.  The 20
# steps after it stay free of threshold ties (a contact point at the
# capsule-cuboid dedup distance or the prediction distance), which longer
# free runs meet: XLA contracts multiply-adds into FMAs, so the reference
# rounds differently from the port and such a tie can fall either way.
SETTLE_STEPS = 40
MAX_SOLVER_PAIRS = 128


@functools.lru_cache(maxsize=None)
def jax_world():
    """(reference SceneState with numpy leaves, reference SimParams)."""
    from rapier_tpu.scenes import mixed_primitives_world

    w = mixed_primitives_world(num_layers=3, grid=3, max_pairs=256)
    w.params = w.params.replace(max_solver_pairs=MAX_SOLVER_PAIRS,
                                solver_backend="pallas")
    return w.build(), w.params


def port_params():
    from rapier_tpu_torch.types import from_numpy

    return from_numpy(jax_world()[1])


def initial_batch():
    """The reference's batched numpy state; scene 1 perturbed."""
    from rapier_tpu.scenes import replicate_scene

    state, _ = jax_world()
    batch = replicate_scene(state, B)
    rng = np.random.default_rng(1234)
    dyn = np.asarray(state.bodies.body_type) == 0
    noise = rng.normal(0.0, 0.05, (int(dyn.sum()), 3)).astype(np.float32)
    for name in ("pos", "next_pos"):
        arr = getattr(batch.bodies, name)
        arr[1, dyn] += noise
    return batch


def to_reference(state):
    """A port state (numpy or tensor leaves; with or without joints) as a
    reference SceneState with numpy leaves of the reference's dtypes."""
    import rapier_tpu.types as jt
    from rapier_tpu_torch.types import to_numpy

    np_state = to_numpy(state)
    parts = {}
    for name, cls, empty in (("bodies", jt.Bodies, jt.empty_bodies),
                             ("colliders", jt.Colliders, jt.empty_colliders),
                             ("contacts", jt.Contacts, jt.empty_contacts),
                             ("joints", jt.Joints, jt.empty_joints)):
        part = getattr(np_state, name)
        if part is None:
            continue
        dtypes = empty(1)
        parts[name] = cls(**{
            f.name: np.asarray(getattr(part, f.name)).astype(
                np.asarray(getattr(dtypes, f.name)).dtype)
            for f in dataclasses.fields(cls)
        })
    return jt.SceneState(step_count=np.asarray(np_state.step_count, np.int32),
                         **parts)


def reference_params(params):
    """The port's SimParams as the reference's (the port's own fields,
    such as joint_slots, dropped)."""
    import rapier_tpu.types as jt

    return jt.SimParams(**{f.name: getattr(params, f.name)
                           for f in dataclasses.fields(jt.SimParams) if hasattr(params, f.name)})


@functools.lru_cache(maxsize=None)
def settled_batch(steps: int = SETTLE_STEPS):
    """The batch after `steps` port steps: bodies in contact, a warm contact
    cache.  Returned as a reference SceneState with numpy leaves."""
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.types import from_numpy

    params = port_params()
    state = from_numpy(initial_batch())
    for _ in range(steps):
        state, _ = step(state, params)
    return to_reference(state)


def assert_equal(actual, desired, what, mask=None):
    a, d = np.asarray(actual), np.asarray(desired)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    if mask is not None:
        a, d = a[mask], d[mask]
    bad = np.flatnonzero(a.astype(np.int64) != d.astype(np.int64))
    assert bad.size == 0, f"{what}: {bad.size} of {a.size} differ"


def assert_close(actual, desired, atol, what, mask=None):
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    if mask is not None:
        a, d = a[mask], d[mask]
    err = float(np.max(np.abs(a - d))) if a.size else 0.0
    assert err <= atol, f"{what}: max |diff| {err:.3e} > {atol}"


def unsolved_impulses(ws_n, ws_t, ws_tw, point_active, warmstart_coeff, n_sub):
    """The impulse block ``[B, 14, K]`` of lanes that no color pass solves,
    in float32: generation sets their impulses from the warmstart (normal
    rows masked by the active points), and each substep adds them to the
    accumulators and decays them by `warmstart_coeff`."""
    import torch

    imp = [ws_n * point_active.to(ws_n.dtype), ws_t, ws_tw.unsqueeze(1)]
    acc = [torch.zeros_like(x) for x in imp]
    for _ in range(n_sub):
        acc = [a + x for a, x in zip(acc, imp)]
        imp = [x * warmstart_coeff for x in imp]
    return torch.cat([imp[0], acc[0], imp[1], acc[1], imp[2], acc[2]], dim=1)


def perturbed_batch(world, noise_axes, seed):
    """(reference numpy batch of B scenes of `world`, scene 1's dynamic
    bodies moved by seeded noise along `noise_axes`; reference params)."""
    import rapier_tpu.types as jt
    from rapier_tpu.scenes import replicate_scene

    state = world.build()
    batch = replicate_scene(state, B)
    rng = np.random.default_rng(seed)
    dyn = np.asarray(state.bodies.body_type) == int(jt.BodyType.DYNAMIC)
    noise = rng.normal(0.0, 0.02, (int(dyn.sum()), 3)).astype(np.float32)
    noise *= np.asarray(noise_axes, np.float32)
    for name in ("pos", "next_pos"):
        getattr(batch.bodies, name)[1, dyn] += noise
    return batch, world.params


def blocked_thresholds(mp):
    """Send every scene of both packages down the large-scene paths (set
    the dense-routing limits to 0 through the monkeypatch `mp`)."""
    import rapier_tpu.dynamics.solver.coloring as jcol
    import rapier_tpu.pipeline.physics_pipeline as jpp
    import rapier_tpu.utils.routing as jrt
    import rapier_tpu_torch.pipeline.physics_pipeline as pp

    for mod, name in ((jrt, "DENSE_ROUTE_ELEMS"), (jrt, "DENSE_JOIN_ELEMS"),
                      (jpp, "_DENSE_ROUTE_ELEMS"), (jpp, "_DENSE_JOIN_ELEMS"),
                      (jcol, "DENSE_ROUTE_ELEMS"), (pp, "DENSE_ROUTE_ELEMS")):
        mp.setattr(mod, name, 0)


def reference_rollout(jax_step, start, jparams, n_steps):
    """`n_steps` steps of the compiled reference step from the numpy batch
    `start`: the states, with numpy leaves."""
    import jax
    import jax.numpy as jnp

    js = jax.tree.map(jnp.asarray, start)
    ref = []
    for _ in range(n_steps):
        js, _ = jax_step(js, jparams)
        ref.append(jax.tree.map(np.asarray, js))
    return ref


def rollouts(start, jparams, n_steps, jax_step=None, **port_params):
    """`n_steps` steps of the reference (jit of the vmapped step, or
    `jax_step`, such a function compiled before) and of the port (its
    parameters `jparams` but for `port_params`) from the numpy batch
    `start`: (the port's solve path, reference states, port states), each
    state with numpy leaves.  The port's steps must not overflow."""
    import jax
    import jax.numpy as jnp
    import rapier_tpu.pipeline.physics_pipeline as jpp
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.types import from_numpy, to_numpy

    f = jax_step or jax.jit(jax.vmap(jpp.step, in_axes=(0, None)))
    ref = reference_rollout(f, start, jparams, n_steps)
    params = from_numpy(jparams).replace(**port_params)
    ps = from_numpy(start)
    path = pp.solve_path(ps, params)
    port = []
    for _ in range(n_steps):
        ps, ev = pp.step(ps, params)
        assert int(ev.solver_overflow.max()) == 0 and int(ev.broadphase_overflow.max()) == 0
        port.append(to_numpy(ps))
    return path, ref, port


def assert_trajectories_agree(ref, port):
    """Pair keys and touching flags equal, positions and rotations within
    1e-4, velocities within 1e-3, at every step.  Returns the fewest
    touching lanes of any step."""
    touching = 0
    for t, (rs, ps) in enumerate(zip(ref, port)):
        assert_equal(ps.contacts.pair_key, rs.contacts.pair_key, f"step {t + 1} pair_key")
        assert_equal(ps.contacts.touching, rs.contacts.touching, f"step {t + 1} touching")
        assert_close(ps.bodies.pos, rs.bodies.pos, 1e-4, f"step {t + 1} pos")
        assert_close(ps.bodies.rot, rs.bodies.rot, 1e-4, f"step {t + 1} rot")
        assert_close(ps.bodies.linvel, rs.bodies.linvel, 1e-3, f"step {t + 1} linvel")
        assert_close(ps.bodies.angvel, rs.bodies.angvel, 1e-3, f"step {t + 1} angvel")
        touching = min(touching or 10**9, int(np.sum(rs.contacts.touching)))
    return touching


def assert_joint_impulses_agree(ref, port):
    """`joints.impulses` (the last substep's row impulses) within 1e-3 of
    the step's largest impulse, at every step."""
    for t, (rs, ps) in enumerate(zip(ref, port)):
        r = np.asarray(rs.joints.impulses)
        scale = float(np.abs(r).max())
        assert scale > 0.0, f"step {t + 1}: no joint impulse"
        assert_close(ps.joints.impulses, r, 1e-3 * scale, f"step {t + 1} joints.impulses")


# ---------------------------------------------------------------------------
# The impulse-joint scenes (tests/test_torch_joint_step.py and
# tests/test_torch_joint_substeps.py).
# ---------------------------------------------------------------------------

JOINT_CAPACITY = dict(body_capacity=24, collider_capacity=24, max_pairs=256)


def _pad_joints(state, j_cap):
    """The state with its joint table padded to `j_cap` disabled joints."""
    import rapier_tpu.types as rt

    pad = rt.empty_joints(j_cap - state.joints.n)
    joints = rt.Joints(**{f.name: np.concatenate([np.asarray(getattr(state.joints, f.name)),
                                                  np.asarray(getattr(pad, f.name))])
                          for f in dataclasses.fields(rt.Joints)})
    return state.replace(joints=joints)


def joint_starts(substeps):
    """{"joints3" | "quadruped": (numpy batch, reference params)} at B = 2,
    scene 1's dynamic bodies moved by seeded noise, with `substeps` solver
    substeps and ONE static configuration, so that one compile of the
    reference's step serves both: joints3 (`scenes.joints3_world`, built
    with the port's builders) and the impulse-joint quadruped (the
    reference's `quadruped_world(use_multibody=False)`, its joint table
    padded to joints3's 24 with disabled joints and scene 1's servo targets
    also moved) share their capacities and one shape census (the union of
    the two; a census only skips kernels whose pair types cannot occur)."""
    from rapier_tpu.scenes import quadruped_world
    from rapier_tpu_torch.scenes import joints3_world

    w = joints3_world(device="cpu", **JOINT_CAPACITY)[0]
    state = to_reference(w.build())
    j3 = types.SimpleNamespace(build=lambda: state, params=reference_params(w.params))
    j3_batch, j3_params = perturbed_batch(j3, (1.0, 1.0, 1.0), seed=31)
    quad = quadruped_world(use_multibody=False, **JOINT_CAPACITY)[0]
    build = quad.build
    quad.build = lambda: _pad_joints(build(), j3_batch.joints.n)
    quad_batch, quad_params = perturbed_batch(quad, (1.0, 1.0, 1.0), seed=32)
    quad_batch.joints.motor_target_pos[1, :8, 3] += np.random.default_rng(33).normal(
        0, 0.05, 8).astype(np.float32)
    census = tuple(sorted({**dict(quad_params.shape_types_present),
                           **dict(j3_params.shape_types_present)}.items()))
    static = dict(num_solver_iterations=substeps, shape_types_present=census)
    return {"joints3": (j3_batch, j3_params.replace(**static)),
            "quadruped": (quad_batch, quad_params.replace(**static))}


def joint_step():
    """The reference's step, vmapped and jitted (compiled at first call)."""
    import jax
    import rapier_tpu.pipeline.physics_pipeline as jpp

    return jax.jit(jax.vmap(jpp.step, in_axes=(0, None)))


def joint_rollouts(starts, n_steps, jax_step):
    """{scene: rollouts(...)} of `joint_starts`, the port building the row
    slots each joint table uses (`SimParams.joint_slots`, as
    `PhysicsWorld.build` sets it)."""
    from rapier_tpu_torch.dynamics.solver.joint_constraints import used_slots
    from rapier_tpu_torch.types import from_numpy

    return {name: rollouts(batch, params, n_steps, jax_step=jax_step,
                           joint_slots=used_slots(from_numpy(batch).joints))
            for name, (batch, params) in starts.items()}
