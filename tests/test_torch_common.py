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
import torch

# The tier-1 run spreads the test files over 6 worker processes on one host,
# and torch's default intra-op pool (a thread per core in every worker)
# starves the reference's JAX compiles in the other workers, which set the
# run's length (tests/test_mjcf.py).  The port's test tensors are small:
# one thread each.  Every worker imports this module while collecting.
torch.set_num_threads(1)

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
    """A port state (numpy or tensor leaves; with or without joints, meshes
    and hulls) as a reference SceneState with numpy leaves of the reference's
    dtypes."""
    import rapier_tpu.types as jt
    from rapier_tpu_torch.types import to_numpy

    np_state = to_numpy(state)
    parts = {}
    for name, cls, empty in (("bodies", jt.Bodies, jt.empty_bodies),
                             ("colliders", jt.Colliders, jt.empty_colliders),
                             ("contacts", jt.Contacts, jt.empty_contacts),
                             ("joints", jt.Joints, jt.empty_joints),
                             ("meshes", jt.MeshData, lambda n: jt.empty_meshes(n, n)),
                             ("hulls", jt.ConvexHulls, jt.empty_hulls)):
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


def rollouts(start, jparams, n_steps, jax_step=None, hooks=None, **port_params):
    """`n_steps` steps of the reference (jit of the vmapped step, or
    `jax_step`, such a function compiled before) and of the port (its
    parameters `jparams` but for `port_params`, with the step's `hooks`)
    from the numpy batch `start`: (the port's solve path, reference states,
    port states), each state with numpy leaves.  The port's steps must not
    overflow."""
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
        ps, ev = pp.step(ps, params, hooks)
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


CONTACT_IMPULSES = ("impulse", "tangent_impulse", "warmstart_impulse",
                    "warmstart_tangent_impulse", "warmstart_twist_impulse")


def assert_contact_impulses_agree(rs, ps, what):
    """The contact cache's impulses of one step within 1e-3 of the step's
    largest (reference state `rs`, port state `ps`, numpy leaves)."""
    scale = max(float(np.abs(np.asarray(getattr(rs.contacts, f))).max())
                for f in CONTACT_IMPULSES)
    assert scale > 0.0, f"{what}: no contact impulse"
    for f in CONTACT_IMPULSES:
        assert_close(getattr(ps.contacts, f), getattr(rs.contacts, f), 1e-3 * scale,
                     f"{what} contacts.{f}")


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


# ---------------------------------------------------------------------------
# Seeded contact lanes for the solve-function tests (tests/test_torch_block
# _solve.py, tests/test_torch_coulomb.py).
# ---------------------------------------------------------------------------

SEED_N, SEED_K = 8, 64      # bodies (a sentinel column N after them), lanes


def _random_quat(rng, shape):
    q = rng.normal(size=shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def seeded_lanes(seed):
    """(manifold fields ``[B, ...]``, solver-body tables ``[B, d, N+1]``,
    previous impulses, colors) as float64 numpy arrays: B scenes of SEED_N
    bodies (body 0 fixed) and SEED_K manifold lanes, lanes of one color
    sharing bodies (a Jacobi pass), point patterns from one to four active
    points with most lanes having points 0 and 1, normal impulses of both
    signs' worth of velocity and rhs.  Point 1 of the lanes listed in
    "twin" repeats point 0."""
    rng = np.random.default_rng(seed)
    n, k, n1 = SEED_N, SEED_K, SEED_N + 1
    m = rng.normal(size=(B, 3, 3, n1))
    ii = np.einsum("bijn,bkjn->bikn", m, m) * 0.5
    im = np.repeat(rng.uniform(0.2, 2.0, (B, 1, n1)), 3, axis=1)
    im[..., 0], ii[..., 0] = 0.0, 0.0
    sb = dict(v_lin=rng.normal(size=(B, 3, n1)), v_ang=rng.normal(size=(B, 3, n1)),
              com=rng.normal(0, 2.0, (B, 3, n1)),
              rot=np.moveaxis(_random_quat(rng, (B, n1)), -1, 1), im=im, ii=ii)
    for key, v in sb.items():
        v[..., n] = 0.0
        if key == "rot":
            v[:, 3, n] = 1.0
    body1 = rng.integers(0, n, (B, k))
    body2 = (body1 + rng.integers(1, n, (B, k))) % n
    body2 = np.where(rng.random((B, k)) < 0.2, -1, body2)        # static environment
    normal = rng.normal(size=(B, 3, k))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    c1 = np.take_along_axis(sb["com"], np.broadcast_to(body1[:, None], (B, 3, k)), -1)
    point = c1[:, None] + rng.normal(0, 0.5, (B, 4, 3, k))
    twin = np.arange(0, k, 7)
    point[:, 1, :, twin] = point[:, 0, :, twin]
    pattern = rng.choice(4, (B, k), p=[0.55, 0.15, 0.15, 0.15])
    active = np.stack([pattern != 2, pattern != 3, pattern == 1, pattern == 1], axis=1)
    man = dict(
        body1=body1.astype(np.int32), body2=body2.astype(np.int32),
        rel_dominance=np.zeros((B, k), np.int32), normal=normal, point=point,
        point_active=active, dist=rng.uniform(-0.05, 0.02, (B, 4, k)),
        friction=rng.uniform(0.2, 1.0, (B, k)),
        restitution=np.where(rng.random((B, k)) < 0.3, 0.5, 0.0),
        solver_pair=rng.random((B, k)) < 0.9)
    prev = np.where(rng.random((B, 4, k)) < 0.3, 0.0, rng.uniform(0, 1, (B, 4, k)))
    color = rng.integers(0, 4, (B, k)).astype(np.int32)
    return man, sb, prev, color, twin


def reference_manifolds(man, s, cast):
    """Scene `s` of `seeded_lanes`' manifold fields as the reference's
    ManifoldBatch (fields the solve does not read zeroed)."""
    import jax.numpy as jnp
    from rapier_tpu.geometry.dispatch import ManifoldBatch

    k = man["body1"].shape[-1]
    fill = dict(collider1=np.zeros(k, np.int32), collider2=np.zeros(k, np.int32),
                active_events_or=np.zeros(k, np.int32), active_hooks_or=np.zeros(k, np.int32),
                force_threshold=np.zeros(k), dyn1=np.ones(k, bool), dyn2=np.ones(k, bool),
                pair_key=np.arange(k, dtype=np.int32), fid=np.zeros((4, k), np.int32),
                point_valid=man["point_active"][s], valid=man["solver_pair"][s],
                unsupported=np.int32(0), touching=man["solver_pair"][s],
                sensor=np.zeros(k, bool))
    fields = {**fill, **{key: v[s] for key, v in man.items()}}
    return ManifoldBatch(**{key: jnp.asarray(cast(np.asarray(v)))
                            for key, v in fields.items()})


def port_manifolds(man, cast):
    """`seeded_lanes`' manifold fields as the port's ManifoldBatch."""
    import torch
    from rapier_tpu_torch.geometry.dispatch import ManifoldBatch

    b, k = man["body1"].shape
    fill = dict(collider1=np.zeros((b, k), np.int32), collider2=np.zeros((b, k), np.int32),
                active_events_or=np.zeros((b, k), np.int32),
                active_hooks_or=np.zeros((b, k), np.int32), force_threshold=np.zeros((b, k)),
                dyn1=np.ones((b, k), bool), dyn2=np.ones((b, k), bool),
                pair_key=np.tile(np.arange(k, dtype=np.int32), (b, 1)),
                fid=np.zeros((b, 4, k), np.int32), point_valid=man["point_active"],
                valid=man["solver_pair"], unsupported=np.zeros(b, np.int32),
                touching=man["solver_pair"], sensor=np.zeros((b, k), bool))
    fields = {**fill, **man}
    return ManifoldBatch(**{key: torch.from_numpy(cast(np.asarray(v)))
                            for key, v in fields.items()})


def cast_float(dtype):
    """Cast float arrays to `dtype`, leave the others."""
    return lambda v: v.astype(dtype) if np.issubdtype(v.dtype, np.floating) else v


def assert_scaled(actual, desired, what, tol):
    """max |actual - desired| within `tol` times the largest |desired| (at
    least 1)."""
    a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    scale = max(1.0, float(np.max(np.abs(d)))) if d.size else 1.0
    err = float(np.max(np.abs(a - d))) if a.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > {tol} x {scale:.3f}"


# ---------------------------------------------------------------------------
# Seeded convex shape pairs (tests/test_torch_gjk.py and
# tests/test_torch_convex.py).
# ---------------------------------------------------------------------------

# Two hulls: the decimated hull of 40 seeded points on an ellipsoid, and an
# octahedron.
def convex_hull_table():
    """``[2, MAX_HULL_VERTS, 3]`` float32 hull slots, built by the port's
    `_build_hull` (held to the reference's in tests/test_torch_convex.py)."""
    from rapier_tpu_torch.types import MAX_HULL_VERTS
    from rapier_tpu_torch.world import _build_hull

    rng = np.random.default_rng(5)
    d = rng.normal(size=(40, 3))
    cloud = d / np.linalg.norm(d, axis=1, keepdims=True) * np.array([0.9, 0.6, 0.75])
    octa = [(0.75, 0, 0), (-0.75, 0, 0), (0, 0.5, 0), (0, -0.5, 0), (0, 0, 0.75), (0, 0, -0.75)]
    return np.stack([_build_hull(cloud, MAX_HULL_VERTS)[0],
                     _build_hull(octa, MAX_HULL_VERTS)[0]])


def _convex_params(rng, t, touching):
    """A parameter row of shape type `t` (ShapeType int).  With `touching`,
    extents are dyadic (exact in float32) and capsules and segments lie on
    the local Y axis, so an exact stacking is representable."""
    from rapier_tpu_torch.types import ShapeType as S

    def size(lo=0.3, hi=1.0):
        return float(rng.choice([0.25, 0.5, 0.75])) if touching else float(rng.uniform(lo, hi))

    def border():
        return float(rng.choice([0.0625, 0.125])) if touching else float(rng.uniform(0.05, 0.15))

    prm = np.zeros(12, np.float32)
    if t == S.BALL:
        prm[0] = size()
    elif t in (S.CUBOID, S.ROUND_CUBOID):
        prm[0:3] = [size(), size(), size()]
        if t == S.ROUND_CUBOID:
            prm[3] = border()
    elif t in (S.CAPSULE, S.SEGMENT):
        if touching:
            axis = np.array([0.0, 1.0, 0.0])
        else:
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
        hh = size(0.2, 0.8)
        prm[0:3], prm[3:6] = -hh * axis, hh * axis
        if t == S.CAPSULE:
            prm[6] = size(0.2, 0.6)
    elif t in (S.CYLINDER, S.CONE, S.ROUND_CYLINDER, S.ROUND_CONE):
        prm[0], prm[1] = size(), size()
        if t in (S.ROUND_CYLINDER, S.ROUND_CONE):
            prm[2] = border()
    else:   # CONVEX: a row of the hull table and a border
        prm[0] = float(rng.integers(2))
        prm[1] = float(rng.choice([0.0, 0.0625]))
    return prm


def _y_extent(t, prm, hulls):
    """(top, bottom) of an unrotated shape along Y, border included."""
    from rapier_tpu_torch.types import ShapeType as S

    if t == S.BALL:
        return prm[0], prm[0]
    if t in (S.CUBOID, S.ROUND_CUBOID):
        e = prm[1] + (prm[3] if t == S.ROUND_CUBOID else 0.0)
        return e, e
    if t in (S.CAPSULE, S.SEGMENT):
        e = prm[4] + (prm[6] if t == S.CAPSULE else 0.0)
        return e, e
    if t in (S.CYLINDER, S.CONE, S.ROUND_CYLINDER, S.ROUND_CONE):
        e = prm[0] + (prm[2] if t in (S.ROUND_CYLINDER, S.ROUND_CONE) else 0.0)
        return e, e
    v = hulls[int(prm[0])]
    return v[:, 1].max() + prm[1], -v[:, 1].min() + prm[1]


CONVEX_CASES = ("separated", "deep", "near", "touching")


def convex_pairs(seed, cases=CONVEX_CASES):
    """Seeded lanes of every ordered pair of `narrowphase_convex.SUPPORTED`
    types, one lane a pair and case: "separated" (centres 4.5 apart, beyond
    any two shapes' reach), "deep" (0.4 apart: EPA), "near" (1.2 apart:
    either) in random directions and rotations, and "touching" (unrotated,
    B stacked on A's top along Y with dyadic extents: the gap is exactly 0,
    the inflated retry).  Returns (dict of float32 / int32 numpy arrays pA,
    rA, stA, prmA, pB, rB, stB, prmB [L, ...], the hull table, the case of
    each lane)."""
    from rapier_tpu_torch.geometry.narrowphase_convex import SUPPORTED

    rng = np.random.default_rng(seed)
    hulls = convex_hull_table()
    rows, case_of = [], []
    for case in cases:
        touching = case == "touching"
        for ta in SUPPORTED:
            for tb in SUPPORTED:
                pa, pb = _convex_params(rng, ta, touching), _convex_params(rng, tb, touching)
                if touching:
                    ra = rb = np.array([0.0, 0.0, 0.0, 1.0])
                    top = _y_extent(ta, pa, hulls)[0]
                    bottom = _y_extent(tb, pb, hulls)[1]
                    pos_a = np.zeros(3)
                    pos_b = np.array([float(rng.choice([0.0, 0.125])), np.float32(top)
                                      + np.float32(bottom), 0.0])
                else:
                    ra, rb = _random_quat(rng, ()), _random_quat(rng, ())
                    d = rng.normal(size=3)
                    d /= np.linalg.norm(d)
                    pos_a = rng.normal(0, 0.5, 3)
                    pos_b = pos_a + d * {"separated": 4.5, "deep": 0.4, "near": 1.2}[case]
                rows.append((pos_a, ra, int(ta), pa, pos_b, rb, int(tb), pb))
                case_of.append(case)
    cols = list(zip(*rows))
    lanes = dict(pA=np.array(cols[0], np.float32), rA=np.array(cols[1], np.float32),
                 stA=np.array(cols[2], np.int32), prmA=np.array(cols[3], np.float32),
                 pB=np.array(cols[4], np.float32), rB=np.array(cols[5], np.float32),
                 stB=np.array(cols[6], np.int32), prmB=np.array(cols[7], np.float32))
    return lanes, hulls, np.array(case_of)


def lane_hulls(st, prm, hulls):
    """Each lane's hull vertex slots ``[L, V, 3]`` (hull 0 for a lane that is
    not CONVEX, as the reference's dispatch gathers)."""
    from rapier_tpu_torch.types import ShapeType

    idx = np.where(st == int(ShapeType.CONVEX), prm[:, 0].astype(np.int64), 0)
    return hulls[idx]


def witness_verdicts(lanes, ref_lane, port, close, nudge=(("pA", 3), ("pB", 3), ("rA", 4),
                                                          ("rB", 4))):
    """Per-lane verdicts of a port kernel against the reference called one
    lane at a time (`ref_lane(lanes, i)` -> list of numpy results; `port`:
    the port's results, a list of ``[L, ...]`` arrays; `close(o, r)`):
    "agree"; else "witness" when the port agrees with the reference run from
    a start 1 ulp apart (each component of the `nudge` fields, up and down);
    else "unstable" when such a run itself parts from the reference; else
    "differs"."""
    n = len(next(iter(lanes.values())))
    verdict = []
    for i in range(n):
        o = [x[i] for x in port]
        r = ref_lane(lanes, i)
        if close(o, r):
            verdict.append("agree")
            continue
        wit = []
        for key, size in nudge:
            for ax in range(size):
                for sign in (1.0, -1.0):
                    nudged = {k: v.copy() for k, v in lanes.items()}
                    flat = nudged[key].reshape(n, -1)
                    flat[i, ax] = np.nextafter(flat[i, ax], np.float32(sign * np.inf))
                    wit.append(ref_lane(nudged, i))
        if any(close(o, w) for w in wit):
            verdict.append("witness")
        elif any(not close(w, r) for w in wit):
            verdict.append("unstable")
        else:
            verdict.append("differs")
    return np.array(verdict)


# ---------------------------------------------------------------------------
# Scene queries (tests/test_torch_queries*.py)

QUERY_TOL = 1e-5           # toi, points, distances: relative
QUERY_NORMAL_TOL = 1e-4    # analytic normals
GJK_NORMAL_TOL = 2e-3      # normals from GJK (separated lanes agree to ~1e-3)
QUERY_UNSTABLE_SHARE = 0.05


def query_zoo(package, kinds=None):
    """One fixed collider of every query shape type (rotated by seeded
    quaternions, the round shapes and a hull included; a heightfield and a
    trimesh apart from the others; a tilted halfspace below them all), or
    of the named `kinds` only, built with `package`'s builders
    ("rapier_tpu" or "rapier_tpu_torch").  Returns (world, [(name, centre,
    extent)] of each target)."""
    import importlib

    w_mod = importlib.import_module(f"{package}.world")
    rb, cb = w_mod.RigidBodyBuilder, w_mod.ColliderBuilder
    kw = {"device": "cpu"} if package == "rapier_tpu_torch" else {}
    w = w_mod.PhysicsWorld(**kw)
    rng = np.random.default_rng(11)
    hull = [(x, y, z) for x in (-0.5, 0.5) for y in (-1.0, 1.0) for z in (-0.5, 0.5)]
    hull += [(0.0, 1.3, 0.0), (0.7, 0.0, 0.2)]
    shapes = [
        ("ball", cb.ball(0.5), 0.5),
        ("cuboid", cb.cuboid(0.5, 1.0, 0.4), 1.0),
        ("round_cuboid", cb.round_cuboid(0.4, 0.3, 0.5, 0.1), 0.6),
        ("capsule", cb.capsule_x(0.6, 0.3), 0.9),
        ("cylinder", cb.cylinder(1.0, 0.5), 1.0),
        ("round_cylinder", cb.round_cylinder(0.6, 0.4, 0.05), 0.65),
        ("cone", cb.cone(1.0, 0.5), 1.0),
        ("round_cone", cb.round_cone(0.7, 0.5, 0.05), 0.75),
        ("hull", cb.convex_hull(hull), 1.3),
    ]
    targets = []

    def want(name):
        return kinds is None or name in kinds

    for i, (name, col, ext) in enumerate(shapes):
        q = rng.normal(size=4)
        q = (q / np.linalg.norm(q)).astype(np.float32)
        centre = (4.0 * i, 1.5, 0.0)
        if not want(name):
            continue
        b = w.insert_body(rb.fixed().with_translation(centre).with_rotation(tuple(q)))
        w.insert_collider(col, b)
        targets.append((name, centre, ext))
    heights = rng.uniform(0.0, 1.0, (5, 5)).astype(np.float32)
    if want("heightfield"):
        hf = w.insert_body(rb.fixed().with_translation((40.0, 0.0, 0.0)))
        w.insert_collider(cb.heightfield(heights, (6.0, 1.0, 6.0)), hf)
        targets.append(("heightfield", (40.0, 0.5, 0.0), 2.5))
    verts = np.array([[-2, 0, -2], [2, 0.5, -2], [2, 0, 2], [-2, -0.5, 2], [0, 1.5, 0]],
                     np.float32)
    tris = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], np.int32)
    if want("trimesh"):
        tm = w.insert_body(rb.fixed().with_translation((50.0, 0.5, 0.0)))
        w.insert_collider(cb.trimesh(verts, tris), tm)
        targets.append(("trimesh", (50.0, 1.0, 0.0), 2.0))
    if want("halfspace"):
        ground = w.insert_body(rb.fixed().with_translation((0.0, -3.0, 0.0)))
        n = np.array([0.1, 1.0, 0.05])
        w.insert_collider(cb.halfspace(tuple(n / np.linalg.norm(n))), ground)
        targets.append(("halfspace", (20.0, -3.0, 0.0), 3.0))
    w.build()
    return w, targets


def aimed_rays(targets, per_target, seed):
    """`per_target` seeded rays at each target: (origin, direction) ``[R,
    3]`` float32, a tenth of them starting inside their target, and the
    target of each."""
    rng = np.random.default_rng(seed)
    o, d, which = [], [], []
    for k, (_, centre, ext) in enumerate(targets):
        aim = np.asarray(centre) + rng.uniform(-ext, ext, (per_target, 3))
        start = aim + rng.normal(0.0, 1.0, (per_target, 3)) * (2.0 + 2.0 * ext)
        inside = rng.uniform(size=per_target) < 0.1
        start[inside] = np.asarray(centre) + rng.uniform(-0.1, 0.1, (int(inside.sum()), 3))
        scale = rng.uniform(0.5, 2.0, (per_target, 1))
        o.append(start)
        d.append((aim - start) * scale / np.maximum(
            np.linalg.norm(aim - start, axis=1, keepdims=True), 1e-3))
        which += [k] * per_target
    return (np.concatenate(o).astype(np.float32), np.concatenate(d).astype(np.float32),
            np.array(which))


def near_points(targets, per_target, seed):
    """`per_target` seeded points around each target ``[P, 3]``."""
    rng = np.random.default_rng(seed)
    pts = [np.asarray(c) + rng.normal(0.0, 0.8, (per_target, 3)) * ext for _, c, ext in targets]
    return np.concatenate(pts).astype(np.float32)


def nudged(x, seed_axes=3):
    """The 2 x `seed_axes` copies of ``x [N, 3]`` moved 1 ulp up and down
    along each axis: the reference's own spread on rounding ties."""
    out = []
    for ax in range(seed_axes):
        for sign in (1.0, -1.0):
            y = x.copy()
            y[:, ax] = np.nextafter(y[:, ax], np.float32(sign * np.inf))
            out.append(y)
    return out


def assert_rows_with_witnesses(port, ref, witnesses, tols, what, mask=None,
                               share=QUERY_UNSTABLE_SHARE):
    """Rows of `port` that agree with `ref` (every field within its
    tolerance), or with one of the reference's own runs from inputs 1 ulp
    apart (`witnesses`), or where such a run parts from `ref` (the
    reference is unstable there: at most `share` of the rows).  `port`,
    `ref` and each witness are lists of ``[N, ...]`` arrays, `tols` a
    tolerance a field (a scalar or ``[N]``; 0 for flags and indices)."""
    def close(a, b):
        return rows_close(a, b, tols)

    rows = np.ones(len(port[0]), bool) if mask is None else np.asarray(mask)
    ok = close(port, ref)
    wit = np.zeros_like(ok)
    unstable = np.zeros_like(ok)
    for w in witnesses:
        wit |= close(port, w)
        unstable |= ~close(w, ref)
    bad = rows & ~ok & ~wit & ~unstable
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {int(rows.sum())} rows differ, e.g. "
                           f"row {np.flatnonzero(bad)[:3]}: port "
                           f"{[np.asarray(x)[bad][:1] for x in port]} ref "
                           f"{[np.asarray(x)[bad][:1] for x in ref]}")
    n_unstable = int((rows & ~ok & ~wit).sum())
    assert n_unstable <= share * max(1, int(rows.sum())), (
        f"{what}: {n_unstable} rows only explained by the reference's instability")


def rows_close(a, b, tols):
    """Per row: every field of `a` within its tolerance of `b` (lists of
    ``[N, ...]`` arrays; a tolerance a field, scalar or ``[N]``)."""
    ok = np.ones(len(a[0]), bool)
    for x, y, t in zip(a, b, tols):
        g = np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
        ok &= g.reshape(g.shape[0], -1).max(axis=1) <= t
    return ok


def lazy_witnesses(ref, args, base, rows, nudge_args=(0,)):
    """The 1-ulp witnesses of the compiled reference `ref(*args)` (numpy
    inputs ``[N, ...]``, result `base`): one for each component of each of
    the `nudge_args` inputs, up and down.  They run only for `rows` (a bool
    mask) and equal `base` on the others; the nudged rows are packed into
    batches of N, so `ref` runs at its compiled shape."""
    import jax
    import jax.numpy as jnp

    n = len(args[0])
    idx = np.flatnonzero(rows)
    nudges = [(a, y) for a in nudge_args
              for y in nudged(np.asarray(args[a])[idx], np.asarray(args[a]).shape[1])]
    wits = [jax.tree.map(np.array, base) for _ in nudges]
    todo = [(j, i) for j in range(len(nudges)) for i in range(len(idx))]
    for s in range(0, len(todo), n):
        chunk = todo[s:s + n]
        pad = chunk + [chunk[-1]] * (n - len(chunk))
        batch = [np.stack([nudges[j][1][i] if a == nudges[j][0] else np.asarray(x)[idx[i]]
                           for j, i in pad]) for a, x in enumerate(args)]
        out = jax.tree.map(np.asarray, ref(*[jnp.asarray(x) for x in batch]))
        for m, (j, i) in enumerate(chunk):
            for w_leaf, o_leaf in zip(jax.tree.leaves(wits[j]), jax.tree.leaves(out)):
                w_leaf[idx[i]] = o_leaf[m]
    return wits


# ---------------------------------------------------------------------------
# The reference at f64.  `rapier_tpu.precision.set_precision("f64")` turns
# on jax_enable_x64 for the whole process, and xdist runs other test files
# in the same worker, so the reference runs at f64 in a subprocess.
# ---------------------------------------------------------------------------

F64_FIELDS = ("bodies.pos", "bodies.rot", "bodies.linvel", "bodies.angvel",
              "contacts.pair_key", "contacts.touching", "contacts.impulse",
              "contacts.tangent_impulse", "contacts.warmstart_impulse",
              "contacts.warmstart_tangent_impulse", "contacts.warmstart_twist_impulse")

_F64_SCRIPT = r'''
import os, pickle, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from rapier_tpu.precision import set_precision
set_precision("f64")
import dataclasses
import numpy as np
import jax.numpy as jnp
import rapier_tpu.pipeline.physics_pipeline as jpp
import test_torch_common as tp

job = pickle.load(open(sys.argv[1], "rb"))
out = {}
if job.get("build"):
    scope = {}
    exec(job["build"], scope)
    built = scope["world"].build()
    out["built"] = {f"{part}.{f.name}": np.asarray(getattr(getattr(built, part), f.name))
                    for part in ("bodies", "colliders", "contacts")
                    for f in dataclasses.fields(getattr(built, part))}
    out["built_params"] = {f.name: np.asarray(getattr(scope["world"].params, f.name))
                           for f in dataclasses.fields(scope["world"].params)
                           if np.asarray(getattr(scope["world"].params, f.name)).dtype.kind == "f"}
if job.get("state") is not None:
    start = tp.to_reference(job["state"])
    jparams = tp.reference_params(job["params"])
    step = jax.jit(jax.vmap(jpp.step, in_axes=(0, None)))
    starts = {"reference": start}
    if job.get("witness"):
        s, b, a = job["witness"]
        w = jax.tree.map(np.array, start)
        for name in ("pos", "next_pos"):
            arr = getattr(w.bodies, name)
            arr[s, b, a] = np.nextafter(arr[s, b, a], np.inf)
        starts["witness"] = w
    for key, st in starts.items():
        js, traj = jax.tree.map(jnp.asarray, st), []
        for _ in range(job["steps"]):
            js, _ = step(js, jparams)
            rec = {f: np.asarray(getattr(getattr(js, f.split(".")[0]), f.split(".")[1]))
                   for f in job["fields"]}
            traj.append(rec)
        out[key] = traj
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def reference_f64(tmp_path, *, state=None, params=None, steps=0, witness=None,
                  build=None, fields=F64_FIELDS, timeout=900):
    """Run the reference at f64 in a subprocess.  `state` (a port batch with
    numpy or tensor leaves) and `params` (the port's SimParams) are stepped
    `steps` times by `jax.jit(jax.vmap(step))`, and, with `witness = (scene,
    body, axis)`, a second time from the same state with that coordinate of
    pos and next_pos 1 ulp higher.  `build` is source that defines a
    reference `world`, built there.  Returns a dict: "reference" and
    "witness" (per step, `fields` as numpy arrays), "built" (the built
    state's leaves by "part.field") and "built_params" (its float fields)."""
    import os
    import pickle
    import subprocess
    import sys

    from rapier_tpu_torch.types import to_numpy

    job = dict(state=None if state is None else to_numpy(state), params=params,
               steps=steps, witness=witness, build=build, fields=fields)
    inp, outp = tmp_path / "f64_job.pkl", tmp_path / "f64_out.pkl"
    script = tmp_path / "f64_reference.py"
    script.write_text(_F64_SCRIPT)
    with open(inp, "wb") as f:
        pickle.dump(job, f)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(here), here,
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, str(script), str(inp), str(outp)],
                          capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=os.path.dirname(here))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(outp, "rb") as f:
        return pickle.load(f)


def port_f64_rollout(state, params, steps, fields=F64_FIELDS):
    """The port's steps from `state` (tensors), recorded as
    `reference_f64` records them, and the last state."""
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    traj = []
    for _ in range(steps):
        state, _ = step(state, params)
        traj.append({f: getattr(getattr(state, f.split(".")[0]), f.split(".")[1])
                     .detach().cpu().numpy() for f in fields})
    return traj, state


def trajectory_gap(a, b, fields):
    """The largest absolute difference of each field over every step."""
    return {f: max(float(np.max(np.abs(np.asarray(x[f], np.float64)
                                       - np.asarray(y[f], np.float64)), initial=0.0))
                   for x, y in zip(a, b))
            for f in fields}
