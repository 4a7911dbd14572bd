"""rapier_tpu_torch's shape queries (geometry/queries.py: cast_shape,
cast_shape_nonlinear, intersect_shape, intersect_aabb_conservative) against
rapier_tpu.geometry.queries on the CPU.

Inputs: `test_torch_common.query_zoo` (every query shape type, a hull, a
heightfield and a trimesh), built by the reference's builders and fed to
both packages, and seeded casts of every query shape aimed at each target.
The reference runs `jax.vmap` over the casts in one compiled function (the
shape type and parameters are per-cast values).  The meshes sit in a scene
of their own, compiled at XLA's optimisation level 0: at the default level
XLA:CPU miscompiles the reference's vmapped triangle SAT (ROADMAP R14), and
level 0 runs five times slower.

Tolerances: hit flags and collider indices exact; toi 1e-5 relative or
the search's final bracket (MAX_TOI / 8 / 2^12: a last bisection sample
within GJK's error of the surface falls either way); the normals
CAST_NORMAL_TOL: a cast's normal is GJK's at the last separated bisection
sample, a gap below that bracket, where GJK's stopping rule (progress under
1e-6 of the distance) leaves its direction good to a few 1e-2 only on
polytopes (the reference's own 1-ulp witnesses part by more than 1e-2 on
15% of the turning hull's casts).  Rows that differ are held to witnesses, the reference run from
starts 1 ulp apart (ROADMAP R16; each component of the start, the direction and the
rotation, up and down): a bisection sample within GJK's error of the
surface may fall either way.  The reference's own checks of tests/test_queries.py (intersect_shape, the
nonlinear cast, casts onto the heightfield) run on the port's
`PhysicsWorld` in tests/test_torch_queries_checks.py.  This file keeps to
8 tests, as tests/test_torch_queries.py does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu.geometry import queries as jq
from rapier_tpu_torch.geometry import queries as pq
from rapier_tpu_torch.scenes import replicate_scene
from rapier_tpu_torch.types import ShapeType, from_numpy

PER_TARGET = 4
MAX_TOI = 6.0
CAST_NORMAL_TOL = 5e-2
BRACKET = MAX_TOI / 8 / 2 ** 12
HULL = np.array([(x, y, z) for x in (-0.2, 0.2) for y in (-0.3, 0.3) for z in (-0.25, 0.25)]
                + [(0.0, 0.4, 0.1)], np.float32)
QUERY_SHAPES = {
    "ball": (ShapeType.BALL, [0.3]),
    "cuboid": (ShapeType.CUBOID, [0.2, 0.3, 0.25]),
    "capsule": (ShapeType.CAPSULE, [0.0, -0.3, 0.0, 0.0, 0.3, 0.0, 0.2]),
    "hull": (ShapeType.CONVEX, [0.0, 0.0]),
}
NAMES = sorted(QUERY_SHAPES)


def _prm(name):
    st, p = QUERY_SHAPES[name]
    return int(st), np.pad(np.asarray(p, np.float32), (0, 12 - len(p)))


ALL = [t[0] for t in tp.query_zoo("rapier_tpu")[1]]
MESHES = ("heightfield", "trimesh")
SCENES = {"shapes": tuple(k for k in ALL if k not in MESHES),
          "meshes": ("ball",) + MESHES + ("halfspace",)}
AIMED = {"shapes": SCENES["shapes"], "meshes": MESHES, "all": tuple(ALL)}


@functools.lru_cache(maxsize=None)
def zoo(scene="all"):
    """(reference state, the port's batch of one, the aimed-at targets)."""
    w, targets = tp.query_zoo("rapier_tpu", SCENES.get(scene))
    s = w.state
    return s, from_numpy(replicate_scene(s, 1)), [t for t in targets if t[0] in AIMED[scene]]


@functools.lru_cache(maxsize=None)
def casts(seed, scene="all"):
    """Seeded casts of every query shape at every target: (shape names,
    starts, unit directions towards the target, rotations, angular
    velocities) ``[Q, ...]``."""
    _, _, targets = zoo(scene)
    rng = np.random.default_rng(seed)
    names, starts, dirs = [], [], []
    for name in NAMES:
        for _, c, ext in targets:
            aim = np.asarray(c) + rng.uniform(-ext, ext, (PER_TARGET, 3))
            start = aim + rng.normal(0.0, 1.0, (PER_TARGET, 3)) * 2.0
            d = aim - start
            names += [name] * PER_TARGET
            starts.append(start)
            dirs.append(d / np.linalg.norm(d, axis=1, keepdims=True))
    q = rng.normal(size=(len(names), 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = rng.normal(0.0, 2.0, (len(names), 3))
    return (np.array(names), np.concatenate(starts).astype(np.float32),
            np.concatenate(dirs).astype(np.float32), q.astype(np.float32), w.astype(np.float32))


def _per_row(names):
    """Each row's shape type and parameters."""
    st = np.array([_prm(n)[0] for n in names], np.int32)
    prm = np.stack([_prm(n)[1] for n in names])
    return st, prm


def _compiled(fn, args, meshes: bool):
    """`fn` compiled for numpy `args`, at XLA's optimisation level 0 where
    it runs the meshes' SAT (R14)."""
    low = jax.jit(fn).lower(*[jnp.asarray(x) for x in args])
    return low.compile(compiler_options={"xla_backend_optimization_level": 0}) if meshes \
        else low.compile()


KEYS = ("hit", "collider", "toi", "normal")


def _tols(r):
    return (0, 0, np.maximum(tp.QUERY_TOL * np.maximum(1.0, np.abs(r.toi)), BRACKET),
            np.where(r.hit, CAST_NORMAL_TOL, np.inf))


@functools.lru_cache(maxsize=None)
def cast_results(scene, nonlinear=False):
    """(shape names, the reference's casts (one compile: shape types and
    parameters are per-row values), the port's (a call a shape), the
    reference's 1-ulp witnesses where the two differ, the inputs)."""
    s, ps, _ = zoo(scene)
    names, pos, dirs, rot, angvel = casts(1, scene)
    st, prm = _per_row(names)
    kw = dict(meshes=s.meshes, hulls=s.hulls, shape_hull=jnp.asarray(HULL))

    def ref_fn(p, d, r, w, t, pr):
        def one(p1, d1, r1, w1, t1, pr1):
            if nonlinear:
                return jq.cast_shape_nonlinear(s.bodies, s.colliders, t1, pr1, p1, r1, d1, w1,
                                               MAX_TOI, **kw)
            return jq.cast_shape(s.bodies, s.colliders, t1, pr1, p1, r1, d1, MAX_TOI, **kw)
        return jax.vmap(one)(p, d, r, w, t, pr)

    args = (pos, dirs, rot, angvel, st, prm)
    ref = _compiled(ref_fn, args, scene == "meshes")
    r = jax.tree.map(np.asarray, ref(*[jnp.asarray(x) for x in args]))
    parts = []
    for name in NAMES:
        rows = names == name
        t = [torch.from_numpy(x[rows])[None] for x in (pos, dirs, rot, angvel)]
        stn, prmn = _prm(name)
        pkw = dict(meshes=ps.meshes, hulls=ps.hulls,
                   shape_hull=HULL if name == "hull" else None)
        if nonlinear:
            parts.append(pq.cast_shape_nonlinear(ps.bodies, ps.colliders, stn, prmn, t[0], t[2],
                                                 t[1], t[3], MAX_TOI, **pkw))
        else:
            parts.append(pq.cast_shape(ps.bodies, ps.colliders, stn, prmn, t[0], t[2], t[1],
                                       MAX_TOI, **pkw))
    p = type(parts[0])(*[torch.cat([x[j] for x in parts], dim=1) for j in range(4)])
    port = [getattr(p, k)[0].numpy() for k in KEYS]
    bad = ~tp.rows_close(port, [getattr(r, k) for k in KEYS], _tols(r))
    # Witnesses: the start, the direction (the linear velocity) and the
    # rotation nudged.
    return names, r, p, tp.lazy_witnesses(ref, args, r, bad, nudge_args=(0, 1, 2)), args


def _assert_casts(names, r, p, wit, args, name, what, scene, share=tp.QUERY_UNSTABLE_SHARE):
    rows = names == name
    tp.assert_rows_with_witnesses([getattr(p, k)[0].numpy() for k in KEYS],
                                  [getattr(r, k) for k in KEYS],
                                  [[getattr(w, k) for k in KEYS] for w in wit], _tols(r), what,
                                  mask=rows, share=share)
    hit_any = {int(c) for c in np.unique(r.collider[rows & r.hit])}
    aimed = [i for i, k in enumerate(SCENES[scene]) if k in AIMED[scene]]
    assert sum(i in hit_any for i in aimed) >= len(aimed) - 2, hit_any


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cast_shape_matches_reference(scene):
    for name in NAMES:
        _assert_casts(*cast_results(scene), name, f"{name} casts", scene)


# A turning hull's casts: the reference's own witnesses part from it on 4
# of its 40 (hull against hull and cuboid, near a face), the port agrees
# with it or a witness on the others.
TURNING_HULL_UNSTABLE_SHARE = 0.15


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cast_shape_nonlinear_matches_reference(scene):
    for name in NAMES:
        share = TURNING_HULL_UNSTABLE_SHARE if name == "hull" else tp.QUERY_UNSTABLE_SHARE
        _assert_casts(*cast_results(scene, nonlinear=True), name, f"turning {name} casts",
                      scene, share)


def test_intersect_shape_matches_reference():
    s, ps, targets = zoo()
    names, pos, _, rot, _ = casts(3)
    st, prm = _per_row(names)
    # Half the poses on their target: overlaps and misses.
    centres = np.tile(np.repeat(np.asarray([c for _, c, _ in targets], np.float32), PER_TARGET,
                                axis=0), (len(NAMES), 1))
    on = np.arange(len(pos)) % 2 == 0
    pos = np.where(on[:, None], centres + 0.15 * (pos - centres), pos).astype(np.float32)

    def ref_fn(p, r, t, pr):
        return jax.vmap(lambda p1, r1, t1, pr1: jq.intersect_shape(
            s.bodies, s.colliders, t1, pr1, p1, r1, meshes=s.meshes, hulls=s.hulls,
            shape_hull=jnp.asarray(HULL)))(p, r, t, pr)

    args = (pos, rot, st, prm)
    ref = _compiled(ref_fn, args, True)
    r = np.asarray(ref(*[jnp.asarray(x) for x in args]))
    p = np.concatenate([pq.intersect_shape(
        ps.bodies, ps.colliders, _prm(n)[0], _prm(n)[1],
        torch.from_numpy(pos[names == n])[None], torch.from_numpy(rot[names == n])[None],
        meshes=ps.meshes, hulls=ps.hulls, shape_hull=HULL if n == "hull" else None)[0].numpy()
        for n in NAMES])
    wit = tp.lazy_witnesses(ref, args, r, ~tp.rows_close([p], [r], (0,)), nudge_args=(0, 1))
    tp.assert_rows_with_witnesses([p], [r], [[w] for w in wit], (0,), "overlaps")
    assert r.sum() > len(pos) // 4 and (~r.any(axis=1)).sum() > 0


def test_intersect_aabb_matches_reference():
    s, ps, _ = zoo()
    rng = np.random.default_rng(4)
    js = jax.tree.map(jnp.asarray, s)
    for _ in range(32):
        lo = rng.uniform(-5, 50, 3).astype(np.float32) * np.array([1, 0.1, 0.1], np.float32)
        hi = (lo + rng.uniform(0.1, 6.0, 3)).astype(np.float32)
        for kw in ({}, dict(flags=jq.EXCLUDE_FIXED), dict(exclude_collider=3)):
            ref = np.asarray(jq.intersect_aabb_conservative(js.bodies, js.colliders, lo, hi, **kw))
            got = pq.intersect_aabb_conservative(ps.bodies, ps.colliders, torch.from_numpy(lo),
                                                 torch.from_numpy(hi), **kw)[0].numpy()
            np.testing.assert_array_equal(got, ref)


def test_world_shape_queries_match_reference():
    """The world's four shape-query methods at B = 1 return what the
    reference returns: the port's world (its own builders) on casts whose
    reference results the tests above computed."""
    s, _, _ = zoo("shapes")
    pw, _ = tp.query_zoo("rapier_tpu_torch", SCENES["shapes"])
    names, r, _, _, args = cast_results("shapes")
    _, r_non, _, _, _ = cast_results("shapes", nonlinear=True)
    pos, dirs, rot, angvel = args[:4]
    for i in np.flatnonzero(names == "capsule")[::7]:
        st, prm = _prm("capsule")
        p = pw.cast_shape(st, prm[:7], pos[i], rot[i], dirs[i], MAX_TOI)
        assert p.toi.shape == () and p.normal.shape == (3,)
        assert bool(p.hit) == bool(r.hit[i]) and int(p.collider) == int(r.collider[i])
        assert abs(float(p.toi) - float(r.toi[i])) <= tp.QUERY_TOL * MAX_TOI
        p = pw.cast_shape_nonlinear(st, prm[:7], pos[i], rot[i], dirs[i], angvel[i], MAX_TOI)
        assert int(p.collider) == int(r_non.collider[i])
        assert abs(float(p.toi) - float(r_non.toi[i])) <= tp.QUERY_TOL * MAX_TOI
    js = jax.tree.map(jnp.asarray, s)
    for centre in ((4.0, 1.5, 0.0), (40.0, 1.0, 0.0)):
        ref = np.asarray(jq.intersect_aabb_conservative(
            js.bodies, js.colliders, jnp.asarray(centre) - 1.0, jnp.asarray(centre) + 1.0))
        np.testing.assert_array_equal(
            pw.colliders_with_aabb_intersecting_aabb(np.subtract(centre, 1.0),
                                                     np.add(centre, 1.0)), np.flatnonzero(ref))
    hits = pw.intersections_with_shape(ShapeType.BALL, [0.8], (4.0, 1.5, 0.0), (0, 0, 0, 1))
    assert list(hits) == [1]
    ps = pw.state
    for name in ("ball", "hull"):
        pos = torch.tensor([[[4.0 * SCENES["shapes"].index(name), 1.5, 0.0]]])
        mask = pq.intersect_shape(ps.bodies, ps.colliders, _prm("cuboid")[0], _prm("cuboid")[1],
                                  pos, torch.tensor([0.0, 0.0, 0.0, 1.0]))[0, 0].numpy()
        np.testing.assert_array_equal(pw.intersections_with_shape(
            ShapeType.CUBOID, QUERY_SHAPES["cuboid"][1], pos[0, 0].tolist(), (0, 0, 0, 1)),
            np.flatnonzero(mask))
