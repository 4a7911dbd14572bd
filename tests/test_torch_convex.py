"""rapier_tpu_torch's generic convex shapes against rapier_tpu on the CPU.

Kernels, on `test_torch_common.convex_pairs`' seeded lanes (every ordered
pair of `narrowphase_convex.SUPPORTED` types, round shapes and two hulls
included; separated, deep, near and exactly touching), the port on all
lanes at once, the reference one lane at a time:

- `convex_convex` (the manifold: validity of each point exact, the normal
  within 2e-3, the points' distances within 1e-4 and positions within 5e-3,
  the feature ids of the valid points exact) and `support_gap` (the gap
  within 1e-4);
- `convex_halfspace` for every type the reference's generic halfspace
  kernel takes (hulls included) against a seeded plane, and
  `convex_triangle` (with `_triangle_sat`'s border) for every SUPPORTED
  type against a seeded triangle, held the same way.

A lane that differs is held to witnesses as in tests/test_torch_gjk.py
(the reference from starts 1 ulp apart; the support patch picks vertices of
flat features by the sign of components that are zero up to rounding): it
passes if the port agrees with one, or if the reference itself is unstable
there, for at most 5% of the lanes.

Host side, exactly or to float32 rounding: `support_point` and
`compute_aabbs` for every type, the mass properties of every new builder
(through a built scene holding one of each), `_build_hull` against the
reference's, `_expand_collider` for compound, polyline, voxels and
convex_decomposition, `from_numpy` of a reference state with a hull table,
ROADMAP R15 (a hull against a trimesh is its centre plus its border, in
both packages), and `PhysicsWorld2D` with `segment` and `convex_hull`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common as tp
import rapier_tpu.world as rw
from rapier_tpu.geometry import narrowphase as rnp
from rapier_tpu.geometry import narrowphase_convex as rnc
from rapier_tpu.geometry import narrowphase_mesh as rnm
from rapier_tpu.geometry import shapes as rshapes
from rapier_tpu_torch.geometry import narrowphase as pnp
from rapier_tpu_torch.geometry import narrowphase_convex as pnc
from rapier_tpu_torch.geometry import narrowphase_mesh as pnm
from rapier_tpu_torch.geometry import shapes as pshapes
from rapier_tpu_torch.types import ShapeType
import rapier_tpu_torch.world as pw

KEYS = ("pA", "rA", "stA", "prmA", "pB", "rB", "stB", "prmB")
TOL_DIST, TOL_NORMAL, TOL_POINT = 1e-4, 2e-3, 5e-3
UNSTABLE_SHARE = 0.05


def _manifold_close(o, r):
    """(normal, point, dist, fid, valid) of one lane, port vs reference."""
    n, pt, d, fid, valid = o
    rn, rpt, rd, rfid, rvalid = r
    if not np.array_equal(valid, rvalid) or np.abs(n - rn).max() > TOL_NORMAL:
        return False
    v = valid.astype(bool)
    return (np.abs(d[v] - rd[v]).max(initial=0.0) <= TOL_DIST
            and np.abs(pt[v] - rpt[v]).max(initial=0.0) <= TOL_POINT
            and np.array_equal(fid[v], rfid[v]))


def _as_np(man):
    return [np.asarray(x) for x in (man.normal, man.point, man.dist, man.fid, man.valid)]


def _assert_verdicts(verdict, what):
    bad = np.flatnonzero(verdict == "differs")
    assert bad.size == 0, f"{what}: lanes {bad.tolist()} differ from the reference"
    assert np.mean(verdict == "unstable") <= UNSTABLE_SHARE, \
        (what, np.unique(verdict, return_counts=True))


# ---------------------------------------------------------------------------
# convex_convex and support_gap
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pairs():
    lanes, hulls, case = tp.convex_pairs(3)
    hA = tp.lane_hulls(lanes["stA"], lanes["prmA"], hulls)
    hB = tp.lane_hulls(lanes["stB"], lanes["prmB"], hulls)
    return lanes, hA, hB, case


def test_convex_convex_matches_reference():
    lanes, hA, hB, case = _pairs()
    ref_fn = jax.jit(rnc.convex_convex)

    def ref_lane(l, i):
        return _as_np(ref_fn(*[jnp.asarray(l[k][i]) for k in KEYS],
                             jnp.asarray(hA[i]), jnp.asarray(hB[i])))

    port = _as_np(pnc.convex_convex(*[torch.from_numpy(lanes[k]) for k in KEYS],
                                    torch.from_numpy(hA), torch.from_numpy(hB)))
    verdict = tp.witness_verdicts(lanes, ref_lane, port, _manifold_close)
    _assert_verdicts(verdict, "convex_convex")
    # The deepest point carries the exact gap: on every separated lane it
    # agrees with the reference's without a witness.
    for i in np.flatnonzero(case == "separated"):
        r = ref_lane(lanes, i)
        assert abs(port[2][i][port[4][i]].min() - r[2][r[4]].min()) <= TOL_DIST
    assert np.mean(verdict == "agree") >= 0.85


def test_support_gap_matches_reference():
    lanes, hA, hB, case = _pairs()
    ref_fn = jax.jit(rnc.support_gap)
    gap, axis = pnc.support_gap(*[torch.from_numpy(lanes[k]) for k in KEYS],
                                torch.from_numpy(hA), torch.from_numpy(hB))
    n_axis = 0
    for i in range(len(case)):
        rg, ra = ref_fn(*[jnp.asarray(lanes[k][i]) for k in KEYS],
                        jnp.asarray(hA[i]), jnp.asarray(hB[i]))
        assert abs(float(gap[i]) - float(rg)) <= TOL_DIST, (i, float(gap[i]), float(rg))
        n_axis += np.abs(axis[i].numpy() - np.asarray(ra)).max() <= TOL_NORMAL
    # Axes of equal gap (an unrotated pair's frame axes) tie.
    assert n_axis >= 0.95 * len(case), n_axis


# ---------------------------------------------------------------------------
# convex_halfspace and convex_triangle (the port's lane-last kernels)
# ---------------------------------------------------------------------------

HALFSPACE_TYPES = tuple(int(t) for t in pnc.SUPPORTED)


def _cl(x):
    """Lane-first ``[L, ...]`` numpy -> the port's lane-last tensor."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if t.dim() == 1 else t.movedim(0, -1)


def _lane_first(man):
    return [np.asarray(x.movedim(-1, 0)) for x in
            (man.normal, man.point, man.dist, man.fid, man.valid)]


@functools.lru_cache(maxsize=None)
def _halfspace_lanes():
    """Every halfspace-kernel type (4 lanes each): A in a seeded pose just
    above, touching or sunk into a seeded plane through B's origin."""
    lanes, hulls, _ = tp.convex_pairs(4, ("near",))
    keep = np.isin(lanes["stA"], HALFSPACE_TYPES)
    lanes = {k: v[keep][::3].copy() for k, v in lanes.items()}
    rng = np.random.default_rng(4)
    n = len(lanes["stA"])
    normal = rng.normal(size=(n, 3)) * [0.3, 1.0, 0.3]
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    lanes["prmB"] = np.zeros((n, 12), np.float32)
    lanes["prmB"][:, :3] = normal
    lanes["stB"] = np.full(n, int(ShapeType.HALFSPACE), np.int32)
    lanes["pB"] = (lanes["pA"] - normal * rng.uniform(0.0, 1.5, (n, 1))).astype(np.float32)
    return lanes, tp.lane_hulls(lanes["stA"], lanes["prmA"], hulls)


def test_convex_halfspace_matches_reference():
    lanes, hA = _halfspace_lanes()
    ref_fn = jax.jit(rnp.convex_halfspace)
    args = ("pA", "rA", "stA", "prmA", "pB", "rB", "prmB")

    def ref_lane(l, i):
        return _as_np(ref_fn(*[jnp.asarray(l[k][i]) for k in args], jnp.asarray(hA[i])))

    port = _lane_first(pnp.convex_halfspace(*[_cl(lanes[k]) for k in args],
                                            torch.from_numpy(hA)))
    verdict = tp.witness_verdicts(lanes, ref_lane, port, _manifold_close,
                                  nudge=(("pA", 3), ("rA", 4)))
    _assert_verdicts(verdict, "convex_halfspace")
    assert set(np.unique(lanes["stA"])) == set(HALFSPACE_TYPES)
    assert np.mean(verdict == "agree") >= 0.9


@functools.lru_cache(maxsize=None)
def _triangle_lanes():
    """Every SUPPORTED type (4 lanes each) against a seeded triangle near
    its centre."""
    lanes, hulls, _ = tp.convex_pairs(5, ("near",))
    lanes = {k: v[::3].copy() for k, v in lanes.items()}
    rng = np.random.default_rng(5)
    n = len(lanes["stA"])
    c = lanes["pA"] + rng.normal(0, 0.6, (n, 3))
    for k, name in enumerate(("v0", "v1", "v2")):
        lanes[name] = (c + rng.normal(0, 1.0, (n, 3))).astype(np.float32)
    return {k: lanes[k] for k in ("pA", "rA", "stA", "prmA", "v0", "v1", "v2")}


def test_convex_triangle_matches_reference():
    lanes = _triangle_lanes()
    ref_fn = jax.jit(rnm.convex_triangle)
    args = ("pA", "rA", "stA", "prmA", "v0", "v1", "v2")

    def ref_lane(l, i):
        return _as_np(ref_fn(*[jnp.asarray(l[k][i]) for k in args]))

    port = _lane_first(pnm.convex_triangle(*[_cl(lanes[k]) for k in args]))
    verdict = tp.witness_verdicts(lanes, ref_lane, port, _manifold_close,
                                  nudge=(("pA", 3), ("rA", 4)))
    _assert_verdicts(verdict, "convex_triangle")
    assert np.mean(verdict == "agree") >= 0.9


# ---------------------------------------------------------------------------
# support points, AABBs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hull", [False, True])
def test_support_point_matches_reference(hull):
    lanes, hulls, _ = tp.convex_pairs(6, ("near",))
    rng = np.random.default_rng(6)
    st, prm = lanes["stA"], lanes["prmA"]
    tri = st == int(ShapeType.CONE)          # some lanes as triangles too
    st = np.where(tri & (rng.random(len(st)) < 0.5), int(ShapeType.TRIANGLE), st).astype(np.int32)
    prm = np.where((st == int(ShapeType.TRIANGLE))[:, None],
                   rng.normal(size=prm.shape).astype(np.float32), prm)
    d = rng.normal(size=(len(st), 3)).astype(np.float32)
    d[::7, 1] = 0.0                          # directions in the xz plane
    h = tp.lane_hulls(st, prm, hulls) if hull else None
    ref = np.asarray(rshapes.support_point(jnp.asarray(st), jnp.asarray(prm), jnp.asarray(d),
                                           None if h is None else jnp.asarray(h)))
    port = pshapes.support_point(torch.from_numpy(st), torch.from_numpy(prm),
                                 torch.from_numpy(d), None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)


def test_compute_aabbs_matches_reference():
    lanes, _, _ = tp.convex_pairs(7, ("near",))
    rng = np.random.default_rng(7)
    st = np.concatenate([lanes["stA"], np.arange(14, dtype=np.int32)])
    prm = np.concatenate([lanes["prmA"], rng.uniform(0.2, 1.0, (14, 12)).astype(np.float32)])
    prm[:, 2:8] = np.where(st[:, None] == int(ShapeType.CONVEX),
                           np.sort(rng.normal(size=(len(st), 2, 3)), 1).reshape(-1, 6),
                           prm[:, 2:8])
    pos = rng.normal(size=(len(st), 3)).astype(np.float32)
    rot = tp._random_quat(rng, (len(st),)).astype(np.float32)
    ref = rshapes.compute_aabbs(*[jnp.asarray(x) for x in (st, prm, pos, rot)])
    port = pshapes.compute_aabbs(*[torch.from_numpy(x) for x in (st, prm, pos, rot)])
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# Builders, hulls, compounds, mass properties
# ---------------------------------------------------------------------------

CLOUD = np.random.default_rng(8).normal(size=(80, 3)) * [1.0, 0.5, 0.7]
L_VERTS = np.array([(x, y, z) for x in (-1.0, 1.0) for y in (-0.25, 0.25) for z in (-0.25, 0.25)]
                   + [(x, y, z) for x in (-1.0, -0.5) for y in (0.25, 1.25)
                      for z in (-0.25, 0.25)])
L_FACES = np.array([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
                    (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)])
L_FACES = np.concatenate([L_FACES, L_FACES + 8])


def _builders(CB):
    """One collider builder of every new kind (the package's own
    ColliderBuilder `CB`), in a fixed order."""
    ident = (0.0, 0.0, 0.0, 1.0)
    return [
        CB.round_cuboid(0.4, 0.3, 0.5, 0.1),
        CB.segment((0.0, -0.5, 0.0), (0.2, 0.5, 0.1)),
        CB.cylinder(0.5, 0.4),
        CB.round_cylinder(0.5, 0.4, 0.05),
        CB.cone(0.6, 0.5),
        CB.round_cone(0.6, 0.5, 0.05),
        CB.convex_hull(CLOUD).with_density(2.0),
        CB.round_convex_hull(tp.convex_hull_table()[1][:6], 0.05),
        CB.convex_mesh([(x, y, z) for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]),
        CB.compound([((0.3, 0.0, 0.0), (0.0, 0.0, 0.3826834, 0.9238795), CB.cuboid(0.3, 0.1, 0.1)),
                     ((-0.3, 0.1, 0.0), ident, CB.ball(0.2)),
                     ((0.0, 0.0, 0.4), (0.0, 0.0, 0.0), CB.compound([
                         ((0.0, 0.2, 0.0), ident, CB.cone(0.2, 0.1))]))]
                    ).with_translation((0.1, 0.2, 0.0)).with_rotation((0.0, 0.3, 0.0)),
        CB.polyline([(0, 0, 0), (1, 0, 0), (2, 1, 0), (2, 1, 1)]),
        CB.voxels([(x * 0.5, 0.0, 0.0) for x in range(4)] + [(0.0, 0.5, 0.0), (1.0, 0.5, 0.0)], 0.5),
        CB.voxels_from_points(CLOUD, 0.5),
        CB.convex_decomposition(L_VERTS, L_FACES, max_parts=4),
    ]


def _zoo_state(mod):
    """A scene with one body per builder of `_builders` in package `mod`
    (its world module), the port's on the CPU; returns the built numpy
    state."""
    kw = {"device": "cpu"} if mod is pw else {}
    w = mod.PhysicsWorld(**kw)
    g = w.insert_body(mod.RigidBodyBuilder.fixed().with_translation((0.0, -1.0, 0.0)))
    w.insert_collider(mod.ColliderBuilder.cuboid(20.0, 1.0, 20.0), g)
    for i, cb in enumerate(_builders(mod.ColliderBuilder)):
        b = w.insert_body(mod.RigidBodyBuilder.dynamic().with_translation((3.0 * i, 2.0, 0.0)))
        w.insert_collider(cb, b)
    return w.build(), w


@pytest.mark.parametrize("part", ["bodies", "colliders", "hulls"])
def test_built_scene_matches_reference(part):
    """Every builder's leaves, parameters (the hull rows [hull, border,
    AABB]), transforms and the bodies' mass properties, and the hull table,
    equal the reference's build: exactly, or the float32 rounding of the
    float64 mass computations."""
    rs, _ = _zoo_state(rw)
    ps, _ = _zoo_state(pw)
    r, p = getattr(rs, part), getattr(ps, part)
    for f in dataclasses.fields(p):
        a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
        assert a.shape == d.shape, (f.name, a.shape, d.shape)
        if np.issubdtype(d.dtype, np.floating):
            np.testing.assert_allclose(a, d, rtol=1e-6, atol=1e-7, err_msg=f"{part}.{f.name}")
        else:
            assert np.array_equal(a.astype(np.int64), d.astype(np.int64)), f"{part}.{f.name}"
    if part == "bodies":
        assert (np.asarray(p.inv_mass)[1:15] > 0).sum() >= 12    # the massive builders


def test_census_holds_every_leaf_type():
    _, w = _zoo_state(pw)
    _, rw_ = _zoo_state(rw)
    assert w.params.shape_types_present == tuple(rw_.params.shape_types_present)


@pytest.mark.parametrize("points", [CLOUD, tp.convex_hull_table()[1][:6], L_VERTS])
def test_build_hull_matches_reference(points):
    for a, b in zip(pw._build_hull(points, 32), rw._build_hull(points, 32)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["compound", "polyline", "voxels", "convex_decomposition"])
def test_expand_collider_matches_reference(kind):
    """The same leaves in the same order: type, parameters, translation,
    rotation, hull points."""
    idx = {"compound": 9, "polyline": 10, "voxels": 11, "convex_decomposition": 13}[kind]
    port_leaves = pw.PhysicsWorld(device="cpu")._expand_collider(_builders(pw.ColliderBuilder)[idx])
    ref_leaves = rw.PhysicsWorld()._expand_collider(_builders(rw.ColliderBuilder)[idx])
    assert len(port_leaves) == len(ref_leaves) >= 2
    for p, r in zip(port_leaves, ref_leaves):
        assert int(p.shape_type) == int(r.shape_type)
        np.testing.assert_array_equal(np.asarray(p.shape_params, np.float64),
                                      np.asarray(r.shape_params, np.float64))
        np.testing.assert_allclose(p.translation, r.translation, rtol=0, atol=1e-12)
        np.testing.assert_allclose(p.rotation, r.rotation, rtol=0, atol=1e-12)
        rp = getattr(r, "_hull_points", None)
        assert (p.hull_points is None) == (rp is None)
        if rp is not None:
            assert np.array_equal(p.hull_points, rp)


def test_from_numpy_carries_the_hull_table():
    from rapier_tpu_torch.types import from_numpy, to_numpy

    rs, _ = _zoo_state(rw)
    assert rs.hulls is not None
    ps = from_numpy(rs)
    assert torch.equal(ps.hulls.vertices, torch.from_numpy(np.asarray(rs.hulls.vertices)))
    back = to_numpy(ps)
    assert np.array_equal(back.hulls.vertices, np.asarray(rs.hulls.vertices))
    ref = tp.to_reference(ps)
    assert np.array_equal(np.asarray(ref.hulls.vertices), np.asarray(rs.hulls.vertices))


# ---------------------------------------------------------------------------
# ROADMAP R15: a hull against a mesh
# ---------------------------------------------------------------------------


def _hull_on_mesh(mod):
    kw = {"device": "cpu"} if mod is pw else {}
    w = mod.PhysicsWorld(**kw)
    g = w.insert_body(mod.RigidBodyBuilder.fixed())
    verts = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32)
    w.insert_collider(mod.ColliderBuilder.trimesh(verts, np.array([[0, 2, 1], [0, 3, 2]])), g)
    b = w.insert_body(mod.RigidBodyBuilder.dynamic().with_translation((0.3, 0.4, 0.2)))
    w.insert_collider(mod.ColliderBuilder.round_convex_hull(
        [(x, y, z) for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)], 0.05), b)
    w.params = w.params.replace(solver_backend="pallas")
    return w


def test_hull_against_a_mesh_is_its_centre_plus_border():
    """R15: the reference passes no hull table to the mesh kernels, so a
    CONVEX collider's support there is zero: the unit cube at height 0.4 is
    a point at its centre plus its 0.05 border, 0.35 above the quad (not
    0.5 into it).  The port computes the same manifold."""
    import rapier_tpu.geometry.dispatch as rd
    import rapier_tpu_torch.geometry.dispatch as pd
    rws = _hull_on_mesh(rw)
    rs = jax.tree.map(jnp.asarray, rws.build())
    pws = _hull_on_mesh(pw)
    pws.build()
    ps = pws.state
    c1 = np.full(64, -1, np.int32)
    c2 = np.full(64, -1, np.int32)
    c1[0], c2[0] = 0, 1
    valid = c1 >= 0
    ref = rd.compute_mesh_manifolds(rs.bodies, rs.colliders, rs.meshes, jnp.asarray(c1),
                                    jnp.asarray(c2), jnp.asarray(valid), 0.002, 4, 2)
    port = pd.compute_mesh_manifolds(ps.bodies, ps.colliders, ps.meshes,
                                     torch.from_numpy(c1)[None].long(),
                                     torch.from_numpy(c2)[None].long(),
                                     torch.from_numpy(valid)[None], 0.002, 4, 2)
    rv = np.asarray(ref.point_valid)
    assert rv.any()
    np.testing.assert_array_equal(port.point_valid[0].numpy(), rv)
    np.testing.assert_allclose(port.dist[0].numpy()[rv], np.asarray(ref.dist)[rv], atol=1e-6)
    np.testing.assert_allclose(port.normal[0].numpy(), np.asarray(ref.normal), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.dist)[rv], 0.35, atol=1e-5)


# ---------------------------------------------------------------------------
# The 2D builders
# ---------------------------------------------------------------------------


def _polygon_world(mod2d):
    kw = {"device": "cpu"} if mod2d.__name__.startswith("rapier_tpu_torch") else {}
    w = mod2d.PhysicsWorld2D(**kw)
    g = w.insert_body(mod2d.RigidBodyBuilder2D.fixed())
    w.insert_collider(mod2d.ColliderBuilder2D.segment((-5.0, 0.0), (5.0, 0.0)), g)
    b = w.insert_body(mod2d.RigidBodyBuilder2D.dynamic().with_translation((0.0, 1.0)))
    w.insert_collider(mod2d.ColliderBuilder2D.convex_hull(
        [(0.0, 0.0), (1.0, 0.0), (1.2, 0.8), (0.2, 1.0)]).with_density(1.5), b)
    c = w.insert_body(mod2d.RigidBodyBuilder2D.dynamic().with_translation((3.0, 1.0)))
    w.insert_collider(mod2d.ColliderBuilder2D.segment((0.0, 0.0), (1.0, 0.5)), c)
    w.insert_collider(mod2d.ColliderBuilder2D.ball(0.3), c)
    return w


def test_2d_segment_and_polygon_match_reference():
    """The polygon's 2D mass properties (area density, the centroid as the
    centre of mass) and a segment-carrying body's 3D ones equal the
    reference's; the state builds identically."""
    import rapier_tpu.world2d as rw2
    import rapier_tpu_torch.world2d as pw2

    rs = _polygon_world(rw2).build()
    ps = _polygon_world(pw2).build()
    for f in ("inv_mass", "local_com", "inv_principal_inertia", "principal_frame"):
        np.testing.assert_allclose(np.asarray(getattr(ps.bodies, f)),
                                   np.asarray(getattr(rs.bodies, f)), rtol=1e-6, atol=1e-7,
                                   err_msg=f)
    for f in ("shape_type", "shape_params", "local_pos"):
        np.testing.assert_array_equal(np.asarray(getattr(ps.colliders, f)),
                                      np.asarray(getattr(rs.colliders, f)))
    np.testing.assert_array_equal(ps.hulls.vertices, np.asarray(rs.hulls.vertices))


def test_heightfield3_full_keys_wrap_as_the_reference():
    """Upstream's heightfield3 with its compounds (1,665 colliders, capacity
    1,672, and 800 triangles) has mesh pair keys past 2**31: the port builds
    it, and its int64 keys cast to int32 wrap exactly as the reference's
    int32 arithmetic does, ``lo * C + hi + (tri + 1) * C * C``."""
    from rapier_tpu_torch.scenes import heightfield3_full_world

    w, handles = heightfield3_full_world(device="cpu")
    st = w.build()
    c, t = st.colliders.parent.shape[0], st.meshes.triangles.shape[0]
    assert (c, t) == (1672, 800) and 2**31 <= c * c * (t + 1) < 2**32
    assert w.params.max_mesh_pairs == 1664 and len(handles["bodies"]) == 1280
    lo, hi, tri = np.array([0, 5, 0]), np.array([1, 1600, 1664]), np.array([0, 767, 799])
    with np.errstate(over="ignore"):
        ref = (lo.astype(np.int32) * np.int32(c) + hi.astype(np.int32)
               + (tri.astype(np.int32) + np.int32(1)) * np.int32(c) * np.int32(c))
    port = (torch.from_numpy(lo) * c + torch.from_numpy(hi)
            + (torch.from_numpy(tri) + 1) * (c * c)).to(torch.int32)
    assert np.array_equal(port.numpy(), ref) and (ref < 0).any()
