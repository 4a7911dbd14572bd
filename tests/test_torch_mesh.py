"""rapier_tpu_torch's mesh narrow phase, mesh mass properties, mesh scene
builds and `compute_mesh_manifolds` against the reference on the CPU.

Inputs are seeded numpy arrays fed to both packages.  The six triangle
functions run on 640 seeded cases, the reference one lane at a time: XLA:CPU
miscompiles its `_triangle_sat` over a batch of lanes (ROADMAP R14), and a
float64 evaluation of the SAT gap holds the port on every cuboid case.
Geometry within 1e-5; feature ids and validity exact.  The capsule's
geometry within 1e-4, and where its ternary search meets a rounding tie
within what the search's last interval leaves open (ROADMAP R13).  The
mid-phase runs on a 2-scene batch whose scenes hold a heightfield and a flat
quad (two triangles of one AABB: a score tie), one of them with more mesh
pairs than `max_mesh_pairs`: lane by lane the colliders, bodies, pair keys,
validity, touching and solver flags are exact.

The degenerate triangles put their third vertex on the first, so their
vanishing terms are exact zeros.  A sliver (distinct collinear vertices, or
a repeated second vertex) is a rounding tie: its region tests compare
differences of products that vanish only in exact arithmetic, and XLA's
fused multiply-adds round them otherwise than the port (ROADMAP R1b), so the
two packages may pick different regions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu.geometry import narrowphase_mesh as jnpm
from rapier_tpu_torch.geometry import narrowphase_mesh as npm
from rapier_tpu_torch.types import ShapeType

N_CASES = 640
GEOM_TOL = 1e-5
CAPSULE_TOL = 1e-4
# The ternary search's last interval: (2/3)**20 of the capsule's segment.
SEARCH_WIDTH = (2.0 / 3.0) ** 20
# Distances this many float32 ulps apart are a rounding tie of the search.
TIE_ULPS = 8


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]])


def _random_quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def triangle_cases(seed=0, n=N_CASES):
    """Seeded (pA, rA, stA, prmA, v0, v1, v2, kind) rows, row-major
    ``[n, ...]``: balls in each Voronoi region of the triangle and at its
    plane's deep centre, capsules at random and parallel to a face, cuboids
    face, edge and vertex down and at random, and degenerate triangles (the
    third vertex on the first).  A ball's centre and a capsule's segment stay
    0.05 or more from the triangle but for the exact deep-centre and parallel
    cases: closer, a normal is the closest point's rounding over that
    distance, in either package."""
    rng = np.random.default_rng(seed)
    rows = []
    regions = ("face", "ab", "bc", "ca", "a", "b", "c")
    for i in range(n):
        group = i % 8
        v = rng.uniform(-2.0, 2.0, (3, 3))
        if group == 7:
            v[2] = v[0]
        tn = np.cross(v[1] - v[0], v[2] - v[0])
        tn = tn / np.linalg.norm(tn) if group != 7 else _random_quat(rng)[:3]
        tn = tn / np.linalg.norm(tn)
        side = rng.choice([-1.0, 1.0])
        rot = _random_quat(rng)
        prm = np.zeros(12)
        if group in (0, 1, 2) or (group == 7 and i % 3 == 0):
            st = ShapeType.BALL
            rad = rng.uniform(0.1, 0.8)
            prm[0] = rad
            region = regions[(i // 8) % 7]
            bary = {"face": rng.dirichlet((2, 2, 2)),
                    "ab": [0.5 + 0.5 * rng.uniform(-0.5, 0.5), 0.5, -0.4],
                    "bc": [-0.4, 0.5, 0.5 + 0.5 * rng.uniform(-0.5, 0.5)],
                    "ca": [0.5, -0.4, 0.5 + 0.5 * rng.uniform(-0.5, 0.5)],
                    "a": [1.4, -0.2, -0.2], "b": [-0.2, 1.4, -0.2],
                    "c": [-0.2, -0.2, 1.4]}[region]
            if group == 7:                       # beyond an end of the degenerate edge
                bary = [(-0.3, 1.3, 0.0), (1.3, -0.3, 0.0)][(i // 8) % 2]
            p = np.asarray(bary, np.float64) @ v + tn * side * rng.uniform(0.05, 1.5 * rad)
            if group == 2 and i % 3 == 0:        # deep centre: on the face, exactly
                v = np.array([[0.0, 0.0, 0.0], [4.0, 0.0, 0.0], [0.0, 0.0, 4.0]])
                v += np.array([rng.integers(-2, 2), 0.0, rng.integers(-2, 2)])
                p = v[0] + np.array([1.0, 0.0, 1.0])
            rows.append((p, rot, st, prm, v, "ball"))
        elif group in (3, 4) or (group == 7 and i % 3 == 1):
            st = ShapeType.CAPSULE
            hh, rad = rng.uniform(0.1, 0.8), rng.uniform(0.1, 0.5)
            prm[:7] = [0.0, -hh, 0.0, 0.0, hh, 0.0, rad]
            off = hh + rng.uniform(0.05, rad + 0.3)
            p = rng.dirichlet((2, 2, 2)) @ v + tn * side * off
            if group == 4 and i % 2 == 0:        # parallel to a flat face, over its interior
                hh = rng.uniform(0.1, 0.5)
                prm[:7] = [-hh, 0.0, 0.0, hh, 0.0, 0.0, rad]
                v = np.array([[-2.0, 0.0, -2.0], [2.0, 0.0, -2.0], [0.0, 0.0, 2.0]])
                p = np.array([rng.uniform(-0.3, 0.3), rad + rng.uniform(-0.1, 0.1),
                              rng.uniform(-0.3, 0.3)])
                rot = np.array([0.0, 0.0, 0.0, 1.0])
            rows.append((p, rot, st, prm, v, "capsule"))
        else:
            st = ShapeType.CUBOID
            he = rng.uniform(0.1, 0.6, 3)
            prm[:3] = he
            p = rng.dirichlet((2, 2, 2)) @ v
            pose = (i // 8) % 4
            if pose < 3 and group != 7:          # face, edge or vertex down, on a flat face
                v = np.array([[-3.0, 0.0, -3.0], [3.0, 0.0, -3.0], [0.0, 0.0, 3.0]])
                rot = (np.array([0.0, 0.0, 0.0, 1.0]), _quat((0.0, 0.0, 1.0), np.pi / 4),
                       _quat((1.0, 0.0, -1.0), np.arctan(np.sqrt(2.0))))[pose]
                reach = (he[1], (he[0] + he[1]) / np.sqrt(2.0), np.linalg.norm(he))[pose]
                p = np.array([rng.uniform(-0.5, 0.5), reach + rng.uniform(-0.1, 0.05),
                              rng.uniform(-0.5, 0.5)])
            else:
                p = p + tn * side * rng.uniform(-0.2, 1.0) * float(np.linalg.norm(he))
            rows.append((p, rot, st, prm, v, "cuboid"))
    f32 = np.float32
    return dict(
        pA=np.stack([r[0] for r in rows]).astype(f32),
        rA=np.stack([r[1] for r in rows]).astype(f32),
        stA=np.array([int(r[2]) for r in rows], np.int32),
        prmA=np.stack([r[3] for r in rows]).astype(f32),
        v0=np.stack([r[4][0] for r in rows]).astype(f32),
        v1=np.stack([r[4][1] for r in rows]).astype(f32),
        v2=np.stack([r[4][2] for r in rows]).astype(f32),
        kind=np.array([r[5] for r in rows]))


@functools.lru_cache(maxsize=None)
def _reference_fns():
    def run(pA, rA, stA, prmA, v0, v1, v2):
        vm = jax.vmap
        return dict(
            closest=vm(jnpm.closest_point_triangle)(pA, v0, v1, v2),
            ball=vm(jnpm.ball_triangle)(pA, rA, prmA, v0, v1, v2),
            capsule=vm(jnpm.capsule_triangle)(pA, rA, prmA, v0, v1, v2),
            sat=vm(jnpm._triangle_sat)(pA, rA, stA, prmA, v0, v1, v2),
            gap=vm(jnpm.triangle_gap)(pA, rA, stA, prmA, v0, v1, v2),
            convex=vm(jnpm.convex_triangle)(pA, rA, stA, prmA, v0, v1, v2))

    return jax.jit(run)


def _reference(args):
    """The reference's six functions on the cases one lane at a time (the
    reference's SAT depends on the batch it runs in, ROADMAP R14), numpy."""
    f = _reference_fns()
    outs = [f(*[jnp.asarray(a[i:i + 1]) for a in args]) for i in range(len(args[0]))]
    return jax.tree.map(lambda *x: np.concatenate([np.asarray(y) for y in x]), *outs)


@functools.lru_cache(maxsize=None)
def kernel_outputs():
    """On the seeded cases, numpy, row-major per case (the port's lane-last
    outputs transposed): the port's six functions and the reference's."""
    c = triangle_cases()
    args = [c[k] for k in ("pA", "rA", "stA", "prmA", "v0", "v1", "v2")]
    ref = _reference(args)

    def lane(x):
        t = torch.from_numpy(x)
        return t if t.dim() == 1 else t.T.contiguous()

    pA, rA, stA, prmA, v0, v1, v2 = (lane(a) for a in args)

    def rows(man):
        return dict(normal=man.normal.T.numpy(), point=man.point.permute(2, 0, 1).numpy(),
                    dist=man.dist.T.numpy(), fid=man.fid.T.numpy(), valid=man.valid.T.numpy())

    sat = npm._triangle_sat(pA, rA, stA, prmA, v0, v1, v2)
    port = dict(
        closest=npm.closest_point_triangle(pA, v0, v1, v2).T.numpy(),
        ball=rows(npm.ball_triangle(pA, rA, prmA, v0, v1, v2)),
        capsule=rows(npm.capsule_triangle(pA, rA, prmA, v0, v1, v2)),
        sat=(sat[0].numpy(), sat[1].T.numpy()),
        gap=npm.triangle_gap(pA, rA, stA, prmA, v0, v1, v2).numpy(),
        convex=rows(npm.convex_triangle(pA, rA, stA, prmA, v0, v1, v2)))
    return c, ref, port


def _sat_f64(c, i):
    """The sampled-SAT gap of case i in float64: the largest over the
    reference's 14 axes (oriented towards the triangle, degenerate ones
    left out) of the triangle's least projection less the cuboid's
    support."""
    p, q, he = (np.asarray(c[k][i], np.float64) for k in ("pA", "rA", "prmA"))
    v = np.stack([np.asarray(c[k][i], np.float64) for k in ("v0", "v1", "v2")])
    x, y, z, w = q
    m = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    center = v.mean(axis=0) - p
    edges = [v[1] - v[0], v[2] - v[1], v[0] - v[2]]
    tn = np.cross(edges[0], v[2] - v[0])
    tn = tn / np.linalg.norm(tn) if np.linalg.norm(tn) > 1e-9 else np.array([0.0, 1.0, 0.0])
    axes = [tn, center] + [a for i in range(3)
                           for a in [m[:, i]] + [np.cross(m[:, i], e) for e in edges]]
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    world = p + (corners * he[:3]) @ m.T
    gaps = []
    for a in axes:
        if np.linalg.norm(a) < 1e-6:
            continue
        a = a / np.linalg.norm(a) * (1.0 if a @ center >= 0 else -1.0)
        gaps.append(np.min(v @ a) - np.max(world @ a))
    return max(gaps)


def test_cases_cover_the_regions():
    """The seeded cases reach every Voronoi region of closest_point_triangle,
    the deep-centre ball, degenerate triangles and all three shapes."""
    c, ref, _ = kernel_outputs()
    q = np.asarray(ref["closest"], np.float64)
    v = np.stack([c["v0"], c["v1"], c["v2"]], axis=1).astype(np.float64)
    at_vertex = np.any(np.all(np.abs(q[:, None] - v) < 1e-6, axis=-1), axis=1)
    assert at_vertex.sum() >= 20 and (~at_vertex).sum() >= 200
    deep = np.linalg.norm(q - c["pA"], axis=-1) < 1e-9
    assert deep[c["kind"] == "ball"].sum() >= 5
    for k in ("ball", "capsule", "cuboid"):
        assert (c["kind"] == k).sum() >= 100
    touching = np.asarray(ref["convex"].dist)[c["kind"] == "cuboid"].min(axis=1) < 0
    assert 20 <= touching.sum() <= (c["kind"] == "cuboid").sum() - 20


def test_closest_point_triangle():
    _, ref, port = kernel_outputs()
    tp.assert_close(port["closest"], ref["closest"], GEOM_TOL, "closest point")


def _capsule_search(c, idx):
    """The capsule's ternary search on the cases `idx`, replayed with the
    port's float32 arithmetic: whether a step compared distances within
    TIE_ULPS of each other (a step that rounding decides), and how far the
    kernel's geometry moves while the segment parameter moves within
    SEARCH_WIDTH of the true minimum of the distance (float64): the largest
    change of the normal, of the three points' distances and of the point-0
    position.  Returns (ties ``[n]``, spreads ``[n, 3]``)."""
    from rapier_tpu_torch.geometry.narrowphase import _norm, _safe_normalize, _transform_point
    from rapier_tpu_torch.math.quat import cross_cl, dot_cl

    def segment(dtype):
        col = {k: torch.from_numpy(np.asarray(c[k][idx], dtype)).T.contiguous()
               for k in ("pA", "rA", "prmA", "v0", "v1", "v2")}
        a = _transform_point(col["pA"], col["rA"], col["prmA"][0:3])
        b = _transform_point(col["pA"], col["rA"], col["prmA"][3:6])
        return a, b, col["prmA"][6], [col[k] for k in ("v0", "v1", "v2")]

    a, b, _, tri = segment(np.float32)
    lo, hi = torch.zeros(len(idx)), torch.ones(len(idx))
    tie = torch.zeros(len(idx), dtype=torch.bool)
    for step in range(20):
        m1 = torch.full_like(lo, npm._THIRD) if step == 0 else lo + (hi - lo) / 3.0
        m2 = torch.full_like(lo, npm._TWO_THIRDS) if step == 0 else hi - (hi - lo) / 3.0
        p = a + (b - a) * torch.stack([m1, m2]).unsqueeze(-2)
        d = _norm(p - npm.closest_point_triangle(p, *tri))
        ulp = torch.from_numpy(np.spacing(torch.maximum(d[0], d[1]).numpy()))
        tie |= (d[0] - d[1]).abs() <= TIE_ULPS * ulp
        go_right = d[0] > d[1]
        lo, hi = torch.where(go_right, m1, lo), torch.where(go_right, hi, m2)

    a, b, rad, tri = segment(np.float64)

    def geometry(t):
        """At the parameters ``t [S, n]``: distance, normal, the three
        points' distances, point 0."""
        p = a + (b - a) * t.unsqueeze(-2)
        q = npm.closest_point_triangle(p, *tri)
        n, d = _safe_normalize(q - p, fallback=cross_cl(tri[1] - tri[0], tri[2] - tri[0])
                               .expand_as(p))
        ends = [dot_cl(npm.closest_point_triangle(e, *tri) - e, n) - rad for e in (a, b)]
        return d, n, torch.stack([dot_cl(q - p, n) - rad] + ends, dim=1), \
            0.5 * (p + n * rad + q)

    f64 = torch.float64
    grid = torch.linspace(0.0, 1.0, 4001, dtype=f64).unsqueeze(1).expand(-1, len(idx))
    t0 = torch.gather(grid, 0, torch.argmin(geometry(grid)[0], dim=0, keepdim=True))
    fine = torch.clamp(t0 + torch.linspace(-2.5e-4, 2.5e-4, 501, dtype=f64).unsqueeze(1), 0, 1)
    t0 = torch.gather(fine, 0, torch.argmin(geometry(fine)[0], dim=0, keepdim=True))
    window = torch.clamp(t0 + torch.linspace(-SEARCH_WIDTH, SEARCH_WIDTH, 41,
                                             dtype=f64).unsqueeze(1), 0.0, 1.0)
    _, n, dists, point = geometry(window)

    def spread(x):
        """Largest change over the window (axis 0) per case (last axis)."""
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        return (x.amax(dim=0) - x.amin(dim=0)).amax(dim=0)

    return tie.numpy(), torch.stack([spread(n), spread(dists), spread(point)], dim=1).numpy()


@pytest.mark.parametrize("kernel,kind,tol", [("ball", "ball", GEOM_TOL),
                                             ("capsule", "capsule", CAPSULE_TOL),
                                             ("convex", "cuboid", GEOM_TOL)])
def test_triangle_kernel(kernel, kind, tol):
    """Each kernel on its shape's cases.  Near a smooth minimum the
    capsule's ternary search may compare distances equal to within rounding,
    and each package's rounding (XLA fuses multiply-adds, ROADMAP R13)
    decides such a step: the search's parameter then ends elsewhere in its
    last interval.  On a case with such a step (about half of them) the
    capsule's geometry is held to CAPSULE_TOL beyond what moving the
    parameter within SEARCH_WIDTH of the minimum moves it
    (`_capsule_search`); on the others to CAPSULE_TOL."""
    c, ref, port = kernel_outputs()
    r, p = ref[kernel], port[kernel]
    idx = np.flatnonzero(c["kind"] == kind)
    tp.assert_equal(p["valid"][idx], np.asarray(r.valid)[idx], f"{kernel}.valid")
    tp.assert_equal(p["fid"][idx], np.asarray(r.fid)[idx], f"{kernel}.fid")
    valid = np.asarray(r.valid)[idx]
    spread = np.zeros((len(idx), 3))
    if kernel == "capsule":
        ties, search = _capsule_search(c, idx)
        spread[ties] = search[ties]
        assert (~ties).sum() >= 50, int(ties.sum())     # the strict tolerance is exercised
    for j, name in enumerate(("normal", "dist", "point")):
        want = np.asarray(getattr(r, name), np.float64)[idx]
        got = p[name][idx].astype(np.float64)
        if name != "normal":     # padding slots hold 1e10 or unused points
            keep = valid.reshape(valid.shape + (1,) * (want.ndim - 2))
            want, got = np.where(keep, want, 0.0), np.where(keep, got, 0.0)
        err = np.abs(got - want).max(axis=tuple(range(1, want.ndim)))
        bad = np.flatnonzero(err > tol + spread[:, j])
        assert bad.size == 0, (f"{kernel}.{name}: cases {idx[bad].tolist()} past the "
                               f"tolerance, errors {err[bad].tolist()}")
    print(f"{kernel}: {len(idx)} cases; {int((spread.max(axis=1) > 0).sum())} with a "
          f"rounding tie in the search, their spread up to {spread.max():.3e}")


def test_triangle_sat_and_gap():
    """The SAT gap and axis; the gap also against a float64 evaluation of
    the same axes on every cuboid case, which the reference called over all
    lanes at once misses on some (ROADMAP R14)."""
    c, ref, port = kernel_outputs()
    tp.assert_close(port["sat"][0], ref["sat"][0], GEOM_TOL, "sat gap")
    tp.assert_close(port["sat"][1], ref["sat"][1], GEOM_TOL, "sat axis")
    tp.assert_close(port["gap"], ref["gap"], GEOM_TOL, "triangle_gap")
    cub = np.flatnonzero(c["kind"] == "cuboid")
    exact = np.array([_sat_f64(c, i) for i in cub])
    tp.assert_close(port["sat"][0][cub], exact, GEOM_TOL, "sat gap vs float64")
    args = [jnp.asarray(c[k]) for k in ("pA", "rA", "stA", "prmA", "v0", "v1", "v2")]
    batched = np.asarray(jax.jit(jax.vmap(jnpm._triangle_sat))(*args)[0])
    off = np.abs(batched[cub] - exact) > GEOM_TOL
    print(f"the reference over all {len(c['kind'])} lanes at once misses the float64 gap on "
          f"{int(off.sum())} of {len(cub)} cuboid cases: {cub[off].tolist()}")


# ---------------------------------------------------------------------------
# Mass properties and scene builds
# ---------------------------------------------------------------------------


def flat_quad_mesh(half=10.0, y=0.0):
    """tests/test_mesh.py's flat quad: two triangles with one AABB."""
    verts = [(-half, y, -half), (half, y, -half), (half, y, half), (-half, y, half)]
    tris = [(0, 2, 1), (0, 3, 2)]
    return verts, tris


def _heightfield3(mod):
    """examples/heightfield3.py's scene with the builders of `mod` (either
    package's world module)."""
    w = mod.PhysicsWorld(**({} if mod.__name__.startswith("rapier_tpu.") else
                            {"device": "cpu"}))
    n = 12
    xs = np.linspace(-8.0, 8.0, n)
    zs = np.linspace(-8.0, 8.0, n)
    heights = np.sin(xs[None, :]) + np.cos(zs[:, None])
    ground = w.insert_body(mod.RigidBodyBuilder.fixed())
    w.insert_collider(mod.ColliderBuilder.heightfield(heights, (16.0, 1.0, 16.0)), ground)
    rng = np.random.RandomState(0)
    for i in range(12):
        x, z = rng.uniform(-4, 4, 2)
        kind = i % 3
        b = w.insert_body(mod.RigidBodyBuilder.dynamic().with_translation((x, 4.0 + (i % 4), z)))
        cb = (mod.ColliderBuilder.ball(0.4) if kind == 0 else
              mod.ColliderBuilder.cuboid(0.35, 0.35, 0.35) if kind == 1 else
              mod.ColliderBuilder.capsule_y(0.25, 0.25))
        w.insert_collider(cb, b)
    return w


def _flat_quad_ball(mod):
    """tests/test_mesh.py::test_ball_rests_on_trimesh's scene."""
    w = mod.PhysicsWorld(**({} if mod.__name__.startswith("rapier_tpu.") else
                            {"device": "cpu"}))
    g = w.insert_body(mod.RigidBodyBuilder.fixed())
    w.insert_collider(mod.ColliderBuilder.trimesh(*flat_quad_mesh()), g)
    b = w.insert_body(mod.RigidBodyBuilder.dynamic().with_translation((0.5, 2, 0.3)))
    w.insert_collider(mod.ColliderBuilder.ball(0.5), b)
    return w


def _port_scene(name):
    import rapier_tpu_torch.world as pw
    from rapier_tpu_torch import scenes

    if name == "heightfield3":
        return scenes.heightfield3_world(device="cpu")[0]
    if name == "trimesh3":
        return scenes.trimesh3_world(device="cpu")[0]
    return _flat_quad_ball(pw)


def _reference_scene(name):
    import rapier_tpu.world as rw

    if name == "heightfield3":
        return _heightfield3(rw)
    if name == "trimesh3":
        w = rw.PhysicsWorld()
        verts = np.array([[-2, 0.5, -2], [0, 0, -2], [2, 0.5, -2],
                          [-2, 0.5, 2], [0, 0, 2], [2, 0.5, 2]], np.float32)
        tris = np.array([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4]], np.int32)
        g = w.insert_body(rw.RigidBodyBuilder.fixed())
        w.insert_collider(rw.ColliderBuilder.trimesh(verts, tris), g)
        b = w.insert_body(rw.RigidBodyBuilder.dynamic().with_translation((0.6, 3, 0)))
        w.insert_collider(rw.ColliderBuilder.ball(0.3), b)
        return w
    return _flat_quad_ball(rw)


def test_mesh_mass_properties():
    """A closed cube and heightfield3's open surface: equal to the
    reference's, float for float."""
    from rapier_tpu.geometry import mass_properties as jmp
    from rapier_tpu_torch.geometry import mass_properties as pmp
    from rapier_tpu_torch.scenes import heightfield3_world

    cube_v = np.array([[x, y, z] for x in (-0.5, 1.5) for y in (-1.0, 1.0)
                       for z in (-0.25, 0.75)], np.float32)
    cube_t = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                       [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                      np.int32)
    field = heightfield3_world(device="cpu")[0]._pending_colliders[0][0].mesh
    for verts, tris, density in ((cube_v, cube_t, 2.5), (*field, 1.0)):
        for convex in (False, True):
            r = jmp.mesh_mass_properties(verts, tris, density, assume_convex=convex)
            p = pmp.mesh_mass_properties(verts, tris, density, assume_convex=convex)
            assert p.mass == r.mass
            for name in ("com", "principal_inertia", "principal_frame"):
                assert np.array_equal(getattr(p, name), getattr(r, name)), name
    assert pmp.mesh_mass_properties(cube_v, cube_t, 2.5).mass == pytest.approx(2.5 * 4.0)


@pytest.mark.parametrize("name", ["heightfield3", "trimesh3", "flat_quad"])
def test_build_matches_reference(name):
    """Every leaf of `build()`, the mesh tables, shape_params and masses
    included, equals the reference's; so do the census and the pair lanes
    with the mesh-lane reservation."""
    pw, rw = _port_scene(name), _reference_scene(name)
    ps, rs = pw.build(), rw.build()
    assert pw.params.shape_types_present == rw.params.shape_types_present
    assert ps.contacts.max_pairs == rs.contacts.max_pairs == 128 + 64 * 8
    for part in ("bodies", "colliders", "contacts", "meshes"):
        r, p = getattr(rs, part), getattr(ps, part)
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            assert a.dtype == d.dtype and np.array_equal(a, d), f"{part}.{f.name}"
    assert ps.meshes.triangles.shape[0] % 8 == 0


def test_build_refuses_pair_keys_past_int32():
    """C**2 * (T + 1) must stay below 2**32: the int32 keys wrap past
    2**31 as the reference's int32 arithmetic does, and would repeat past
    2**32."""
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(collider_capacity=4096, device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.heightfield(np.zeros((13, 13)), (10.0, 1.0, 10.0)), g)
    with pytest.raises(NotImplementedError, match="int32"):
        w.build()


# ---------------------------------------------------------------------------
# The mid-phase and the per-triangle lanes
# ---------------------------------------------------------------------------

MAX_MESH_PAIRS = 4      # scene 1 has 6 mesh pairs: the last 2 are dropped
TRIS_PER_PAIR = 8
QUAD_X = 20.0           # the flat quad's body, far from the heightfield


def _manifold_scene():
    """A fixed heightfield (collider 0), six bodies (colliders 1-6: ball,
    cuboid, capsule, twice) and a fixed flat quad at x = QUAD_X (collider 7,
    after the bodies, so its pairs keep the mesh second).  Returns (port
    world, numpy batch of 2 scenes, the pair buffers c1, c2, valid)."""
    from rapier_tpu_torch.scenes import replicate_scene
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    heights = np.add.outer(np.linspace(0.0, 0.5, 6), np.linspace(0.0, 0.3, 6)) ** 2
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.heightfield(heights, (10.0, 1.0, 10.0)), g)
    shapes = [ColliderBuilder.ball(0.4), ColliderBuilder.cuboid(0.3, 0.25, 0.35),
              ColliderBuilder.capsule_y(0.25, 0.2)] * 2
    for cb in shapes:
        w.insert_collider(cb, w.insert_body(RigidBodyBuilder.dynamic()))
    quad = w.insert_body(RigidBodyBuilder.fixed().with_translation((QUAD_X, 0.0, 0.0)))
    w.insert_collider(ColliderBuilder.trimesh(*flat_quad_mesh(half=4.0)), quad)
    state = replicate_scene(w.build(), 2)

    # Reaches below each body's centre: resting a little into a surface.
    reach = [0.4, 0.25, 0.45] * 2
    verts = w._pending_colliders[0][0].mesh[0]
    rng = np.random.default_rng(7)

    def on_field(b, v):
        x, y, z = verts[v]
        return (x + rng.uniform(-0.05, 0.05), y + reach[b] - 0.01, z + rng.uniform(-0.05, 0.05))

    def on_quad(b, x, z):
        return (QUAD_X + x, reach[b] - 0.01, z)

    far = [(40.0 + 3 * b, 50.0, 0.0) for b in range(6)]
    placed = [[on_field(0, 14), on_quad(1, 0.5, -1.0), on_quad(2, -1.0, 1.5)] + far[3:],
              [on_field(0, 14), on_field(1, 21), on_field(2, 27),
               on_quad(3, 1.0, 1.0), on_quad(4, -2.0, 0.0), on_quad(5, 0.0, -2.0)]]
    rot = np.array([0.0, np.sin(0.2), 0.0, np.cos(0.2)], np.float32)
    for s, poses in enumerate(placed):
        for b, xyz in enumerate(poses):
            for name in ("pos", "next_pos"):
                getattr(state.bodies, name)[s, 1 + b] = xyz
            for name in ("rot", "next_rot"):
                getattr(state.bodies, name)[s, 1 + b] = rot

    p = 32
    c1 = np.full((2, p), -1, np.int32)
    c2 = np.full((2, p), -1, np.int32)
    pairs = [[(1, 2), (2, 7), (0, 1), (3, 7), (4, 5)],
             [(0, 1), (1, 2), (4, 7), (0, 2), (5, 7), (0, 3), (6, 7), (2, 3)]]
    for s, lst in enumerate(pairs):
        for j, (a, b) in enumerate(lst):
            c1[s, 2 * j + 1], c2[s, 2 * j + 1] = a, b    # gaps: compaction keeps pair order
    return w, state, (c1, c2, c1 >= 0)


@functools.lru_cache(maxsize=None)
def mesh_manifolds():
    """Both packages' compute_mesh_manifolds on the 2-scene batch, numpy;
    the reference's compiled with XLA's backend optimisations off (R14)."""
    from rapier_tpu.geometry.dispatch import compute_mesh_manifolds as jcmm
    from rapier_tpu_torch.geometry.dispatch import compute_mesh_manifolds
    from rapier_tpu_torch.types import from_numpy

    w, state, (c1, c2, valid) = _manifold_scene()
    pred = float(w.params.prediction_distance())
    ref_state = tp.to_reference(state)

    def one(s, a, b, v):
        return jcmm(s.bodies, s.colliders, s.meshes, a, b, v, pred, MAX_MESH_PAIRS,
                    TRIS_PER_PAIR)

    args = (jax.tree.map(jnp.asarray, ref_state), c1, c2, valid)
    # XLA's backend optimisations off: they miscompile the vmapped SAT (R14).
    compiled = jax.jit(jax.vmap(one)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    ref = jax.tree.map(np.asarray, compiled(*args))
    ps = from_numpy(state)
    port = compute_mesh_manifolds(
        ps.bodies, ps.colliders, ps.meshes, torch.from_numpy(c1), torch.from_numpy(c2),
        torch.from_numpy(valid), pred, MAX_MESH_PAIRS, TRIS_PER_PAIR)
    return state, ref, jax.tree.map(lambda x: x.numpy(), tuple(port)), port._fields


def test_mesh_manifolds_lane_by_lane():
    """Lane by lane: colliders, bodies, pair keys, validity, touching and
    solver flags exact; the geometry of the ball and cuboid lanes within
    1e-5 (the capsule's is held in test_triangle_kernel)."""
    state, ref, port, fields = mesh_manifolds()
    port = dict(zip(fields, port))
    for name in ("collider1", "collider2", "body1", "body2", "pair_key", "valid",
                 "touching", "solver_pair", "dyn1", "dyn2", "sensor", "rel_dominance",
                 "point_valid", "point_active"):
        tp.assert_equal(port[name], getattr(ref, name), name)
    lane_ok = port["valid"]
    assert port["touching"].sum(axis=1).min() >= 3
    c1 = np.asarray(ref.collider1)
    stA = np.asarray(state.colliders.shape_type)[0][np.where(c1 == 0, ref.collider2, c1)]
    geom = lane_ok & (stA != int(ShapeType.CAPSULE))
    pv = np.asarray(ref.point_valid)
    tp.assert_close(port["normal"].transpose(0, 2, 1)[geom],
                    np.asarray(ref.normal).transpose(0, 2, 1)[geom], GEOM_TOL, "normal")
    tp.assert_close(port["dist"][pv & geom[:, None]],
                    np.asarray(ref.dist)[pv & geom[:, None]], GEOM_TOL, "dist")
    tp.assert_close(port["point"].transpose(0, 1, 3, 2)[pv & geom[:, None]],
                    np.asarray(ref.point).transpose(0, 1, 3, 2)[pv & geom[:, None]],
                    GEOM_TOL, "point")
    tp.assert_equal(port["fid"][pv & geom[:, None]], np.asarray(ref.fid)[pv & geom[:, None]],
                    "fid")


def test_mesh_manifolds_layout_and_ties():
    """The lane layout: max_mesh_pairs x tris_per_pair lanes, row-major by
    (mesh pair, rank), the mesh pairs in pair order, the pairs past
    max_mesh_pairs dropped as the reference drops them (scene 1 keeps 4 of
    its 6); pair keys lo * C + hi + (tri + 1) * C**2.  On the flat quad the
    two triangles' scores tie (one AABB): the lower index ranks first."""
    state, ref, port, fields = mesh_manifolds()
    port = dict(zip(fields, port))
    n_coll = state.colliders.parent.shape[-1]
    key = port["pair_key"].reshape(2, MAX_MESH_PAIRS, TRIS_PER_PAIR).astype(np.int64)
    ok = port["valid"].reshape(key.shape)
    pair_of = np.where(ok, key % (n_coll * n_coll), -1)
    tri = np.where(ok, key // (n_coll * n_coll) - 1, -1)
    # The mesh pairs, in pair-buffer order (scene 1: its first 4 of 6).
    want = [[(2, 7), (0, 1), (3, 7)], [(0, 1), (4, 7), (0, 2), (5, 7)]]
    for s in range(2):
        got = [tuple(divmod(int(k), n_coll)) for k in pair_of[s, :, 0] if k >= 0]
        assert got == want[s], (s, got)
    assert not ok[0, 3].any()
    # The flat quad's triangles: both candidates, the lower index first.
    quad_start = int(np.asarray(state.colliders.shape_params)[0, 7, 0])
    tris = np.asarray(state.meshes.triangles)[0]
    verts = np.asarray(state.meshes.vertices)[0]
    box = [(verts[tris[quad_start + t]].min(0), verts[tris[quad_start + t]].max(0))
           for t in (0, 1)]
    assert all(np.array_equal(a, b) for a, b in zip(*box))     # a tie
    for s, lane in ((0, 0), (0, 2), (1, 1), (1, 3)):
        assert tri[s, lane, :2].tolist() == [quad_start, quad_start + 1], (s, lane, tri[s, lane])
        assert not ok[s, lane, 2:].any()
    # Each (pair, triangle) key is unique: the warmstart join matches them.
    for s in range(2):
        k = port["pair_key"][s][port["valid"][s]]
        assert len(np.unique(k)) == len(k)


def test_mesh_aabbs_match_reference():
    """`shapes.compute_aabbs`' mesh branch (the local AABB of
    shape_params[2:8], re-boxed in the world) against the reference's, on
    heightfield3's and the flat quad's mesh rows at seeded poses."""
    from rapier_tpu.geometry import shapes as jshapes
    from rapier_tpu_torch.geometry import shapes

    rows = []
    for name in ("heightfield3", "flat_quad"):
        st = _port_scene(name).build().colliders
        rows.append((np.asarray(st.shape_type)[0], np.asarray(st.shape_params)[0]))
    st = np.array([t for t, _ in rows] * 32, np.int32)
    prm = np.stack([p for _, p in rows] * 32).astype(np.float32)
    assert set(st.tolist()) == {int(ShapeType.HEIGHTFIELD), int(ShapeType.TRIMESH)}
    rng = np.random.default_rng(3)
    pos = rng.uniform(-5.0, 5.0, (len(st), 3)).astype(np.float32)
    rot = np.stack([_random_quat(rng) for _ in st]).astype(np.float32)
    ref = jax.jit(jshapes.compute_aabbs)(*(jnp.asarray(x) for x in (st, prm, pos, rot)))
    port = shapes.compute_aabbs(*(torch.from_numpy(x) for x in (st, prm, pos, rot)))
    for r, p, what in zip(ref, port, ("mins", "maxs")):
        tp.assert_close(p.numpy(), np.asarray(r), GEOM_TOL, what)
