"""rapier_tpu_torch's ray and point queries (geometry/queries.py) against
rapier_tpu.geometry.queries on the CPU.

Inputs: `test_torch_common.query_zoo`, one collider of every query shape
type (rotated, round shapes, a heightfield, a trimesh, a tilted halfspace),
built by the reference's builders and fed to both packages, and 512 seeded
rays and points aimed at each shape type.  The hull sits in a scene of its
own with a ball and the halfspace (the reference runs a hull's GJK on every
collider lane once a scene holds a hull, which would cost minutes here).
The reference runs `jax.vmap` over the queries of one compiled function;
the port takes them as one ``[1, R, 3]`` batch.

Tolerances: toi, points and distances 1e-5 relative (a hit point's scale
is its ray's length and origin), hit flags and collider indices exact,
analytic normals 1e-4 times that scale (a normal is a hit point's offset
over a radius).  A row that differs is held to witnesses, the reference run
from inputs 1 ulp apart, as tests/test_torch_gjk.py does (ROADMAP R16): it
passes if the port agrees with one of them, or if the reference itself
parts from them there (at most 5% of the rows).

A hull's ray normal is GJK's at 1e-4 outside the hit point, which near an
edge or a vertex is not one direction: the reference's own witnesses part
on ~18% of the rays.  So the port's hull normals are held to geometry
instead: each is a unit vector of a plane through the hit point that
supports the hull (a ray starting inside the hull hits at 0, where GJK's
normal is no direction in either package: those rows are not checked).
The reference negates GJK's outward normal there (queries.py:305), so a
hull's ray normal points into the hull, unlike every other shape's; the
port copies it (ROADMAP R29).  A point inside the hull projects by EPA, whose 10
float32 iterations do not always converge on the hull's 16 faces, in
either package (R16): the rows where the reference's depth is not the
exact one (the hull's face planes) are left out of the parity check and
the port's depth is held to be no deeper than the exact one there.

The reference's own checks of tests/test_queries.py and
tests/test_world_api.py run on the port's `PhysicsWorld` in
tests/test_torch_queries_checks.py.  This file keeps to 8 tests (one a
scene and query kind): the tier-1 run (`--dist loadfile`) hands out the
files with the most tests first, and a heavy file with more than 8 would
go before tests/test_mjcf.py (8 tests), the run's longest.
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
from rapier_tpu_torch.types import from_numpy

PER_TARGET = 512
ALL = [t[0] for t in tp.query_zoo("rapier_tpu")[1]]
# The hull's scene holds a ball and the halfspace beside it; its rays and
# points aim at the hull only.
SCENES = {"analytic": tuple(k for k in ALL if k != "hull"),
          "hull": ("ball", "hull", "halfspace")}
AIMED = {"analytic": SCENES["analytic"], "hull": ("hull",)}


@functools.lru_cache(maxsize=None)
def zoo_states(scene):
    """(reference world, its numpy state, the same state as a port batch of
    one, the aimed-at targets) of one of SCENES."""
    w, targets = tp.query_zoo("rapier_tpu", SCENES[scene])
    s = w.state
    return w, s, from_numpy(replicate_scene(s, 1)), [t for t in targets
                                                     if t[0] in AIMED[scene]]


def _port_np(x):
    return x[0].numpy()


def names(scene):
    """The colliders of a scene, in order."""
    return [t[0] for t in tp.query_zoo("rapier_tpu", SCENES[scene])[1]]


def _rel(x):
    return tp.QUERY_TOL * np.maximum(1.0, np.abs(np.asarray(x, np.float64)))


@functools.lru_cache(maxsize=None)
def ray_results(scene):
    """(rays (origin, direction, target index), the reference's (cast_ray,
    intersect_ray) on them and on their 1-ulp witnesses, the port's)."""
    _, s, ps, targets = zoo_states(scene)
    o, d, which = tp.aimed_rays(targets, PER_TARGET, seed=3)

    @jax.jit
    def ref(o, d):
        def one(o1, d1):
            kw = dict(meshes=s.meshes, hulls=s.hulls)
            return (jq.cast_ray(s.bodies, s.colliders, o1, d1, **kw),
                    jq.intersect_ray(s.bodies, s.colliders, o1, d1, **kw))
        return jax.vmap(one)(o, d)

    r = jax.tree.map(np.asarray, ref(jnp.asarray(o), jnp.asarray(d)))
    kw = dict(meshes=ps.meshes, hulls=ps.hulls)
    ot, dt = torch.from_numpy(o)[None], torch.from_numpy(d)[None]
    port = (pq.cast_ray(ps.bodies, ps.colliders, ot, dt, **kw),
            pq.intersect_ray(ps.bodies, ps.colliders, ot, dt, **kw))
    # Witnesses for the rows where any value differs beyond 1e-5 (the
    # hulls' normals aside: they are held to geometry).
    hull = np.zeros(r[1][2].shape[1], bool)
    hull[:len(names(scene))] = [n == "hull" for n in names(scene)]
    nrm = np.where(hull[None, :, None], 0.0, r[1][2])
    p_nrm = np.where(hull[None, :, None], 0.0, _port_np(port[1][2]))
    fields = [(_port_np(port[0].hit), r[0].hit), (_port_np(port[0].collider), r[0].collider),
              (_port_np(port[0].toi), r[0].toi), (_port_np(port[0].point), r[0].point),
              (_port_np(port[1][0]), r[1][0]), (_port_np(port[1][1]), r[1][1]), (p_nrm, nrm)]
    bad = ~tp.rows_close([f[0] for f in fields], [f[1] for f in fields],
                         [0, 0] + [tp.QUERY_TOL * np.maximum(1.0, np.abs(f[1]).reshape(
                             len(o), -1).max(axis=1)) for f in fields[2:]])
    wit = tp.lazy_witnesses(ref, (o, d), r, bad)
    return (o, d, which), r, wit, port


def _ray_scale(o, d, hit, toi):
    """A hit point's scale: its origin and its ray's length up to the hit."""
    return np.maximum(np.abs(o).max(axis=1), np.where(hit, toi, 0.0) * np.linalg.norm(d, axis=1))


def _ray_tols(o, d, hit, toi, hull: bool):
    """hit, collider exact; toi and point 1e-5 of the scale; normals 1e-4 of
    it (GJK_NORMAL_TOL on a hull)."""
    scale = np.maximum(1.0, _ray_scale(o, d, hit, toi))
    normal = tp.GJK_NORMAL_TOL if hull else tp.QUERY_NORMAL_TOL * scale
    return 0, tp.QUERY_TOL * scale, normal


def _hull_planes(scene):
    """The hull collider's exact face planes in world space ``[F, 4]`` (n,
    d with n.x + d <= 0 inside) and its world vertices."""
    from scipy.spatial import ConvexHull

    from rapier_tpu_torch.geometry.dispatch import collider_world_poses
    from rapier_tpu_torch.math import quat

    _, _, ps, _ = zoo_states(scene)
    c = names(scene).index("hull")
    w_pos, w_rot = collider_world_poses(ps.bodies, ps.colliders)
    hv = ps.hulls.vertices[0, int(ps.colliders.shape_params[0, c, 0])]
    world = (w_pos[0, c] + quat.rotate(w_rot[0, c].expand(len(hv), 4), hv)).numpy()
    world = world.astype(np.float64)
    return ConvexHull(world).equations, world


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rays_match_reference(scene):
    """cast_ray at each target of the scene, then intersect_ray."""
    for target in AIMED[scene]:
        _cast_ray_at(scene, target)
    _intersect_ray(scene)


def _cast_ray_at(scene, target):
    (o, d, which), (r, _), wit, (p, _) = ray_results(scene)
    rows = which == AIMED[scene].index(target)
    _, t_tol, n_tol = _ray_tols(o, d, r.hit, r.toi, target == "hull")
    keys = ("hit", "collider", "toi", "point", "normal")
    tols = (0, 0, t_tol, t_tol, n_tol)
    if target == "hull":
        keys, tols = keys[:4], tols[:4]
        _, verts = _hull_planes(scene)
        on = (rows & _port_np(p.hit) & (_port_np(p.toi) > 0)
              & (_port_np(p.collider) == names(scene).index("hull")))
        n, x = _port_np(p.normal)[on], _port_np(p.point)[on]
        assert np.all(np.abs(np.linalg.norm(n, axis=1) - 1.0) < 1e-3)

        def support(nrm):
            # The inward normal (R29): its opposite supports the hull.
            return np.einsum("rj,rvj->rv", -nrm, verts[None] - x[:, None]).max(axis=1)

        # GJK stops at a relative progress of 1e-6, so 1e-4 from the surface
        # its direction is approximate: as far off as the reference's own.
        bound = max(tp.GJK_NORMAL_TOL, 2.0 * float(support(r.normal[on]).max()))
        assert np.all(support(n) <= bound), (support(n).max(), bound)
    tp.assert_rows_with_witnesses([_port_np(getattr(p, k)) for k in keys],
                                  [getattr(r, k) for k in keys],
                                  [[getattr(w[0], k) for k in keys] for w in wit], tols,
                                  f"rays at the {target}", mask=rows)
    assert (rows & r.hit & (r.collider == names(scene).index(target))).sum() > PER_TARGET // 4


def _intersect_ray(scene):
    (o, d, _), (_, r), wit, (_, p) = ray_results(scene)
    port = [_port_np(x) for x in p]
    for c, name in enumerate(names(scene)):
        hit = r[0][:, c]
        _, t_tol, n_tol = _ray_tols(o, d, hit, r[1][:, c], name == "hull")
        # A hull's normals: test_cast_ray_matches_reference's geometry check.
        n_tol = np.inf if name == "hull" else np.where(hit, n_tol, np.inf)
        tp.assert_rows_with_witnesses(
            [x[:, c] for x in port], [x[:, c] for x in r], [[x[:, c] for x in w[1]] for w in wit],
            (0, np.where(hit, t_tol, 0.0), n_tol), f"all hits on the {name}")


@functools.lru_cache(maxsize=None)
def point_results(scene, solid):
    _, s, ps, targets = zoo_states(scene)
    pts = tp.near_points(targets, PER_TARGET, seed=5)

    @jax.jit
    def ref(p):
        def one(p1):
            return (jq.project_point(s.bodies, s.colliders, p1, solid=solid, meshes=s.meshes,
                                     hulls=s.hulls),
                    jq.intersections_with_point(s.bodies, s.colliders, p1, hulls=s.hulls))
        return jax.vmap(one)(p)

    r = jax.tree.map(np.asarray, ref(jnp.asarray(pts)))
    pt = torch.from_numpy(pts)[None]
    port = (pq.project_point(ps.bodies, ps.colliders, pt, solid=solid, meshes=ps.meshes,
                             hulls=ps.hulls),
            pq.intersections_with_point(ps.bodies, ps.colliders, pt, hulls=ps.hulls))
    fields = [(_port_np(getattr(port[0], k)), getattr(r[0], k)) for k in r[0]._fields]
    fields.append((_port_np(port[1]), r[1]))
    bad = ~tp.rows_close([f[0] for f in fields], [f[1] for f in fields],
                         [tp.QUERY_TOL * np.maximum(1.0, np.abs(pts).max(axis=1))] * len(fields))
    return pts, r, tp.lazy_witnesses(ref, (pts,), r, bad), port


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("solid", [True, False])
def test_points_match_reference(scene, solid):
    """project_point, and (solid) intersections_with_point."""
    _project_point(scene, solid)
    if solid:
        _intersections_with_point(scene)


def _project_point(scene, solid):
    pts, (r, _), wit, (p, _) = point_results(scene, solid)
    keys = ("collider", "is_inside", "distance", "point")
    # Distances and points 1e-5 of the point's scale; a hull's come from
    # GJK or EPA: GJK_NORMAL_TOL.
    scale = np.maximum(1.0, np.abs(pts).max(axis=1))
    hull = r.collider == (names(scene).index("hull") if scene == "hull" else -2)
    tol = np.where(hull, tp.GJK_NORMAL_TOL, tp.QUERY_TOL * scale)
    rows = np.ones(len(pts), bool)
    if scene == "hull":
        # Points inside the hull: EPA.  Where the reference's depth is the
        # exact one, the port's must be too; elsewhere (EPA unconverged)
        # the port's is no deeper than the exact one.  A projected point
        # that differs from the reference's is held to geometry: on the
        # hull's boundary, |distance| from the point (two faces at one
        # depth are a tie either package may take).
        planes, _ = _hull_planes(scene)
        exact = (pts.astype(np.float64) @ planes[:, :3].T + planes[:, 3]).max(axis=1)
        inside = hull & (exact < 0)
        unconverged = inside & (np.abs(r.distance - exact) > tp.GJK_NORMAL_TOL)
        # 56 of the 512 points lie inside; the reference's EPA converges on
        # 30 of them.
        assert (inside & ~unconverged).sum() >= 16
        pd, pp = _port_np(p.distance), _port_np(p.point)
        ok = inside & ~unconverged
        assert np.all(np.abs(pd - exact)[ok] <= tp.GJK_NORMAL_TOL)
        assert np.all(-pd[unconverged] <= -exact[unconverged] + 1e-4)
        if not solid:
            tie = ok & (np.abs(pp - r.point).max(axis=1) > tp.GJK_NORMAL_TOL)
            on_boundary = (pp.astype(np.float64) @ planes[:, :3].T + planes[:, 3]).max(axis=1)
            assert np.all(np.abs(on_boundary[tie]) <= tp.GJK_NORMAL_TOL)
            reach = np.linalg.norm(pp - pts, axis=1)
            assert np.all(np.abs(reach - np.abs(pd))[tie] <= tp.GJK_NORMAL_TOL)
        rows = ~inside
    tp.assert_rows_with_witnesses([_port_np(getattr(p, k)) for k in keys],
                                  [getattr(r, k) for k in keys],
                                  [[getattr(w[0], k) for k in keys] for w in wit],
                                  (0, 0, tol, tol), f"projections (solid={solid})", mask=rows)
    for c, name in enumerate(names(scene)):
        if name in AIMED[scene]:
            assert (r.collider == c).sum() > 0, f"no point projects onto {name}"


def _intersections_with_point(scene):
    _, (_, r_in), wit, (_, p_in) = point_results(scene, True)
    tp.assert_rows_with_witnesses([_port_np(p_in)], [r_in], [[w[1]] for w in wit], (0,),
                                  "containment")
    assert r_in.sum() >= 50


def test_filter_mask_matches_reference():
    """Every filter flag, the excludes and the collision groups, on a scene
    of fixed, kinematic, dynamic and sensor colliders."""
    from rapier_tpu.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld()
    for i, b in enumerate((RigidBodyBuilder.fixed(), RigidBodyBuilder.dynamic(),
                           RigidBodyBuilder.kinematic_position_based(),
                           RigidBodyBuilder.kinematic_velocity_based(),
                           RigidBodyBuilder.dynamic())):
        h = w.insert_body(b.with_translation((i, 0, 0)))
        cb = ColliderBuilder.ball(0.3).with_collision_groups((0x0003 << 16) | (1 << (i % 3)))
        w.insert_collider(cb.as_sensor() if i == 4 else cb, h)
    w.insert_collider(ColliderBuilder.ball(0.3))          # no parent
    s = w.build()
    ps = from_numpy(replicate_scene(s, 1))
    for flags in range(32):
        for kw in ({}, dict(exclude_collider=2), dict(exclude_body=1),
                   dict(groups=(0x0001 << 16) | 0x0002), dict(groups=(0x0004 << 16) | 0x0001)):
            ref = np.asarray(jq._filter_mask(jax.tree.map(jnp.asarray, s.colliders),
                                             jnp.asarray(s.bodies.body_type), flags, **kw))
            got = pq._filter_mask(ps.colliders, ps.bodies.body_type, flags, **kw)[0].numpy()
            np.testing.assert_array_equal(got, ref, err_msg=f"flags {flags} {kw}")


def test_world_queries_match_reference():
    """The port's world methods at B = 1 against the reference's world:
    one value per query, as the reference's return."""
    kinds = ("ball", "cuboid", "capsule", "heightfield", "trimesh", "halfspace")
    rw, _ = tp.query_zoo("rapier_tpu", kinds)
    pw, _ = tp.query_zoo("rapier_tpu_torch", kinds)
    for name, part in (("bodies", "pos"), ("colliders", "shape_params")):
        np.testing.assert_array_equal(getattr(getattr(pw.state, name), part)[0].numpy(),
                                      np.asarray(getattr(getattr(rw.state, name), part)))
    for origin, direction in (((4.0, 5.0, 0.2), (0.0, -1.0, 0.0)),
                              ((41.0, 5.0, 1.0), (0.0, -1.0, 0.0))):
        r, p = rw.cast_ray(origin, direction), pw.cast_ray(origin, direction)
        assert p.hit.shape == () and p.point.shape == (3,)
        assert bool(p.hit) == bool(r.hit) and int(p.collider) == int(r.collider)
        np.testing.assert_allclose(p.point.numpy(), np.asarray(r.point), rtol=1e-5, atol=1e-5)
    for point in ((0.3, 2.5, 0.3), (51.0, 2.0, 0.5)):
        r, p = rw.project_point(point), pw.project_point(point)
        assert int(p.collider) == int(r.collider)
        np.testing.assert_allclose(p.point.numpy(), np.asarray(r.point), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(pw.intersections_with_point(point).numpy(),
                                      np.asarray(rw.intersections_with_point(point)))
