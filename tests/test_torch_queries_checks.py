"""tests/test_queries.py's and tests/test_world_api.py's own checks of the
scene queries, run on rapier_tpu_torch's `PhysicsWorld` on the CPU (no
reference run: the parity of every query against the reference is
tests/test_torch_queries.py's and tests/test_torch_queries_shapes.py's).
Each check keeps the reference test's thresholds.
"""

import numpy as np
import pytest
import torch

from rapier_tpu_torch.geometry import queries as pq
from rapier_tpu_torch.types import ShapeType


@pytest.fixture(scope="module")
def scene():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.halfspace((0, 1, 0)), g)
    ball = w.insert_body(RigidBodyBuilder.fixed().with_translation((5, 1, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5), ball)
    box = w.insert_body(RigidBodyBuilder.fixed().with_translation((-5, 1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.5, 1.0, 0.5), box)
    cap = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 1, 5)))
    w.insert_collider(ColliderBuilder.capsule_y(0.5, 0.25), cap)
    w.build()
    return w


RAY_CASES = {
    # (origin, direction, kwargs, hit, collider, toi or None, point or None, normal or None)
    "hits_ball": ((5, 5, 0), (0, -1, 0), {}, True, 1, None, (5, 1.5, 0), (0, 1, 0)),
    "hits_box_face": ((-10, 1, 0), (1, 0, 0), {}, True, 2, 4.5, None, (-1, 0, 0)),
    "hits_ground": ((100, 3, 100), (0, -1, 0), {}, True, 0, 3.0, None, None),
    "hits_capsule": ((3, 1, 5), (-1, 0, 0), {}, True, 3, 2.75, None, None),
    "max_toi": ((5, 5, 0), (0, -1, 0), dict(max_toi=2.0), False, None, None, None, None),
    "misses_everything": ((0, 5, 0), (0, 1, 0), {}, False, None, None, None, None),
    "exclude_collider": ((5, 5, 0), (0, -1, 0), dict(exclude_collider=1), True, 0, None, None,
                         None),
}


@pytest.mark.parametrize("case", sorted(RAY_CASES))
def test_reference_ray_checks(scene, case):
    o, d, kw, hit, col, toi, point, normal = RAY_CASES[case]
    h = scene.cast_ray(o, d, **kw)
    assert bool(h.hit) == hit
    if col is not None:
        assert int(h.collider) == col
    if toi is not None:
        assert abs(float(h.toi) - toi) < (1e-4 if case == "hits_capsule" else 1e-5)
    if point is not None:
        np.testing.assert_allclose(h.point.numpy(), point, atol=1e-5)
    if normal is not None:
        np.testing.assert_allclose(h.normal.numpy(), normal, atol=1e-5)


def test_reference_point_checks(scene):
    s = scene.state
    hits, _, _ = pq.intersect_ray(s.bodies, s.colliders, torch.tensor([[[5.0, 5.0, 0.0]]]),
                                  torch.tensor([[[0.0, -1.0, 0.0]]]))
    assert bool(hits[0, 0, 1]) and bool(hits[0, 0, 0])        # the ball, then the ground
    proj = scene.project_point((5.0, 2.5, 0.0))
    assert int(proj.collider) == 1 and not bool(proj.is_inside)
    np.testing.assert_allclose(proj.point.numpy(), [5, 1.5, 0], atol=1e-5)
    assert abs(float(proj.distance) - 1.0) < 1e-5
    inside = scene.intersections_with_point((5.0, 1.1, 0.0))
    assert bool(inside[1]) and not bool(inside[2])


@pytest.fixture(scope="module")
def zoo():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    cyl = w.insert_body(RigidBodyBuilder.fixed().with_translation((10, 1, 0)))
    w.insert_collider(ColliderBuilder.cylinder(1.0, 0.5), cyl)
    cone = w.insert_body(RigidBodyBuilder.fixed().with_translation((15, 1, 0)))
    w.insert_collider(ColliderBuilder.cone(1.0, 0.5), cone)
    hull = w.insert_body(RigidBodyBuilder.fixed().with_translation((20, 1, 0)))
    pts = [(x, y, z) for x in (-0.5, 0.5) for y in (-1.0, 1.0) for z in (-0.5, 0.5)]
    w.insert_collider(ColliderBuilder.convex_hull(pts), hull)
    hf = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 0, 0)))
    w.insert_collider(ColliderBuilder.heightfield(np.zeros((5, 5), np.float32),
                                                  (40.0, 1.0, 40.0)), hf)
    w.build()
    return w


def test_reference_zoo_ray_checks(zoo):
    hit = zoo.cast_ray((10.0, 1.0, -5.0), (0.0, 0.0, 1.0))
    assert bool(hit.hit) and int(hit.collider) == 0 and abs(float(hit.toi) - 4.5) < 1e-4
    np.testing.assert_allclose(hit.normal.numpy(), [0, 0, -1], atol=1e-4)
    cap = zoo.cast_ray((10.0, 5.0, 0.0), (0.0, -1.0, 0.0))
    assert bool(cap.hit) and abs(float(cap.toi) - 3.0) < 1e-4
    np.testing.assert_allclose(cap.normal.numpy(), [0, 1, 0], atol=1e-4)
    cone = zoo.cast_ray((15.0, 5.0, 0.0), (0.0, -1.0, 0.0))
    assert bool(cone.hit) and int(cone.collider) == 1 and abs(float(cone.toi) - 3.0) < 1e-3
    side = zoo.cast_ray((15.0, 0.25, -5.0), (0.0, 0.0, 1.0))
    assert bool(side.hit) and abs(float(side.toi) - (5.0 - 0.5 * (2.0 - 0.25) / 2.0)) < 1e-3
    hull = zoo.cast_ray((20.0, 1.0, -5.0), (0.0, 0.0, 1.0))
    assert bool(hull.hit) and int(hull.collider) == 2 and abs(float(hull.toi) - 4.5) < 5e-3
    miss = zoo.cast_ray((20.0, 3.5, -5.0), (0.0, 0.0, 1.0))
    assert (not bool(miss.hit)) or int(miss.collider) != 2
    hf = zoo.cast_ray((3.0, 5.0, 3.0), (0.0, -1.0, 0.0))
    assert bool(hf.hit) and int(hf.collider) == 3 and abs(float(hf.toi) - 5.0) < 1e-4
    np.testing.assert_allclose(hf.normal.numpy(), [0, 1, 0], atol=1e-4)
    veh = zoo.cast_ray((2.0, 2.0, 2.0), (0.0, -1.0, 0.0), max_toi=5.0)
    assert bool(veh.hit) and int(veh.collider) == 3 and abs(float(veh.toi) - 2.0) < 1e-4


def test_reference_zoo_point_checks(zoo):
    pp = zoo.project_point((10.0, 1.0, 0.9))
    assert int(pp.collider) == 0 and abs(float(pp.distance) - 0.4) < 1e-4
    np.testing.assert_allclose(pp.point.numpy(), [10, 1, 0.5], atol=1e-4)
    pc = zoo.project_point((15.0, 2.5, 0.0))
    assert int(pc.collider) == 1
    np.testing.assert_allclose(pc.point.numpy(), [15, 2, 0], atol=1e-3)
    pf = zoo.project_point((10.0, 1.0, 2.0))
    assert int(pf.collider) == 3 and abs(float(pf.distance) - 1.0) < 1e-3
    np.testing.assert_allclose(pf.point.numpy(), [10, 0, 2], atol=1e-3)
    pm = zoo.project_point((5.0, 0.75, 5.0))
    assert int(pm.collider) == 3
    np.testing.assert_allclose(pm.point.numpy(), [5, 0, 5], atol=1e-4)
    assert bool(zoo.intersections_with_point((10.0, 1.5, 0.0))[0])
    assert not bool(zoo.intersections_with_point((10.0, 2.5, 0.0))[0])
    assert bool(zoo.intersections_with_point((15.0, 0.1, 0.0))[1])
    assert not bool(zoo.intersections_with_point((15.0, 1.9, 0.4))[1])


def test_reference_world_api_checks():
    """tests/test_world_api.py's `settled` scene: a box resting on the
    ground under a big sensor ball; test_world_cast_ray and
    test_world_project_point."""
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(50, 1, 50), g)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 0.6, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.5, 0.5, 0.5), b)
    s = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 0.5, 0)))
    w.insert_collider(ColliderBuilder.ball(2.0).as_sensor(), s)
    w.build()
    w.step(60)
    assert int(w.cast_ray((0.0, 5.0, 0.0), (0.0, -1.0, 0.0)).collider) == 2
    hit = w.cast_ray((0.0, 5.0, 0.0), (0.0, -1.0, 0.0), flags=pq.EXCLUDE_SENSORS)
    assert bool(hit.hit) and int(hit.collider) == 1 and abs(float(hit.point[1]) - 1.0) < 0.05
    proj = w.project_point((0.0, 3.0, 0.0), flags=pq.EXCLUDE_SENSORS)
    assert abs(float(proj.point[1]) - 1.0) < 0.05


def test_reference_intersect_shape_check(scene):
    hits = scene.intersections_with_shape(ShapeType.BALL, [0.6], (5.0, 1.0, 0.0), (0, 0, 0, 1))
    assert list(hits) == [1], hits


def test_reference_nonlinear_vs_linear_check(scene):
    lin = scene.cast_shape(ShapeType.BALL, [0.2], (2.0, 1.0, 0.0), (0, 0, 0, 1),
                           (1.0, 0.0, 0.0), 10.0)
    non = scene.cast_shape_nonlinear(ShapeType.BALL, [0.2], (2.0, 1.0, 0.0), (0, 0, 0, 1),
                                     (1.0, 0.0, 0.0), (0.0, 0.0, 0.0), 10.0)
    assert bool(lin.hit) and bool(non.hit)
    assert abs(float(non.toi) - float(lin.toi)) < 0.02
    non2 = scene.cast_shape_nonlinear(ShapeType.CAPSULE, [0.0, -0.5, 0.0, 0.0, 0.5, 0.0, 0.2],
                                      (2.0, 1.0, 0.0), (0, 0, 0, 1), (1.0, 0.0, 0.0),
                                      (0.0, 0.0, 3.0), 10.0)
    assert bool(non2.hit)


def test_reference_cast_onto_heightfield_check():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    hf = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.heightfield(np.zeros((5, 5), np.float32),
                                                  (40.0, 1.0, 40.0)), hf)
    w.build()
    hit = w.cast_shape(ShapeType.BALL, [0.5], (3.0, 4.0, 3.0), (0, 0, 0, 1), (0.0, -1.0, 0.0),
                       10.0)
    assert bool(hit.hit) and int(hit.collider) == 0 and abs(float(hit.toi) - 3.5) < 0.05


