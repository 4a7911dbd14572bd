"""rapier_tpu_torch's 2D world against rapier_tpu.world2d, without a step:

- the built state of a scene with every carried 2D shape (cuboid, ball,
  capsule_x, capsule_y, halfspace), an offset two-collider body, a mass
  override, a body mixing 2D and 3D colliders, a fixed body and the three 2D
  joints equals the reference's field by field: every field exactly, but for
  the recomputed 2D mass properties (inverse mass, inverse principal
  inertia, local COM) and the joint anchors shifted by the COM, within 1e-6;
- the parameters (gravity, the 2x2 block solve) and the Coulomb cache
  layout; `segment` and `convex_hull` build the reference's colliders (they
  raised before the generic convex shapes were ported: the test keeps its
  name);
- `solve_path`: "masked" for a PhysicsWorld2D batch and for a Coulomb
  scene, "blocked" for the full-size `s2d_pyramid_world(100)`;
- the scenes shared with chip_smoke.py build as tests/test_s2d.py builds
  them with the reference's builders.
"""

import dataclasses

import numpy as np
import pytest

import test_torch_common as tp

APPROX = {("bodies", "inv_mass"), ("bodies", "inv_principal_inertia"),
          ("bodies", "local_com"), ("joints", "local_pos1"), ("joints", "local_pos2")}


def _build_zoo(w2d, **world_kw):
    """The same scene through either package's world2d module."""
    rb, cb = w2d.RigidBodyBuilder2D, w2d.ColliderBuilder2D
    w = w2d.PhysicsWorld2D(gravity=(0.5, -9.0), **world_kw)
    ground = w.insert_body(rb.fixed().with_translation((0.0, -1.0)))
    w.insert_collider(cb.cuboid(20.0, 1.0).with_friction(0.7), ground)
    w.insert_collider(cb.halfspace((0.0, 1.0)), ground)
    shapes = [cb.cuboid(0.4, 0.3), cb.ball(0.35), cb.capsule_x(0.5, 0.2),
              cb.capsule_y(0.3, 0.25)]
    bodies = []
    for i, shape in enumerate(shapes):
        b = w.insert_body(rb.dynamic().with_translation((2.0 * i, 1.0 + 0.1 * i))
                          .with_rotation_angle(0.3 * i).with_linvel((0.5 * i, -1.0))
                          .with_angvel_scalar(0.2 * i))
        w.insert_collider(shape.with_density(1.0 + i), b)
        bodies.append(b)
    # Two offset 2D colliders on one body: a COM away from its origin.
    b = w.insert_body(rb.dynamic().with_translation((10.0, 2.0)))
    w.insert_collider(cb.cuboid(0.5, 0.2).with_translation((0.4, 0.1, 0.0)), b)
    w.insert_collider(cb.ball(0.3).with_translation((-0.5, 0.0, 0.0)).with_density(3.0), b)
    bodies.append(b)
    # An explicit mass: the 3D build's value stands.
    b = w.insert_body(rb.dynamic().with_translation((12.0, 2.0)))
    over = cb.cuboid(0.5, 0.5)
    over.mass = 3.0
    w.insert_collider(over, b)
    bodies.append(b)
    # A 2D and a 3D collider on one body: the 3D values stand.
    b = w.insert_body(rb.dynamic().with_translation((14.0, 2.0)))
    w.insert_collider(cb.cuboid(0.5, 0.5), b)
    w.insert_collider(w2d.ColliderBuilder.ball(0.4).with_translation((0.3, 0.0, 0.0)), b)
    bodies.append(b)
    w.insert_impulse_joint(bodies[0], bodies[1],
                           w2d.revolute_joint_2d(anchor1=(1.0, 0.0), anchor2=(-1.0, 0.0)))
    w.insert_impulse_joint(bodies[1], bodies[2],
                           w2d.prismatic_joint_2d(axis=(0.6, 0.8), anchor1=(0.5, 0.2)))
    w.insert_impulse_joint(bodies[4], bodies[3],
                           w2d.pin_slot_joint_2d(axis=(1.0, 0.0), anchor2=(0.1, -0.2)))
    return w


def _compare_states(ps, rs, parts=("bodies", "colliders", "contacts", "joints")):
    for part in parts:
        p, r = getattr(ps, part), getattr(rs, part)
        for f in dataclasses.fields(p):
            a, d = np.asarray(getattr(p, f.name)), np.asarray(getattr(r, f.name))
            if (part, f.name) in APPROX:
                tp.assert_close(a, d, 1e-6, f"{part}.{f.name}")
            else:
                assert a.dtype == d.dtype and np.array_equal(a, d), f"{part}.{f.name}"


def test_build_matches_reference():
    import rapier_tpu.world2d as rw2d
    import rapier_tpu_torch.world2d as pw2d
    from rapier_tpu_torch.types import LOCK_ROTATION_X, LOCK_ROTATION_Y, LOCK_TRANSLATION_Z

    rw, pw = _build_zoo(rw2d), _build_zoo(pw2d, device="cpu")
    rs, ps = rw.build(), pw.build()
    _compare_states(ps, rs)
    assert pw.params.block_solver_2x2 and rw.params.block_solver_2x2
    assert np.array_equal(pw.params.gravity, np.asarray(rw.params.gravity))
    assert pw.params.shape_types_present == rw.params.shape_types_present
    # The plane lock on every dynamic body, the 2D mass on the 2D ones.
    lock = LOCK_TRANSLATION_Z | LOCK_ROTATION_X | LOCK_ROTATION_Y
    dyn = ps.bodies.body_type == 0
    assert (ps.bodies.locked_axes[dyn] & lock == lock).all()
    assert ps.bodies.inv_mass[2] == np.float32(1.0 / (np.pi * 0.35 ** 2 * 2.0))
    # The facade's state on its device is the numpy state.
    for name in ("inv_mass", "local_com", "inv_principal_inertia", "locked_axes"):
        assert np.array_equal(getattr(pw.state.bodies, name)[0].numpy(),
                              getattr(ps.bodies, name)), name


def test_accessors_match_reference():
    import rapier_tpu.world2d as rw2d
    import rapier_tpu_torch.world2d as pw2d

    rw, pw = _build_zoo(rw2d), _build_zoo(pw2d, device="cpu")
    rw.build()
    pw.build()
    for h in range(1, 6):
        assert np.array_equal(pw.body_translation2(h), np.asarray(rw.body_translation2(h)))
        assert np.array_equal(pw.body_linvel2(h), np.asarray(rw.body_linvel2(h)))
        assert abs(pw.body_rotation_angle(h) - rw.body_rotation_angle(h)) < 1e-6


@pytest.mark.parametrize("ctor, args", [("segment", ((0.0, 0.0), (1.0, 0.0))),
                                        ("convex_hull", ([(0, 0), (1, 0), (0, 1)],))])
def test_gjk_shapes_raise(ctor, args):
    """The 2D shapes that need GJK no longer raise: each builds the
    reference's extruded 3D collider (type, parameters, hull points, 2D
    tag)."""
    from rapier_tpu.world2d import ColliderBuilder2D as Ref2D
    from rapier_tpu_torch.world2d import ColliderBuilder2D

    port, ref = getattr(ColliderBuilder2D, ctor)(*args), getattr(Ref2D, ctor)(*args)
    assert int(port.shape_type) == int(ref.shape_type)
    assert tuple(port.shape_params) == tuple(ref.shape_params)
    assert getattr(port, "_shape2d", None) == getattr(ref, "_shape2d", None)
    ref_points = getattr(ref, "_hull_points", None)
    assert (port.hull_points is None) == (ref_points is None)
    if ref_points is not None:
        assert np.array_equal(port.hull_points, ref_points)


def test_coulomb_cache_layout():
    """A Coulomb world builds the [4, 2, P] tangent caches, which cross to
    tensors, replicate and come back with their layout."""
    from rapier_tpu_torch.scenes import replicate_scene, s2d_coulomb_stack_world
    from rapier_tpu_torch.types import from_numpy, to_numpy

    w, _ = s2d_coulomb_stack_world(device="cpu")
    state = w.build()
    p = state.contacts.max_pairs
    assert state.contacts.warmstart_tangent_impulse.shape == (4, 2, p)
    assert state.contacts.tangent_impulse.shape == (4, 2, p)
    batch = replicate_scene(from_numpy(state), 3)
    assert tuple(batch.contacts.warmstart_tangent_impulse.shape) == (3, 4, 2, p)
    back = to_numpy(batch)
    assert back.contacts.tangent_impulse.shape == (3, 4, 2, p)
    assert tuple(w.state.contacts.tangent_impulse.shape) == (1, 4, 2, p)


def test_solve_paths():
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.scenes import (
        replicate_scene,
        s2d_coulomb_stack_world,
        s2d_high_mass_ratio_world,
        s2d_pyramid_world,
    )
    from rapier_tpu_torch.types import from_numpy

    def path(make, batch=2, **kw):
        w, _ = make(device="cpu", **kw)
        return pp.solve_path(replicate_scene(from_numpy(w.build()), batch), w.params), w

    assert path(s2d_pyramid_world, base_count=10)[0] == "masked"
    assert path(s2d_high_mass_ratio_world)[0] == "masked"
    assert path(s2d_coulomb_stack_world)[0] == "masked"
    # SURVEY.md's full-size scene: 5,050 boxes, far above the routing limit.
    big, w = path(s2d_pyramid_world, batch=1, base_count=100)
    assert big == "blocked"
    assert w.state.contacts.max_pairs * (w.state.bodies.pos.shape[1] + 1) > pp.DENSE_ROUTE_ELEMS
    # A cache built for the twist model refuses the Coulomb model.
    w, _ = s2d_pyramid_world(device="cpu", base_count=3)
    state = replicate_scene(from_numpy(w.build()), 1)
    with pytest.raises(ValueError, match="tangent layout"):
        pp.solve_path(state, w.params.replace(friction_model=1))


@pytest.mark.parametrize("name", ["pyramid", "high_mass_ratio", "coulomb_stack",
                                  "far_pyramid"])
def test_scenes_build_as_the_reference_tests_build_them(name):
    import rapier_tpu.world2d as rw2d
    import rapier_tpu_torch.scenes as scenes
    from rapier_tpu.types import FrictionModel

    rb, cb = rw2d.RigidBodyBuilder2D, rw2d.ColliderBuilder2D
    rw = rw2d.PhysicsWorld2D()
    if name in ("pyramid", "coulomb_stack"):
        # tests/test_s2d.py:18-36
        g = rw.insert_body(rb.fixed().with_translation((0, -1)))
        rw.insert_collider(cb.cuboid(100.0, 1.0).with_friction(0.6), g)
        rows = 10 if name == "pyramid" else 6
        for row in range(rows):
            n = rows - row
            y = 0.5 * 1.002 + row * 0.5 * 2.004
            x0 = -(n - 1) * 1.002 / 2.0
            for i in range(n):
                b = rw.insert_body(rb.dynamic().with_translation((x0 + i * 1.002, y)))
                rw.insert_collider(cb.cuboid(0.5, 0.5).with_friction(0.6), b)
        if name == "coulomb_stack":
            # tests/test_s2d.py:310-334
            rw.params = rw.params.replace(friction_model=int(FrictionModel.COULOMB))
            s = rw.insert_body(rb.dynamic().with_translation((20.0, 0.55))
                               .with_linvel((6.0, 0.0)))
            rw.insert_collider(cb.cuboid(0.5, 0.5).with_friction(0.4), s)
        pw, _ = (scenes.s2d_pyramid_world(device="cpu") if name == "pyramid"
                 else scenes.s2d_coulomb_stack_world(device="cpu"))
    elif name == "high_mass_ratio":
        # tests/test_s2d.py:50-73
        g = rw.insert_body(rb.fixed().with_translation((0, -1)))
        rw.insert_collider(cb.cuboid(50.0, 1.0).with_friction(0.5), g)
        for x in (-0.6, 0.6):
            b = rw.insert_body(rb.dynamic().with_translation((x, 0.5)))
            rw.insert_collider(cb.cuboid(0.3, 0.5).with_friction(0.5), b)
        h = rw.insert_body(rb.dynamic().with_translation((0.0, 1.5)))
        rw.insert_collider(cb.cuboid(1.2, 0.5).with_friction(0.5).with_density(25.0), h)
        pw, _ = scenes.s2d_high_mass_ratio_world(device="cpu")
    else:
        # tests/test_s2d.py:227-259
        origin = np.array([100_000.0, -80_000.0])
        g = rw.insert_body(rb.fixed().with_translation(tuple((0, -1) + origin)))
        rw.insert_collider(cb.cuboid(100.0, 1.0).with_friction(0.6), g)
        for i in range(10):
            y = (2.0 * i + 1.0) * 0.625 + 0.5
            for j in range(i, 10):
                x = (i + 1.0) * 0.625 + 2.0 * (j - i) * 0.625 - 5.0
                b = rw.insert_body(rb.dynamic().with_translation(tuple(np.array([x, y])
                                                                       + origin)))
                rw.insert_collider(cb.cuboid(0.5, 0.5).with_friction(0.6), b)
        pw, _ = scenes.s2d_far_pyramid_world(device="cpu")
    _compare_states(pw.build(), rw.build(), ("bodies", "colliders", "contacts"))
    assert pw.params.friction_model == rw.params.friction_model
    assert pw.params.block_solver_2x2 == rw.params.block_solver_2x2
