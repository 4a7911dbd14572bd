"""`rapier_tpu_torch.utils.debug_render` against the reference's on the same
states (reference states carried across with `types.from_numpy`).

Tolerances: the line arrays equal in count, order and color; coordinates
within COORD_TOL (the two packages compute the collider world poses, each
in its own float32 arithmetic).  Every mode and a custom style are
rendered, on scenes that hold every shape type `_shape_outline` draws:
- tests/test_world_api.py's trimesh-and-hull scene, stepped by the
  reference;
- a zoo built by the reference: halfspace, cylinder, cone, round cylinder,
  ball, capsule, cuboid, a heightfield, a sleeping body and a disabled
  collider;
- the bench batch after its contacts touch (`settled_batch`, both scenes);
- joints3 (joint lines).
"""

import dataclasses

import numpy as np
import pytest

import test_torch_common as tp

COORD_TOL = 1e-6


def _modes():
    from rapier_tpu_torch.utils.debug_render import DebugRenderMode as M

    return (None, M.COLLIDER_SHAPES, M.RIGID_BODY_AXES, M.IMPULSE_JOINTS, M.CONTACTS,
            M.DEFAULT, M.ALL)


def _styles():
    from rapier_tpu.utils.debug_render import DebugRenderStyle as RS
    from rapier_tpu_torch.utils.debug_render import DebugRenderStyle as PS

    custom = dict(collider_color=(1.0, 0.0, 0.0, 1.0), sleep_color=(0.0, 1.0, 1.0, 1.0),
                  contact_color=(0.5, 0.5, 0.0, 1.0), joint_color=(0.0, 0.0, 1.0, 0.5),
                  contact_normal_length=0.7, body_axes_length=1.5)
    return [(None, None), (RS(**custom), PS(**custom))]


def _scene(batch, s):
    import jax

    return jax.tree.map(lambda x: np.asarray(x)[s], batch)


def _assert_same_render(ref_state, port_batch, scene, what, need=()):
    """Every mode and style: the reference on `ref_state` (one scene), the
    port on scene `scene` of `port_batch`.  `need`: colors that must appear
    in the default render."""
    from rapier_tpu.utils.debug_render import debug_render as ref_render
    from rapier_tpu_torch.utils.debug_render import debug_render as port_render

    for rstyle, pstyle in _styles():
        for mode in _modes():
            rs, re, rc = ref_render(ref_state, mode=mode, style=rstyle)
            ps, pe, pc = port_render(port_batch, mode=mode, style=pstyle, scene=scene)
            tag = f"{what} mode={mode} style={'custom' if rstyle else 'default'}"
            assert ps.shape == rs.shape and pc.shape == rc.shape, (tag, ps.shape, rs.shape)
            assert np.array_equal(pc, rc), tag
            np.testing.assert_allclose(ps, rs, atol=COORD_TOL, rtol=0, err_msg=tag)
            np.testing.assert_allclose(pe, re, atol=COORD_TOL, rtol=0, err_msg=tag)
    _, _, colors = port_render(port_batch, scene=scene)
    for color in need:
        assert any(tuple(c) == color for c in colors), (what, color)


def _one(state):
    from rapier_tpu_torch.scenes import replicate_scene
    from rapier_tpu_torch.types import from_numpy

    return from_numpy(replicate_scene(state, 1))


def test_mesh_and_hull_scene_stepped_by_the_reference():
    """tests/test_world_api.py::test_debug_render_mesh_hull_outlines_and_modes:
    a trimesh quad and a convex hull, after 3 reference steps."""
    import jax
    import jax.numpy as jnp
    import rapier_tpu.pipeline.physics_pipeline as jpp
    from rapier_tpu.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld()
    g = w.insert_body(RigidBodyBuilder.fixed())
    verts = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    w.insert_collider(ColliderBuilder.trimesh(verts, tris), g)
    hb = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 2, 0)))
    pts = [(x, y, z) for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]
    w.insert_collider(ColliderBuilder.convex_hull(pts), hb)
    state = w.build()
    f = jax.jit(jpp.step)
    js = jax.tree.map(jnp.asarray, state)
    for _ in range(3):
        js, _ = f(js, w.params)
    state = jax.tree.map(np.asarray, js)
    _assert_same_render(state, _one(state), 0, "mesh and hull")
    from rapier_tpu_torch.utils.debug_render import DebugRenderMode, debug_render

    s0, _, _ = debug_render(_one(state), mode=DebugRenderMode.COLLIDER_SHAPES)
    assert len(s0) >= 6 + 12


def test_shape_zoo_sleep_and_disabled():
    """Every analytic outline, a heightfield's wireframe, the sleep color and
    a disabled collider (skipped), built by the reference."""
    from rapier_tpu.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder
    from rapier_tpu_torch.utils.debug_render import DebugRenderStyle, debug_render

    w = PhysicsWorld()
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.halfspace((0.0, 1.0, 0.0)), g)
    heights = np.sin(np.linspace(0, 3, 16)).reshape(4, 4) * 0.3
    hf = w.insert_body(RigidBodyBuilder.fixed().with_translation((8.0, 0.0, 0.0)))
    w.insert_collider(ColliderBuilder.heightfield(heights, (4.0, 1.0, 4.0)), hf)
    shapes = [ColliderBuilder.cylinder(0.4, 0.3), ColliderBuilder.cone(0.5, 0.3),
              ColliderBuilder.round_cylinder(0.3, 0.3, 0.05), ColliderBuilder.ball(0.3),
              ColliderBuilder.capsule_y(0.3, 0.2), ColliderBuilder.cuboid(0.3, 0.2, 0.4)]
    for i, cb in enumerate(shapes):
        b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((1.5 * i, 1.0, 0.0))
                          .with_rotation((0.3 * i, 0.1, 0.2)))
        w.insert_collider(cb, b)
    sleeper = w.insert_body(dataclasses.replace(
        RigidBodyBuilder.dynamic().with_translation((0.0, 3.0, 2.0)), sleeping=True))
    w.insert_collider(ColliderBuilder.cuboid(0.5, 0.5, 0.5), sleeper)
    off = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0.0, 3.0, -2.0)))
    w.insert_collider(dataclasses.replace(ColliderBuilder.ball(0.5), enabled=False), off)
    state = w.build()
    style = DebugRenderStyle()
    _assert_same_render(state, _one(state), 0, "zoo",
                        need=(style.sleep_color, style.collider_color))
    # The disabled ball draws nothing: its 3 circles appear once enabled.
    enabled = np.array(state.colliders.enabled)
    assert not enabled[w.n_colliders - 1]
    enabled[w.n_colliders - 1] = True
    on = dataclasses.replace(state, colliders=dataclasses.replace(state.colliders,
                                                                  enabled=enabled))
    assert len(debug_render(_one(on))[0]) == len(debug_render(_one(state))[0]) + 3 * 16


@pytest.mark.parametrize("scene", [0, 1])
def test_bench_contacts(scene):
    """The bench batch after its bottom layer lands (contact normals on the
    touching lanes), each scene of the batch."""
    batch = tp.settled_batch()
    assert int(np.asarray(batch.contacts.touching)[scene].sum()) > 0
    from rapier_tpu_torch.types import from_numpy
    from rapier_tpu_torch.utils.debug_render import DebugRenderStyle

    _assert_same_render(_scene(batch, scene), from_numpy(batch), scene, f"bench {scene}",
                        need=(DebugRenderStyle().contact_color,))


def test_joint_lines():
    """joints3 (built with the port's builders, as the joint tests build it):
    a line a joint."""
    from rapier_tpu_torch.scenes import joints3_world
    from rapier_tpu_torch.utils.debug_render import DebugRenderStyle

    w = joints3_world(device="cpu", **tp.JOINT_CAPACITY)[0]
    ref = tp.to_reference(w.build())
    _assert_same_render(ref, _one(ref), 0, "joints3",
                        need=(DebugRenderStyle().joint_color,))
