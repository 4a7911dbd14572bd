"""tests/test_ccd.py's scenarios on rapier_tpu_torch alone, with their own
thresholds, and the batched CCD pass against each scene alone.

The port's steps with CCD against the reference's are in
tests/test_torch_ccd_step.py, and its clamp against the reference's in
tests/test_torch_ccd.py; these run no reference step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rapier_tpu_torch.dynamics import ccd as port_ccd
from rapier_tpu_torch.types import from_numpy
from test_torch_ccd import captures, port_clamp


def _port_wall_world(ccd: bool):
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(gravity=(0, 0, 0), device="cpu")
    wall = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.cuboid(0.1, 5, 5), wall)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((-5, 0, 0))
                      .with_linvel((100, 0, 0)).with_ccd_enabled(ccd))
    w.insert_collider(ColliderBuilder.ball(0.5), b)
    w.build()
    return w, b


def test_fast_ball_tunnels_without_ccd():
    w, b = _port_wall_world(ccd=False)
    assert not w.params.enable_ccd
    w.step(10)
    assert w.body_translation(b)[0] > 5.0


def test_fast_ball_stopped_by_ccd():
    w, b = _port_wall_world(ccd=True)
    assert w.params.enable_ccd
    w.step(10)
    x = w.body_translation(b)[0]
    assert -1.5 < x < 0.0, x
    assert np.isfinite(w.body_translation(b)).all()
    assert int(w.last_events.ccd_overflow[0]) == 0


def test_ccd3_wall_smash_no_tunneling():
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -0.1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(200.0, 0.1, 10.0), g)
    boxes = []
    for wall_x in (20.0, 30.0):
        for iy in range(4):
            b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((wall_x, 0.5 + iy, 0)))
            w.insert_collider(ColliderBuilder.cuboid(0.5, 0.5, 1.0), b)
            boxes.append(b)
    ball = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0.0, 2.0, 0.0))
                         .with_linvel((1000.0, 0.0, 0.0)).with_ccd_enabled())
    w.insert_collider(ColliderBuilder.ball(0.5).with_density(10.0), ball)
    w.build()
    assert w.params.enable_ccd
    xs = []
    for _ in range(30):
        w.step()
        xs.append(float(w.body_translation(ball)[0]))
    assert xs[-1] < 350.0, xs[-1]
    assert float(w.body_linvel(ball)[0]) < 600.0
    assert np.diff([0.0] + xs).min() < 10.0
    assert any(abs(float(w.body_translation(b)[0]) - wx) > 0.2
               for b, wx in zip(boxes, [20.0] * 4 + [30.0] * 4))


@pytest.mark.parametrize("ccd", [False, True])
def test_fast_ball_and_trimesh(ccd):
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(gravity=(0, 0, 0), device="cpu")
    wall = w.insert_body(RigidBodyBuilder.fixed())
    verts = [(0, -5, -5), (0, 5, -5), (0, 5, 5), (0, -5, 5)]
    w.insert_collider(ColliderBuilder.trimesh(verts, [(0, 1, 2), (0, 2, 3)]), wall)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((-5, 0, 0))
                      .with_linvel((100, 0, 0)).with_ccd_enabled(ccd))
    w.insert_collider(ColliderBuilder.ball(0.5), b)
    w.step(10)
    x = float(w.body_translation(b)[0])
    if ccd:
        assert -1.5 < x < 0.0, f"mesh CCD failed to clamp: x={x}"
    else:
        assert x > 5.0, f"without CCD the ball should tunnel, x={x}"


@pytest.mark.parametrize("ccd", [False, True])
def test_spinning_rod(ccd):
    """A rod spinning half a turn a step sweeps its tip through a thin wall
    between its two poses: only the interpolated rotations see it.  The
    control has enable_ccd set without a CCD body, and builds and steps."""
    from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld(gravity=(0, 0, 0), device="cpu")
    wall_b = w.insert_body(RigidBodyBuilder.fixed().with_translation((0.65, 0.0, 0.0)))
    w.insert_collider(ColliderBuilder.cuboid(0.05, 3.0, 3.0), wall_b)
    rb = RigidBodyBuilder.dynamic().with_linvel((3.0, 0.0, 0.0)).with_angvel(
        (0.0, 0.0, float(np.pi * 60.0)))
    rb = rb.with_rotation((0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)))
    rod = w.insert_body(rb.with_ccd_enabled(ccd))
    w.insert_collider(ColliderBuilder.capsule_x(0.5, 0.1), rod)
    w.params = w.params.replace(enable_ccd=True)
    w.build()
    w.step(3)
    vx = float(w.body_linvel(rod)[0])
    if ccd:
        assert vx < 2.0, f"rotational sweep not caught: vx={vx}"
    else:
        assert abs(vx - 3.0) < 1e-3, vx


def test_batched_cases_match_each_alone():
    """Every non-mesh case's first clamped step in one batch through the
    port: each scene clamps as it does alone (rows, pairs and caps are per
    scene)."""
    picked = []
    for name in ("wall", "ccd3_flavour", "rod", "fairness", "halfspace", "hull"):
        params, caps = captures(name)
        state = next(s for s, _ in caps if port_clamp(s, params)[0].tolist()
                     != s.bodies.next_pos[0].tolist())
        picked.append(from_numpy(state))
    # Every shape type's support branch: the cases' censuses differ.
    params = params.replace(shape_types_present=())

    def cat(part):
        first = getattr(picked[0], part)
        return dataclasses.replace(first, **{
            f.name: torch.cat([getattr(getattr(s, part), f.name) for s in picked])
            for f in dataclasses.fields(first)})

    bodies, ovf = port_ccd.clamp_motions(cat("bodies"), cat("colliders"), params, None)
    for i, s in enumerate(picked):
        alone, ovf1 = port_ccd.clamp_motions(s.bodies, s.colliders, params, None)
        torch.testing.assert_close(bodies.next_pos[i], alone.next_pos[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(bodies.next_rot[i], alone.next_rot[0], rtol=0, atol=1e-6)
        assert int(ovf[i]) == int(ovf1[0])
