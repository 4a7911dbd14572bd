"""Benchmark / acceptance scenes (counterpart of rapier_tpu.scenes)."""

from __future__ import annotations

import numpy as np
import torch

from rapier_tpu_torch.types import tree_map
from rapier_tpu_torch.world import (
    ColliderBuilder,
    FixedJointBuilder,
    PhysicsWorld,
    PrismaticJointBuilder,
    RevoluteJointBuilder,
    RigidBodyBuilder,
    SphericalJointBuilder,
)


def mixed_primitives_world(num_layers: int = 4, grid: int = 4, rad: float = 0.5,
                           **world_kw) -> PhysicsWorld:
    """primitives3-flavoured scene (examples3d/primitives3.rs:13-60): layers
    of balls, cuboids and capsules dropped onto a fixed ground cuboid."""
    w = PhysicsWorld(**world_kw)
    ground = w.insert_body(RigidBodyBuilder.fixed().with_translation((0.0, -2.1, 0.0)))
    w.insert_collider(ColliderBuilder.cuboid(100.1, 2.1, 100.1), ground)

    shift = rad * 2.5
    center = shift * (grid - 1) / 2.0
    for j in range(num_layers):
        y = j * shift * 2.0 + rad + 2.0
        for i in range(grid):
            for k in range(grid):
                x = i * shift - center + 0.02 * j
                z = k * shift - center + 0.02 * j
                b = w.insert_body(
                    RigidBodyBuilder.dynamic().with_translation((x, y, z)))
                kind = j % 3
                if kind == 0:
                    cb = ColliderBuilder.ball(rad)
                elif kind == 1:
                    cb = ColliderBuilder.cuboid(rad, rad, rad)
                else:
                    cb = ColliderBuilder.capsule_y(rad * 0.5, rad * 0.5)
                w.insert_collider(cb, b)
    return w


def pyramid_world(base_count: int = 10, half: float = 0.5, friction: float = 0.6,
                  **world_kw) -> PhysicsWorld:
    """s2d_pyramid (examples2d/s2d_pyramid.rs:13-38) lifted to 3D: a planar
    triangular pyramid of cuboids on a ground cuboid."""
    w = PhysicsWorld(**world_kw)
    ground = w.insert_body(RigidBodyBuilder.fixed().with_translation((0.0, -1.0, 0.0)))
    w.insert_collider(
        ColliderBuilder.cuboid(100.0, 1.0, 100.0).with_friction(friction), ground)
    gap = half * 2.0 * 1.002
    for row in range(base_count):
        n_in_row = base_count - row
        y = half + row * half * 2.0
        x0 = -(n_in_row - 1) * gap / 2.0
        for i in range(n_in_row):
            b = w.insert_body(
                RigidBodyBuilder.dynamic().with_translation((x0 + i * gap, y, 0.0)))
            w.insert_collider(
                ColliderBuilder.cuboid(half, half, half).with_friction(friction), b)
    return w


def stack_world(n: int = 10, half: float = 0.5, friction: float = 0.7,
                **world_kw) -> PhysicsWorld:
    """A single column of `n` cuboids on a ground cuboid."""
    w = PhysicsWorld(**world_kw)
    ground = w.insert_body(RigidBodyBuilder.fixed().with_translation((0.0, -1.0, 0.0)))
    w.insert_collider(
        ColliderBuilder.cuboid(50.0, 1.0, 50.0).with_friction(friction), ground)
    for i in range(n):
        b = w.insert_body(
            RigidBodyBuilder.dynamic().with_translation((0.0, half + i * half * 2.002, 0.0)))
        w.insert_collider(
            ColliderBuilder.cuboid(half, half, half).with_friction(friction), b)
    return w


def pyramid3_world(stack_height: int = 12, half: float = 1.0,
                   **world_kw) -> PhysicsWorld:
    """3D square pyramid stress scene (examples3d/stress_tests/pyramid3.rs:
    4-64): level i holds (stack_height - i)^2 cuboids, so stack 16 has 1,496
    boxes, stack 24 4,900 and stack 31 10,416."""
    w = PhysicsWorld(**world_kw)
    ground = w.insert_body(RigidBodyBuilder.fixed().with_translation((0.0, -0.1, 0.0)))
    w.insert_collider(ColliderBuilder.cuboid(50.0, 0.1, 50.0), ground)
    shift = half * 2.5
    n = stack_height
    for i in range(n):
        for j in range(i, n):
            for k in range(i, n):
                x = i * shift / 2.0 + (k - i) * shift - n * half
                y = i * shift + half
                z = i * shift / 2.0 + (j - i) * shift - n * half
                b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((x, y, z)))
                w.insert_collider(ColliderBuilder.cuboid(half, half, half), b)
    return w


# Quadruped robot (reference scenes.py:125-192): a free-floating trunk with
# four 2-hinge legs driven by position servos, on a plane; the batched-RL
# configuration of the bench's robots mode.
QUADRUPED_MJCF = """
<mujoco model="quadruped">
  <compiler angle="radian"/>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1" friction="0.9"/>
    <body name="trunk" pos="0 0 0.45">
      <joint name="root" type="free"/>
      <geom name="trunk_geom" type="box" size="0.25 0.15 0.05"
            density="800"/>
      <BODY_LEGS/>
    </body>
  </worldbody>
  <actuator>
    <ACTUATORS/>
  </actuator>
</mujoco>
"""


def _quadruped_xml() -> str:
    legs, acts = [], []
    for name, sx, sy in (("fl", 1, 1), ("fr", 1, -1), ("rl", -1, 1), ("rr", -1, -1)):
        x, y = 0.18 * sx, 0.11 * sy
        legs.append(f"""
      <body name="{name}_upper" pos="{x} {y} -0.05">
        <joint name="{name}_hip" type="hinge" axis="0 1 0"
               limited="true" range="-1.2 1.2"/>
        <geom type="capsule" fromto="0 0 0  0 0 -0.18" size="0.03"
              density="1000"/>
        <body name="{name}_lower" pos="0 0 -0.18">
          <joint name="{name}_knee" type="hinge" axis="0 1 0"
                 limited="true" range="-1.6 1.6"/>
          <geom type="capsule" fromto="0 0 0  0 0 -0.18" size="0.025"
                density="1000" friction="0.9"/>
        </body>
      </body>""")
        for j in ("hip", "knee"):
            acts.append(f'<position name="{name}_{j}_servo" joint="{name}_{j}" kp="80"/>')
    return (QUADRUPED_MJCF
            .replace("<BODY_LEGS/>", "".join(legs))
            .replace("<ACTUATORS/>", "\n    ".join(acts)))


def quadruped_world(use_multibody: bool = True, **world_kw):
    """Quadruped standing on a plane: a reduced-coordinate articulation, or
    with use_multibody=False eight impulse joints.  Returns (world,
    MjcfRobotHandles)."""
    from rapier_tpu_torch.loaders.mjcf import load_mjcf

    world_kw.setdefault("gravity", (0.0, 0.0, -9.81))
    w = PhysicsWorld(**world_kw)
    return w, load_mjcf(_quadruped_xml(), w, use_multibody=use_multibody)


def joints3_world(**world_kw):
    """The joint zoo of examples/joints3.py (examples3d/joints3.rs): a
    5-link revolute chain hanging from a fixed anchor, a prismatic slider
    with a position motor and limits, a 3x3 fixed-joint lattice hung from
    its top middle body, and a 4-link spherical rope whose last joint has
    swing limits.  Returns (world, {"chain": [...], "slider": h, "rope": [...]})."""
    rb, cb = RigidBodyBuilder, ColliderBuilder
    w = PhysicsWorld(**world_kw)

    anchor = w.insert_body(rb.fixed().with_translation((0, 8, 0)))
    prev, chain = anchor, []
    for i in range(5):
        b = w.insert_body(rb.dynamic().with_translation((0.6 * (i + 1), 8, 0)))
        w.insert_collider(cb.cuboid(0.25, 0.1, 0.1), b)
        jb = RevoluteJointBuilder((0, 0, 1)).with_local_anchor1(
            (0.3, 0, 0) if prev != anchor else (0.0, 0.0, 0.0)
        ).with_local_anchor2((-0.3, 0, 0)).with_contacts_enabled(False)
        w.insert_impulse_joint(prev, b, jb)
        chain.append(b)
        prev = b

    base = w.insert_body(rb.fixed().with_translation((4, 6, 0)))
    slider = w.insert_body(rb.dynamic().with_translation((4, 6, 0)))
    w.insert_collider(cb.cuboid(0.3, 0.3, 0.3), slider)
    pj = PrismaticJointBuilder((0, 1, 0)).with_limits(0, -2.0, 2.0)
    pj = pj.with_motor_position(0, 1.5, 200.0, 20.0).with_contacts_enabled(False)
    w.insert_impulse_joint(base, slider, pj)

    grid = {}
    for r in range(3):
        for c in range(3):
            top = r == 0 and c == 1
            bb = rb.fixed() if top else rb.dynamic()
            b = w.insert_body(bb.with_translation((8 + c * 0.6, 8 - r * 0.6, 0)))
            if not top:
                w.insert_collider(cb.ball(0.2), b)
            grid[(r, c)] = b
    for (r, c), b in grid.items():
        for (dr, dc, a1, a2) in [(1, 0, (0, -0.3, 0), (0, 0.3, 0)),
                                 (0, 1, (0.3, 0, 0), (-0.3, 0, 0))]:
            if (r + dr, c + dc) in grid:
                jb = FixedJointBuilder().with_local_anchor1(a1) \
                    .with_local_anchor2(a2).with_contacts_enabled(False)
                w.insert_impulse_joint(b, grid[(r + dr, c + dc)], jb)

    prev, rope = w.insert_body(rb.fixed().with_translation((12, 8, 0))), []
    for i in range(4):
        b = w.insert_body(rb.dynamic().with_translation((12, 8 - 0.7 * (i + 1), 0)))
        w.insert_collider(cb.ball(0.15), b)
        jb = SphericalJointBuilder().with_local_anchor1(
            (0, -0.35, 0) if i else (0, 0, 0)
        ).with_local_anchor2((0, 0.35, 0)).with_contacts_enabled(False)
        if i == 3:
            jb = jb.with_swing_limits(0.0, 0.5)
        w.insert_impulse_joint(prev, b, jb)
        rope.append(b)
        prev = b
    return w, {"chain": chain, "slider": slider, "rope": rope}


def replicate_scene(state, batch: int):
    """Copy one scene state `batch` times along a new leading scene axis.
    Numpy leaves stay numpy (host); tensor leaves are copied on their
    device."""
    def rep(x):
        if isinstance(x, torch.Tensor):
            return x.unsqueeze(0).expand((batch,) + tuple(x.shape)).clone()
        x = np.asarray(x)
        return np.broadcast_to(x[None], (batch,) + x.shape).copy()

    return tree_map(rep, state)
