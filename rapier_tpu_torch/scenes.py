"""Benchmark / acceptance scenes (counterpart of rapier_tpu.scenes)."""

from __future__ import annotations

import numpy as np
import torch

from rapier_tpu_torch.types import tree_map
from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder


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
    """Quadruped standing on a plane, as a reduced-coordinate articulation.
    Returns (world, MjcfRobotHandles).  The impulse-joint form
    (use_multibody=False) is not ported."""
    from rapier_tpu_torch.loaders.mjcf import load_mjcf

    world_kw.setdefault("gravity", (0.0, 0.0, -9.81))
    w = PhysicsWorld(**world_kw)
    return w, load_mjcf(_quadruped_xml(), w, use_multibody=use_multibody)


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
