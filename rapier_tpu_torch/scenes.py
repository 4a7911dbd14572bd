"""Benchmark / acceptance scenes (counterpart of rapier_tpu.scenes)."""

from __future__ import annotations

import numpy as np
import torch

from rapier_tpu_torch.types import tree_map
from rapier_tpu_torch.world import (
    ColliderBuilder,
    FixedJointBuilder,
    GenericJointBuilder,
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


def primitives3_world(num_layers: int = 20, grid: int = 8, rad: float = 1.0, **world_kw):
    """Upstream's primitives3 (SURVEY.md Appendix A, examples3d/primitives3.rs
    :13-60): a fixed ground cuboid (100.1, 2.1, 100.1) at y = -2.1, and
    `num_layers` layers of `grid` x `grid` bodies of radius `rad`, 3 rad
    apart, layer j at y = 3 rad j + 1.5 rad + 3 and shifted by -0.05 rad
    (grid - 1) in x and z a layer.  The shape cycles by layer, j % 5:
    capsule_y(rad, rad), ball(rad), round_cylinder(rad, rad, rad / 10),
    cone(rad, rad), capsule_y(rad, rad).  The layers start centred on the
    origin (the survey gives no start offset).  20 x 8 is upstream's size
    (1,280 bodies).  Returns (world, {"bodies": handles, "layer": bodies a
    layer})."""
    w = PhysicsWorld(**world_kw)
    ground = w.insert_body(RigidBodyBuilder.fixed().with_translation((0.0, -2.1, 0.0)))
    w.insert_collider(ColliderBuilder.cuboid(100.1, 2.1, 100.1), ground)
    shift = 3.0 * rad
    center = shift * (grid // 2)
    offset = 0.0
    bodies = []
    for j in range(num_layers):
        y = j * shift + shift / 2.0 + 3.0
        for i in range(grid):
            for k in range(grid):
                b = w.insert_body(RigidBodyBuilder.dynamic().with_translation(
                    (i * shift - center + offset, y, k * shift - center + offset)))
                w.insert_collider(_primitive(j % 5, rad), b)
                bodies.append(b)
        offset -= 0.05 * rad * (grid - 1)
    return w, {"bodies": bodies, "layer": grid * grid}


def _primitive(kind: int, rad: float):
    """primitives3's shape of a layer, by j % 5."""
    if kind == 1:
        return ColliderBuilder.ball(rad)
    if kind == 2:
        return ColliderBuilder.round_cylinder(rad, rad, rad / 10.0)
    if kind == 3:
        return ColliderBuilder.cone(rad, rad)
    return ColliderBuilder.capsule_y(rad, rad)


# The convex zoo's unit cube and octahedron point clouds.
CUBE_POINTS = [(x, y, z) for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]


def convex_zoo_world(gap: float = 0.02, **world_kw):
    """One body of each generic convex shape, from tests/test_convex_shapes.py
    and tests/test_convex_fallback.py, on a fixed ground cuboid (20, 1, 20)
    whose top is y = 0, each `gap` above its resting height: a cylinder
    (0.5, 0.5), a round cuboid (0.4, 0.3, 0.4, border 0.1), a round cone
    (0.5, 0.5, border 0.05), the convex hull of a unit cube, a compound cross
    of two cuboids (0.8, 0.2, 0.2) and (0.2, 0.2, 0.8), a voxel run of four
    0.5 cubes (merged into one box) and a cone (0.5, 0.5); beside the ground,
    a fixed halfspace ramp (normal (0.3, 1, 0), through (-10, 0, 0), above
    the ground for x < -10) with a round cylinder (0.3, 0.5, border 0.05)
    on it, its axis along the ramp's normal over the ramp's point at x = -13.
    Returns (world, {name: body handle})."""
    w = PhysicsWorld(**world_kw)
    ground = w.insert_body(RigidBodyBuilder.fixed().with_translation((0.0, -1.0, 0.0)))
    w.insert_collider(ColliderBuilder.cuboid(20.0, 1.0, 20.0), ground)
    ramp = w.insert_body(RigidBodyBuilder.fixed().with_translation((-10.0, 0.0, 0.0)))
    w.insert_collider(ColliderBuilder.halfspace((0.3, 1.0, 0.0)), ramp)
    n = np.array([0.3, 1.0, 0.0]) / np.hypot(0.3, 1.0)
    on_ramp = np.array([-13.0, 0.9, 0.0]) + n * 0.35
    handles = {}
    for name, xyz, collider in (
            ("cylinder", (0.0, 0.5, 0.0), ColliderBuilder.cylinder(0.5, 0.5)),
            ("round_cuboid", (2.0, 0.4, 0.0), ColliderBuilder.round_cuboid(0.4, 0.3, 0.4, 0.1)),
            ("round_cone", (4.0, 0.55, 0.0), ColliderBuilder.round_cone(0.5, 0.5, 0.05)),
            ("hull", (0.0, 0.5, 3.0), ColliderBuilder.convex_hull(CUBE_POINTS)),
            ("cross", (3.0, 0.2, 3.0), ColliderBuilder.compound([
                ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), ColliderBuilder.cuboid(0.8, 0.2, 0.2)),
                ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), ColliderBuilder.cuboid(0.2, 0.2, 0.8)),
            ])),
            ("voxels", (-2.0, 0.25, 6.0), ColliderBuilder.voxels(
                [(x * 0.5, 0.0, 0.0) for x in range(4)], 0.5)),
            ("cone", (-3.0, 0.5, 0.0), ColliderBuilder.cone(0.5, 0.5)),
            ("on_ramp", tuple(on_ramp), ColliderBuilder.round_cylinder(0.3, 0.5, 0.05))):
        x, y, z = xyz
        body = RigidBodyBuilder.dynamic().with_translation((x, y + gap, z))
        if name == "on_ramp":
            body = body.with_rotation((0.0, 0.0, -float(np.arctan(0.3))))
        b = w.insert_body(body)
        w.insert_collider(collider, b)
        handles[name] = b
    return w, handles


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


def _s2d_pyramid(w, base_count: int, half: float = 0.5, friction: float = 0.6):
    """The 2D box pyramid of tests/test_s2d.py:18-36 into `w`: a ground
    cuboid (100, 1) at y = -1, rows of half-`half` boxes 1.002 box widths
    apart, each row 1.002 box heights above the last.  Returns the boxes'
    handles."""
    from rapier_tpu_torch.world2d import ColliderBuilder2D, RigidBodyBuilder2D

    ground = w.insert_body(RigidBodyBuilder2D.fixed().with_translation((0.0, -1.0)))
    w.insert_collider(ColliderBuilder2D.cuboid(100.0, 1.0).with_friction(friction), ground)
    gap = half * 2.0 * 1.002
    boxes = []
    for row in range(base_count):
        n = base_count - row
        y = half * 1.002 + row * half * 2.004
        x0 = -(n - 1) * gap / 2.0
        for i in range(n):
            b = w.insert_body(RigidBodyBuilder2D.dynamic().with_translation((x0 + i * gap, y)))
            w.insert_collider(ColliderBuilder2D.cuboid(half, half).with_friction(friction), b)
            boxes.append(b)
    return boxes


def s2d_pyramid_world(base_count: int = 10, **world_kw):
    """s2d_pyramid (examples2d/s2d_pyramid.rs:13-38; SURVEY.md's full-size
    scene is base 100, 5,050 boxes) on `PhysicsWorld2D`, built as
    tests/test_s2d.py builds it.  Returns (world, {"boxes": handles}), the
    top box last."""
    from rapier_tpu_torch.world2d import PhysicsWorld2D

    w = PhysicsWorld2D(**world_kw)
    return w, {"boxes": _s2d_pyramid(w, base_count)}


def s2d_far_pyramid_world(**world_kw):
    """s2d_far_pyramid.rs as tests/test_s2d.py:227-259 builds it: a 10-row
    pyramid of half-0.5 boxes 1.25 box widths apart, far from the origin
    at (1e5, -8e4), where a float32 ulp is ~0.0078 (ROADMAP R2).  Returns
    (world, {"boxes": handles, "origin": (x, y)})."""
    from rapier_tpu_torch.world2d import ColliderBuilder2D, PhysicsWorld2D, RigidBodyBuilder2D

    w = PhysicsWorld2D(**world_kw)
    origin = np.array([100_000.0, -80_000.0])
    ground = w.insert_body(RigidBodyBuilder2D.fixed().with_translation(
        tuple((0, -1) + origin)))
    w.insert_collider(ColliderBuilder2D.cuboid(100.0, 1.0).with_friction(0.6), ground)
    base, h = 10, 0.5
    shift = 1.25 * h
    boxes = []
    for i in range(base):
        y = (2.0 * i + 1.0) * shift + 0.5
        for j in range(i, base):
            x = (i + 1.0) * shift + 2.0 * (j - i) * shift - h * base
            b = w.insert_body(RigidBodyBuilder2D.dynamic().with_translation(
                tuple(np.array([x, y]) + origin)))
            w.insert_collider(ColliderBuilder2D.cuboid(h, h).with_friction(0.6), b)
            boxes.append(b)
    return w, {"boxes": boxes, "origin": tuple(origin)}


def s2d_high_mass_ratio_world(**world_kw):
    """The heavy-on-light scene of tests/test_s2d.py:50-73 (the
    s2d_high_mass_ratio family): a box of density 25 resting on two light
    boxes.  Returns (world, {"heavy": handle, "light": [handles]})."""
    from rapier_tpu_torch.world2d import ColliderBuilder2D, PhysicsWorld2D, RigidBodyBuilder2D

    w = PhysicsWorld2D(**world_kw)
    ground = w.insert_body(RigidBodyBuilder2D.fixed().with_translation((0, -1)))
    w.insert_collider(ColliderBuilder2D.cuboid(50.0, 1.0).with_friction(0.5), ground)
    light = []
    for x in (-0.6, 0.6):
        b = w.insert_body(RigidBodyBuilder2D.dynamic().with_translation((x, 0.5)))
        w.insert_collider(ColliderBuilder2D.cuboid(0.3, 0.5).with_friction(0.5), b)
        light.append(b)
    heavy = w.insert_body(RigidBodyBuilder2D.dynamic().with_translation((0.0, 1.5)))
    w.insert_collider(
        ColliderBuilder2D.cuboid(1.2, 0.5).with_friction(0.5).with_density(25.0), heavy)
    return w, {"heavy": heavy, "light": light}


def s2d_coulomb_stack_world(**world_kw):
    """The Coulomb-friction scene of tests/test_s2d.py:310-334: a 6-row 2D
    pyramid under FrictionModel.COULOMB, and a box kicked along the ground
    at 6 m/s that friction brings to rest.  Returns (world, {"boxes":
    handles, "slider": handle})."""
    from rapier_tpu_torch.types import FrictionModel
    from rapier_tpu_torch.world2d import ColliderBuilder2D, PhysicsWorld2D, RigidBodyBuilder2D

    w = PhysicsWorld2D(**world_kw)
    w.params = w.params.replace(friction_model=int(FrictionModel.COULOMB))
    boxes = _s2d_pyramid(w, 6)
    slider = w.insert_body(RigidBodyBuilder2D.dynamic().with_translation((20.0, 0.55))
                           .with_linvel((6.0, 0.0)))
    w.insert_collider(ColliderBuilder2D.cuboid(0.5, 0.5).with_friction(0.4), slider)
    return w, {"boxes": boxes, "slider": slider}


def heightfield3_world(**world_kw):
    """examples/heightfield3.py's scene (reference examples3d/heightfield3.rs,
    cut to size): a 12 x 12 sin/cos heightfield over 16 x 1 x 16 on a fixed
    body, and 12 bodies cycling ball 0.4 / cuboid 0.35 / capsule_y(0.25,
    0.25), placed from RandomState(0).  Returns (world, {"bodies":
    handles})."""
    w = PhysicsWorld(**world_kw)
    n = 12
    xs = np.linspace(-8.0, 8.0, n)
    zs = np.linspace(-8.0, 8.0, n)
    heights = np.sin(xs[None, :]) + np.cos(zs[:, None])
    ground = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.heightfield(heights, (16.0, 1.0, 16.0)), ground)
    bodies = []
    rng = np.random.RandomState(0)
    for i in range(12):
        x, z = rng.uniform(-4, 4, 2)
        b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((x, 4.0 + (i % 4), z)))
        w.insert_collider(_mixed_shape(i, 0.4, 0.35, 0.25), b)
        bodies.append(b)
    return w, {"bodies": bodies}


def _mixed_shape(i: int, ball: float, half: float, cap: float):
    """The example's cycle: a ball, a cuboid, a capsule_y."""
    return (ColliderBuilder.ball(ball) if i % 3 == 0 else
            ColliderBuilder.cuboid(half, half, half) if i % 3 == 1 else
            ColliderBuilder.capsule_y(cap, cap))


def trimesh3_world(**world_kw):
    """The trimesh3 scene of tests/test_example_scenes.py:241-263 (reference
    examples3d/trimesh3.rs, cut to size): a 4-triangle valley, its floor line
    y = 0 along z at x = 0 and its walls rising to 0.5 at |x| = 2, and a ball
    of radius 0.3 dropped at (0.6, 3, 0), which rolls to the floor.  Returns
    (world, {"ball": handle})."""
    w = PhysicsWorld(**world_kw)
    verts = np.array([
        [-2, 0.5, -2], [0, 0, -2], [2, 0.5, -2],
        [-2, 0.5, 2], [0, 0, 2], [2, 0.5, 2],
    ], np.float32)
    tris = np.array([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4]], np.int32)
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.trimesh(verts, tris), g)
    b = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0.6, 3, 0)))
    w.insert_collider(ColliderBuilder.ball(0.3), b)
    return w, {"ball": b}


# The full-size heightfield3: upstream's 20 x 20 subdivisions and 20 layers
# of 8 x 8 bodies.
HF_FULL_SUBDIVS = 20
HF_FULL_LAYERS = 20
HF_FULL_GRID = 8


def heightfield3_full_world(**world_kw):
    """SURVEY.md's upstream heightfield3 (examples3d/heightfield3.rs:14-60) at
    its size: a 20 x 20-subdivision heightfield over 100 x 1 x 100 on a fixed
    body, heights sin(x) + cos(z) with x = 5 i, z = 5 j at row i, column j,
    and 10 on the border rows and columns; above it 20 layers of 8 x 8 bodies
    of radius 1, 3 apart, the bottom layer at y = 4.5.  The shape cycles by
    layer, j % 6, as upstream's does: cuboid(1, 1, 1), ball(1),
    round_cylinder(1, 1, 0.1), cone(1, 1), capsule_y(1, 1), and a compound
    of three cuboids, (1, 0.5, 0.5) at the origin and (0.5, 1, 0.5) at x = 1
    and x = -1.  1,280 bodies; 1,665 colliders (the compound is three) and
    800 triangles.  max_mesh_pairs is the number of body colliders, 1,664,
    so that no collider can lose its terrain pair (the reference drops the
    mesh pairs beyond it, ROADMAP R12).  Returns (world, {"bodies": handles,
    "layer": bodies per layer})."""
    w = PhysicsWorld(**world_kw)
    n = HF_FULL_SUBDIVS
    i, j = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    heights = np.sin(i * 100.0 / n) + np.cos(j * 100.0 / n)
    border = (i == 0) | (i == n) | (j == 0) | (j == n)
    heights = np.where(border, 10.0, heights)
    ground = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.heightfield(heights, (100.0, 1.0, 100.0)), ground)
    rad, grid = 1.0, HF_FULL_GRID
    shift = 3.0 * rad
    center = shift * (grid // 2)
    bodies = []
    for layer in range(HF_FULL_LAYERS):
        for gi in range(grid):
            for gk in range(grid):
                b = w.insert_body(RigidBodyBuilder.dynamic().with_translation(
                    (gi * shift - center, layer * shift + shift / 2.0 + 3.0,
                     gk * shift - center)))
                w.insert_collider(_heightfield3_shape(layer % 6, rad), b)
                bodies.append(b)
    w.params = w.params.replace(max_mesh_pairs=len(w._pending_colliders) - 1)
    return w, {"bodies": bodies, "layer": grid * grid}


def _heightfield3_shape(kind: int, rad: float):
    """Upstream heightfield3's shape of a layer, by j % 6."""
    ident = (0.0, 0.0, 0.0, 1.0)
    if kind == 0:
        return ColliderBuilder.cuboid(rad, rad, rad)
    if kind == 1:
        return ColliderBuilder.ball(rad)
    if kind == 2:
        return ColliderBuilder.round_cylinder(rad, rad, rad / 10.0)
    if kind == 3:
        return ColliderBuilder.cone(rad, rad)
    if kind == 4:
        return ColliderBuilder.capsule_y(rad, rad)
    return ColliderBuilder.compound([
        ((0.0, 0.0, 0.0), ident, ColliderBuilder.cuboid(rad, rad / 2.0, rad / 2.0)),
        ((rad, 0.0, 0.0), ident, ColliderBuilder.cuboid(rad / 2.0, rad, rad / 2.0)),
        ((-rad, 0.0, 0.0), ident, ColliderBuilder.cuboid(rad / 2.0, rad, rad / 2.0)),
    ])


# ccd3 (SURVEY.md:521-524): 5 walls, each an 8-high pyramid of boxes.
CCD3_WALLS = 5
CCD3_WALL_ROWS = 8
CCD3_WALL_SPACING = 10.0
CCD3_BALL_SPEED = 1000.0
CCD3_BALL_RADIUS = 0.5


def ccd3_world(walls: int = CCD3_WALLS, rows: int = CCD3_WALL_ROWS, **world_kw):
    """Upstream's ccd3 (examples3d/ccd3.rs:39-102, as SURVEY.md:521-524
    describes it): a ground of half-extents 50 x 0.1, `walls` walls each a
    `rows`-high pyramid of boxes of half-extents (0.5, 0.5, 1.0) (180 boxes
    at 5 x 8), and two density-10 balls at linvel (1000, 0, 0) with CCD, one
    of them also with soft CCD.  The upstream file is not in this checkout,
    so the layout is a reconstruction: the walls stand across the balls'
    path (boxes side by side along z, rows stacked in y, each row centred on
    z = 0) at x = 0, 10, 20, ... (CCD3_WALL_SPACING, the spacing of
    tests/test_ccd.py's ccd3 flavour; at 6 m the second ball meets the
    first wall's debris and the next wall in one sweep, more than the 16
    candidates a CCD collider keeps, and CCD drops 2); the balls take the
    reference's own ccd3 flavour (tests/test_ccd.py: radius 0.5, density 10,
    at y = 2, where two rows meet) and start at x = -20, one at z = -2.5,
    the other, with soft_ccd_prediction 1.0, at z = +2.5 (each row's box
    there is a whole box, not a seam).  Returns (world, {"boxes": [[...] a
    wall], "balls": [h, h], "wall_x": [...]})."""
    rb, cb = RigidBodyBuilder, ColliderBuilder
    w = PhysicsWorld(**world_kw)
    g = w.insert_body(rb.fixed().with_translation((0.0, -0.1, 0.0)))
    w.insert_collider(cb.cuboid(50.0, 0.1, 50.0), g)
    boxes, wall_x = [], []
    for k in range(walls):
        x = k * CCD3_WALL_SPACING
        wall = []
        for i in range(rows):
            for j in range(rows - i):
                z = (j - (rows - 1 - i) / 2.0) * 2.0
                b = w.insert_body(rb.dynamic().with_translation((x, 0.5 + i, z)))
                w.insert_collider(cb.cuboid(0.5, 0.5, 1.0), b)
                wall.append(b)
        boxes.append(wall)
        wall_x.append(x)
    balls = []
    for z, soft in ((-2.5, 0.0), (2.5, 1.0)):
        bb = rb.dynamic().with_translation((-20.0, 2.0, z)).with_linvel(
            (CCD3_BALL_SPEED, 0.0, 0.0)).with_ccd_enabled().with_soft_ccd_prediction(soft)
        balls.append(w.insert_body(bb))
        w.insert_collider(cb.ball(CCD3_BALL_RADIUS).with_density(10.0), balls[-1])
    return w, {"boxes": boxes, "balls": balls, "wall_x": wall_x}


_ALL_AXES = 0b111111
ARM_SHOULDER_TARGET = -1.35


def multibody_arm_world(coupled: bool = False, **world_kw):
    """examples/multibody_arm.py's scene: a 3-link capsule arm (revolute
    about z, position motors of stiffness 80 and damping 8, armature 0.05)
    on a fixed base, the shoulder commanded to ARM_SHOULDER_TARGET rad (the
    example sets it after building; here the builder does), and a ball of
    radius 0.25 on a pedestal in its sweep.  With `coupled`, the elbow's
    velocity is coupled to -1 x the shoulder's (`insert_dof_coupling`).
    Returns (world, {"links": [...], "ball": h, "pedestal": h})."""
    rb, cb = RigidBodyBuilder, ColliderBuilder
    w = PhysicsWorld(**world_kw)
    ground = w.insert_body(rb.fixed().with_translation((0, -1, 0)))
    w.insert_collider(cb.cuboid(20, 1, 20), ground)
    prev = w.insert_body(rb.fixed().with_translation((0, 0.0, 0)))
    links = []
    for i in range(3):
        b = w.insert_body(rb.dynamic().with_translation((0, 0.5 + i, 0)))
        w.insert_collider(cb.capsule_y(0.4, 0.08).with_density(300.0), b)
        jb = GenericJointBuilder(locked_axes=_ALL_AXES & ~(1 << 5))
        jb = jb.with_local_anchor1((0, 0.5, 0) if i else (0, 0, 0)).with_local_anchor2(
            (0, -0.5, 0))
        target = ARM_SHOULDER_TARGET if i == 0 else 0.0
        jb = jb.with_motor_position(5, target, 80.0, 8.0).with_armature(5, 0.05)
        w.insert_multibody_joint(prev, b, jb)
        links.append(b)
        prev = b
    pedestal = w.insert_body(rb.fixed().with_translation((1.8, 0.25, 0)))
    w.insert_collider(cb.cuboid(0.15, 0.25, 0.15), pedestal)
    ball = w.insert_body(rb.dynamic().with_translation((1.8, 0.8, 0)))
    w.insert_collider(cb.ball(0.25), ball)
    if coupled:
        w.insert_dof_coupling(links[1], 5, links[0], 5, -1.0)
    return w, {"links": links, "ball": ball, "pedestal": pedestal}


# examples/urdf_pendulum.py's robot: a fixed base and two arms on continuous
# joints about Z.
URDF_PENDULUM = """
<robot name="pendulum">
  <link name="base"><collision><geometry><box size="0.2 0.2 0.2"/></geometry></collision></link>
  <link name="arm1"><collision><origin xyz="0 -0.25 0"/><geometry><box size="0.05 0.5 0.05"/></geometry></collision></link>
  <link name="arm2"><collision><origin xyz="0 -0.25 0"/><geometry><capsule radius="0.04" length="0.4"/></geometry></collision></link>
  <joint name="shoulder" type="continuous"><parent link="base"/><child link="arm1"/><origin xyz="0 -0.1 0"/><axis xyz="0 0 1"/></joint>
  <joint name="elbow" type="continuous"><parent link="arm1"/><child link="arm2"/><origin xyz="0 -0.5 0"/><axis xyz="0 0 1"/></joint>
</robot>
"""


def urdf_pendulum_world(use_multibody: bool = False, **world_kw):
    """examples/urdf_pendulum.py: the double pendulum under a sideways pull,
    its base fixed at (0, 2, 0); impulse or multibody joints.  Returns
    (world, UrdfRobotHandles)."""
    from rapier_tpu_torch.loaders.urdf import load_urdf

    world_kw.setdefault("gravity", (-2.0, -9.81, 0.0))
    w = PhysicsWorld(**world_kw)
    return w, load_urdf(URDF_PENDULUM, w, root_translation=(0, 2, 0), fixed_base=True,
                        use_multibody=use_multibody)


# Three models of the reference's MJCF tests (tests/test_mjcf.py:159, :199,
# :231): a fixed tendon coupling two hinges, driven by a position servo; two
# free spheres held 1 m apart by an equality connect; a gravity-compensated
# slider (an ellipsoid, a site) beside a mocap body, a spatial tendon between
# them and a keyframe with a mocap pose.
MJCF_MODELS = {
    "tendon": """
<mujoco>
  <worldbody>
    <body name="root" pos="0 0 2">
      <body name="l1" pos="0 0 -0.4">
        <joint name="j1" type="hinge" axis="0 1 0"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.04"/>
        <body name="l2" pos="0 0 -0.4">
          <joint name="j2" type="hinge" axis="0 1 0"/>
          <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.04"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="curl"><joint joint="j1" coef="1"/><joint joint="j2" coef="1"/></fixed>
  </tendon>
  <actuator><position name="a1" joint="j1" kp="80" kv="8"/></actuator>
</mujoco>
""",
    "connect": """
<mujoco>
  <worldbody>
    <body name="a" pos="0 0 1"><joint type="free"/><geom type="sphere" size="0.2"/></body>
    <body name="b" pos="1 0 1"><joint type="free"/><geom type="sphere" size="0.2"/></body>
  </worldbody>
  <equality><connect name="link" body1="a" body2="b" anchor="0.5 0 0"/></equality>
</mujoco>
""",
    "gravcomp_mocap": """
<mujoco>
  <worldbody>
    <geom type="plane" size="10 10 0.1"/>
    <body name="float" pos="0 0 1" gravcomp="1">
      <joint name="lift" type="slide" axis="0 0 1"/>
      <geom type="ellipsoid" size="0.3 0.2 0.1" density="500"/>
      <site name="s_base" pos="0 0 0.1"/>
    </body>
    <body name="target" pos="0.5 0 1.5" mocap="true">
      <geom type="sphere" size="0.05" density="100"/>
      <site name="s_tip" pos="0 0 0"/>
    </body>
  </worldbody>
  <tendon><spatial name="cable"><site site="s_base"/><site site="s_tip"/></spatial></tendon>
  <sensor><tendonpos name="cable_len" tendon="cable"/></sensor>
  <keyframe><key name="home" qpos="0" mpos="0.5 0.5 2.0" mquat="1 0 0 0"/></keyframe>
</mujoco>
""",
}


def mjcf_model_world(name: str, use_multibody: bool = False, **world_kw):
    """One of MJCF_MODELS loaded into a Z-up world.  Returns (world,
    MjcfRobotHandles)."""
    from rapier_tpu_torch.loaders.mjcf import load_mjcf

    world_kw.setdefault("gravity", (0.0, 0.0, -9.81))
    w = PhysicsWorld(**world_kw)
    return w, load_mjcf(MJCF_MODELS[name], w, use_multibody=use_multibody)


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
