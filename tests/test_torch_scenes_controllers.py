"""The reference's tests/test_controllers.py scenarios on rapier_tpu_torch,
on the CPU (ROADMAP queue 1 item 2).

Each test builds its scene with the port's builders (`device="cpu"`), runs
the port's controllers (`control/character.py`, `control/vehicle.py`,
`control/pid.py`) and steps with the port's `PhysicsWorld`, and keeps the
reference test's own checks and thresholds.  The reference marks its file
slow; these run in tier-1, each under 20 s on the port.
"""

import numpy as np
import pytest
import torch

from rapier_tpu_torch.control.character import CharacterControllerOptions, move_shape
from rapier_tpu_torch.control.pid import PdGains, pd_force_and_torque
from rapier_tpu_torch.control.vehicle import (
    default_wheels,
    update_vehicle,
    with_chassis_velocities,
)
from rapier_tpu_torch.types import ShapeType
from rapier_tpu_torch.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

IDQ = torch.tensor([0.0, 0.0, 0.0, 1.0])


@pytest.fixture(scope="module")
def walled_scene():
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.halfspace((0, 1, 0)), g)
    wall = w.insert_body(RigidBodyBuilder.fixed().with_translation((3, 1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.2, 2.0, 5.0), wall)
    w.build()
    return w


def _capsule_params():
    return torch.tensor([0.0, -0.4, 0.0, 0.0, 0.4, 0.0, 0.3] + [0.0] * 5)


def _move(w, start, want, options):
    s = w.state
    mv = move_shape(s.bodies, s.colliders, int(ShapeType.CAPSULE), _capsule_params(),
                    torch.tensor([start]), IDQ, torch.tensor([want]), options)
    return type(mv)(*[x[0] for x in mv])


def test_character_free_move(walled_scene):
    mv = _move(walled_scene, (0.0, 1.0, 0.0), (0.5, 0.0, 0.0),
               CharacterControllerOptions(snap_to_ground=0.0))
    np.testing.assert_allclose(mv.translation.numpy(), [0.5, 0, 0], atol=1e-3)


def test_character_blocked_by_wall(walled_scene):
    mv = _move(walled_scene, (0.0, 1.0, 0.0), (5.0, 0.0, 0.0),
               CharacterControllerOptions(snap_to_ground=0.0))
    # Stops at the wall (x = 3 - 0.2 - 0.3 = 2.5) minus the offset.
    assert bool(mv.hit_obstacle)
    assert 2.3 < float(mv.translation[0]) < 2.52
    assert abs(float(mv.translation[2])) < 1e-3


def test_character_slides_along_wall(walled_scene):
    mv = _move(walled_scene, (2.3, 1.0, 0.0), (1.0, 0.0, 1.0),
               CharacterControllerOptions(snap_to_ground=0.0))
    # x blocked at the wall, z slides through.
    assert float(mv.translation[2]) > 0.8
    assert float(mv.translation[0]) < 0.25


def test_character_grounded_and_snap(walled_scene):
    mv = _move(walled_scene, (0.0, 0.8, 0.0), (0.2, 0.0, 0.0),
               CharacterControllerOptions(snap_to_ground=0.3))
    assert bool(mv.grounded)
    # Snapped down towards the floor (capsule bottom at y=0.8-0.7=0.1).
    assert float(mv.translation[1]) < -0.05


def test_pd_controller_drives_to_target():
    w = PhysicsWorld(gravity=(0, 0, 0), device="cpu")
    b = w.insert_body(RigidBodyBuilder.dynamic())
    w.insert_collider(ColliderBuilder.ball(0.5), b)
    w.build()
    target = torch.zeros((1, 8, 3))
    target[0, b, 0] = 2.0
    idq = IDQ.expand(1, 8, 4)
    zero = torch.zeros((1, 8, 3))
    for _ in range(120):
        force, _ = pd_force_and_torque(w.state.bodies, target, idq, zero, zero,
                                       PdGains(lin_kp=30.0, lin_kd=10.0))
        w.state.bodies.force.copy_(force)
        w.step()
    assert abs(w.body_translation(b)[0] - 2.0) < 0.1


def _drive(w, chassis, wheels, steps, engine, steering):
    upd = None
    for _ in range(steps):
        b = w.state.bodies
        upd = update_vehicle(b, w.state.colliders, chassis, wheels, engine_force=engine,
                             brake=torch.zeros(4), steering=steering, dt=w.params.dt)
        w.state.bodies = with_chassis_velocities(b, chassis, upd)
        w.step()
    return upd


def test_vehicle_drives_forward():
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed())
    w.insert_collider(ColliderBuilder.halfspace((0, 1, 0)).with_friction(1.0), g)
    chassis = w.insert_body(RigidBodyBuilder.dynamic().with_translation((0, 0.6, 0)))
    w.insert_collider(ColliderBuilder.cuboid(0.6, 0.2, 1.0), chassis)
    w.build()
    wheels = default_wheels(
        [(-0.5, 0.0, -0.8), (0.5, 0.0, -0.8), (-0.5, 0.0, 0.8), (0.5, 0.0, 0.8)],
        radius=0.25, rest_length=0.3, device="cpu")
    upd = _drive(w, chassis, wheels, 90, torch.full((4,), 8.0), torch.zeros(4))
    p = w.body_translation(chassis)
    # Reference convention: forward = contact_normal x axle; with up normal
    # and +x axles that is -z.
    assert p[2] < -1.0, f"vehicle should drive forward (-z), at {p}"
    assert 0.2 < p[1] < 1.0  # suspension holds it off the ground
    assert bool(upd.in_contact.all())


def test_character_autostep_onto_ledge():
    """CharacterAutostep (character_controller.rs:68): a capsule walking into
    a 0.2-high ledge steps up onto it when autostep is enabled, and is
    blocked when it is not."""
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, -0.5, 0)))
    w.insert_collider(ColliderBuilder.cuboid(20, 0.5, 20), g)
    ledge = w.insert_body(RigidBodyBuilder.fixed().with_translation((2.0, 0.1, 0)))
    w.insert_collider(ColliderBuilder.cuboid(1.0, 0.1, 5.0), ledge)
    w.build()
    prm = torch.tensor([0.0, -0.3, 0.0, 0.0, 0.3, 0.0, 0.25] + [0.0] * 5)
    start = torch.tensor([[0.0, 0.56, 0.0]])
    want = torch.tensor([[1.6, 0.0, 0.0]])
    s = w.state
    blocked = move_shape(s.bodies, s.colliders, int(ShapeType.CAPSULE), prm, start, IDQ, want,
                         CharacterControllerOptions(autostep_max_height=0.0))
    stepped = move_shape(s.bodies, s.colliders, int(ShapeType.CAPSULE), prm, start, IDQ, want,
                         CharacterControllerOptions(autostep_max_height=0.35,
                                                    autostep_min_width=0.3))
    xb = float(blocked.translation[0, 0])
    xs = float(stepped.translation[0, 0])
    ys = float(stepped.translation[0, 1])
    assert xb < 1.2, f"should be blocked without autostep, moved {xb}"
    assert xs > xb + 0.2, f"autostep should advance further: {xs} vs {xb}"
    assert ys > 0.1, f"autostep should lift the character: dy={ys}"


def test_vehicle_holds_curve():
    """Side-friction resolution (ray_cast_vehicle_controller.rs:409-486):
    with steering applied, the vehicle yaws and follows a curve instead of
    plowing straight."""
    from rapier_tpu_torch.scenes import VEHICLE_WHEELS, vehicle_world

    w, h = vehicle_world(device="cpu")
    w.build()
    wheels = default_wheels(VEHICLE_WHEELS, radius=0.25, rest_length=0.3, device="cpu")
    steer = torch.tensor([0.35, 0.35, 0.0, 0.0])   # front-wheel steering
    _drive(w, h["chassis"], wheels, 150, torch.full((4,), 6.0), steer)
    p = w.body_translation(h["chassis"])
    assert np.isfinite(p).all()
    # Curved path: significant lateral displacement relative to forward travel.
    assert abs(p[0]) > 0.8, f"vehicle did not turn: {p}"
    assert 0.2 < p[1] < 1.0


def test_character_pushes_dynamic_box():
    """Character push impulses (reference character_controller.rs:840
    solve_character_collision_impulses): walking into a dynamic box
    transfers momentum along the contact normal, shoving it forward; a
    massless character (impulses off) leaves it asleep-still."""
    from rapier_tpu_torch.scenes import character_world

    cap = [0.0, -0.4, 0.0, 0.0, 0.4, 0.0, 0.3]

    # Push: character at x=0 walks +x into the box with 80 kg behind it.
    w, h = character_world(device="cpu")
    w.build()
    box = h["box"]
    v0 = w.body_linvel(box).copy()
    mv = w.move_character(ShapeType.CAPSULE, cap, (0.0, 0.75, 0.0), (0, 0, 0, 1),
                          (0.6, 0.0, 0.0), character_mass=80.0, dt=1.0 / 60.0)
    assert bool(mv.hit_obstacle)
    v1 = w.body_linvel(box)
    assert v1[0] > 0.3, f"box not pushed: {v0} -> {v1}"
    # A few steps later the box has actually moved away.
    x0 = float(w.body_translation(box)[0])
    w.step(30)
    assert float(w.body_translation(box)[0]) > x0 + 0.05

    # No impulses: same move with apply_impulses=False leaves it still.
    w2, h2 = character_world(device="cpu")
    w2.build()
    w2.move_character(ShapeType.CAPSULE, cap, (0.0, 0.75, 0.0), (0, 0, 0, 1),
                      (0.6, 0.0, 0.0), character_mass=80.0, apply_impulses=False)
    assert abs(float(w2.body_linvel(h2["box"])[0])) < 1e-6


def test_character_cast_sees_trimesh():
    """tests/test_queries.py::test_character_cast_sees_trimesh: the
    collide-and-slide downward cast lands on a trimesh floor."""
    w = PhysicsWorld(device="cpu")
    g = w.insert_body(RigidBodyBuilder.fixed())
    verts = np.array([[-10, 0, -10], [10, 0, -10], [10, 0, 10], [-10, 0, 10]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    w.insert_collider(ColliderBuilder.trimesh(verts, tris), g)
    w.build()
    s = w.state
    mv = move_shape(s.bodies, s.colliders, int(ShapeType.CAPSULE),
                    torch.tensor([0.0, -0.5, 0.0, 0.0, 0.5, 0.0, 0.3, 0, 0, 0, 0, 0]),
                    torch.tensor([[0.0, 2.0, 0.0]]), IDQ, torch.tensor([[0.0, -5.0, 0.0]]),
                    CharacterControllerOptions(), meshes=s.meshes, hulls=s.hulls)
    # Capsule bottom is at y-0.8; floor at 0 => allowed downward ~1.2.
    dy = float(mv.translation[0, 1])
    assert -1.35 < dy < -1.0, dy
    assert bool(mv.grounded[0])
