"""Raycast vehicle controller (counterpart of rapier_tpu.control.vehicle,
the reference's DynamicRayCastVehicleController,
ray_cast_vehicle_controller.rs:17).

One vehicle a scene, W wheels as lanes: per-wheel suspension rays through
`geometry.queries.cast_ray`, spring-damper suspension impulses,
engine / brake forward impulses, side friction (resolve_single_unilateral
:802) and the combined skid clamp (:660-700), as one function that returns
the chassis' new velocities ``[B, 3]``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from rapier_tpu_torch import precision as _prec
from rapier_tpu_torch.dynamics.solver.velocity_solver import effective_world_inv_inertia
from rapier_tpu_torch.geometry import queries
from rapier_tpu_torch.math import quat


@dataclass
class WheelDesc:
    """Per-wheel configuration, leading axis W (WheelTuning's defaults,
    ray_cast_vehicle_controller.rs:60-70)."""

    chassis_connection: torch.Tensor    # [W, 3] chassis-local hard point
    direction: torch.Tensor             # [W, 3] chassis-local down
    axle: torch.Tensor                  # [W, 3] chassis-local axle
    radius: torch.Tensor                # [W]
    suspension_rest_length: torch.Tensor   # [W]
    suspension_stiffness: torch.Tensor     # [W] (default 5.88)
    damping_compression: torch.Tensor      # [W] (default 0.83)
    damping_relaxation: torch.Tensor       # [W] (default 0.88)
    max_suspension_travel: torch.Tensor    # [W] (default 5.0)
    max_suspension_force: torch.Tensor     # [W] (default 6000)
    friction_slip: torch.Tensor            # [W] (default 10.5)
    side_friction_stiffness: torch.Tensor  # [W] (default 1.0)
    roll_influence: torch.Tensor           # [W] (default 0.1)

    def to(self, device) -> "WheelDesc":
        return dataclasses.replace(self, **{f.name: getattr(self, f.name).to(device)
                                            for f in dataclasses.fields(self)})


def default_wheels(connections, direction=(0, -1, 0), axle=(1, 0, 0), radius=0.3,
                   rest_length=0.4, device="cuda") -> WheelDesc:
    """The wheel table at `precision.FLOAT` (a builder: it reads the
    precision axis when it runs)."""
    ft = _prec.FLOAT
    conns = torch.as_tensor(connections, dtype=ft, device=device)
    w = conns.shape[0]
    ones = torch.ones((w,), dtype=ft, device=device)
    return WheelDesc(
        chassis_connection=conns,
        direction=torch.as_tensor(direction, dtype=ft, device=device).expand(w, 3),
        axle=torch.as_tensor(axle, dtype=ft, device=device).expand(w, 3),
        radius=ones * radius,
        suspension_rest_length=ones * rest_length,
        suspension_stiffness=ones * 5.88,
        damping_compression=ones * 0.83,
        damping_relaxation=ones * 0.88,
        max_suspension_travel=ones * 5.0,
        max_suspension_force=ones * 6000.0,
        friction_slip=ones * 10.5,
        side_friction_stiffness=ones * 1.0,
        roll_influence=ones * 0.1,
    )


class VehicleUpdate(NamedTuple):
    linvel: torch.Tensor             # [B, 3] new chassis linear velocity
    angvel: torch.Tensor             # [B, 3] new chassis angular velocity
    in_contact: torch.Tensor         # [B, W]
    suspension_length: torch.Tensor  # [B, W]
    ground_collider: torch.Tensor    # [B, W] int64


def _dot(a, b):
    return (a * b).sum(-1)


def _mv(m, v):
    """``m [..., 3, 3]`` times ``v [..., 3]``."""
    return (m * v.unsqueeze(-2)).sum(-1)


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)


def update_vehicle(bodies, colliders, chassis: int, wheels: WheelDesc, engine_force, brake,
                   steering, dt, forward_axis: int = 2, up_axis: int = 1, meshes=None,
                   hulls=None) -> VehicleUpdate:
    """One control update of the vehicle whose chassis is body `chassis` in
    every scene (update_vehicle, ray_cast_vehicle_controller.rs:408-486):
    suspension rays, suspension impulses, side and forward friction
    impulses with the skid clamp.  engine_force, brake and steering are
    ``[W]`` or ``[B, W]``.  Returns the chassis' new velocities."""
    dev = bodies.pos.device
    bsz = bodies.pos.shape[0]
    wheels = wheels.to(dev)
    wheels = dataclasses.replace(wheels, **{f.name: getattr(wheels, f.name).to(bodies.pos.dtype)
                                            for f in dataclasses.fields(wheels)})
    w = wheels.radius.shape[0]

    def per_wheel(x):
        return torch.as_tensor(x, dtype=bodies.pos.dtype, device=dev).expand(bsz, w)

    engine_force, brake, steering = per_wheel(engine_force), per_wheel(brake), per_wheel(steering)
    pos, rot = bodies.pos[:, chassis], bodies.rot[:, chassis]
    com = pos + quat.rotate(rot, bodies.local_com[:, chassis])
    linvel, angvel = bodies.linvel[:, chassis], bodies.angvel[:, chassis]
    inv_mass = bodies.inv_mass[:, chassis]
    mass = torch.where(inv_mass > 0, 1.0 / torch.clamp(inv_mass, min=1e-12), 0.0)
    ii = effective_world_inv_inertia(bodies, torch.ones_like(bodies.enabled))[:, chassis]
    e_up = torch.zeros(3, dtype=pos.dtype, device=dev)
    e_up[up_axis] = 1.0
    up_w = quat.rotate(rot, e_up.expand(bsz, 3))

    # Steering turns direction and axle about the wheel's "up"
    # (update_wheel_transform).
    wdir = wheels.direction.expand(bsz, w, 3)
    steer_q = quat.from_axis_angle(-wdir, steering)
    rot_w = rot.unsqueeze(1).expand(bsz, w, 4)
    dir_w = quat.rotate(rot_w, quat.rotate(steer_q, wdir))
    axle_w = quat.rotate(rot_w, quat.rotate(steer_q, wheels.axle.expand(bsz, w, 3)))
    hard_pt = pos.unsqueeze(1) + quat.rotate(rot_w, wheels.chassis_connection.expand(bsz, w, 3))

    rest, radius = wheels.suspension_rest_length, wheels.radius
    hit = queries.cast_ray(bodies, colliders, hard_pt, dir_w,
                           max_toi=(rest + radius).expand(bsz, w), exclude_body=chassis,
                           meshes=meshes, hulls=hulls)
    in_contact, toi = hit.hit, hit.toi
    travel = wheels.max_suspension_travel
    susp_len = torch.where(in_contact,
                           torch.clamp(toi - radius, min=rest - travel, max=rest + travel), rest)
    contact_pt = hard_pt + dir_w * toi.unsqueeze(-1)
    contact_n = torch.where(in_contact.unsqueeze(-1), hit.normal, -dir_w)
    com_w = com.unsqueeze(1)

    # Suspension force (update_suspension, :493-531).
    denom = _dot(contact_n, dir_w)
    clipped_inv = torch.where(denom >= -0.1, 10.0, -1.0 / denom)
    vel_at = linvel.unsqueeze(1) + quat.cross(angvel.unsqueeze(1), contact_pt - com_w)
    rel_vel = torch.where(denom >= -0.1, 0.0, _dot(contact_n, vel_at) * (-1.0 / denom))
    force = wheels.suspension_stiffness * (rest - susp_len) * clipped_inv
    force = force - torch.where(rel_vel < 0, wheels.damping_compression,
                                wheels.damping_relaxation) * rel_vel
    susp_force = torch.where(in_contact, torch.clamp(force * mass.unsqueeze(-1), min=0.0), 0.0)
    susp_force = torch.minimum(susp_force, wheels.max_suspension_force)

    def apply_impulse_at(lv, av, imp, point):
        return lv + imp * inv_mass.unsqueeze(-1), av + _mv(ii, quat.cross(point - com, imp))

    lv, av = linvel, angvel
    for k in range(w):
        lv, av = apply_impulse_at(lv, av, contact_n[:, k] * susp_force[:, k:k + 1] * dt,
                                  contact_pt[:, k])

    # Friction (update_friction, :534-700).
    proj_a = _dot(axle_w, contact_n)
    axle_t = _unit(axle_w - contact_n * proj_a.unsqueeze(-1))
    fwd_t = _unit(quat.cross(contact_n, axle_t))
    dpt = contact_pt - com_w

    def inv_denominator(n):
        v = quat.cross(_mv(ii.unsqueeze(1), quat.cross(dpt, n)), dpt)
        return 1.0 / torch.clamp(inv_mass.unsqueeze(-1) + _dot(n, v), min=1e-9)

    vel = lv.unsqueeze(1) + quat.cross(av.unsqueeze(1), dpt)
    # resolve_single_unilateral (:802-818), against static ground.
    side = -0.2 * _dot(axle_t, vel) * inv_denominator(axle_t) * wheels.side_friction_stiffness
    side = torch.where(in_contact, side, 0.0)
    rolling = -_dot(fwd_t, vel) * inv_denominator(fwd_t)
    rolling = torch.minimum(torch.maximum(rolling, -brake), brake)
    fwd_imp = torch.where(engine_force != 0.0, engine_force * dt, rolling)
    fwd_imp = torch.where(in_contact, fwd_imp, 0.0)

    # The combined skid clamp (:660-700).
    max_imp = susp_force * dt * wheels.friction_slip
    x, y = fwd_imp * 0.5, side * 1.0
    imp_sq = x * x + y * y
    skid = torch.where(imp_sq > max_imp * max_imp,
                       max_imp / torch.clamp(torch.sqrt(imp_sq), min=1e-9), 1.0)
    fwd_imp, side = fwd_imp * skid, side * skid
    for k in range(w):
        lv, av = apply_impulse_at(lv, av, fwd_t[:, k] * fwd_imp[:, k:k + 1], contact_pt[:, k])
        # The side impulse's point raised towards the COM by roll_influence.
        p = contact_pt[:, k]
        p = p - up_w * (_dot(up_w, p - com) * (1.0 - wheels.roll_influence[k])).unsqueeze(-1)
        lv, av = apply_impulse_at(lv, av, axle_t[:, k] * side[:, k:k + 1], p)
    return VehicleUpdate(linvel=lv, angvel=av, in_contact=in_contact,
                         suspension_length=susp_len, ground_collider=hit.collider)


def with_chassis_velocities(bodies, chassis: int, update: VehicleUpdate):
    """`bodies` with the chassis' velocities from `update` and the chassis
    awake (new tensors; the input is not written)."""
    linvel, angvel, sleeping = bodies.linvel.clone(), bodies.angvel.clone(), bodies.sleeping.clone()
    linvel[:, chassis] = update.linvel
    angvel[:, chassis] = update.angvel
    sleeping[:, chassis] = False
    return dataclasses.replace(bodies, linvel=linvel, angvel=angvel, sleeping=sleeping)
