"""Kinematic character controller: collide-and-slide by shape casts
(counterpart of rapier_tpu.control.character, the reference's
KinematicCharacterController, character_controller.rs:173, move_shape :267).

One character a scene: poses ``[B, 3]`` / ``[B, 4]``, movements ``[B, 3]``.
The reference's fixed-iteration loop is a Python loop of `max_iterations`
passes; every pass casts for all scenes at once and a scene whose motion is
used up keeps its state through the pass's masks.  Once no scene has motion
left the loop stops (one host read a pass): the remaining passes would
change no output.  Autostep (lift, advance,
settle, committed only when every leg is clear) and snap-to-ground follow
character_controller.rs:68.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from rapier_tpu_torch.dynamics.solver.velocity_solver import effective_world_inv_inertia
from rapier_tpu_torch.geometry import gjk as _gjk
from rapier_tpu_torch.geometry import queries
from rapier_tpu_torch.geometry.dispatch import collider_world_poses
from rapier_tpu_torch.math import quat
from rapier_tpu_torch.types import BodyType
from rapier_tpu_torch.utils.routing import make_segment_plan, segment_sum


@dataclass(frozen=True)
class CharacterControllerOptions:
    """The reference controller's knobs (character_controller.rs:68+)."""

    offset: float = 0.01                 # gap kept between character and world
    up: tuple = (0.0, 1.0, 0.0)
    max_slope_climb_angle: float = 0.8   # radians (~45 deg)
    min_slope_slide_angle: float = 0.2
    slide: bool = True
    max_iterations: int = 6
    snap_to_ground: float = 0.2          # max snap distance (0 disables)
    # Autostep (CharacterAutostep): step onto obstacles no taller than
    # max_height with min_width of clear landing; 0 disables.
    autostep_max_height: float = 0.0
    autostep_min_width: float = 0.1


class CharacterMovement(NamedTuple):
    translation: torch.Tensor   # [B, 3] the movement achieved
    grounded: torch.Tensor      # [B]
    hit_obstacle: torch.Tensor  # [B]: a cast hit during the solve
    remaining: torch.Tensor     # [B, 3] the blocked movement (push impulses)


def _dot(a, b):
    return (a * b).sum(-1)


def _angle_from(n, up):
    return torch.arccos(torch.clamp(_dot(n, up), -1.0, 1.0))


def move_shape(bodies, colliders, shape_type, shape_params, pos, rot, desired_translation,
               options: CharacterControllerOptions = CharacterControllerOptions(),
               exclude_collider=-1, exclude_body=-1, flags: int = 0, meshes=None,
               hulls=None) -> CharacterMovement:
    """The movement a kinematic character shape can make towards
    `desired_translation` in each scene."""
    dev = bodies.pos.device
    bsz = bodies.pos.shape[0]
    up = torch.tensor(options.up, dtype=bodies.pos.dtype, device=dev)
    pos = torch.as_tensor(pos, dtype=bodies.pos.dtype, device=dev).expand(bsz, 3)
    rot = torch.as_tensor(rot, dtype=bodies.pos.dtype, device=dev).expand(bsz, 4)
    desired = torch.as_tensor(desired_translation, dtype=bodies.pos.dtype,
                              device=dev).expand(bsz, 3)
    kw = dict(flags=flags, exclude_collider=exclude_collider, exclude_body=exclude_body,
              meshes=meshes, hulls=hulls)

    def cast(start, direction, max_toi):
        hit = queries.cast_shape(bodies, colliders, shape_type, shape_params,
                                 start.unsqueeze(1), rot.unsqueeze(1),
                                 direction.expand(bsz, 3).unsqueeze(1), max_toi, **kw)
        return hit.hit[:, 0], hit.toi[:, 0], hit.normal[:, 0]

    total = torch.zeros_like(desired)
    remaining = desired
    any_hit = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    for _ in range(options.max_iterations):
        dist = torch.linalg.norm(remaining, dim=-1)
        active = dist > 1e-7
        if not bool(active.any()):
            # No scene has motion left: a pass would change no output.
            break
        unit = remaining / torch.clamp(dist, min=1e-9).unsqueeze(-1)
        hit, toi, n = cast(pos + total, unit, (dist + options.offset).unsqueeze(-1))
        blocked = hit & active
        allowed = torch.where(blocked, torch.clamp(toi - options.offset, min=0.0), dist)
        step_vec = unit * allowed.unsqueeze(-1)
        total = total + torch.where(active.unsqueeze(-1), step_vec, 0.0)
        left = remaining - step_vec
        # Slide: drop the into-surface component (character_controller.rs
        # slide pass); floors and walls alike.
        is_wall_or_steep = _angle_from(n, up) > options.max_slope_climb_angle
        into = torch.clamp(_dot(left, n), max=0.0)
        slid = left - n * into.unsqueeze(-1)
        remaining = torch.where(blocked.unsqueeze(-1), slid, 0.0)
        any_hit = any_hit | blocked

        if options.autostep_max_height > 0.0:
            # Lift -> advance -> settle, committed only if every leg is clear.
            horiz = left - up * _dot(left, up).unsqueeze(-1)
            h_dist = torch.linalg.norm(horiz, dim=-1)
            h_unit = horiz / torch.clamp(h_dist, min=1e-9).unsqueeze(-1)
            want_step = blocked & is_wall_or_steep & (h_dist > 1e-6)
            up_hit, up_toi, _ = cast(pos + total, up, options.autostep_max_height)
            lift = torch.where(up_hit, torch.clamp(up_toi - options.offset, min=0.0),
                               options.autostep_max_height)
            lifted = pos + total + up * lift.unsqueeze(-1)
            fwd_hit, fwd_toi, _ = cast(lifted, h_unit,
                                       options.autostep_min_width + options.offset)
            fwd_clear = ~fwd_hit | (fwd_toi >= options.autostep_min_width)
            advanced = lifted + h_unit * options.autostep_min_width
            down_hit, down_toi, down_n = cast(advanced, -up,
                                              (lift + options.offset).unsqueeze(-1))
            land_ok = down_hit & (_angle_from(down_n, up) <= options.max_slope_climb_angle)
            do_step = want_step & (lift > options.offset) & fwd_clear & land_ok
            settle = torch.clamp(down_toi - options.offset, min=0.0)
            step_delta = (up * (lift - settle).unsqueeze(-1)
                          + h_unit * options.autostep_min_width)
            total = total + torch.where(do_step.unsqueeze(-1), step_delta, 0.0)
            # The stepped width uses up that much of the remaining motion.
            rem_after = left - h_unit * torch.clamp(h_dist, max=options.autostep_min_width
                                                    ).unsqueeze(-1)
            remaining = torch.where(do_step.unsqueeze(-1), rem_after, remaining)

    # Grounded test and snap to ground: a short downward cast.
    down_hit, down_toi, down_n = cast(pos + total, -up, options.offset * 3.0
                                      + options.snap_to_ground)
    floor_ok = _angle_from(down_n, up) <= options.max_slope_climb_angle
    grounded = down_hit & (down_toi <= options.offset * 3.0) & floor_ok
    moving_up = _dot(desired, up) > 1e-6
    can_snap = ((options.snap_to_ground > 0.0) & down_hit & ~moving_up
                & (down_toi > options.offset)
                & (down_toi <= options.offset + options.snap_to_ground) & floor_ok)
    total = total + torch.where(can_snap.unsqueeze(-1),
                                -up * (down_toi - options.offset).unsqueeze(-1), 0.0)
    return CharacterMovement(translation=total, grounded=grounded | can_snap,
                             hit_obstacle=any_hit, remaining=desired - total)


def solve_character_collision_impulses(
        bodies, colliders, shape_type, shape_params, pos, rot, translation_remaining, dt,
        character_mass, options: CharacterControllerOptions = CharacterControllerOptions(),
        exclude_collider=-1, exclude_body=-1, hulls=None, shape_hull=None):
    """Push the dynamic bodies the character meets
    (character_controller.rs:840-933): each dynamic collider within the
    contact prediction of the character's final pose takes the blocked
    movement as a velocity along the contact normal, weighted by the reduced
    mass m_b m_c / (m_b + m_c), at the closest point (one exact GJK closest
    point a collider, as the reference: the same total impulse as its
    per-point impulses, an approximate torque arm).  Returns the bodies
    with those velocity changes; pushed bodies wake up."""
    dev = bodies.pos.device
    bsz, n_b = bodies.pos.shape[:2]
    n_c = colliders.shape_type.shape[1]
    pos = torch.as_tensor(pos, dtype=bodies.pos.dtype, device=dev).expand(bsz, 3)
    rot = torch.as_tensor(rot, dtype=bodies.pos.dtype, device=dev).expand(bsz, 4)
    rem = torch.as_tensor(translation_remaining, dtype=bodies.pos.dtype, device=dev).expand(bsz, 3)
    prm = torch.as_tensor(shape_params, dtype=bodies.pos.dtype, device=dev).expand(bsz, 12)

    w_pos, w_rot = collider_world_poses(bodies, colliders)
    ok = queries._filter_mask(
        colliders, bodies.body_type,
        queries.EXCLUDE_FIXED | queries.EXCLUDE_KINEMATIC | queries.EXCLUDE_SENSORS,
        exclude_collider, exclude_body)
    hv_table = queries._hull_table(colliders, hulls)
    # Every (scene, collider) lane, flattened for GJK.
    pA = pos.unsqueeze(1).expand(bsz, n_c, 3).reshape(-1, 3)
    rA = rot.unsqueeze(1).expand(bsz, n_c, 4).reshape(-1, 4)
    prmA = prm.unsqueeze(1).expand(bsz, n_c, 12).reshape(-1, 12)
    stA = torch.full((bsz * n_c,), int(shape_type), dtype=torch.int32, device=dev)
    pB, rB = w_pos.reshape(-1, 3), w_rot.reshape(-1, 4)
    tB, prmB = colliders.shape_type.reshape(-1), colliders.shape_params.reshape(-1, 12)
    hvA = None if shape_hull is None else torch.as_tensor(
        shape_hull, dtype=bodies.pos.dtype, device=dev).expand((bsz * n_c,) + tuple(
            shape_hull.shape[-2:]))
    hvB = None if hv_table is None else hv_table.reshape((-1,) + hv_table.shape[2:])
    supp = _gjk.make_support(pA, rA, stA, prmA, pB, rB, tB, prmB, hullA=hvA, hullB=hvB)
    d0 = pB - pA
    d0 = torch.where((torch.linalg.norm(d0, dim=-1) < 1e-9).unsqueeze(-1),
                     torch.tensor([0.0, 1.0, 0.0], dtype=d0.dtype, device=dev), d0)
    g = _gjk.gjk(supp, d0)
    b_B = _gjk._border_radius(tB, prmB)
    gap = torch.where(g["intersect"], 0.0, g["dist"] - _gjk._border_radius(stA, prmA) - b_B)
    # The normal from the character to the obstacle; the contact point on
    # the obstacle's surface.
    n_c3 = g["normal"].view(bsz, n_c, 3)
    p_c = (g["cpB"] - g["normal"] * b_B.unsqueeze(-1)).view(bsz, n_c, 3)
    touching = ok & (gap.view(bsz, n_c) <= options.offset * 3.0)

    parent = colliders.parent.clamp(min=0).long()
    dyn = (torch.gather(bodies.body_type, 1, parent) == BodyType.DYNAMIC) & (colliders.parent >= 0)
    push = touching & dyn
    dt = torch.as_tensor(dt, dtype=bodies.pos.dtype, device=dev)
    inv_dt = torch.where(dt == 0, 0.0, 1.0 / dt).to(dt.dtype)
    v_transfer = _dot(n_c3, rem.unsqueeze(1)) * inv_dt       # [B, C] along n

    def at_parent(x):
        return torch.gather(x, 1, parent.view(parent.shape + (1,) * (x.dim() - 2)).expand(
            parent.shape + x.shape[2:]))

    com_w = bodies.pos + quat.rotate(bodies.rot, bodies.local_com)
    arm = p_c - at_parent(com_w)
    v_at = at_parent(bodies.linvel) + quat.cross(at_parent(bodies.angvel), arm)
    delta = v_transfer - _dot(v_at, n_c3)
    im_p = at_parent(bodies.inv_mass)
    m_body = torch.where(im_p > 0, 1.0 / torch.clamp(im_p, min=1e-12), 0.0)
    m_char = torch.as_tensor(character_mass, dtype=bodies.pos.dtype, device=dev)
    mass_ratio = m_body * m_char / torch.clamp(m_body + m_char, min=1e-9)
    imp = n_c3 * (torch.clamp(delta, min=0.0) * mass_ratio * push).unsqueeze(-1)
    # At the point: dv = im imp, dw = I_w^-1 (arm x imp), summed per body.
    ii = effective_world_inv_inertia(bodies, torch.ones_like(bodies.enabled))
    # Sums per body in a fixed order (no float atomics).
    plan = make_segment_plan(parent, n_b)
    dv = segment_sum((imp * im_p.unsqueeze(-1)).transpose(1, 2), plan).transpose(1, 2)
    torque = segment_sum(quat.cross(arm, imp).transpose(1, 2), plan).transpose(1, 2)
    dw = torch.einsum("bnij,bnj->bni", ii, torque)
    woke = torch.zeros((bsz, n_b), dtype=torch.int32, device=dev).scatter_reduce(
        1, parent, push.int(), "amax") > 0
    return dataclasses.replace(
        bodies, linvel=bodies.linvel + dv, angvel=bodies.angvel + dw,
        sleeping=bodies.sleeping & ~woke,
        sleep_timer=torch.where(woke, 0.0, bodies.sleep_timer))
