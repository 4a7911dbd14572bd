"""Collision detection without dynamics (counterpart of
rapier_tpu.pipeline.collision_pipeline).

`collide(state, params, hooks=None) -> (state, StepEvents)` runs the broad
phase, the narrow phase (with the mesh lanes) and the event bookkeeping of a
step over a ``[B, ...]`` batch, and nothing else: no solve, no integration,
no sleeping (collision_pipeline.rs:29).  Only the contact cache changes; the
matched warmstart impulses are carried through, so a later `step`
warmstarts as if the collide had not run.  Of the hooks only the contact
filter applies, and only to `touching` (the reference's :82-87).
"""

from __future__ import annotations

import torch

from rapier_tpu_torch.geometry import broadphase, shapes
from rapier_tpu_torch.geometry.dispatch import (
    collider_world_poses,
    compute_manifolds,
    compute_mesh_manifolds,
    concat_manifolds,
)
from rapier_tpu_torch.pipeline.hooks import apply_contact_filter
from rapier_tpu_torch.pipeline.physics_pipeline import StepEvents, _match_previous
from rapier_tpu_torch.types import (
    ACTIVE_EVENTS_COLLISION,
    BodyType,
    Contacts,
    SceneState,
    SimParams,
)



def collide(state: SceneState, params: SimParams, hooks=None):
    """One collision-detection pass (collision_pipeline.rs:66-229) with the
    step's AABB margins (without the soft-CCD margin, as the reference),
    pair filters and manifold kernels."""
    bodies, colliders = state.bodies, state.colliders
    w_pos, w_rot = collider_world_poses(bodies, colliders)
    mins, maxs = shapes.compute_aabbs(colliders.shape_type, colliders.shape_params, w_pos, w_rot)
    margin = (colliders.contact_skin
              + float(params.real(0.5) * params.prediction_distance())
              + float(params.real(0.01) * params.real(params.length_unit))).unsqueeze(-1)
    mins, maxs = mins - margin, maxs + margin

    mesh_lanes = (params.max_mesh_pairs * params.tris_per_pair
                  if state.meshes is not None else 0)
    convex_pairs = state.contacts.max_pairs - mesh_lanes
    if convex_pairs <= 0:
        raise ValueError(f"max_pairs {state.contacts.max_pairs} leaves no lane beside "
                         f"the {mesh_lanes} mesh lanes")
    bp_body_type = torch.where(bodies.mb_link, int(BodyType.DYNAMIC), bodies.body_type)
    c1, c2, pair_valid, bp_overflow = broadphase.find_pairs(
        mins, maxs, colliders, bp_body_type, convex_pairs, params.broad_phase,
        params.sap_window)

    prediction = float(params.prediction_distance())
    man = compute_manifolds(bodies, colliders, c1, c2, pair_valid, prediction,
                            present=params.shape_types_present, hulls=state.hulls,
                            dt=params.dt)
    if state.meshes is not None:
        man = concat_manifolds(man, compute_mesh_manifolds(
            bodies, colliders, state.meshes, c1, c2, pair_valid, prediction,
            params.max_mesh_pairs, params.tris_per_pair,
            present=params.shape_types_present))
    man = apply_contact_filter(hooks, bodies, colliders, man, fields=("touching",))

    ws_n, ws_t, ws_tw, _prev_imp, prev_touch, _matched, still = _match_previous(
        state.contacts, man)
    started = man.touching & ~prev_touch
    prev_c = state.contacts
    stopped = prev_c.touching & ~still & (prev_c.pair_key >= 0)

    contacts = Contacts(
        pair_key=torch.where(man.valid, man.pair_key, -1),
        body1=man.body1, body2=man.body2,
        collider1=man.collider1, collider2=man.collider2,
        normal=man.normal, point=man.point, dist=man.dist,
        feature_id=man.fid, point_active=man.point_active,
        num_points=torch.sum(man.point_active.int(), dim=1, dtype=torch.int32),
        active=man.valid, touching=man.touching,
        # No solve ran: the matched warmstart caches carry through.
        warmstart_impulse=ws_n * man.point_active.to(ws_n.dtype),
        warmstart_tangent_impulse=ws_t.reshape(prev_c.warmstart_tangent_impulse.shape),
        warmstart_twist_impulse=ws_tw,
        impulse=torch.zeros_like(man.dist),
        tangent_impulse=torch.zeros_like(prev_c.warmstart_tangent_impulse),
        friction=man.friction, restitution=man.restitution,
        events_or=man.active_events_or,
    )
    collision_gate = (man.active_events_or & ACTIVE_EVENTS_COLLISION) != 0
    zero_p = torch.zeros_like(man.touching)
    zero_b = torch.zeros_like(man.unsupported)
    events = StepEvents(
        started_pairs=started & collision_gate,
        stopped_keys=prev_c.pair_key,
        stopped=stopped & ((prev_c.events_or & ACTIVE_EVENTS_COLLISION) != 0),
        force_events=zero_p,
        force_magnitude=torch.zeros_like(man.friction),
        total_force=torch.zeros_like(man.normal),
        max_force_direction=man.normal,
        max_force_magnitude=torch.zeros_like(man.friction),
        sensor_pairs=man.sensor,
        intersecting=man.sensor & man.touching,
        broadphase_overflow=bp_overflow,
        unsupported_pairs=man.unsupported,
        ccd_overflow=zero_b,
        solver_overflow=zero_b.clone(),
    )
    new_state = SceneState(bodies=bodies, colliders=colliders, contacts=contacts,
                           step_count=state.step_count, multibodies=state.multibodies,
                           joints=state.joints, meshes=state.meshes, hulls=state.hulls)
    return new_state, events
