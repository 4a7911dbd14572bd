"""rapier_tpu_torch's physics hooks (pipeline/hooks.py, `step(...,
hooks)`) and collision pipeline (pipeline/collision_pipeline.py) against
the reference on the CPU.

The hooked scene is examples3d/one_way_platforms3.rs as
tests/test_example_scenes.py builds it, its platform flagged for both the
contact filter and the contact modifier, at B = 2 (scene 1's balls moved
by seeded noise; the ball from above given a sideways velocity so that the
modifier's friction matters).  The reference runs `jax.vmap(step)` with
the hooks bound by `functools.partial`, with solver_backend "pallas" (the
TPU path's semantics, ROADMAP R1); the port runs its `step` with the same
hooks written for its tensors.  Tolerances as the other step-parity tests:
pair keys and touching flags equal, positions 1e-4, velocities 1e-3,
impulses 1e-3 of the step's largest.  The file keeps to 8 tests
(tests/test_torch_queries.py says why).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_common as tp
from rapier_tpu_torch.pipeline import hooks as ph
from rapier_tpu_torch.pipeline import physics_pipeline as pp
from rapier_tpu_torch.types import (
    ACTIVE_HOOKS_FILTER_CONTACT_PAIR,
    ACTIVE_HOOKS_MODIFY_SOLVER_CONTACTS,
    from_numpy,
)

STEPS = 60            # the ball from below passes by ~20, the one from above lands at ~45
FRICTION_SCALE = 0.25
FLAGS = ACTIVE_HOOKS_FILTER_CONTACT_PAIR | ACTIVE_HOOKS_MODIFY_SOLVER_CONTACTS


def _reference_world(flags=FLAGS):
    from rapier_tpu.world import ColliderBuilder, PhysicsWorld, RigidBodyBuilder

    w = PhysicsWorld()
    plat = w.insert_body(RigidBodyBuilder.fixed().with_translation((0, 0, 0)))
    w.insert_collider(ColliderBuilder.cuboid(5.0, 0.1, 5.0).with_active_hooks(flags), plat)
    above = w.insert_body(RigidBodyBuilder.dynamic().with_translation((1, 3, 0))
                          .with_linvel((1.5, 0, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5), above)
    below = w.insert_body(RigidBodyBuilder.dynamic().with_translation((-1, -3, 0))
                          .with_linvel((0, 14.0, 0)))
    w.insert_collider(ColliderBuilder.ball(0.5), below)
    w.params = w.params.replace(solver_backend="pallas")
    return w, {"platform": plat, "above": above, "below": below}


def _reference_hooks():
    from rapier_tpu.pipeline.hooks import PhysicsHooks, one_way_platform_hook

    def scale(bodies, colliders, man):
        return man._replace(friction=man.friction * FRICTION_SCALE)

    return PhysicsHooks(filter_contact_pair=one_way_platform_hook(
        (0.0, 1.0, 0.0)).filter_contact_pair, modify_solver_contacts=scale)


def port_hooks():
    def scale(bodies, colliders, man):
        return man._replace(friction=man.friction * FRICTION_SCALE)

    return ph.PhysicsHooks(filter_contact_pair=ph.one_way_platform_hook(
        (0.0, 1.0, 0.0)).filter_contact_pair, modify_solver_contacts=scale)


@functools.lru_cache(maxsize=None)
def hooked_rollouts():
    from rapier_tpu.pipeline.physics_pipeline import step as jstep

    w, h = _reference_world()
    start, jparams = tp.perturbed_batch(w, (1.0, 1.0, 1.0), seed=21)
    f = jax.jit(jax.vmap(functools.partial(jstep, hooks=_reference_hooks()), in_axes=(0, None)))
    path, ref, port = tp.rollouts(start, jparams, STEPS, jax_step=f, hooks=port_hooks())
    return path, ref, port, h


def test_hooked_rollout_matches_reference():
    """Bodies, pair keys and touching flags every step, the contact
    impulses every fourth step with a solved contact."""
    path, ref, port, h = hooked_rollouts()
    assert path == "kernel"
    tp.assert_trajectories_agree(ref, port)
    # The filter let the ball from below through and held the one from above.
    ys = np.array([s.bodies.pos[:, h["below"], 1] for s in ref])
    assert (ys.max(axis=0) > 1.0).all()
    assert (ref[-1].bodies.pos[:, h["above"], 1] > 0.4).all()
    # The steps with a solved contact (the ball from below touches the
    # platform unsolved while it passes).
    steps = [t for t, s in enumerate(ref) if np.abs(np.asarray(s.contacts.impulse)).max() > 0]
    assert len(steps) > 10
    for t in steps[::4]:
        tp.assert_contact_impulses_agree(ref[t], port[t], f"step {t + 1}")


def _port_state(flags=FLAGS):
    w, h = _reference_world(flags)
    start, jparams = tp.perturbed_batch(w, (1.0, 1.0, 1.0), seed=21)
    return from_numpy(start), from_numpy(jparams), h


def _run(state, params, hooks, steps=STEPS):
    ys = []
    for _ in range(steps):
        state, _ = pp.step(state, params, hooks)
        ys.append(state.bodies.pos.clone())
    return state, torch.stack(ys)


def test_hooks_take_effect_on_flagged_colliders_only():
    """With the platform flagged the ball from below passes and the contact
    cache holds the modifier's friction; unflagged, the same hooks change
    nothing (bitwise the unhooked run)."""
    state, params, h = _port_state()
    plain_state, plain = _run(state, params, None)
    hooked_state, hooked = _run(state, params, port_hooks())
    assert (hooked[:, :, h["below"], 1].max(dim=0).values > 1.0).all()
    assert (plain[:, :, h["below"], 1].max(dim=0).values < 0.0).all()      # bounced off
    lanes = hooked_state.contacts.touching
    assert lanes.any() and torch.equal(lanes, plain_state.contacts.touching & lanes)
    assert torch.allclose(hooked_state.contacts.friction[lanes],
                          plain_state.contacts.friction[lanes] * FRICTION_SCALE)
    state0, params0, _ = _port_state(flags=0)
    _, unflagged = _run(state0, params0, port_hooks())
    assert torch.equal(unflagged, plain)


def _captured_manifolds():
    """The manifolds a hooked step hands its modifier."""
    state, params, _ = _port_state()
    state, _ = _run(state, params, port_hooks(), steps=50)       # both balls touching
    seen = {}

    def record(bodies, colliders, man):
        seen["man"] = man
        return man

    pp.step(state, params, ph.PhysicsHooks(modify_solver_contacts=record))
    return state, seen["man"]


def test_modifier_writes_only_the_whitelisted_fields():
    """A modifier that rewrites every field, pair_key and body1 included:
    the step takes only HOOK_WRITABLE, and only on the gated lanes."""
    state, man = _captured_manifolds()
    # Every lane of the scene involves the flagged platform: clear the
    # flags of every other lane, so that half the lanes are ungated.
    lanes = torch.arange(man.valid.shape[-1])
    man = man._replace(active_hooks_or=torch.where(lanes % 2 == 0, man.active_hooks_or, 0))

    def rewrite(bodies, colliders, m):
        out = {}
        for f in m._fields:
            x = getattr(m, f)
            out[f] = ~x if x.dtype == torch.bool else x + 7
        return m._replace(**out)

    got = ph.apply_contact_modifier(ph.PhysicsHooks(modify_solver_contacts=rewrite),
                                    state.bodies, state.colliders, man)
    gate = (man.active_hooks_or & ACTIVE_HOOKS_MODIFY_SOLVER_CONTACTS) != 0
    assert gate.any() and (~gate).any()
    changed = set()
    for f in man._fields:
        old, new = getattr(man, f), getattr(got, f)
        if f not in ph.HOOK_WRITABLE:
            assert torch.equal(old, new), f
            continue
        g = gate.view(gate.shape[:1] + (1,) * (old.dim() - 2) + gate.shape[-1:]).expand(
            old.shape)
        assert torch.equal(new[~g], old[~g]), f"{f} changed on an ungated lane"
        assert not torch.equal(new[g], old[g]), f
        changed.add(f)
    assert changed == {"point", "dist", "normal", "friction", "restitution", "point_active"}


def test_filter_gates_by_either_collider():
    """The filter's verdict applies where either collider carries the flag
    and nowhere else; the solver lanes and the touching flags both drop."""
    state, man = _captured_manifolds()
    drop_all = ph.PhysicsHooks(filter_contact_pair=lambda b, c, m: torch.zeros_like(m.valid))
    got = ph.apply_contact_filter(drop_all, state.bodies, state.colliders, man)
    gate = (man.active_hooks_or & ACTIVE_HOOKS_FILTER_CONTACT_PAIR) != 0
    assert torch.equal(got.touching, man.touching & ~gate)
    assert torch.equal(got.solver_pair, man.solver_pair & ~gate)
    flags = state.colliders.active_hooks
    c1, c2 = man.collider1.clamp(min=0).long(), man.collider2.clamp(min=0).long()
    either = (torch.gather(flags, 1, c1) | torch.gather(flags, 1, c2)) & FLAGS
    assert torch.equal(gate & man.valid, (either & ACTIVE_HOOKS_FILTER_CONTACT_PAIR != 0)
                       & man.valid)


def test_filter_intersection_pair_is_never_called():
    """ROADMAP R27: the reference declares filter_intersection_pair
    (hooks.py:34) and no pipeline calls it; the port keeps the field and
    never calls it, in a step or in collide."""
    from rapier_tpu.pipeline.hooks import PhysicsHooks as RefHooks
    from rapier_tpu_torch.pipeline.collision_pipeline import collide

    assert "filter_intersection_pair" in RefHooks.__dataclass_fields__
    calls = []
    hooks = ph.PhysicsHooks(filter_intersection_pair=lambda *a: calls.append(a))
    state, params, _ = _port_state(flags=ACTIVE_HOOKS_FILTER_CONTACT_PAIR
                                   | 1 << 1)
    for _ in range(50):
        state, _ = pp.step(state, params, hooks)
        state, _ = collide(state, params, hooks)
    assert calls == []


def test_surface_velocity_is_skipped():
    """ROADMAP R28: HOOK_WRITABLE names surface_velocity, which neither
    package's ManifoldBatch has; a modifier returning one is not an error
    and the step's manifolds gain no such field."""
    from rapier_tpu.geometry.dispatch import ManifoldBatch as RefManifolds
    from rapier_tpu_torch.geometry.dispatch import ManifoldBatch

    assert "surface_velocity" in ph.HOOK_WRITABLE
    assert "surface_velocity" not in ManifoldBatch._fields
    assert "surface_velocity" not in RefManifolds._fields
    state, man = _captured_manifolds()

    class WithSurfaceVelocity:
        def __init__(self, m):
            self.__dict__.update(m._asdict())
            self.surface_velocity = torch.ones_like(m.normal)

    got = ph.apply_contact_modifier(
        ph.PhysicsHooks(modify_solver_contacts=lambda b, c, m: WithSurfaceVelocity(m)),
        state.bodies, state.colliders, man)
    assert type(got) is ManifoldBatch
    for f in man._fields:
        assert torch.equal(getattr(got, f), getattr(man, f)), f


# ---------------------------------------------------------------------------
# The collision pipeline: tests/test_sensors_collision_types.py:88's scene


def _cd_only_world(package):
    import importlib

    w_mod = importlib.import_module(f"{package}.world")
    types = importlib.import_module(f"{package}.types")
    rb, cb = w_mod.RigidBodyBuilder, w_mod.ColliderBuilder
    w = w_mod.PhysicsWorld(**({"device": "cpu"} if package == "rapier_tpu_torch" else {}))
    ground = w.insert_body(rb.fixed())
    cg = w.insert_collider(cb.cuboid(5, 0.5, 5)._set(active_events=types.ACTIVE_EVENTS_COLLISION),
                           ground)
    probe = w.insert_body(rb.dynamic().with_translation((0, 0.6, 0)))
    cp = w.insert_collider(cb.ball(0.3).as_sensor()._set(
        active_events=types.ACTIVE_EVENTS_COLLISION), probe)
    w.build()
    return w, cg, cp, probe


def test_collide_matches_reference():
    """Two collides from the built state, then one after the probe moves
    away: the contact cache and the events equal the reference's, bodies
    untouched."""
    from rapier_tpu.pipeline.collision_pipeline import collide as jcollide
    from rapier_tpu_torch.pipeline.collision_pipeline import collide
    from rapier_tpu_torch.scenes import replicate_scene

    rw, _, _, probe = _cd_only_world("rapier_tpu")
    js = jax.tree.map(jnp.asarray, rw.state)
    ps = from_numpy(replicate_scene(rw.state, 1))
    params = from_numpy(rw.params)
    f = jax.jit(jcollide)
    for k in range(3):
        if k == 2:     # the probe moves away: the pair stops
            js = js.replace(bodies=js.bodies.replace(pos=js.bodies.pos.at[probe, 1].set(3.0)))
            ps.bodies.pos[0, probe, 1] = 3.0
        before = ps.bodies.pos.clone()
        js, jev = f(js, rw.params)
        ps, pev = collide(ps, params)
        assert torch.equal(ps.bodies.pos, before)
        for name in ("pair_key", "touching", "collider1", "collider2", "num_points",
                     "feature_id", "point_active"):
            tp.assert_equal(getattr(ps.contacts, name)[0], getattr(js.contacts, name), name)
        for name in ("normal", "point", "dist"):
            tp.assert_close(getattr(ps.contacts, name)[0], getattr(js.contacts, name), 1e-5,
                            name)
        for name in ("started_pairs", "stopped", "stopped_keys", "sensor_pairs",
                     "intersecting"):
            tp.assert_equal(getattr(pev, name)[0], getattr(jev, name), f"collide {k} {name}")
        assert int(pev.broadphase_overflow[0]) == int(jev.broadphase_overflow)


def test_collide_on_the_port():
    """collide carries the matched warmstart caches through (a later step
    warmstarts as if it had not run) and of the hooks applies the filter to
    `touching` only; tests/test_sensors_collision_types.py's
    test_collision_pipeline_cd_only on the port's world."""
    from rapier_tpu_torch.pipeline.collision_pipeline import collide

    state, params, h = _port_state()
    state, _ = _run(state, params, port_hooks(), steps=50)
    collided, _ = collide(state, params)
    for f in ("warmstart_impulse", "warmstart_tangent_impulse", "warmstart_twist_impulse"):
        assert torch.equal(getattr(collided.contacts, f), getattr(state.contacts, f)), f
    assert (collided.contacts.impulse == 0).all()
    drop_all = ph.PhysicsHooks(filter_contact_pair=lambda b, c, m: torch.zeros_like(m.valid))
    filtered, _ = collide(state, params, drop_all)
    gated = (filtered.contacts.active & (collided.contacts.touching)).any()
    assert gated and not filtered.contacts.touching.any()
    w, cg, cp, probe = _cd_only_world("rapier_tpu_torch")
    p0 = w.body_translation(probe).copy()
    w.collide()
    assert w.last_events.started_pairs.any()
    assert w.is_intersecting(cg, cp)
    w.collide()
    assert not w.last_events.started_pairs.any()
    np.testing.assert_array_equal(w.body_translation(probe), p0)
    assert w.body_linvel(probe).sum() == 0.0
