"""The Coulomb friction model (`contact_constraints_coulomb`) and its contact
cache against the reference, without a step compile.

- `generate`, `update`, `warmstart` and four biased then four bias-free
  `solve_color` passes on seeded contact lanes
  (`test_torch_common.seeded_lanes`: B = 2 scenes, 8 bodies, 64 lanes in 4
  colors that share bodies, one to four active points), the reference
  running each scene eagerly on the port's constraints.  In float64 (the
  reference under `jax.enable_x64`) every field within 1e-9 of its largest
  magnitude (at least 1); in float32 each value's error against the float64
  run, in units of 1e-5 of the largest magnitude, at most 1 or twice the
  reference's own.  Friction reaches its per-point limit on some points.
- `_match_previous` on a seeded ``[4, 2, P]`` cache against the reference's
  join: every output equal (the join only routes values).
- The Coulomb stack (`s2d_coulomb_stack_world`) for 20 port steps, its state
  saved to numpy and loaded back at step 10 (`to_numpy`, `from_numpy`),
  continues bit for bit as the unbroken run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_common as tp

N = tp.SEED_N
RATES = dict(cfm_factor=0.8, inv_dt=240.0, allowed_lin_err=0.001, erp_inv_dt=60.0,
             max_corrective_velocity=10.0, warmstart_coeff=0.9)
SOLVED = ("impulse", "tan_impulse")


def _passes():
    return [(ci, use_bias) for use_bias in (True, False) for ci in range(4)]


def _leaves(c, s, int32=True):
    import jax.numpy as jnp

    def leaf(v):
        if not isinstance(v, torch.Tensor):
            return v
        v = v[s].numpy()
        return jnp.asarray(v.astype(np.int32) if int32 and v.dtype == np.int64 else v)

    return {name: leaf(v) for name, v in c._asdict().items()}


def _run_both(dtype):
    """{stage: (port value, reference value stacked over scenes)} for every
    field of `generate` and `update`, the warmstart's velocities and each
    pass's velocities and impulses."""
    import jax
    import jax.numpy as jnp
    import rapier_tpu.dynamics.solver.contact_constraints as jcc
    import rapier_tpu.dynamics.solver.contact_constraints_coulomb as jccc
    from rapier_tpu_torch.dynamics.solver import contact_constraints_coulomb as ccc
    from rapier_tpu_torch.dynamics.solver.contact_constraints import SolverBodies

    man, sbn, prev, color, _ = tp.seeded_lanes(8)
    cast = tp.cast_float(dtype)
    sb = SolverBodies(**{k: torch.from_numpy(cast(v)) for k, v in sbn.items()})
    gen = ccc.generate(tp.port_manifolds(man, cast), sb, torch.from_numpy(cast(prev)),
                       torch.from_numpy(color), N)
    rng = np.random.default_rng(9)
    k = gen.b1.shape[-1]
    pmask = gen.point_mask.to(gen.dist0.dtype)
    c0 = gen._replace(
        impulse=torch.from_numpy(cast(rng.uniform(0, 0.3, (tp.B, 4, k)))) * pmask,
        tan_impulse=torch.from_numpy(cast(rng.normal(0, 0.1, (tp.B, 4, 2, k))))
        * pmask.unsqueeze(2))
    upd = ccc.update(c0, sb, **RATES)
    ws = ccc.warmstart(upd, sb)
    port = {"generate": gen, "update": upd, "warmstart": ws}
    pc, psb = upd, ws
    for i, (ci, use_bias) in enumerate(_passes()):
        pc, psb = ccc.solve_color(pc, psb, ci, use_bias=use_bias)
        port[f"pass {i}"] = (pc, psb)

    ref = {}
    with jax.enable_x64(dtype == np.float64):
        for s in range(tp.B):
            rsb = jcc.SolverBodies(*(jnp.asarray(x[s].numpy()) for x in sb))
            rgen = jccc.generate(tp.reference_manifolds(man, s, cast), rsb,
                                 jnp.asarray(cast(prev[s])), jnp.asarray(color[s]), N)
            rc0 = jccc.CoulombConstraints(**_leaves(c0, s))
            rc0 = rc0._replace(cfm_factor=jnp.asarray(1.0, dtype))
            oh1, oh2 = jcc.pair_onehots(rc0, N + 1)
            rupd = jccc.update(rc0, rsb, oh1, oh2, **RATES)
            # The reference stores the factor rounded to float32
            # (contact_constraints_coulomb.py:231), at either precision.
            rupd = rupd._replace(
                cfm_factor=jnp.asarray(np.float32(RATES["cfm_factor"]), dtype))
            rws = jccc.warmstart(rupd, rsb, oh1, oh2)
            out = {"generate": rgen, "update": rupd, "warmstart": rws}
            rc, rs = rupd, rws
            for i, (ci, use_bias) in enumerate(_passes()):
                rc, rs = jccc.solve_color(rc, rs, ci, oh1, oh2, use_bias=use_bias)
                out[f"pass {i}"] = (rc, rs)
            for key, v in out.items():
                ref.setdefault(key, []).append(jax.tree.map(np.asarray, v))
    ref = {key: jax.tree.map(lambda *xs: np.stack(xs), *v) for key, v in ref.items()}
    return port, ref


def _values(port, ref):
    """[(what, port value, reference value)]."""
    out = []
    for stage in ("generate", "update"):
        p, r = port[stage], ref[stage]
        for f in p._fields:
            if isinstance(getattr(p, f), torch.Tensor):
                out.append((f"{stage} {f}", getattr(p, f).numpy(), getattr(r, f)))
    for f in ("v_lin", "v_ang"):
        out.append((f"warmstart {f}", getattr(port["warmstart"], f).numpy(),
                    getattr(ref["warmstart"], f)))
    for i in range(len(_passes())):
        (pc, psb), (rc, rsb) = port[f"pass {i}"], ref[f"pass {i}"]
        for f in ("v_lin", "v_ang"):
            out.append((f"pass {i} {f}", getattr(psb, f).numpy(), getattr(rsb, f)))
        for f in SOLVED:
            out.append((f"pass {i} {f}", getattr(pc, f).numpy(), getattr(rc, f)))
    return out


@pytest.fixture(scope="module")
def runs():
    return {name: _run_both(dt) for name, dt in (("f64", np.float64), ("f32", np.float32))}


def test_float64_matches_reference(runs):
    port, ref = runs["f64"]
    for what, p, r in _values(port, ref):
        tp.assert_scaled(p, r, what, 1e-9)


def test_friction_reaches_its_point_limits(runs):
    """Some points slide: their tangent impulse sits at friction times that
    point's own normal impulse; others stick below it."""
    port, _ = runs["f64"]
    c = port[f"pass {len(_passes()) - 1}"][0]
    tan = torch.linalg.vector_norm(c.tan_impulse, dim=2)
    limit = c.limit.unsqueeze(1) * c.impulse
    live = c.valid.unsqueeze(1) & c.point_mask & (c.impulse > 1e-6)
    at_limit = live & ((tan - limit).abs() <= 1e-9 * torch.clamp(limit, min=1.0))
    assert int(at_limit.sum()) >= 8 and int((live & ~at_limit).sum()) >= 8


def test_float32_rounding_as_close_as_the_reference(runs):
    exact = [r for _, _, r in _values(*runs["f64"])]
    for (what, p32, r32), r64 in zip(_values(*runs["f32"]), exact):
        if not np.issubdtype(np.asarray(r32).dtype, np.floating):
            continue
        p32, r32, r64 = (np.asarray(x, np.float64) for x in (p32, r32, r64))
        tol = 1e-5 * max(1.0, float(np.abs(r64).max()))
        port, ref = np.max(np.abs(p32 - r64)) / tol, np.max(np.abs(r32 - r64)) / tol
        assert port <= max(1.0, 2.0 * ref), f"{what}: port {port:.3f}, reference {ref:.3f}"


def test_match_previous_per_point_tangents():
    """The join of a ``[4, 2, P]`` cache: new pairs found among shuffled
    old keys, per-point feature matches, tangent pairs routed with them."""
    import jax.numpy as jnp
    import rapier_tpu.pipeline.physics_pipeline as jpp
    import rapier_tpu.types as jt
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.types import Contacts

    rng = np.random.default_rng(12)
    p = 48
    old_keys = np.stack([rng.permutation(200)[:p] for _ in range(tp.B)]).astype(np.int32)
    old_keys[:, ::5] = -1
    prev = dict(
        pair_key=old_keys, body1=np.zeros((tp.B, p), np.int32),
        body2=np.zeros((tp.B, p), np.int32), collider1=np.zeros((tp.B, p), np.int32),
        collider2=np.zeros((tp.B, p), np.int32),
        normal=rng.normal(size=(tp.B, 3, p)).astype(np.float32),
        point=rng.normal(size=(tp.B, 4, 3, p)).astype(np.float32),
        dist=rng.normal(size=(tp.B, 4, p)).astype(np.float32),
        feature_id=rng.integers(0, 6, (tp.B, 4, p)).astype(np.int32),
        point_active=rng.random((tp.B, 4, p)) < 0.7,
        num_points=np.zeros((tp.B, p), np.int32), active=old_keys >= 0,
        touching=rng.random((tp.B, p)) < 0.6,
        warmstart_impulse=rng.uniform(0, 1, (tp.B, 4, p)).astype(np.float32),
        warmstart_tangent_impulse=rng.normal(size=(tp.B, 4, 2, p)).astype(np.float32),
        warmstart_twist_impulse=rng.normal(size=(tp.B, p)).astype(np.float32),
        impulse=rng.uniform(0, 2, (tp.B, 4, p)).astype(np.float32),
        tangent_impulse=rng.normal(size=(tp.B, 4, 2, p)).astype(np.float32),
        friction=np.full((tp.B, p), 0.5, np.float32), restitution=np.zeros((tp.B, p), np.float32),
        events_or=np.zeros((tp.B, p), np.int32))
    # New pairs: half of the old keys (in another order), half new ones.
    new_keys = np.stack([np.concatenate([rng.permutation(old_keys[s][old_keys[s] >= 0])[:24],
                                         200 + rng.permutation(100)[:24]])
                         for s in range(tp.B)]).astype(np.int32)
    man_np, _, _, _, _ = tp.seeded_lanes(13)
    man_np = {key: v[..., :p] for key, v in man_np.items()}
    fid = rng.integers(-1, 6, (tp.B, 4, p)).astype(np.int32)
    valid = rng.random((tp.B, p)) < 0.9
    touching = valid & (rng.random((tp.B, p)) < 0.7)
    port_man = tp.port_manifolds(man_np, tp.cast_float(np.float32))._replace(
        pair_key=torch.from_numpy(new_keys), fid=torch.from_numpy(fid),
        valid=torch.from_numpy(valid), touching=torch.from_numpy(touching))
    got = pp._match_previous(Contacts(**{k: torch.from_numpy(v) for k, v in prev.items()}),
                             port_man)
    for s in range(tp.B):
        rman = tp.reference_manifolds(man_np, s, tp.cast_float(np.float32))._replace(
            pair_key=jnp.asarray(new_keys[s]), fid=jnp.asarray(fid[s]),
            valid=jnp.asarray(valid[s]), touching=jnp.asarray(touching[s]))
        want = jpp._match_previous(jt.Contacts(**{k: jnp.asarray(v[s]) for k, v in prev.items()}),
                                   rman)
        names = ("ws_normal", "ws_tan", "ws_twist", "prev_impulse", "prev_touching",
                 "matched", "still")
        for name, g, w in zip(names, got, want):
            assert np.array_equal(g[s].numpy(), np.asarray(w)), f"scene {s} {name}"
        assert got[1].shape == (tp.B, 4, 2, p)
        assert int(np.asarray(want[5]).sum()) >= 15
        assert np.abs(np.asarray(want[1])).max() > 0.0


def test_coulomb_cache_survives_a_numpy_round_trip():
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.scenes import replicate_scene, s2d_coulomb_stack_world
    from rapier_tpu_torch.types import from_numpy, to_numpy

    w, _ = s2d_coulomb_stack_world(device="cpu")
    state, params = replicate_scene(from_numpy(w.build()), 1), w.params
    for _ in range(10):
        state, _ = pp.step(state, params)
    saved = to_numpy(state)
    assert saved.contacts.warmstart_tangent_impulse.shape[1:3] == (4, 2)
    assert np.abs(saved.contacts.warmstart_tangent_impulse).max() > 0.0
    resumed = from_numpy(saved)
    for _ in range(10):
        state, _ = pp.step(state, params)
        resumed, _ = pp.step(resumed, params)
    for part in ("bodies", "contacts"):
        a, b = getattr(state, part), getattr(resumed, part)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"{part}.{f.name}"
