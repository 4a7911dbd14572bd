"""Whole steps of the 2D slice against the reference, at B = 2 scenes (scene
1's dynamic bodies moved in the plane by seeded numpy noise):

(i)   `s2d_pyramid_world(10)` (55 boxes) on the masked sweep with the 2x2
      block solve;
(ii)  the Coulomb stack with its kicked slider (`s2d_coulomb_stack_world`),
      masked, with the ``[4, 2, P]`` tangent cache;
(iii) the same pyramid down the blocked path in both packages (the
      dense-routing limits at 0, as tests/test_torch_large_scene.py does),
      with the reference's blocked passes given the 2x2 flag that they drop
      (ROADMAP R10) by a monkeypatch of its `solve_color`; with the port's
      flag dropped the same way, the steps part (the test bites); its
      Jacobi tail holds lanes at every step, so the tail under the flag is
      held too;
R2    `s2d_far_pyramid_world` (origin (1e5, -8e4)), which shares (i)'s
      shapes and compile; and, outside tier-1 (marked slow), its 180 free
      steps in both packages with their worst sinks printed;
F6    outside tier-1 (marked slow): a 20-row pile whose blocked layout
      leaves most lanes to the Jacobi tail explodes in the port and in the
      reference alike.

The reference runs freely for N_STEPS; each port step starts from the
reference's state of the step before, and at every step pair keys and
touching flags are equal, positions within 1e-4 (R2: within 2 ulps at 1e5,
2 x 0.0078), velocities within 1e-3, the contact cache's impulses within
1e-3 of the step's largest, and z and the x / y spins are exactly 0 in the
port (the plane lock).  Each reference step shape compiles once.  The
pyramids run one substep (SUBSTEPS; the scenes' own is 4: the reference
unrolls its substeps, ~10 s of compile each, and the substep loop is the one
the 3D step tests run at 4); the Coulomb stack runs its own 4.  (iii) also
runs 4 colors (three Luby blocks and the Jacobi tail), so that it unrolls 8
block passes.

Why single steps, each given the reference's contact geometry (ROADMAP
R11): an extruded 2D contact has its points in z-twins of equal depth, and
the box-box reduction picks among them by argmin / argmax, so a 1-ulp
difference in a depth (XLA contracts multiply-adds into FMAs, R1b) picks
another twin or another subset, which reorders the rows of the Gauss-Seidel
pass; the scene's 0.002 gaps also sit on the prediction distance.  From the
same state some 1-4% of the lanes come out so (at most MAX_SHARE is
allowed, and at most twice the share in which the reference's own step
differs when every body starts 1 ulp higher, its witness: 4.7-5.2%), and a
free run of the pile amplifies each such flip past the tolerances within ~8
steps.  So each port step takes the reference's
contact geometry of that step (normal, points, depths, feature ids, active
points, touching) in place of its own.
"""

import numpy as np
import pytest

import test_torch_common as tp
from rapier_tpu_torch.scenes import (
    s2d_coulomb_stack_world,
    s2d_far_pyramid_world,
    s2d_pyramid_world,
)

N_STEPS = 8
FAR_ULP = 0.0078125          # float32 spacing at 1e5 (2**-7)
FAR_SETTLE = 30
FAR_STEPS = 180              # tests/test_s2d.py's run
MAX_SHARE = 0.05             # lanes whose own contact geometry may differ
SUBSTEPS = 1                 # the pyramids' substeps (their own is 4)


def _start(make, seed, **params):
    """(numpy batch, reference params) of the port-built 2D world."""
    import types

    w, _ = make(device="cpu")
    state = tp.to_reference(w.build())
    world = types.SimpleNamespace(build=lambda: state,
                                  params=tp.reference_params(w.params).replace(**params))
    return tp.perturbed_batch(world, (1.0, 1.0, 0.0), seed)


# Manifold field: the contact cache's field holding it.
GEOMETRY = {"normal": "normal", "point": "point", "dist": "dist", "fid": "feature_id",
            "point_active": "point_active", "touching": "touching"}


def _reference_geometry(man, target):
    """The port's manifolds `man` with the contact geometry of the
    reference's `target` contacts (numpy leaves, the same step): GEOMETRY.
    Returns (manifolds, the share of live lanes whose points differed by
    more than 1e-4 or whose active points differed)."""
    import torch

    live = man.valid
    ref = {f: torch.from_numpy(np.array(getattr(target, g))) for f, g in GEOMETRY.items()}
    d_pt = (man.point - ref["point"]).abs().amax(dim=(1, 2))
    d_act = (man.point_active != ref["point_active"]).any(dim=1)
    differ = live & ((torch.where(ref["point_active"].any(dim=1), d_pt, 0.0) > 1e-4) | d_act)
    share = float(differ.sum()) / max(1, int(live.sum()))
    return man._replace(**{f: ref[f].to(getattr(man, f).dtype) for f in GEOMETRY}), share


def _port_steps(start, jparams, ref):
    """One port step from each reference state (the numpy batch `start`,
    then `ref[t - 1]`), its manifolds given the contact geometry of
    `ref[t]` (`_reference_geometry`): (states with numpy leaves, the largest
    share of lanes whose own geometry differed)."""
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.types import from_numpy, to_numpy

    params = from_numpy(jparams)
    port, worst = [], 0.0
    compute = pp.compute_manifolds
    with pytest.MonkeyPatch.context() as mp:
        for prev, rs in zip([start] + ref[:-1], ref):
            def given(*a, **kw):
                nonlocal worst
                man, share = _reference_geometry(compute(*a, **kw), rs.contacts)
                worst = max(worst, share)
                return man

            mp.setattr(pp, "compute_manifolds", given)
            ps, ev = pp.step(from_numpy(prev), params)
            assert int(ev.solver_overflow.max()) == 0 and int(ev.broadphase_overflow.max()) == 0
            port.append(to_numpy(ps))
    return port, worst


def _differ(target, other):
    """The share of `target`'s live lanes whose contact points differ from
    `other`'s by more than 1e-4, or whose active points differ (numpy
    contact caches of one step, lanes aligned)."""
    live = np.asarray(target.active)
    act_t, act_o = np.asarray(target.point_active), np.asarray(other.point_active)
    d_pt = np.abs(np.asarray(other.point) - np.asarray(target.point)).max(axis=(1, 2))
    differ = live & ((np.where(act_t.any(axis=1), d_pt, 0.0) > 1e-4)
                     | (act_o != act_t).any(axis=1))
    return float(differ.sum()) / max(1, int(live.sum()))


def _witness_share(f, start, ref, jparams):
    """ROADMAP R11's witness: each reference step taken again from its
    start with every dynamic body 1 ulp higher; the largest share of lanes
    whose geometry differs from the unmoved step's (`_differ`)."""
    import jax
    import jax.numpy as jnp

    worst = 0.0
    for prev, rs in zip([start] + ref[:-1], ref):
        moved = jax.tree.map(np.copy, prev)
        dyn = np.asarray(moved.bodies.body_type) == 0
        for name in ("pos", "next_pos"):
            y = getattr(moved.bodies, name)[..., 1]
            y[dyn] = np.nextafter(y[dyn], np.float32(np.inf))
        out, _ = f(jax.tree.map(jnp.asarray, moved), jparams)
        worst = max(worst, _differ(rs.contacts, jax.tree.map(np.asarray, out.contacts)))
    return worst


def _rollouts(start, jparams, n_steps, jax_step=None):
    """The reference's rollout and the port's steps from it (`_port_steps`):
    (the port's solve path, reference states, port states).  The share of
    lanes whose own geometry differed from the reference's is at most
    MAX_SHARE, and at most twice the reference's against itself 1 ulp apart
    (`_witness_share`), which is printed beside it."""
    import jax
    import rapier_tpu.pipeline.physics_pipeline as jpp
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.types import from_numpy

    f = jax_step or jax.jit(jax.vmap(jpp.step, in_axes=(0, None)))
    ref = tp.reference_rollout(f, start, jparams, n_steps)
    path = pp.solve_path(from_numpy(start), from_numpy(jparams))
    port, share = _port_steps(start, jparams, ref)
    witness = _witness_share(f, start, ref, jparams)
    print(f"lanes whose contact geometry differs from the reference's: the port's own "
          f"{share:.2%}, the reference 1 ulp apart {witness:.2%}")
    assert share <= MAX_SHARE, f"{share:.1%} of the lanes differ in geometry"
    assert share <= 2 * witness, f"{share:.1%} of the lanes differ, the witness {witness:.1%}"
    return path, ref, port


@pytest.fixture(scope="module")
def jax_step():
    return tp.joint_step()


def _check(ref, port, pos_tol=1e-4):
    for t, (rs, ps) in enumerate(zip(ref, port)):
        tp.assert_equal(ps.contacts.pair_key, rs.contacts.pair_key, f"step {t + 1} pair_key")
        tp.assert_equal(ps.contacts.touching, rs.contacts.touching, f"step {t + 1} touching")
        tp.assert_close(ps.bodies.pos, rs.bodies.pos, pos_tol, f"step {t + 1} pos")
        tp.assert_close(ps.bodies.rot, rs.bodies.rot, 1e-4, f"step {t + 1} rot")
        tp.assert_close(ps.bodies.linvel, rs.bodies.linvel, 1e-3, f"step {t + 1} linvel")
        tp.assert_close(ps.bodies.angvel, rs.bodies.angvel, 1e-3, f"step {t + 1} angvel")
        tp.assert_contact_impulses_agree(rs, ps, f"step {t + 1}")
        assert not ps.bodies.pos[..., 2].any() and not ps.bodies.angvel[..., :2].any(), (
            f"step {t + 1}: a body left the plane")
    return min(int(np.sum(rs.contacts.touching)) for rs in ref)


def test_pyramid_masked_block_solve(jax_step):
    batch, jparams = _start(s2d_pyramid_world, 21, num_solver_iterations=SUBSTEPS)
    path, ref, port = _rollouts(batch, jparams, N_STEPS, jax_step=jax_step)
    assert path == "masked"
    assert jparams.block_solver_2x2
    # Every box rests on two (the bottom row on the ground).
    assert _check(ref, port) > 100


def test_far_pyramid_masked_block_solve(jax_step):
    """ROADMAP R2's far pyramid: the same shapes as the pyramid above.  Its
    rows start 0.25 apart, so the port first steps it FAR_SETTLE steps
    until they have landed."""
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.types import from_numpy

    batch, jparams = _start(s2d_far_pyramid_world, 22, num_solver_iterations=SUBSTEPS)
    state, params = from_numpy(batch), from_numpy(jparams)
    for _ in range(FAR_SETTLE):
        state, _ = pp.step(state, params)
    batch = tp.to_reference(state)
    path, ref, port = _rollouts(batch, jparams, N_STEPS, jax_step=jax_step)
    assert path == "masked"
    assert _check(ref, port, pos_tol=2 * FAR_ULP) > 50


def test_coulomb_stack(jax_step):
    batch, jparams = _start(s2d_coulomb_stack_world, 23)
    assert batch.contacts.warmstart_tangent_impulse.shape[1:3] == (4, 2)
    path, ref, port = _rollouts(batch, jparams, N_STEPS, jax_step=jax_step)
    assert path == "masked"
    assert _check(ref, port) > 30
    # The slider slides: friction is at its limit at its points.
    slider = 22
    assert all(float(ps.bodies.linvel[:, slider, 0].min()) > 1.0 for ps in port)
    assert np.abs(port[-1].contacts.tangent_impulse).max() > 0.0


def _drop_flag(mp, module):
    original = module.solve_color
    mp.setattr(module, "solve_color",
               lambda *a, **kw: original(*a, **{**kw, "block_2x2": False}))


def _give_flag(mp, module):
    original = module.solve_color
    mp.setattr(module, "solve_color",
               lambda *a, **kw: original(*a, **{**kw, "block_2x2": True}))


def test_pyramid_blocked_block_solve(monkeypatch):
    """R10: the port's blocked passes solve with the 2x2 flag; the
    reference's are given it here."""
    import rapier_tpu.dynamics.solver.contact_constraints as jcc
    import rapier_tpu_torch.dynamics.solver.contact_constraints as pcc

    import rapier_tpu.dynamics.solver.coloring as jcol
    import rapier_tpu_torch.pipeline.physics_pipeline as pp

    batch, jparams = _start(s2d_pyramid_world, 24, max_colors=4, solver_backend="jax",
                            num_solver_iterations=1)
    tp.blocked_thresholds(monkeypatch)
    # The Jacobi tail holds lanes at every step, within the reference's own
    # cap for it, so both packages solve them in the same slots.
    tails, coloring = [], pp.color_constraints_blocked

    def record(*a):
        out = coloring(*a)
        tails.append(int((out[0] == len(a[-1]) - 1).sum(-1).min()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        _give_flag(mp, jcc)
        mp.setattr(pp, "color_constraints_blocked", record)
        path, ref, port = _rollouts(batch, jparams, N_STEPS)
    assert path == "blocked"
    assert _check(ref, port) > 100
    assert len(tails) == N_STEPS and min(tails) > 20, tails
    assert max(tails) < jcol.block_caps(batch.contacts.pair_key.shape[-1], 4)[-1], tails

    with pytest.MonkeyPatch.context() as mp:
        _drop_flag(mp, pcc)
        dropped = _port_steps(batch, jparams, ref)[0]
    with pytest.raises(AssertionError):
        _check(ref, dropped)


F6_BASE = 20                 # 210 boxes, 1,792 pair lanes
F6_COLORS = 4                # three Luby blocks leave ~60% of the lanes to the tail
F6_STEPS = 10
F6_BLOWN = 10.0              # m/s: six times free fall's 1.635 in F6_STEPS steps


def _largest_speed(states):
    return max(float(np.abs(np.asarray(s.bodies.linvel)).max()) for s in states)


@pytest.mark.slow
def test_jacobi_tail_explodes_in_both(monkeypatch, capsys):
    """ROADMAP F6, reproduced at 20 rows: with F6_COLORS colors the Luby
    rounds leave more than 256 of the pile's ~500 lanes to the blocked
    layout's Jacobi tail, solved together, and within F6_STEPS steps a box
    moves faster than F6_BLOWN, in the port, in the reference given the
    port's layout and the 2x2 flag, and in the reference on its own path
    (its tail capped at 256, the rest dropped, R7; no 2x2 flag, R10).  At
    SimParams' default 16 colors the tail holds a few lanes and the same
    pile holds in the port: no box faster than free fall.  The blow-up is
    the blocked algorithm's, not the port's."""
    import jax
    import rapier_tpu.dynamics.solver.coloring as jcol
    import rapier_tpu.dynamics.solver.contact_constraints as jcc
    import rapier_tpu.pipeline.physics_pipeline as jpp
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.types import from_numpy, to_numpy

    batch, jparams = _start(lambda **kw: s2d_pyramid_world(F6_BASE, **kw), 25,
                            max_colors=F6_COLORS, solver_backend="jax")
    tp.blocked_thresholds(monkeypatch)
    p_lanes = batch.contacts.pair_key.shape[-1]
    reference_caps = jcol.block_caps
    tails, coloring = [], pp.color_constraints_blocked

    def record(*a):
        out = coloring(*a)
        tails.append(int((out[0] == len(a[-1]) - 1).sum(-1).max()))
        return out

    def step():
        return jax.jit(jax.vmap(jpp.step, in_axes=(0, None)))

    monkeypatch.setattr(pp, "color_constraints_blocked", record)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcol, "block_caps", lambda total, mc, min_cap=256: (
            reference_caps(total, mc, min_cap)[:-1]
            + (max(reference_caps(total, mc, min_cap)[-1], p_lanes),)))
        _give_flag(mp, jcc)
        path, given, port = tp.rollouts(batch, jparams, F6_STEPS, jax_step=step())
    own = tp.reference_rollout(step(), batch, jparams, F6_STEPS)
    assert path == "blocked"
    tail_few, tails[:] = max(tails), []
    state, params, stands = from_numpy(batch), from_numpy(jparams).replace(max_colors=16), []
    for _ in range(F6_STEPS):
        state, _ = pp.step(state, params)
        stands.append(to_numpy(state))
    speeds = {name: _largest_speed(states) for name, states in (
        ("port", port), ("reference, the port's layout", given), ("reference, own", own),
        ("port at 16 colors", stands))}
    with capsys.disabled():
        print(f"\nF6, {F6_BASE}-row 2D pile, largest speed in {F6_STEPS} steps: {speeds}; "
              f"Jacobi-tail lanes at {F6_COLORS} colors {tail_few}, at 16 {max(tails)}")
    assert tail_few > reference_caps(p_lanes, F6_COLORS)[-1]
    assert min(speeds[k] for k in list(speeds)[:3]) > F6_BLOWN, speeds
    # At 16 colors no box moves faster than free fall from rest would make it.
    fall = 9.81 * F6_STEPS * float(jparams.dt)
    assert speeds["port at 16 colors"] <= 1.01 * fall and max(tails) < 64, (speeds, tails)


@pytest.mark.slow
def test_far_pyramid_sinks_as_the_reference_does(jax_step, capsys):
    """ROADMAP R2, reproduced: tests/test_s2d.py's far pyramid (scene 0 of
    the batch, unperturbed) for its 180 steps in both packages, each free;
    the worst sink of every seventh box below its start (the reference
    test's check, which fails in float32: the test is an xfail) printed side
    by side.  The port's worst sink lies within a quarter of the reference's
    (the piles part by rounding, R11)."""
    import rapier_tpu_torch.pipeline.physics_pipeline as pp
    from rapier_tpu_torch.types import from_numpy, to_numpy

    batch, jparams = _start(s2d_far_pyramid_world, 22)
    ref = tp.reference_rollout(jax_step, batch, jparams, FAR_STEPS)[-1]
    state, params = from_numpy(batch), from_numpy(jparams)
    for _ in range(FAR_STEPS):
        state, _ = pp.step(state, params)
    port = to_numpy(state)
    boxes = np.flatnonzero(np.asarray(batch.bodies.body_type[0]) == 0)[::7]
    y0 = np.asarray(batch.bodies.pos)[0, boxes, 1]
    sink = {name: float(np.max(y0 - np.asarray(s.bodies.pos)[0, boxes, 1]))
            for name, s in (("reference", ref), ("port", port))}
    with capsys.disabled():
        print(f"\nfar pyramid after {FAR_STEPS} steps, worst sink of every seventh box: "
              f"reference {sink['reference']:.6f}, port {sink['port']:.6f} "
              f"(float32 ulp at 1e5: {FAR_ULP})")
    assert np.isfinite(port.bodies.pos).all()
    assert abs(sink["port"] - sink["reference"]) <= 0.25 * abs(sink["reference"])
