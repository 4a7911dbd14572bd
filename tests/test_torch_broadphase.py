"""rapier_tpu_torch's SAP and GRID broad phases, segment routing and blocked
coloring against the reference, on the same numpy inputs.

Lane order is semantics (the coloring hashes the lane index), so the pair
buffers, the overflow counts, the block colors and the slots must be equal
element by element; segment sums agree within 1e-6 (the two cumsums add in
another order).  Each batch holds B = 2 scenes, scene 1 a seeded variation
of scene 0, and every scene is held against the reference's unbatched call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rapier_tpu.types as jt
from rapier_tpu.dynamics.solver import coloring as jcol
from rapier_tpu.geometry import broadphase as jbp
from rapier_tpu.utils import routing as jrt
from rapier_tpu_torch.dynamics.solver import coloring as pcol
from rapier_tpu_torch.geometry import broadphase as pbp
from rapier_tpu_torch.types import Colliders
from rapier_tpu_torch.utils import routing as prt

B = 2
FIXED, DYNAMIC = int(jt.BodyType.FIXED), int(jt.BodyType.DYNAMIC)
REF_SAP = jax.jit(jbp.find_pairs_sap, static_argnums=(4, 5))
REF_GRID = jax.jit(jbp.find_pairs_grid, static_argnums=(4,))
REF_BLOCKED = jax.jit(jcol.color_constraints_blocked, static_argnums=(5, 6))


def _case(centers, half, enabled=None, body_type=None, seed=0):
    """(mins, maxs [B, C, 3] f32, enabled [B, C], body_type [B, C]): scene 1
    moves every AABB by seeded noise."""
    centers = np.asarray(centers, np.float32)
    half = np.broadcast_to(np.asarray(half, np.float32), centers.shape)
    c = len(centers)
    shift = np.random.default_rng(seed).normal(0.0, 0.1, (c, 3)).astype(np.float32)
    ctr = np.stack([centers, centers + shift])
    en = np.ones((B, c), bool) if enabled is None else np.broadcast_to(enabled, (B, c)).copy()
    bt = np.full((B, c), DYNAMIC, np.int32) if body_type is None else np.broadcast_to(
        np.asarray(body_type, np.int32), (B, c)).copy()
    return ctr - half, ctr + half, en, bt


def _ref_colliders(enabled):
    c = enabled.shape[-1]
    return jt.empty_colliders(c).replace(
        enabled=jnp.asarray(enabled), parent=jnp.arange(c, dtype=jnp.int32))


def _port_colliders(enabled):
    parts = []
    for s in range(B):
        ref = _ref_colliders(enabled[s])
        parts.append({f.name: np.asarray(getattr(ref, f.name)) for f in dataclasses.fields(ref)})
    return Colliders(**{
        k: torch.from_numpy(np.stack([p[k] for p in parts]).astype(
            np.int64 if parts[0][k].dtype == np.uint32 else parts[0][k].dtype))
        for k in parts[0]})


def _lattice(n=5):
    return [[i, j, k] for i in range(n) for j in range(n) for k in range(n)]


def _long_ground():
    # 5 x 3 boxes, so that no two axes tie in variance: SAP's sweep axis is
    # an argmax over f32 variances, whose last bits depend on the order of
    # the sum (XLA's and PyTorch's differ), so an exact tie can go either way.
    centers = [[x * 1.2, 0.5, z * 1.2] for x in range(5) for z in range(3)]
    half = np.full((16, 3), 0.5, np.float32)
    half[-1] = [100.0, 0.1, 100.0]
    bt = [DYNAMIC] * 15 + [FIXED]
    return centers + [[0.0, -0.1, 0.0]], half, None, bt


def _disabled():
    rng = np.random.default_rng(3)
    en = np.ones(64, bool)
    en[rng.permutation(64)[:34]] = False      # 34 sentinel keys at the end
    return rng.uniform(-4, 4, (64, 3)), 1.0, en, None


def _equal_extents():
    # A 2-level box pile of one size: every extent ties, so the long set is
    # chosen by the tie order alone (4 x 3 columns: no variance tie).
    centers = [[x * 2.1, y * 2.0 + 1.0, z * 2.1] for y in range(2) for x in range(4)
               for z in range(3)]
    return centers, 1.0, None, None


CASES = {
    "random": lambda: (np.random.default_rng(0).uniform(-10, 10, (40, 3)), 1.0, None, None),
    "dense_lattice": lambda: (_lattice(), 0.51, None, None),
    "long_ground": _long_ground,
    "disabled": _disabled,
    "equal_extents": _equal_extents,
}


def _run_both(kind, case, max_pairs, window=64):
    mins, maxs, en, bt = _case(*CASES[case]())
    if kind == "sap":
        port = pbp.find_pairs_sap(torch.from_numpy(mins), torch.from_numpy(maxs),
                                  _port_colliders(en), torch.from_numpy(bt), max_pairs, window)
    else:
        port = pbp.find_pairs_grid(torch.from_numpy(mins), torch.from_numpy(maxs),
                                   _port_colliders(en), torch.from_numpy(bt), max_pairs)
    for s in range(B):
        args = (jnp.asarray(mins[s]), jnp.asarray(maxs[s]), _ref_colliders(en[s]),
                jnp.asarray(bt[s]), max_pairs)
        ref = REF_SAP(*args, window) if kind == "sap" else REF_GRID(*args)
        for name, a, d in zip(("c1", "c2", "valid", "overflow"), port, ref):
            np.testing.assert_array_equal(a[s].numpy(), np.asarray(d), err_msg=f"scene {s} {name}")
    return port


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["sap", "grid"])
def test_broad_phase_matches_reference(kind, case):
    c1, _, valid, _ = _run_both(kind, case, 2048)
    assert int(valid.sum()) > 0


@pytest.mark.parametrize("kind", ["sap", "grid"])
def test_broad_phase_overflow_matches_reference(kind):
    # A full buffer (GRID) and a window too short for the lattice (SAP).
    _, _, _, overflow = _run_both(kind, "dense_lattice", 256, window=8)
    assert int(overflow.min()) > 0


def test_grid_counts_wrapped_sentinel_keys_as_the_reference():
    """Disabled colliders sort last with the int32 maximum key; the
    reference's key + 1 wraps there, so the sentinel rows add no truncation
    to `overflow` (unwrapped int64 keys would add some)."""
    _, _, _, overflow = _run_both("grid", "disabled", 2048)
    assert int(overflow.max()) == 0


def test_find_pairs_dispatches_every_kind():
    mins, maxs, en, bt = _case(*CASES["random"]())
    args = (torch.from_numpy(mins), torch.from_numpy(maxs), _port_colliders(en),
            torch.from_numpy(bt), 512)
    for kind, fn in ((jt.BroadPhaseKind.SAP, lambda: pbp.find_pairs_sap(*args, 40)),
                     (jt.BroadPhaseKind.GRID, lambda: pbp.find_pairs_grid(*args)),
                     (jt.BroadPhaseKind.ALL_PAIRS, lambda: pbp.find_pairs_all(*args))):
        for a, d in zip(pbp.find_pairs(*args, int(kind), 40), fn()):
            assert torch.equal(a, d), kind


def _segments(seed=0, k=257, n=19):
    """Segment ids and values of the scale of one pass's velocity deltas
    (0.1): the prefix sums stay near 1, where 1e-6 is a few ulps."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (B, k)).astype(np.int32)
    vals = rng.normal(0.0, 0.1, (B, 3, k)).astype(np.float32)
    return ids, vals, rng.random((B, k)) > 0.7, n


def test_segment_reductions_match_reference():
    ids, vals, flags, n = _segments()
    plan = prt.make_segment_plan(torch.from_numpy(ids), n)
    got_sum = prt.segment_sum(torch.from_numpy(vals), plan).numpy()
    got_max = prt.segment_max(torch.from_numpy(vals[:, 0]), plan, float("-inf")).numpy()
    got_any = prt.segment_any(torch.from_numpy(flags), plan).numpy()
    for s in range(B):
        jplan = jrt.make_segment_plan(jnp.asarray(ids[s]), n)
        np.testing.assert_array_equal(plan.perm[s].numpy(), np.asarray(jplan.perm))
        np.testing.assert_array_equal(plan.starts[s].numpy(), np.asarray(jplan.starts))
        np.testing.assert_array_equal(plan.ends[s].numpy(), np.asarray(jplan.ends))
        np.testing.assert_allclose(got_sum[s], np.asarray(jrt.segment_sum(jnp.asarray(vals[s]), jplan)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got_max[s], np.asarray(
            jrt.segment_max(jnp.asarray(vals[s, 0]), jplan, jnp.float32(-np.inf))))
        np.testing.assert_array_equal(got_any[s], np.asarray(
            jrt.segment_any(jnp.asarray(flags[s]), jplan)))


@pytest.mark.parametrize("total", [0, 100, 12032, 83328])
@pytest.mark.parametrize("max_colors", [4, 8, 16, 20])
def test_block_caps_match_reference(total, max_colors):
    assert pcol.block_caps(total, max_colors) == jcol.block_caps(total, max_colors)


def _graph(seed, k, n, frac_valid):
    rng = np.random.default_rng(seed)
    b1 = rng.integers(0, n, (B, k)).astype(np.int32)
    b2 = rng.integers(0, n, (B, k)).astype(np.int32)
    return (b1, b2, rng.random((B, k)) > 0.2, rng.random((B, k)) > 0.3,
            rng.random((B, k)) < frac_valid)


@pytest.mark.parametrize("caps, k, frac_valid, expect", [
    ((64, 32, 32, 16), 512, 0.8, "drops"),   # capped rounds and dropped lanes
    ((256, 128, 128, 64, 64, 32, 32, 32), 512, 0.6, None),
    (pcol.block_caps(48, 16), 64, 0.3, "spare rounds"),
])
def test_blocked_coloring_matches_reference(caps, k, frac_valid, expect):
    n = 48
    b1, b2, dyn1, dyn2, valid = _graph(5, k, n, frac_valid)
    color, slot, dropped = pcol.color_constraints_blocked(
        *(torch.from_numpy(x) for x in (b1, b2, dyn1, dyn2, valid)), n, caps)
    for s in range(B):
        rc, rs, rd = REF_BLOCKED(
            *(jnp.asarray(x[s]) for x in (b1, b2, dyn1, dyn2, valid)), n, caps)
        np.testing.assert_array_equal(color[s].numpy(), np.asarray(rc))
        np.testing.assert_array_equal(slot[s].numpy(), np.asarray(rs))
        assert int(dropped[s]) == int(rd)
    if expect == "drops":
        assert int(dropped.min()) > 0
    elif expect == "spare rounds":
        # Spare rounds: every lane colored before the last round, which the
        # reference skips and the port runs on nothing.
        assert int(dropped.max()) == 0
        assert int(color[valid].max()) < len(caps) - 1


def test_widened_tail_drops_no_lane():
    """With the blocked solve's caps (`solve_caps`: the Jacobi tail holds
    every lane), the lanes the reference colors keep its colors and slots,
    and the lanes it drops join the tail instead."""
    n, k = 48, 512
    ref_caps = (64, 32, 32, 16)
    caps = ref_caps[:-1] + (k,)
    b1, b2, dyn1, dyn2, valid = _graph(5, k, n, 0.8)
    color, slot, dropped = pcol.color_constraints_blocked(
        *(torch.from_numpy(x) for x in (b1, b2, dyn1, dyn2, valid)), n, caps)
    assert int(dropped.max()) == 0
    for s in range(B):
        rc, rs, rd = (np.asarray(x) for x in REF_BLOCKED(
            *(jnp.asarray(x[s]) for x in (b1, b2, dyn1, dyn2, valid)), n, ref_caps))
        kept, placed = rc >= 0, (rc >= 0) & (rc < len(caps))
        assert int(rd) > 0
        np.testing.assert_array_equal(color[s].numpy()[kept], rc[kept])
        np.testing.assert_array_equal(slot[s].numpy()[placed], rs[placed])
        assert bool((color[s].numpy()[~kept] == len(caps) - 1).all())
    assert pcol.solve_caps(12032, 12032, 16) == pcol.block_caps(12032, 16)[:-1] + (12032,)
