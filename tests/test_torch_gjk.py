"""rapier_tpu_torch's GJK/EPA (geometry/gjk.py) against rapier_tpu.geometry.gjk
on the CPU.

Inputs: `test_torch_common.convex_pairs`, one lane for every ordered pair of
`narrowphase_convex.SUPPORTED` types (round shapes and two hulls included)
in four cases: separated (GJK), deep (EPA), near (either) and touching
exactly (the 1e-4-inflated retry).  The port runs all lanes at once, the
reference one lane at a time (jit of the one-lane function; its vmapped
triangle SAT is miscompiled by XLA:CPU, ROADMAP R14, and a one-lane call
avoids any such fault here).

Tolerances: the distance within 1e-4, the unit normal within 2e-3 and the
witness points within 5e-3 (GJK stops at a relative progress of 1e-6, so
separated normals and witness points agree to ~1e-3 between two roundings).

EPA on a polytope meets rounding ties by construction: its face normals are
face normals of the Minkowski difference, where a cuboid's or hull's
support picks a vertex by the sign of components that are zero up to
rounding, and a degenerate expansion (the reference's tetrahedron seed is
not consistently wound) cycles through faces.  A lane that differs is held
to witnesses: the reference run from starts 1 ulp apart (each component of
both positions and rotations, up and down).  It passes if the port agrees
with one of them, or if the reference itself is unstable there (a witness
parts from the reference by more than the tolerance); at most 5% of a
seed's lanes may take the second way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_common as tp
from rapier_tpu.geometry import gjk as rg
from rapier_tpu_torch.geometry import gjk as pg

KEYS = ("pA", "rA", "stA", "prmA", "pB", "rB", "stB", "prmB")
TOL_DIST, TOL_NORMAL, TOL_POINT = 1e-4, 2e-3, 5e-3
SEEDS = (0, 1)
UNSTABLE_SHARE = 0.05


@functools.lru_cache(maxsize=None)
def _ref_fn():
    return jax.jit(rg.contact_support_maps)


def _ref_lane(lanes, hA, hB, i):
    a = [jnp.asarray(lanes[k][i]) for k in KEYS]
    return [np.asarray(x, np.float64)
            for x in _ref_fn()(*a, jnp.asarray(hA[i]), jnp.asarray(hB[i]))]


def _close(o, r):
    return (abs(o[0] - r[0]) <= TOL_DIST and np.abs(o[1] - r[1]).max() <= TOL_NORMAL
            and np.abs(o[2] - r[2]).max() <= TOL_POINT
            and np.abs(o[3] - r[3]).max() <= TOL_POINT)


@functools.lru_cache(maxsize=None)
def contact_results(seed):
    """(lanes, cases, port results, reference results, per-lane verdict of
    `test_torch_common.witness_verdicts`)."""
    lanes, hulls, case = tp.convex_pairs(seed)
    hA = tp.lane_hulls(lanes["stA"], lanes["prmA"], hulls)
    hB = tp.lane_hulls(lanes["stB"], lanes["prmB"], hulls)
    ref = [np.stack(x) for x in zip(*[_ref_lane(lanes, hA, hB, i) for i in range(len(case))])]
    port = [o.numpy().astype(np.float64) for o in pg.contact_support_maps(
        *[torch.from_numpy(lanes[k]) for k in KEYS], torch.from_numpy(hA),
        torch.from_numpy(hB))]
    verdict = tp.witness_verdicts(lanes, lambda l, i: _ref_lane(l, hA, hB, i), port, _close)
    return lanes, case, port, ref, verdict


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", tp.CONVEX_CASES)
def test_contact_support_maps_matches_reference(seed, case):
    """Every lane agrees with the reference or its witness, or the reference
    is unstable there (a bounded share of the lanes)."""
    lanes, cases, port, ref, verdict = contact_results(seed)
    sel = cases == case
    bad = np.flatnonzero(sel & (verdict == "differs"))
    assert bad.size == 0, [(int(i), int(lanes["stA"][i]), int(lanes["stB"][i]),
                            float(port[0][i]), float(ref[0][i])) for i in bad]
    assert np.mean(verdict == "unstable") <= UNSTABLE_SHARE, np.unique(verdict, return_counts=True)
    for x in port:
        assert np.isfinite(x[sel]).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_separated_and_touching_lanes_agree_directly(seed):
    """GJK's answer (separated) and the exact-touch retry (touching) need no
    witness: every separated lane and 95% of the touching ones agree with
    the reference itself.  No touching lane overlaps (B sits on A's top;
    with a lateral offset a rounded side leaves a gap), and most touch with
    a gap of exactly 0 and the normal +Y."""
    lanes, cases, port, ref, verdict = contact_results(seed)
    sep = cases == "separated"
    assert (verdict[sep] == "agree").all()
    assert (port[0][sep] > 0.0).all()
    touch = cases == "touching"
    assert np.mean(verdict[touch] == "agree") >= 0.95
    assert port[0][touch].min() >= -1e-4
    flat = touch & (port[0] == 0.0) & (np.abs(port[1] - [0.0, 1.0, 0.0]).max(axis=1) <= 1e-2)
    assert flat.sum() >= 0.5 * touch.sum(), (flat.sum(), touch.sum())


@functools.lru_cache(maxsize=None)
def _ref_gjk_epa():
    def run(pA, rA, stA, prmA, pB, rB, stB, prmB, hA, hB):
        supp = rg.make_support(pA, rA, stA, prmA, pB, rB, stB, prmB, hA, hB)
        d0 = pB - pA
        g = rg.gjk(supp, d0)
        return g, rg.epa(supp, g)

    return jax.jit(run)


@pytest.mark.parametrize("stage", ["gjk", "epa"])
def test_gjk_and_epa_match_reference(stage):
    """`gjk` alone on the separated and near lanes (distance, intersection
    flag, witness points), and `epa` alone on
    the deep lanes, seeded with the reference's own terminal simplex so that
    only EPA is compared (depth, normal, seed flag), held as above."""
    lanes, hulls, case = tp.convex_pairs(2, ("separated", "near", "deep"))
    hA = tp.lane_hulls(lanes["stA"], lanes["prmA"], hulls)
    hB = tp.lane_hulls(lanes["stB"], lanes["prmB"], hulls)
    t = [torch.from_numpy(lanes[k]) for k in KEYS]
    supp = pg.make_support(*t, torch.from_numpy(hA), torch.from_numpy(hB))
    n_ok = n_lanes = 0
    for i in range(len(case)):
        if (stage == "gjk") == (case[i] == "deep"):
            continue
        g_ref, e_ref = _ref_gjk_epa()(*[jnp.asarray(lanes[k][i]) for k in KEYS],
                                      jnp.asarray(hA[i]), jnp.asarray(hB[i]))
        sub = pg.make_support(*[x[i:i + 1] for x in t], torch.from_numpy(hA[i:i + 1]),
                              torch.from_numpy(hB[i:i + 1]))
        n_lanes += 1
        if stage == "gjk":
            g = pg.gjk(sub, t[4][i:i + 1] - t[0][i:i + 1])
            same = (abs(float(g["dist"][0]) - float(g_ref["dist"])) <= TOL_DIST
                    and bool(g["intersect"][0]) == bool(g_ref["intersect"])
                    and np.abs(g["cpA"][0].numpy() - np.asarray(g_ref["cpA"])).max() <= TOL_POINT
                    and np.abs(g["cpB"][0].numpy() - np.asarray(g_ref["cpB"])).max() <= TOL_POINT)
            n_ok += same
        else:
            seed_state = {k: torch.from_numpy(np.array(v)[None]) for k, v in g_ref.items()}
            seed_state["nvalid"] = seed_state["nvalid"].long()
            depth, n, _, _, ok = pg.epa(sub, seed_state)
            same = (abs(float(depth[0]) - float(e_ref[0])) <= TOL_DIST
                    and np.abs(n[0].numpy() - np.asarray(e_ref[1])).max() <= TOL_NORMAL
                    and bool(ok[0]) == bool(e_ref[4]))
            n_ok += same
    del supp
    # GJK: all but the near lanes' rounding ties of the intersection test;
    # EPA: the share the witness test above leaves to rounding ties (deep
    # lanes only, so a larger share than over all cases).
    assert n_ok >= (0.95 if stage == "gjk" else 0.75) * n_lanes, (n_ok, n_lanes)
