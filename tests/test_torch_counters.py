"""The port's recorder (`rapier_tpu_torch.utils.counters.recording`): spans
and counters inside the step, on the CPU at a tiny size.  The step is the
bench's at 2 layers of 3 x 3 on two scenes, settled until its bodies touch."""

from __future__ import annotations

import dataclasses
import functools
import warnings

import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread a worker)
from rapier_tpu_torch.utils import counters

# The spans directly under the root `step` span in a bench step, in order
# (the bench has no meshes, hooks or CCD).
BENCH_STAGES = ("prologue", "broad_phase", "narrow_phase", "contact_match", "wake",
                "solver_bodies", "solve", "writeback", "sleep", "contact_cache")
SETTLE_STEPS = 40


@functools.lru_cache(maxsize=None)
def _bench():
    """(state with touching pairs, params) of the bench at 2 layers of 3 x 3."""
    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.scenes import mixed_primitives_world, replicate_scene
    from rapier_tpu_torch.types import from_numpy

    w = mixed_primitives_world(2, 3, max_pairs=512, device="cpu")
    w.params = w.params.replace(max_solver_pairs=256)
    state = replicate_scene(from_numpy(w.build(), "cpu"), 2)
    for _ in range(SETTLE_STEPS):
        state, _ = step(state, w.params)
    assert bool(state.contacts.touching.any())
    return state, w.params


@functools.lru_cache(maxsize=None)
def _recorded():
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    state, params = _bench()
    with counters.recording() as rec:
        out = step(state, params)
    return rec, out


def _leaves(x):
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x) for v in _leaves(getattr(x, f.name))]
    if isinstance(x, tuple):
        return [v for f in x for v in _leaves(f)]
    return [x] if isinstance(x, torch.Tensor) else []


def _bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8) if x.is_floating_point() else x


def test_recording_changes_no_result():
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    state, params = _bench()
    off = _leaves(step(state, params))
    on = _leaves(_recorded()[1])
    assert len(on) == len(off) > 20
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def test_spans_nest():
    rec = _recorded()[0]
    assert rec.spans and rec.spans[0][:3] == ("step", -1, 0)
    for i, (name, parent, step_i, a, b) in enumerate(rec.spans):
        assert a <= b, name
        if i:
            assert 0 <= parent < i, name
            _, _, p_step, pa, pb = rec.spans[parent]
            assert pa <= a and b <= pb and step_i == p_step, name


def test_root_span_holds_every_stage():
    rec = _recorded()[0]
    top = [s[0] for s in rec.spans if s[1] == 0]
    assert tuple(top) == BENCH_STAGES
    names = {s[0] for s in rec.spans}
    # The children under the stages: the analytic families, the merges,
    # the solve's parts on the kernel route.
    assert {"gather", "ball_ball", "ball_cuboid", "cuboid_cuboid", "merge",
            "compaction", "coloring", "sweep"} <= names


def test_off_records_nothing_and_keeps_the_sync_mode(monkeypatch):
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    mode = {"now": 0}
    sets = []

    def set_mode(m):
        sets.append(m)
        mode["now"] = m

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    state, params = _bench()
    step(state, params)
    assert counters._record is None and counters._timings is None and sets == []
    with counters.stage("broad_phase"), counters.span("x"):
        counters.count("c", 1)
    assert sets == [] and counters._record is None

    # On a card the recorder sets "warn" and restores the mode it found;
    # each sync warning counts under the innermost span, and any other
    # warning is shown once.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mode["now"] = 1
    shown = []
    with warnings.catch_warnings():
        warnings.showwarning = lambda *a, **k: shown.append(str(a[0]))
        with counters.recording() as rec:
            assert mode["now"] == "warn"
            with counters.span("outer"):
                with counters.span("inner"):
                    for _ in range(3):
                        warnings.warn(counters.SYNC_WARNING)
                        warnings.warn("something else")
                warnings.warn(counters.SYNC_WARNING)
        assert shown == ["something else"]
    assert sets == ["warn", 1] and mode["now"] == 1
    assert rec.syncs == {1: 3, 0: 1}


def _convex_lanes():
    """Eight convex pairs, cylinders, cones and cuboids a little turned
    from upright (seeded), stacked along y: four penetrating (the cone on
    the cuboid converges within EPA's iterations), four apart."""
    from rapier_tpu_torch.math import quat
    from rapier_tpu_torch.types import ShapeType

    g = torch.Generator().manual_seed(7)
    cyl, cone, box = (int(t) for t in (ShapeType.CYLINDER, ShapeType.CONE, ShapeType.CUBOID))
    stA = torch.tensor([cyl, box, box, cone] * 2)
    stB = torch.tensor([cone, box, cyl, box] * 2)
    n = len(stA)
    prm = torch.zeros((n, 12))
    prm[:, :3] = torch.tensor([0.5, 0.4, 0.35])

    def rot():
        return quat.normalize(torch.tensor([0.0, 0.0, 0.0, 1.0])
                              + 0.15 * torch.randn((n, 4), generator=g))

    rA, rB = rot(), rot()
    pA, pB = torch.zeros((n, 3)), torch.zeros((n, 3))
    pB[:, 1] = torch.tensor([0.75, 0.72, 0.78, 0.8, 2.0, 2.5, 3.0, 2.2])
    return pA, rA, stA, prm, pB, rB, stB, prm


def test_gjk_epa_counts_the_active_lanes(monkeypatch):
    """The counters against a count made lane by lane from outside: a lane
    is active at an iteration when the iteration changes its state, which
    a lane no longer active never does (GJK: its simplex; EPA: its best
    face's depth, tracked on active lanes only)."""
    from rapier_tpu_torch.geometry import gjk

    pA, rA, stA, prmA, pB, rB, stB, prmB = _convex_lanes()
    supp = gjk.make_support(pA, rA, stA, prmA, pB, rB, stB, prmB)
    d0 = pB - pA
    with counters.recording() as rec:
        g = gjk.gjk(supp, d0)
        inter = torch.nonzero(g["intersect"]).flatten()
        sub = gjk.make_support(*(x[inter] for x in (pA, rA, stA, prmA, pB, rB, stB, prmB)))
        e = gjk.epa(sub, {k: v[inter] for k, v in g.items()})
    got = {name: v for _, name, v in rec.counts}
    assert 0 < len(inter) < len(d0) and bool(e[4].all())

    def gjk_after(k):
        monkeypatch.setattr(gjk, "GJK_ITERS", k)
        r = gjk.gjk(supp, d0)
        return torch.cat([r["W"].flatten(1), r["nvalid"][:, None].float()], 1)

    states = [gjk_after(k) for k in range(gjk.GJK_ITERS + 1)]
    plain = len(d0) + sum(int((~(states[k] == states[k - 1]).all(1)).sum())
                          for k in range(1, len(states) - 1))
    assert got["gjk_useful"] == plain and got["gjk_attempted"] == 16 * len(d0)
    assert plain < got["gjk_attempted"]

    monkeypatch.setattr(gjk, "GJK_ITERS", 16)
    g_sub = {k: v[inter] for k, v in g.items()}

    def depth_after(k):
        monkeypatch.setattr(gjk, "EPA_ITERS", k)
        return gjk.epa(sub, g_sub)[0]

    depths = [depth_after(k) for k in range(gjk.EPA_ITERS + 1)]
    plain = sum(int((depths[k + 1] != depths[k]).sum()) for k in range(len(depths) - 1))
    assert got["epa_useful"] == plain and got["epa_attempted"] == 10 * len(inter)
    assert 0 < plain < got["epa_attempted"]


def test_masked_pass_counter_at_f64(monkeypatch):
    """The masked solve's counters against the step's own colors: useful,
    the colored lanes; attempted, every lane of every color pass; each
    over every sweep."""
    from rapier_tpu_torch import precision
    from rapier_tpu_torch.pipeline import physics_pipeline as pp
    from rapier_tpu_torch.scenes import replicate_scene, stack_world
    from rapier_tpu_torch.types import from_numpy

    precision.set_precision("f64")
    try:
        w = stack_world(3, device="cpu")
        state = replicate_scene(from_numpy(w.build(), "cpu"), 2)
        params = w.params
        assert pp.solve_path(state, params) == "masked"
        for _ in range(2):
            state, _ = pp.step(state, params)
        colors = []
        real = pp.color_constraints

        def kept(*a, **k):
            colors.append(real(*a, **k))
            return colors[-1]

        monkeypatch.setattr(pp, "color_constraints", kept)
        with counters.recording() as rec:
            pp.step(state, params)
    finally:
        precision.set_precision("f32")
    (color, num_colors), = colors
    sweeps = params.num_solver_iterations * (params.num_internal_pgs_iterations
                                             + params.num_internal_stabilization_iterations)
    valid = int((color < params.max_colors).sum())
    got = {name: v for _, name, v in rec.counts}
    assert valid > 0 and int(num_colors.max()) > 1
    assert got["masked_useful"] == valid * sweeps
    assert got["masked_attempted"] == color.numel() * int(num_colors.max()) * sweeps
    where = {rec.spans[i][0] for i, name, _ in rec.counts}
    assert where == {"color_passes"}


@pytest.mark.parametrize("name", ["stage", "span"])
def test_markers_pass_exceptions_through(name):
    with counters.recording() as rec:
        with pytest.raises(ValueError):
            with getattr(counters, name)("boom"):
                raise ValueError
    assert rec.spans[0][0] == "boom" and rec.spans[0][4] is not None
    assert counters._record is None
