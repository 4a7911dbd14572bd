"""The recorded phase's analysis and the metrics that read it, on a phase
laid out by hand (`recorded.py`): program spans, loop spans, launches,
device operations, synchronisations and counters."""

import pytest

from port_bench import recorded, run

MS = 1_000_000   # ns


# Device operations (start ms, end ms, correlation id, the launch's host
# ms): the loop's reset, broad_phase, narrow_phase, gjk_epa, solve, joints,
# the program's step outside its stages, the loop's events.
OPS = [(1, 2, 1, 1), (16, 18, 2, 13), (24, 27, 3, 21), (37, 41, 4, 31), (51, 56, 5, 51),
       (62, 81, 6, 61), (89, 91, 7, 85), (101, 104, 8, 101)]


def _phase():
    """One step.  Host times in ms: the loop's reset 0-5, step 5-95, sync
    95-100, events 100-110; the program's step 10-90 holds broad_phase
    12-20, narrow_phase 20-50 (gjk_epa 30-45 under it) and solve 50-80
    (joints 60-70 under it).  The card's gaps fall (by their middles) in
    the loop's step (9), narrow_phase (21, 46), gjk_epa (32), solve (59),
    the program's step outside its stages (85) and the loop's sync (96)."""
    program = [("step", -1, 0, 10 * MS, 90 * MS),
               ("broad_phase", 0, 0, 12 * MS, 20 * MS),
               ("narrow_phase", 0, 0, 20 * MS, 50 * MS),
               ("gjk_epa", 2, 0, 30 * MS, 45 * MS),
               ("solve", 0, 0, 50 * MS, 80 * MS),
               ("joints", 4, 0, 60 * MS, 70 * MS)]
    spans = [("reset", 0, 5 * MS), ("step", 5 * MS, 95 * MS), ("sync", 95 * MS, 100 * MS),
             ("events", 100 * MS, 110 * MS)]
    launches = {c: t * MS for _, _, c, t in OPS}
    launches[99] = 200 * MS            # a runtime call that launched nothing
    return dict(events=[(a * MS, b * MS, f"op{c}", c) for a, b, c, _ in OPS],
                launches=launches, program=program, spans=spans,
                counts=[(3, "gjk_useful", 30), (3, "gjk_attempted", 64), (3, "epa_useful", 10),
                        (3, "epa_attempted", 16), (4, "masked_useful", 5),
                        (4, "masked_attempted", 20)],
                syncs={0: 2, 2: 1, 3: 4, 5: 3, -1: 5}, window_s=0.11, steps=1)


def _run():
    rec = _phase()
    rec.update(recorded.analyse(rec))
    return {"recorded": rec}


@pytest.mark.parametrize("metric, want", [
    ("broad_phase_host_ms", 8.0), ("narrow_phase_host_ms", 30.0 - 15.0),
    ("gjk_epa_host_ms", 15.0), ("solve_host_ms", 30.0 - 10.0),
    ("broad_phase_device_ms", 2.0), ("narrow_phase_device_ms", 3.0),
    ("gjk_epa_device_ms", 4.0), ("solve_device_ms", (5.0 + 19.0) - 19.0),
    ("syncs_per_step", 2 + 1 + 4 + 3),
    ("gjk_epa_useful_pct", 100.0 * 40 / 80), ("masked_pass_useful_pct", 25.0)])
def test_reader_reads_the_known_value(metric, want):
    got = run.load_module(run.HERE / "metrics" / f"{metric}.py").read(_run())
    assert got == pytest.approx(want)


def test_every_operation_is_placed():
    rec = _phase()
    out = recorded.analyse(rec)
    assert out["placed"] == len(rec["events"]) and out["unplaced"] == 0
    # The program's root and the loop's own spans hold every operation
    # once between them.
    top = [out["stages"][k] for k in ("step", "reset", "sync", "events")]
    assert sum(r["launches"] for r in top) == len(rec["events"])
    assert sum(r["device_ms"] for r in top) == pytest.approx(sum(b - a for a, b, *_ in OPS))
    assert out["stages"]["reset"]["launches"] == 1 and out["stages"]["events"]["launches"] == 1
    assert out["stages"]["step"]["launches"] == 6
    assert out["stages"]["step/narrow_phase"]["device_ms"] == pytest.approx(3 + 4)


def test_a_launch_outside_every_span_is_unplaced():
    rec = _phase()
    rec["launches"][8] = 300 * MS
    del rec["launches"][7]
    out = recorded.analyse(rec)
    assert out["unplaced"] == 2 and out["stages"][recorded.NO_SPAN]["launches"] == 2


def test_breakdown_labels_a_gap_by_its_innermost_span():
    gaps = dict(recorded.analyse(_phase())["idle_gaps"])
    assert gaps == pytest.approx({"step": 0.014 + 0.008, "step/narrow_phase": 0.006 + 0.010,
                                  "step/narrow_phase/gjk_epa": 0.010, "step/solve": 0.006,
                                  "sync": 0.010})


def test_no_recorder_reads_nothing(monkeypatch):
    """An earlier program (no `counters.recording`) and a run that traced
    nothing give None, and so does every reader."""
    from rapier_tpu_torch.utils import counters

    assert recorded.phase({"trace": None}) is None
    monkeypatch.delattr(counters, "recording")
    assert recorded.record(loop=None, steps=3) is None
    for metric in ("broad_phase_device_ms", "syncs_per_step", "gjk_epa_useful_pct"):
        assert run.load_module(run.HERE / "metrics" / f"{metric}.py").read({}) is None


def test_innermost_takes_the_deepest_span():
    iv = [(0, 100), (10, 50), (20, 30), (60, 90)]
    assert recorded.innermost(iv, [5, 10, 25, 30, 55, 70, 150]) == [0, 1, 2, 2, 0, 3, -1]
