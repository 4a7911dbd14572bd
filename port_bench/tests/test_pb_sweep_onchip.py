"""`metrics/sweep_onchip_pct.py` on a recorded phase laid out by hand: one
step whose `solve` span holds `sweep`, with the kernel route's counters."""

import pytest

from port_bench import recorded, run

MS = 1_000_000   # ns


def _run(counts):
    """A phase of one step: the program's step 0-80 ms holds solve 50-80
    (sweep 60-75 under it); one device operation in sweep."""
    rec = dict(events=[(61 * MS, 70 * MS, "contact_sweep_kernel", 1)], launches={1: 60 * MS},
               program=[("step", -1, 0, 0, 80 * MS), ("solve", 0, 0, 50 * MS, 80 * MS),
                        ("sweep", 1, 0, 60 * MS, 75 * MS)],
               spans=[("step", 0, 90 * MS)], counts=counts, syncs={}, window_s=0.09, steps=1)
    rec.update(recorded.analyse(rec))
    return {"recorded": rec}


def _read(r):
    return run.load_module(run.HERE / "metrics" / "sweep_onchip_pct.py").read(r)


@pytest.mark.parametrize("counts, want", [
    ([(2, "sweep_lanes", 300), (2, "sweep_onchip", 240)], 80.0),
    ([(2, "sweep_lanes", 120), (2, "sweep_onchip", 120), (2, "sweep_lanes", 80),
      (2, "sweep_onchip", 0)], 60.0),
    ([(2, "sweep_lanes", 50)], 0.0),
])
def test_reads_the_onchip_share(counts, want):
    assert _read(_run(counts)) == pytest.approx(want)


@pytest.mark.parametrize("counts", [[], [(1, "masked_useful", 5), (1, "masked_attempted", 20)],
                                    [(2, "sweep_lanes", 0), (2, "sweep_onchip", 0)]])
def test_reads_nothing_without_kernel_lanes(counts):
    """A phase in which no step solved a lane on the kernel route (the
    masked route's counters only, or no counter at all) reads nothing."""
    assert _read(_run(counts)) is None


def test_reads_nothing_without_a_recorded_phase():
    assert _read({}) is None
    assert _read({"trace": None}) is None
