"""The contact solve's work, counted from the problem, on a hand-worked scene."""

from types import SimpleNamespace

import pytest
import torch

from port_bench import run

ROOF = run.load_module(run.HERE / "metrics" / "sweep_roofline.py")
PARAMS = SimpleNamespace(num_solver_iterations=4, num_internal_pgs_iterations=1,
                         num_internal_stabilization_iterations=1)


def scene():
    """A ground, two awake dynamic bodies and a sleeping one; lane 0 a
    touching pair with 2 active points (solved), lane 1 touching with none,
    lane 2 an active point on a pair that does not touch."""
    bodies = SimpleNamespace(body_type=torch.tensor([[1, 0, 0, 0]]),
                             enabled=torch.ones(1, 4, dtype=torch.bool),
                             sleeping=torch.tensor([[False, False, False, True]]))
    pa = torch.zeros(1, 4, 3, dtype=torch.bool)
    pa[0, 0:2, 0] = True
    pa[0, 0, 2] = True
    contacts = SimpleNamespace(point_active=pa, touching=torch.tensor([[True, True, False]]))
    return SimpleNamespace(bodies=bodies, contacts=contacts)


def test_work_by_hand():
    n_bytes, flops = ROOF.solve_work(scene(), PARAMS)
    # 2 bodies x (24 read + 13 written) + 1 pair x (10 + 3) + 2 points x (5 + 1) words
    assert n_bytes == 4 * (2 * 37 + 13 + 2 * 6) == 396
    # one lane: generation, then 4 substeps of update + warmstart and 2 sweeps
    assert flops == 850 + 4 * (500 + 2 * 390) == 5970
    assert ROOF.least_seconds(n_bytes, flops) == pytest.approx(396 / 3.35e12)


def test_roofline_reads_the_kernel_by_name():
    run_ = dict(params=PARAMS, trace=dict(outputs=[scene()], events=[
        (0, 1000, "(anonymous namespace)::contact_sweep_kernel(float const*, int const*)"),
        (0, 700, "(anonymous namespace)::contact_sweep_folded_kernel(float const*)"),
        (1000, 9000, "void at::native::elementwise_kernel<128, 2>")]))
    assert ROOF.read(run_) == pytest.approx(100 * (396 / 3.35e12) / 1e-6)
    run_["trace"]["events"] = run_["trace"]["events"][1:]
    assert ROOF.read(run_) is None          # no contact_sweep_kernel: nothing to read
    assert ROOF.read(dict(params=PARAMS)) is None


def test_trace_readers():
    idle = run.load_module(run.HERE / "metrics" / "device_idle_pct.py")
    launches = run.load_module(run.HERE / "metrics" / "launches_per_step.py")
    tr = dict(events=[(0, 400, "a"), (300, 500, "b"), (800, 1000, "c")], window_s=1e-6,
              steps=2)
    assert idle.read(dict(trace=tr)) == pytest.approx(100 * (1 - 700 / 1000))
    assert launches.read(dict(trace=tr)) == 1.5
    assert run.busy_ns(tr["events"]) == 700
    spans = [("step", 0, 450), ("sync", 450, 900)]
    b = run.breakdown(dict(tr, spans=spans))
    assert b["idle_gaps"] == [["sync", 300 / 1e9]]
    assert b["device_ops"][0] == ["b", 200 / 1e9] or b["device_ops"][0][1] == 400 / 1e9


def test_stage_readers():
    st = dict(broad_phase=2.0, narrow_phase=10.0, gjk_epa=6.0, solve=5.0, joints=1.0)
    read = {n: run.load_module(run.HERE / "metrics" / f"{n}.py").read
            for n in ("broad_phase_ms", "narrow_phase_ms", "gjk_epa_ms", "solve_ms")}
    assert [read[n](dict(stages=st)) for n in read] == [2.0, 4.0, 6.0, 4.0]
    assert read["gjk_epa_ms"](dict(stages=dict(narrow_phase=3.0))) is None
