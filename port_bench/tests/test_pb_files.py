"""BENCHMARK.json names only what exists, and every data file and metric
under the harness is found by name from it."""

import json
import re
from pathlib import Path

import pytest

from port_bench import run

BASE = Path(run.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        files = run.cell_files(bench, w["name"])
        cfg = files["config"]
        assert callable(files["layout"].layout)
        assert set(cfg["builder_args"]) <= set(cfg)
        assert set(files["limits"]) == {"start_pos_gap_m", "start_shape_gap", "pos_gap_m",
                                        "rot_gap", "vel_gap", "impulse_gap", "contact_gap"}
        for m in run.cell_metrics(bench, w["name"], False) + run.cell_metrics(bench, w["name"], True):
            assert callable(run.load_module(BASE / "metrics" / f"{m['name']}.py").read)


def test_every_file_is_named_by_the_benchmark(bench):
    cells = {w["name"] for w in bench["workloads"]}
    metrics = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    configs = {Path(c["file"]).stem for c in bench["configs"]}
    traffic = {w["traffic"] for w in bench["workloads"]}
    assert {p.stem for p in (BASE / "metrics").glob("*.py")} == metrics
    assert {p.stem for p in (BASE / "configs").glob("*.json")} == configs
    assert {p.stem for p in (BASE / "configs").glob("*.py")} == configs
    assert {p.stem for p in (BASE / "traffic").glob("*.json")} == traffic
    assert {p.name[:-len(".json")] for p in (BASE / "limits").glob("*.json")} == cells


def test_benchmark_json_keeps_to_its_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all((run.ROOT / p).is_dir() for p in bench["paths"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for x in bench["configs"] + bench["workloads"] + bench["end_to_end"]
             + bench["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for c in bench["configs"]:
        assert (run.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", ["mixed_primitives.e150", "primitives3.e150",
                                  "mixed_primitives.e150-f64"])
def test_the_three_cells_take_one_chip(bench, cell):
    (w,) = [w for w in bench["workloads"] if w["name"] == cell]
    assert w["chips"] == 1
