"""The plain reference against rapier_tpu_torch on the CPU at a tiny batch,
and what each of them loads."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench import run

ROOT = str(run.ROOT)


def advance(cell, bench, overrides, settle, compare=3, seed=2**35 + 3):
    """The port's state after `settle` steps, then `compare` steps each held
    against one reference step from the port's own state."""
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    files = run.cell_files(bench, cell)
    cfg = dict(files["config"], **overrides)
    state, params, _, _ = run.build_batch(cfg, files["traffic"], seed, "cpu")
    for _ in range(settle):
        state, _ = step(state, params)
    worst, touching = {}, 0
    for _ in range(compare):
        nxt, _ = step(state, params)
        ref = run.reference_step(cfg, state, files["traffic"]["precision"])
        touching += int(ref.contacts.touching.sum())
        for k, v in run.gaps(nxt, ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
        state = nxt
    return worst, files["limits"], touching, state


@pytest.mark.parametrize("cell, overrides, settle", [
    ("mixed_primitives.e150", dict(scenes=2, num_layers=2, grid=2), 45),
    ("primitives3.e150", dict(scenes=2, num_layers=3, grid=2), 110),
    ("mixed_primitives.e150-f64", dict(scenes=2, num_layers=2, grid=2), 45),
])
def test_reference_follows_the_port(bench, f32, cell, overrides, settle):
    worst, limits, touching, state = advance(cell, bench, overrides, settle)
    assert touching > 0
    for k, v in worst.items():
        assert v <= limits[k], (k, v, limits[k])
    if cell.endswith("f64"):
        assert state.bodies.pos.dtype == torch.float64


def test_primitives3_reaches_gjk_pairs(bench, f32):
    """The compared steps include touching pairs of a round cylinder or a
    cone, which take GJK/EPA."""
    _, _, _, state = advance("primitives3.e150", bench, dict(scenes=1, num_layers=3, grid=2),
                             110, compare=1)
    c, st = state.contacts, state.colliders.shape_type
    t1 = torch.gather(st, 1, c.collider1.clamp(min=0).long())
    t2 = torch.gather(st, 1, c.collider2.clamp(min=0).long())
    gjk = (t1 == 9) | (t2 == 9) | (t1 == 5) | (t2 == 5)
    assert bool((c.touching & gjk).any())


@pytest.mark.parametrize("cell, overrides", [
    ("mixed_primitives.e150", dict(scenes=1, num_layers=1, grid=2)),
    ("primitives3.e150", dict(scenes=1, num_layers=1, grid=2)),
    ("mixed_primitives.e150-f64", dict(scenes=1, num_layers=1, grid=2)),
])
def test_the_reference_steps_under_the_worlds_params(bench, f32, cell, overrides):
    """Every field that the reference's SimParams shares with the world's
    params holds the same value at the same dtype, but the f64 cells'
    gravity: the world holds (0, -9.81, 0) in float32, the reference in
    float64."""
    import dataclasses

    import numpy as np

    files = run.cell_files(bench, cell)
    cfg, dtype = dict(files["config"], **overrides), files["traffic"]["precision"]
    state, params, _, _ = run.build_batch(cfg, files["traffic"], 5, "cpu")
    ref = run.reference_params(cfg, run.to_reference(state), dtype, params)
    differ = {}
    for f in dataclasses.fields(ref):
        if hasattr(params, f.name):
            a, b = np.asarray(getattr(params, f.name)), np.asarray(getattr(ref, f.name))
            if a.dtype != b.dtype or not np.array_equal(a, b):
                differ[f.name] = (a, b)
    if dtype == "f64":
        world_g, ref_g = differ.pop("gravity")
        assert world_g.dtype == np.float32 and ref_g.dtype == np.float64
        assert np.array_equal(ref_g, [0.0, -9.81, 0.0])
        assert np.array_equal(world_g, ref_g.astype(np.float32))
    assert not differ, differ


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    names = loaded("import sys; sys.path.insert(0, '.')\n"
                   "import port_bench.reference.step, port_bench.reference.masses\n"
                   "from port_bench import run\n"
                   "for c in ('mixed_primitives', 'primitives3'):\n"
                   "    run.load_module(run.HERE / 'configs' / (c + '.py')).layout(1, 1, 1.0)")
    assert not names & {"jax", "jaxlib", "flax", "rapier_tpu", "rapier_tpu_torch"}


def test_a_run_loads_no_jax():
    names = loaded("import sys; sys.path.insert(0, '.')\n"
                   "from port_bench import run\n"
                   "bench = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
                   "run.run_cell(bench, 'primitives3.e150', 5, 0.2, False, device='cpu',\n"
                   "    overrides=dict(scenes=2, num_layers=1, grid=2, episode_steps=3,\n"
                   "                   check_every=1, check_captures=1, check_scenes=1))\n"
                   "assert not run.banned_modules()")
    assert "rapier_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rapier_tpu"}
