"""A benchmark directory of new files only that holds an articulated,
actuated robot: the port's MJCF quadruped
(`scenes.quadruped_world(use_multibody=True)`: a free trunk, four 2-hinge
legs, 8 position servos, Z up), its plain layout, a traffic with the
policy's actions, limits, and a reference package of its own that records
what the harness gives it and steps the port (it has no reference of its
own yet, so its `correct` shows the harness's plumbing, not the program).

    bench = write(root, scenes=4, episode_steps=6, every=2, scale=0.5)
    run.run_cell(bench, CELL, seed, seconds, trace, root=root)

`test_pb_robot.py` runs it on the CPU at 4 scenes; the same directory at
4096 scenes and 120-step episodes sizes the `quadruped.e120` cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from port_bench import run

CELL = "quadruped.actions"
REFERENCE = "recording_reference"

LAYOUT = '''"""The plain layout of the port's MJCF quadruped (rapier_tpu_torch/scenes.py,
QUADRUPED_MJCF): a floor halfspace (normal +z) at the origin; a trunk box of
half-extents (0.25, 0.15, 0.05), density 800, at z = 0.45 on a free root;
four legs at x = +-0.18, y = +-0.11, each an upper capsule (radius 0.03) at
z = 0.40 and a lower one (0.025) at z = 0.22, each 0.18 long down its
body's -z from the body's origin, density 1000.  Every link's
`articulation` is the trunk, body 1."""

import math

CUBOID, CAPSULE, HALFSPACE = 1, 2, 3


def _capsule_down(r, h, density):
    mc, ms = math.pi * r * r * h, 4.0 / 3.0 * math.pi * r ** 3
    axial = mc * r * r / 2 + ms * 0.4 * r * r
    cross = mc * (h * h / 12 + r * r / 4) + ms * (0.4 * r * r + h * h / 4 + 3 / 8 * h * r)
    return dict(mass=density * (mc + ms), inertia=(density * cross, density * cross,
                                                   density * axial), com=(0.0, 0.0, -h / 2))


def layout(use_multibody=True):
    hx, hy, hz = 0.25, 0.15, 0.05
    m = 800.0 * 8 * hx * hy * hz
    out = [dict(pos=(0.0, 0.0, 0.0), shape=HALFSPACE, params=(0.0, 0.0, 1.0), dynamic=False),
           dict(pos=(0.0, 0.0, 0.45), shape=CUBOID, params=(hx, hy, hz), dynamic=True,
                articulation=1, mass=m, com=(0.0, 0.0, 0.0),
                inertia=(m / 3 * (hy * hy + hz * hz), m / 3 * (hx * hx + hz * hz),
                         m / 3 * (hx * hx + hy * hy)))]
    for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        for z, r in ((0.40, 0.03), (0.22, 0.025)):
            out.append(dict(pos=(0.18 * sx, 0.11 * sy, z), shape=CAPSULE,
                            params=(0.0, 0.0, 0.0, 0.0, 0.0, -0.18, r), dynamic=True,
                            articulation=1, **_capsule_down(r, 0.18, 1000.0)))
    return out
'''

REFERENCE_FILES = {
    "__init__.py": '"""A reference that records what the harness gives it and steps the port."""\n',
    "types.py": "from rapier_tpu_torch.types import tree_map  # noqa: F401\n",
    "params.py": '''SEEN = []


def sim_params(config, state, dtype, world_params):
    from rapier_tpu_torch import precision

    precision.set_precision(dtype)
    SEEN.append(world_params)
    return world_params
''',
    "step.py": '''SEEN = []


def step(state, params):
    from rapier_tpu_torch.pipeline.physics_pipeline import step as port_step

    SEEN.append(state)
    return port_step(state, params)
''',
}


def write(root: Path, scenes: int = 4, episode_steps: int = 6, every: int = 2,
          scale: float = 0.5, check=(1, 3, 2), per_layer=(), limit: float = 0.01) -> dict:
    """The directory under `root` and its BENCHMARK dict.  `check`: the
    traffic's check_every, check_captures, check_scenes; `per_layer`: the
    names of the repository's per-layer metrics the cell reports."""
    base = Path(root) / "port_bench"
    for d in ("configs", "traffic", "limits", "metrics", REFERENCE):
        (base / d).mkdir(parents=True, exist_ok=True)
    config = dict(builder="quadruped_world", builder_args=["use_multibody"], use_multibody=True,
                  rad=0.25, max_pairs=128, max_solver_pairs=0, scenes=scenes,
                  reference=REFERENCE)
    traffic = dict(episode_steps=episode_steps, jitter_rad=0.2, precision="f32",
                   check_every=check[0], check_captures=check[1], check_scenes=check[2],
                   trace_steps=3, stage_steps=3, actions=dict(every=every, scale=scale))
    limits = dict.fromkeys(("start_pos_gap_m", "start_shape_gap", "pos_gap_m", "rot_gap",
                            "vel_gap", "impulse_gap", "contact_gap"), limit)
    (base / "configs" / "quadruped.json").write_text(json.dumps(config))
    (base / "configs" / "quadruped.py").write_text(LAYOUT)
    (base / "traffic" / "actions.json").write_text(json.dumps(traffic))
    (base / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    for name, text in REFERENCE_FILES.items():
        (base / REFERENCE / name).write_text(text)
    real = run.load_json(run.ROOT / "BENCHMARK.json")
    e2e = [m for m in real["end_to_end"] if "workloads" not in m]
    layer = [dict(m, workloads=[CELL]) for m in real["per_layer"] if m["name"] in per_layer]
    for m in e2e + layer:
        shutil.copy(run.HERE / "metrics" / f"{m['name']}.py", base / "metrics")
    return dict(paths=["port_bench"], run_seconds=10,
                configs=[dict(name="quadruped", file="port_bench/configs/quadruped.json")],
                workloads=[dict(name=CELL, config="quadruped", traffic="actions", chips=1)],
                end_to_end=e2e, per_layer=layer)


def seen(root: Path):
    """What the recording reference was given: (its params' world params,
    the states it stepped)."""
    ref = run.reference_package(dict(reference=REFERENCE), Path(root) / "port_bench")
    return ref.params.SEEN, ref.step.SEEN
