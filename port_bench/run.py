#!/usr/bin/env python3
"""The benchmark of rapier_tpu_torch on one CUDA card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`<cell>` is a `workloads` entry of BENCHMARK.json; its configuration
(`configs/<config>.json`, with its plain layout `configs/<config>.py`), its
traffic (`traffic/<traffic>.json`), its correctness limits
(`limits/<cell>.json`) and each metric (`metrics/<metric>.py`) are files found
by name.  One run, in a new process:

1. set-up: the configuration's scene built by the port's own builder, its
   free bodies and free-rooted articulations moved in the ground plane from
   the seed (an articulation whole, by its root's offset), replicated to the
   batch on the card; the start checked against the plain layout; then
   `episode_steps` warm-up steps of the loop below, after which every scene
   has reset once and the scenes' ages are spread evenly over an episode;
2. the window: for `--seconds`, an RL user's loop over the whole batch:
   reset the scenes whose episode ended (a masked copy of each scene's own
   start state into every leaf), with the traffic's `actions` write the
   policy's actuator targets every `every` steps, `physics_pipeline.step`,
   synchronise, read the step's overflow counters;  every `check_every`
   steps a sample of scenes (drawn from the seed) is kept before and after
   its step;
3. with `--trace 1`: `trace_steps` more steps of the loop under
   torch.profiler (the card's activity only), then `stage_steps` with the
   port's stage markers on;
4. the check: the program's state freed, the configuration's plain
   reference (the package `reference` names, `reference/` by default)
   steps every kept scene from the program's state before its step, and
   each number compared is printed beside its limit;
5. one JSON line: correct, attempted (env-steps), failed (env-steps of
   scenes that overflowed the broad phase or the solver, met an unsupported
   pair or left a non-finite pose or velocity), metrics, device.

Without a CUDA card the run fails: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

# Few host threads for the CPU libraries (set before they load).
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that no module of a run may have: the JAX package
# and JAX itself (the port's name begins with the JAX package's, so names
# compare whole).
BANNED_MODULES = ("jax", "jaxlib", "flax", "rapier_tpu")
# What makes a scene's env-step fail (StepEvents' counters, and the check
# that every pose and velocity is finite).
FAILURE_KINDS = ("broadphase_overflow", "solver_overflow", "unsupported_pairs", "non_finite")


def _process_age_s() -> float:
    """Seconds since this process started (from /proc: its start tick
    against the uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _card_state():
    """The card's SM clock, power draw and limit, temperature and active
    throttle reasons as nvidia-smi reads them, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED_MODULES))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"port_bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry and the data it runs from, each found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    base = root / bench["paths"][0]
    cfg_entry = cfgs[cell["config"]]
    return dict(config=load_json(root / cfg_entry["file"]),
                layout=load_module((root / cfg_entry["file"]).with_suffix(".py")),
                traffic=load_json(base / "traffic" / f"{cell['traffic']}.json"),
                limits=load_json(base / "limits" / f"{workload}.json"))


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports: its per-layer ones in a traced
    run, else its end-to-end ones."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if "workloads" not in m or workload in m["workloads"]]


# ---------------------------------------------------------------------------
# The scene state as a tree of dataclasses with tensor leaves.
# ---------------------------------------------------------------------------

def zip_map(fn, *trees):
    """`fn` over the matching leaves of states (or their parts) of one
    structure; None slots stay None."""
    first = trees[0]
    if first is None:
        return None
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: zip_map(fn, *(getattr(t, f.name) for t in trees))
                              for f in dataclasses.fields(first)})
    return fn(*trees)


def rows(state, idx):
    """Scenes `idx` of a batched state."""
    return zip_map(lambda x: x[idx], state)


def concat(states):
    import torch

    return zip_map(lambda *xs: torch.cat(xs), *states)


# ---------------------------------------------------------------------------
# Traffic: the seed's jitter, episode offsets and the kept samples.
# ---------------------------------------------------------------------------

def rng(seed: int, stream: int):
    import numpy as np

    return np.random.default_rng([int(seed) % 2**64, stream])


def episode_offsets(seed: int, scenes: int, episode: int):
    """Each scene's clock offset in [0, episode): the same multiset of
    offsets for every seed (`scenes` mod `episode` scenes start one step
    apart), assigned to scenes in the seed's order."""
    return rng(seed, 1).permutation(scenes) % episode


def jitter(seed: int, scenes: int, bodies: int, amplitude: float):
    """Uniform offsets in [-amplitude, amplitude] of each scene's bodies in
    the two ground-plane axes: ``[scenes, bodies, 2]`` float64."""
    return (rng(seed, 2).random((scenes, bodies, 2)) * 2.0 - 1.0) * amplitude


def ground_axes(gravity) -> tuple:
    """The two axes orthogonal to gravity's largest component, in order
    (x and z under -Y gravity, x and y under -Z)."""
    import numpy as np

    up = int(np.argmax(np.abs(np.asarray(gravity, np.float64))))
    return tuple(a for a in range(3) if a != up)


def start_offsets(seed: int, scenes: int, movable, root, amplitude: float):
    """Each scene's start offsets: (the bodies that move, in index order;
    their offsets ``[scenes, moved, 2]`` in `ground_axes`, float64).
    `jitter` draws a column for each movable body; a body takes the column
    of its articulation's root (`root`: the root body of each body, itself
    for a free body), so an articulation moves whole, and it moves where
    its root is movable."""
    import numpy as np

    movable, root = np.asarray(movable, bool), np.asarray(root)
    column = np.cumsum(movable) - 1
    moved = np.flatnonzero(movable[root])
    return moved, jitter(seed, scenes, int(movable.sum()), amplitude)[:, column[root[moved]]]


def check_schedule(seed: int, scenes: int, traffic: dict):
    """The window steps whose scenes are kept for the check (every
    `check_every` steps from a seeded phase, `check_captures` of them) and
    the `check_scenes` scenes kept at each."""
    r = rng(seed, 3)
    every, count = traffic["check_every"], traffic["check_captures"]
    phase = int(r.integers(every))
    steps = [phase + every * i for i in range(count)]
    picks = [r.choice(scenes, size=min(traffic["check_scenes"], scenes), replace=False)
             for _ in steps]
    return dict(zip(steps, picks))


# ---------------------------------------------------------------------------
# Set-up.
# ---------------------------------------------------------------------------

class Actuators:
    """A robot's actuators, resolved once at build time from the builder's
    handles (`MjcfRobotHandles`, kept as `handles`).  `writes`: for each
    target tensor of the articulation table, as `apply_controls` writes it
    (`motor_target_pos` for a position actuator, `motor_target_vel` for a
    motor or velocity one), its actuators' columns (a slice) and their
    (tree, link, axis) slots (index tensors).  `mid`, `half`, `gear`: each
    actuator's control range, the middle and half-range of its joint's
    limits for a position actuator on a limited joint, else 0 and 1, and
    its gear."""

    def __init__(self, handles, world, one, device):
        import math

        import torch

        mb = one.multibodies
        groups = {}
        for a in handles.actuators:
            if a.joint not in handles.joints:
                continue
            if not handles.use_multibody:
                raise ValueError("the harness drives the actuators of multibody joints only")
            tree, link = handles._mb_slot(world, a.joint)
            axis = handles.joint_axis[a.joint]
            lo, hi = float(mb.limit_min[tree, link, axis]), float(mb.limit_max[tree, link, axis])
            limited = a.kind == "position" and math.isfinite(lo) and math.isfinite(hi)
            field = "motor_target_pos" if a.kind == "position" else "motor_target_vel"
            groups.setdefault(field, []).append(
                ((tree, link, axis), ((lo + hi) / 2, (hi - lo) / 2) if limited else (0.0, 1.0),
                 a.gear))
        self.handles, self.writes, ranges, gears = handles, [], [], []
        for field, acts in groups.items():
            slots = zip(*(slot for slot, _, _ in acts))
            self.writes.append((field, slice(len(ranges), len(ranges) + len(acts)),
                                tuple(torch.tensor(x, device=device) for x in slots)))
            ranges += [r for _, r, _ in acts]
            gears += [g for _, _, g in acts]
        dtype = mb.motor_target_pos.dtype
        self.mid = torch.tensor([m for m, _ in ranges], dtype=dtype, device=device)
        self.half = torch.tensor([h for _, h in ranges], dtype=dtype, device=device)
        self.gear = torch.tensor(gears, dtype=dtype, device=device)


class Actions:
    """The policy's actions (a traffic's `"actions": {"every": k, "scale":
    s}`): a draw u ~ U[-1, 1] ``[scenes, actuators]`` from a generator on
    the state's device, seeded from the seed's stream 5, and each
    actuator's target (mid + u s half) gear written into the batch's
    articulation table."""

    def __init__(self, actuators: Actuators, spec: dict, seed: int, scenes: int):
        import torch

        self.every, self.actuators = int(spec["every"]), actuators
        self.width = actuators.half * float(spec["scale"])
        self.shape = (scenes, len(actuators.gear))
        self.generator = torch.Generator(device=actuators.gear.device)
        self.generator.manual_seed(int(rng(seed, 5).integers(2**63)))

    def draw(self):
        import torch

        u = torch.empty(self.shape, dtype=self.width.dtype, device=self.width.device)
        return u.uniform_(-1.0, 1.0, generator=self.generator)

    def targets(self, u):
        import torch

        return torch.addcmul(self.actuators.mid, u, self.width).mul_(self.actuators.gear)

    def __call__(self, state):
        """A new draw's targets, written in place: one indexed write a
        target tensor (the loop's reset has just made every leaf anew)."""
        ctrl = self.targets(self.draw())
        for field, cols, index in self.actuators.writes:
            getattr(state.multibodies, field)[(slice(None),) + index] = ctrl[:, cols]


def articulation_roots(one):
    """Each body's articulation root (its tree's link 0, itself off a tree)
    and whether it moves with the start jitter (a dynamic free body, or a
    link of a tree whose root is free), from a one-scene state."""
    import numpy as np

    from rapier_tpu_torch.types import BodyType

    b = one.bodies
    root = np.arange(b.pos.shape[0])
    movable = (b.body_type == int(BodyType.DYNAMIC)).cpu().numpy() & ~b.mb_link.cpu().numpy()
    mb = one.multibodies
    if mb is not None:
        free = (mb.locked_axes[:, 0] == 0).cpu().numpy()
        for tree, links in enumerate(mb.link_body.cpu().numpy()):
            links = links[links >= 0]
            root[links] = links[0]
            movable[links] = free[tree]
    return movable, root


def build_batch(config: dict, traffic: dict, seed: int, device: str):
    """The configuration's scene from the port's builder, moved in the ground
    plane from the seed (`start_offsets`) and replicated to
    `config["scenes"]` on `device`.  Returns (state, params, the one-scene
    state before the offsets, and where the traffic has `actions` the
    `Actuators` of the handles the builder returns with the world, else
    None)."""
    import torch

    from rapier_tpu_torch import precision, scenes
    from rapier_tpu_torch.types import from_numpy

    precision.set_precision(traffic["precision"])
    built = getattr(scenes, config["builder"])(
        **{k: config[k] for k in config["builder_args"]},
        max_pairs=config["max_pairs"], device=device)
    world, handles = built if isinstance(built, tuple) else (built, None)
    world.params = world.params.replace(max_solver_pairs=config["max_solver_pairs"])
    one = from_numpy(world.build(), device)
    actuators = None
    if "actions" in traffic:
        if not hasattr(handles, "actuators"):
            raise ValueError(f"{config['builder']} returns no robot's handles to act on")
        actuators = Actuators(handles, world, one, device)
    state = scenes.replicate_scene(one, config["scenes"])
    movable, root = articulation_roots(one)
    moved, off = start_offsets(seed, config["scenes"], movable, root,
                               traffic["jitter_rad"] * config["rad"])
    axes = ground_axes(world.params.gravity)
    idx, jit = torch.as_tensor(moved, device=device), torch.as_tensor(off, device=device)
    pos = state.bodies.pos.clone()
    nxt = state.bodies.next_pos.clone()
    for k, axis in enumerate(axes):
        pos[:, idx, axis] += jit[..., k].to(pos.dtype)
        nxt[:, idx, axis] += jit[..., k].to(pos.dtype)
    state = dataclasses.replace(state, bodies=dataclasses.replace(
        state.bodies, pos=pos, next_pos=nxt))
    if one.multibodies is not None:
        # A free root's coordinates carry its world position, so they move
        # with its body (a moved root is a free one: `articulation_roots`).
        col = {int(body): i for i, body in enumerate(moved)}
        roots = one.multibodies.link_body[:, 0].tolist()
        trees = [t for t, r in enumerate(roots) if r in col]
        if trees:
            q = state.multibodies.q.clone()
            cols = [col[roots[t]] for t in trees]
            for k, axis in enumerate(axes):
                q[:, trees, 0, axis] += jit[:, cols, k].to(q.dtype)
            state = dataclasses.replace(state, multibodies=state.multibodies.replace(q=q))
    return state, world.params, one, actuators


def start_readings(state, layout_bodies, seed, config, traffic, idx, gravity):
    """The program's built scenes `idx` (`state`: their rows, before any step) against the plain
    layout with the seed's offsets (`start_offsets` in the ground plane of
    `gravity`: a layout body's `articulation` names its tree's root body,
    and it moves where that root is dynamic).  start_pos_gap_m: the largest gap of a
    body's start position.  start_shape_gap: the largest relative gap of a
    dynamic body's mass or inertia tensor (over its largest principal
    inertia) or of a collider's shape parameters (the layout's rounded to
    float32, as the builders store them at either precision), of a centre
    of mass over the radius, a fixed body's inverse mass; 1 for a collider
    of the wrong shape or parent, or one too many or too few."""
    import numpy as np

    b, c = state.bodies, state.colliders
    n = len(layout_bodies)
    dyn_ids = [i for i, lb in enumerate(layout_bodies) if lb["dynamic"]]
    fixed = [i for i, lb in enumerate(layout_bodies) if not lb["dynamic"]]
    root = [lb.get("articulation", i) for i, lb in enumerate(layout_bodies)]
    movable = [layout_bodies[r]["dynamic"] for r in root]
    moved, jit = start_offsets(seed, config["scenes"], movable, root,
                               traffic["jitter_rad"] * config["rad"])
    want_pos = np.tile(np.array([lb["pos"] for lb in layout_bodies], np.float64),
                       (len(idx), 1, 1))
    for k, axis in enumerate(ground_axes(gravity)):
        want_pos[:, moved, axis] += jit[idx, :, k]
    got = lambda x: x.double().cpu().numpy()     # noqa: E731
    pos_gap = float(np.abs(got(b.pos)[:, :n] - want_pos).max())

    mass = np.array([lb["mass"] for lb in layout_bodies if lb["dynamic"]])
    inertia = np.array([lb["inertia"] for lb in layout_bodies if lb["dynamic"]])
    com = np.array([lb["com"] for lb in layout_bodies if lb["dynamic"]])
    # The inertia tensor in the body's frame, R diag(principal) R^T, from
    # the principal frame the program chose, against the layout's (whose
    # shapes are symmetric about their axes: a diagonal tensor).
    q = got(b.principal_frame)[:, dyn_ids]
    x, y, z, w = (q[..., i] for i in range(4))
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                    2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                    2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                   -1).reshape(q.shape[:-1] + (3, 3))
    tensor = np.einsum("...ij,...j,...kj->...ik", rot,
                       1.0 / got(b.inv_principal_inertia)[:, dyn_ids], rot)
    gaps = [np.abs(got(b.inv_mass)[:, dyn_ids] * mass - 1.0).max(),
            (np.abs(tensor - inertia[:, :, None] * np.eye(3)).max(-1).max(-1)
             / inertia.max(-1)).max(),
            np.abs(got(b.local_com)[:, dyn_ids] - com).max() / config["rad"],
            np.abs(got(b.inv_mass)[:, fixed]).max()]
    parent = c.parent.cpu().numpy()
    stype = c.shape_type.cpu().numpy()
    prm = got(c.shape_params)
    for s in range(len(idx)):
        owned = np.flatnonzero(parent[s] >= 0)
        if len(owned) != n or sorted(parent[s][owned]) != list(range(n)):
            gaps.append(1.0)
        for ci in owned:
            lb = layout_bodies[parent[s][ci]]
            want = np.zeros(prm.shape[-1])
            want[:len(lb["params"])] = np.float32(lb["params"])
            gaps.append(1.0 if stype[s][ci] != lb["shape"] else
                        np.abs(prm[s][ci] - want).max() / np.abs(want).max())
    return dict(start_pos_gap_m=pos_gap, start_shape_gap=float(max(gaps)))


# ---------------------------------------------------------------------------
# The loop.
# ---------------------------------------------------------------------------

class Loop:
    """The RL user's loop over the batch: reset, write the policy's actions
    (every `actions.every` steps, where the traffic has them), step,
    synchronise, read the step's failure counters.  `spans` (when a list)
    receives (label, start ns, end ns) of each part on the host's monotonic
    clock."""

    def __init__(self, state, params, offsets, episode, step_fn, actions=None):
        import torch

        self.state, self.init, self.params = state, state, params
        self.offsets = torch.as_tensor(offsets, device=state.bodies.pos.device)
        self.episode, self.step_fn, self.t = episode, step_fn, 0
        self.actions = actions
        self.spans = None
        self.failures = dict.fromkeys(FAILURE_KINDS, 0)

    @contextlib.contextmanager
    def _span(self, label):
        if self.spans is None:
            yield
            return
        t0 = time.perf_counter_ns()
        yield
        self.spans.append((label, t0, time.perf_counter_ns()))

    def reset(self):
        import torch

        mask = (self.offsets + self.t) % self.episode == 0

        def where(x0, x):
            return torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x0, x)

        self.state = zip_map(where, self.init, self.state)

    def __call__(self, keep=None):
        """One iteration; returns the failed scenes of this step, and with
        `keep` (scene indices) the kept (before, after) rows."""
        import torch

        with self._span("reset"):
            self.reset()
        if self.actions is not None and self.t % self.actions.every == 0:
            with self._span("actions"):
                self.actions(self.state)
        before = rows(self.state, keep) if keep is not None else None
        with self._span("step"):
            new, events = self.step_fn(self.state, self.params)
        with self._span("sync"):
            torch.cuda.synchronize() if new.bodies.pos.is_cuda else None
        with self._span("events"):
            b = new.bodies
            finite = torch.ones_like(events.broadphase_overflow, dtype=torch.bool)
            for x in (b.pos, b.rot, b.linvel, b.angvel):
                finite &= torch.isfinite(x).flatten(1).all(dim=1)
            kinds = torch.stack([events.broadphase_overflow > 0, events.solver_overflow > 0,
                                 events.unsupported_pairs > 0, ~finite])
            counts = torch.cat([kinds.any(0).sum().view(1), kinds.sum(1)]).tolist()
            failed = counts[0]
            for k, c in zip(FAILURE_KINDS, counts[1:]):
                self.failures[k] += c
        self.last = (new, events)
        self.state = new
        self.t += 1
        return failed, (None if keep is None else (before, rows(new, keep)))


# ---------------------------------------------------------------------------
# The traced steps.
# ---------------------------------------------------------------------------

def traced_steps(loop, steps: int) -> dict:
    """`steps` iterations under torch.profiler recording the card only:
    the device's events (name, start, end ns), the host's spans on the same
    clock where it can be matched, the window's host seconds and each
    step's output state (for the work counts)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    outputs = []
    loop.spans = []
    mono0, real0 = time.perf_counter_ns(), time.time_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loop()
            outputs.append(loop.last[0])
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    spans, loop.spans = loop.spans, None
    events = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    # The profiler's clock: the monotonic one or the wall clock; the host
    # spans move to whichever holds the device's first event.
    shift = None
    if events:
        lo, hi = spans[0][1] - 10**9, spans[-1][2] + 10**9
        for cand in (0, real0 - mono0):
            if lo + cand <= events[0][0] <= hi + cand:
                shift = cand
                break
    host = None if shift is None else [(lab, a + shift, b + shift) for lab, a, b in spans]
    return dict(events=events, spans=host, window_s=window, steps=steps, outputs=outputs)


def busy_ns(events) -> int:
    """The union of the events' intervals (trace_step's arithmetic)."""
    busy, end = 0, None
    for a, b, _ in events:
        busy += max(0, b - (a if end is None else max(a, end)))
        end = b if end is None else max(end, b)
    return busy


def breakdown(trace: dict) -> dict:
    """The device operations of most time, and the device's idle time by
    what the host was doing (the benchmark's spans around its calls)."""
    by_name = {}
    for a, b, name in trace["events"]:
        by_name[name[:80]] = by_name.get(name[:80], 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = {}, None
    spans = trace["spans"]
    for a, b, _ in trace["events"]:
        if end is not None and a > end:
            mid = (a + end) // 2
            label = "unmatched clock" if spans is None else next(
                (lab for lab, s0, s1 in spans if s0 <= mid <= s1), "between spans")
            gaps[label] = gaps.get(label, 0) + (a - end)
        end = b if end is None else max(end, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k, v / 1e9] for k, v in ops],
                idle_gaps=[[k, v / 1e9] for k, v in idle])


def staged_steps(loop, steps: int) -> dict:
    """Milliseconds a step of each of the port's stages over `steps`
    iterations, the stage markers on (they synchronise around each stage:
    profile_step's accumulation)."""
    from rapier_tpu_torch.utils import counters

    counters._timings = {}
    try:
        for _ in range(steps):
            loop()
        ms = {k: v / steps for k, v in counters._timings.items()}
    finally:
        counters._timings = None
    return ms


# ---------------------------------------------------------------------------
# The check.
# ---------------------------------------------------------------------------

def reference_package(config: dict, base: Path = HERE):
    """The configuration's plain reference: the package under the
    benchmark's directory `base` that its `reference` key names
    (`reference/` where it has none), as the package's three modules:
    `step` (`step(state, params)` -> (new state, events)), `types`
    (`tree_map(fn, state)`: a state of the program as the package's own,
    with every optional part its types carry) and `params`
    (`sim_params(config, state, dtype, world_params)`: its SimParams)."""
    import importlib
    import types
    import zlib

    name = config.get("reference", "reference")
    base = Path(base).resolve()
    if base == HERE:
        pkg = f"port_bench.{name}"
    else:
        # A benchmark directory elsewhere (a test's): its package by path.
        pkg = f"port_bench_{zlib.crc32(str(base).encode()):08x}_{name}"
        if pkg not in sys.modules:
            spec = importlib.util.spec_from_file_location(
                pkg, base / name / "__init__.py", submodule_search_locations=[str(base / name)])
            sys.modules[pkg] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(sys.modules[pkg])
    return types.SimpleNamespace(**{m: importlib.import_module(f"{pkg}.{m}")
                                    for m in ("step", "types", "params")})


def to_reference(state, ref=None):
    """The kept rows as the reference's own state type (fields read by
    name)."""
    return (ref or reference_package({})).types.tree_map(lambda x: x, state)


def reference_params(config: dict, state, dtype: str, world_params=None, base: Path = HERE):
    """The reference's SimParams at `dtype` for the reference's `state`, from
    the configuration and the world's own params (the package's
    `sim_params`)."""
    return reference_package(config, base).params.sim_params(config, state, dtype, world_params)


def gaps(got, want) -> dict:
    """Each number compared, `got` against the reference's `want` (both
    states after one step from the same state):
    pos_gap_m / rot_gap / vel_gap: the largest gap of a body's position,
      orientation (quaternion components, sign aligned), linear or angular
      velocity;
    impulse_gap: the largest gap of a contact's normal, tangent or twist
      impulse, over the reference's largest normal impulse;
    contact_gap: the largest gap (m) of an active contact point's position
      or depth, or of a normal; a lane whose pair, touching flag or active
      points differ counts 1."""
    import torch

    gb, wb = got.bodies, want.bodies
    dq = torch.minimum((gb.rot - wb.rot).abs().amax(-1), (gb.rot + wb.rot).abs().amax(-1))
    gc_, wc = got.contacts, want.contacts
    same = ((gc_.pair_key == wc.pair_key) & (gc_.touching == wc.touching)
            & (gc_.point_active == wc.point_active).all(1))
    act = wc.point_active & same.unsqueeze(1)
    point = torch.where(act.unsqueeze(2), (gc_.point - wc.point).abs(), 0.0).amax((1, 2))
    dist = torch.where(act, (gc_.dist - wc.dist).abs(), 0.0).amax(1)
    normal = torch.where((same & wc.touching).unsqueeze(1),
                         (gc_.normal - wc.normal).abs(), 0.0).amax(1)
    contact = torch.maximum(torch.maximum(point, dist), normal)
    contact = torch.where(same, contact, torch.ones_like(contact))
    scale = wc.impulse.abs().amax().clamp(min=1e-30)
    imp = torch.where(same.unsqueeze(1), (gc_.impulse - wc.impulse).abs(), 0.0).amax()
    tan = torch.where(same.unsqueeze(1),
                      (gc_.tangent_impulse - wc.tangent_impulse).abs(), 0.0).amax()
    tw = torch.where(same, (gc_.warmstart_twist_impulse - wc.warmstart_twist_impulse).abs(),
                     0.0).amax()
    f = lambda x: float(x.double())          # noqa: E731
    return dict(pos_gap_m=f((gb.pos - wb.pos).abs().amax()),
                rot_gap=f(dq.amax()),
                vel_gap=f(torch.maximum((gb.linvel - wb.linvel).abs().amax(),
                                        (gb.angvel - wb.angvel).abs().amax())),
                impulse_gap=f(torch.stack([imp, tan, tw]).amax() / scale),
                contact_gap=f(contact.amax()))


def lower_precision(state, dtype):
    """The state with every floating leaf held at `dtype` ("bf16": stored in
    bfloat16, computed in float32; "f32": float32)."""
    import torch

    def cast(x):
        if not x.is_floating_point():
            return x
        if dtype == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        return x.float()

    return zip_map(cast, state)


def reference_step(config, before, dtype, world_params=None, base: Path = HERE):
    """The configuration's reference stepped once from the program's
    `before` at `dtype`."""
    ref = reference_package(config, base)
    ref_state = to_reference(before, ref)
    return ref.step.step(ref_state, ref.params.sim_params(config, ref_state, dtype,
                                                          world_params))[0]


def control_readings(config, before, want, precision: str, world_params=None,
                     base: Path = HERE) -> dict:
    """The control: the reference put in the program's place one precision
    below the configuration's (f64 cells: float32; float32 cells: the state
    held in bfloat16, the step computed in float32, its results stored in
    bfloat16; and, for the record, float32 with TF32 on)."""
    import torch

    out = {}
    if precision == "f64":
        got = reference_step(config, lower_precision(before, "f32"), "f32", world_params,
                             base)
        out["f32"] = gaps(zip_map(lambda x: x.double() if x.is_floating_point() else x, got),
                          want)
    else:
        got = reference_step(config, lower_precision(before, "bf16"), "f32", world_params,
                             base)
        out["bf16"] = gaps(lower_precision(got, "bf16"), want)
        if before.bodies.pos.is_cuda:
            prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                out["tf32"] = gaps(reference_step(config, before, "f32", world_params, base),
                                   want)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out


def check(config, traffic, kept, control=False, world_params=None, base: Path = HERE) -> dict:
    """The program's kept steps against the reference's steps from the same
    states (and, with `control`, the control's)."""
    before = concat([k[0] for k in kept])
    after = concat([k[1] for k in kept])
    want = reference_step(config, before, traffic["precision"], world_params, base)
    out = dict(program=gaps(after, want), samples=int(before.bodies.pos.shape[0]))
    if control:
        out["control"] = control_readings(config, before, want, traffic["precision"],
                                          world_params, base)
    return out


# ---------------------------------------------------------------------------
# One run.
# ---------------------------------------------------------------------------

def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None, step_fn=None,
             control: bool = False, root: Path = ROOT) -> dict:
    """One run of `workload`; returns the result line's fields (and, with
    `control`, the check's readings of the program and the control).
    `overrides` replaces configuration and traffic values (the tests' small
    sizes); `step_fn` replaces the port's step (the tests' faults)."""
    import torch

    from rapier_tpu_torch.pipeline.physics_pipeline import step as port_step

    files = cell_files(bench, workload, root)
    config, traffic = dict(files["config"]), dict(files["traffic"])
    for k, v in (overrides or {}).items():
        (config if k in config else traffic)[k] = v
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.startswith("cuda")

    state, params, _, robot = build_batch(config, traffic, seed, device)
    scenes, episode = config["scenes"], traffic["episode_steps"]
    actions = None if robot is None else Actions(robot, traffic["actions"], seed, scenes)
    layout = files["layout"].layout(**{k: config[k] for k in config["builder_args"]})
    start_idx = rng(seed, 4).choice(scenes, size=min(traffic["check_scenes"], scenes),
                                    replace=False)
    readings = start_readings(rows(state, start_idx), layout, seed, config, traffic,
                              start_idx, params.gravity)
    low = "f32" if traffic["precision"] == "f64" else "bf16"
    start_control = start_readings(lower_precision(rows(state, start_idx), low), layout, seed,
                                   config, traffic, start_idx,
                                   params.gravity) if control else None

    loop = Loop(state, params, episode_offsets(seed, scenes, episode), episode,
                step_fn or port_step, actions)
    # The last warm-up step keeps scenes as the window's checked steps do,
    # so that the window launches no kernel for the first time.
    for i in range(episode):
        loop(start_idx if i == episode - 1 else None)
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    # Set-up's objects leave the collector's generations, so that the
    # window's collections do not walk them.
    gc.collect()
    gc.freeze()
    setup_s = _process_age_s()

    schedule = check_schedule(seed, scenes, traffic)
    loop.failures = dict.fromkeys(FAILURE_KINDS, 0)
    kept, step_s, failed, n = [], [], 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        f, k = loop(schedule.get(n))
        step_s.append(time.perf_counter() - ts)
        failed += f
        if k is not None:
            kept.append(k)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    card_state = _card_state() if on_card else None
    sleeping = int(loop.state.bodies.sleeping.sum())

    record = dict(scenes=scenes, steps=n, window_s=window_s, step_s=step_s, setup_s=setup_s,
                  window_peak_bytes=window_peak, params=params, actions=actions)
    if trace:
        if not on_card:
            raise RuntimeError("a traced run records the card")
        record["trace"] = traced_steps(loop, traffic["trace_steps"])
        record["stages"] = staged_steps(loop, traffic["stage_steps"])
        record["breakdown"] = breakdown(record["trace"])

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = load_module(root / bench["paths"][0] / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    out = dict(correct=False, attempted=n * scenes, failed=failed, metrics=metrics,
               device=dict(platform="gpu" if on_card else "cpu",
                           kind=torch.cuda.get_device_name() if on_card else "cpu",
                           count=1,
                           memory_peak_bytes=int(max(setup_peak, window_peak)) if on_card else 0))
    out["failures"] = dict(loop.failures)
    ms = sorted(s * 1e3 for s in step_s)
    out["window"] = dict(steps=n, seconds=window_s, setup_s=setup_s, step_ms_min=ms[0],
                         step_ms_median=ms[len(ms) // 2], step_ms_max=ms[-1], card=card_state,
                         sleeping_bodies_at_close=sleeping)
    if trace:
        out["device"]["busy_s"] = busy_ns(record["trace"]["events"]) / 1e9
        out["device"]["window_s"] = record["trace"]["window_s"]
        out["breakdown"] = record["breakdown"]
    del record

    # The check, with the program's state freed.
    loop.state = loop.init = loop.last = state = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = dict(readings)
    found = dict(samples=0)
    if kept:
        found = check(config, traffic, kept, control=control, world_params=params,
                      base=root / bench["paths"][0])
        numbers.update(found["program"])
        if control:
            found["control"][low].update(start_control)
    checks = {k: dict(value=numbers.get(k), limit=v) for k, v in files["limits"].items()}
    out["correct"] = bool(kept) and all(c["value"] is not None and c["value"] <= c["limit"]
                                        for c in checks.values())
    return out, checks, found


def require_card(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"port_bench: the cell needs {chips} CUDA card(s); this machine "
                         f"has {have}\n")
        raise SystemExit(2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        sys.stderr.write(f"port_bench: no workload {args.workload!r}\n")
        return 2
    require_card(cells[args.workload]["chips"])
    # One host thread: the step's host work is one launching thread.
    import torch

    torch.set_num_threads(1)
    out, checks, found = run_cell(bench, args.workload, args.seed, args.seconds,
                                  bool(args.trace))
    loaded = banned_modules()
    if loaded:
        sys.stderr.write(f"port_bench: modules loaded that the run may not load: {loaded}\n")
        return 3
    sys.stderr.write(f"check samples {found['samples']} (scene-steps compared; at least 1)\n")
    for name, c in checks.items():
        sys.stderr.write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    out["checks"] = checks
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
