#!/usr/bin/env python3
"""The recorded phase of a traced run: loop steps under torch.profiler
(the card's activity, and the host's CUDA runtime calls that it records)
with the port's `counters.recording()` on.  Each device operation is put
down, by its launch's correlation id, to the innermost program span whose
host time holds the launch, or outside the program to the loop's span
(`reset`, `events`).  The `*_host_ms`, `*_device_ms`, `syncs_per_step` and
`*_useful_pct` metrics read it.

A metric's reader calls `phase(run)`: the first call steps the program
from the traced phase's last output state (`trace_steps` loop steps in
which no episode ends, so the resets copy nothing but launch what the
window's do), after `run.py`'s own traced and stage phases, which it leaves
as they are.  A program without the recorder gives None, and so does every
reader.

The phase is kept in `run["recorded"]`: `events` (each device operation's
start ns, end ns, name and correlation id), `launches` (correlation id to
the host start ns of the CUDA runtime call that launched it), `program`
(the program's spans: name, parent index, step index, start and end ns,
moved to the profiler's clock as the loop's spans are), `spans` (the
loop's), `counts` (span index, counter, value), `syncs` (span index to
host-device synchronisations), `window_s`, `steps`, and what `analyse`
makes of them: `stages` (each span path's, and each loop label's, host ms,
device ms, launches and syncs a step; a path counts what its spans and
those under them hold), `names` (the same by span name, what the metrics
read), `idle_gaps` (the card's idle time by the innermost span path holding
each gap), `placed` and `unplaced` (device operations put down to a span,
and not) and `counters` (each counter's sum).  The result line of `run.py`
does not carry `stages`; the command below prints it.

    python3 port_bench/recorded.py --workload <cell> --seed <n> --seconds <s>

runs a cell's set-up and an untraced window as `run.py` does, its traced
phase (`run.traced_steps`, with `run.breakdown`'s labels), then the
recorded phase on the same loop, and prints one JSON line: the `stages`
table, the idle gaps by span path beside `run.breakdown`'s, the share of
device operations placed, the recorder's cost (the phase's host ms a step
against the window's median step) and whether a recorded step equals an
unrecorded one bit for bit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from port_bench import run as bench_run  # noqa: E402

# Host events of the CUDA activity that launch device work: the CUDA API's
# calls (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel).
LAUNCH_PREFIX = "cu"
# The label of a gap or an operation that no span holds.
NO_SPAN = "between spans"


# ---------------------------------------------------------------------------
# Recording.
# ---------------------------------------------------------------------------

def record(loop, steps: int) -> dict | None:
    """`steps` iterations of `loop` under torch.profiler with the port's
    recorder on.  Returns the phase (profiler clock, ns):
    events: (start, end, name, correlation id) of each device operation;
    launches: {correlation id: host start} of each runtime call;
    program: the program's spans (name, parent, step, start, end);
    spans: the loop's (label, start, end); counts, syncs: the recorder's;
    window_s and steps.  None where the program has no recorder."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rapier_tpu_torch.utils import counters

    if not hasattr(counters, "recording"):
        return None
    torch.cuda.synchronize()
    loop.spans = []
    mono0, real0 = time.perf_counter_ns(), time.time_ns()
    # The profiler inside the recorder: the counters, read as the recorder
    # closes, copy to the host outside the profiled window.
    with counters.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                loop()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
    spans, loop.spans = loop.spans, None
    events, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            events.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        elif e.name().startswith(LAUNCH_PREFIX):
            launches[e.correlation_id()] = e.start_ns()
    events.sort()
    # The profiler's clock is the monotonic one or the wall clock
    # (run.traced_steps' test): the host's spans move to the one holding
    # the first device event.
    shift = 0
    if events:
        lo, hi = spans[0][1] - 10**9, spans[-1][2] + 10**9
        shift = next((c for c in (0, real0 - mono0) if lo + c <= events[0][0] <= hi + c), None)
    if shift is None:
        return None
    return dict(events=events, launches=launches,
                program=[(n, p, s, a + shift, b + shift) for n, p, s, a, b in rec.spans],
                spans=[(lab, a + shift, b + shift) for lab, a, b in spans],
                counts=rec.counts, syncs=rec.syncs, window_s=window, steps=steps)


def phase(run: dict) -> dict | None:
    """The recorded phase of a traced run's record, stepped once and kept
    in it (`run["recorded"]`) with its `analyse`; None where the run traced
    nothing or the program has no recorder."""
    if "recorded" not in run:
        run["recorded"] = None
        tr = run.get("trace")
        if tr and tr["outputs"]:
            from rapier_tpu_torch.pipeline.physics_pipeline import step

            state = tr["outputs"][-1]
            # No episode ends inside the phase: offset 1, an episode longer
            # than it.
            loop = bench_run.Loop(state, run["params"], [1] * run["scenes"],
                                  tr["steps"] + 2, step, run.get("actions"))
            rec = record(loop, tr["steps"])
            if rec is not None:
                rec.update(analyse(rec))
            run["recorded"] = rec
    return run["recorded"]


# ---------------------------------------------------------------------------
# Analysis.
# ---------------------------------------------------------------------------

def innermost(intervals, times) -> list:
    """For each time, the index of the innermost of the nested `intervals`
    ((start, end) pairs) that holds it, or -1."""
    marks = [(a, 0, i) for i, (a, _) in enumerate(intervals)]
    marks += [(b, 2, i) for i, (_, b) in enumerate(intervals)]
    marks += [(t, 1, j) for j, t in enumerate(times)]
    marks.sort()
    out, open_ = [-1] * len(times), []
    for _, kind, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        else:
            out[i] = open_[-1] if open_ else -1
    return out


def _paths(program) -> list:
    """Each program span's path of names from the root ("step/solve")."""
    paths = []
    for name, parent, *_ in program:
        paths.append(name if parent < 0 else f"{paths[parent]}/{name}")
    return paths


def analyse(rec: dict) -> dict:
    """The phase's tables.  Each device operation goes to the innermost
    program span holding its launch's host time, else to the loop's span
    holding it, else to `NO_SPAN` (as does one whose launch is missing).

    stages: {span path or loop label: host_ms, device_ms, launches, syncs
      a step}, each program path counting what it and the spans under it
      hold; the loop's labels count what the program's spans do not hold
      (their host ms the loop span's whole);
    names: the same for every program span of one name wherever it lies
      (the stage markers' sums);
    idle_gaps: [label, seconds] of the card's idle time by the innermost
      span path holding each gap's middle (a gap inside the loop's `step`
      and outside every program span: `step`), most first;
    placed, unplaced: device operations put down to a span, and not;
    counters: each counter's sum over the phase."""
    steps, program, loop_spans = rec["steps"], rec["program"], rec["spans"]
    paths = _paths(program)
    chains = []                       # each span's own index and its ancestors'
    for i, (_, parent, *_rest) in enumerate(program):
        chains.append([i] + (chains[parent] if parent >= 0 else []))
    prog_iv = [(s[3], s[4]) for s in program]
    loop_iv = [(s[1], s[2]) for s in loop_spans]

    def holders(times):
        """Each time's innermost program span (its index), else its loop
        span (its label), else None."""
        return [p if p >= 0 else (loop_spans[q][0] if q >= 0 else None)
                for p, q in zip(innermost(prog_iv, times), innermost(loop_iv, times))]

    events = rec["events"]
    launch = [rec["launches"].get(c) for *_, c in events]
    known = [j for j, t in enumerate(launch) if t is not None]
    where = [None] * len(events)
    for j, w in zip(known, holders([launch[j] for j in known])):
        where[j] = w

    def row():
        return dict(host_ms=0.0, device_ms=0.0, launches=0, syncs=0)

    stages, names = {}, {}
    for i, (name, _, _, a, b) in enumerate(program):
        stages.setdefault(paths[i], row())["host_ms"] += (b - a) / 1e6
        names.setdefault(name, row())["host_ms"] += (b - a) / 1e6
    for lab, a, b in loop_spans:
        if lab != "step":
            stages.setdefault(lab, row())["host_ms"] += (b - a) / 1e6

    held = {}

    def rows_of(w):
        """The rows an operation or a synchronisation at `w` counts in."""
        if w not in held:
            if isinstance(w, int):
                held[w] = ([stages[p] for p in {paths[k] for k in chains[w]}]
                           + [names[n] for n in {program[k][0] for k in chains[w]}])
            else:
                held[w] = [stages.setdefault(w if w is not None else NO_SPAN, row())]
        return held[w]

    for (a, b, *_), w in zip(events, where):
        for r in rows_of(w):
            r["device_ms"] += (b - a) / 1e6
            r["launches"] += 1
    for w, n in rec["syncs"].items():
        if w >= 0:
            for r in rows_of(w):
                r["syncs"] += n
    for table in (stages, names):
        for r in table.values():
            for k in r:
                r[k] /= steps

    gaps, end, mids = {}, None, []
    for a, b, *_ in events:
        if end is not None and a > end:
            mids.append(((a + end) // 2, a - end))
        end = b if end is None else max(end, b)
    for (_, ns), w in zip(mids, holders([m for m, _ in mids])):
        label = paths[w] if isinstance(w, int) else (w or NO_SPAN)
        gaps[label] = gaps.get(label, 0) + ns
    totals = {}
    for _, name, v in rec["counts"]:
        totals[name] = totals.get(name, 0) + v
    placed = sum(w is not None for w in where)
    return dict(stages=stages, names=names,
                idle_gaps=[[k, v / 1e9] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])],
                placed=placed, unplaced=len(events) - placed, counters=totals)


# ---------------------------------------------------------------------------
# What the metrics read.
# ---------------------------------------------------------------------------

def stage_value(run: dict, name: str, key: str, less: str | None = None):
    """`key` ("host_ms", "device_ms", "launches" or "syncs") a step of the
    program spans named `name`, less those named `less` (the stage markers'
    exclusions); None where the phase did not run or no span has the name."""
    rec = phase(run)
    if rec is None or name not in rec["names"]:
        return None
    sub = rec["names"].get(less, {}).get(key, 0.0) if less else 0.0
    return rec["names"][name][key] - sub


def useful_pct(run: dict, *kinds: str):
    """100 x the `<kind>_useful` counters' sum over the `<kind>_attempted`
    counters' sum; None where nothing was attempted."""
    rec = phase(run)
    if rec is None:
        return None
    c = rec["counters"]
    attempted = sum(c.get(f"{k}_attempted", 0) for k in kinds)
    if not attempted:
        return None
    return 100.0 * sum(c.get(f"{k}_useful", 0) for k in kinds) / attempted


# ---------------------------------------------------------------------------
# The operator's command.
# ---------------------------------------------------------------------------

def same_step(state, params) -> bool:
    """A step from `state` with the recorder on equals one with it off,
    every leaf of the state and the events, bit for bit."""
    import dataclasses

    import torch

    from rapier_tpu_torch.pipeline.physics_pipeline import step
    from rapier_tpu_torch.utils import counters

    def leaves(x):
        if dataclasses.is_dataclass(x):
            return [v for f in dataclasses.fields(x) for v in leaves(getattr(x, f.name))]
        if isinstance(x, tuple):
            return [v for f in x for v in leaves(f)]
        return [x] if isinstance(x, torch.Tensor) else []

    def bits(x):
        return x.contiguous().reshape(-1).view(torch.uint8) if x.is_floating_point() else x

    off = leaves(step(state, params))
    with counters.recording():
        on = leaves(step(state, params))
        torch.cuda.synchronize()
    return len(on) == len(off) and all(
        a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(bits(a), bits(b)))
        for a, b in zip(on, off))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from rapier_tpu_torch.pipeline.physics_pipeline import step

    torch.set_num_threads(1)
    bench = bench_run.load_json(bench_run.ROOT / "BENCHMARK.json")
    files = bench_run.cell_files(bench, args.workload)
    config, traffic = files["config"], files["traffic"]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    state, params, _, robot = bench_run.build_batch(config, traffic, args.seed, "cuda")
    scenes, episode = config["scenes"], traffic["episode_steps"]
    actions = (None if robot is None
               else bench_run.Actions(robot, traffic["actions"], args.seed, scenes))
    loop = bench_run.Loop(state, params, bench_run.episode_offsets(args.seed, scenes, episode),
                          episode, step, actions)
    for _ in range(episode):
        loop()
    torch.cuda.synchronize()
    step_s, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        ts = time.perf_counter()
        loop()
        step_s.append(time.perf_counter() - ts)
    steps = traffic["trace_steps"]
    traced = bench_run.traced_steps(loop, steps)
    old = bench_run.breakdown(traced)
    del traced
    rec = record(loop, steps)
    rec.update(analyse(rec))
    median_ms = statistics.median(step_s) * 1e3
    out = dict(workload=args.workload, seed=args.seed,
               card=[torch.cuda.get_device_name(), bench_run._card_state()],
               window_steps=len(step_s), window_step_ms_median=median_ms,
               recorded_step_ms=rec["window_s"] * 1e3 / steps,
               recorded_over_median=rec["window_s"] * 1e3 / steps / median_ms,
               placed=rec["placed"], unplaced=rec["unplaced"],
               spans_per_step=len(rec["program"]) / steps,
               stages=rec["stages"], counters=rec["counters"],
               idle_gaps=rec["idle_gaps"], idle_gaps_by_loop_span=old["idle_gaps"],
               recorded_equals_unrecorded=same_step(loop.state, params))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
