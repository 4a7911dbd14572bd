"""Per-stage step timers on the card (counterpart of
rapier_tpu.utils.counters, the reference's Counters taxonomy,
src/counters/mod.rs:20-35).

`step` marks its stages with `stage(name)` and, below and between them,
spans with `span(name)`.  Outside a measurement either is one Python call
and nothing else.  Three measurement paths turn them on:

1. `profile_step(state, params)` runs whole steps with a
   `torch.cuda.synchronize()` before and after every stage and returns the
   host milliseconds of each (`StageTimings`).  The synchronisations add
   their own cost, so the stages sum to more than an unmeasured step.
2. `trace_step(state, params)` runs steps under `torch.profiler`, recording
   the card's activity only (a host-side record of every op would cost the
   profiler tens of seconds a step on the launch-bound paths), and returns
   the step's wall time, its kernel count, the time the card was busy and
   the kernels of most device time.
3. `recording()` records every `stage` and `span` as it opens and closes,
   on the host's clock and with no synchronisation, with the counters that
   `count` adds and the host-device synchronisations inside each span
   (`Recording`).  Put beside `torch.profiler`, it says which stage
   launched each device operation and where the host kept the card
   waiting.  It works on any device.

`profile_step` and `trace_step` time the card only: a state on another
device raises, so no number from the CPU is ever reported as the card's.
The `stage` markers' names are what `profile_step` and the benchmark's
`*_ms` metrics read, so a stage keeps its extent; the spans record under
`recording()` only and are transparent to `profile_step`.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass, field

import torch

PROFILE_ITERS = 3   # steps `profile_step` averages over
TOP_KERNELS = 8     # kernel names `trace_step` ranks by device time

_timings: dict | None = None      # stage -> summed ms, while profile_step runs
_record: Recording | None = None  # the open `recording()`
# The text of the warning torch.cuda's sync debug mode gives at each
# synchronising operation.
SYNC_WARNING = "called a synchronizing CUDA operation"


class Recording:
    """What `recording()` yields.

    spans: (name, parent index or -1, step index, start ns, end ns) of each
      span in the order they opened, on `time.perf_counter_ns()`'s clock; a
      span opened with `new_step` (the pipeline's `step`) begins a step
      index, and the spans under it share it.
    counts: (span index, name, value) of each `count`, the values read as
      Python ints once the recording has closed.
    syncs: {span index: host-device synchronisations the host made while
      that span was the innermost open one}; -1 for none open (on the card
      only: the CPU has nothing to wait for)."""

    def __init__(self):
        self.spans, self.counts, self.syncs = [], [], {}
        self.step = -1
        self._open = []

    def innermost(self) -> int:
        return self._open[-1] if self._open else -1

    @contextlib.contextmanager
    def span(self, name: str, new_step: bool = False):
        if new_step:
            self.step += 1
        i = len(self.spans)
        self.spans.append((name, self.innermost(), self.step, time.perf_counter_ns(), None))
        self._open.append(i)
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            self._open.pop()
            self.spans[i] = self.spans[i][:4] + (end,)

    def _shower(self, show):
        """A `warnings.showwarning` that counts the sync debug mode's
        warnings against the innermost open span and hands every other
        warning to `show`, once a place."""
        seen = set()

        def shower(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                i = self.innermost()
                self.syncs[i] = self.syncs.get(i, 0) + 1
            elif (str(message), category, filename, lineno) not in seen:
                seen.add((str(message), category, filename, lineno))
                show(message, category, filename, lineno, file, line)

        return shower


@contextlib.contextmanager
def recording():
    """Record every stage and span of the steps run inside, unsynchronised;
    yields the `Recording`.  On the card the sync debug mode is set to
    "warn" inside, and every warning is let through (the default filter
    would show a place once) so that each synchronisation is counted; the
    mode, the filters and `warnings.showwarning` are restored on exit.
    Tensor counters are read when the recording closes: synchronise the
    device before leaving the block, and nothing is left to wait for."""
    global _record
    if _record is not None or _timings is not None:
        raise RuntimeError("recording() runs alone: no other measurement may be open")
    rec = Recording()
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else None
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = rec._shower(warnings.showwarning)
        if mode is not None:
            torch.cuda.set_sync_debug_mode("warn")
        _record = rec
        try:
            yield rec
        finally:
            _record = None
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
    rec.counts = [(i, name, int(v)) for i, name, v in rec.counts]


def is_recording() -> bool:
    return _record is not None


def count(name: str, value):
    """Add `value` (a device scalar or a host int) to counter `name` under
    the innermost open span; nothing outside `recording()`."""
    if _record is not None:
        _record.counts.append((_record.innermost(), name, value))


_NO_SPAN = contextlib.nullcontext()


def span(name: str, new_step: bool = False):
    """Mark a span that `recording()` alone records (a no-op otherwise,
    `profile_step` included).  `new_step`: the span is a whole step."""
    return _NO_SPAN if _record is None else _record.span(name, new_step)


@contextlib.contextmanager
def stage(name: str):
    """Mark one stage of the step: under `profile_step` its host ms between
    synchronisations, under `recording()` a span; a no-op otherwise."""
    if _timings is None and _record is None:
        yield
        return
    if _record is not None:
        with _record.span(name):
            yield
        return
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    _timings[name] = _timings.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


@dataclass
class StageTimings:
    """Milliseconds a step, per stage (the reference's Counters schema);
    `narrow_phase_ms` is the pair lanes' narrow phase without the GJK/EPA
    fallback and `solver_ms` the solve without the impulse joints; `extra`
    holds the GJK/EPA fallback (`gjk_epa`, the generic convex pairs), the
    mesh narrow phase (the (convex, mesh) pairs' triangle lanes), the joints,
    the contact join, wake, CCD motion clamping (`ccd`), sleep and the rest."""

    broad_phase_ms: float = 0.0
    narrow_phase_ms: float = 0.0
    solver_ms: float = 0.0
    total_ms: float = 0.0
    extra: dict = field(default_factory=dict)

    def as_dict(self):
        return {"broad_phase_ms": self.broad_phase_ms,
                "narrow_phase_ms": self.narrow_phase_ms,
                "solver_ms": self.solver_ms, "total_ms": self.total_ms, **self.extra}


def _on_card(state):
    if state.bodies.pos.device.type != "cuda":
        raise ValueError(f"the stage timers measure the card; the state lies on "
                         f"{state.bodies.pos.device}")


def profile_step(state, params, iters: int = PROFILE_ITERS) -> StageTimings:
    """Mean host milliseconds of each stage over `iters` steps from `state`
    (after one unmeasured step), each stage between synchronisations."""
    global _timings
    from rapier_tpu_torch.pipeline.physics_pipeline import step

    _on_card(state)
    step(state, params)
    torch.cuda.synchronize()
    _timings = {}
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(state, params)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3 / iters
        ms = {k: v / iters for k, v in _timings.items()}
    finally:
        _timings = None
    # The joints run inside "solve", the GJK/EPA fallback inside
    # "narrow_phase": each is taken out of the stage around it.
    joints = ms.pop("joints", 0.0)
    gjk_epa = ms.pop("gjk_epa", 0.0)
    extra = {f"{k}_ms": ms.get(k, 0.0)
             for k in ("mesh_narrow_phase", "contact_match", "wake", "ccd", "sleep")}
    extra["joints_ms"] = joints
    extra["gjk_epa_ms"] = gjk_epa
    extra["rest_ms"] = total - sum(ms.values())
    return StageTimings(broad_phase_ms=ms.get("broad_phase", 0.0),
                        narrow_phase_ms=ms.get("narrow_phase", 0.0) - gjk_epa,
                        solver_ms=ms.get("solve", 0.0) - joints, total_ms=total, extra=extra)


def trace_step(state, params, steps: int = 3, warm: bool = True, step_fn=None) -> dict:
    """`steps` steps from `state` under torch.profiler (after one unmeasured
    step unless `warm` is False: the caller has just stepped from `state`).
    `step_fn(state, params)`: the step to trace (default the pipeline's
    `step`; e.g. a controller's update and then the step).
    Returns per step: wall_ms (host clock to a synchronisation),
    kernels (device kernels and copies), device_ms (the time at least one of
    them ran: the union of their intervals), device_share = device_ms /
    wall_ms, and `top`: the TOP_KERNELS names of most device time, each with
    its count and milliseconds a step.  The device entries are None where
    the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rapier_tpu_torch.pipeline.physics_pipeline import step

    step = step_fn or step
    _on_card(state)
    if warm:
        step(state, params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, params)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    # The profiler's raw events (nanoseconds): building its FunctionEvent
    # list costs ~0.1 ms an event, half a minute for a CCD step's ~137,000.
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    if not spans:
        return dict(wall_ms=wall, kernels=0, device_ms=None, device_share=None, top=None)
    busy, end, by_name = 0, None, {}
    for a, b, name in spans:
        busy += max(0, b - (a if end is None else max(a, end)))
        end = b if end is None else max(end, b)
        n, ns = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, ns + (b - a))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    device = busy / 1e6 / steps
    return dict(wall_ms=wall, kernels=len(spans) / steps, device_ms=device,
                device_share=device / wall,
                top=[dict(name=k[:80], count=n / steps, ms=ns / 1e6 / steps)
                     for k, (n, ns) in ranked])
