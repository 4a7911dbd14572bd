"""The card's idle share of the traced steps: 100 x (1 - the union of its
kernel and copy intervals over the traced window's host seconds), the
arithmetic of rapier_tpu_torch.utils.counters.trace_step."""

from port_bench.run import busy_ns


def read(run):
    tr = run.get("trace")
    if not tr or not tr["events"]:
        return None
    return 100.0 * (1.0 - busy_ns(tr["events"]) / 1e9 / tr["window_s"])
