"""The 95th percentile (nearest rank) of every window step's host time:
reset, step, synchronise and the read-back of the failure counters."""

import math


def read(run):
    times = sorted(run["step_s"])
    return times[max(0, math.ceil(0.95 * len(times)) - 1)] * 1e3
