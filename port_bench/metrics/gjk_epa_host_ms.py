"""Host milliseconds a step of the port's `gjk_epa` span (the generic convex
pairs' GJK/EPA) in the recorded phase of a traced run (`recorded.py`),
unsynchronised; nothing where no step ran it."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "gjk_epa", "host_ms")
