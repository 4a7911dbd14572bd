"""Host milliseconds a step of the port's `narrow_phase` span less its
`gjk_epa` span in the recorded phase of a traced run (`recorded.py`),
unsynchronised."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "narrow_phase", "host_ms", less="gjk_epa")
