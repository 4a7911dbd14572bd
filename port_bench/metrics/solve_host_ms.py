"""Host milliseconds a step of the port's `solve` span less its `joints` spans
in the recorded phase of a traced run (`recorded.py`), unsynchronised."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "solve", "host_ms", less="joints")
