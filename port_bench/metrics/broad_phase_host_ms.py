"""Host milliseconds a step of the port's `broad_phase` span in the recorded
phase of a traced run (`recorded.py`): unsynchronised, so the host's launch
time and its waits inside the stage, not the device's."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "broad_phase", "host_ms")
