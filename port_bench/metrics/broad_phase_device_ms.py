"""Device milliseconds a step of the operations launched inside the port's
`broad_phase` span in the recorded phase of a traced run (`recorded.py`):
each kernel, copy and set put down to the span by its launch's correlation
id."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "broad_phase", "device_ms")
