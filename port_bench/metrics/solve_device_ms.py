"""Device milliseconds a step of the operations launched inside the port's
`solve` span less those inside its `joints` spans, in the recorded phase of
a traced run (`recorded.py`)."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "solve", "device_ms", less="joints")
