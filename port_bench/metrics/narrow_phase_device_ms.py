"""Device milliseconds a step of the operations launched inside the port's
`narrow_phase` span less those inside its `gjk_epa` span, in the recorded
phase of a traced run (`recorded.py`)."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "narrow_phase", "device_ms", less="gjk_epa")
