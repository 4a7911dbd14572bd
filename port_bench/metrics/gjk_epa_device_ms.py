"""Device milliseconds a step of the operations launched inside the port's
`gjk_epa` span in the recorded phase of a traced run (`recorded.py`);
nothing where no step ran it."""

from port_bench import recorded


def read(run):
    return recorded.stage_value(run, "gjk_epa", "device_ms")
