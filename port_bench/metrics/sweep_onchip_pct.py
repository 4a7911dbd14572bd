"""The contact-sweep kernel's share of its lanes kept on chip, in the
recorded phase of a traced run (`recorded.py`): 100 x the valid lanes of
scenes whose valid lanes all fit the kernel's shared memory over every
valid lane it solved, from the port's `sweep_onchip` and `sweep_lanes`
counters; nothing where no step took the kernel route or the program does
not count them."""

from port_bench import recorded


def read(run):
    rec = recorded.phase(run)
    if rec is None:
        return None
    c = rec["counters"]
    lanes = c.get("sweep_lanes", 0)
    if not lanes:
        return None
    return 100.0 * c.get("sweep_onchip", 0) / lanes
