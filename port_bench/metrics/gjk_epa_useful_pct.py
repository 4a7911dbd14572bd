"""GJK/EPA's useful share of its lane-iterations in the recorded phase of a
traced run (`recorded.py`): 100 x the lanes still active at each GJK and
EPA iteration over every lane at every iteration (the fixed GJK_ITERS and
EPA_ITERS), from the port's counters; nothing where no step ran it."""

from port_bench import recorded


def read(run):
    return recorded.useful_pct(run, "gjk", "epa")
