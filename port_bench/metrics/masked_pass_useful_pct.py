"""The masked solve's useful share of its pass lanes in the recorded phase of
a traced run (`recorded.py`): 100 x the valid lanes over every lane times the
batch's color count, each over every sweep, from the port's counters;
nothing where no step took the masked solve."""

from port_bench import recorded


def read(run):
    return recorded.useful_pct(run, "masked")
