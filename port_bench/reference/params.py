"""The reference's SimParams for a configuration (the benchmark's own, as
`counters.py` and `masses.py` are): its defaults at `dtype`, the
configuration's solver cap, and the shape census worked out from the
state's colliders.  Every field of the world's own params that these share
is the same, but for the f64 configurations' gravity, which the world holds
in float32 and this in float64 (`tests/test_pb_reference.py`)."""

from collections import Counter

from . import precision, types


def sim_params(config: dict, state, dtype: str, world_params=None):
    """`world_params` (the program's world's) is not read: the
    configurations of this reference step under its defaults."""
    precision.set_precision(dtype)
    c = state.colliders
    census = Counter(int(t) for t, p in zip(c.shape_type[0].tolist(), c.parent[0].tolist())
                     if p >= 0)
    return types.SimParams(max_solver_pairs=config["max_solver_pairs"],
                           shape_types_present=tuple(sorted(census.items())))
