"""The floating-point precision axis (counterpart of `rapier_tpu.precision`;
upstream's f32/f64 feature builds and the rapier3d-f64 crates).

The engine defaults to float32.  The f64 axis is for precision-critical
scenes, such as a stack built 1e5 units from the origin (upstream's
s2d_far_pyramid.rs): call `set_precision("f64")` BEFORE building a world.
It flips the dtype of every state constructor (`types.empty_*`), of
`SimParams`' defaults and of the world builders; as in the reference, one
precision a process, set before the world is built.

Nothing else reads it: the step and every other function take their dtype
from the state's tensors, so a float32 world built before the switch keeps
stepping at float32.  An f64 scene takes the contact-sweep kernel's float64
build where a float32 scene of its shapes takes the kernel
(`pipeline.physics_pipeline.solve_path`); the reference's Mosaic kernels
are float32 only, so its f64 scene takes the masked solve, whose result the
float64 kernel computes.
"""

from __future__ import annotations

import numpy as np
import torch

# Module attributes, read live (`from rapier_tpu_torch import precision;
# precision.NP_FLOAT`), never imported by value.
FLOAT = torch.float32
NP_FLOAT = np.float32


def set_precision(kind: str) -> None:
    """kind: "f32" (the default) or "f64"."""
    global FLOAT, NP_FLOAT
    if kind == "f64":
        FLOAT, NP_FLOAT = torch.float64, np.float64
    elif kind == "f32":
        FLOAT, NP_FLOAT = torch.float32, np.float32
    else:
        raise ValueError(f"unknown precision {kind!r} (use 'f32' or 'f64')")


def is_f64() -> bool:
    return NP_FLOAT is np.float64
