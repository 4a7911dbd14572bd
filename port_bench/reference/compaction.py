# Frozen copy of rapier_tpu_torch/utils/compaction.py at commit 4adbf044245c; imports
# made relative to this package.  Do not edit: it is the benchmark's yardstick.
"""Order-preserving stream compaction (the semantics of
rapier_tpu.utils.compaction.compact_indices / compact_route).

The reference builds one-hot routes and blocked ranks because computed-index
gathers serialise on a TPU.  Here a compaction is a cumsum plus a batched
searchsorted; callers gather fields with the returned indices.
"""

from __future__ import annotations

import torch

from .routing import take_lanes


def compact_indices(mask, max_out: int):
    """Indices of the first `max_out` True lanes of `mask` ``[..., K]``.

    Returns (src ``[..., max_out]`` int64, valid ``[..., max_out]`` bool,
    overflow ``[...]`` int32): src[j] is the lane of the (j+1)-th True entry,
    0 where invalid; overflow counts True lanes beyond `max_out`."""
    inc = torch.cumsum(mask.to(torch.int32), dim=-1)
    total = inc[..., -1]
    targets = torch.arange(1, max_out + 1, dtype=torch.int32, device=mask.device)
    targets = targets.expand(mask.shape[:-1] + (max_out,)).contiguous()
    src = torch.searchsorted(inc.contiguous(), targets)
    valid = targets <= total[..., None]
    src = torch.where(valid, src, torch.zeros_like(src))
    overflow = torch.clamp(total - max_out, min=0).to(torch.int32)
    return src, valid, overflow


def gather_lanes(x, src, valid, fill=0):
    """Gather the compacted lanes ``x[..., src]`` of a lane-last field
    ``[B, *rows, K]`` by ``src [B, K']``; invalid slots take `fill`."""
    v = valid.view((valid.shape[0],) + (1,) * (x.dim() - 2) + (valid.shape[-1],))
    return torch.where(v, take_lanes(x, src),
                       torch.as_tensor(fill, dtype=x.dtype, device=x.device))
