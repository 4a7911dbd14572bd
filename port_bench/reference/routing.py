# Frozen copy of rapier_tpu_torch/utils/routing.py at commit 4adbf044245c; imports
# made relative to this package.  Do not edit: it is the benchmark's yardstick.
"""Sorted segment plans for large single scenes (counterpart of
rapier_tpu.utils.routing).

A `SegmentPlan` sorts K lanes by their target segment once (a stable
argsort) and finds each segment's slot range with a batched searchsorted.
Every reduction over the same targets then reuses it: the blocked coloring's
rounds, the solver's warmstart and Jacobi-tail scatters.

`segment_sum` keeps the reference's form: the lane values in sorted order,
their cumsum, and the difference at each segment's ends.  The order of the
additions is fixed by the plan, so the sum does not depend on the run (a
float `scatter_add` on the card adds in the order its atomics land).
`segment_max` and `segment_any` are order-free and reduce with
`scatter_reduce`.

Every tensor carries a leading scene axis: ids ``[B, K]``, values
``[B, ..., K]``, results ``[B, ..., N]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentPlan(NamedTuple):
    """K lanes routed into N segments, sorted by segment id."""

    perm: torch.Tensor        # [B, K] int64: lane order sorted by segment id
    sorted_ids: torch.Tensor  # [B, K] int64: segment id of each sorted slot
    starts: torch.Tensor      # [B, N] int64: first sorted slot of each segment
    ends: torch.Tensor        # [B, N] int64: one past its last sorted slot
    n_segments: int


def take_lanes(x, idx):
    """``x [B, ..., K]`` at lane indices ``idx [B, M]`` -> ``[B, ..., M]``."""
    ix = idx.view((idx.shape[0],) + (1,) * (x.dim() - 2) + (idx.shape[-1],))
    return torch.gather(x, -1, ix.expand(x.shape[:-1] + (idx.shape[-1],)))


def make_segment_plan(ids, n_segments: int) -> SegmentPlan:
    """Plan for ``ids [B, K]``; ids outside [0, n_segments) are clamped into
    range, so callers send masked lanes to a sentinel segment they ignore."""
    ids = torch.clamp(ids.long(), 0, n_segments - 1)
    perm = torch.argsort(ids, dim=-1, stable=True)
    sorted_ids = torch.gather(ids, -1, perm).contiguous()
    edges = torch.arange(n_segments, device=ids.device).expand(
        ids.shape[0], n_segments).contiguous()
    starts = torch.searchsorted(sorted_ids, edges, side="left")
    ends = torch.searchsorted(sorted_ids, edges, side="right")
    return SegmentPlan(perm, sorted_ids, starts, ends, n_segments)


def segment_sum(values, plan: SegmentPlan):
    """Sum lane values ``[B, ..., K]`` into segments ``[B, ..., N]``: a
    cumsum over the sorted values, differenced at the segment ends."""
    vs = take_lanes(values, plan.perm)
    cs = torch.cat([torch.zeros_like(vs[..., :1]), torch.cumsum(vs, dim=-1)], dim=-1)
    return take_lanes(cs, plan.ends) - take_lanes(cs, plan.starts)


def segment_max(values, plan: SegmentPlan, empty):
    """Max of lane values ``[B, K]`` per segment ``[B, N]``; segments with
    no lane hold `empty`."""
    vs = torch.gather(values, -1, plan.perm)
    out = torch.zeros(values.shape[:-1] + (plan.n_segments,), dtype=values.dtype,
                      device=values.device)
    out = out.scatter_reduce(-1, plan.sorted_ids, vs, "amax", include_self=False)
    return torch.where(plan.ends > plan.starts, out,
                       torch.as_tensor(empty, dtype=values.dtype, device=values.device))


def segment_any(values_bool, plan: SegmentPlan):
    """OR of boolean lane values per segment."""
    return segment_max(values_bool.to(torch.int32), plan, 0) > 0
