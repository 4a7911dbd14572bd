# Frozen copy of rapier_tpu_torch/geometry/broadphase.py at commit 4adbf044245c; imports
# made relative to this package.  Do not edit: it is the benchmark's yardstick.
"""Broad phase: AABB pair finding (counterpart of
rapier_tpu.geometry.broadphase).

Three strategies, each compacting its candidates in a fixed order into a
``[B, P]`` pair buffer (lane order is semantics: the coloring hashes the
lane index):

- ALL_PAIRS: the masked ``[C, C]`` overlap test, row-major over the upper
  triangle.
- SAP: sweep and prune along the axis of largest centre variance, each
  collider against the next `window` in sorted order, plus the K_LONG
  longest colliders paired globally.  Candidates: the ``[C, window]`` grid
  row-major, then the ``[K_LONG, C]`` long-collider grid.
- GRID: a uniform grid whose cell is the largest non-long extent; colliders
  sort by their cell key and meet their own column and four forward column
  offsets, plus the long-collider grid.  Candidates: the own-column window,
  the offsets (1,-1), (1,0), (1,1), (0,1), then the long-collider grid.

Window misses, cell overflows and run truncations are counted in
`overflow`, never dropped silently.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .types import BodyType, BroadPhaseKind
from .compaction import compact_indices


def _compact_pairs(c1, c2, mask, max_pairs: int):
    """Compact masked candidate pairs ``[B, K]`` into a ``[B, P]`` buffer,
    keeping candidate order; overflowing pairs are dropped and counted."""
    src, valid, overflow = compact_indices(mask, max_pairs)
    out1 = torch.where(valid, torch.gather(c1, -1, src), -1).to(torch.int32)
    out2 = torch.where(valid, torch.gather(c2, -1, src), -1).to(torch.int32)
    return out1, out2, valid, overflow


def _parent_body_type(colliders, body_type):
    parent = colliders.parent.long()
    bt = torch.gather(body_type.long(), -1, parent.clamp(min=0))
    return torch.where(parent >= 0, bt, int(BodyType.FIXED))


K_LONG = 8          # colliders with the longest extents pair globally
GRID_CELL_CAP = 8   # colliders per cell the grid's candidate runs assume
GRID_M = 1024       # grid cells per axis
_I32_MAX = 2**31 - 1


class _Fields(NamedTuple):
    """The per-collider fields the pair filters read, ``[B, C, ...]``."""

    min: torch.Tensor   # [B, C, 3]
    max: torch.Tensor   # [B, C, 3]
    en: torch.Tensor
    par: torch.Tensor
    bt: torch.Tensor    # parent body type
    act: torch.Tensor   # active collision types
    g: torch.Tensor     # interaction groups


def _fields(mins, maxs, en, colliders, body_type) -> _Fields:
    return _Fields(mins, maxs, en, colliders.parent.long(),
                   _parent_body_type(colliders, body_type),
                   colliders.active_collision_types.long(),
                   colliders.collision_groups.long())


def _rows(arr, idx):
    """``arr [B, C, ...]`` at per-scene rows ``idx [B, ...]``."""
    flat = idx.reshape(idx.shape[0], -1)
    tail = tuple(arr.shape[2:])
    ix = flat.view(flat.shape + (1,) * len(tail)).expand(flat.shape + tail)
    return torch.gather(arr, 1, ix).reshape(tuple(idx.shape) + tail)


def _take(f: _Fields, idx) -> _Fields:
    return _Fields(*(_rows(x, idx) for x in f))


def _at(f: _Fields, dim: int) -> _Fields:
    """Every field with a broadcast axis at `dim`."""
    return _Fields(*(x.unsqueeze(dim) for x in f))


def _pair_ok(a: _Fields, b: _Fields):
    """The reference's pair filters (narrow_phase.rs:834-932 hoisted) between
    colliders `a` and `b`, broadcast against each other: AABB overlap, both
    enabled, no shared parent, the ActiveCollisionTypes test
    (collider_components.rs:282: either side's mask may allow the body-type
    combination) and the interaction groups."""
    def kinds(act):
        return ((((act >> (a.bt * 4)) & 15) & (1 << b.bt)) != 0) | (
            (((act >> (b.bt * 4)) & 15) & (1 << a.bt)) != 0)

    overlap = torch.all((a.min <= b.max) & (b.min <= a.max), dim=-1)
    return (overlap & a.en & b.en & ~((a.par == b.par) & (a.par >= 0))
            & (kinds(a.act) | kinds(b.act))
            & (((a.g >> 16) & (b.g & 0xFFFF)) != 0) & (((b.g >> 16) & (a.g & 0xFFFF)) != 0))


def _wrap32(x):
    """int64 values as the reference's int32 arithmetic leaves them
    (two's-complement wrap)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _forward(start, width: int, c: int):
    """Candidate rows ``start [..., 1] + k`` for k < `width`, clamped to the
    last row, and whether each is in range."""
    run = start + torch.arange(width, device=start.device)
    return torch.clamp(run, max=c - 1), run < c


def _long_set(score, k_long: int):
    """The `k_long` highest scores per scene, the lower index first among
    equal scores (`jax.lax.top_k`'s order): (rows ``[B, K]``, rank ``[B, C]``
    with k_long for colliders outside the set)."""
    rows = torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :k_long]
    rank = torch.full_like(score, k_long, dtype=torch.int64).scatter(
        1, rows, torch.arange(k_long, device=score.device).expand_as(rows))
    return rows, rank


def _long_pairs(f: _Fields, rows, rank, k_long: int):
    """``[B, K, C]`` mask of each long collider (`rows` of `f`) against every
    collider; a long-long pair counts once, at the lower long rank."""
    c = f.min.shape[1]
    dedup = (rank >= k_long).unsqueeze(1) | (
        rank.unsqueeze(1) > torch.arange(k_long, device=rows.device)[:, None])
    not_self = rows.unsqueeze(-1) != torch.arange(c, device=rows.device)
    return _pair_ok(_at(_take(f, rows), 2), _at(f, 1)) & dedup & not_self


def _pairs_out(ids_a, ids_b, masks, max_pairs: int):
    """Compact the concatenated candidate grids, each pair as (lower id,
    higher id)."""
    bsz = ids_a[0].shape[0]
    all_a = torch.cat([x.reshape(bsz, -1) for x in ids_a], dim=1)
    all_b = torch.cat([x.reshape(bsz, -1) for x in ids_b], dim=1)
    return _compact_pairs(torch.minimum(all_a, all_b), torch.maximum(all_a, all_b),
                          torch.cat([m.reshape(bsz, -1) for m in masks], dim=1), max_pairs)


def find_pairs_all(mins, maxs, colliders, body_type, max_pairs: int):
    """All-pairs test over ``[B, C, 3]`` AABBs, compacted row-major over the
    upper triangle.  Returns (c1, c2 ``[B, P]`` int32, -1 where empty; valid
    ``[B, P]``; overflow ``[B]``)."""
    c = mins.shape[-2]
    f = _fields(mins, maxs, colliders.enabled, colliders, body_type)
    idx = torch.arange(c, device=mins.device)
    ok = _pair_ok(_at(f, 2), _at(f, 1)) & (idx[:, None] < idx[None, :])
    src, valid, overflow = compact_indices(ok.reshape(ok.shape[0], -1), max_pairs)
    out1 = torch.where(valid, src // c, -1).to(torch.int32)
    out2 = torch.where(valid, src % c, -1).to(torch.int32)
    return out1, out2, valid, overflow


def find_pairs_sap(mins, maxs, colliders, body_type, max_pairs: int, window: int):
    """Sweep and prune with a fixed window and a global long-collider set
    (broadphase.py:104-239)."""
    bsz, c, _ = mins.shape
    en = colliders.enabled
    var = torch.var(torch.where(en.unsqueeze(-1), 0.5 * (mins + maxs), 0.0), dim=1,
                    correction=0)
    ax = torch.argmax(var, dim=-1).view(bsz, 1, 1).expand(bsz, c, 1)
    key = torch.where(en, torch.gather(mins, 2, ax)[..., 0], float("inf"))
    order = torch.argsort(key, dim=-1, stable=True)
    s = _take(_fields(mins, maxs, en, colliders, body_type), order)   # sweep order
    s_key = _rows(key, order)
    smax_axis = torch.gather(s.max, 2, ax)[..., 0]

    slot = torch.arange(c, device=mins.device)
    j, in_range = _forward(slot[:, None] + 1, window, c)
    j = j.expand(bsz, c, window)
    mask = (in_range & (_rows(s_key, j) <= smax_axis.unsqueeze(-1))
            & _pair_ok(_at(s, 2), _take(s, j)))

    # The long colliders (grounds, walls) leave the window and pair globally.
    k_long = min(K_LONG, c)
    li, rank = _long_set(torch.where(s.en, smax_axis - s_key, float("-inf")), k_long)
    is_long = rank < k_long
    mask = mask & ~is_long.unsqueeze(-1) & ~_rows(is_long, j)
    out1, out2, valid, overflow = _pairs_out(
        [order.unsqueeze(-1).expand(bsz, c, window), _rows(order, li).unsqueeze(-1)
         .expand(bsz, k_long, c)],
        [_rows(order, j), order.unsqueeze(1).expand(bsz, k_long, c)],
        [mask, _long_pairs(s, li, rank, k_long)], max_pairs)

    # Window misses: an interval still open `window` rows on.
    far = torch.clamp(slot + window, max=c - 1)
    missed = (slot + window < c) & (s_key[:, far] <= smax_axis) & ~is_long
    return out1, out2, valid, (overflow + missed.sum(-1)).to(torch.int32)


def find_pairs_grid(mins, maxs, colliders, body_type, max_pairs: int):
    """Uniform-grid broad phase (broadphase.py:260-432), complete for dense
    3D piles."""
    bsz, c, _ = mins.shape
    en = colliders.enabled
    max_ext = torch.amax(torch.where(en.unsqueeze(-1), maxs - mins, 0.0), dim=-1)
    k_long = min(K_LONG, c)
    long_idx, rank = _long_set(torch.where(en, max_ext, float("-inf")), k_long)
    is_long = rank < k_long                                       # original ids

    # Cell size: the largest non-long extent, 5% slack.
    h = torch.clamp(torch.amax(torch.where(is_long, 0.0, max_ext), dim=-1), min=1e-3) * 1.05
    ctr = 0.5 * (mins + maxs)
    origin = torch.amin(torch.where(en.unsqueeze(-1), ctr, float("inf")), dim=1)
    cell = torch.clamp(torch.floor((ctr - origin.unsqueeze(1)) / h.view(bsz, 1, 1)),
                       0, GRID_M - 1).long()
    key = (cell[..., 0] * GRID_M + cell[..., 2]) * GRID_M + cell[..., 1]
    key = torch.where(en & ~is_long, key, _I32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    skey = torch.gather(key, 1, order).contiguous()
    f = _fields(mins, maxs, en, colliders, body_type)
    s = _take(f._replace(en=en & ~is_long), order)                 # key order
    s_row = _at(s, 2)

    slot = torch.arange(c, device=mins.device)
    width = 3 * GRID_CELL_CAP
    rows = order.unsqueeze(-1).expand(bsz, c, width)

    # Own column: a static forward window over the same and adjacent y cells.
    j, in_range = _forward(slot[:, None] + 1, width, c)
    j = j.expand(bsz, c, width)
    in_col = _rows(skey, j) <= _wrap32(skey + 1).unsqueeze(-1)
    masks, ids_b = [_pair_ok(s_row, _take(s, j)) & in_col & in_range], [_rows(order, j)]
    far = torch.clamp(slot + width, max=c - 1)
    overflow = ((slot + width < c) & (skey[:, far] <= _wrap32(skey + 1))).sum(-1)

    # The four forward column offsets: contiguous 3-cell runs in key order.
    for dx, dz in ((1, -1), (1, 0), (1, 1), (0, 1)):
        off = (dx * GRID_M + dz) * GRID_M
        lo_key = _wrap32(skey + off - 1)
        hi_key = _wrap32(skey + off + 1)
        pos = torch.searchsorted(skey, lo_key.contiguous())
        j, in_range = _forward(pos.unsqueeze(-1), width, c)
        jkey = _rows(skey, j)
        masks.append(_pair_ok(s_row, _take(s, j)) & in_range
                     & (jkey >= lo_key.unsqueeze(-1)) & (jkey <= hi_key.unsqueeze(-1)))
        ids_b.append(_rows(order, j))
        far = torch.clamp(pos + width, max=c - 1)
        overflow = overflow + ((pos + width < c)
                               & (torch.gather(skey, 1, far) <= hi_key)).sum(-1)

    # The long colliders against every collider, in original ids.
    masks.append(_long_pairs(f, long_idx, rank, k_long))
    out1, out2, valid, ovf = _pairs_out(
        [rows] * 5 + [long_idx.unsqueeze(-1).expand(bsz, k_long, c)],
        ids_b + [slot.expand(bsz, k_long, c)], masks, max_pairs)
    return out1, out2, valid, (ovf + overflow).to(torch.int32)


def find_pairs(mins, maxs, colliders, body_type, max_pairs: int, kind: int,
               window: int = 64):
    if kind == BroadPhaseKind.SAP:
        return find_pairs_sap(mins, maxs, colliders, body_type, max_pairs, window)
    if kind == BroadPhaseKind.GRID:
        return find_pairs_grid(mins, maxs, colliders, body_type, max_pairs)
    return find_pairs_all(mins, maxs, colliders, body_type, max_pairs)
