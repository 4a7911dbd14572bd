# Frozen copy of rapier_tpu_torch/dynamics/solver/coloring.py at commit 4adbf044245c; imports
# made relative to this package.  Do not edit: it is the benchmark's yardstick.
"""Constraint-graph coloring for Gauss-Seidel color sweeps (counterpart of
rapier_tpu.dynamics.solver.coloring: `color_constraints`, and for large
scenes `block_caps` with `color_constraints_blocked`).

Same rule as the reference, so the colors are equal: Luby-style rounds pick,
per round, every uncolored lane whose hashed priority is the maximum over
both of its dynamic bodies; lanes left after ``max_colors - 1`` rounds fall
into the overflow color ``max_colors - 1``; a greedy merge then folds each
color into the first earlier color it shares no dynamic body with, and the
colors are renumbered densely.
"""

from __future__ import annotations

import torch

from .routing import make_segment_plan, segment_max


def _hash32(x):
    """The reference's uint32 Knuth hash, in int64 with a 32-bit mask
    (torch's uint32 arithmetic is incomplete)."""
    return ((x.to(torch.int64) * 2654435761) & 0xFFFFFFFF) ^ 0x9E3779B9


def color_constraints(b1, b2, dyn1, dyn2, valid, n_bodies: int, max_colors: int):
    """Color ``[B, K]`` lanes so no two same-color lanes share a dynamic body.

    Returns (color ``[B, K]`` int32 in [0, max_colors) for valid lanes and
    max_colors for invalid ones, num_colors ``[B]`` int32)."""
    bsz, k = b1.shape
    dev = b1.device
    n1 = n_bodies + 1
    w = _hash32(torch.arange(k, device=dev)).expand(bsz, k)
    sent = n_bodies
    color = torch.where(valid, -1, max_colors).to(torch.int64)
    t1 = torch.where(dyn1, b1, sent).long()
    t2 = torch.where(dyn2, b2, sent).long()
    zero = torch.zeros((bsz, n1), dtype=torch.int64, device=dev)

    r = 0
    while r < max_colors - 1 and bool(torch.any(valid & (color < 0))):
        unc = valid & (color < 0)
        wm = torch.where(unc, w, 0)
        bw = zero.scatter_reduce(1, t1, wm, "amax").scatter_reduce(1, t2, wm, "amax")
        bw1 = torch.gather(bw, 1, t1)
        bw2 = torch.gather(bw, 1, t2)
        sel = unc & (~dyn1 | (bw1 == w)) & (~dyn2 | (bw2 == w))
        color = torch.where(sel, r, color)
        r += 1
    color = torch.where(valid & (color < 0), max_colors - 1, color)

    # Greedy color merge (conflict-free colors only fold into earlier
    # colors that share no dynamic body with them).
    mc = max_colors
    colored = color < mc
    cidx = torch.where(colored, color, 0)
    ones = colored.to(torch.int32)
    counts = torch.zeros((bsz, mc * n1), dtype=torch.int32, device=dev)
    counts = counts.scatter_add(1, cidx * n1 + t1, ones)
    counts = counts.scatter_add(1, cidx * n1 + t2, ones).view(bsz, mc, n1)
    counts[:, :, n_bodies] = 0           # the sentinel never conflicts
    occ = counts > 0
    self_ok = ~torch.any(counts > 1, dim=-1)                 # [B, MC]

    ids = torch.arange(mc, device=dev)
    mocc = torch.zeros_like(occ)
    mocc[:, 0] = occ[:, 0]
    cmap = ids.expand(bsz, mc).clone()
    for c in range(1, mc):
        occ_c = occ[:, c]
        conflict = torch.any(mocc & occ_c[:, None, :], dim=-1)
        cand = torch.where((ids < c) & ~conflict & self_ok[:, c:c + 1], ids, c)
        t = torch.amin(cand, dim=-1)
        mocc = mocc | ((ids == t[:, None])[:, :, None] & occ_c[:, None, :])
        cmap[:, c] = t
    used = torch.zeros((bsz, mc), dtype=torch.bool, device=dev)
    used.scatter_(1, cmap, True)
    new_id = torch.cumsum(used.to(torch.int64), dim=-1) - 1
    cmap_dense = torch.gather(new_id, 1, cmap)
    color = torch.where(valid, torch.gather(cmap_dense, 1, cidx), mc)
    num_colors = torch.amax(torch.where(valid, color, -1), dim=-1) + 1
    return color.to(torch.int32), num_colors.to(torch.int32)


def block_caps(total: int, max_colors: int, min_cap: int = 256):
    """The blocked solve's static lane capacity per color (coloring.py:
    162-177): front-loaded, since Luby rounds select geometrically shrinking
    independent sets, and 128-aligned; their sum is ~1.3 x `total`."""

    def ru(x):
        return max(min_cap, -(-x // 128) * 128)

    sched = [2, 4, 4, 8, 8, 16, 16, 16]
    caps = [ru(total // f) for f in sched[:max_colors]]
    while len(caps) < max_colors:
        caps.append(min_cap)
    return tuple(caps)


def solve_caps(total: int, k_lanes: int, max_colors: int):
    """The blocked solve's layout: `block_caps` with the last (Jacobi tail)
    block widened to all `k_lanes` lanes, so that it takes every lane the
    Luby rounds leave and no lane is dropped.  The reference keeps the tail
    at its cap and drops the rest for the step (ROADMAP R7); where it drops
    none the two layouts solve the same lanes in the same slots."""
    caps = block_caps(total, max_colors)
    return caps[:-1] + (max(caps[-1], k_lanes),)


def color_constraints_blocked(b1, b2, dyn1, dyn2, valid, n_bodies: int, caps: tuple):
    """Capped Luby coloring into a contiguous blocked lane layout
    (coloring.py:180-246).  Round r keeps at most caps[r] of its independent
    set, by lane order; the last round takes every lane left (a Jacobi tail,
    with no independence guarantee); lanes beyond the last cap are dropped.

    Every round runs: a round with no uncolored lane selects nothing, so
    this equals the reference, which skips such rounds, without asking the
    device whether any lane is left.

    Returns (color ``[B, K]`` int32 block id, len(caps) for invalid lanes
    and -1 for dropped ones; slot ``[B, K]`` int32 position in the layout,
    sum(caps) for both; dropped ``[B]`` int32)."""
    bsz, k = b1.shape
    dev = b1.device
    n_colors = len(caps)
    starts = [sum(caps[:r]) for r in range(n_colors)]
    w = _hash32(torch.arange(k, device=dev)).expand(bsz, k)
    sent = n_bodies
    t1 = torch.where(dyn1, b1, sent).long()
    t2 = torch.where(dyn2, b2, sent).long()
    # One plan over both endpoints: a round's per-body max is one reduction.
    plan = make_segment_plan(torch.cat([t1, t2], dim=-1), n_bodies + 1)
    color = torch.where(valid, -1, n_colors).to(torch.int64)
    slot = torch.full((bsz, k), sum(caps), dtype=torch.int64, device=dev)
    for r in range(n_colors):
        unc = valid & (color < 0)
        if r == n_colors - 1:
            sel = unc
        else:
            wm = torch.where(unc, w, 0)
            bw = segment_max(torch.cat([wm, wm], dim=-1), plan, 0)
            sel = (unc & (~dyn1 | (torch.gather(bw, 1, t1) == w))
                   & (~dyn2 | (torch.gather(bw, 1, t2) == w)))
        rank = torch.cumsum(sel.to(torch.int64), dim=-1) - 1
        keep = sel & (rank < caps[r])
        color = torch.where(keep, r, color)
        slot = torch.where(keep, starts[r] + rank, slot)
    dropped = torch.sum(valid & (color < 0), dim=-1, dtype=torch.int32)
    return color.to(torch.int32), slot.to(torch.int32), dropped
