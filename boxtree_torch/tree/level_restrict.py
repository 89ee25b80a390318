"""2:1 level restriction for adaptive trees.

Port of :mod:`boxtree_tpu.tree.level_restrict`
(``boxtree_tpu/tree/level_restrict.py:41-153``): makes neighbouring
leaves differ by at most one level (the ``"adaptive-level-restricted"``
tree kind) by raising the per-particle leaf levels of the sort-based
build, in rounds until nothing changes.  Each round is

1. the downward demand pass, deepest level first
   (:func:`boxtree_torch.ops.restrict.demand_pass`, the K5 kernel on the
   card), and
2. the consistency sweep: a box splits as a whole, so if any particle of a
   box descends, every particle of it does (segment reductions with
   ``torch.cummax``, ``torch.cummin`` and ``torch.cumsum``).

The restriction acts on non-empty leaves only, as the reference's does.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import restrict


def _box_starts(codes_s, leaf_level, level, dimensions, depth):
    """Particles that start a box at *level*, and the active mask."""
    pfx = codes_s >> (dimensions * (depth - level))
    active = leaf_level >= level
    is_start = active.clone()
    is_start[1:] &= (pfx[1:] != pfx[:-1]) | ~active[:-1]
    return is_start, active


def _consistency_sweep(codes_s, leaf_level, *, dimensions, depth,
                       max_level):
    """Raise every leaf box at level t that holds a deeper particle
    (``level_restrict.py:94-114``)."""
    n = codes_s.shape[0]
    dev = codes_s.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    end = torch.full((1,), n, dtype=torch.int64, device=dev)
    for t in range(max_level):
        is_start, active = _box_starts(codes_s, leaf_level, t, dimensions,
                                       depth)
        lo = torch.cummax(torch.where(is_start, iota, 0), 0).values
        nxt = torch.where(is_start | ~active, iota, n)
        suf = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
        hi = torch.cat([suf[1:], end])
        deeper = torch.cat([end.new_zeros(1), torch.cumsum(
            (leaf_level > t).to(torch.int64), 0)])
        has_deeper = (deeper[hi] - deeper[lo]) > 0
        leaf_level = torch.where(active & (leaf_level == t) & has_deeper,
                                 torch.full_like(leaf_level, t + 1),
                                 leaf_level)
    return leaf_level


def _recount_boxes(codes_s, leaf_level, *, dimensions, depth, max_level):
    """Boxes per level, ``(depth + 2,)`` int64 (``level_restrict.py:
    122-133``)."""
    counts = torch.zeros(depth + 2, dtype=torch.int64,
                         device=codes_s.device)
    for level in range(max_level + 1):
        is_start, _ = _box_starts(codes_s, leaf_level, level, dimensions,
                                  depth)
        counts[level] = is_start.sum()
    return counts


def restrict_leaf_levels(codes_s, leaf_level, *, dimensions, depth,
                         max_level, plain=False):
    """Raise per-particle leaf levels until the 2:1 constraint holds
    (``boxtree_tpu/tree/level_restrict.py:136-153``).

    :arg codes_s: ``(n,)`` int64 full-depth Morton keys, ascending.
    :arg leaf_level: ``(n,)`` int32 leaf levels from phase A.
    :arg max_level: deepest occupied level; the restriction never deepens
        the tree.
    :arg plain: run the demand pass's plain twin whatever the device.
    :returns: ``(leaf_level, counts, rounds)``: the new leaf levels, the
        per-level box counts as a ``(depth + 2,)`` int64 tensor, and the
        number of rounds run.
    """
    demand = restrict.demand_pass_plain if plain else restrict.demand_pass
    rounds = 0
    for _ in range(max_level + 1):
        leaf_in = leaf_level
        for m in range(max_level, 1, -1):
            leaf_level = demand(codes_s, leaf_level, m=m,
                                dimensions=dimensions, depth=depth)
        leaf_level = _consistency_sweep(codes_s, leaf_level,
                                        dimensions=dimensions, depth=depth,
                                        max_level=max_level)
        rounds += 1
        if not bool((leaf_level != leaf_in).any()):
            break
    counts = _recount_boxes(codes_s, leaf_level, dimensions=dimensions,
                            depth=depth, max_level=max_level)
    return leaf_level, counts, rounds
