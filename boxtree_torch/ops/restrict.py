"""The demand pass and the consistency sweep of the 2:1 level restriction,
and the K5 and K45 kernels.

One demand pass at level ``m`` (``boxtree_tpu/tree/level_restrict.py:
50-90``): every leaf box at level ``m`` demands that the level-``m-1``
cells touching it be refined to at least level ``m-1``.  Each demanded
cell is one contiguous range ``[lo, hi)`` of the Morton-sorted particles;
the ranges are marked with +1/-1 and a cumulative sum, and every covered
particle whose leaf level is below ``m-1`` is raised to it.  A demanded
cell with no particles of its own (``lo == hi``) may lie inside a coarser
leaf whose particles sit just before or at ``lo``; that leaf is raised by
one level.  These raises run offset by offset, ``lo - 1`` before ``lo``,
each step reading the leaf levels as the earlier steps left them, so the
result depends on that order.

:func:`demand_pass` launches ``csrc/restrict.cu`` (K5) on CUDA tensors and
runs :func:`demand_pass_plain`, the reference's algorithm step for step,
on CPU tensors.  Both give the same leaf levels bit for bit.

The sweep at level ``t`` (``boxtree_tpu/tree/level_restrict.py:94-116``):
within each maximal run of active particles (leaf level at least ``t``)
that share their level-``t`` prefix, every particle at leaf level ``t``
rises to ``t + 1`` if the run holds a deeper particle.  Mid-round the tree
need not be consistent, so an inactive particle may split a prefix range
into two runs.  :func:`sweep` launches K45 on CUDA tensors and runs
:func:`sweep_plain` (segment bounds by ``cummax`` / ``cummin``) on CPU
tensors.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels, morton
from boxtree_torch.ops import tree as tree_ops
from boxtree_torch.traversal.neighbors import _offsets


def demand_pass_plain(codes_s, leaf_level, *, m, dimensions, depth):
    """Plain twin of :func:`demand_pass`: the reference's demand pass at
    level *m*, one offset at a time, over every particle."""
    n = codes_s.shape[0]
    d = dimensions
    dev = codes_s.device
    offs = torch.as_tensor(_offsets(d, 1), device=dev)
    leaf_level = leaf_level.clone()
    is_m_leaf = leaf_level == m
    cells = morton.deinterleave(codes_s >> (d * (depth - m)), d)
    marks = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    nb = 1 << m
    pshift = d * (depth - (m - 1))
    for i in range(offs.shape[0]):
        nc = cells + offs[i][:, None]
        in_range = ((nc >= 0) & (nc < nb)).all(dim=0)
        valid = is_m_leaf & in_range
        q = morton.interleave(nc.clamp(0, nb - 1) >> 1)
        lo = torch.searchsorted(codes_s, q << pshift)
        hi = torch.searchsorted(codes_s, (q + 1) << pshift)
        marks.index_add_(0, lo[valid], torch.ones_like(lo[valid],
                                                       dtype=torch.int32))
        marks.index_add_(0, hi[valid], torch.full_like(
            hi[valid], -1, dtype=torch.int32))

        empty = valid & (lo == hi)
        if not bool(empty.any()):
            continue
        for cand in (lo - 1, lo):
            ok = empty & (cand >= 0) & (cand < n)
            pc = cand.clamp(0, n - 1)
            t_p = leaf_level[pc].to(torch.int64)
            # the shifts only matter where t_p <= m - 2
            sh = (d * (m - 1 - t_p)).clamp(min=0)
            q_anc = q >> sh
            p_pfx = codes_s[pc] >> (d * (depth - t_p))
            upd = ok & (t_p <= m - 2) & (q_anc == p_pfx)
            # all writes of one step to one particle carry the same value
            # (its snapshot level + 1), so the scatter-max is a plain set
            leaf_level[pc[upd]] = (t_p[upd] + 1).to(leaf_level.dtype)
    covered = torch.cumsum(marks[:-1], 0) > 0
    return torch.where(covered & (leaf_level < m - 1),
                       torch.full_like(leaf_level, m - 1), leaf_level)


def demand_pass(codes_s, leaf_level, *, m, dimensions, depth):
    """Leaf levels after the demand pass at level *m* (``m >= 2``).

    :arg codes_s: ``(n,)`` int64 full-depth Morton keys, ascending.
    :arg leaf_level: ``(n,)`` int32 leaf level of every particle.
    :returns: the new ``(n,)`` int32 leaf levels.

    CPU tensors take :func:`demand_pass_plain`.  CUDA tensors launch K5
    (``csrc/restrict.cu``) once (it lists the level-``m`` leaf boxes on
    the card, then takes them one a thread), then finish with
    ``torch.cumsum`` of the marks; nothing is read back.
    """
    if codes_s.device.type == "cpu":
        return demand_pass_plain(codes_s, leaf_level, m=m,
                                 dimensions=dimensions, depth=depth)
    if dimensions not in (1, 2, 3):
        raise ValueError(f"unsupported dimensions {dimensions}")
    kernels.check_tensors(codes_s, dtype=torch.int64)
    kernels.check_tensors(leaf_level, dtype=torch.int32)
    n = codes_s.shape[0]
    dev = codes_s.device
    leaf_level = leaf_level.clone()
    marks = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    noffs = 3 ** dimensions
    # the listed boxes, then the raise candidates of each offset
    counts = torch.zeros(1 + noffs, dtype=torch.int32, device=dev)
    reps = torch.empty(n, dtype=torch.int64, device=dev)
    # each candidate's box (its first particle) and range start, n slots an
    # offset (int32, as particle ids are)
    ev_box = torch.empty(noffs * n, dtype=torch.int32, device=dev)
    ev_lo = torch.empty(noffs * n, dtype=torch.int32, device=dev)
    ev_val = torch.empty(n, dtype=torch.int32, device=dev)
    kernels.launch("restrict_demand", None, codes_s, n, leaf_level,
                   dimensions, depth, m, marks, counts, reps, ev_box, ev_lo,
                   ev_val)
    covered = torch.cumsum(marks[:-1], 0) > 0
    return torch.where(covered & (leaf_level < m - 1),
                       torch.full_like(leaf_level, m - 1), leaf_level)


def sweep_plain(codes_s, leaf_level, *, t, dimensions, depth):
    """Plain twin of :func:`sweep`: the reference's segment bounds by
    ``cummax`` and a reversed ``cummin``, and a cumulative count of the
    deeper particles."""
    n = codes_s.shape[0]
    dev = codes_s.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    end = torch.full((1,), n, dtype=torch.int64, device=dev)
    is_start, active = tree_ops.run_starts(codes_s, leaf_level, t,
                                           dimensions, depth)
    lo = torch.cummax(torch.where(is_start, iota, 0), 0).values
    nxt = torch.where(is_start | ~active, iota, n)
    suf = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    hi = torch.cat([suf[1:], end])
    deeper = torch.cat([end.new_zeros(1), torch.cumsum(
        (leaf_level > t).to(torch.int64), 0)])
    has_deeper = (deeper[hi] - deeper[lo]) > 0
    return torch.where(active & (leaf_level == t) & has_deeper,
                       torch.full_like(leaf_level, t + 1), leaf_level)


def sweep(codes_s, leaf_level, *, t, dimensions, depth, lcp=None):
    """Leaf levels after the consistency sweep at level *t*.

    :arg codes_s: ``(n,)`` int64 full-depth Morton keys, ascending.
    :arg leaf_level: ``(n,)`` int32 leaf levels.
    :arg lcp: the keys' :func:`boxtree_torch.ops.tree.lcp_levels`, or None
        to compute them here (the restriction computes them once).
    :returns: the new ``(n,)`` int32 leaf levels.

    CPU tensors take :func:`sweep_plain`.  CUDA tensors launch K45
    (``csrc/restrict.cu``) once, over the runs' inclusive scan of their
    starts (a library ``cumsum``); nothing is read back.
    """
    if codes_s.device.type == "cpu":
        return sweep_plain(codes_s, leaf_level, t=t, dimensions=dimensions,
                           depth=depth)
    kernels.check_tensors(codes_s, dtype=torch.int64)
    kernels.check_tensors(leaf_level, dtype=torch.int32)
    if lcp is None:
        lcp = tree_ops.lcp_levels(codes_s, dimensions, depth)
    n = codes_s.shape[0]
    prev_leaf = torch.cat([leaf_level.new_full((1,), -1), leaf_level[:-1]])
    is_start = (leaf_level >= t) & (
        torch.minimum(lcp, prev_leaf.to(torch.int64)) < t)
    seg = torch.cumsum(is_start, 0, dtype=torch.int32)
    leaf_level = leaf_level.clone()
    flag = torch.zeros(n, dtype=torch.int32, device=codes_s.device)
    kernels.launch("restrict_sweep", None, leaf_level, n, seg, t, flag)
    return leaf_level
