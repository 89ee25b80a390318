"""Phase A and phase B of the tree build, and the restriction's recount:
the K43, K44 and K46 kernels.

- :func:`leaf_levels` (K43) gives every Morton-sorted particle its leaf
  level and counts the boxes of every level (``boxtree_tpu/tree/build.py:
  113-247``, ``_phase_a``'s level loop), in one launch and with no host
  read: the counts, the particles left in overfull boxes and the level a
  non-adaptive tree uses come back packed in one int64 array.
- :func:`box_levels` (K44) materializes the per-box arrays level by level
  (``build.py:337-419``, ``_phase_b``'s level loop), one launch a level,
  from the level counts the host already holds.
- :func:`level_box_counts` (K46) recounts the boxes of every level after
  the level restriction (``boxtree_tpu/tree/level_restrict.py:122-133``).

Each wrapper launches its kernel (``csrc/tree.cu``) on CUDA tensors and
runs its plain twin (the ``*_plain`` function, the reference's algorithm
in PyTorch) on CPU tensors; both give the same integers, and the same box
centres, bit for bit.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels, morton


def bit_length(x):
    """``64 - clz(x)`` of an int64 tensor (64 for negative entries)."""
    neg = x < 0
    x = torch.where(neg, torch.zeros_like(x), x)
    bl = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        m = (x >> s) != 0
        bl = bl + m.to(torch.int64) * s
        x = torch.where(m, x >> s, x)
    bl = bl + (x != 0).to(torch.int64)
    return torch.where(neg, torch.full_like(bl, 64), bl)


def lcp_levels(codes_s, dimensions, depth):
    """The deepest level at which each sorted key shares its prefix with
    its predecessor's, int64; the first takes the reference's sentinel
    (``boxtree_tpu/tree/build.py:321-326``), below -1."""
    xor = torch.cat([
        torch.full((1,), -1, dtype=torch.int64, device=codes_s.device),
        codes_s[1:] ^ codes_s[:-1]])
    return depth - (bit_length(xor) + dimensions - 1) // dimensions


def _prefix_starts(codes_s, shift):
    pfx = codes_s >> shift
    return torch.cat([torch.ones(1, dtype=torch.bool, device=codes_s.device),
                      pfx[1:] != pfx[:-1]])


def segment_totals(vals, is_start):
    """Per-element totals of each row of *vals* ``(k, n)`` over its run of
    equal prefixes."""
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    nseg = int(seg[-1]) + 1
    totals = vals.new_zeros(vals.shape[0], nseg).index_add_(1, seg, vals)
    return totals[:, seg]


def run_starts(codes_s, leaf_level, level, dimensions, depth):
    """Particles that start a run of active particles (leaf level at least
    *level*) with one level-*level* prefix, and the active mask
    (``boxtree_tpu/tree/level_restrict.py:96-101``)."""
    pfx = codes_s >> (dimensions * (depth - level))
    active = leaf_level >= level
    is_start = active.clone()
    is_start[1:] &= (pfx[1:] != pfx[:-1]) | ~active[:-1]
    return is_start, active


# {{{ K43: leaf levels and box counts (phase A)

def leaf_levels_plain(codes_s, weights_s, stick_s, max_weight, *,
                      dimensions, depth, adaptive=True):
    """Plain twin of :func:`leaf_levels`: the reference's level loop, all
    particles at a time, with a host check between levels."""
    n = codes_s.shape[0]
    dev = codes_s.device
    w = (weights_s.to(torch.int64) if weights_s is not None
         else torch.ones(n, dtype=torch.int64, device=dev))
    counts = torch.zeros(depth + 2, dtype=torch.int64, device=dev)
    leaf = torch.full((n,), depth, dtype=torch.int32, device=dev)
    used = -1
    if adaptive:
        assigned = torch.zeros(n, dtype=torch.bool, device=dev)
        level = 0
        while level <= depth and not bool(assigned.all()):
            active = ~assigned
            is_start = _prefix_starts(codes_s, dimensions * (depth - level))
            if stick_s is not None:
                # a split counts only particles that can still descend; a
                # box exists while it holds an active particle
                wt, n_active = segment_totals(torch.stack([
                    torch.where(active & (stick_s > level), w, 0),
                    active.to(torch.int64)]), is_start)
                counts[level] = (is_start & (n_active > 0)).sum()
                done = active & ((wt <= max_weight) | (stick_s <= level))
            else:
                wt = segment_totals(w[None], is_start)[0]
                counts[level] = (is_start & active).sum()
                done = active & (wt <= max_weight)
            leaf = torch.where(done, torch.full_like(leaf, level), leaf)
            assigned = assigned | done
            level += 1
        n_unfit = int((~assigned).sum())
    else:
        # every box splits while any is overfull
        # (boxtree_tpu/tree/build.py:218-241)
        n_unfit, used = n, depth
        for level in range(depth + 1):
            is_start = _prefix_starts(codes_s, dimensions * (depth - level))
            wt = segment_totals(w[None], is_start)[0]
            counts[level] = is_start.sum()
            if bool((wt <= max_weight).all()):
                n_unfit, used = 0, level
                break
        leaf = torch.full_like(leaf, used)
    return leaf, torch.cat([counts, torch.tensor(
        [n_unfit, used], dtype=torch.int64, device=dev)])


def leaf_levels(codes_s, weights_s, stick_s, max_weight, *, dimensions,
                depth, adaptive=True):
    """Leaf level of every particle and the boxes of every level.

    :arg codes_s: ``(n,)`` int64 full-depth Morton keys, ascending.
    :arg weights_s: ``(n,)`` integer refine weights in the same order, or
        None for unit weights.
    :arg stick_s: ``(n,)`` int32 stick levels (extents), or None.
    :arg max_weight: the largest refine weight of a leaf box.
    :arg adaptive: False for the non-adaptive kind (one leaf level).
    :returns: ``(leaf_level, packed)``: ``(n,)`` int32 leaf levels, and an
        int64 ``(depth + 4,)`` array of the boxes per level ``0..depth +
        1``, the number of particles still in overfull boxes at *depth*,
        and the leaf level of a non-adaptive tree (-1 for an adaptive one).

    CPU tensors take :func:`leaf_levels_plain`.  CUDA tensors launch K43
    (``csrc/tree.cu``) once, after one library ``cumsum`` of the weights
    (with extents: of the weights of the particles above each level, a
    ``(depth + 1, n + 1)`` int64 table).
    """
    if codes_s.device.type == "cpu":
        return leaf_levels_plain(codes_s, weights_s, stick_s, max_weight,
                                 dimensions=dimensions, depth=depth,
                                 adaptive=adaptive)
    if stick_s is not None and not adaptive:
        raise ValueError("extents require the adaptive kind")
    kernels.check_tensors(codes_s, dtype=torch.int64)
    n = codes_s.shape[0]
    dev = codes_s.device
    w = weights_s.to(torch.int64) if weights_s is not None else None
    cumw = table = stick = maxw = tags = codes_s   # placeholders
    if stick_s is not None:
        stick = stick_s.to(torch.int32).contiguous()
        levels = torch.arange(depth + 1, device=dev)[:, None]
        above = ((stick[None] > levels).to(torch.int64) if w is None
                 else torch.where(stick[None] > levels, w[None], 0))
        table = torch.zeros(depth + 1, n + 1, dtype=torch.int64, device=dev)
        table[:, 1:] = torch.cumsum(above, 1)
        tags = torch.zeros(n, dtype=torch.int64, device=dev)
    elif w is not None:
        cumw = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        cumw[1:] = torch.cumsum(w, 0)
    if not adaptive:
        maxw = torch.full((depth + 1,), torch.iinfo(torch.int64).min,
                          dtype=torch.int64, device=dev)
    leaf = torch.empty(n, dtype=torch.int32, device=dev)
    packed = torch.zeros(depth + 4, dtype=torch.int64, device=dev)
    packed[-1] = -1
    kernels.launch("tree_leaf_levels", None, codes_s, n, cumw,
                   int(w is not None and stick_s is None), table, stick,
                   int(stick_s is not None), int(max_weight), int(adaptive),
                   dimensions, depth, leaf, packed, maxw, tags)
    return leaf, packed

# }}}


# {{{ K44: the per-box arrays, level by level (phase B)

def _box_arrays(cap, n, d, cdt, dev):
    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return dict(
        box_morton=zeros(cap, dtype=torch.int64),
        box_level=zeros(cap, dtype=torch.int32),
        box_start=zeros(cap, dtype=torch.int64),
        box_count_cumul=zeros(cap, dtype=torch.int64),
        box_count_nonchild=zeros(cap, dtype=torch.int64),
        box_has_children=zeros(cap, dtype=torch.bool),
        box_parent=zeros(cap, dtype=torch.int32),
        box_child=zeros(2 ** d, cap, dtype=torch.int32),
        box_centers=zeros(d, cap, dtype=cdt),
        leaf_box=zeros(n, dtype=torch.int32))


def box_levels_plain(codes_s, leaf_level, bbox_min, root_extent, *,
                     dimensions, depth, level_starts, has_extents=False):
    """Plain twin of :func:`box_levels`: the reference's level loop, with
    one host read a level (the box starts' positions)."""
    nlevels = len(level_starts) - 1
    d = dimensions
    n = codes_s.shape[0]
    nchild = 2 ** d
    dev = codes_s.device
    cdt = bbox_min.dtype
    out = _box_arrays(level_starts[-1], n, d, cdt, dev)
    prev_box = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_box = out["leaf_box"]

    leaf64 = leaf_level.to(torch.int64)
    if has_extents:
        # active-particle prefix counts telescope across levels: the
        # "deeper" count of one level is the "active" count of the next
        cum_ge = torch.arange(n + 1, dtype=torch.int64, device=dev)
    else:
        iota64 = torch.arange(n, dtype=torch.int64, device=dev)
        lcp_level = lcp_levels(codes_s, d, depth)
        prev_leaf = torch.cat([
            torch.full((1,), -1, dtype=torch.int64, device=dev),
            leaf64[:-1]])
        thr = torch.minimum(lcp_level, prev_leaf)

    for level in range(nlevels):
        b0, b1 = level_starts[level], level_starts[level + 1]
        nl = b1 - b0
        if has_extents:
            cum_gt = _exclusive_cumsum((leaf64 > level).to(torch.int64))
        if nl == 0:
            if has_extents:
                cum_ge = cum_gt
            continue
        shift = d * (depth - level)
        active = leaf_level >= level
        if has_extents:
            is_start, _ = run_starts(codes_s, leaf_level, level, d, depth)
        else:
            is_start = (leaf64 >= level) & (thr < level)
        seg_id = torch.cumsum(is_start.to(torch.int32), 0,
                              dtype=torch.int32) - 1
        reps_l = torch.nonzero(is_start)[:, 0]
        if reps_l.shape[0] != nl:
            raise RuntimeError(f"level {level}: {reps_l.shape[0]} box "
                               f"starts, expected {nl}")

        if has_extents:
            nxt_l = torch.cat([reps_l[1:], reps_l.new_full((1,), n)])
            cumul_l = cum_ge[nxt_l] - cum_ge[reps_l]
            deeper_l = cum_gt[nxt_l] - cum_gt[reps_l]
            cum_ge = cum_gt
        else:
            # subtree end: next position whose prefix changes at or above
            # this level (reverse cummin)
            bnd = torch.where(lcp_level < level, iota64,
                              torch.full_like(iota64, n))
            suffmin = torch.flip(
                torch.cummin(torch.flip(bnd, [0]), 0).values, [0])
            suffmin = torch.cat([suffmin[1:], suffmin.new_full((1,), n)])
            cumul_l = suffmin[reps_l] - reps_l
            deeper_l = torch.where(leaf_level[reps_l] > level, cumul_l,
                                   torch.zeros_like(cumul_l))

        pfx_l = codes_s[reps_l] >> shift
        out["box_morton"][b0:b1] = pfx_l
        out["box_level"][b0:b1] = level
        out["box_start"][b0:b1] = reps_l
        out["box_count_cumul"][b0:b1] = cumul_l
        out["box_count_nonchild"][b0:b1] = cumul_l - deeper_l
        out["box_has_children"][b0:b1] = deeper_l > 0

        cells = morton.deinterleave(pfx_l, d)
        size = root_extent.to(cdt) / (1 << level)
        out["box_centers"][:, b0:b1] = (bbox_min[:, None]
                                        + (cells.to(cdt) + 0.5) * size)

        if level > 0:
            parent_l = prev_box[reps_l]
            out["box_parent"][b0:b1] = parent_l
            digit_l = pfx_l & (nchild - 1)
            out["box_child"][digit_l, parent_l.to(torch.int64)] = \
                torch.arange(b0, b1, dtype=torch.int32, device=dev)

        box_of_cur = torch.where(active, b0 + seg_id, prev_box)
        leaf_box = torch.where(leaf_level == level, box_of_cur, leaf_box)
        prev_box = box_of_cur
    out["leaf_box"] = leaf_box
    return out


def _exclusive_cumsum(x):
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def box_levels(codes_s, leaf_level, bbox_min, root_extent, *, dimensions,
               depth, level_starts, has_extents=False):
    """The per-box arrays of a tree from its sorted keys and leaf levels.

    :arg codes_s: ``(n,)`` int64 keys in tree order: full-depth Morton keys
        ascending, or with extents the keys with the bits below each leaf
        level zeroed, after phase B's re-sort.
    :arg leaf_level: ``(n,)`` int32 leaf levels in the same order.
    :arg bbox_min: ``(d,)`` root box corner, the coordinates' dtype.
    :arg root_extent: 0-d root box edge, the same dtype.
    :arg level_starts: the first box of every level, host ints.
    :returns: a dict of the per-box arrays (``box_morton``, ``box_level``,
        ``box_start``, ``box_count_cumul``, ``box_count_nonchild``,
        ``box_has_children``, ``box_parent``, ``box_child``,
        ``box_centers``) and each particle's ``leaf_box``.

    CPU tensors take :func:`box_levels_plain`.  CUDA tensors launch K44
    (``csrc/tree.cu``) once a level, over that level's box starts'
    inclusive scan (a library ``cumsum``; with extents also the cumulative
    count of the particles below the level), and read nothing back.
    """
    if codes_s.device.type == "cpu":
        return box_levels_plain(codes_s, leaf_level, bbox_min, root_extent,
                                dimensions=dimensions, depth=depth,
                                level_starts=level_starts,
                                has_extents=has_extents)
    cdt = bbox_min.dtype
    kernels.check_tensors(codes_s, dtype=torch.int64)
    leaf_level = leaf_level.to(torch.int32).contiguous()
    bbox_min = bbox_min.contiguous()
    root_extent = root_extent.to(cdt).reshape(1).contiguous()
    kernels.check_tensors(bbox_min, root_extent, dtype=cdt)
    n = codes_s.shape[0]
    d = dimensions
    dev = codes_s.device
    cap = level_starts[-1]
    out = _box_arrays(cap, n, d, cdt, dev)
    prev_box = torch.zeros(n, dtype=torch.int32, device=dev)
    prev_leaf = torch.cat([leaf_level.new_full((1,), -1), leaf_level[:-1]])
    thr = torch.minimum(lcp_levels(codes_s, d, depth),
                        prev_leaf.to(torch.int64)).to(torch.int32)
    cum_ge = cum_gt = codes_s   # placeholders without extents
    if has_extents:
        cum_ge = torch.arange(n + 1, dtype=torch.int64, device=dev)
    for level in range(len(level_starts) - 1):
        b0, b1 = level_starts[level], level_starts[level + 1]
        if has_extents:
            cum_gt = _exclusive_cumsum((leaf_level > level).to(torch.int64))
        if b1 > b0:
            seg = torch.cumsum((leaf_level >= level) & (thr < level), 0,
                               dtype=torch.int32)
            kernels.launch(
                "tree_level_boxes", cdt, codes_s, n, leaf_level, thr, seg,
                cum_ge, cum_gt, int(has_extents), level, b0, cap, d, depth,
                bbox_min, root_extent, out["box_morton"], out["box_level"],
                out["box_start"], out["box_count_cumul"],
                out["box_count_nonchild"], out["box_has_children"],
                out["box_parent"], out["box_child"], out["box_centers"],
                prev_box, out["leaf_box"])
        if has_extents:
            cum_ge = cum_gt
    return out

# }}}


# {{{ K46: boxes per level after the restriction

def level_box_counts_plain(codes_s, leaf_level, *, dimensions, depth,
                           max_level):
    """Plain twin of :func:`level_box_counts`: one masked sum a level."""
    counts = torch.zeros(depth + 2, dtype=torch.int64,
                         device=codes_s.device)
    for level in range(max_level + 1):
        is_start, _ = run_starts(codes_s, leaf_level, level, dimensions,
                                 depth)
        counts[level] = is_start.sum()
    return counts


def level_box_counts(codes_s, leaf_level, *, dimensions, depth, max_level):
    """Runs of active particles per level, ``(depth + 2,)`` int64: the
    boxes of every level up to *max_level* of a consistent tree
    (``boxtree_tpu/tree/level_restrict.py:122-133``).

    CPU tensors take :func:`level_box_counts_plain`; CUDA tensors launch
    K46 (``csrc/tree.cu``) once for all levels.
    """
    if codes_s.device.type == "cpu":
        return level_box_counts_plain(codes_s, leaf_level,
                                      dimensions=dimensions, depth=depth,
                                      max_level=max_level)
    kernels.check_tensors(codes_s, dtype=torch.int64)
    leaf_level = leaf_level.to(torch.int32).contiguous()
    counts = torch.zeros(depth + 2, dtype=torch.int64,
                         device=codes_s.device)
    kernels.launch("level_box_counts", None, codes_s, codes_s.shape[0],
                   leaf_level, dimensions, depth, max_level, counts)
    return counts

# }}}
