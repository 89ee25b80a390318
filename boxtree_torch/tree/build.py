"""Sort-based adaptive tree build in PyTorch.

Port of :mod:`boxtree_tpu.tree.build` (``boxtree_tpu/tree/build.py:45-553,
583-816``) for the adaptive and the adaptive-level-restricted kinds, the
adaptive kind also with particle extents (radii):

1. Every particle's full-depth Morton key, packed with its index, comes
   from the K1 kernel (:func:`boxtree_torch.ops.morton.encode_points`) and
   is sorted once with ``torch.sort``.
2. :func:`_phase_a` assigns every particle its *leaf level* (the first
   level at which its box's refine weight is at most the maximum) and
   counts the boxes of every level.  With extents a particle also stops
   at its stick-out level (K12, :mod:`boxtree_torch.ops.extents`), and
   only particles that can still descend count toward a split.
   For the level-restricted kind, :mod:`.level_restrict` then raises
   leaf levels until touching leaves differ by at most one level.
3. :func:`_phase_b` materializes the per-box arrays level by level.  With
   extents the particles are first re-sorted so that each box's own
   ("nonchild") particles precede its subtree, and the boxes' particle
   bounding boxes follow (K13).

Without extents a shallow first attempt (the Morton depth that leaves room
for the packed index) is retried at the full depth when particles stay in
overfull boxes; at the full depth that raises :class:`MaxLevelsExceeded`.
Trees with extents always use the full depth.  Boxes are numbered
level-major and Morton-ordered within each level, as in the
reference.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from boxtree_torch import config
from boxtree_torch.ops import extents, morton
from boxtree_torch.tree.containers import Tree, box_flags_enum
from boxtree_torch.tree.level_restrict import restrict_leaf_levels

logger = logging.getLogger(__name__)


class MaxLevelsExceeded(RuntimeError):
    """Raised when the tree would need more levels than Morton keys can
    represent (mirrors ``boxtree_tpu.tree.build.MaxLevelsExceeded``)."""


_TREE_KINDS = ("adaptive", "adaptive-level-restricted", "non-adaptive")


def _segment_totals(vals, is_start):
    """Per-element totals of each row of *vals* ``(k, n)`` over its run of
    equal prefixes."""
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    nseg = int(seg[-1]) + 1
    totals = vals.new_zeros(vals.shape[0], nseg).index_add_(1, seg, vals)
    return totals[:, seg]


def _bit_length(x):
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


# {{{ phase A: sort + leaf-level assignment

def _root_box(coords, radii=None):
    """``(bbox_min, root_extent)`` of the root box around *coords*
    (``(d, n)``), each grown by its radius where *radii* are given
    (``boxtree_tpu/tree/build.py:138-141``)."""
    lo = coords - radii if radii is not None else coords
    hi = coords + radii if radii is not None else coords
    bbox_min = torch.amin(lo, dim=1)
    return bbox_min, (torch.max(torch.amax(hi, dim=1) - bbox_min)
                      * (1 + config.ROOT_EXTENT_STRETCH_FACTOR))


def _phase_a(coords, max_weight, *, dimensions, depth, radii=None,
             extent_norm=None, stick_out_factor=0.0):
    """Morton sort + leaf-level assignment + per-level box counts
    (``boxtree_tpu/tree/build.py:113-247``, adaptive, unit refine
    weights); *radii* (``(n,)``) give the particles extents.

    :returns: ``(codes_s, order, leaf_level, counts, n_unfit, bbox_min,
        root_extent)``; ``counts[l]`` is the number of boxes at level
        ``l``, ``n_unfit`` the number of particles still in overfull boxes
        at depth ``depth``.
    """
    n = coords.shape[1]
    dev = coords.device
    has_extents = radii is not None
    bbox_min, root_extent = _root_box(coords, radii)

    iota_bits = max(1, int(n - 1).bit_length())
    if dimensions * depth + iota_bits <= 63:
        # the tie-break index packed into the low bits: one key-only sort
        packed = torch.sort(morton.encode_points(
            coords, bbox_min, root_extent, depth, iota_bits)).values
        codes_s = packed >> iota_bits
        order = (packed & ((1 << iota_bits) - 1)).to(torch.int32)
    else:
        codes = morton.encode_points(coords, bbox_min, root_extent, depth)
        codes_s, order = torch.sort(codes, stable=True)
        order = order.to(torch.int32)
    if has_extents:
        stick_s = extents.stick_levels(
            coords, radii, bbox_min, root_extent, dimensions=dimensions,
            depth=depth, extent_norm=extent_norm,
            stick_out_factor=stick_out_factor)[order.to(torch.int64)]

    ones = torch.ones(1, n, dtype=torch.int64, device=dev)
    counts = torch.zeros(depth + 2, dtype=torch.int64, device=dev)
    assigned = torch.zeros(n, dtype=torch.bool, device=dev)
    leaf_level = torch.full((n,), depth, dtype=torch.int32, device=dev)
    level = 0
    while level <= depth and not bool(assigned.all()):
        active = ~assigned
        pfx = codes_s >> (dimensions * (depth - level))
        is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                              pfx[1:] != pfx[:-1]])
        if has_extents:
            # a split counts only particles that can still descend; a box
            # exists while it holds an active particle
            w, n_active = _segment_totals(
                torch.stack([active & (stick_s > level), active]).to(
                    torch.int64), is_start)
            counts[level] = (is_start & (n_active > 0)).sum()
            done = active & ((w <= max_weight) | (stick_s <= level))
        else:
            w = _segment_totals(ones, is_start)[0]
            counts[level] = (is_start & active).sum()
            done = active & (w <= max_weight)
        leaf_level = torch.where(done, torch.full_like(leaf_level, level),
                                 leaf_level)
        assigned = assigned | done
        level += 1
    n_unfit = int((~assigned).sum())
    return (codes_s, order, leaf_level, counts, n_unfit, bbox_min,
            root_extent)

# }}}


# {{{ phase B: materialize box arrays

def _exclusive_cumsum(x):
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def _phase_b(codes_s, order, leaf_level, merged_coords, bbox_min,
             root_extent, *, dimensions, depth, level_starts, nsources,
             ntargets, sources_are_targets, has_extents=False):
    """Per-box arrays from the sorted keys and leaf levels
    (``boxtree_tpu/tree/build.py:262-530``).

    Without extents, particle i starts a level-L box exactly for the
    levels in ``(thr[i], leaf_level[i]]`` with ``thr[i] =
    min(lcp_level[i], leaf_level[i-1])``, where ``lcp_level`` is the
    deepest level at which i shares its Morton prefix with i-1; a box's
    subtree ends at the next position whose prefix changes at or above
    its level.  With extents, the particles are first sorted by (Morton
    key with the bits below the leaf level zeroed, leaf level), stably, so
    that each box's own particles precede its subtree; a level-L box then
    starts at an active particle whose prefix differs from its
    predecessor's or whose predecessor is inactive, and its counts are
    differences of cumulative counts of the particles with leaf level
    ``>= L`` and ``> L`` (``:272-284, 333-379``).
    """
    nlevels = len(level_starts) - 1
    d = dimensions
    n = codes_s.shape[0]
    nchild = 2 ** d
    dev = codes_s.device
    cdt = merged_coords.dtype
    cap = level_starts[-1]

    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    box_morton = zeros(cap, dtype=torch.int64)
    box_level = zeros(cap, dtype=torch.int32)
    box_start = zeros(cap, dtype=torch.int64)
    box_count_cumul = zeros(cap, dtype=torch.int64)
    box_count_nonchild = zeros(cap, dtype=torch.int64)
    box_has_children = zeros(cap, dtype=torch.bool)
    box_parent = zeros(cap, dtype=torch.int32)
    box_child = zeros(nchild, cap, dtype=torch.int32)
    box_centers = zeros(d, cap, dtype=cdt)

    prev_box = zeros(n, dtype=torch.int32)
    leaf_box = zeros(n, dtype=torch.int32)

    leaf64 = leaf_level.to(torch.int64)
    if has_extents:
        shift_bits = d * (depth - leaf64)
        masked = (codes_s >> shift_bits) << shift_bits
        # stable sort by (masked key, leaf level): the second key first
        perm = torch.sort(leaf_level, stable=True).indices
        perm = perm[torch.sort(masked[perm], stable=True).indices]
        codes_s, order = masked[perm], order[perm]
        leaf_level, leaf64 = leaf_level[perm], leaf64[perm]
        # active-particle prefix counts telescope across levels: the
        # "deeper" count of one level is the "active" count of the next
        cum_ge = torch.arange(n + 1, dtype=torch.int64, device=dev)
    else:
        iota64 = torch.arange(n, dtype=torch.int64, device=dev)
        xor = torch.cat([
            torch.full((1,), -1, dtype=torch.int64, device=dev),
            codes_s[1:] ^ codes_s[:-1]])
        lcp_level = depth - (_bit_length(xor) + d - 1) // d
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
            pfx = codes_s >> shift
            prev_active = torch.cat([active.new_zeros(1), active[:-1]])
            diff = torch.cat([active.new_ones(1), pfx[1:] != pfx[:-1]])
            is_start = active & (diff | ~prev_active)
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
        box_morton[b0:b1] = pfx_l
        box_level[b0:b1] = level
        box_start[b0:b1] = reps_l
        box_count_cumul[b0:b1] = cumul_l
        box_count_nonchild[b0:b1] = cumul_l - deeper_l
        box_has_children[b0:b1] = deeper_l > 0

        cells = morton.deinterleave(pfx_l, d)
        size = root_extent.to(cdt) / (1 << level)
        box_centers[:, b0:b1] = (bbox_min[:, None].to(cdt)
                                 + (cells.to(cdt) + 0.5) * size)

        if level > 0:
            parent_l = prev_box[reps_l]
            box_parent[b0:b1] = parent_l
            digit_l = pfx_l & (nchild - 1)
            box_child[digit_l, parent_l.to(torch.int64)] = torch.arange(
                b0, b1, dtype=torch.int32, device=dev)

        box_of_cur = torch.where(active, b0 + seg_id, prev_box)
        leaf_box = torch.where(leaf_level == level, box_of_cur, leaf_box)
        prev_box = box_of_cur

    # {{{ source/target split

    pid = config.particle_id_dtype
    if sources_are_targets:
        is_source_s = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        is_source_s = order < nsources

    def box_ranges(member):
        cum = _exclusive_cumsum(member.to(torch.int64))
        starts = cum[box_start]
        return (starts,
                cum[box_start + box_count_cumul] - starts,
                cum[box_start + box_count_nonchild] - starts)

    (box_source_starts, box_source_counts_cumul,
     box_source_counts_nonchild) = box_ranges(is_source_s)

    order64 = order.to(torch.int64)
    if sources_are_targets:
        user_source_ids = order.to(pid)
        box_id_of_source = leaf_box
        sources = merged_coords[:, order64]
        box_target_starts = box_source_starts
        box_target_counts_cumul = box_source_counts_cumul
        box_target_counts_nonchild = box_source_counts_nonchild
        targets = sources
        box_id_of_target = box_id_of_source
        user_target_ids = order64
    else:
        user_source_ids = order[is_source_s].to(pid)
        box_id_of_source = leaf_box[is_source_s]
        sources = merged_coords[:, user_source_ids.to(torch.int64)]
        is_target_s = ~is_source_s
        (box_target_starts, box_target_counts_cumul,
         box_target_counts_nonchild) = box_ranges(is_target_s)
        user_target_ids = order64[is_target_s] - nsources
        box_id_of_target = leaf_box[is_target_s]
        targets = merged_coords[:, nsources + user_target_ids]
    # user target id -> tree-order position (inverse permutation)
    sorted_target_ids = torch.empty(ntargets, dtype=pid, device=dev)
    sorted_target_ids[user_target_ids] = torch.arange(
        ntargets, dtype=pid, device=dev)

    # }}}

    # {{{ box flags (boxtree_tpu/tree/build.py:488-506)

    F = box_flags_enum

    def flag(cond, bit):
        return torch.where(cond, bit, 0).to(torch.int32)

    flags = (flag(box_has_children
                  & (box_source_counts_cumul > box_source_counts_nonchild),
                  F.HAS_SOURCE_CHILD_BOXES)
             | flag(box_has_children
                    & (box_target_counts_cumul
                       > box_target_counts_nonchild),
                    F.HAS_TARGET_CHILD_BOXES)
             | flag(box_source_counts_nonchild > 0, F.IS_SOURCE_BOX)
             | flag(box_target_counts_nonchild > 0, F.IS_TARGET_BOX)
             | flag(~box_has_children, F.IS_LEAF_BOX))

    # }}}

    return dict(
        user_target_ids=user_target_ids,
        box_morton=box_morton,
        box_level=box_level,
        box_parent=box_parent,
        box_child=box_child,
        box_centers=box_centers,
        box_flags=flags,
        box_source_starts=box_source_starts.to(pid),
        box_source_counts_cumul=box_source_counts_cumul.to(pid),
        box_source_counts_nonchild=box_source_counts_nonchild.to(pid),
        box_target_starts=box_target_starts.to(pid),
        box_target_counts_cumul=box_target_counts_cumul.to(pid),
        box_target_counts_nonchild=box_target_counts_nonchild.to(pid),
        user_source_ids=user_source_ids,
        sorted_target_ids=sorted_target_ids,
        sources=sources,
        targets=targets,
        box_id_of_source=box_id_of_source,
        box_id_of_target=box_id_of_target,
    )

# }}}


# {{{ host driver

def _default_device(particles):
    """The device of a tree whose caller names none: a tensor's own (or
    that of a list of tensors), else the CUDA device.  Without one, a
    non-tensor input raises rather than landing on the CPU unasked."""
    if isinstance(particles, torch.Tensor):
        return particles.device
    if (isinstance(particles, (list, tuple)) and particles
            and all(isinstance(p, torch.Tensor) for p in particles)):
        return particles[0].device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "build_tree: no CUDA device for these particles; pass "
            "device='cpu' to build the tree on the CPU")
    return torch.device("cuda")


def _as_coord_tensor(particles, device):
    if device is None:
        device = _default_device(particles)
    if isinstance(particles, (list, tuple)):
        particles = torch.stack([torch.as_tensor(p) for p in particles])
    if isinstance(particles, torch.Tensor):
        arr = particles
    else:
        arr = torch.as_tensor(np.asarray(particles))
    arr = arr.to(device)
    if arr.ndim != 2:
        raise ValueError("particles must be (dimensions, nparticles)")
    if arr.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported coordinate dtype {arr.dtype}")
    return arr.contiguous()


def build_tree(particles, kind="adaptive", max_particles_in_box=None,
               targets=None, source_radii=None, target_radii=None,
               stick_out_factor=None, refine_weights=None,
               max_leaf_refine_weight=None, extent_norm=None, bbox=None,
               debug=False, *, device=None):
    """Build a :class:`Tree` of *particles* (``(dimensions, n)``).

    The arguments are those of ``boxtree_tpu.build_tree``; the tree lives
    on *device*.  When *device* is None, a tensor input keeps its own
    device and any other input (numpy, lists) goes to the CUDA device;
    without one that raises, and ``device="cpu"`` builds on the CPU.
    This port covers the adaptive and the adaptive-level-restricted kinds,
    refined by ``max_particles_in_box``, in the bounding box of the
    particles.  The adaptive kind also takes extents: *source_radii* and
    *target_radii* (which need *targets*), *stick_out_factor* and
    *extent_norm* (``"linf"``, the default, or ``"l2"``); the tree then
    carries the radii and the boxes' source and target bounding boxes.
    The non-adaptive kind, extents with another kind, ``refine_weights``
    and a given ``bbox`` raise :class:`NotImplementedError`.
    """
    if kind not in _TREE_KINDS:
        raise ValueError(f"unknown tree kind: '{kind}'")
    if kind == "non-adaptive":
        raise NotImplementedError(f"tree kind '{kind}' is not ported yet")
    sources_have_extent = source_radii is not None
    targets_have_extent = target_radii is not None
    has_extents = sources_have_extent or targets_have_extent
    if has_extents:
        # boxtree_tpu/tree/build.py:613-623
        if targets is None:
            raise ValueError(
                "must specify targets when specifying any kind of radii")
        if kind != "adaptive":
            raise NotImplementedError(
                "extents currently require kind='adaptive'")
        if extent_norm is None:
            extent_norm = "linf"
        if extent_norm not in ("linf", "l2"):
            raise ValueError(f"unexpected extent_norm: {extent_norm}")
    if stick_out_factor is None:
        stick_out_factor = 0.0
    if refine_weights is not None or max_leaf_refine_weight is not None:
        raise NotImplementedError("refine_weights is not ported yet")
    if bbox is not None:
        raise NotImplementedError("a given bbox is not ported yet")
    if max_particles_in_box is None:
        raise ValueError("must specify max_particles_in_box")

    coords = _as_coord_tensor(particles, device)
    dev = coords.device
    dimensions, nsources = coords.shape
    coord_dtype = coords.dtype
    sources_are_targets = targets is None
    if targets is not None:
        tgt_coords = _as_coord_tensor(targets, dev)
        if tgt_coords.dtype != coord_dtype:
            raise TypeError("sources and targets must have the same dtype")
        ntargets = tgt_coords.shape[1]
        merged = torch.cat([coords, tgt_coords], dim=1)
    else:
        ntargets = nsources
        merged = coords
    n = merged.shape[1]
    if n == 0:
        raise ValueError("cannot build a tree from zero particles")

    merged_radii = None
    if has_extents:
        def radii_of(radii, count):
            if radii is None:
                return torch.zeros(count, dtype=coord_dtype, device=dev)
            if not isinstance(radii, torch.Tensor):
                radii = torch.as_tensor(np.asarray(radii))
            return radii.to(device=dev, dtype=coord_dtype)
        sr = radii_of(source_radii, nsources)
        tr = radii_of(target_radii, ntargets)
        merged_radii = torch.cat([sr, tr]).contiguous()

    max_weight = int(max_particles_in_box)

    depth_full = config.max_morton_depth(dimensions)
    # shallow first try so the sort's tie-break index packs into the key;
    # a distribution needing more levels retries at the full depth.  Trees
    # with extents always take the full depth: a shallower stick level
    # would change the tree, not fail (boxtree_tpu/tree/build.py:680-728)
    iota_bits = max(1, int(n - 1).bit_length())
    if has_extents:
        depth = depth_full
    else:
        depth = max(min(depth_full, (63 - iota_bits) // dimensions), 1)
    while True:
        (codes_s, order, leaf_level, counts, n_unfit, bbox_min,
         root_extent) = _phase_a(merged, max_weight, dimensions=dimensions,
                                 depth=depth, radii=merged_radii,
                                 extent_norm=extent_norm,
                                 stick_out_factor=stick_out_factor)
        if not n_unfit:
            break
        if depth < depth_full:
            depth = depth_full
            continue
        raise MaxLevelsExceeded(
            f"{n_unfit} particles remain in overfull boxes at the deepest "
            f"representable level ({depth})")

    counts = counts.cpu().numpy()
    if kind == "adaptive-level-restricted":
        leaf_level, counts, rounds = restrict_leaf_levels(
            codes_s, leaf_level, dimensions=dimensions, depth=depth,
            max_level=int(np.max(np.nonzero(counts)[0])))
        counts = counts.cpu().numpy()
        logger.info("build_tree: level restriction in %d rounds", rounds)
    nlevels = int(np.max(np.nonzero(counts)[0])) + 1
    level_starts = tuple(int(x) for x in np.concatenate(
        [[0], np.cumsum(counts[:nlevels])]))
    logger.info("build_tree: %d particles -> %d boxes, %d levels (%s)",
                n, level_starts[-1], nlevels, kind)

    out = _phase_b(
        codes_s, order, leaf_level, merged, bbox_min, root_extent,
        dimensions=dimensions, depth=depth, level_starts=level_starts,
        nsources=nsources, ntargets=ntargets,
        sources_are_targets=sources_are_targets, has_extents=has_extents)

    src_radii = tgt_radii = None
    sbb = tbb = (None, None)
    if has_extents:
        # radii in tree order, and the boxes' particle bounding boxes
        # (boxtree_tpu/tree/build.py:757-773)
        src_radii = sr[out["user_source_ids"].to(torch.int64)]
        tgt_radii = (src_radii if sources_are_targets
                     else tr[out["user_target_ids"]])

        def bounding_boxes(what, radii, have):
            return extents.box_extents(
                out[f"{what}s"], radii if have else None,
                out[f"box_{what}_starts"],
                out[f"box_{what}_counts_nonchild"], out["box_centers"],
                out["box_child"], lsb=level_starts)
        sbb = bounding_boxes("source", src_radii, sources_have_extent)
        tbb = bounding_boxes("target", tgt_radii, targets_have_extent)

    return Tree(
        root_extent=root_extent.to(coord_dtype),
        box_centers=out["box_centers"],
        box_parent_ids=out["box_parent"],
        box_child_ids=out["box_child"],
        box_levels=out["box_level"],
        box_flags=out["box_flags"],
        box_morton_prefixes=out["box_morton"],
        level_start_box_nrs=level_starts,
        box_id_dtype=config.box_id_dtype,
        box_level_dtype=config.box_level_dtype,
        coord_dtype=coord_dtype,
        sources_have_extent=sources_have_extent,
        targets_have_extent=targets_have_extent,
        extent_norm=extent_norm,
        stick_out_factor=float(stick_out_factor),
        _is_pruned=True,
        max_depth=depth,
        sources_are_targets=sources_are_targets,
        particle_id_dtype=config.particle_id_dtype,
        sources=out["sources"],
        source_radii=src_radii if sources_have_extent else None,
        targets=out["targets"],
        target_radii=tgt_radii if targets_have_extent else None,
        user_source_ids=out["user_source_ids"],
        sorted_target_ids=out["sorted_target_ids"],
        box_source_starts=out["box_source_starts"],
        box_source_counts_nonchild=out["box_source_counts_nonchild"],
        box_source_counts_cumul=out["box_source_counts_cumul"],
        box_target_starts=out["box_target_starts"],
        box_target_counts_nonchild=out["box_target_counts_nonchild"],
        box_target_counts_cumul=out["box_target_counts_cumul"],
        box_source_bounding_box_min=sbb[0],
        box_source_bounding_box_max=sbb[1],
        box_target_bounding_box_min=tbb[0],
        box_target_bounding_box_max=tbb[1],
        box_id_of_source=out["box_id_of_source"],
        box_id_of_target=out["box_id_of_target"],
    )


class TreeBuilder:
    """Callable wrapper around :func:`build_tree`, for the public name of
    ``boxtree_tpu``'s (``boxtree_tpu/tree/build.py:819-832``): stateless;
    a leading argument that is no array (an array context) is dropped."""

    ROOT_EXTENT_STRETCH_FACTOR = config.ROOT_EXTENT_STRETCH_FACTOR

    def __init__(self, actx=None):
        pass

    def __call__(self, *args, **kwargs):
        if args and not hasattr(args[0], "shape") \
                and not isinstance(args[0], (list, tuple, np.ndarray)):
            args = args[1:]
        return build_tree(*args, **kwargs)

# }}}
