"""The sharded tree build over a :class:`~boxtree_torch.parallel.mesh.Mesh`
of rank slots.

Port of the tree half of :mod:`boxtree_tpu.parallel.shard_build`
(``shard_build.py:1-1330``) for the adaptive kind with sources as targets,
no extents and unit refine weights: per-shard Morton codes (K1), the
distributed key-value sample sort and rebalance
(:mod:`~boxtree_torch.parallel.shard_sort`, K83 / K84), sharded phase A
(K87), the per-shard box skeleton of sharded phase B (K88), the O(nboxes)
assembly of the box arrays, and the particles routed into tree order by
the distributed permutation (K83, K85, K86).  Each rank holds
``n / nranks`` particles, plus its padded send and receive buffers
(``capacity_factor`` times that), until the assembly.

The reference's chain of per-shard summaries (``_chain_seg_quantities``,
``shard_build.py:53-152``) is here :func:`boxtree_torch.ops.shard.
leaf_summary` with the halo sums in K87, and
:func:`~boxtree_torch.ops.shard.skeleton_summary` with the chain in K88.

Not ported yet, each refused with :class:`NotImplementedError` naming
ROADMAP Queue 1 #8 "Next" (1): the non-adaptive and the level-restricted
kinds (``sharded_restrict_leaf_levels``, jit ``:568``), separate targets
(the sources flag of the skeleton), and extents (the stick levels of jit
``:1023`` and the ``num_keys=2`` re-sort of ``:1081-1111``).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from boxtree_torch import config
from boxtree_torch.ops import morton, shard
from boxtree_torch.ops.tree import lcp_levels
from boxtree_torch.parallel.shard_sort import (
    as_mesh,
    sharded_key_sort,
    sharded_permute,
    sharded_rebalance,
    shards_of,
)
from boxtree_torch.tree.build import (
    _TREE_KINDS,
    MaxLevelsExceeded,
    _as_coord_tensor,
    box_flags,
)
from boxtree_torch.tree.containers import Tree

logger = logging.getLogger(__name__)

#: the keys of :func:`sharded_box_skeleton`'s dict (``shard_build.py:
#: 895-896``)
SKELETON_KEYS = ("box_id", "box_morton", "box_level", "box_start",
                 "box_count_cumul", "box_parent", "box_child", "nboxes")


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to the sharded build yet (ROADMAP Queue 1 "
        "#8, 'Next' (1))")


def sharded_morton_codes(coords, mesh, *, depth=None, radii=None):
    """Per-shard Morton codes in the bounding box of all the particles
    (``shard_build.py:154``): each rank's minimum and maximum, gathered and
    reduced, give the root box of ``build_tree``'s ``_root_box`` exactly
    (float minima and maxima are exact), and K1 encodes each shard.

    :arg coords: ``(dimensions, n)`` float tensor, n divisible by the
        ranks; rank *r* takes the particles ``r * per .. (r + 1) * per -
        1``.
    :returns: ``(codes, bbox_min, root_extent)``: per-rank ``(per,)`` int64
        codes, and the root box as tensors on rank 0's device.
    """
    if radii is not None:
        raise _not_ported("radii (extent trees)")
    coords = torch.as_tensor(coords)
    dims, n = coords.shape
    nranks = mesh.size
    if n % nranks:
        raise ValueError(f"n={n} not divisible by nranks={nranks}")
    per = n // nranks
    if depth is None:
        depth = config.max_morton_depth(dims)
    blocks = [coords[:, r * per:(r + 1) * per].to(d).contiguous()
              for r, d in enumerate(mesh.devices)]
    lo = mesh.all_gather([torch.amin(b, dim=1) for b in blocks])
    hi = mesh.all_gather([torch.amax(b, dim=1) for b in blocks])
    box, codes = {}, []
    for r, d in enumerate(mesh.devices):
        if d not in box:
            bbox_min = torch.amin(lo[r], dim=0)
            box[d] = (bbox_min, torch.max(torch.amax(hi[r], dim=0) - bbox_min)
                      * (1 + config.ROOT_EXTENT_STRETCH_FACTOR))
        codes.append(morton.encode_points(blocks[r], *box[d], depth))
    return (codes, *box[mesh.devices[0]])


def sharded_leaf_levels(codes_s, weights_s, mesh, *, max_weight,
                        dimensions, depth, adaptive=True, stick_s=None):
    """Leaf levels over shard-sorted Morton keys (``shard_build.py:215``),
    the adaptive kind: every rank's boundary summary (library
    ``searchsorted``s), one ``all_gather`` of them, then K87 once a rank;
    the ranks' counts are summed on rank 0's device and read once.

    :arg codes_s: ``(n,)`` int64 globally sorted keys, or their shards.
    :arg weights_s: ``(n,)`` refine weights in the same order (or their
        shards), or None for unit weights.
    :returns: ``(leaf_level, counts_and_unfit)``: per-rank ``(per,)``
        int32 leaf levels, and a ``(depth + 3,)`` int64 CPU tensor of the
        boxes of every level ``0 .. depth + 1`` and the particles left in
        overfull boxes at *depth*, equal to ``_phase_a``'s.
    """
    if not adaptive:
        raise _not_ported("the non-adaptive kind")
    if stick_s is not None:
        raise _not_ported("stick levels (extent trees)")
    codes = shards_of(codes_s, mesh)
    cumw = ([shard.cumulative_weights(w) for w in shards_of(weights_s, mesh)]
            if weights_s is not None else [None] * mesh.size)
    masks, summs = {}, []
    for r, d in enumerate(mesh.devices):
        if d not in masks:
            masks[d] = shard.level_masks(dimensions, depth, d)
        summs.append(shard.leaf_summary(codes[r], cumw[r], masks[d]))
    summs = mesh.all_gather(summs)
    leaf, packed = [], []
    for r in range(mesh.size):
        lf, pk = shard.shard_leaf_levels(codes[r], cumw[r], summs[r], r,
                                         max_weight, dimensions=dimensions,
                                         depth=depth)
        leaf.append(lf)
        packed.append(pk)
    return leaf, mesh.gather(packed).sum(0).cpu()


def _continuation_levels(codes, leaf, mesh, dimensions, depth):
    """Per rank, ``(per,)`` int32: the deepest level at which each particle
    continues its predecessor's box (``thr`` of K44), the first particle
    against the left rank's last (one ``ppermute``), -1 on rank 0's
    first."""
    nranks = mesh.size
    edge = mesh.ppermute(
        [torch.stack([c[-1], lf[-1].to(torch.int64)])
         for c, lf in zip(codes, leaf)],
        [(r, r + 1) for r in range(nranks - 1)])
    thr = []
    for r in range(nranks):
        c, lf = codes[r], leaf[r].to(torch.int64)
        if r == 0:
            lcp = lcp_levels(c, dimensions, depth)
            prev = torch.cat([lf.new_full((1,), -1), lf[:-1]])
        else:
            lcp = lcp_levels(torch.cat([edge[r][:1], c]), dimensions,
                             depth)[1:]
            prev = torch.cat([edge[r][1:], lf[:-1]])
        thr.append(torch.minimum(lcp, prev).clamp(min=-1).to(torch.int32))
    return thr


def _skeleton_cap(counts, per):
    """The level count and the rows of a rank's skeleton
    (``shard_build.py:657-664``): a level's box starts are distinct
    particles, so a rank holds at most ``min(per, counts[l])`` boxes of
    level *l*, plus one spanning its boundary a level."""
    nlevels = (int(np.max(np.nonzero(counts)[0])) + 1 if counts.any()
               else 1)
    level_starts = np.concatenate([[0], np.cumsum(counts[:nlevels])])
    cap = int(min(level_starts[-1],
                  sum(int(min(per, counts[lev])) for lev in range(nlevels))
                  + nlevels))
    return nlevels, [int(x) for x in level_starts], cap


def sharded_box_skeleton(codes_s, leaf_level, counts, mesh, *, dimensions,
                         depth, is_src_s=None, with_extents=False):
    """Per-shard phase B (``shard_build.py:597``): every rank builds the
    rows of the boxes whose first particle is in its shard, level by
    level: two library ``cumsum``s and a summary row a rank, one
    ``all_gather`` of the rows, then K88 once a rank.

    :arg counts: the ``(depth + 3,)`` counts and unfit count of
        :func:`sharded_leaf_levels` (host values).
    :returns: a dict of per-rank lists (rows padded to one capacity):
        ``box_id`` (global id, -1 for a pad), ``box_morton``,
        ``box_level``, ``box_start`` (global first particle),
        ``box_count_cumul``, ``box_parent`` (global id, -1 for the root),
        ``box_child`` (``(cap, 2^d)`` global ids, -1 where absent), and
        ``nboxes`` (0-d tensors, the valid rows).
    """
    if is_src_s is not None:
        raise _not_ported("separate targets (the sources flag)")
    if with_extents:
        raise _not_ported("extents")
    nranks = mesh.size
    codes = shards_of(codes_s, mesh)
    leaf = [lf.to(torch.int32) for lf in shards_of(leaf_level, mesh)]
    per = codes[0].shape[0]
    nchild = 2 ** dimensions
    counts = np.asarray(counts.tolist() if isinstance(counts, torch.Tensor)
                        else counts)[:-1]
    nlevels, level_starts, cap = _skeleton_cap(counts, per)
    thr = _continuation_levels(codes, leaf, mesh, dimensions, depth)

    out, rowbase = [], []
    for d in mesh.devices:
        def full(*shape, fill=0, dtype=torch.int64):
            return torch.full(shape, fill, dtype=dtype, device=d)
        out.append(dict(
            box_id=full(cap, fill=-1), box_morton=full(cap),
            box_level=full(cap, dtype=torch.int32), box_start=full(cap),
            box_count_cumul=full(cap), box_parent=full(cap, fill=-1),
            box_child=full(cap, nchild, fill=-1)))
        rowbase.append(full(nlevels + 1))
    prev_cs, prev_summ = [None] * nranks, [None] * nranks
    for level in range(nlevels):
        cs_ca = [shard.level_starts_and_counts(leaf[r], thr[r], level)
                 for r in range(nranks)]
        summs = []
        for r in range(nranks):
            cs, ca = cs_ca[r]
            summs.append(shard.skeleton_summary(
                codes[r], leaf[r], cs, ca, prev_cs[r], level,
                dimensions=dimensions, depth=depth))
            rowbase[r][level + 1:level + 2] = rowbase[r][level:level + 1] \
                + cs[-1:]
        summs = mesh.all_gather(summs)
        for r in range(nranks):
            cs, ca = cs_ca[r]
            shard.shard_box_skeleton(
                codes[r], leaf[r], thr[r], cs, ca, prev_cs[r], summs[r],
                prev_summ[r], rowbase[r], out[r], rank=r, level=level,
                b0=level_starts[level],
                prev_lstart=level_starts[level - 1] if level else 0,
                base=r * per, dimensions=dimensions, depth=depth)
        prev_cs, prev_summ = [cs for cs, _ in cs_ca], summs
    skel = {key: [o[key] for o in out] for key in SKELETON_KEYS[:-1]}
    skel["nboxes"] = [rb[nlevels] for rb in rowbase]
    return skel


def _assemble_boxes(skel, mesh, level_starts, bbox_min, root_extent,
                    dimensions, coord_dtype):
    """The box arrays of the tree from the ranks' skeleton rows, on rank
    0's device (``shard_build.py:1120-1193``): every rank's rows scattered
    to their global ids, then children, centres, counts and flags as
    ``build_tree`` computes them."""
    nboxes = level_starts[-1]
    ids = mesh.gather(skel["box_id"]).reshape(-1)
    slot = torch.where(ids >= 0, ids, nboxes)

    def gathered(key):
        vals = mesh.gather(skel[key])
        vals = vals.reshape(-1, *vals.shape[2:])
        full = vals.new_empty((nboxes + 1, *vals.shape[1:]))
        full[slot] = vals
        return full[:nboxes]

    box_morton = gathered("box_morton")
    box_level = gathered("box_level").to(config.box_level_dtype)
    box_start = gathered("box_start")
    box_cumul = gathered("box_count_cumul")
    box_parent = gathered("box_parent")
    box_parent[0] = 0                  # the root, as phase B has it
    box_child = gathered("box_child")
    has_children = (box_child >= 0).any(dim=1)
    box_child = torch.where(box_child < 0, 0, box_child).T.to(
        config.box_id_dtype).contiguous()
    cells = morton.deinterleave(box_morton, dimensions).to(coord_dtype)
    size = root_extent.to(coord_dtype) / torch.bitwise_left_shift(
        torch.ones_like(box_morton), box_level.to(torch.int64)).to(
            coord_dtype)
    centers = bbox_min.to(coord_dtype)[:, None] + (cells + 0.5) * size
    nonchild = torch.where(has_children, 0, box_cumul)
    return dict(
        box_centers=centers,
        box_parent_ids=box_parent.to(config.box_id_dtype),
        box_child_ids=box_child, box_levels=box_level,
        box_flags=box_flags(has_children, box_cumul, nonchild, box_cumul,
                            nonchild),
        box_morton_prefixes=box_morton, box_start=box_start,
        box_cumul=box_cumul, nonchild=nonchild)


def _leaf_box_ids(boxes, mesh, per):
    """Each particle's leaf box: one library ``searchsorted`` a rank over
    the leaf boxes' starts (``shard_build.py:1216-1238``), sorted on rank
    0's device and given to every rank; the ranks' results concatenated
    on rank 0's device."""
    starts = torch.where(boxes["nonchild"] > 0, boxes["box_start"],
                         shard.PAD)
    starts, leaves = torch.sort(starts)
    starts = mesh.broadcast(starts)
    leaves = mesh.broadcast(leaves.to(config.box_id_dtype))
    out = []
    for r, d in enumerate(mesh.devices):
        i = r * per + torch.arange(per, dtype=torch.int64, device=d)
        out.append(leaves[r][torch.searchsorted(starts[r], i, right=True)
                             - 1])
    return mesh.gather(out).reshape(-1)


def sharded_build_tree(particles, mesh, *, max_particles_in_box,
                       kind="adaptive", targets=None, source_radii=None,
                       target_radii=None, stick_out_factor=None,
                       extent_norm=None, return_skeleton=False, device=None,
                       timing_data=None):
    """Build a :class:`~boxtree_torch.tree.containers.Tree` through the
    sharded pipeline (``shard_build.py:912``): per-shard Morton codes,
    the distributed key-value sample sort, the rebalance, sharded leaf
    levels, the per-shard box skeleton, the assembly of the O(nboxes) box
    arrays on rank 0's device, and the coordinates routed into tree order
    by the distributed permutation (whose inverse is
    ``sorted_target_ids``).

    :arg particles: ``(dimensions, n)`` coordinates, n divisible by the
        ranks; a tensor keeps its device, anything else goes to the card
        unless *device* says otherwise.
    :arg mesh: a :class:`~boxtree_torch.parallel.mesh.Mesh`, or a number
        of ranks on the particles' device (``Mesh.of_ranks``).
    :arg timing_data: a dict, or None; a dict gets the seconds of every
        stage (``stage_s``: the devices synchronised after each), the
        capacity factors and the radius used, and the depth.

    The tree equals :func:`boxtree_torch.build_tree`'s field for field:
    the keys take the same depth (the shallow first try of ``build_tree``,
    so that particles sharing a cell there keep their input order, retried
    at the full depth when a box stays overfull), and every stage
    reproduces the single-device conventions.  A capacity or radius retry
    is the reference's loop, and is logged as a warning.  The particle
    arrays of the tree are the ranks' shards concatenated on rank 0's
    device: a port :class:`Tree` lives on one device, so this is the one
    step that holds all n particles in one place.  On the card a build
    reads the host three times per depth tried: the sort's counts and
    flags, the leaf levels' counts, the permutation's flags; and once more
    for each capacity retry of the sort or the permutation.

    With *return_skeleton*, returns ``(tree, skel)``,
    *skel* the per-rank dict of :func:`sharded_box_skeleton`.
    """
    if kind not in _TREE_KINDS:
        raise ValueError(f"unknown tree kind: '{kind}'")
    if kind != "adaptive":
        raise _not_ported(f"the {kind} kind")
    if targets is not None:
        raise _not_ported("separate targets")
    if source_radii is not None or target_radii is not None:
        raise _not_ported("radii (extent trees)")
    coords = _as_coord_tensor(particles, device)
    mesh = as_mesh(mesh, coords.device)
    dims, n = coords.shape
    nranks = mesh.size
    if n == 0:
        raise ValueError("cannot build a tree from zero particles")
    if n % nranks:
        raise ValueError(f"n={n} not divisible by nranks={nranks}"
                         " (pad the input)")
    per = n // nranks
    depth_full = config.max_morton_depth(dims)
    iota_bits = max(1, int(n - 1).bit_length())
    depth = max(min(depth_full, (63 - iota_bits) // dims), 1)

    stage_s = {}
    t_last = [time.perf_counter()]

    def lap(name):
        if timing_data is None:
            return
        for d in set(mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        now = time.perf_counter()
        stage_s[name] = stage_s.get(name, 0.0) + now - t_last[0]
        t_last[0] = now

    lap("start")
    while True:
        codes, bbox_min, root_extent = sharded_morton_codes(
            coords, mesh, depth=depth)
        lap("codes")
        payload = [torch.arange(r * per, (r + 1) * per, device=d)
                   for r, d in enumerate(mesh.devices)]
        cf = 2.0
        for _ in range(6):
            merged, mvals, counts, ok = sharded_key_sort(
                codes, mesh, vals=payload, capacity_factor=cf)
            if ok:
                break
            logger.warning("sharded_build_tree: sample sort bucket overflow "
                           "at capacity_factor=%g", cf)
            cf *= 2
        else:
            raise RuntimeError("sample sort bucket overflow at "
                               f"capacity_factor={cf}")
        lap("sort")
        radius = 2
        while True:
            codes_s, order, ok = sharded_rebalance(
                merged, counts, mesh, radius=radius, vals=mvals)
            if ok:
                break
            if radius >= nranks:
                raise RuntimeError("rebalance radius exhausted")
            logger.warning("sharded_build_tree: rebalance radius %d too "
                           "small", radius)
            radius = min(2 * radius, nranks)
        del merged, mvals
        lap("rebalance")
        leaf, counts_and_unfit = sharded_leaf_levels(
            codes_s, None, mesh, max_weight=max_particles_in_box,
            dimensions=dims, depth=depth)
        lap("leaf_levels")
        n_unfit = int(counts_and_unfit[-1])
        if not n_unfit:
            break
        if depth < depth_full:
            depth = depth_full
            continue
        raise MaxLevelsExceeded(
            f"{n_unfit} particles remain in overfull boxes at the "
            f"deepest representable level ({depth})")

    skel = sharded_box_skeleton(codes_s, leaf, counts_and_unfit, mesh,
                                dimensions=dims, depth=depth)
    lap("skeleton")
    counts_h = counts_and_unfit[:-1].numpy()
    _, level_starts, _ = _skeleton_cap(counts_h, per)
    boxes = _assemble_boxes(skel, mesh, level_starts, bbox_min, root_extent,
                            dims, coords.dtype)
    lap("assembly")

    rows = [coords[:, r * per:(r + 1) * per].T.to(d).contiguous()
            for r, d in enumerate(mesh.devices)]
    pcf = 2.0
    for _ in range(6):
        src_sh, inv_sh, ok = sharded_permute(order, rows, mesh,
                                             capacity_factor=pcf)
        if ok:
            break
        logger.warning("sharded_build_tree: permutation bucket overflow at "
                       "capacity_factor=%g", pcf)
        pcf *= 2
    else:
        raise RuntimeError("sharded_permute capacity exhausted at "
                           f"capacity_factor={pcf}")
    pid = config.particle_id_dtype
    sources = mesh.gather(src_sh).reshape(n, dims).T.contiguous()
    sorted_target_ids = mesh.gather(inv_sh).reshape(-1).to(pid)
    user_source_ids = mesh.gather(order).reshape(-1).to(pid)
    lap("permute")
    box_id_of = _leaf_box_ids(boxes, mesh, per)
    lap("box_ids")
    if timing_data is not None:
        del stage_s["start"]
        timing_data.update(stage_s=stage_s, capacity_factor=cf,
                           radius=radius, permute_capacity_factor=pcf,
                           depth=depth)

    starts = boxes["box_start"].to(pid)
    cumul = boxes["box_cumul"].to(pid)
    nonchild = boxes["nonchild"].to(pid)
    tree = Tree(
        root_extent=root_extent.to(coords.dtype),
        box_centers=boxes["box_centers"],
        box_parent_ids=boxes["box_parent_ids"],
        box_child_ids=boxes["box_child_ids"],
        box_levels=boxes["box_levels"],
        box_flags=boxes["box_flags"],
        box_morton_prefixes=boxes["box_morton_prefixes"],
        level_start_box_nrs=tuple(level_starts),
        box_id_dtype=config.box_id_dtype,
        box_level_dtype=config.box_level_dtype,
        coord_dtype=coords.dtype,
        sources_have_extent=False,
        targets_have_extent=False,
        extent_norm=None,
        stick_out_factor=float(stick_out_factor or 0.0),
        _is_pruned=True,
        max_depth=depth,
        sources_are_targets=True,
        particle_id_dtype=pid,
        sources=sources,
        source_radii=None,
        targets=sources,
        target_radii=None,
        user_source_ids=user_source_ids,
        sorted_target_ids=sorted_target_ids,
        box_source_starts=starts,
        box_source_counts_nonchild=nonchild,
        box_source_counts_cumul=cumul,
        box_target_starts=starts,
        box_target_counts_nonchild=nonchild,
        box_target_counts_cumul=cumul,
        box_source_bounding_box_min=None,
        box_source_bounding_box_max=None,
        box_target_bounding_box_min=None,
        box_target_bounding_box_max=None,
        box_id_of_source=box_id_of,
        box_id_of_target=box_id_of,
    )
    return (tree, skel) if return_skeleton else tree
