"""Sort-based tree build in PyTorch.

Port of :mod:`boxtree_tpu.tree.build` (``boxtree_tpu/tree/build.py:45-553,
583-816``) for the adaptive, the adaptive-level-restricted and the
non-adaptive kinds, refined by ``max_particles_in_box`` or by refine
weights, in the particles' bounding box or a given one; the adaptive kind
also with particle extents (radii):

1. Every particle's full-depth Morton key, packed with its index, comes
   from the K1 kernel (:func:`boxtree_torch.ops.morton.encode_points`) and
   is sorted once with ``torch.sort``.
2. :func:`_phase_a` assigns every particle its *leaf level* (the first
   level at which its box's refine weight is at most the maximum; for the
   non-adaptive kind the first level at which every box's is) and counts
   the boxes of every level: K43 (:func:`boxtree_torch.ops.tree.
   leaf_levels`), whose packed counts are the build's one host read per
   depth tried.  With extents a particle also stops at its stick-out level
   (K12, :mod:`boxtree_torch.ops.extents`), and only particles that can
   still descend count toward a split.  For the level-restricted kind,
   :mod:`.level_restrict` then raises leaf levels until touching leaves
   differ by at most one level (one host read a round, one for the
   recount).
3. :func:`_phase_b` materializes the per-box arrays level by level (K44,
   :func:`boxtree_torch.ops.tree.box_levels`) and reads nothing back.
   With extents the particles are first re-sorted so that each box's own
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
from typing import NamedTuple

import numpy as np
import torch

from boxtree_torch import config
from boxtree_torch.ops import extents, morton
from boxtree_torch.ops import tree as tree_ops
from boxtree_torch.tree.containers import Tree, box_flags_enum
from boxtree_torch.tree.level_restrict import restrict_leaf_levels

logger = logging.getLogger(__name__)


class MaxLevelsExceeded(RuntimeError):
    """Raised when the tree would need more levels than Morton keys can
    represent (mirrors ``boxtree_tpu.tree.build.MaxLevelsExceeded``)."""


_TREE_KINDS = ("adaptive", "adaptive-level-restricted", "non-adaptive")


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


def _sort_keys(coords, *, dimensions, depth, weights=None, radii=None,
               extent_norm=None, stick_out_factor=0.0, bbox=None):
    """The root box, the Morton-sorted keys and their permutation, the
    weights in that order and with *radii* the sorted stick levels: K43's
    inputs (``boxtree_tpu/tree/build.py:133-168``).

    :arg bbox: ``(bbox_min, root_extent)`` tensors of a given root box, or
        None for the particles' own.
    :returns: ``(codes_s, order, weights_s, stick_s, bbox_min,
        root_extent)``; ``weights_s`` and ``stick_s`` are None without
        weights and radii.
    """
    n = coords.shape[1]
    if bbox is None:
        bbox_min, root_extent = _root_box(coords, radii)
    else:
        bbox_min, root_extent = bbox
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
    order64 = order.to(torch.int64)
    stick_s = None
    if radii is not None:
        stick_s = extents.stick_levels(
            coords, radii, bbox_min, root_extent, dimensions=dimensions,
            depth=depth, extent_norm=extent_norm,
            stick_out_factor=stick_out_factor)[order64]
    weights_s = weights[order64] if weights is not None else None
    return codes_s, order, weights_s, stick_s, bbox_min, root_extent


def _phase_a(coords, max_weight, *, adaptive=True, **keys):
    """Morton sort + leaf-level assignment + per-level box counts
    (``boxtree_tpu/tree/build.py:113-247``): :func:`_sort_keys` with
    *keys* (``dimensions``, ``depth``, and the refine ``weights``, the
    ``radii`` and their options, a given ``bbox``), then K43; *adaptive*
    False builds a non-adaptive tree.

    :returns: ``(codes_s, order, leaf_level, counts, n_unfit, bbox_min,
        root_extent)``; ``counts[l]`` (a CPU tensor) is the number of boxes
        at level ``l``, ``n_unfit`` the number of particles still in
        overfull boxes at depth ``depth``.  Everything else stays on the
        device of *coords*: the packed counts are the one host read.
    """
    codes_s, order, w_s, stick_s, bbox_min, root_extent = _sort_keys(
        coords, **keys)
    depth = keys["depth"]
    leaf_level, packed = tree_ops.leaf_levels(
        codes_s, w_s, stick_s, max_weight, dimensions=keys["dimensions"],
        depth=depth, adaptive=adaptive)
    packed = packed.cpu()
    return (codes_s, order, leaf_level, packed[:depth + 2],
            int(packed[depth + 2]), bbox_min, root_extent)

# }}}


# {{{ phase B: materialize box arrays

def _exclusive_cumsum(x):
    return torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])


def _extent_order(codes_s, order, leaf_level, *, dimensions, depth):
    """The particles of a tree with extents in its order: sorted by
    (Morton key with the bits below the leaf level zeroed, leaf level),
    stably, so that each box's own particles precede its subtree
    (``boxtree_tpu/tree/build.py:272-284``); returns the masked keys, the
    order and the leaf levels so sorted."""
    shift_bits = dimensions * (depth - leaf_level.to(torch.int64))
    masked = (codes_s >> shift_bits) << shift_bits
    # stable sort by (masked key, leaf level): the second key first
    perm = torch.sort(leaf_level, stable=True).indices
    perm = perm[torch.sort(masked[perm], stable=True).indices]
    return masked[perm], order[perm], leaf_level[perm]


def box_flags(has_children, src_cumul, src_nonchild, tgt_cumul,
              tgt_nonchild):
    """The int32 box flags (``boxtree_tpu/tree/build.py:488-506``)."""
    F = box_flags_enum

    def flag(cond, bit):
        return torch.where(cond, bit, 0).to(torch.int32)

    return (flag(has_children & (src_cumul > src_nonchild),
                 F.HAS_SOURCE_CHILD_BOXES)
            | flag(has_children & (tgt_cumul > tgt_nonchild),
                   F.HAS_TARGET_CHILD_BOXES)
            | flag(src_nonchild > 0, F.IS_SOURCE_BOX)
            | flag(tgt_nonchild > 0, F.IS_TARGET_BOX)
            | flag(~has_children, F.IS_LEAF_BOX))


def _phase_b(codes_s, order, leaf_level, merged_coords, bbox_min,
             root_extent, *, dimensions, depth, level_starts, nsources,
             ntargets, sources_are_targets, has_extents=False, plain=False):
    """Per-box arrays from the sorted keys and leaf levels
    (``boxtree_tpu/tree/build.py:262-530``): K44 (or with *plain* its
    twin) level by level, then the source/target split and the flags, all
    without a host read.

    With extents, the particles are first put in :func:`_extent_order`.
    """
    d = dimensions
    dev = codes_s.device
    cdt = merged_coords.dtype

    if has_extents:
        codes_s, order, leaf_level = _extent_order(
            codes_s, order, leaf_level, dimensions=d, depth=depth)

    boxes_fn = tree_ops.box_levels_plain if plain else tree_ops.box_levels
    boxes = boxes_fn(codes_s, leaf_level, bbox_min.to(cdt),
                     torch.as_tensor(root_extent).to(cdt),
                     dimensions=d, depth=depth, level_starts=level_starts,
                     has_extents=has_extents)
    box_start = boxes["box_start"]
    box_count_cumul = boxes["box_count_cumul"]
    box_count_nonchild = boxes["box_count_nonchild"]
    box_has_children = boxes["box_has_children"]
    leaf_box = boxes["leaf_box"]

    # {{{ source/target split (boxtree_tpu/tree/build.py:423-484)

    pid = config.particle_id_dtype
    order64 = order.to(torch.int64)

    def box_ranges(member):
        cum = _exclusive_cumsum(member.to(torch.int64))
        starts = cum[box_start]
        return (cum,
                starts,
                cum[box_start + box_count_cumul] - starts,
                cum[box_start + box_count_nonchild] - starts)

    def compact(values, member, pos, count, dtype):
        """*values* of the *member* particles at their tree-order
        positions *pos*; the others land on a dropped slot."""
        out = torch.zeros(count + 1, dtype=dtype, device=dev)
        out[torch.where(member, pos, count)] = values.to(dtype)
        return out[:count]

    if sources_are_targets:
        # every particle is a source: the ranges are the boxes' own and
        # the compactions collapse to identities
        box_source_starts = box_start
        box_source_counts_cumul = box_count_cumul
        box_source_counts_nonchild = box_count_nonchild
        user_source_ids = order.to(pid)
        box_id_of_source = leaf_box
        sources = merged_coords[:, order64]
        box_target_starts = box_source_starts
        box_target_counts_cumul = box_source_counts_cumul
        box_target_counts_nonchild = box_source_counts_nonchild
        targets = sources
        box_id_of_target = box_id_of_source
        user_target_ids = order64
        # user target id -> tree-order position (inverse permutation)
        sorted_target_ids = torch.empty(ntargets, dtype=pid, device=dev)
        sorted_target_ids[order64] = torch.arange(ntargets, dtype=pid,
                                                  device=dev)
    else:
        is_source_s = order < nsources
        (cumsrc, box_source_starts, box_source_counts_cumul,
         box_source_counts_nonchild) = box_ranges(is_source_s)
        pos_src = cumsrc[:-1]
        user_source_ids = compact(order, is_source_s, pos_src, nsources,
                                  pid)
        box_id_of_source = compact(leaf_box, is_source_s, pos_src,
                                   nsources, torch.int32)
        sources = merged_coords[:, user_source_ids.to(torch.int64)]
        is_target_s = ~is_source_s
        (cumtgt, box_target_starts, box_target_counts_cumul,
         box_target_counts_nonchild) = box_ranges(is_target_s)
        pos_tgt = cumtgt[:-1]
        user_target_ids = compact(order64 - nsources, is_target_s, pos_tgt,
                                  ntargets, torch.int64)
        sorted_target_ids = compact(pos_tgt, is_target_s,
                                    order64 - nsources, ntargets, pid)
        box_id_of_target = compact(leaf_box, is_target_s, pos_tgt,
                                   ntargets, torch.int32)
        targets = merged_coords[:, nsources + user_target_ids]

    # }}}

    flags = box_flags(box_has_children, box_source_counts_cumul,
                      box_source_counts_nonchild, box_target_counts_cumul,
                      box_target_counts_nonchild)

    return dict(
        user_target_ids=user_target_ids,
        box_morton=boxes["box_morton"],
        box_level=boxes["box_level"],
        box_parent=boxes["box_parent"],
        box_child=boxes["box_child"],
        box_centers=boxes["box_centers"],
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


def _weights_of(refine_weights, n, device):
    """The refine weights as an int32 tensor, checked as the reference
    checks them (``boxtree_tpu/tree/build.py:659-669``)."""
    if not isinstance(refine_weights, torch.Tensor):
        refine_weights = torch.as_tensor(np.asarray(refine_weights))
    if refine_weights.dtype != torch.int32:
        raise TypeError("refine_weights must have dtype int32")
    if tuple(refine_weights.shape) != (n,):
        raise ValueError("refine_weights must have one entry per "
                         "source-and-target particle")
    return refine_weights.to(device)


def _given_bbox(bbox, dimensions, coord_dtype, device):
    """``(bbox_min, root_extent)`` tensors of a given square bounding box,
    computed as the reference's ``_validate_bbox`` computes them
    (``boxtree_tpu/tree/build.py:569-580``): in the coordinates' dtype."""
    np_dtype = np.float32 if coord_dtype == torch.float32 else np.float64
    if isinstance(bbox, torch.Tensor):
        bbox = bbox.cpu().numpy()
    bbox = np.asarray(bbox, dtype=np_dtype)
    if bbox.shape != (dimensions, 2):
        raise ValueError("bbox must have shape (dimensions, 2)")
    bbox_min = bbox[:, 0].copy()
    exts = bbox[:, 1] - bbox_min
    if not np.allclose(exts, exts[0], rtol=1e-14, atol=0):
        raise ValueError("bbox must be square")
    return (torch.as_tensor(bbox_min, device=device),
            torch.tensor(exts[0], dtype=coord_dtype, device=device))


class _PhaseAInputs(NamedTuple):
    """What :func:`build_tree` hands phase A: the merged particles (the
    sources, then the targets) and how many are sources, the largest leaf
    weight, :func:`_sort_keys`'s keywords at the first depth to try
    (``keys``), whether the tree is adaptive, and the full depth a failed
    first try retries at."""

    merged: torch.Tensor
    nsources: int
    max_weight: int
    keys: dict
    adaptive: bool
    depth_full: int


def _build_inputs(particles, kind="adaptive", max_particles_in_box=None,
                  targets=None, source_radii=None, target_radii=None,
                  stick_out_factor=None, refine_weights=None,
                  max_leaf_refine_weight=None, extent_norm=None, bbox=None,
                  *, device=None):
    """The arguments of :func:`build_tree`, checked as the reference
    checks them (``boxtree_tpu/tree/build.py:602-690``), as
    :class:`_PhaseAInputs`."""
    if kind not in _TREE_KINDS:
        raise ValueError(f"unknown tree kind: '{kind}'")
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

    coords = _as_coord_tensor(particles, device)
    dev = coords.device
    dimensions, nsources = coords.shape
    coord_dtype = coords.dtype
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
        merged_radii = torch.cat([radii_of(source_radii, nsources),
                                  radii_of(target_radii, ntargets)])

    # refine weights (boxtree_tpu/tree/build.py:651-672)
    weights = None
    if max_particles_in_box is not None:
        if refine_weights is not None or max_leaf_refine_weight is not None:
            raise ValueError(
                "may not specify both max_particles_in_box and "
                "refine_weights/max_leaf_refine_weight")
        max_weight = int(max_particles_in_box)
    elif refine_weights is not None:
        if max_leaf_refine_weight is None:
            raise ValueError("must specify max_leaf_refine_weight with "
                             "refine_weights")
        weights = _weights_of(refine_weights, n, dev)
        max_weight = int(max_leaf_refine_weight)
    else:
        raise ValueError("must specify either max_particles_in_box or "
                         "refine_weights/max_leaf_refine_weight")

    given = None
    if bbox is not None:
        given = _given_bbox(bbox, dimensions, coord_dtype, dev)

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
    return _PhaseAInputs(
        merged=merged, nsources=nsources, max_weight=max_weight,
        keys=dict(dimensions=dimensions, depth=depth, weights=weights,
                  radii=merged_radii, extent_norm=extent_norm,
                  stick_out_factor=stick_out_factor, bbox=given),
        adaptive=kind != "non-adaptive", depth_full=depth_full)


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
    Every kind is ported: ``"adaptive"``, ``"adaptive-level-restricted"``
    and ``"non-adaptive"``, refined by ``max_particles_in_box`` or by
    int32 *refine_weights* (one per source and target particle) with
    *max_leaf_refine_weight*, in the bounding box of the particles or in a
    given square *bbox* (``(dimensions, 2)``, not stretched).  The
    adaptive kind also takes extents: *source_radii* and *target_radii*
    (which need *targets*), *stick_out_factor* and *extent_norm*
    (``"linf"``, the default, or ``"l2"``); the tree then carries the radii
    and the boxes' source and target bounding boxes.  Extents with another
    kind raise :class:`NotImplementedError`, as the reference does.

    On the card the build reads the host once per depth tried (K43's
    packed counts), and a level-restricted build once more a restriction
    round and once for its recount.
    """
    inp = _build_inputs(
        particles, kind, max_particles_in_box, targets, source_radii,
        target_radii, stick_out_factor, refine_weights,
        max_leaf_refine_weight, extent_norm, bbox, device=device)
    merged, nsources = inp.merged, inp.nsources
    dimensions, n = merged.shape
    coord_dtype = merged.dtype
    sources_are_targets = targets is None
    ntargets = nsources if sources_are_targets else n - nsources
    sources_have_extent = source_radii is not None
    targets_have_extent = target_radii is not None
    has_extents = sources_have_extent or targets_have_extent
    keys = dict(inp.keys)
    depth = keys.pop("depth")
    while True:
        (codes_s, order, leaf_level, counts, n_unfit, bbox_min,
         root_extent) = _phase_a(merged, inp.max_weight, depth=depth,
                                 adaptive=inp.adaptive, **keys)
        if not n_unfit:
            break
        if depth < inp.depth_full:
            depth = inp.depth_full
            continue
        raise MaxLevelsExceeded(
            f"{n_unfit} particles remain in overfull boxes at the deepest "
            f"representable level ({depth})")

    counts = counts.numpy()
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
        radii = keys["radii"]
        src_radii = radii[out["user_source_ids"].to(torch.int64)]
        tgt_radii = (src_radii if sources_are_targets
                     else radii[nsources:][out["user_target_ids"]])

        def bounding_boxes(what, radii, have):
            return extents.box_extents(
                out[f"{what}s"], radii if have else None,
                out[f"box_{what}_starts"],
                out[f"box_{what}_counts_nonchild"], out["box_centers"],
                out["box_child"], lsb=level_starts)
        sbb = bounding_boxes("source", src_radii, sources_have_extent)
        tbb = bounding_boxes("target", tgt_radii, targets_have_extent)

    if bbox is not None:
        # the reference keeps the given extent as a float (float64)
        root_extent = root_extent.to(torch.float64)
    else:
        root_extent = root_extent.to(coord_dtype)
    return Tree(
        root_extent=root_extent,
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
        extent_norm=keys["extent_norm"],
        stick_out_factor=float(keys["stick_out_factor"]),
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
