"""FMM traversal (interaction-list) builder in PyTorch.

Port of :func:`boxtree_tpu.traversal.build.build_traversal`
(``boxtree_tpu/traversal/build.py:1520-1889``) on its neighbor-table path
(``fast == 1``, ``well_sep_is_n_away == 1``, no masks), and of
:func:`merge_close_lists` (``:1892-1925``).  Every list comes from the
generators of :mod:`.neighbors` over one level's rows at a time; candidate
rows are sorted and compacted into CSR form, so every row's entries ascend
as in the reference (which sorts ``(row << 32) | id`` keys).  Rows are
processed in chunks that bound the candidate tensors.

When the targets have extents, the same-level lists, List 2 and the
target side of List 1 are unchanged; Lists 3 and 4 and their "close"
halves come from :mod:`boxtree_torch.ops.close_lists` (K14, K15), and the
source side of List 1 from the per-level binary-search generator
:func:`_gen_list1_source_side`, since internal boxes then hold targets
and the table's one entry per cell misses the intermediate ones.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from boxtree_torch.ops import close_lists, morton
from boxtree_torch.ops.peers import _lookup, _touch
from boxtree_torch.traversal import neighbors as nbr
from boxtree_torch.traversal.containers import (
    BuiltList,
    FMMTraversalInfo,
    compressed_csr,
    csr_rows,
)
from boxtree_torch.tree.containers import box_flags_enum

logger = logging.getLogger(__name__)

_F = box_flags_enum
_ROW_CHUNK = 1 << 16
_INT32_MAX = 2 ** 31 - 1


def _csr_from_candidates(counts_and_values, nrows, device):
    """Concatenate per-chunk ``(counts, values)`` into CSR
    ``(starts[int32, nrows + 1], lists[int32])``."""
    if counts_and_values:
        counts = torch.cat([c for c, _ in counts_and_values])
        lists = torch.cat([v for _, v in counts_and_values])
    else:
        counts = torch.zeros(0, dtype=torch.int64, device=device)
        lists = torch.zeros(0, dtype=torch.int32, device=device)
    if counts.shape[0] != nrows:
        raise RuntimeError("CSR rows out of step")
    starts = torch.zeros(nrows + 1, dtype=torch.int64, device=device)
    starts[1:] = torch.cumsum(counts, 0)
    return starts.to(torch.int32), lists.to(torch.int32)


def _row_sorted(cand):
    """Per-row counts and the row-major values of a ``(B, K)`` candidate
    block (``-1`` invalid), each row's values ascending."""
    valid = cand >= 0
    srt = torch.sort(torch.where(valid, cand, torch.full_like(
        cand, _INT32_MAX)), dim=1).values
    counts = valid.sum(dim=1)
    return counts, srt[srt != _INT32_MAX]


def _row_lists(gen, rows):
    """Run *gen* over *rows* in chunks; returns a list of
    ``(counts, values)``."""
    out = []
    for c0 in range(0, rows.shape[0], _ROW_CHUNK):
        out.append(_row_sorted(gen(rows[c0:c0 + _ROW_CHUNK])))
    return out


def _valid_keys(gen, rows):
    """Run a key generator over *rows* in chunks; returns its valid
    int64 keys."""
    parts = []
    for c0 in range(0, rows.shape[0], _ROW_CHUNK):
        keys = gen(rows[c0:c0 + _ROW_CHUNK])
        parts.append(keys[keys != nbr._INVALID_KEY])
    if not parts:
        return torch.zeros(0, dtype=torch.int64)
    return torch.cat(parts)


def _mask_list(mask, lsb):
    """Ascending indices of True entries, and their per-level starts
    (``boxtree_tpu/traversal/build.py:110-120, 1497-1503``)."""
    lst = torch.nonzero(mask)[:, 0]
    bounds = torch.as_tensor(lsb, dtype=torch.int64, device=mask.device)
    level_starts = torch.searchsorted(lst, bounds).to(torch.int32)
    return lst.to(torch.int32), level_starts


def _row_of_box(mask):
    """int64 row of each True box among the True boxes, ``-1`` elsewhere
    (``boxtree_tpu/traversal/build.py:1506-1511``)."""
    return torch.where(mask, torch.cumsum(mask.to(torch.int64), 0) - 1,
                       torch.full_like(mask, -1, dtype=torch.int64))


@dataclasses.dataclass(frozen=True)
class _Boxes:
    """What every list of :func:`build_traversal` is built from: the box
    lists with their level starts (tensors, and ``*_h`` host copies where
    rows are sliced by level), the target row of each box (int64, ``-1``
    for boxes that are not target boxes) and the clamped neighbour
    table."""

    source_boxes: torch.Tensor
    ls_src: torch.Tensor
    source_parent_boxes: torch.Tensor
    ls_srcp: torch.Tensor
    totp_boxes: torch.Tensor
    ls_totp: torch.Tensor
    target_boxes: torch.Tensor
    ls_tgt: torch.Tensor
    part_boxes: torch.Tensor
    ls_part: torch.Tensor
    ls_totp_h: list
    ls_tgt_h: list
    ls_part_h: list
    tgt_row_of_box: torch.Tensor
    ntable: torch.Tensor

    @classmethod
    def of_tree(cls, tree):
        flags = tree.box_flags
        lsb = tree.level_start_box_nrs
        src_mask = (flags & _F.IS_SOURCE_BOX) != 0
        source_boxes, ls_src = _mask_list(src_mask, lsb)
        source_parent_boxes, ls_srcp = _mask_list(
            (flags & _F.HAS_SOURCE_CHILD_BOXES) != 0, lsb)
        totp_boxes, ls_totp = _mask_list(
            (flags & (_F.IS_TARGET_BOX | _F.HAS_TARGET_CHILD_BOXES)) != 0,
            lsb)
        if tree.sources_are_targets:
            tgt_row_mask = src_mask
            target_boxes, ls_tgt = source_boxes, ls_src
            part_boxes, ls_part = target_boxes, ls_tgt
        else:
            tgt_row_mask = (flags & _F.IS_TARGET_BOX) != 0
            target_boxes, ls_tgt = _mask_list(tgt_row_mask, lsb)
            part_boxes, ls_part = _mask_list(src_mask | tgt_row_mask, lsb)
        ntable = nbr.build_neighbor_table(
            tree.box_morton_prefixes, tree.box_parent_ids,
            tree.box_child_ids, flags, tgt_row_mask,
            dimensions=tree.dimensions, lsb=lsb)
        return cls(
            source_boxes=source_boxes, ls_src=ls_src,
            source_parent_boxes=source_parent_boxes, ls_srcp=ls_srcp,
            totp_boxes=totp_boxes, ls_totp=ls_totp,
            target_boxes=target_boxes, ls_tgt=ls_tgt,
            part_boxes=part_boxes, ls_part=ls_part,
            ls_totp_h=[int(x) for x in ls_totp.cpu()],
            ls_tgt_h=[int(x) for x in ls_tgt.cpu()],
            ls_part_h=[int(x) for x in ls_part.cpu()],
            tgt_row_of_box=_row_of_box(tgt_row_mask), ntable=ntable)


def _gen_list1_source_side(rows, prefixes, box_flags, tgt_row_of_box, *,
                           ls, dimensions, lsb):
    """Source-side List-1 keys ``(tgt << 32) | b`` of the boxes *rows* at
    level *ls*: the target boxes at every coarser level that touch ``b``
    (``boxtree_tpu/traversal/build.py:342-362``), found by binary search
    in each level's Morton prefixes."""
    rows_i = rows.to(torch.int64)
    cells = morton.deinterleave(prefixes[rows_i], dimensions)
    offs = torch.as_tensor(nbr._offsets(dimensions, 1), device=rows.device)
    emitter_is_src = ((box_flags[rows_i] & _F.IS_SOURCE_BOX) != 0)[:, None]
    out = []
    for lt in range(ls):
        cand = (cells >> (ls - lt))[:, :, None] + offs.T[:, None, :]
        found, box_id = _lookup(prefixes[lsb[lt]:lsb[lt + 1]], lsb[lt],
                                cand, lt)
        is_tgt = tgt_row_of_box[torch.where(found, box_id, 0)] >= 0
        valid = (found & is_tgt & _touch(cand, lt, cells[:, :, None], ls)
                 & emitter_is_src)
        out.append(torch.where(valid, (box_id.to(torch.int64) << 32)
                               | rows_i[:, None], nbr._INVALID_KEY))
    return torch.cat(out, dim=1)


def _starts_of_box_keys(keys, target_boxes, nboxes):
    """CSR starts over the *target_boxes* rows of sorted keys whose high
    halves are box ids (``boxtree_tpu/traversal/build.py:819-826``)."""
    bounds = torch.cat([target_boxes.to(torch.int64),
                        target_boxes.new_full((1,), nboxes).to(torch.int64)])
    return torch.searchsorted(keys >> 32, bounds).to(torch.int32)


def build_traversal(tree, well_sep_is_n_away=1, from_sep_smaller_crit=None,
                    debug=False, _from_sep_smaller_min_nsources_cumul=None,
                    source_boxes_mask=None, source_parent_boxes_mask=None):
    """Build an :class:`FMMTraversalInfo` for *tree*, on the tree's device.

    Arguments as ``boxtree_tpu.traversal.build_traversal``.  This port
    covers ``well_sep_is_n_away == 1`` without masks, on trees with or
    without target extents; with target extents the traversal also holds
    the close Lists 3 and 4, under the *from_sep_smaller_crit*
    (``"precise_linf"``, the default, ``"static_linf"`` or
    ``"static_l2"``) and *_from_sep_smaller_min_nsources_cumul* given.
    (Without target extents the criteria coincide and the threshold is
    not read, as in the reference.)  ``well_sep_is_n_away >= 2`` and masks
    raise :class:`NotImplementedError`.
    """
    if tree.sources_have_extent:
        raise ValueError("source extents not supported in traversal "
                         "(same restriction as the reference, "
                         "boxtree/traversal.py:2002-2006)")
    ext = bool(tree.targets_have_extent)
    crit = from_sep_smaller_crit or "precise_linf"
    if crit not in close_lists.CRITERIA:
        raise ValueError(f"unexpected value of 'from_sep_smaller_crit': "
                         f"{crit}")
    if ext and tree.extent_norm == "l2" and crit == "static_linf":
        # boxtree_tpu/traversal/build.py:1552-1555
        raise ValueError("the static l^inf from-sep-smaller criterion "
                         "cannot be used with the l^2 extent norm")
    min_nsources = int(_from_sep_smaller_min_nsources_cumul or 0)
    if well_sep_is_n_away != 1:
        raise NotImplementedError("well_sep_is_n_away >= 2 is not ported yet")
    if source_boxes_mask is not None or source_parent_boxes_mask is not None:
        raise NotImplementedError("source box masks are not ported yet")
    if tree.nboxes >= (1 << 29):
        raise NotImplementedError("trees of 2^29 boxes or more need the "
                                  "generic generators, not ported yet")

    d = tree.dimensions
    nlevels = tree.nlevels
    nboxes = tree.nboxes
    lsb = tree.level_start_box_nrs
    dev = tree.box_flags.device
    flags = tree.box_flags
    prefixes = tree.box_morton_prefixes
    parents = tree.box_parent_ids
    bx = _Boxes.of_tree(tree)
    ntable = bx.ntable
    totp_boxes, target_boxes = bx.totp_boxes, bx.target_boxes
    ntarget_boxes = target_boxes.shape[0]
    tgt_row_of_box = bx.tgt_row_of_box
    child_rows = tree.box_child_ids.T.contiguous()

    def level_ids(lev):
        return torch.arange(lsb[lev], lsb[lev + 1], dtype=torch.int32,
                            device=dev)

    # {{{ same-level non-well-separated boxes (rows = all boxes)

    parts = []
    for lev in range(nlevels):
        parts += _row_lists(
            lambda r, lev=lev: nbr.fgen_slnws(r, ntable, lsb_lev=lsb[lev]),
            level_ids(lev))
    slnws_starts, slnws_lists = _csr_from_candidates(parts, nboxes, dev)

    # }}}

    # {{{ Lists 2 and 4 (rows = target_or_target_parent_boxes)

    ntotp = totp_boxes.shape[0]
    if ext:
        (args4, kw4), (args3, kw3) = close_list_inputs(tree, bx)
        l4_starts, l4_lists, l4c_starts, l4c_lists = close_lists.list4_ext(
            *args4, **kw4)
    l2_parts, l4_parts = [], []
    for lev in range(nlevels):
        rows = totp_boxes[bx.ls_totp_h[lev]:bx.ls_totp_h[lev + 1]]
        if lev == 0:
            empty = (torch.zeros(rows.shape[0], dtype=torch.int64,
                                 device=dev),
                     torch.zeros(0, dtype=torch.int32, device=dev))
            l2_parts.append(empty)
            l4_parts.append(empty)
            continue
        l2_parts += _row_lists(
            lambda r, lev=lev: nbr.fgen_list2(
                r, ntable, child_rows, parents, prefixes, dimensions=d,
                min_id=lsb[lev - 1]), rows)
        if not ext:
            l4_parts += _row_lists(
                lambda r, lev=lev: nbr.fgen_list4(
                    r, ntable, parents, prefixes, lb=lev, dimensions=d,
                    lsb=lsb), rows)
    l2_starts, l2_lists = _csr_from_candidates(l2_parts, ntotp, dev)
    if not ext:
        l4_starts, l4_lists = _csr_from_candidates(l4_parts, ntotp, dev)

    # }}}

    # {{{ List 1 (rows = target_boxes): target side + cross-level
    # source side, merged by one key sort

    keys = []
    for lt in range(nlevels):
        rows = target_boxes[bx.ls_tgt_h[lt]:bx.ls_tgt_h[lt + 1]]
        for c0 in range(0, rows.shape[0], _ROW_CHUNK):
            r = rows[c0:c0 + _ROW_CHUNK]
            cand = nbr.fgen_list1_tgt(r, ntable, prefixes, lt=lt,
                                      dimensions=d, lsb=lsb)
            trow = tgt_row_of_box[r.to(torch.int64)]
            k = (trow[:, None] << 32) | cand.to(torch.int64)
            keys.append(k[cand >= 0])
        if lt > 0:
            prow = bx.part_boxes[bx.ls_part_h[lt]:bx.ls_part_h[lt + 1]]
            if ext:
                def gen_src(r, lt=lt):
                    return _gen_list1_source_side(
                        r, prefixes, flags, tgt_row_of_box, ls=lt,
                        dimensions=d, lsb=lsb)
            else:
                def gen_src(r, lt=lt):
                    return nbr.fgen_list1_src(r, ntable, prefixes, lt=lt,
                                              dimensions=d, lsb=lsb)
            src_keys = _valid_keys(gen_src, prow).to(dev)
            tb = src_keys >> 32
            keys.append((tgt_row_of_box[tb] << 32)
                        | (src_keys & 0xFFFFFFFF))
    l1_keys = torch.sort(torch.cat(keys)).values if keys else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    l1_starts = torch.searchsorted(
        l1_keys >> 32, torch.arange(ntarget_boxes + 1, device=dev)).to(
            torch.int32)
    l1_lists = (l1_keys & 0xFFFFFFFF).to(torch.int32)

    # }}}

    # {{{ List 3 per source level, compressed over nonempty target rows

    if ext:
        l3_keys, l3c_keys = close_lists.list3_ext(
            *args3, **kw3, crit=crit, min_nsources=min_nsources)
    else:
        l3_keys = [torch.zeros(0, dtype=torch.int64, device=dev)] + [
            torch.sort(_valid_keys(
                lambda r, ls=ls: nbr.fgen_list3(
                    r, ntable, parents, prefixes, flags, ls=ls,
                    dimensions=d, lsb=lsb),
                level_ids(ls)).to(dev)).values
            for ls in range(1, nlevels)]
    from_sep_smaller_by_level = []
    target_boxes_sep_smaller = []
    for keys in l3_keys:
        tgt_sep, starts, lists = compressed_csr(keys)
        from_sep_smaller_by_level.append(BuiltList(
            count=int(keys.shape[0]),
            starts=starts,
            lists=lists,
            num_nonempty_lists=int(tgt_sep.shape[0]),
            nonempty_indices=tgt_row_of_box[tgt_sep.to(torch.int64)].to(
                torch.int32)))
        target_boxes_sep_smaller.append(tgt_sep)

    # }}}

    close = dict.fromkeys(("from_sep_close_smaller_starts",
                           "from_sep_close_smaller_lists",
                           "from_sep_close_bigger_starts",
                           "from_sep_close_bigger_lists"))
    if ext:
        close.update(
            from_sep_close_smaller_starts=_starts_of_box_keys(
                l3c_keys, target_boxes, nboxes),
            from_sep_close_smaller_lists=(l3c_keys & 0xFFFFFFFF).to(
                torch.int32),
            from_sep_close_bigger_starts=l4c_starts,
            from_sep_close_bigger_lists=l4c_lists)

    logger.info(
        "build_traversal: %d boxes, edges l1=%d l2=%d l3=%d l4=%d",
        nboxes, l1_lists.shape[0], l2_lists.shape[0],
        sum(bl.count for bl in from_sep_smaller_by_level),
        l4_lists.shape[0])

    return FMMTraversalInfo(
        tree=tree,
        well_sep_is_n_away=1,
        source_boxes=bx.source_boxes,
        target_boxes=target_boxes,
        level_start_source_box_nrs=bx.ls_src,
        level_start_target_box_nrs=bx.ls_tgt,
        source_parent_boxes=bx.source_parent_boxes,
        level_start_source_parent_box_nrs=bx.ls_srcp,
        target_or_target_parent_boxes=totp_boxes,
        level_start_target_or_target_parent_box_nrs=bx.ls_totp,
        same_level_non_well_sep_boxes_starts=slnws_starts,
        same_level_non_well_sep_boxes_lists=slnws_lists,
        neighbor_source_boxes_starts=l1_starts,
        neighbor_source_boxes_lists=l1_lists,
        from_sep_siblings_starts=l2_starts,
        from_sep_siblings_lists=l2_lists,
        from_sep_smaller_by_level=tuple(from_sep_smaller_by_level),
        target_boxes_sep_smaller_by_source_level=tuple(
            target_boxes_sep_smaller),
        from_sep_bigger_starts=l4_starts,
        from_sep_bigger_lists=l4_lists,
        **close,
    )


def close_list_inputs(tree, boxes=None):
    """The arguments with which :func:`build_traversal` calls
    :func:`~boxtree_torch.ops.close_lists.list4_ext` and
    :func:`~boxtree_torch.ops.close_lists.list3_ext` (K14, K15) on *tree*,
    a tree whose targets have extents: ``((args4, kwargs4), (args3,
    kwargs3))``; ``list3_ext`` also takes ``crit`` and ``min_nsources``.
    *boxes* is the tree's :class:`_Boxes`, made here when not given."""
    bx = boxes if boxes is not None else _Boxes.of_tree(tree)
    common = (bx.ntable, tree.box_parent_ids, tree.box_morton_prefixes,
              tree.box_flags, bx.tgt_row_of_box)
    geo = close_lists.ExtentGeometry.of_tree(tree)
    kwargs = dict(dimensions=tree.dimensions, lsb=tree.level_start_box_nrs)
    return (((bx.totp_boxes, bx.ls_totp_h, *common,
              bx.target_boxes.shape[0], geo), kwargs),
            ((*common, geo), kwargs))


def merge_close_lists(trav):
    """A traversal with the close Lists 3 and 4 merged into List 1 and set
    to None (``boxtree_tpu/traversal/build.py:1892-1925``): all three are
    CSR lists over the ``target_boxes`` rows, merged by one key sort."""
    rows, vals = [], []
    for what in ("neighbor_source_boxes", "from_sep_close_smaller",
                 "from_sep_close_bigger"):
        lists = getattr(trav, f"{what}_lists")
        rows.append(csr_rows(getattr(trav, f"{what}_starts"),
                             lists.shape[0]))
        vals.append(lists.to(torch.int64))
    keys = torch.sort((torch.cat(rows) << 32) | torch.cat(vals)).values
    starts = torch.searchsorted(
        keys >> 32, torch.arange(trav.ntarget_boxes + 1,
                                 device=keys.device)).to(torch.int32)
    return dataclasses.replace(
        trav,
        neighbor_source_boxes_starts=starts,
        neighbor_source_boxes_lists=(keys & 0xFFFFFFFF).to(torch.int32),
        from_sep_close_smaller_starts=None,
        from_sep_close_smaller_lists=None,
        from_sep_close_bigger_starts=None,
        from_sep_close_bigger_lists=None)


class FMMTraversalBuilder:
    """Callable wrapper around :func:`build_traversal`, for the public name
    of ``boxtree_tpu``'s (``boxtree_tpu/traversal/build.py:1928-1962``),
    with its argument checks."""

    def __init__(self, actx=None, well_sep_is_n_away=1,
                 from_sep_smaller_crit=None):
        if isinstance(actx, int):
            # no array-context argument: the positional form is
            # (well_sep_is_n_away[, from_sep_smaller_crit])
            if from_sep_smaller_crit is not None:
                raise TypeError(
                    "FMMTraversalBuilder: pass the array context first "
                    "or use keyword arguments")
            actx, well_sep_is_n_away, from_sep_smaller_crit = (
                None, actx,
                None if well_sep_is_n_away == 1 else well_sep_is_n_away)
        if not isinstance(well_sep_is_n_away, int) or well_sep_is_n_away < 1:
            raise TypeError(
                f"well_sep_is_n_away must be a positive int, got "
                f"{well_sep_is_n_away!r}")
        if from_sep_smaller_crit not in (None, *close_lists.CRITERIA):
            raise ValueError(
                f"bad from_sep_smaller_crit: {from_sep_smaller_crit!r}")
        self.well_sep_is_n_away = well_sep_is_n_away
        self.from_sep_smaller_crit = from_sep_smaller_crit

    def __call__(self, tree_or_actx, tree=None, **kwargs):
        if tree is None:
            tree = tree_or_actx
        return build_traversal(
            tree, well_sep_is_n_away=self.well_sep_is_n_away,
            from_sep_smaller_crit=self.from_sep_smaller_crit, **kwargs)
