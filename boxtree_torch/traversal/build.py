"""FMM traversal (interaction-list) builder in PyTorch.

Port of :func:`boxtree_tpu.traversal.build.build_traversal`
(``boxtree_tpu/traversal/build.py:1520-1889``) on its neighbor-table path
(``fast == 1``, ``well_sep_is_n_away == 1``, no extents, no masks).  Every
list comes from the generators of :mod:`.neighbors` over one level's rows
at a time; candidate rows are sorted and compacted into CSR form, so every
row's entries ascend as in the reference (which sorts ``(row << 32) | id``
keys).  Rows are processed in chunks that bound the candidate tensors.
"""

from __future__ import annotations

import logging

import torch

from boxtree_torch.traversal import neighbors as nbr
from boxtree_torch.traversal.containers import (
    BuiltList,
    FMMTraversalInfo,
    compressed_csr,
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


def build_traversal(tree, well_sep_is_n_away=1, from_sep_smaller_crit=None,
                    debug=False, _from_sep_smaller_min_nsources_cumul=None,
                    source_boxes_mask=None, source_parent_boxes_mask=None):
    """Build an :class:`FMMTraversalInfo` for *tree*, on the tree's device.

    Arguments as ``boxtree_tpu.traversal.build_traversal``.  This port
    covers ``well_sep_is_n_away == 1`` on trees without extents and
    without masks; those raise :class:`NotImplementedError`.  (Without
    target extents the *from_sep_smaller_crit* variants coincide.)
    """
    if tree.sources_have_extent:
        raise ValueError("source extents not supported in traversal "
                         "(same restriction as the reference, "
                         "boxtree/traversal.py:2002-2006)")
    crit = from_sep_smaller_crit or "precise_linf"
    if crit not in ("static_linf", "precise_linf", "static_l2"):
        raise ValueError(f"unexpected value of 'from_sep_smaller_crit': "
                         f"{crit}")
    if tree.targets_have_extent:
        raise NotImplementedError("traversals of trees with target extents "
                                  "are not ported yet")
    if well_sep_is_n_away != 1:
        raise NotImplementedError("well_sep_is_n_away >= 2 is not ported yet")
    if source_boxes_mask is not None or source_parent_boxes_mask is not None:
        raise NotImplementedError("source box masks are not ported yet")
    if _from_sep_smaller_min_nsources_cumul:
        raise NotImplementedError(
            "_from_sep_smaller_min_nsources_cumul is not ported yet")
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

    # {{{ basic box lists

    src_mask = (flags & _F.IS_SOURCE_BOX) != 0
    tgt_mask = (flags & _F.IS_TARGET_BOX) != 0
    source_boxes, ls_src = _mask_list(src_mask, lsb)
    source_parent_boxes, ls_srcp = _mask_list(
        (flags & _F.HAS_SOURCE_CHILD_BOXES) != 0, lsb)
    totp_boxes, ls_totp = _mask_list(
        (flags & (_F.IS_TARGET_BOX | _F.HAS_TARGET_CHILD_BOXES)) != 0, lsb)
    if tree.sources_are_targets:
        target_boxes, ls_tgt = source_boxes, ls_src
        tgt_row_mask = src_mask
        part_boxes = target_boxes
        ls_part = ls_tgt
    else:
        target_boxes, ls_tgt = _mask_list(tgt_mask, lsb)
        tgt_row_mask = tgt_mask
        part_boxes, ls_part = _mask_list(src_mask | tgt_mask, lsb)
    ntarget_boxes = target_boxes.shape[0]
    tgt_row_of_box = torch.where(
        tgt_row_mask, torch.cumsum(tgt_row_mask.to(torch.int64), 0) - 1,
        torch.full((nboxes,), -1, dtype=torch.int64, device=dev))

    ls_tgt_h = [int(x) for x in ls_tgt.cpu()]
    ls_totp_h = [int(x) for x in ls_totp.cpu()]
    ls_part_h = [int(x) for x in ls_part.cpu()]

    # }}}

    ntable = nbr.build_neighbor_table(
        prefixes, parents, tree.box_child_ids, flags, tgt_row_mask,
        dimensions=d, lsb=lsb)
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
    l2_parts, l4_parts = [], []
    for lev in range(nlevels):
        rows = totp_boxes[ls_totp_h[lev]:ls_totp_h[lev + 1]]
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
        l4_parts += _row_lists(
            lambda r, lev=lev: nbr.fgen_list4(
                r, ntable, parents, prefixes, lb=lev, dimensions=d,
                lsb=lsb), rows)
    l2_starts, l2_lists = _csr_from_candidates(l2_parts, ntotp, dev)
    l4_starts, l4_lists = _csr_from_candidates(l4_parts, ntotp, dev)

    # }}}

    # {{{ List 1 (rows = target_boxes): target side + cross-level
    # source side, merged by one key sort

    keys = []
    for lt in range(nlevels):
        rows = target_boxes[ls_tgt_h[lt]:ls_tgt_h[lt + 1]]
        for c0 in range(0, rows.shape[0], _ROW_CHUNK):
            r = rows[c0:c0 + _ROW_CHUNK]
            cand = nbr.fgen_list1_tgt(r, ntable, prefixes, lt=lt,
                                      dimensions=d, lsb=lsb)
            trow = tgt_row_of_box[r.to(torch.int64)]
            k = (trow[:, None] << 32) | cand.to(torch.int64)
            keys.append(k[cand >= 0])
        if lt > 0:
            prow = part_boxes[ls_part_h[lt]:ls_part_h[lt + 1]]
            src_keys = _valid_keys(
                lambda r, lt=lt: nbr.fgen_list1_src(
                    r, ntable, prefixes, lt=lt, dimensions=d, lsb=lsb),
                prow).to(dev)
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

    from_sep_smaller_by_level = []
    target_boxes_sep_smaller = []
    for ls in range(nlevels):
        keys = torch.zeros(0, dtype=torch.int64, device=dev)
        if ls > 0:
            keys = torch.sort(_valid_keys(
                lambda r, ls=ls: nbr.fgen_list3(
                    r, ntable, parents, prefixes, flags, ls=ls,
                    dimensions=d, lsb=lsb),
                level_ids(ls)).to(dev)).values
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

    logger.info(
        "build_traversal: %d boxes, edges l1=%d l2=%d l3=%d l4=%d",
        nboxes, l1_lists.shape[0], l2_lists.shape[0],
        sum(bl.count for bl in from_sep_smaller_by_level),
        l4_lists.shape[0])

    return FMMTraversalInfo(
        tree=tree,
        well_sep_is_n_away=1,
        source_boxes=source_boxes,
        target_boxes=target_boxes,
        level_start_source_box_nrs=ls_src,
        level_start_target_box_nrs=ls_tgt,
        source_parent_boxes=source_parent_boxes,
        level_start_source_parent_box_nrs=ls_srcp,
        target_or_target_parent_boxes=totp_boxes,
        level_start_target_or_target_parent_box_nrs=ls_totp,
        same_level_non_well_sep_boxes_starts=slnws_starts,
        same_level_non_well_sep_boxes_lists=slnws_lists,
        neighbor_source_boxes_starts=l1_starts,
        neighbor_source_boxes_lists=l1_lists,
        from_sep_siblings_starts=l2_starts,
        from_sep_siblings_lists=l2_lists,
        from_sep_smaller_by_level=tuple(from_sep_smaller_by_level),
        target_boxes_sep_smaller_by_source_level=tuple(
            target_boxes_sep_smaller),
        from_sep_close_smaller_starts=None,
        from_sep_close_smaller_lists=None,
        from_sep_bigger_starts=l4_starts,
        from_sep_bigger_lists=l4_lists,
        from_sep_close_bigger_starts=None,
        from_sep_close_bigger_lists=None,
    )
