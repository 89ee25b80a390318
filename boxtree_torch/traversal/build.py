"""FMM traversal (interaction-list) builder in PyTorch.

Port of :func:`boxtree_tpu.traversal.build.build_traversal`
(``boxtree_tpu/traversal/build.py:1520-1889``) on its neighbor-table path
(``fast == 1``, ``well_sep_is_n_away == 1``, no masks), and of
:func:`merge_close_lists` (``:1892-1925``).  The box lists come from
cumulative sums of the box flags, with one host read of their per-level
counts; the clamped neighbour table from K24 and every list from K25-K27
(:mod:`boxtree_torch.ops.traversal`), whose count passes share one host
read of their totals; the List-3 rows are compressed with one more host
read of their counts.  Every row's entries ascend as in the reference
(which sorts ``(row << 32) | id`` keys).  On CPU tensors the plain twins
of K24-K27 run instead.

When the targets have extents, the same-level lists, List 2 and the
target side of List 1 are unchanged; Lists 3 and 4 and their "close"
halves come from :mod:`boxtree_torch.ops.close_lists` (K14, K15), and the
source side of List 1 from a binary search in each coarser level's Morton
prefixes (K27), since internal boxes then hold targets and the table's
one entry per cell misses the intermediate ones.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from boxtree_torch.ops import close_lists
from boxtree_torch.ops import traversal as trav_ops
from boxtree_torch.traversal.containers import (
    BuiltList,
    FMMTraversalInfo,
    compressed_csr,
    csr_rows,
    first_of_rows,
)
from boxtree_torch.tree.containers import box_flags_enum

logger = logging.getLogger(__name__)

_F = box_flags_enum


def _mask_lists(masks, lsb_t):
    """For each boolean mask over the boxes: the ascending indices of its
    True entries (int32), their per-level starts (int32, and on the host)
    and the row of each box among them (int64, ``-1`` where False)
    (``boxtree_tpu/traversal/build.py:110-120, 1497-1511``), with one host
    read of every mask's per-level counts, as the reference's
    ``_mask_level_counts`` (``:1497``)."""
    dev = lsb_t.device
    csums = [torch.cumsum(m, 0) for m in masks]
    ends = torch.stack([c[lsb_t[1:] - 1] for c in csums])
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends], dim=1)
    out = []
    for m, c, st, st_h in zip(masks, csums, starts, starts.tolist()):
        n = st_h[-1]
        lst = torch.empty(n + 1, dtype=torch.int32, device=dev)
        lst.scatter_(0, torch.where(m, c - 1, n),
                     torch.arange(m.shape[0], dtype=torch.int32, device=dev))
        out.append((lst[:n], st.to(torch.int32), st_h,
                    torch.where(m, c - 1, -1)))
    return out


@dataclasses.dataclass(frozen=True)
class _Boxes:
    """The box lists of :func:`build_traversal` with their level starts,
    and what K25-K27 read (:class:`~boxtree_torch.ops.traversal.
    ListInputs`, the clamped neighbour table among it)."""

    source_boxes: torch.Tensor
    ls_src: torch.Tensor
    source_parent_boxes: torch.Tensor
    ls_srcp: torch.Tensor
    ls_totp: torch.Tensor
    ls_tgt: torch.Tensor
    lists: trav_ops.ListInputs

    @classmethod
    def of_tree(cls, tree, plain=False):
        """*plain* builds the table with K24's plain twin on any
        device."""
        flags = tree.box_flags
        lsb = tree.level_start_box_nrs
        lsb_t = torch.as_tensor(lsb, dtype=torch.int64, device=flags.device)
        src_mask = (flags & _F.IS_SOURCE_BOX) != 0
        masks = [src_mask, (flags & _F.HAS_SOURCE_CHILD_BOXES) != 0,
                 (flags & (_F.IS_TARGET_BOX | _F.HAS_TARGET_CHILD_BOXES))
                 != 0]
        if tree.sources_are_targets:
            tgt_row_mask = src_mask
        else:
            tgt_row_mask = (flags & _F.IS_TARGET_BOX) != 0
            masks += [tgt_row_mask, src_mask | tgt_row_mask]
        src, srcp, totp, *rest = _mask_lists(masks, lsb_t)
        tgt, part = rest or (src, src)
        child_rows = tree.box_child_ids.T.contiguous()
        table_fn = (trav_ops.neighbor_table_plain if plain
                    else trav_ops.neighbor_table)
        ntable = table_fn(
            tree.box_morton_prefixes, tree.box_parent_ids, child_rows, flags,
            tgt_row_mask, dimensions=tree.dimensions, lsb=lsb)
        return cls(
            source_boxes=src[0], ls_src=src[1],
            source_parent_boxes=srcp[0], ls_srcp=srcp[1],
            ls_totp=totp[1], ls_tgt=tgt[1],
            lists=trav_ops.ListInputs(
                dimensions=tree.dimensions, lsb=lsb, lsb_t=lsb_t,
                prefixes=tree.box_morton_prefixes,
                parents=tree.box_parent_ids, flags=flags,
                child_rows=child_rows, ntable=ntable,
                totp_boxes=totp[0], ls_totp_h=totp[2],
                target_boxes=tgt[0], ls_tgt_h=tgt[2],
                part_boxes=part[0], ls_part_h=part[2],
                tgt_row_of_box=tgt[3],
                ext=bool(tree.targets_have_extent)))


def list_inputs(tree):
    """What :func:`build_traversal` gives K24-K27 on *tree*: ``((args,
    kwargs), inputs)``, the arguments of
    :func:`~boxtree_torch.ops.traversal.neighbor_table` and the
    :class:`~boxtree_torch.ops.traversal.ListInputs` of K25-K27."""
    inp = _Boxes.of_tree(tree).lists
    tgt_row_mask = inp.tgt_row_of_box >= 0
    return (((inp.prefixes, inp.parents, inp.child_rows, inp.flags,
              tgt_row_mask), dict(dimensions=inp.dimensions, lsb=inp.lsb)),
            inp)


def _starts_of_box_keys(keys, target_boxes, nboxes):
    """CSR starts over the *target_boxes* rows of sorted keys whose high
    halves are box ids (``boxtree_tpu/traversal/build.py:819-826``)."""
    bounds = torch.cat([target_boxes.to(torch.int64),
                        target_boxes.new_full((1,), nboxes).to(torch.int64)])
    return torch.searchsorted(keys >> 32, bounds).to(torch.int32)


def _sep_smaller_by_level(l3_keys, tgt_row_of_box):
    """The List-3 :class:`BuiltList` of each source level and its target
    boxes, from each level's sorted keys ``(target_box << 32) | w``, with
    one host read of every level's count of nonempty rows."""
    firsts = [first_of_rows(keys >> 32) for keys in l3_keys]
    nrows = torch.stack([f.sum() for f in firsts]).tolist()
    by_level, targets = [], []
    for keys, first, n in zip(l3_keys, firsts, nrows):
        tgt_sep, starts, lists = compressed_csr(keys, first, n)
        by_level.append(BuiltList(
            count=int(keys.shape[0]), starts=starts, lists=lists,
            num_nonempty_lists=n,
            nonempty_indices=tgt_row_of_box[tgt_sep.to(torch.int64)].to(
                torch.int32)))
        targets.append(tgt_sep)
    return tuple(by_level), tuple(targets)


def build_traversal(tree, well_sep_is_n_away=1, from_sep_smaller_crit=None,
                    debug=False, _from_sep_smaller_min_nsources_cumul=None,
                    source_boxes_mask=None, source_parent_boxes_mask=None,
                    _plain=False):
    """Build an :class:`FMMTraversalInfo` for *tree*, on the tree's device.

    Arguments as ``boxtree_tpu.traversal.build_traversal``.  This port
    covers ``well_sep_is_n_away == 1`` without masks, on trees with or
    without target extents; with target extents the traversal also holds
    the close Lists 3 and 4, under the *from_sep_smaller_crit*
    (``"precise_linf"``, the default, ``"static_linf"`` or
    ``"static_l2"``) and *_from_sep_smaller_min_nsources_cumul* given.
    (Without target extents the criteria coincide and the threshold is
    not read, as in the reference.)  ``well_sep_is_n_away >= 2`` and masks
    raise :class:`NotImplementedError`.  *_plain* runs the plain twins of
    K24-K27 on any device, to time them beside the kernels.
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

    bx = _Boxes.of_tree(tree, plain=_plain)
    inp = bx.lists
    (sl_starts, sl_lists, l2_starts, l2_lists), l43, (l1_starts, l1_lists) = \
        trav_ops.traversal_lists(inp, plain=_plain)

    close = dict.fromkeys(("from_sep_close_smaller_starts",
                           "from_sep_close_smaller_lists",
                           "from_sep_close_bigger_starts",
                           "from_sep_close_bigger_lists"))
    if ext:
        (args4, kw4), (args3, kw3) = close_list_inputs(tree, bx)
        l4_starts, l4_lists, l4c_starts, l4c_lists = close_lists.list4_ext(
            *args4, **kw4)
        l3_keys, l3c_keys = close_lists.list3_ext(
            *args3, **kw3, crit=crit, min_nsources=min_nsources)
        close.update(
            from_sep_close_smaller_starts=_starts_of_box_keys(
                l3c_keys, inp.target_boxes, tree.nboxes),
            from_sep_close_smaller_lists=(l3c_keys & 0xFFFFFFFF).to(
                torch.int32),
            from_sep_close_bigger_starts=l4c_starts,
            from_sep_close_bigger_lists=l4c_lists)
    else:
        l4_starts, l4_lists, l3_keys = l43
    by_level, targets_sep_smaller = _sep_smaller_by_level(
        l3_keys, inp.tgt_row_of_box)

    logger.info(
        "build_traversal: %d boxes, edges l1=%d l2=%d l3=%d l4=%d",
        tree.nboxes, l1_lists.shape[0], l2_lists.shape[0],
        sum(bl.count for bl in by_level), l4_lists.shape[0])

    return FMMTraversalInfo(
        tree=tree,
        well_sep_is_n_away=1,
        source_boxes=bx.source_boxes,
        target_boxes=inp.target_boxes,
        level_start_source_box_nrs=bx.ls_src,
        level_start_target_box_nrs=bx.ls_tgt,
        source_parent_boxes=bx.source_parent_boxes,
        level_start_source_parent_box_nrs=bx.ls_srcp,
        target_or_target_parent_boxes=inp.totp_boxes,
        level_start_target_or_target_parent_box_nrs=bx.ls_totp,
        same_level_non_well_sep_boxes_starts=sl_starts,
        same_level_non_well_sep_boxes_lists=sl_lists,
        neighbor_source_boxes_starts=l1_starts,
        neighbor_source_boxes_lists=l1_lists,
        from_sep_siblings_starts=l2_starts,
        from_sep_siblings_lists=l2_lists,
        from_sep_smaller_by_level=by_level,
        target_boxes_sep_smaller_by_source_level=targets_sep_smaller,
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
    inp = (boxes if boxes is not None else _Boxes.of_tree(tree)).lists
    common = (inp.ntable, inp.parents, inp.prefixes, inp.flags,
              inp.tgt_row_of_box)
    geo = close_lists.ExtentGeometry.of_tree(tree)
    kwargs = dict(dimensions=tree.dimensions, lsb=tree.level_start_box_nrs)
    return (((inp.totp_boxes, inp.ls_totp_h, *common,
              inp.target_boxes.shape[0], geo), kwargs),
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
