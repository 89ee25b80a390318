"""Traversal (interaction-list) data structures.

Port of :mod:`boxtree_tpu.traversal.containers`: ``FMMTraversalInfo`` with
the four basic box lists and their per-level starts, the same-level
non-well-separated boxes, and Lists 1-4 in CSR form, List 3 stored per
source level with empty rows compressed, and, for targets with extents,
the close Lists 3 and 4 over the target rows.  Field names, dtypes (int32) and
indexing conventions are those of the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


def csr_rows(starts, nedges):
    """Row index (int64) of every entry of a CSR list."""
    starts = starts.to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(starts.shape[0] - 1, device=starts.device),
        starts[1:] - starts[:-1], output_size=nedges)


def first_of_rows(row):
    """True where a sorted row index differs from the one before it."""
    first = torch.ones(row.shape[0], dtype=torch.bool, device=row.device)
    first[1:] = row[1:] != row[:-1]
    return first


def compressed_csr(keys, first=None, nrows=None):
    """CSR over the nonempty rows of sorted int64 ``(row << 32) | value``
    keys: ``(rows, starts, lists)``, all int32, ``rows`` ascending.  Given
    *first* (:func:`first_of_rows` of the keys' rows) and *nrows*, its
    count of True, it reads nothing back to the host."""
    row = keys >> 32
    if first is None:
        first = first_of_rows(row)
    if nrows is None:
        nrows = int(first.sum())
    pos = torch.empty(nrows + 1, dtype=torch.int64, device=keys.device)
    pos.scatter_(0, torch.where(first, torch.cumsum(first, 0) - 1, nrows),
                 torch.arange(keys.shape[0], device=keys.device))
    pos[nrows] = keys.shape[0]
    return (row[pos[:-1]].to(torch.int32), pos.to(torch.int32),
            (keys & 0xFFFFFFFF).to(torch.int32))


@dataclass(frozen=True)
class BuiltList:
    """One CSR list (``boxtree/traversal.py:64-67``): ``starts`` over the
    nonempty rows, ``nonempty_indices`` their row numbers."""

    count: int
    starts: Any
    lists: Any
    num_nonempty_lists: int
    nonempty_indices: Any


@dataclass(frozen=True)
class FMMTraversalInfo:
    """Interaction lists for an FMM evaluation (see
    ``boxtree/traversal.py:1351-1705`` for every attribute)."""

    tree: Any
    well_sep_is_n_away: int

    # basic box lists for iteration
    source_boxes: Any
    target_boxes: Any
    level_start_source_box_nrs: Any
    level_start_target_box_nrs: Any
    source_parent_boxes: Any
    level_start_source_parent_box_nrs: Any
    target_or_target_parent_boxes: Any
    level_start_target_or_target_parent_box_nrs: Any

    # same-level non-well-separated boxes (starts indexed by box id)
    same_level_non_well_sep_boxes_starts: Any
    same_level_non_well_sep_boxes_lists: Any

    # neighbor sources ("List 1"), indexed like target_boxes
    neighbor_source_boxes_starts: Any
    neighbor_source_boxes_lists: Any

    # separated siblings ("List 2"), indexed like
    # target_or_target_parent_boxes
    from_sep_siblings_starts: Any
    from_sep_siblings_lists: Any

    # separated smaller boxes ("List 3"), per source level
    from_sep_smaller_by_level: Any
    target_boxes_sep_smaller_by_source_level: Any
    from_sep_close_smaller_starts: Any
    from_sep_close_smaller_lists: Any

    # separated bigger boxes ("List 4"), indexed like
    # target_or_target_parent_boxes
    from_sep_bigger_starts: Any
    from_sep_bigger_lists: Any
    from_sep_close_bigger_starts: Any
    from_sep_close_bigger_lists: Any

    @property
    def nboxes(self):
        return self.tree.nboxes

    @property
    def nlevels(self):
        return self.tree.nlevels

    @property
    def ntarget_boxes(self):
        return len(self.target_boxes)

    @property
    def ntarget_or_target_parent_boxes(self):
        return len(self.target_or_target_parent_boxes)

    def merge_close_lists(self, debug=False):
        """This traversal with the close Lists 3 and 4 merged into List 1
        (``boxtree_tpu/traversal/containers.py:92-99``); itself when it
        has no close lists."""
        if self.from_sep_close_smaller_starts is None:
            return self
        from boxtree_torch.traversal.build import merge_close_lists
        return merge_close_lists(self)

    def get_box_list(self, what, index):
        starts = getattr(self, f"{what}_starts")
        lists = getattr(self, f"{what}_lists")
        return lists[int(starts[index]):int(starts[index + 1])]
