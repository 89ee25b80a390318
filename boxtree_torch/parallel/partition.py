"""Tree partitioning and responsibility masks for the distributed FMM.

Port of :mod:`boxtree_tpu.parallel.partition` (``partition.py:1-209``),
which mirrors ``boxtree/distributed/partition.py``:

- :func:`dfs_box_order`: boxes in Morton depth-first order.  The reference
  walks a stack over every box on the host (``partition.py:23-38``); here
  it is one sort on the tree's device: each box's Morton prefix shifted
  to the deepest level is the smallest full-depth key of its subtree, so
  sorting by it (ties, a box and its first-digit descendants, broken by
  level, parent first: box ids are level-major, and the sort is stable)
  gives the preorder that visits children in digit order, the order of
  ``box_child_ids``.
- :func:`partition_work` / :func:`partition_ranks`: contiguous DFS
  segments balanced by per-box cost, one per rank, as dense masks or in
  the interval form :class:`RankPartition`.
- :func:`get_box_masks`: per-rank responsible / ancestor / point-source /
  multipole-source box masks.

Everything is a tensor on the device of the traversal (or of the cost
vector); the segment bounds come from one ``cumsum`` and one
``searchsorted`` in float64, as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from boxtree_torch.traversal.containers import csr_rows


def dfs_box_order(tree):
    """Box ids (int64) in Morton depth-first order
    (``boxtree_tpu/parallel/partition.py:23-38``)."""
    lev = tree.box_levels.to(torch.int64)
    shift = tree.dimensions * (tree.nlevels - 1 - lev)
    key = tree.box_morton_prefixes.to(torch.int64) << shift
    return torch.sort(key, stable=True).indices


def _segment_bounds(cost, order, nranks):
    """``(nranks + 1,)`` DFS positions where each rank's segment starts
    (``partition.py:47-55``)."""
    nboxes = order.shape[0]
    cum = torch.cumsum(cost[order], 0)
    fracs = cum[-1] * torch.arange(1, nranks, device=cum.device) / nranks
    bounds = torch.searchsorted(cum, fracs)
    return torch.cat([
        torch.zeros(1, dtype=torch.int64, device=cum.device), bounds + 1,
        torch.full((1,), nboxes, dtype=torch.int64, device=cum.device),
    ]).clamp(0, nboxes)


def _cost(cost_per_box, tree):
    return torch.as_tensor(cost_per_box, dtype=torch.float64,
                           device=tree.box_levels.device)


def partition_work(cost_per_box, traversal, nranks):
    """Split the DFS box order into *nranks* contiguous, cost-balanced
    segments; returns ``(nranks, nboxes)`` bool responsibility masks
    (``partition.py:41-56``)."""
    tree = traversal.tree
    order = dfs_box_order(tree)
    seg = _segment_bounds(_cost(cost_per_box, tree), order, nranks)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(tree.nboxes, device=order.device)
    return (seg[:-1, None] <= pos[None, :]) & (pos[None, :] < seg[1:, None])


@dataclass
class RankPartition:
    """The DFS cost partition in interval form
    (``boxtree_tpu/parallel/partition.py:59-93``): every box carries its
    owner rank and the contiguous interval of ranks for which it is
    responsible or an ancestor of a responsible box (the ranks whose
    segment its DFS subtree overlaps).  Fields are int64 tensors."""

    nranks: int
    #: (nboxes,) DFS position of each box
    pos_of_box: Any
    #: (nboxes,) DFS subtree size (descendants and the box itself)
    subtree_size: Any
    #: (nranks + 1,) segment bounds in DFS positions
    seg_bounds: Any
    #: (nboxes,) responsible rank of each box
    owner_of_box: Any
    #: (nboxes,) first / last rank having the box responsible-or-ancestor
    r_lo: Any
    r_hi: Any

    def responsible_masks(self):
        """(nranks, nboxes) bool, as :func:`partition_work` gives."""
        r = torch.arange(self.nranks, device=self.owner_of_box.device)
        return self.owner_of_box[None, :] == r[:, None]

    def resp_or_anc_masks(self):
        """(nranks, nboxes) bool responsible-or-ancestor masks."""
        r = torch.arange(self.nranks, device=self.r_lo.device)[:, None]
        return (self.r_lo[None, :] <= r) & (r <= self.r_hi[None, :])


def partition_ranks(cost_per_box, traversal, nranks):
    """Cost-balanced DFS partition in interval form; its segment bounds
    are :func:`partition_work`'s (``partition.py:96-129``)."""
    tree = traversal.tree
    order = dfs_box_order(tree)
    nboxes = tree.nboxes
    dev = order.device
    pos_of_box = torch.empty_like(order)
    pos_of_box[order] = torch.arange(nboxes, device=dev)
    seg = _segment_bounds(_cost(cost_per_box, tree), order, nranks)

    # subtree sizes bottom-up, one pass a level
    lsb = tree.level_start_box_nrs
    parents = tree.box_parent_ids.to(torch.int64)
    size = torch.ones(nboxes, dtype=torch.int64, device=dev)
    for lev in range(tree.nlevels - 1, 0, -1):
        b0, b1 = lsb[lev], lsb[lev + 1]
        size.index_add_(0, parents[b0:b1], size[b0:b1].clone())

    def rank_of(pos):
        return (torch.searchsorted(seg, pos, right=True) - 1).clamp(
            0, nranks - 1)

    # subtree interval [pos, pos + size) against the segments: the ranks
    # it overlaps form [rank of its first position, rank of its last]
    owner = rank_of(pos_of_box)
    return RankPartition(nranks=nranks, pos_of_box=pos_of_box,
                         subtree_size=size, seg_bounds=seg,
                         owner_of_box=owner, r_lo=owner,
                         r_hi=rank_of(pos_of_box + size - 1))


def _propagate_to_ancestors(tree, mask):
    """Mask of the strict ancestors of masked boxes, and the root."""
    parents = tree.box_parent_ids.to(torch.int64)
    anc = torch.zeros_like(mask)
    cur = mask.clone()
    for _ in range(tree.nlevels):
        nxt = torch.zeros_like(mask)
        nxt[parents[cur]] = True
        nxt &= ~anc
        if not bool(nxt.any()):
            break
        anc |= nxt
        cur = nxt
    anc[0] = True
    return anc


def _interaction_mask(nboxes, row_boxes_mask, starts, lists, rows):
    """Boxes listed in the CSR rows whose box is in *row_boxes_mask*."""
    out = torch.zeros(nboxes, dtype=torch.bool, device=lists.device)
    row_of_edge = csr_rows(starts, lists.shape[0])
    sel = row_boxes_mask[rows.to(torch.int64)[row_of_edge]]
    out[lists.to(torch.int64)[sel]] = True
    return out


@dataclass
class BoxMasks:
    """``boxtree/distributed/partition.py:165-205``: (nboxes,) bool
    tensors."""

    responsible_boxes: Any
    ancestor_boxes: Any
    point_src_boxes: Any
    multipole_src_boxes: Any


def get_box_masks(traversal, responsible_mask):
    """Per-rank box masks (``boxtree_tpu/parallel/partition.py:164-209``):
    point sources feed the rank's List 1 and List 4; multipole sources its
    List 2 of responsible-or-ancestor boxes and List 3 of responsible
    ones."""
    tree = traversal.tree
    nboxes = tree.nboxes
    resp = torch.as_tensor(responsible_mask, dtype=torch.bool,
                           device=tree.box_levels.device)
    anc = _propagate_to_ancestors(tree, resp)
    resp_or_anc = resp | anc

    point_src = (_interaction_mask(
        nboxes, resp_or_anc, traversal.neighbor_source_boxes_starts,
        traversal.neighbor_source_boxes_lists, traversal.target_boxes)
        | _interaction_mask(
            nboxes, resp_or_anc, traversal.from_sep_bigger_starts,
            traversal.from_sep_bigger_lists,
            traversal.target_or_target_parent_boxes))

    mp_src = _interaction_mask(
        nboxes, resp_or_anc, traversal.from_sep_siblings_starts,
        traversal.from_sep_siblings_lists,
        traversal.target_or_target_parent_boxes)
    for ssn, tb in zip(traversal.from_sep_smaller_by_level,
                       traversal.target_boxes_sep_smaller_by_source_level):
        if ssn.count:
            mp_src |= _interaction_mask(nboxes, resp, ssn.starts, ssn.lists,
                                        tb)

    return BoxMasks(responsible_boxes=resp, ancestor_boxes=anc,
                    point_src_boxes=point_src,
                    multipole_src_boxes=mp_src)
