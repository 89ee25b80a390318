"""Geometric lookup structures: area queries, leaves-to-balls lookup,
space-invader queries and peer lists.

Port of :mod:`boxtree_tpu.geometry.area_query`
(``boxtree_tpu/geometry/area_query.py:52-389``), with the same containers,
field names and call forms (``AreaQueryBuilder()(tree, ball_centers,
ball_radii)``; an array-context first argument is accepted and ignored).
A ball is an l-inf ball; it overlaps a box when ``max_i |c_i - b_i| <=
box_radius + radius``.

- :class:`AreaQueryBuilder`: for each ball, the leaves it overlaps, from
  the level-by-level sweep of :mod:`boxtree_torch.ops.area_query` (K6) and
  one ``torch.sort`` of the ``(ball << 32) | leaf`` keys.
- :class:`LeavesToBallsLookupBuilder`: the inverse, by one more key sort.
- :func:`area_query_elementwise`: a custom per-hit operation whose values
  combine into an output by add, max or min.
- :class:`SpaceInvaderQueryBuilder`: for each leaf, the largest l-inf
  distance from its centre to the centre of an overlapping ball (K7).
- :class:`PeerListFinder`: for each box, the adjacent boxes at its level
  and the coarser adjacent leaves and childless-near-it boxes (K8).

Results live on the device of the tree's tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from boxtree_torch.ops import area_query as aq_ops
from boxtree_torch.ops import peers as peer_ops

_COMBINE = {"add": "sum", "max": "amax", "min": "amin"}


# {{{ containers

@dataclass(frozen=True)
class AreaQueryResult:
    """CSR of the leaves overlapping each ball
    (``boxtree/area_query.py:50-76``)."""

    tree: Any
    leaves_near_ball_starts: Any
    leaves_near_ball_lists: Any


@dataclass(frozen=True)
class LeavesToBallsLookup:
    """CSR of the balls overlapping each box, empty for non-leaves
    (``boxtree/area_query.py:79-105``)."""

    tree: Any
    balls_near_box_starts: Any
    balls_near_box_lists: Any


@dataclass(frozen=True)
class PeerListLookup:
    """CSR of the peers of each box (``boxtree/area_query.py:108-130``)."""

    tree: Any
    peer_list_starts: Any
    peer_lists: Any

# }}}


def _balls(tree, ball_centers, ball_radii):
    dev = tree.box_centers.device
    return (torch.as_tensor(ball_centers, device=dev),
            torch.as_tensor(ball_radii, device=dev))


def _args(tree_or_actx, tree, ball_centers, ball_radii):
    """Accept ``(tree, centers, radii)`` and ``(actx, tree, centers,
    radii)``."""
    if ball_radii is None:
        return tree_or_actx, tree, ball_centers
    return tree, ball_centers, ball_radii


def _starts_of_rows(rows_sorted, nrows):
    """CSR starts (int32, ``nrows + 1``) of ascending row numbers."""
    return torch.searchsorted(
        rows_sorted, torch.arange(nrows + 1, dtype=torch.int64,
                                  device=rows_sorted.device)).to(torch.int32)


class AreaQueryBuilder:
    """For each ball, the leaf boxes overlapping it
    (``boxtree/area_query.py:657-807``)."""

    def __init__(self, actx=None):
        pass

    def __call__(self, tree_or_actx, tree=None, ball_centers=None,
                 ball_radii=None, peer_lists=None):
        tree, ball_centers, ball_radii = _args(tree_or_actx, tree,
                                               ball_centers, ball_radii)
        centers, radii = _balls(tree, ball_centers, ball_radii)
        keys = aq_ops.ball_leaf_keys(tree, centers, radii)
        return AreaQueryResult(
            tree=tree,
            leaves_near_ball_starts=_starts_of_rows(keys >> 32,
                                                    centers.shape[1]),
            leaves_near_ball_lists=(keys & 0xFFFFFFFF).to(torch.int32))


class LeavesToBallsLookupBuilder:
    """For each box, the balls overlapping it (non-empty for leaves only;
    ``boxtree/area_query.py:814-918``)."""

    def __init__(self, actx=None):
        pass

    def __call__(self, tree_or_actx, tree=None, ball_centers=None,
                 ball_radii=None, peer_lists=None):
        tree, ball_centers, ball_radii = _args(tree_or_actx, tree,
                                               ball_centers, ball_radii)
        centers, radii = _balls(tree, ball_centers, ball_radii)
        keys = aq_ops.ball_leaf_keys(tree, centers, radii)
        inv = torch.sort(((keys & 0xFFFFFFFF) << 32) | (keys >> 32)).values
        return LeavesToBallsLookup(
            tree=tree,
            balls_near_box_starts=_starts_of_rows(inv >> 32, tree.nboxes),
            balls_near_box_lists=(inv & 0xFFFFFFFF).to(torch.int32))


def area_query_elementwise(tree, ball_center_and_radius, nballs,
                           leaf_found_op, out, combine="add"):
    """A custom area query (``boxtree_tpu/geometry/area_query.py:
    226-256``, the reference's ``AreaQueryElementwiseTemplate``).

    :arg ball_center_and_radius: maps an int64 ``(B,)`` index tensor to
        ``((d, B) centers, (B,) radii)``.
    :arg leaf_found_op: maps the int64 ``(E,)`` edge tensors ``(ball_idx,
        leaf_box_id)`` to ``(values, out_indices)``.
    :arg out: the accumulator; a new tensor is returned.
    :arg combine: ``"add"``, ``"max"`` or ``"min"``; the values combine
        into *out* with ``scatter_reduce``.
    """
    if combine not in _COMBINE:
        raise ValueError(f"unknown combine: {combine!r}")
    dev = tree.box_centers.device
    centers, radii = ball_center_and_radius(
        torch.arange(nballs, dtype=torch.int64, device=dev))
    keys = aq_ops.ball_leaf_keys(tree, centers, radii)
    vals, oidx = leaf_found_op(keys >> 32, keys & 0xFFFFFFFF)
    return out.scatter_reduce(0, oidx.to(torch.int64), vals.to(out.dtype),
                              reduce=_COMBINE[combine], include_self=True)


class SpaceInvaderQueryBuilder:
    """For each leaf box, the largest l-inf distance from its centre to
    the centre of an overlapping ball, float32, 0 where none
    (``boxtree/area_query.py:925-1049``)."""

    def __init__(self, actx=None):
        pass

    def __call__(self, tree_or_actx, tree=None, ball_centers=None,
                 ball_radii=None, peer_lists=None):
        tree, ball_centers, ball_radii = _args(tree_or_actx, tree,
                                               ball_centers, ball_radii)
        centers, radii = _balls(tree, ball_centers, ball_radii)
        return aq_ops.space_invader(tree, centers, radii)


class PeerListFinder:
    """Each box's peers (``boxtree/area_query.py:1057-1188``)."""

    def __init__(self, actx=None):
        pass

    def __call__(self, tree_or_actx, tree=None):
        if tree is None:
            tree = tree_or_actx
        starts, lists = peer_ops.peer_lists(
            tree.box_morton_prefixes, tree.box_flags,
            dimensions=tree.dimensions, lsb=tree.level_start_box_nrs)
        return PeerListLookup(tree=tree, peer_list_starts=starts,
                              peer_lists=lists)
