"""2:1 level restriction for adaptive trees.

Port of :mod:`boxtree_tpu.tree.level_restrict`
(``boxtree_tpu/tree/level_restrict.py:41-153``): makes neighbouring
leaves differ by at most one level (the ``"adaptive-level-restricted"``
tree kind) by raising the per-particle leaf levels of the sort-based
build, in rounds until nothing changes.  Each round is

1. the downward demand pass, deepest level first
   (:func:`boxtree_torch.ops.restrict.demand_pass`, the K5 kernel on the
   card), and
2. the consistency sweep: a box splits as a whole, so if any particle of a
   box descends, every particle of it does
   (:func:`boxtree_torch.ops.restrict.sweep`, the K45 kernel on the card,
   one launch a level).

Each round reads one flag back (did anything change); then the boxes of
every level are recounted (:func:`boxtree_torch.ops.tree.
level_box_counts`, K46, one launch).  The restriction acts on non-empty
leaves only, as the reference's does.
"""

from __future__ import annotations

from boxtree_torch.ops import restrict
from boxtree_torch.ops import tree as tree_ops


def consistency_sweep(codes_s, leaf_level, *, dimensions, depth, max_level,
                      plain=False):
    """Raise every leaf box at level t that holds a deeper particle, for t
    from 0 up (``level_restrict.py:94-114``); *plain* runs the twin of
    K45 whatever the device."""
    lcp = None
    if not plain and codes_s.device.type != "cpu":
        lcp = tree_ops.lcp_levels(codes_s, dimensions, depth)
    for t in range(max_level):
        if plain:
            leaf_level = restrict.sweep_plain(
                codes_s, leaf_level, t=t, dimensions=dimensions, depth=depth)
        else:
            leaf_level = restrict.sweep(
                codes_s, leaf_level, t=t, dimensions=dimensions, depth=depth,
                lcp=lcp)
    return leaf_level


def restrict_leaf_levels(codes_s, leaf_level, *, dimensions, depth,
                         max_level, plain=False):
    """Raise per-particle leaf levels until the 2:1 constraint holds
    (``boxtree_tpu/tree/level_restrict.py:136-153``).

    :arg codes_s: ``(n,)`` int64 full-depth Morton keys, ascending.
    :arg leaf_level: ``(n,)`` int32 leaf levels from phase A.
    :arg max_level: deepest occupied level; the restriction never deepens
        the tree.
    :arg plain: run the plain twins of K5, K45 and K46 whatever the device.
    :returns: ``(leaf_level, counts, rounds)``: the new leaf levels, the
        per-level box counts as a ``(depth + 2,)`` int64 tensor, and the
        number of rounds run.
    """
    demand = restrict.demand_pass_plain if plain else restrict.demand_pass
    recount = (tree_ops.level_box_counts_plain if plain
               else tree_ops.level_box_counts)
    rounds = 0
    for _ in range(max_level + 1):
        leaf_in = leaf_level
        for m in range(max_level, 1, -1):
            leaf_level = demand(codes_s, leaf_level, m=m,
                                dimensions=dimensions, depth=depth)
        leaf_level = consistency_sweep(codes_s, leaf_level,
                                       dimensions=dimensions, depth=depth,
                                       max_level=max_level, plain=plain)
        rounds += 1
        if not bool((leaf_level != leaf_in).any()):
            break
    counts = recount(codes_s, leaf_level, dimensions=dimensions, depth=depth,
                     max_level=max_level)
    return leaf_level, counts, rounds
