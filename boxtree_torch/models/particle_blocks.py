"""List 2's edges classified by (level, translation class).

Port of :class:`boxtree_tpu.models.particle_blocks.M2LPlan`
(``particle_blocks.py:148-298``), the plan the reference's edge-form M2L
runs on: every List-2 (target, source) pair of all levels is classified
by its translation ``cell(target) - cell(source)`` within the window
*offsets*, and the edges are sorted so that each (level, class)
operator's edges form one run.  The classification runs on the
traversal's device (:func:`boxtree_torch.ops.rotation.classify_edges`:
K75, one ``torch.sort``, K76 on CUDA), and only the histogram of the
operator keys crosses to the host, once.

The port's dense M2L (K35) runs on its own parent-block plan
(:class:`boxtree_torch.ops.translate.ParentBlockPlan`); this plan serves
the rotation M2L (:mod:`boxtree_torch.models.rotation_m2l`).
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.ops import rotation


class M2LPlan:
    """List-2 edges sorted by operator (see module doc).

    .. attribute:: used

        ``(level, class_id)`` pairs present, in key order: the order of
        the operator table.

    .. attribute:: tgt, src

        ``(E,)`` int32 tensors of the edges' target and source boxes,
        sorted by operator.

    .. attribute:: group_sizes

        ``(nops,)`` int32 tensor of the edges of each operator.
    """

    def __init__(self, traversal, offsets):
        """:arg offsets: ``(nclasses, dim)`` int array of the translation
        window (the allowed ``cell(target) - cell(source)``)."""
        tree = traversal.tree
        self.offsets = np.asarray(offsets)
        self.nclasses = len(self.offsets)
        d = tree.dimensions
        dev = tree.box_levels.device
        self._radius = int(np.abs(self.offsets).max())
        width = 2 * self._radius + 1
        self._weights = width ** np.arange(d)
        self._table = np.full(width ** d, -1, np.int64)
        self._table[(self.offsets + self._radius) @ self._weights] = \
            np.arange(self.nclasses)
        lists = traversal.from_sep_siblings_lists
        npossible = tree.nlevels * self.nclasses

        tgt, src, hist = rotation.classify_edges(
            tree.box_morton_prefixes, tree.box_levels.to(torch.int32),
            traversal.from_sep_siblings_starts.to(torch.int32),
            lists.to(torch.int32),
            traversal.target_or_target_parent_boxes.to(torch.int32),
            torch.as_tensor(self._table, device=dev), dim=d,
            radius=self._radius, nclasses=self.nclasses,
            npossible=npossible)
        hist = hist.cpu().numpy()                       # the one host read
        if hist[-1] != 0:
            raise AssertionError("List-2 edge outside translation window")
        used_keys = np.nonzero(hist[:-1])[0]
        self._used_keys = used_keys.astype(np.int64)
        self.used = [(int(k) // self.nclasses, int(k) % self.nclasses)
                     for k in used_keys]
        self.nops = len(used_keys)
        self.tgt = tgt
        self.src = src
        sizes = hist[used_keys].astype(np.int64)
        self.group_sizes = torch.as_tensor(sizes.astype(np.int32),
                                           device=dev)
        #: the edges and their per-operator counts, for the rotation M2L
        self.edges = rotation.EdgeGroups(tgt, src, sizes)
