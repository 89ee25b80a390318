"""Constant-one ("counting") expansion wrangler.

Port of ``boxtree_tpu/models/constant_one.py:25-250``: the Green's function
is identically 1, so for unit source weights every target's potential must
equal ``nsources`` exactly (``boxtree/constant_one.py:50-237``) - the exact
oracle for the traversal.  Every stage is a gather or an ``index_add_``
over the CSR lists.
"""

from __future__ import annotations

import torch

from boxtree_torch.fmm.drive import (
    ExpansionWranglerInterface,
    TreeIndependentDataForWrangler,
)
from boxtree_torch.traversal.containers import csr_rows


def segment_sum(vals, ids, num_segments):
    return vals.new_zeros(num_segments).index_add_(0, ids.to(torch.int64),
                                                   vals)


class ConstantOneTreeIndependentDataForWrangler(
        TreeIndependentDataForWrangler):
    pass


class ConstantOneExpansionWrangler(ExpansionWranglerInterface):
    """The counting FMM (``boxtree/constant_one.py:50-237``), vectorized."""

    def __init__(self, tree_indep, traversal, dtype=torch.float64):
        super().__init__(tree_indep, traversal)
        self.dtype = dtype
        tree = traversal.tree
        self._lsb = tree.level_start_box_nrs
        self._ls_totp = [int(x) for x in
                         traversal.level_start_target_or_target_parent_box_nrs
                         .cpu()]

    def _zeros(self, n):
        return torch.zeros(n, dtype=self.dtype,
                           device=self.tree.box_levels.device)

    def multipole_expansion_zeros(self):
        return self._zeros(self.tree.nboxes)

    local_expansion_zeros = multipole_expansion_zeros

    def output_zeros(self):
        return self._zeros(self.tree.ntargets)

    def _to_outputs(self, per_box_vals):
        return per_box_vals[self.tree.box_id_of_target.to(torch.int64)]

    def reorder_sources(self, source_array):
        return torch.as_tensor(source_array, device=self.tree.sources.device)[
            self.tree.user_source_ids.to(torch.int64)].to(self.dtype)

    def reorder_potentials(self, potentials):
        return potentials[self.tree.sorted_target_ids.to(torch.int64)]

    def multipole_expansions_view(self, mpole_exps, level):
        return mpole_exps[self._lsb[level]:self._lsb[level + 1]]

    local_expansions_view = multipole_expansions_view

    def _box_source_sums(self, src_weights):
        return segment_sum(src_weights, self.tree.box_id_of_source,
                           self.tree.nboxes)

    def form_multipoles(self, level_start_source_box_nrs, source_boxes,
                        src_weight_vecs):
        src_weights, = src_weight_vecs
        return self._box_source_sums(src_weights)

    def coarsen_multipoles(self, level_start_source_parent_box_nrs,
                           source_parent_boxes, mpoles):
        parents = self.tree.box_parent_ids.to(torch.int64)
        mpoles = mpoles.clone()
        # source_level from nlevels-1 down to 3 (boxtree/constant_one.py:113)
        for source_level in range(self.tree.nlevels - 1, 2, -1):
            b0, b1 = self._lsb[source_level], self._lsb[source_level + 1]
            mpoles.index_add_(0, parents[b0:b1], mpoles[b0:b1].clone())
        return mpoles

    def eval_direct(self, target_boxes, neighbor_sources_starts,
                    neighbor_sources_lists, src_weight_vecs):
        src_weights, = src_weight_vecs
        box_sums = self._box_source_sums(src_weights)
        lists = neighbor_sources_lists.to(torch.int64)
        rows = csr_rows(neighbor_sources_starts, lists.shape[0])
        row_sums = segment_sum(box_sums[lists], rows, target_boxes.shape[0])
        pot_box = self._zeros(self.tree.nboxes)
        pot_box[target_boxes.to(torch.int64)] = row_sums
        return self._to_outputs(pot_box)

    def multipole_to_local(self, level_start_target_or_target_parent_box_nrs,
                           target_or_target_parent_boxes, starts, lists,
                           mpole_exps):
        lists = lists.to(torch.int64)
        rows = csr_rows(starts, lists.shape[0])
        contrib = segment_sum(mpole_exps[lists], rows,
                              target_or_target_parent_boxes.shape[0])
        return self.local_expansion_zeros().index_add_(
            0, target_or_target_parent_boxes.to(torch.int64), contrib)

    def eval_multipoles(self, target_boxes_by_source_level,
                        from_sep_smaller_by_level, mpole_exps):
        pot_box = self._zeros(self.tree.nboxes)
        for level, ssn in enumerate(from_sep_smaller_by_level):
            if ssn.count == 0:
                continue
            lists = ssn.lists.to(torch.int64)
            rows = csr_rows(ssn.starts, lists.shape[0])
            tb = target_boxes_by_source_level[level].to(torch.int64)
            contrib = segment_sum(mpole_exps[lists], rows, tb.shape[0])
            pot_box.index_add_(0, tb, contrib)
        return self._to_outputs(pot_box)

    def form_locals(self, level_start_target_or_target_parent_box_nrs,
                    target_or_target_parent_boxes, starts, lists,
                    src_weight_vecs, local_exps=None):
        src_weights, = src_weight_vecs
        box_sums = self._box_source_sums(src_weights)
        lists = lists.to(torch.int64)
        rows = csr_rows(starts, lists.shape[0])
        contrib = segment_sum(box_sums[lists], rows,
                              target_or_target_parent_boxes.shape[0])
        if local_exps is None:
            local_exps = self.local_expansion_zeros()
        return local_exps.index_add_(
            0, target_or_target_parent_boxes.to(torch.int64), contrib)

    def refine_locals(self, level_start_target_or_target_parent_box_nrs,
                      target_or_target_parent_boxes, local_exps):
        parents = self.tree.box_parent_ids.to(torch.int64)
        local_exps = local_exps.clone()
        for target_lev in range(1, self.tree.nlevels):
            r0, r1 = self._ls_totp[target_lev], self._ls_totp[target_lev + 1]
            ids = target_or_target_parent_boxes[r0:r1].to(torch.int64)
            local_exps.index_add_(0, ids, local_exps[parents[ids]])
        return local_exps

    def eval_locals(self, level_start_target_box_nrs, target_boxes,
                    local_exps):
        return self._to_outputs(local_exps)

    def finalize_potentials(self, potentials):
        return potentials
