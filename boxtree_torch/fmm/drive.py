"""FMM driver and expansion-wrangler interface.

Port of :mod:`boxtree_tpu.fmm.drive` (``boxtree_tpu/fmm/drive.py:21-240``),
which mirrors ``boxtree/fmm.py`` stage for stage: P2M, M2M, P2P over
List 1, M2L over List 2, M2P over per-level List 3, P2L over List 4, L2L,
L2P, over an abstract wrangler.
"""

from __future__ import annotations

import logging
import time
from abc import ABC, abstractmethod

import torch

logger = logging.getLogger(__name__)

#: the wrangler methods :func:`drive_fmm` times when asked to
FMM_STAGES = ("form_multipoles", "coarsen_multipoles", "eval_direct",
              "multipole_to_local", "eval_multipoles", "form_locals",
              "refine_locals", "eval_locals")


class TreeIndependentDataForWrangler:
    """Kernel-specific, tree-independent data (``boxtree/fmm.py:51-66``)."""


class ExpansionWranglerInterface(ABC):
    """Abstract expansion handling interface for :func:`drive_fmm`
    (``boxtree/fmm.py:69-337``)."""

    #: trailing dims of per-target potentials: () for scalar potentials,
    #: (2,) for kernels whose complex potential is carried as ``[re, im]``
    #: real lanes (the real-pair Helmholtz wranglers;
    #: ``boxtree_tpu/fmm/drive.py:29-32``)
    _pot_extra_dims = ()

    def __init__(self, tree_indep, traversal):
        self.tree_indep = tree_indep
        self.traversal = traversal

    @property
    def tree(self):
        return self.traversal.tree

    def potential_box_map(self):
        """Box id owning each output-potential slot: what the distributed
        runner masks potentials by
        (``boxtree_tpu/models/expansion_base.py:602-605``)."""
        return self.tree.box_id_of_target

    @abstractmethod
    def reorder_sources(self, source_array):
        pass

    @abstractmethod
    def reorder_potentials(self, potentials):
        pass

    @abstractmethod
    def multipole_expansions_view(self, mpole_exps, level):
        pass

    @abstractmethod
    def local_expansions_view(self, local_exps, level):
        pass

    @abstractmethod
    def form_multipoles(self, level_start_source_box_nrs, source_boxes,
                        src_weight_vecs):
        pass

    @abstractmethod
    def coarsen_multipoles(self, level_start_source_parent_box_nrs,
                           source_parent_boxes, mpoles):
        pass

    @abstractmethod
    def eval_direct(self, target_boxes, neighbor_sources_starts,
                    neighbor_sources_lists, src_weight_vecs):
        pass

    @abstractmethod
    def multipole_to_local(self, level_start_target_or_target_parent_box_nrs,
                           target_or_target_parent_boxes, starts, lists,
                           mpole_exps):
        pass

    @abstractmethod
    def eval_multipoles(self, target_boxes_by_source_level,
                        from_sep_smaller_by_level, mpole_exps):
        pass

    @abstractmethod
    def form_locals(self, level_start_target_or_target_parent_box_nrs,
                    target_or_target_parent_boxes, starts, lists,
                    src_weight_vecs, local_exps=None):
        """List-4 local expansions, added in place into *local_exps* when
        it is given (else into zeros); returns the sum."""

    @abstractmethod
    def refine_locals(self, level_start_target_or_target_parent_box_nrs,
                      target_or_target_parent_boxes, local_exps):
        pass

    @abstractmethod
    def eval_locals(self, level_start_target_box_nrs, target_boxes,
                    local_exps):
        pass

    @abstractmethod
    def finalize_potentials(self, potentials):
        pass

    # {{{ distributed hooks (no-ops, boxtree/fmm.py:281-337)

    def distribute_source_weights(self, src_weight_vecs, src_idx_all_ranks):
        return src_weight_vecs

    def gather_potential_results(self, potentials, tgt_idx_all_ranks):
        return potentials

    def communicate_mpoles(self, mpole_exps, return_stats=False):
        return mpole_exps

    # }}}


class _TimedWrangler:
    """Adds each stage's synchronised wall time to *timing_data*."""

    def __init__(self, inner, timing_data):
        self._inner = inner
        self._timing_data = timing_data

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in FMM_STAGES:
            return attr
        device = self._inner.tree.sources.device

        def timed(*args, **kwargs):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = attr(*args, **kwargs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self._timing_data[name] = (self._timing_data.get(name, 0.0)
                                       + time.perf_counter() - t0)
            return out
        return timed


def drive_fmm(wrangler, src_weight_vecs, *, global_src_idx_all_ranks=None,
              global_tgt_idx_all_ranks=None, timing_data=None):
    """Top-level FMM driver (``boxtree/fmm.py:342-532``).

    :arg timing_data: optional dict; if given, every stage's wall time
        (device-synchronised) is added to it under the stage's method name.
    """
    traversal = wrangler.traversal
    if timing_data is not None:
        wrangler = _TimedWrangler(wrangler, timing_data)

    src_weight_vecs = [wrangler.reorder_sources(w) for w in src_weight_vecs]
    src_weight_vecs = wrangler.distribute_source_weights(
        src_weight_vecs, global_src_idx_all_ranks)

    # Step 2.1: construct local multipoles
    mpole_exps = wrangler.form_multipoles(
        traversal.level_start_source_box_nrs,
        traversal.source_boxes,
        src_weight_vecs)

    # Step 2.2: propagate multipoles upward
    mpole_exps = wrangler.coarsen_multipoles(
        traversal.level_start_source_parent_box_nrs,
        traversal.source_parent_boxes,
        mpole_exps)

    mpole_exps = wrangler.communicate_mpoles(mpole_exps)

    # Stage 3: direct evaluation from neighbor source boxes ("list 1")
    potentials = wrangler.eval_direct(
        traversal.target_boxes,
        traversal.neighbor_source_boxes_starts,
        traversal.neighbor_source_boxes_lists,
        src_weight_vecs)

    # Stage 4: translate separated siblings' ("list 2") mpoles to local
    local_exps = wrangler.multipole_to_local(
        traversal.level_start_target_or_target_parent_box_nrs,
        traversal.target_or_target_parent_boxes,
        traversal.from_sep_siblings_starts,
        traversal.from_sep_siblings_lists,
        mpole_exps)

    # Stage 5: evaluate separated smaller mpoles ("list 3") at particles
    potentials = potentials + wrangler.eval_multipoles(
        traversal.target_boxes_sep_smaller_by_source_level,
        traversal.from_sep_smaller_by_level,
        mpole_exps)

    if traversal.from_sep_close_smaller_starts is not None:
        potentials = potentials + wrangler.eval_direct(
            traversal.target_boxes,
            traversal.from_sep_close_smaller_starts,
            traversal.from_sep_close_smaller_lists,
            src_weight_vecs)

    # Stage 6: add locals for separated bigger source boxes ("list 4")
    # into the List-2 locals, in place
    local_exps = wrangler.form_locals(
        traversal.level_start_target_or_target_parent_box_nrs,
        traversal.target_or_target_parent_boxes,
        traversal.from_sep_bigger_starts,
        traversal.from_sep_bigger_lists,
        src_weight_vecs, local_exps)

    if traversal.from_sep_close_bigger_starts is not None:
        potentials = potentials + wrangler.eval_direct(
            traversal.target_boxes,
            traversal.from_sep_close_bigger_starts,
            traversal.from_sep_close_bigger_lists,
            src_weight_vecs)

    # Stage 7: propagate local_exps downward
    local_exps = wrangler.refine_locals(
        traversal.level_start_target_or_target_parent_box_nrs,
        traversal.target_or_target_parent_boxes,
        local_exps)

    # Stage 8: evaluate locals
    potentials = potentials + wrangler.eval_locals(
        traversal.level_start_target_box_nrs,
        traversal.target_boxes,
        local_exps)

    potentials = wrangler.gather_potential_results(
        potentials, global_tgt_idx_all_ranks)
    result = wrangler.reorder_potentials(potentials)
    logger.debug("drive_fmm: done")
    return wrangler.finalize_potentials(result)
