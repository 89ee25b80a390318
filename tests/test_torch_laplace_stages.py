"""Each 3D Laplace FMM stage of boxtree_torch against boxtree_tpu's, in
float64, on the reference's own tree and traversal (bridged), so a stage
failure is never a traversal failure in disguise.

Every stage gets the reference's own inputs (the reference's outputs of the
stages before it).  Tolerance: rel l-inf (divided by max |ref|) <= 1e-11:
the same math, summed in another order.  Surface points, because uniform
clouds of this size have no List 3 or List 4.

P2P is held instead to an independent float64 direct sum over the same
List-1 box pairs, correctly rounded per target (``math.fsum``), within
``P2P_EPS_COND`` times ``eps * sum_j |q_j| / r_ij``, the sum's own
condition number.  Against boxtree_tpu it agreed to 4e-16 in every run
but one of the whole suite under xdist, where every element differed by
about 5e-10 (rel 1.3e-11); the direct sum does not depend on what else
ran in the process.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxtree_tpu
from boxtree_torch.models import make_laplace_wrangler
from boxtree_torch.utils.bridge import traversal_from_numpy
from boxtree_tpu.models.laplace import (
    make_laplace_wrangler as jax_make_laplace_wrangler,
)
from boxtree_tpu.traversal import build_traversal as jax_build_traversal
from boxtree_tpu.utils.particles import make_surface_particle_array
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-11
#: the P2P tolerance in units of eps * sum_j |q_j| / r_ij per target: the
#: port and the reference both land within 1.3 of these units; the run in
#: which the two parted (by about 5e-10 on every target, whose sums have
#: condition numbers below 1.3e3) put them more than 1,600 apart
P2P_EPS_COND = 16
ORDER = 6
STAGES = ["P2M", "M2M", "P2P", "M2L", "M2P", "P2L", "M2L+P2L", "L2L",
          "L2P"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _direct_sum(trav, q_tree):
    """Per tree-order target: the correctly rounded float64 sum of
    ``q_j / r_ij`` over the sources of its List-1 boxes (``r = 0``
    skipped), and ``sum_j |q_j| / r_ij``."""
    tree = trav.tree
    tgt, src = tree.targets.numpy(), tree.sources.numpy()
    q = q_tree.numpy()
    tst = tree.box_target_starts.numpy()
    tcn = tree.box_target_counts_nonchild.numpy()
    sst = tree.box_source_starts.numpy()
    scn = tree.box_source_counts_nonchild.numpy()
    starts = trav.neighbor_source_boxes_starts.numpy()
    lists = trav.neighbor_source_boxes_lists.numpy()
    exact = np.zeros(tgt.shape[1])
    cond = np.zeros(tgt.shape[1])
    for row, box in enumerate(trav.target_boxes.numpy()):
        ti = np.arange(tst[box], tst[box] + tcn[box])
        sj = np.concatenate([np.arange(sst[b], sst[b] + scn[b])
                             for b in lists[starts[row]:starts[row + 1]]])
        r = np.sqrt(((tgt[:, ti, None] - src[:, None, sj]) ** 2).sum(0))
        terms = np.where(r > 0, q[sj] / np.where(r > 0, r, 1), 0)
        exact[ti] = [math.fsum(t) for t in terms]
        cond[ti] = np.abs(terms).sum(1)
    return exact, cond


@pytest.fixture(scope="module")
def stages():
    n = 3000
    pts = make_surface_particle_array(n, 3, np.float64, seed=11)
    q = np.random.default_rng(1).standard_normal(n)
    jtrav = jax_build_traversal(
        boxtree_tpu.build_tree(pts, max_particles_in_box=30))
    jw = jax_make_laplace_wrangler(jtrav, order=ORDER, pairs=True,
                                   rscale="auto", dtype=np.float64)
    trav = traversal_from_numpy(jtrav)
    w = make_laplace_wrangler(trav, order=ORDER, pairs=True, rscale="auto",
                              dtype=np.float64)

    jq = jw.reorder_sources(jnp.asarray(q))
    tq = w.reorder_sources(torch.from_numpy(q))
    out = {}

    mp = jw.form_multipoles(jtrav.level_start_source_box_nrs,
                            jtrav.source_boxes, [jq])
    out["P2M"] = (mp, w.form_multipoles(
        trav.level_start_source_box_nrs, trav.source_boxes, [tq]))
    mp_up = jw.coarsen_multipoles(jtrav.level_start_source_parent_box_nrs,
                                  jtrav.source_parent_boxes, mp)
    out["M2M"] = (mp_up, w.coarsen_multipoles(
        trav.level_start_source_parent_box_nrs, trav.source_parent_boxes,
        _t(mp)))
    out["P2P"] = (
        _direct_sum(trav, tq),
        w.eval_direct(trav.target_boxes, trav.neighbor_source_boxes_starts,
                      trav.neighbor_source_boxes_lists, [tq]))
    loc = jw.multipole_to_local(
        jtrav.level_start_target_or_target_parent_box_nrs,
        jtrav.target_or_target_parent_boxes, jtrav.from_sep_siblings_starts,
        jtrav.from_sep_siblings_lists, mp_up)
    out["M2L"] = (loc, w.multipole_to_local(
        trav.level_start_target_or_target_parent_box_nrs,
        trav.target_or_target_parent_boxes, trav.from_sep_siblings_starts,
        trav.from_sep_siblings_lists, _t(mp_up)))
    out["M2P"] = (
        jw.eval_multipoles(jtrav.target_boxes_sep_smaller_by_source_level,
                           jtrav.from_sep_smaller_by_level, mp_up),
        w.eval_multipoles(trav.target_boxes_sep_smaller_by_source_level,
                          trav.from_sep_smaller_by_level, _t(mp_up)))
    p2l = jw.form_locals(
        jtrav.level_start_target_or_target_parent_box_nrs,
        jtrav.target_or_target_parent_boxes, jtrav.from_sep_bigger_starts,
        jtrav.from_sep_bigger_lists, [jq])
    out["P2L"] = (p2l, w.form_locals(
        trav.level_start_target_or_target_parent_box_nrs,
        trav.target_or_target_parent_boxes, trav.from_sep_bigger_starts,
        trav.from_sep_bigger_lists, [tq]))
    # as drive_fmm calls it: P2L added in place into the M2L output
    out["M2L+P2L"] = (loc + p2l, w.form_locals(
        trav.level_start_target_or_target_parent_box_nrs,
        trav.target_or_target_parent_boxes, trav.from_sep_bigger_starts,
        trav.from_sep_bigger_lists, [tq], _t(loc)))
    loc = loc + p2l
    loc_down = jw.refine_locals(
        jtrav.level_start_target_or_target_parent_box_nrs,
        jtrav.target_or_target_parent_boxes, loc)
    out["L2L"] = (loc_down, w.refine_locals(
        trav.level_start_target_or_target_parent_box_nrs,
        trav.target_or_target_parent_boxes, _t(loc)))
    out["L2P"] = (
        jw.eval_locals(jtrav.level_start_target_box_nrs, jtrav.target_boxes,
                       loc_down),
        w.eval_locals(trav.level_start_target_box_nrs, trav.target_boxes,
                      _t(loc_down)))
    return out, trav, w, tq


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_reference(stages, stage):
    ref, got = stages[0][stage]
    got = got.numpy()
    if stage == "P2P":
        ref, cond = ref
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert (cond > 0).all()
        eps = np.finfo(np.float64).eps
        assert (np.abs(got - ref) <= P2P_EPS_COND * eps * cond).all()
        return
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() / scale <= RTOL


def test_list_stages_exercised(stages):
    trav = stages[1]
    assert sum(bl.count for bl in trav.from_sep_smaller_by_level) > 0
    assert trav.from_sep_bigger_lists.shape[0] > 0


@pytest.mark.parametrize("stage", ["M2L", "M2P", "P2L"])
def test_foreign_lists_raise(stages, stage):
    """M2L, M2P and P2L run on plans built from the wrangler's traversal,
    so lists that are not that traversal's own are refused."""
    _, trav, w, tq = stages
    lsb = trav.level_start_target_or_target_parent_box_nrs
    totp = trav.target_or_target_parent_boxes
    mp = w.multipole_expansion_zeros()
    with pytest.raises(ValueError, match="traversal's own"):
        if stage == "M2L":
            w.multipole_to_local(lsb, totp, trav.from_sep_siblings_starts,
                                 trav.from_sep_siblings_lists.clone(), mp)
        elif stage == "M2P":
            w.eval_multipoles(trav.target_boxes_sep_smaller_by_source_level,
                              list(trav.from_sep_smaller_by_level), mp)
        else:
            w.form_locals(lsb, totp, trav.from_sep_bigger_starts.clone(),
                          trav.from_sep_bigger_lists, [tq])


def test_m2l_pair_count_mismatch_raises(stages):
    trav = stages[1]
    broken = dataclasses.replace(
        trav, from_sep_siblings_lists=trav.from_sep_siblings_lists[:-1])
    with pytest.raises(RuntimeError, match="List-2 pairs"):
        make_laplace_wrangler(broken, order=2, pairs=True)
