"""FMM cost model: per-stage and per-box operation counts, translation
cost formulas, and calibration against measured timings.

Port of :mod:`boxtree_tpu.cost.model` (``boxtree_tpu/cost/model.py:1-451``),
which mirrors ``boxtree/cost.py``:

- :class:`FMMTranslationCostModel` (``cost.py:87-147``): per-translation
  costs by expansion size, the PDE-aware ``(p+1)^(d-1)`` flavour (with
  point-and-shoot M2L in 3D) and the Taylor ``(p+1)^d`` one
  (``cost.py:152-179``).
- :class:`FMMCostModel`: the model over a built traversal, per stage
  (``cost_per_stage``) or per box (``cost_per_box``, the input of the
  distributed partition), and the least-squares calibration
  (``estimate_calibration_params``).

Both evaluation flavours of the reference are kept, over one body
(:meth:`AbstractFMMCostModel._stage_terms`): :class:`FMMCostModel`
evaluates on the traversal's device and :class:`PythonFMMCostModel` on the
host, scattering per-level operator-cost tables over the CSR lists' edges.
Everything is float64; the per-box sums are ``index_add_`` over the edges'
target boxes.
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.traversal.containers import csr_rows

_F64 = torch.float64


class FMMTranslationCostModel:
    """Per-translation cost formulas.  Each method returns the cost of one
    translation of a level (an int, or a tensor of levels)."""

    def __init__(self, ncoeffs_fmm_by_level, uses_point_and_shoot=False):
        self.ncoeffs_fmm_by_level = np.asarray(ncoeffs_fmm_by_level,
                                               np.float64)
        self.uses_point_and_shoot = uses_point_and_shoot

    def _ncoeffs(self, level):
        if isinstance(level, torch.Tensor):
            table = torch.as_tensor(self.ncoeffs_fmm_by_level,
                                    device=level.device)
            return table[level.to(torch.int64)]
        return self.ncoeffs_fmm_by_level[level]

    def p2qbxl(self):
        return 1.0

    def p2p(self):
        return 1.0

    def p2m(self, level):
        return self._ncoeffs(level)

    def l2p(self, level):
        return self._ncoeffs(level)

    def m2p(self, level):
        return self._ncoeffs(level)

    def p2l(self, level):
        return self._ncoeffs(level)

    def m2m(self, src_level, tgt_level):
        return self.e2e_cost(self._ncoeffs(src_level),
                             self._ncoeffs(tgt_level))

    def l2l(self, src_level, tgt_level):
        return self.e2e_cost(self._ncoeffs(src_level),
                             self._ncoeffs(tgt_level))

    def m2l(self, src_level, tgt_level):
        return self.e2e_cost(self._ncoeffs(src_level),
                             self._ncoeffs(tgt_level))

    def e2e_cost(self, nsource_coeffs, ntarget_coeffs):
        """Expansion-to-expansion translation cost
        (``boxtree/cost.py:134-147``)."""
        if self.uses_point_and_shoot:
            return (nsource_coeffs ** 1.5
                    + nsource_coeffs ** 0.5 * ntarget_coeffs
                    + ntarget_coeffs ** 1.5)
        return nsource_coeffs * ntarget_coeffs


def make_pde_aware_translation_cost_model(dim, nlevels):
    """Costs for FMMs with PDE-aware expansion counts ~ (p+1)^(d-1)
    (``boxtree/cost.py:152-166``); the per-level orders come at evaluation
    time, through ``with_orders(level_to_order)``."""
    return _DeferredOrderCostModel(
        lambda p: (p + 1) ** (dim - 1), nlevels,
        uses_point_and_shoot=(dim == 3))


def make_taylor_translation_cost_model(dim, nlevels):
    """Costs for Taylor-expansion FMMs ~ (p+1)^d
    (``boxtree/cost.py:169-179``)."""
    return _DeferredOrderCostModel(
        lambda p: (p + 1) ** dim, nlevels, uses_point_and_shoot=False)


class _DeferredOrderCostModel:
    def __init__(self, ncoeffs_of_order, nlevels, uses_point_and_shoot):
        self.ncoeffs_of_order = ncoeffs_of_order
        self.nlevels = nlevels
        self.uses_point_and_shoot = uses_point_and_shoot

    def with_orders(self, level_to_order):
        ncoeffs = [self.ncoeffs_of_order(level_to_order[lev])
                   for lev in range(self.nlevels)]
        return FMMTranslationCostModel(
            ncoeffs, uses_point_and_shoot=self.uses_point_and_shoot)


FMM_STAGES = (
    "form_multipoles", "coarsen_multipoles", "eval_direct",
    "multipole_to_local", "eval_multipoles", "form_locals",
    "refine_locals", "eval_locals")


class AbstractFMMCostModel:
    """Shared stage-count machinery: every stage is a (box ids, per-term
    costs) pair on the device that :meth:`_device` names, the costs
    gathered from per-level operator-cost tables (built on the host, a few
    numbers each); the per-stage cost is each pair's sum, the per-box
    vector one ``index_add_`` a stage."""

    def __init__(self, translation_cost_model_factory=None):
        self.translation_cost_model_factory = (
            translation_cost_model_factory
            or make_pde_aware_translation_cost_model)

    def _device(self, traversal):
        return traversal.tree.box_levels.device

    def _gather(self, traversal):
        dev = self._device(traversal)
        tree = traversal.tree

        def get(x):
            return x.to(dev, torch.int64)

        return {
            "levels": get(tree.box_levels),
            "src_cnt": get(tree.box_source_counts_nonchild),
            "tgt_cnt": get(tree.box_target_counts_nonchild),
            "parents": get(tree.box_parent_ids),
            "source_boxes": get(traversal.source_boxes),
            "target_boxes": get(traversal.target_boxes),
            "totp": get(traversal.target_or_target_parent_boxes),
            "spb": get(traversal.source_parent_boxes),
            "l1_starts": get(traversal.neighbor_source_boxes_starts),
            "l1_lists": get(traversal.neighbor_source_boxes_lists),
            "l2_starts": get(traversal.from_sep_siblings_starts),
            "l2_lists": get(traversal.from_sep_siblings_lists),
            "l4_starts": get(traversal.from_sep_bigger_starts),
            "l4_lists": get(traversal.from_sep_bigger_lists),
            "l3": [(lvl, get(ssn.starts), int(ssn.count), get(
                traversal.target_boxes_sep_smaller_by_source_level[lvl]))
                for lvl, ssn in enumerate(traversal.from_sep_smaller_by_level)
                if ssn.count],
        }

    def _xlat(self, tree, level_to_order):
        return self.translation_cost_model_factory(
            tree.dimensions, tree.nlevels).with_orders(level_to_order)

    def _tables(self, tree, level_to_order, c, device):
        nlevels = tree.nlevels
        xlat = self._xlat(tree, level_to_order)
        levs = range(nlevels)

        def t1(f, cc):
            return torch.tensor([float(f(lv)) * cc for lv in levs],
                                dtype=_F64, device=device)

        def t2(f, cc):
            return torch.tensor([[float(f(s, t)) * cc for t in levs]
                                 for s in levs], dtype=_F64, device=device)

        return {
            "p2m": t1(xlat.p2m, c["c_p2m"]),
            "l2p": t1(xlat.l2p, c["c_l2p"]),
            "m2p": t1(xlat.m2p, c["c_m2p"]),
            "p2l": t1(xlat.p2l, c["c_p2l"]),
            "m2m": t2(xlat.m2m, c["c_m2m"]),
            "l2l": t2(xlat.l2l, c["c_l2l"]),
            "m2l": t2(xlat.m2l, c["c_m2l"]),
        }

    def _stage_terms(self, traversal, level_to_order, c):
        """Per stage: (box ids, per-term costs) scatter pairs."""
        tree = traversal.tree
        g = self._gather(traversal)
        dev = g["levels"].device
        t = self._tables(tree, level_to_order, c, dev)
        lev = g["levels"]
        src_cnt, tgt_cnt = g["src_cnt"].to(_F64), g["tgt_cnt"].to(_F64)
        parents = g["parents"]
        terms = {}

        sb = g["source_boxes"]
        terms["form_multipoles"] = (sb, src_cnt[sb] * t["p2m"][lev[sb]])

        # M2M: one link per box whose parent is a source-parent box
        spb_mask = torch.zeros(tree.nboxes, dtype=torch.bool, device=dev)
        spb_mask[g["spb"]] = True
        ball = torch.arange(1, tree.nboxes, device=dev)
        pball = parents[ball]
        is_link = spb_mask[pball]
        zero = torch.zeros((), dtype=_F64, device=dev)
        terms["coarsen_multipoles"] = (
            torch.where(is_link, pball, 0),
            torch.where(is_link, t["m2m"][lev[ball], lev[pball]], zero))

        l1 = g["l1_lists"]
        tgt = g["target_boxes"][csr_rows(g["l1_starts"], l1.shape[0])]
        terms["eval_direct"] = (tgt, tgt_cnt[tgt] * src_cnt[l1] * c["c_p2p"])

        l2 = g["l2_lists"]
        tgt = g["totp"][csr_rows(g["l2_starts"], l2.shape[0])]
        terms["multipole_to_local"] = (tgt, t["m2l"][lev[l2], lev[tgt]])

        m2p_idx, m2p_val = [], []
        for lvl, starts, count, tb in g["l3"]:
            rows = tb[csr_rows(starts, count)]
            m2p_idx.append(rows)
            m2p_val.append(tgt_cnt[rows] * t["m2p"][lvl])
        terms["eval_multipoles"] = (
            (torch.cat(m2p_idx), torch.cat(m2p_val)) if m2p_idx else
            (torch.zeros(0, dtype=torch.int64, device=dev),
             torch.zeros(0, dtype=_F64, device=dev)))

        l4 = g["l4_lists"]
        tgt = g["totp"][csr_rows(g["l4_starts"], l4.shape[0])]
        terms["form_locals"] = (tgt, src_cnt[l4] * t["p2l"][lev[tgt]])

        totp = g["totp"]
        terms["refine_locals"] = (
            totp, torch.where(lev[totp] > 0,
                              t["l2l"][lev[parents[totp]], lev[totp]], zero))

        tb = g["target_boxes"]
        terms["eval_locals"] = (tb, tgt_cnt[tb] * t["l2p"][lev[tb]])
        return terms

    def cost_per_stage(self, traversal, level_to_order,
                       calibration_params=None):
        c = calibration_params or self.get_unit_calibration_params()
        terms = self._stage_terms(traversal, level_to_order, c)
        totals = torch.stack([v.sum() for _i, v in terms.values()]).tolist()
        return dict(zip(terms, totals))

    def cost_per_box(self, traversal, level_to_order,
                     calibration_params=None):
        c = calibration_params or self.get_unit_calibration_params()
        terms = self._stage_terms(traversal, level_to_order, c)
        cost = torch.zeros(traversal.tree.nboxes, dtype=_F64,
                           device=self._device(traversal))
        for idx, val in terms.values():
            cost.index_add_(0, idx, val)
        return cost

    @staticmethod
    def get_unit_calibration_params():
        """All-ones calibration (``boxtree/cost.py:640-648``)."""
        return {f"c_{s}": 1.0 for s in
                ("p2m", "m2m", "p2p", "m2l", "m2p", "p2l", "l2l", "l2p")}

    def estimate_calibration_params(self, model_results, timing_results,
                                    wall_time_field="wall_elapsed"):
        """Least-squares fit of per-stage parameters from modeled counts
        and measured stage timings (``boxtree/cost.py:650-708``).

        :arg model_results: list of per-stage count dicts (from
            ``cost_per_stage`` with unit calibration).
        :arg timing_results: list of dicts stage -> seconds (such as
            :func:`~boxtree_torch.fmm.drive_fmm`'s ``timing_data``).
        """
        stage_to_param = {
            "form_multipoles": "c_p2m", "coarsen_multipoles": "c_m2m",
            "eval_direct": "c_p2p", "multipole_to_local": "c_m2l",
            "eval_multipoles": "c_m2p", "form_locals": "c_p2l",
            "refine_locals": "c_l2l", "eval_locals": "c_l2p"}
        params = {}
        for stage, pname in stage_to_param.items():
            counts = np.array([m[stage] for m in model_results])
            times = np.array([t.get(stage, 0.0) for t in timing_results])
            denom = np.sum(counts * counts)
            params[pname] = float(np.sum(counts * times) / denom) \
                if denom > 0 else 0.0
        return params

    @staticmethod
    def aggregate_over_boxes(per_box):
        return float(torch.as_tensor(per_box, dtype=_F64).sum())


class PythonFMMCostModel(AbstractFMMCostModel):
    """Host evaluation, the reference's pure-Python flavour
    (``boxtree/cost.py:1264``): the traversal's arrays are copied to the
    CPU."""

    def _device(self, traversal):
        return torch.device("cpu")

    def cost_per_stage(self, traversal, level_to_order,
                       calibration_params=None):
        """As the base class's, but a translation model that gives one
        number for all of a stage's translations (no tensor) has it counted
        once in that stage, as the reference's ``np.sum`` of a scalar
        does."""
        out = super().cost_per_stage(traversal, level_to_order,
                                     calibration_params)
        c = calibration_params or self.get_unit_calibration_params()
        xlat = self._xlat(traversal.tree, level_to_order)
        lev = torch.zeros(1, dtype=torch.int64)
        for stage, op in (("coarsen_multipoles", "m2m"),
                          ("multipole_to_local", "m2l"),
                          ("refine_locals", "l2l")):
            v = getattr(xlat, op)(lev, lev)
            if not isinstance(v, torch.Tensor):
                out[stage] = float(v) * c[f"c_{op}"]
        return out


class FMMCostModel(AbstractFMMCostModel):
    """Evaluation on the traversal's device, the analogue of the
    reference's OpenCL flavour (``boxtree/cost.py:715-1257``): nothing
    large goes through the host."""

