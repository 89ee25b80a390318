"""Kernel-independent plumbing of the expansion wranglers.

Port of :class:`boxtree_tpu.models.expansion_base.ExpansionWranglerBase`
(``expansion_base.py:212-1803``) with one formulation per stage:

- P2M and L2P: the hooks ``_p2m`` / ``_l2p``; every wrangler launches
  the kernels of its module (:mod:`boxtree_torch.ops.laplace2d`,
  :mod:`~boxtree_torch.ops.laplace3d`,
  :mod:`~boxtree_torch.ops.helmholtz3d`,
  :mod:`~boxtree_torch.ops.helmholtz2d`) over the rows
  :attr:`_source_rows` / :attr:`_target_rows` (the boxes that own
  particles, on every level);
- M2M, M2L and L2L: the kernels of :mod:`boxtree_torch.ops.translate`
  (K36, K35, K37), gathered rows of expansions times operator tables
  built once at setup: M2M and L2L per (level, child digit), one launch a
  level; M2L in the parent-block form (``expansion_base.py:915-1086``),
  one table entry per (level, translation class) that List 2 uses and
  one launch for all levels, with no host read; the table comes from the
  subclass's ``_m2l_table`` (the Laplace wranglers: one kernel launch for
  all levels, :mod:`boxtree_torch.ops.m2l_ops`);
- with ``m2l_mode="rotation"`` (``expansion_base.py:361-378``; 3D
  Laplace only), M2L runs the rotation form instead
  (:mod:`boxtree_torch.models.rotation_m2l`, K77-K79) over List 2's
  edges classified by (level, class)
  (:class:`~boxtree_torch.models.particle_blocks.M2LPlan`), and no dense
  table is built;
- P2P, M2P, P2L: the list kernels of each wrangler's module.

Subclasses provide ``_ncoeff``, the particle hooks ``_p2m`` and
``_l2p``, the batched operator builders ``_m2m_matrices``,
``_l2l_matrices`` and ``_m2l_matrices`` (numpy or a tensor), which
:meth:`_operator` turns into tensors of the coefficient dtype (or, for
M2L, a ``_m2l_table`` of their own), and the list-stage hooks ``_p2p``,
``_m2p`` and ``_p2l``.  Coefficients and
potentials are of the wrangler's ``dtype`` (real, or complex); box
geometry, particles and rscales of its real counterpart, ``real_dtype``.

Two options follow the reference (``expansion_base.py:227-347``):

- ``dipole_vec``: the sources are dipoles, for the classes that set
  ``_supports_dipoles``: their P2M and list-stage hooks read
  :attr:`dipole_vec` and launch their dipole kernels.
- ``level_to_order``: expansions keep the maximum order with each level's
  tail masked to zero (after P2M, after P2L and on L2P's input), and the
  M2M, L2L and M2L operators are truncated to the orders of the levels
  they join; the subclass gives each coefficient's order
  (``_coeff_orders``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from boxtree_torch.config import as_torch_dtype
from boxtree_torch.fmm.drive import ExpansionWranglerInterface
from boxtree_torch.ops import morton, rotation, translate
from boxtree_torch.traversal.containers import compressed_csr, csr_rows
from boxtree_torch.traversal.neighbors import _offsets

def merge_list3(target_boxes_by_source_level, from_sep_smaller_by_level):
    """Merge the per-source-level List-3 CSRs into one CSR over target
    boxes: ``(rows, starts, lists)`` with ``rows`` the target boxes that
    have List-3 entries (ascending) and ``lists`` their source boxes
    (``expansion_base.py:76-95``)."""
    keys = [(tgts.to(torch.int64)[csr_rows(bl.starts, bl.count)] << 32)
            | bl.lists.to(torch.int64)
            for tgts, bl in zip(target_boxes_by_source_level,
                                from_sep_smaller_by_level) if bl.count]
    if not keys:
        return None
    return compressed_csr(torch.sort(torch.cat(keys)).values)


def nonempty_rows(row_boxes, starts, lists):
    """Compress a CSR list over *row_boxes* to its nonempty rows:
    ``(rows, starts, lists)`` with ``rows`` naming boxes."""
    starts = starts.to(torch.int64)
    counts = starts[1:] - starts[:-1]
    keep = counts > 0
    new_starts = torch.zeros(int(keep.sum()) + 1, dtype=torch.int64,
                             device=starts.device)
    new_starts[1:] = torch.cumsum(counts[keep], 0)
    return (row_boxes[keep].to(torch.int32), new_starts.to(torch.int32),
            lists.to(torch.int32).contiguous())


def rows_with_particles(*box_counts):
    """For each ``(nboxes,)`` count array, the int32 ids (ascending) of the
    boxes whose count is positive, with one host read for all of them."""
    masks = [c > 0 for c in box_counts]
    totals = torch.stack([m.sum() for m in masks]).tolist()
    out = []
    for mask, n in zip(masks, totals):
        # the positive boxes go to their ranks, the others past the end
        pos = torch.where(mask, torch.cumsum(mask, 0) - 1, n)
        rows = torch.empty(mask.shape[0] + 1, dtype=torch.int32,
                           device=mask.device)
        rows[pos] = torch.arange(mask.shape[0], dtype=torch.int32,
                                 device=mask.device)
        out.append(rows[:n])
    return out


class ExpansionWranglerBase(ExpansionWranglerInterface):
    """Kernel-independent expansion wrangler plumbing; see module doc."""

    dtype = torch.float64
    _supports_rscale = False
    #: whether the list-stage hooks have dipole kernels
    _supports_dipoles = False
    #: the particle stages' kernel wrappers, ``{stage: wrapper}``, the
    #: dipole forms under ``"<stage>_dipole"``
    _kernels = None
    #: why ``m2l_mode="rotation"`` is refused, or None where it is taken
    _rotation_refusal = "rotation M2L is ported for 3D Laplace only"

    def __init__(self, tree_indep, traversal, rscale=None, dtype=None,
                 dipole_vec=None, dipoles_already_reordered=False,
                 level_to_order=None, m2l_mode="dense"):
        """:arg rscale: per-level expansion scaling: ``None`` (off),
            ``"auto"`` (``min(root_extent * 2^-level, 1)``), or an
            ``(nlevels,)`` array (``expansion_base.py:282-304``).
        :arg dtype: real dtype of coefficients and potentials.
        :arg dipole_vec: ``(dim, nsources)``, in user order unless
            *dipoles_already_reordered*: the potential of source ``y`` of
            weight ``w`` is ``w (dipole_vec . grad_y) G(x, y)``
            (``expansion_base.py:231-238``).
        :arg level_to_order: ``level -> order`` (the reference's
            ``fmm_level_to_order``); the wrangler's order must be the
            largest of them.
        :arg m2l_mode: ``"dense"`` (K35 over the operator table) or
            ``"rotation"`` (point-and-shoot, 3D Laplace without
            ``level_to_order``; ``expansion_base.py:361-378``).
        """
        if m2l_mode not in ("dense", "rotation"):
            raise ValueError(f"bad m2l_mode: {m2l_mode!r}")
        if m2l_mode == "rotation":
            if traversal.tree.dimensions != 3:
                raise NotImplementedError("rotation M2L is 3D-only")
            if level_to_order is not None:
                raise NotImplementedError(
                    "rotation M2L with level_to_order truncation")
            if self._rotation_refusal is not None:
                raise NotImplementedError(self._rotation_refusal)
        self.m2l_mode = m2l_mode
        super().__init__(tree_indep, traversal)
        if dtype is not None:
            self.dtype = as_torch_dtype(dtype)
        tree = traversal.tree
        self.dim = tree.dimensions
        self.ncoeff = self._ncoeff()
        dev = self.device = tree.box_levels.device
        dt = self.real_dtype = self.dtype.to_real()
        nlevels = tree.nlevels
        root = float(tree.root_extent)
        self.root_extent = root
        self._lsb = tree.level_start_box_nrs
        self._box_levels = tree.box_levels.to(torch.int64)

        if level_to_order is None:
            self.level_orders = self._level_mask = None
        else:
            self.level_orders = np.array(
                [int(level_to_order(lev)) for lev in range(nlevels)])
            self._level_mask = torch.as_tensor(
                np.asarray(self._coeff_orders())[None, :]
                <= self.level_orders[:, None], device=dev)

        if dipole_vec is not None:
            if not self._supports_dipoles:
                raise NotImplementedError(
                    f"{type(self).__name__} has no dipole kernels yet")
            dipole_vec = torch.as_tensor(dipole_vec, device=dev)
            if tuple(dipole_vec.shape) != (self.dim, tree.nsources):
                raise ValueError("dipole_vec must have shape "
                                 "(dimensions, nsources)")
            if not dipoles_already_reordered:
                dipole_vec = dipole_vec[
                    :, tree.user_source_ids.to(torch.int64)]
            dipole_vec = dipole_vec.to(dt).contiguous()
        self.dipole_vec = dipole_vec

        if rscale is None:
            rs = np.ones(nlevels)
        else:
            if not self._supports_rscale:
                raise NotImplementedError(
                    f"{type(self).__name__} does not implement rscale")
            if isinstance(rscale, str):
                if rscale != "auto":
                    raise ValueError(f"bad rscale: {rscale!r}")
                rs = np.minimum(root * 2.0 ** -np.arange(nlevels)
                                * self._rscale_factor(), 1.0)
            else:
                rs = np.asarray(rscale, np.float64)
                if rs.shape != (nlevels,):
                    raise ValueError("rscale must have shape (nlevels,)")
        self._rscale_np = rs
        scale_of_level = torch.as_tensor(rs, dtype=dt, device=dev)
        self.box_scale = scale_of_level[tree.box_levels.to(torch.int64)]

        # particle and box geometry in the wrangler's real dtype
        self.centers = tree.box_centers.to(dt).contiguous()
        self._sources = tree.sources.to(dt).contiguous()
        self._targets = (self._sources if tree.sources_are_targets
                         else tree.targets.to(dt).contiguous())
        # the boxes that own sources / targets themselves, on every level
        # (the P2M and L2P kernels' rows)
        self._source_rows, self._target_rows = rows_with_particles(
            tree.box_source_counts_nonchild, tree.box_target_counts_nonchild)

        nchild = 2 ** self.dim
        # (nboxes, 2^d) children by digit, and those that are
        # target-or-target-parent boxes; -1 for none
        child = tree.box_child_ids.T.to(torch.int32)
        child = torch.where(child > 0, child, -1).contiguous()
        totp = traversal.target_or_target_parent_boxes
        is_totp = torch.zeros(tree.nboxes + 1, dtype=torch.bool, device=dev)
        is_totp[totp.to(torch.int64)] = True
        self._child = child
        self._tgt_child = torch.where(is_totp[child.to(torch.int64)], child,
                                      -1).contiguous()

        # {{{ M2M / L2L: per (level, digit) operators, the L2L parent rows

        # (2^d, d) child cell signs, in digit order
        signs = np.array([[1.0 if (q >> (self.dim - 1 - ax)) & 1 else -1.0
                           for ax in range(self.dim)]
                          for q in range(nchild)])
        self._m2m_opsT, self._l2l_opsT = {}, {}
        for lev in range(1, nlevels):
            child_off = signs * (root / (1 << lev) / 2)  # c_child - c_parent
            self._m2m_opsT[lev] = self._truncate(self._operator(
                self._m2m_matrices(-child_off, rs[lev], rs[lev - 1])),
                lev - 1, lev).transpose(1, 2).contiguous()
            self._l2l_opsT[lev] = self._truncate(self._operator(
                self._l2l_matrices(child_off, rs[lev - 1], rs[lev])),
                lev, lev - 1).transpose(1, 2).contiguous()

        # the target-or-target-parent boxes of each level: their children
        # at the next level take L2L from them
        ls_totp = [int(x) for x in
                   traversal.level_start_target_or_target_parent_box_nrs
                   .cpu()]
        totp = totp.to(torch.int32)
        self._l2l_rows = {lev: totp[ls_totp[lev - 1]:ls_totp[lev]]
                          for lev in range(1, nlevels)}

        # }}}

        self._m2l_rot = None
        if m2l_mode == "rotation":
            self._build_m2l_rotation()
        else:
            self._build_m2l_parent_plan()

        # List 3 merged over source levels, List 4 compressed to its
        # nonempty rows (the kernels' row sets)
        self._l3_csr = merge_list3(
            traversal.target_boxes_sep_smaller_by_source_level,
            traversal.from_sep_smaller_by_level)
        self._l4_csr = nonempty_rows(
            traversal.target_or_target_parent_boxes,
            traversal.from_sep_bigger_starts,
            traversal.from_sep_bigger_lists)

    # {{{ kernel hooks

    def _ncoeff(self):
        raise NotImplementedError

    def _coeff_orders(self):
        """``(ncoeff,)`` the least order that holds each coefficient
        (``expansion_base.py:521-524``): what ``level_to_order`` masks
        by."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement level_to_order yet")

    def _rscale_factor(self):
        """Factor of the ``"auto"`` rscale (the reference's
        ``_rscale_factor``, ``expansion_base.py:526-529``): 1, or
        ``|k|`` for oscillatory kernels."""
        return 1.0

    def _p2m(self, src_weights):
        """Multipoles ``(nboxes, K)`` of the tree-order *src_weights*,
        before the level mask (``expansion_base.py:651-677``)."""
        raise NotImplementedError

    def _l2p(self, local_exps):
        """Potentials (tree-order targets) of the masked *local_exps*
        (``expansion_base.py:1793-1803``)."""
        raise NotImplementedError

    def _m2m_matrices(self, ts, r_child, r_parent):
        """(n, K, K) M2M operators of the shifts *ts* ``(n, d)`` (new
        centre - old)."""
        raise NotImplementedError

    def _l2l_matrices(self, ts, r_parent, r_child):
        """(n, K, K) L2L operators of the shifts *ts*."""
        raise NotImplementedError

    def _m2l_matrices(self, classes, size, r):
        """(C, K, K) M2L operators of the translations ``classes * size``
        (``c_tgt - c_src``) at rscale *r*."""
        raise NotImplementedError

    def _m2l_table(self, used, classes):
        """``(nops, K, K)`` transposed M2L operators, truncated, of the
        used ``(level, class)`` pairs of *classes*, in the wrangler's dtype:
        per level one ``_m2l_matrices`` call on its used classes."""
        mats = []
        for lev in sorted({lev for lev, _ in used}):
            used_c = [c for lv, c in used if lv == lev]
            size = self.root_extent / (1 << lev)
            mats.append(self._truncate(self._operator(self._m2l_matrices(
                classes[used_c], size, float(self._rscale_np[lev]))),
                lev, lev).transpose(1, 2))
        k = self.ncoeff
        return (torch.cat(mats).contiguous() if mats else torch.zeros(
            (0, k, k), dtype=self.dtype, device=self.device))

    def _m2l_table_inputs(self, used, classes):
        """Per used ``(level, class)``: the translation ``classes[c] *
        size`` (``c_tgt - c_src``), the level's rscale and the level, as
        host arrays: what the M2L table builders take."""
        ts = np.zeros((len(used), self.dim))
        for i, (lev, c) in enumerate(used):
            ts[i] = np.asarray(classes[c], np.float64) * (
                self.root_extent / (1 << lev))
        levels = np.array([lev for lev, _ in used], np.int64)
        return ts, np.asarray(self._rscale_np, np.float64)[levels], levels

    def _operator(self, mats):
        """An operator stack (numpy or tensor) as a tensor of the
        wrangler's dtype on its device."""
        if not isinstance(mats, torch.Tensor):
            mats = np.ascontiguousarray(mats)
        return torch.as_tensor(mats, dtype=self.dtype, device=self.device)

    def _truncate(self, mats, lev_rows, lev_cols):
        """(n, K, K) operators with the rows past level *lev_rows*'s order
        and the columns past *lev_cols*'s zeroed (``expansion_base.py:
        342-347``); as they are without ``level_to_order``."""
        if self._level_mask is None:
            return mats
        keep = (self._level_mask[lev_rows][:, None]
                & self._level_mask[lev_cols][None, :])
        return torch.where(keep, mats, torch.zeros((), dtype=mats.dtype,
                                                   device=mats.device))

    def _mask_levels(self, exps):
        """(nboxes, K) expansions with each box's coefficients past its
        level's order zeroed; as they are without ``level_to_order``."""
        if self._level_mask is None:
            return exps
        return torch.where(self._level_mask[self._box_levels], exps,
                           torch.zeros((), dtype=exps.dtype,
                                       device=exps.device))

    # }}}

    # {{{ plumbing

    def multipole_expansion_zeros(self):
        return torch.zeros((self.tree.nboxes, self.ncoeff), dtype=self.dtype,
                           device=self.device)

    local_expansion_zeros = multipole_expansion_zeros

    def output_zeros(self):
        """Zero potentials, ``(ntargets, *_pot_extra_dims)``
        (``expansion_base.py:591-600``)."""
        return torch.zeros((self.tree.ntargets, *self._pot_extra_dims),
                           dtype=self.dtype, device=self.device)

    def _with_dipoles(self, stage, lead, q, *rest):
        """Stage *stage*'s kernel on ``(*lead, q, *rest)``, or with
        ``dipole_vec`` set its dipole kernel, the dipoles after *q*."""
        if self.dipole_vec is None:
            return self._kernels[stage](*lead, q.contiguous(), *rest)
        return self._kernels[f"{stage}_dipole"](
            *lead, q.contiguous(), self.dipole_vec, *rest)

    def reorder_sources(self, source_array):
        return torch.as_tensor(source_array, device=self.device)[
            self.tree.user_source_ids.to(torch.int64)].to(self.dtype)

    def reorder_potentials(self, potentials):
        # along the target axis, keeping any trailing lanes
        return potentials[self.tree.sorted_target_ids.to(torch.int64)]

    def multipole_expansions_view(self, mpole_exps, level):
        return mpole_exps[self._lsb[level]:self._lsb[level + 1]]

    local_expansions_view = multipole_expansions_view

    def finalize_potentials(self, potentials):
        return potentials

    def _check_own_lists(self, **lists):
        """M2L, M2P and P2L run on plans built from the wrangler's
        traversal at setup; lists that are not that traversal's own
        fields raise."""
        for name, val in lists.items():
            if val is not getattr(self.traversal, name):
                raise ValueError(
                    f"{name} is not the wrangler's traversal's own: M2L, "
                    "M2P and P2L run on plans built from it at setup")

    # }}}

    # {{{ P2M / L2P (hooks: _p2m, _l2p)

    def form_multipoles(self, level_start_source_box_nrs, source_boxes,
                        src_weight_vecs):
        src_weights, = src_weight_vecs
        return self._mask_levels(self._p2m(src_weights))

    def eval_locals(self, level_start_target_box_nrs, target_boxes,
                    local_exps):
        return self._l2p(self._mask_levels(local_exps))

    # }}}

    # {{{ M2M / L2L: K36 / K37 a level

    def coarsen_multipoles(self, level_start_source_parent_box_nrs,
                           source_parent_boxes, mpoles):
        mpoles = mpoles.clone()
        lsb = self._lsb
        for lev in range(self.tree.nlevels - 1, 2, -1):
            translate.m2m_translate(mpoles, self._m2m_opsT[lev], self._child,
                                    lsb[lev - 1], lsb[lev] - lsb[lev - 1])
        return mpoles

    def refine_locals(self, level_start_target_or_target_parent_box_nrs,
                      target_or_target_parent_boxes, local_exps):
        local_exps = local_exps.clone()
        for lev in range(1, self.tree.nlevels):
            translate.l2l_translate(local_exps, self._l2l_opsT[lev],
                                    self._l2l_rows[lev], self._tgt_child)
        return local_exps

    # }}}

    # {{{ M2L (parent-block form): K35

    def _build_m2l_parent_plan(self):
        """Static parent-block M2L setup (``expansion_base.py:349-431`` and
        ``:915-1014``), in :class:`~boxtree_torch.ops.translate.
        ParentBlockPlan`.

        List 2 of every child of a parent P is the set of children of P's
        colleagues that are well separated from it, so the (colleague
        slot j, source digit qs, target digit qt) triple fixes the
        translation ``cell(qt) - cell(qs) - 2 * offset_j`` and hence the
        class.  One device pass counts, per (level, j, qs, qt), the pairs
        whose source child exists and whose target child is a
        target-or-target-parent box; one host read of those counts gives
        the pair count, checked against the traversal's List-2 edge count
        (a mismatch raises), and the (level, class) pairs in use.  The
        operator table holds those pairs only, in the reference's key
        order (``particle_blocks.py:148`` ``M2LPlan``), from
        :meth:`_m2l_table`.
        """
        trav = self.traversal
        tree = self.tree
        d = self.dim
        dev = self.device
        nchild = 2 ** d
        lsb = self._lsb
        nlevels = tree.nlevels
        m = 3 ** d
        # slot j's offset, axis 0 fastest (the reference's slot order)
        offs = np.stack([(np.arange(m) // 3 ** a) % 3 - 1
                         for a in range(d)], axis=1)         # (m, d)
        cq = np.array([[(q >> (d - 1 - a)) & 1 for a in range(d)]
                       for q in range(nchild)])              # (2^d, d)
        vec = (cq[None, None, :, :] - cq[None, :, None, :]
               - 2 * offs[:, None, None, :])                 # (m, qs, qt, d)
        wellsep = np.abs(vec).max(axis=-1) > 1
        classes = _offsets(d, 3, min_inf_norm=1)             # (C, d)
        nclasses = len(classes)
        pow7 = 7 ** np.arange(d)[::-1]
        class_of_offset = np.full(7 ** d, -1, np.int64)
        class_of_offset[((classes + 3) * pow7).sum(axis=-1)] = \
            np.arange(nclasses)
        cls = np.where(wellsep, class_of_offset[((vec + 3) * pow7)
                                                .sum(axis=-1)], -1)

        # (nboxes, m) colleague of each box in each offset slot
        lists = trav.same_level_non_well_sep_boxes_lists.to(torch.int64)
        rows = csr_rows(trav.same_level_non_well_sep_boxes_starts,
                        lists.shape[0])
        cells = morton.deinterleave(tree.box_morton_prefixes, d)
        off = cells[:, lists] - cells[:, rows]
        slot = torch.zeros_like(rows)
        for a in range(d):
            slot = slot + (off[a] + 1) * 3 ** a
        pmap = torch.full((tree.nboxes, m), -1, dtype=torch.int32,
                          device=dev)
        pmap[rows, slot] = lists.to(torch.int32)

        # per (level, j, qs, qt): the pairs with a source child and a
        # target child; per level: the parents with a target child
        child = self._child.to(torch.int64)
        tgt_ok = self._tgt_child >= 0                        # (nboxes, qt)
        sel = torch.zeros(tree.nboxes, dtype=torch.bool, device=dev)
        cnt = torch.zeros((nlevels, m * nchild, nchild), dtype=torch.float64,
                          device=dev)
        for lev in range(2, nlevels):
            p0, p1 = lsb[lev - 1], lsb[lev]
            pm = pmap[p0:p1].to(torch.int64)                 # (np, m)
            src_ok = (pm[..., None] >= 0) & (
                child[pm.clamp(min=0)] >= 0)                 # (np, m, qs)
            cnt[lev] = (src_ok.reshape(p1 - p0, -1).T.to(torch.float64)
                        @ tgt_ok[p0:p1].to(torch.float64))
            sel[p0:p1] = tgt_ok[p0:p1].any(dim=1)
        nsel = torch.zeros(nlevels, dtype=torch.float64, device=dev)
        for lev in range(2, nlevels):
            nsel[lev] = sel[lsb[lev - 1]:lsb[lev]].sum()
        # the one host read of the setup
        host = torch.cat([nsel, cnt.reshape(-1)]).cpu().numpy()
        nsel, cnt = host[:nlevels].astype(np.int64), host[nlevels:]
        cnt = cnt.reshape(nlevels, m, nchild, nchild) * wellsep[None]
        count = int(cnt.sum())
        nedges = int(trav.from_sep_siblings_lists.shape[0])
        if count != nedges:
            raise RuntimeError(
                f"parent-block M2L covers {count} List-2 pairs, the "
                f"traversal has {nedges}")

        # the operator table of the used (level, class) pairs, in key order
        level_opid = np.full((nlevels, nclasses), -1, np.int64)
        used = []
        for lev in range(2, nlevels):
            used_c = np.unique(cls[cnt[lev] > 0])
            if not len(used_c):
                continue
            level_opid[lev, used_c] = len(used) + np.arange(len(used_c))
            used.extend((lev, int(c)) for c in used_c)
        ops = self._m2l_table(used, classes)
        opid = np.where(cls[None] >= 0,
                        level_opid[:, np.clip(cls, 0, None)], -1)

        # the target parents, each level's padded to whole tiles: ranks
        # within the level scattered to the level's padded offset
        pad = translate.ROW_PAD
        npar = -(-nsel // pad) * pad                 # by child level
        starts = np.concatenate([[0], np.cumsum(npar)])
        npad = int(starts[-1])
        box_start = torch.as_tensor(
            np.repeat(starts[1:], np.diff(lsb)), device=dev)
        rank = torch.zeros(tree.nboxes, dtype=torch.int64, device=dev)
        for lev in range(2, nlevels):
            p0, p1 = lsb[lev - 1], lsb[lev]
            rank[p0:p1] = torch.cumsum(sel[p0:p1], 0) - 1
        pos = torch.where(sel, box_start + rank, npad)
        sel_rows = torch.full((npad + 1,), -1, dtype=torch.int32, device=dev)
        sel_rows[pos] = torch.arange(tree.nboxes, dtype=torch.int32,
                                     device=dev)
        sel_rows = sel_rows[:npad].contiguous()
        sel_pmap = torch.where(
            (sel_rows >= 0)[:, None], pmap[sel_rows.clamp(min=0).to(
                torch.int64)], -1).contiguous()
        # the source box of each (slot, source digit) pair and row
        col = sel_pmap.to(torch.int64)
        src = torch.where((col >= 0)[..., None], self._child[col.clamp(min=0)],
                          -1)                                # (npad, m, qs)
        src = src.reshape(npad, m * nchild).T.contiguous()
        row_level = torch.as_tensor(
            np.repeat(np.arange(nlevels), npar).astype(np.int32),
            device=dev)

        self._m2l_opsT = ops
        self._m2l_plan = translate.ParentBlockPlan(
            ops=ops, used=used,
            opid=torch.as_tensor(np.ascontiguousarray(opid, np.int32),
                                 device=dev),
            rows=sel_rows, pmap=sel_pmap, src=src, row_level=row_level,
            child=self._child, tgt_child=self._tgt_child,
            level_opid=torch.as_tensor(level_opid, device=dev),
            class_of_offset=torch.as_tensor(class_of_offset, device=dev),
            radius=3, cells=cells, box_levels=self._box_levels,
            l2_rows=trav.target_or_target_parent_boxes,
            l2_starts=trav.from_sep_siblings_starts,
            l2_lists=trav.from_sep_siblings_lists)

    def _build_m2l_rotation(self):
        """The rotation M2L's setup (``expansion_base.py:353-378``): List 2's
        edges classified by (level, class) in the reference's window
        (``n = 1``: offsets of ``[-3, 3]^d`` outside ``[-1, 1]^d``), one
        host read of the operator histogram, and the rotation and axial
        blocks of the used operators; no dense table."""
        from boxtree_torch.models.particle_blocks import M2LPlan
        from boxtree_torch.models.rotation_m2l import RotationM2L

        t0 = time.perf_counter()
        self.m2l_plan = M2LPlan(self.traversal,
                                _offsets(self.dim, 3, min_inf_norm=1))
        #: host seconds of the rotation setup's parts (each ends in a
        #: host read): the edge plan, the rotation blocks, the axial ones
        self.rotation_setup_s = {"plan": time.perf_counter() - t0}
        if self.m2l_plan.nops:
            self._m2l_rot = RotationM2L(self)
            self.rotation_setup_s.update(self._m2l_rot.seconds)
            # the kernel's tiles and blocks, so that M2L copies nothing
            self.m2l_plan.edges.tiles(rotation.tile_edges(
                (self.order + 1) ** 2, self.dtype))
            self._m2l_rot.blocks.flat(self.real_dtype)

    def multipole_to_local(self, level_start_target_or_target_parent_box_nrs,
                           target_or_target_parent_boxes, starts, lists,
                           mpole_exps):
        self._check_own_lists(
            target_or_target_parent_boxes=target_or_target_parent_boxes,
            from_sep_siblings_starts=starts, from_sep_siblings_lists=lists)
        if self.m2l_mode == "rotation":
            if self._m2l_rot is None:
                return self.local_expansion_zeros()
            return self._m2l_rot.apply(mpole_exps.contiguous(),
                                       self.m2l_plan.edges)
        return translate.m2l_translate(mpole_exps.contiguous(),
                                       self._m2l_plan)

    # }}}

    # {{{ P2P / M2P / P2L (hooks: _p2p, _m2p, _p2l)

    def eval_direct(self, target_boxes, neighbor_sources_starts,
                    neighbor_sources_lists, src_weight_vecs):
        src_weights, = src_weight_vecs
        return self._p2p(target_boxes, neighbor_sources_starts,
                         neighbor_sources_lists, src_weights)

    def eval_multipoles(self, target_boxes_by_source_level,
                        from_sep_smaller_by_level, mpole_exps):
        self._check_own_lists(
            target_boxes_sep_smaller_by_source_level=(
                target_boxes_by_source_level),
            from_sep_smaller_by_level=from_sep_smaller_by_level)
        if self._l3_csr is None:
            return self.output_zeros()
        return self._m2p(*self._l3_csr, mpole_exps)

    def form_locals(self, level_start_target_or_target_parent_box_nrs,
                    target_or_target_parent_boxes, starts, lists,
                    src_weight_vecs, local_exps=None):
        self._check_own_lists(
            target_or_target_parent_boxes=target_or_target_parent_boxes,
            from_sep_bigger_starts=starts, from_sep_bigger_lists=lists)
        src_weights, = src_weight_vecs
        if local_exps is None:
            local_exps = self.local_expansion_zeros()
        return self._mask_levels(
            self._p2l(*self._l4_csr, src_weights, local_exps))

    # }}}
