"""Kernel-independent plumbing of the expansion wranglers.

Port of :class:`boxtree_tpu.models.expansion_base.ExpansionWranglerBase`
(``expansion_base.py:212-1803``) with one formulation per stage:

- P2M and L2P: the hooks ``_p2m`` / ``_l2p``; by default per-particle
  basis evaluation in chunks, ``index_add_`` into the boxes / a gather of
  the box's local expansion; the 3D Laplace and the 3D and 2D Helmholtz
  wranglers launch the kernels of :mod:`boxtree_torch.ops.laplace3d`,
  :mod:`~boxtree_torch.ops.helmholtz3d` and
  :mod:`~boxtree_torch.ops.helmholtz2d` over the rows
  :attr:`_source_rows` / :attr:`_target_rows` (the boxes that own
  particles, on every level) instead;
- M2M and L2L: per (level, child digit), a gather and one ``torch.matmul``
  with the (K, K) shift operator;
- M2L: the parent-block form (``expansion_base.py:915-1086``): per level,
  one gathered ``2^d * K`` row of children's multipoles per (parent,
  colleague slot) times a static ``(2^d K, 2^d K)`` block of per-class
  operators serves all children of the parent;
- P2P, M2P, P2L: the kernels of :mod:`boxtree_torch.ops.laplace3d`.

Subclasses provide ``_ncoeff``, the per-particle hooks ``_p2m_terms`` and
``_l2p_eval``, the batched operator builders ``_m2m_matrices``,
``_l2l_matrices`` and ``_m2l_matrices`` (numpy or a tensor), which
:meth:`_operator` turns into tensors of the coefficient dtype, and the
list-stage hooks ``_p2p``, ``_m2p`` and ``_p2l``.  Coefficients and
potentials are of the wrangler's ``dtype`` (real, or complex); box
geometry, particles and rscales of its real counterpart, ``real_dtype``.

Two options follow the reference (``expansion_base.py:227-347``):

- ``dipole_vec``: the sources are dipoles, for the kernels that set
  ``_supports_dipoles``.  The default P2M takes the JVP of ``_p2m_terms``
  in the source offsets; the P2M and list-stage hooks of a class with
  dipole kernels read :attr:`dipole_vec` and launch them.
- ``level_to_order``: expansions keep the maximum order with each level's
  tail masked to zero (after P2M, after P2L and on L2P's input), and the
  M2M, L2L and M2L operators are truncated to the orders of the levels
  they join; the subclass gives each coefficient's order
  (``_coeff_orders``).
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.config import as_torch_dtype
from boxtree_torch.fmm.drive import ExpansionWranglerInterface
from boxtree_torch.ops import morton
from boxtree_torch.traversal.containers import compressed_csr, csr_rows
from boxtree_torch.traversal.neighbors import _offsets

#: element budget of one chunk of the per-particle and M2L temporaries
_CHUNK_ELEMS = 1 << 26


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

    def __init__(self, tree_indep, traversal, rscale=None, dtype=None,
                 dipole_vec=None, dipoles_already_reordered=False,
                 level_to_order=None):
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
        """
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
        parents = tree.box_parent_ids.to(torch.int64)
        digit = tree.box_morton_prefixes & (nchild - 1)

        # {{{ M2M / L2L: per (level, digit) operators and box groups

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

        def digit_groups(ids):
            d_ids = digit[ids]
            return [(ids[d_ids == q], parents[ids[d_ids == q]])
                    for q in range(nchild)]

        self._m2m_plan = {
            lev: digit_groups(torch.arange(self._lsb[lev],
                                           self._lsb[lev + 1], device=dev))
            for lev in range(nlevels - 1, 2, -1)}
        totp = traversal.target_or_target_parent_boxes.to(torch.int64)
        ls_totp = [int(x) for x in
                   traversal.level_start_target_or_target_parent_box_nrs
                   .cpu()]
        self._l2l_plan = {
            lev: digit_groups(totp[ls_totp[lev]:ls_totp[lev + 1]])
            for lev in range(1, nlevels)}

        # }}}

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

    def _p2m_terms(self, rel, q, scale):
        """Multipole terms of charges *q* at offsets *rel* pre-divided by
        *scale*, the box's rscale (``expansion_base.py:532-538``)."""
        raise NotImplementedError

    def _l2p_eval(self, rel, loc, scale):
        """Potentials of locals *loc* at offsets *rel* pre-divided by
        *scale*."""
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
        return torch.zeros(self.tree.ntargets, dtype=self.dtype,
                           device=self.device)

    def reorder_sources(self, source_array):
        return torch.as_tensor(source_array, device=self.device)[
            self.tree.user_source_ids.to(torch.int64)].to(self.dtype)

    def reorder_potentials(self, potentials):
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

    def _particle_chunks(self, n):
        chunk = max(1, _CHUNK_ELEMS // self.ncoeff)
        for c0 in range(0, n, chunk):
            yield slice(c0, min(n, c0 + chunk))

    # }}}

    # {{{ P2M / L2P (hooks: _p2m, _l2p)

    def _p2m(self, src_weights):
        """Multipoles ``(nboxes, K)`` of the tree-order *src_weights*,
        before the level mask: ``_p2m_terms`` a chunk of particles at a
        time, summed into each particle's box."""
        box = self.tree.box_id_of_source.to(torch.int64)
        mp = self.multipole_expansion_zeros()
        for c in self._particle_chunks(box.shape[0]):
            b = box[c]
            s = self.box_scale[b]
            rel = (self._sources[:, c] - self.centers[:, b]) / s
            q = src_weights[c]
            if self.dipole_vec is None:
                terms = self._p2m_terms(rel, q, s)
            else:
                # the dipole is the JVP in the source offset, d(rel) = d/s
                # (expansion_base.py:664-673)
                terms = torch.func.jvp(
                    lambda r, q=q, s=s: self._p2m_terms(r, q, s), (rel,),
                    (self.dipole_vec[:, c] / s,))[1]
            mp.index_add_(0, b, terms)
        return mp

    def _l2p(self, local_exps):
        """Potentials (tree-order targets) of the masked *local_exps*:
        ``_l2p_eval`` a chunk of targets at a time against its box's
        local expansion."""
        box = self.tree.box_id_of_target.to(torch.int64)
        pot = self.output_zeros()
        for c in self._particle_chunks(box.shape[0]):
            b = box[c]
            s = self.box_scale[b]
            rel = (self._targets[:, c] - self.centers[:, b]) / s
            pot[c] = self._l2p_eval(rel, local_exps[b], s)
        return pot

    def form_multipoles(self, level_start_source_box_nrs, source_boxes,
                        src_weight_vecs):
        src_weights, = src_weight_vecs
        return self._mask_levels(self._p2m(src_weights))

    def eval_locals(self, level_start_target_box_nrs, target_boxes,
                    local_exps):
        return self._l2p(self._mask_levels(local_exps))

    # }}}

    # {{{ M2M / L2L

    def coarsen_multipoles(self, level_start_source_parent_box_nrs,
                           source_parent_boxes, mpoles):
        mpoles = mpoles.clone()
        for lev in range(self.tree.nlevels - 1, 2, -1):
            for q, (ids, par) in enumerate(self._m2m_plan[lev]):
                if ids.numel():
                    mpoles.index_add_(
                        0, par, torch.matmul(mpoles[ids],
                                             self._m2m_opsT[lev][q]))
        return mpoles

    def refine_locals(self, level_start_target_or_target_parent_box_nrs,
                      target_or_target_parent_boxes, local_exps):
        local_exps = local_exps.clone()
        for lev in range(1, self.tree.nlevels):
            for q, (ids, par) in enumerate(self._l2l_plan[lev]):
                if ids.numel():
                    local_exps.index_add_(
                        0, ids, torch.matmul(local_exps[par],
                                             self._l2l_opsT[lev][q]))
        return local_exps

    # }}}

    # {{{ M2L (parent-block form)

    def _build_m2l_parent_plan(self):
        """Static parent-block M2L setup (``expansion_base.py:915-1014``).

        List 2 of every child of a parent P is the set of children of P's
        colleagues that are well separated from it, so the (colleague
        slot j, source digit qs, target digit qt) triple fixes the
        translation ``cell(qt) - cell(qs) - 2 * offset_j`` and hence the
        operator.  Per level this keeps the per-class operators and a
        ``(m, 2^d, 2^d)`` index into them (-1: not well separated).  The
        pair count of the static form is checked against the traversal's
        List-2 edge count; a mismatch raises.
        """
        trav = self.traversal
        tree = self.tree
        d = self.dim
        dev = self.device
        nchild = 2 ** d
        lsb = self._lsb
        nlevels = tree.nlevels
        offs = _offsets(d, 1)                                # (m, d)
        m = offs.shape[0]
        cq = np.array([[(q >> (d - 1 - a)) & 1 for a in range(d)]
                       for q in range(nchild)])              # (2^d, d)
        vec = (cq[None, None, :, :] - cq[None, :, None, :]
               - 2 * offs[:, None, None, :])                 # (m, qs, qt, d)
        wellsep = np.abs(vec).max(axis=-1) > 1
        classes = _offsets(d, 3, min_inf_norm=1)             # (C, d)
        lin = ((vec + 3) * 7 ** np.arange(d)[::-1]).sum(axis=-1)
        table = np.full(7 ** d, -1, np.int64)
        table[((classes + 3) * 7 ** np.arange(d)[::-1]).sum(axis=-1)] = \
            np.arange(len(classes))
        self._m2l_class = torch.as_tensor(
            np.where(wellsep, table[lin], -1), device=dev)   # (m, qs, qt)
        self._m2l_slots = [j for j in range(m) if wellsep[j].any()]

        # (nboxes, m) colleague of each box in each offset slot
        lists = trav.same_level_non_well_sep_boxes_lists.to(torch.int64)
        rows = csr_rows(trav.same_level_non_well_sep_boxes_starts,
                        lists.shape[0])
        cells = morton.deinterleave(tree.box_morton_prefixes, d)
        off = cells[:, lists] - cells[:, rows]
        slot = torch.zeros_like(rows)
        for a in range(d):
            slot = slot + (off[a] + 1) * 3 ** (d - 1 - a)
        pmap = torch.full((tree.nboxes, m), -1, dtype=torch.int64,
                          device=dev)
        pmap[rows, slot] = lists
        self._m2l_pmap = pmap
        self._child_rows = tree.box_child_ids.T.to(torch.int64)
        totp = torch.zeros(tree.nboxes + 1, dtype=torch.bool, device=dev)
        totp[trav.target_or_target_parent_boxes.to(torch.int64)] = True
        self._m2l_totp = totp

        ws = torch.as_tensor(wellsep.reshape(m * nchild, nchild),
                             dtype=torch.float64, device=dev)
        count = 0
        for lev in range(2, nlevels):
            pm = pmap[lsb[lev - 1]:lsb[lev]]                 # (np, m)
            src_ok = (pm[..., None] >= 0) & (
                self._child_rows[pm.clamp(min=0)] > 0)       # (np, m, qs)
            ch = self._child_rows[lsb[lev - 1]:lsb[lev]]
            tgt_ok = (ch > 0) & totp[ch]                     # (np, qt)
            count += int(((src_ok.reshape(len(pm), -1).to(torch.float64)
                           @ ws) * tgt_ok).sum())
        nedges = int(trav.from_sep_siblings_lists.shape[0])
        if count != nedges:
            raise RuntimeError(
                f"parent-block M2L covers {count} List-2 pairs, the "
                f"traversal has {nedges}")

        # per-level (C, K, K) operator stacks, transposed for row vectors
        self._m2l_opsT = {}
        for lev in range(2, nlevels):
            size = self.root_extent / (1 << lev)
            mats = self._truncate(self._operator(self._m2l_matrices(
                classes, size, float(self._rscale_np[lev]))), lev, lev)
            self._m2l_opsT[lev] = mats.transpose(1, 2).contiguous()

    def _m2l_block(self, lev, j):
        """(2^d K, 2^d K) operator block of colleague slot *j* at child
        level *lev*: rows (source digit, coefficient), columns (target
        digit, coefficient)."""
        k = self.ncoeff
        nchild = 2 ** self.dim
        ops = self._m2l_opsT[lev]
        cls = self._m2l_class[j]                             # (qs, qt)
        blk = torch.where((cls >= 0)[..., None, None],
                          ops[cls.clamp(min=0)],
                          torch.zeros((), dtype=ops.dtype, device=ops.device))
        return blk.permute(0, 2, 1, 3).reshape(nchild * k, nchild * k)

    def multipole_to_local(self, level_start_target_or_target_parent_box_nrs,
                           target_or_target_parent_boxes, starts, lists,
                           mpole_exps):
        self._check_own_lists(
            target_or_target_parent_boxes=target_or_target_parent_boxes,
            from_sep_siblings_starts=starts, from_sep_siblings_lists=lists)
        k = self.ncoeff
        nchild = 2 ** self.dim
        lsb = self._lsb
        out = self.local_expansion_zeros()
        chunk = max(1, _CHUNK_ELEMS // (nchild * k))
        for lev in range(2, self.tree.nlevels):
            p0, p1 = lsb[lev - 1], lsb[lev]
            npar = p1 - p0
            ch = self._child_rows[p0:p1]                     # (np, 2^d)
            mp8 = torch.where((ch > 0)[..., None], mpole_exps[ch], 0)
            mp8 = torch.cat([mp8.reshape(npar, nchild * k),
                             mp8.new_zeros(1, nchild * k)])
            tgt_ok = (ch > 0) & self._m2l_totp[ch]
            # parents with target children only; colleagues index mp8
            sel = torch.nonzero(tgt_ok.any(dim=1))[:, 0]
            if sel.numel() == 0:
                continue
            pm = self._m2l_pmap[p0 + sel]
            pml = torch.where(pm >= 0, pm - p0, npar)
            y = mp8.new_zeros(sel.shape[0], nchild * k)
            for j in self._m2l_slots:
                blk = self._m2l_block(lev, j)
                for c0 in range(0, sel.shape[0], chunk):
                    y[c0:c0 + chunk] += torch.matmul(
                        mp8[pml[c0:c0 + chunk, j]], blk)
            ok = tgt_ok[sel]
            out[ch[sel][ok]] = y.reshape(-1, nchild, k)[ok]
        return out

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
