"""2D Helmholtz expansion wranglers: on complex128 coefficients, and on
``[re | im]`` real-pair coefficients with ``(ntargets, 2)`` potentials.

Port of ``boxtree_tpu/models/helmholtz.py:43-418``.  Kernel ``G(t, s) = (i/4)
H_0^(1)(k |t - s|)``, real k.  Expansions about a box centre, coefficient
index n over ``-p..p``: multipoles ``phi = sum_n a_n H_n(k r) e^{i n th}``
with P2M ``a_n = (i/4) sum_j q_j J_n(k r_j) e^{-i n th_j}``, locals ``phi =
sum_n b_n J_n(k r) e^{i n th}`` with P2L ``b_n = (i/4) q H_n(k r_s) e^{-i n
th_s}`` (the basis is :func:`boxtree_torch.ops.helmholtz2d.basis`).  Every
particle stage runs a kernel of :mod:`boxtree_torch.ops.helmholtz2d` (P2M
K33, P2P K16, M2P K17, P2L K18, L2P K34; their ``_f64`` entry points K55,
K52, K53, K54 and K56 on the pair wrangler), on any k r: their recurrence
scratch is global memory, not shared.

Translations are Graf's addition theorem, with ``d = c_old - c_new``
(M2M/L2L) or ``d = c_src - c_tgt`` (M2L):

- M2M/L2L: ``T[m, n] = J_{m-n}(k |d|) e^{-i (m-n) arg d}``;
- M2L:     ``T[m, n] = H_{m-n}(k |d|) e^{-i (m-n) arg d}``.

With rscale on (``D_r = diag(r^|n|)``, ``M~ = D_r^-1 M``, ``L~ = D_r L``)
the scaled operators ``D_p^-1 B D_c`` (M2M), ``D_c B D_p^-1`` (L2L) and
``D_r B D_r`` (M2L) are built without forming the unscaled entries: the
radial tables come s-scaled from :mod:`boxtree_torch.ops.
scaled_bessel_host` and the leftover powers have nonnegative exponents
(``helmholtz.py:143-222``).  The port builds each stack of operators in
one batch: the radial table once per distinct ``k |d|``, the rest by
broadcasting.

:class:`Helmholtz2DPairsExpansionWrangler` (``helmholtz.py:296-418``) is the
same FMM with no complex value on the card: real charges, ``[re | im]``
coefficient rows, the Graf stacks expanded to ``[[Re, -Im], [Im, Re]]`` and
``[re, im]`` potential lanes.

Both take dipole sources (``dipole_vec``, the potential ``q (d . grad_y)
(i/4) H_0(k |x - y|)``): P2M, P2P and P2L then run the dipole kernels
K63-K65 (pairs K66-K68), the JVPs of the charge stages in the source
positions (``boxtree_tpu/models/expansion_base.py:664-673``,
``:1314-1324``, ``:1688-1694``); a dipole on its box's centre adds the
limit of its P2M tangent, where the reference drops it.  M2P, L2P and the
translations do not change.
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.config import as_torch_dtype
from boxtree_torch.fmm.drive import TreeIndependentDataForWrangler
from boxtree_torch.models.expansion_base import ExpansionWranglerBase
from boxtree_torch.ops import helmholtz2d as hops
from boxtree_torch.ops import scaled_bessel_host as sbh
from boxtree_torch.ops import solid_harmonics as sh
from boxtree_torch.ops.cylinder_bessel import miller_start


class HelmholtzTreeIndependentDataForWrangler(
        TreeIndependentDataForWrangler):
    """Dimension, wavenumber and order (``helmholtz.py:43-51``): 2D, real
    k."""

    def __init__(self, dim, helmholtz_k, order):
        if dim != 2:
            raise NotImplementedError("Helmholtz wrangler is 2D for now")
        self.dim = dim
        self.helmholtz_k = float(helmholtz_k)
        self.order = order


class Helmholtz2DExpansionWrangler(ExpansionWranglerBase):
    """2D Helmholtz FMM wrangler on complex128 coefficients (see module
    doc); the counterpart of ``boxtree_tpu``'s wrangler of the same
    name."""

    dtype = torch.complex128
    _supports_rscale = True
    _supports_dipoles = True
    _kernels = {
        "p2m": hops.p2m_helmholtz2d,
        "p2m_dipole": hops.p2m_helmholtz2d_dipole,
        "p2p": hops.p2p_helmholtz2d,
        "p2p_dipole": hops.p2p_helmholtz2d_dipole,
        "p2l": hops.p2l_helmholtz2d,
        "p2l_dipole": hops.p2l_helmholtz2d_dipole}

    def __init__(self, tree_indep, traversal, **kwargs):
        self.order = p = tree_indep.order
        self.k = tree_indep.helmholtz_k
        if kwargs.get("dtype") is not None and \
                as_torch_dtype(kwargs["dtype"]) != type(self).dtype:
            raise NotImplementedError(
                f"{type(self).__name__} is ported in {type(self).dtype} "
                "only")
        self._ns = np.arange(-p, p + 1)
        # static Miller start: k r in every particle stage is bounded by
        # the root diagonal plus slack (the reference's p + 2 leaves room
        # for its dipole JVP, one order up)
        root = float(traversal.tree.root_extent)
        xmax = self.k * root * (2.0 * np.sqrt(tree_indep.dim) + 1.0)
        self._nstart = miller_start(p + 2, xmax)
        super().__init__(tree_indep, traversal, **kwargs)

    def _ncoeff(self):
        return 2 * self.order + 1

    def _rscale_factor(self):
        return abs(self.k)

    # {{{ host operators (helmholtz.py:143-222), batched

    def _graf(self, ds, kind, s=None):
        """``(C, K, K)`` Graf matrices ``F_{m-n}(k |d|) e^{-i (m-n) arg d}``
        of the rows of *ds* ``(C, 2)``, *kind* ``"J"`` or ``"H"``: by
        :mod:`scipy.special` when *s* is None, else with the radial factor
        pre-scaled, ``J_q s^-q`` or ``H_q s^+q`` for ``q = |m - n|``."""
        ds = np.asarray(ds, np.float64)
        rd = np.hypot(ds[:, 0], ds[:, 1])[:, None, None]
        ad = np.arctan2(ds[:, 1], ds[:, 0])[:, None, None]
        dn = self._ns[:, None] - self._ns[None, :]          # m - n
        phase = np.exp(-1j * dn * ad)
        if s is None:
            from scipy import special as sp
            fn = sp.jv if kind == "J" else sp.hankel1
            return fn(dn, self.k * rd) * phase
        fn = sbh.jv_scaled if kind == "J" else sbh.hankel1_scaled
        q = np.abs(dn)
        xs = self.k * rd[:, 0, 0]
        uniq, inv = np.unique(xs, return_inverse=True)
        tab = np.stack([fn(x, 2 * self.order, s) for x in uniq])[inv]
        sigma = np.where(dn < 0, (-1.0) ** q, 1.0)           # F_-q=(-1)^q F_q
        return tab[:, q] * sigma * phase

    def _m2m_matrices(self, ts, r_child, r_parent):
        # ts = new - old; Graf d = old - new
        ds = -np.asarray(ts)
        if r_child == 1.0 and r_parent == 1.0:
            return self._graf(ds, "J")
        am = np.abs(self._ns)
        q = np.abs(self._ns[:, None] - self._ns[None, :])
        e = q + am[None, :] - am[:, None]                    # >= 0
        return self._graf(ds, "J", r_child) * r_child ** e \
            * (r_child / r_parent) ** am[:, None]

    def _l2l_matrices(self, ts, r_parent, r_child):
        ds = -np.asarray(ts)
        if r_child == 1.0 and r_parent == 1.0:
            return self._graf(ds, "J")
        am = np.abs(self._ns)
        q = np.abs(self._ns[:, None] - self._ns[None, :])
        e = q + am[:, None] - am[None, :]                    # >= 0
        return self._graf(ds, "J", r_child) * r_child ** e \
            * (r_child / r_parent) ** am[None, :]

    def _m2l_matrices(self, classes, size, r):
        # ts = c_tgt - c_src; d = src - tgt
        ds = -(np.asarray(classes) * size)
        if r == 1.0:
            return self._graf(ds, "H")
        am = np.abs(self._ns)
        q = np.abs(self._ns[:, None] - self._ns[None, :])
        e = am[:, None] + am[None, :] - q                    # >= 0
        return self._graf(ds, "H", r) * r ** e

    # }}}

    # {{{ particle hooks (helmholtz.py:267-294): P2M (K33) and L2P (K34)
    # over the boxes that own particles, P2P (K16), M2P (K17) and P2L (K18)
    # over the lists; with dipole_vec set, P2M, P2P and P2L run the dipole
    # kernels (K63-K65)

    def _p2m(self, q):
        tree = self.tree
        return self._with_dipoles(
            "p2m", (self._sources,), q,
            tree.box_source_starts, tree.box_source_counts_nonchild,
            self._source_rows, self.centers, self.box_scale, self.k,
            self.order, self._nstart)

    def _l2p(self, local_exps):
        tree = self.tree
        return hops.l2p_helmholtz2d(
            self._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, self._target_rows,
            local_exps.contiguous(), self.centers, self.box_scale, self.k,
            self.order, self._nstart)

    def _p2p(self, target_boxes, starts, lists, q):
        tree = self.tree
        return self._with_dipoles(
            "p2p", (self._targets, self._sources), q,
            tree.box_target_starts, tree.box_target_counts_nonchild,
            tree.box_source_starts, tree.box_source_counts_nonchild,
            target_boxes, starts, lists, self.k, self._nstart)

    def _m2p(self, rows, starts, lists, mpole_exps):
        tree = self.tree
        return hops.m2p_helmholtz2d(
            self._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, rows, starts, lists,
            mpole_exps.contiguous(), self.centers, self.box_scale, self.k,
            self.order, self._nstart)

    def _p2l(self, rows, starts, lists, q, out):
        tree = self.tree
        return self._with_dipoles(
            "p2l", (self._sources,), q,
            tree.box_source_starts, tree.box_source_counts_nonchild, rows,
            starts, lists, self.centers, self.box_scale, self.k, self.order,
            self._nstart, out)

    # }}}


class Helmholtz2DPairsExpansionWrangler(Helmholtz2DExpansionWrangler):
    """2D Helmholtz FMM wrangler with no complex value on the card: real
    float64 charges, ``[re | im]`` real-pair coefficients of 2 (2p+1)
    values, the Graf operators pair-expanded on the card, and potentials as
    ``(ntargets, 2)`` float64 ``[re, im]`` lanes; the counterpart of
    ``boxtree_tpu``'s wrangler of the same name (``helmholtz.py:296-418``).
    The particle stages run the pair kernels K52-K56 (with dipoles
    K66-K68 for P2M, P2P and P2L), whose twins use the real ``(J, Y)``
    recurrences and carry the phase as (cos, sin) lanes."""

    dtype = torch.float64
    _pot_extra_dims = (2,)

    def reorder_sources(self, source_array):
        if torch.as_tensor(source_array).is_complex():
            raise TypeError(
                "the real-pair wrangler takes REAL source weights; complex "
                "weights are linear: drive the real and imaginary parts "
                "separately and combine")
        return super().reorder_sources(source_array)

    def _ncoeff(self):
        return 2 * (2 * self.order + 1)

    def _coeff_orders(self):
        return np.tile(np.abs(self._ns), 2)

    # {{{ operators: the complex Graf stacks, pair-expanded on the card

    def _m2m_matrices(self, ts, r_child, r_parent):
        return sh.pair_tensor(super()._m2m_matrices(ts, r_child, r_parent),
                              self.device)

    def _l2l_matrices(self, ts, r_parent, r_child):
        return sh.pair_tensor(super()._l2l_matrices(ts, r_parent, r_child),
                              self.device)

    def _m2l_matrices(self, classes, size, r):
        return sh.pair_tensor(super()._m2l_matrices(classes, size, r),
                              self.device)

    # }}}
