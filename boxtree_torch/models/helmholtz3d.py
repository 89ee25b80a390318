"""3D Helmholtz expansion wranglers: on complex128 coefficients, and on
``[re | im]`` real-pair coefficients with ``(ntargets, 2)`` potentials.

Port of ``boxtree_tpu/models/helmholtz3d.py:43-572``.  Kernel ``G(t, s) =
exp(ik|t-s|) / |t-s|``, real k.  Basis: spherical wave functions in the
angular basis ``A_n^m(u) = R_n^m(u)`` (the regular solid harmonics on the
unit sphere):

- regular:  ``HR_n^m(x) = j_n(k|x|) A_n^m(x/|x|)``
- outgoing: ``HS_n^m(x) = h^(1)_n(k|x|) A_n^m(x/|x|)``

with ``G = sum_nm w_nm HR_nm(y')* HS_nm(x')``, ``w_nm = 4 pi i k D_nm^2``
and ``Y_n^m = D_nm A_n^m`` (orthonormal Y).  P2M is ``M_nm += q w_nm
conj(HR_nm(y - c))``, evaluation ``phi = sum M_nm HS_nm(x - c)``; P2L/L2P
mirror them with h and j swapped.  Every particle stage runs a kernel of
:mod:`boxtree_torch.ops.helmholtz3d` (P2M K31, P2P K9, M2P K10, P2L K11,
L2P K32; their ``_f64`` entry points K50, K47, K48, K49 and K51 on the
pair wrangler).  Both wranglers take dipole sources (``dipole_vec``, the
potential ``q (d . grad_y) G``): P2M, P2P and P2L then run the dipole
kernels K57, K58 and K59 (pairs K60, K61, K62), the JVPs of the charge
stages in the source positions.  Coefficients are rscaled as the
reference's are (``M~_n = M_n s^-n``, ``L~_n = L_n s^n`` for the level's
rscale s, ``helmholtz3d.py:188-196``).

Translations use the reference's exact Gaunt-series addition theorem
(``helmholtz3d.py:23-33``)::

    T_Y[numu, nm](t) = 4 pi sum_q i^(q+nu-n) f_q(k|t|) Y_q^(m-mu)(t^)
                       Gaunt(n,m | nu,mu | q, m-mu)

with ``f = j`` for M2M/L2L and ``f = h^(1)`` for M2L.  The reference builds
one operator per call, each with 625 scalar ``sph_harm`` calls and a loop
over q.  Here :meth:`Helmholtz3DTreeIndependentDataForWrangler.
translation_operators` builds a batch: the Y table of all directions in one
vectorised call, and the q-sum as one complex matrix product per ``s = m -
mu`` (the Gaunt tensor times the per-q power, against the Y table times the
radial table), on the wrangler's device.  The 316 M2L classes have the
same directions at every level, so their Y table is built once.

:class:`Helmholtz3DPairsExpansionWrangler` (``helmholtz3d.py:373-523``) is
the same FMM with no complex value on the card: real charges, ``[re | im]``
coefficient rows, each operator stack the complex one expanded to ``[[Re,
-Im], [Im, Re]]`` on the card, and ``[re, im]`` potential lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.config import as_torch_dtype
from boxtree_torch.fmm.drive import TreeIndependentDataForWrangler
from boxtree_torch.models.expansion_base import ExpansionWranglerBase
from boxtree_torch.ops import helmholtz3d as hops
from boxtree_torch.ops import scaled_bessel_host as sbh
from boxtree_torch.ops import solid_harmonics as sh


def _sph_harm_y(n, m, theta, phi):
    """Orthonormal Y_n^m (scipy), tolerant of scipy API versions."""
    from scipy import special as sp
    if hasattr(sp, "sph_harm_y"):
        return sp.sph_harm_y(n, m, theta, phi)
    return sp.sph_harm(m, n, phi, theta)


def _y_tables(dirs, lmax):
    """``Y_l^s`` of the directions of the rows of *dirs* ``(C, 3)`` for
    ``0 <= l <= lmax``, ``|s| <= l``: complex ``(C, lmax+1, 2 lmax+1)``
    indexed ``[c, l, s + lmax]`` (``helmholtz3d.py:63-70``, vectorised)."""
    t = np.asarray(dirs, np.float64)
    r = np.linalg.norm(t, axis=1)
    theta = np.arccos(np.clip(t[:, 2] / r, -1, 1))
    phi = np.arctan2(t[:, 1], t[:, 0])
    ell = np.concatenate([[lv] * (2 * lv + 1) for lv in range(lmax + 1)])
    s = np.concatenate([np.arange(-lv, lv + 1) for lv in range(lmax + 1)])
    out = np.zeros((len(t), lmax + 1, 2 * lmax + 1), np.complex128)
    out[:, ell, s + lmax] = _sph_harm_y(ell[None, :], s[None, :],
                                        theta[:, None], phi[:, None])
    return out


class Helmholtz3DTreeIndependentDataForWrangler(
        TreeIndependentDataForWrangler):
    """Order, wavenumber, and the Gaunt / normalisation tables shared by
    every tree (``helmholtz3d.py:73-140``)."""

    def __init__(self, helmholtz_k, order):
        self.dim = 3
        self.k = complex(helmholtz_k)
        if self.k.imag == 0:
            self.k = float(helmholtz_k)
        self.order = p = order
        self.nm_n = np.concatenate(
            [[n] * (2 * n + 1) for n in range(p + 1)]).astype(np.int64)
        self.nm_m = np.concatenate(
            [np.arange(-n, n + 1) for n in range(p + 1)])
        K = len(self.nm_n)

        # D_nm: Y_n^m = D_nm A_n^m, pinned at one generic direction (both
        # bases carry e^{im phi}, so the ratio is a real constant)
        theta0, phi0 = 1.1, 0.7
        u = np.array([np.sin(theta0) * np.cos(phi0),
                      np.sin(theta0) * np.sin(phi0),
                      np.cos(theta0)])
        a_vals = sh.regular(u[:, None], p)[0]          # (K,)
        d = np.empty(K)
        for i in range(K):
            y = _sph_harm_y(int(self.nm_n[i]), int(self.nm_m[i]),
                            theta0, phi0)
            ratio = y / a_vals[i]
            assert abs(ratio.imag) < 1e-10 * abs(ratio)
            d[i] = ratio.real
        self.D = d

        # Gaunt tensor G[(n,m),(nu,mu),q] = int Y_n^m conj(Y_nu^mu)
        # conj(Y_q^{m-mu}) dOmega by exact Gauss-Legendre quadrature, zero
        # outside the selection rules (the quadrature's 1e-16 noise there
        # would be amplified by the D ratios)
        qmax = 2 * p
        nodes, weights = np.polynomial.legendre.leggauss(2 * p + 2)
        theta_i = np.arccos(nodes)
        yh = np.zeros((qmax + 1, 2 * qmax + 1, len(nodes)))
        for ell in range(qmax + 1):
            for s in range(-ell, ell + 1):
                yh[ell, s + qmax] = _sph_harm_y(ell, s, theta_i, 0.0).real
        ynm_i = yh[self.nm_n, self.nm_m + qmax]        # (K, i)
        s_idx = (self.nm_m[:, None] - self.nm_m[None, :]) + qmax  # (K,K)
        gaunt = np.zeros((K, K, qmax + 1))
        w = weights * 2 * np.pi
        n_a = self.nm_n[:, None]
        n_b = self.nm_n[None, :]
        s_ab = self.nm_m[:, None] - self.nm_m[None, :]
        for q in range(qmax + 1):
            yq = yh[q][s_idx]                          # (K, K, i)
            g = np.einsum("ai,bi,abi,i->ab", ynm_i, ynm_i, yq, w)
            keep = ((q >= np.abs(n_a - n_b)) & (q <= n_a + n_b)
                    & (((n_a + n_b + q) % 2) == 0)
                    & (np.abs(s_ab) <= q))
            gaunt[:, :, q] = np.where(keep, g, 0.0)
        self.gaunt = gaunt
        self.qmax = qmax
        # i^{nu - n} (rows = output nu, cols = input n)
        self.phase_pair = (1j) ** (
            self.nm_n[:, None] - self.nm_n[None, :])
        # the (in, out) pairs of each s = m_in - m_out, for the batched
        # q-sum
        self._s_groups = [np.nonzero(s_idx.ravel() == s)[0]
                          for s in range(2 * qmax + 1)]
        self._y_cache = {}

    # {{{ batched operator builds

    def _y_table(self, dirs):
        """:func:`_y_tables` of *dirs*, kept for integer *dirs*: the M2L
        classes name the same directions at every level."""
        dirs = np.ascontiguousarray(dirs)
        if dirs.dtype.kind not in "iu":
            return _y_tables(dirs, self.qmax)
        key = (dirs.shape, dirs.tobytes())
        if key not in self._y_cache:
            self._y_cache[key] = _y_tables(dirs, self.qmax)
        return self._y_cache[key]

    def translation_operators(self, dirs, fhat, pw=None, device="cpu"):
        """``(C, K, K)`` [out, in] translation operators in the A basis
        for translations along the rows of *dirs* ``(C, 3)``, from the
        radial table *fhat* ``(C, qmax+1)`` and an optional per-q
        multiplier *pw* ``(K, K, qmax+1)`` in (in, out) orientation
        (``helmholtz3d.py:142-172`` for a batch): a complex128 tensor on
        *device*."""
        K = len(self.nm_n)
        Q = self.qmax + 1
        coef = ((1j) ** np.arange(Q))[None, :] * np.asarray(fhat)
        f = torch.as_tensor(self._y_table(dirs).transpose(0, 2, 1)
                            * coef[:, None, :], device=device)  # (C, S, Q)
        g = self.gaunt.reshape(K * K, Q)
        if pw is not None:
            g = g * np.asarray(pw).reshape(K * K, Q)
        g = torch.as_tensor(g, dtype=torch.complex128, device=device)
        t_in_out = f.new_zeros(f.shape[0], K * K)
        for s, idx_np in enumerate(self._s_groups):
            idx = torch.as_tensor(idx_np, device=device)
            t_in_out[:, idx] = f[:, s] @ g[idx].T
        t = (4 * np.pi) * t_in_out.reshape(-1, K, K).transpose(1, 2)
        # [out, in]; Y basis -> A basis: T_A = D_out T_Y D_in^-1
        d = torch.as_tensor(self.D, device=device)
        phase = torch.as_tensor(self.phase_pair, device=device)
        return (d[:, None] * (t * phase)) / d[None, :]

    def _x(self, ts):
        return self.k * np.linalg.norm(np.asarray(ts, np.float64), axis=1)

    def _check_real_k(self):
        if not isinstance(self.k, float):
            raise NotImplementedError("rscale with complex helmholtz_k")

    def _scaled_table(self, xs, fn, s):
        """``fn(x, qmax, s)`` for every x of *xs*, evaluated once per
        distinct value."""
        uniq, inv = np.unique(xs, return_inverse=True)
        return np.stack([fn(x, self.qmax, s) for x in uniq])[inv]

    def translation_matrices(self, ts, kind, device="cpu", dirs=None):
        """Unscaled operators for translations *ts* ``(C, 3)``: *kind*
        ``"J"`` (regular: M2M/L2L) or ``"H"`` (M2L)
        (``helmholtz3d.py:174-186``).  *dirs* (default *ts*) are vectors
        along *ts* that name their directions exactly (the integer M2L
        classes)."""
        from scipy import special as sp
        q = np.arange(self.qmax + 1)
        x = self._x(ts)[:, None]
        fq = sp.spherical_jn(q, x)
        if kind == "H":
            fq = fq + 1j * sp.spherical_yn(q, x)
        return self.translation_operators(
            ts if dirs is None else dirs, fq, device=device)

    def m2m_matrices_scaled(self, ts, r_c, r_p, device="cpu"):
        """``helmholtz3d.py:202-214`` for a batch."""
        self._check_real_k()
        fhat = self._scaled_table(self._x(ts), sbh.spherical_jn_scaled, r_c)
        na = self.nm_n[:, None, None]
        nb = self.nm_n[None, :, None]
        q = np.arange(self.qmax + 1)[None, None, :]
        pw = (r_c ** np.maximum(q + na - nb, 0)
              * (r_c / r_p) ** nb.astype(np.float64))
        return self.translation_operators(ts, fhat, pw, device)

    def l2l_matrices_scaled(self, ts, r_p, r_c, device="cpu"):
        """``helmholtz3d.py:216-227`` for a batch."""
        self._check_real_k()
        fhat = self._scaled_table(self._x(ts), sbh.spherical_jn_scaled, r_c)
        na = self.nm_n[:, None, None]
        nb = self.nm_n[None, :, None]
        q = np.arange(self.qmax + 1)[None, None, :]
        pw = (r_c ** np.maximum(q + nb - na, 0)
              * (r_c / r_p) ** na.astype(np.float64))
        return self.translation_operators(ts, fhat, pw, device)

    def m2l_matrices_scaled(self, ts, r, device="cpu", dirs=None):
        """``helmholtz3d.py:229-239`` for a batch."""
        self._check_real_k()
        fhat = self._scaled_table(self._x(ts), sbh.spherical_hn1_scaled, r)
        na = self.nm_n[:, None, None]
        nb = self.nm_n[None, :, None]
        q = np.arange(self.qmax + 1)[None, None, :]
        pw = r ** np.maximum(na + nb - q, 0)
        return self.translation_operators(ts if dirs is None else dirs, fhat,
                                          pw, device)

    # }}}


class Helmholtz3DExpansionWrangler(ExpansionWranglerBase):
    """3D Helmholtz FMM wrangler on complex128 coefficients (see module
    doc); the counterpart of ``boxtree_tpu``'s wrangler of the same
    name."""

    _rotation_refusal = (
        "rotation M2L of the 3D Helmholtz wranglers: the reference's axial "
        "operators fail its delta-sparsity check (0.84 at order 5, k = 2; "
        "boxtree_tpu/models/rotation_m2l.py:213-215)")

    dtype = torch.complex128
    _supports_rscale = True
    _supports_dipoles = True
    _kernels = {
        "p2m": hops.p2m_helmholtz3d,
        "p2m_dipole": hops.p2m_helmholtz3d_dipole,
        "p2p": hops.p2p_helmholtz3d,
        "p2p_dipole": hops.p2p_helmholtz3d_dipole,
        "p2l": hops.p2l_helmholtz3d,
        "p2l_dipole": hops.p2l_helmholtz3d_dipole}

    def __init__(self, tree_indep, traversal, **kwargs):
        self.order = tree_indep.order
        self.k = tree_indep.k
        if kwargs.get("dtype") is not None and \
                as_torch_dtype(kwargs["dtype"]) != type(self).dtype:
            raise NotImplementedError(
                f"{type(self).__name__} is ported in {type(self).dtype} "
                "only")
        super().__init__(tree_indep, traversal, **kwargs)
        ti = tree_indep
        #: the ``(K,)`` weight the P2M and P2L kernels take
        self._w_nm = torch.as_tensor(4 * np.pi * 1j * ti.k * ti.D ** 2,
                                     device=self.device)

    def _rscale_factor(self):
        return abs(self.k)

    def _ncoeff(self):
        return sh.ncoeffs(self.order)

    # {{{ operators (helmholtz3d.py:266-279), batched

    def _m2m_matrices(self, ts, r_child, r_parent):
        ti = self.tree_indep
        if r_child == 1.0 and r_parent == 1.0:
            return ti.translation_matrices(ts, "J", self.device)
        return ti.m2m_matrices_scaled(ts, r_child, r_parent, self.device)

    def _l2l_matrices(self, ts, r_parent, r_child):
        ti = self.tree_indep
        if r_child == 1.0 and r_parent == 1.0:
            return ti.translation_matrices(ts, "J", self.device)
        return ti.l2l_matrices_scaled(ts, r_parent, r_child, self.device)

    def _m2l_matrices(self, classes, size, r):
        ti = self.tree_indep
        ts = classes * size
        if r == 1.0:
            return ti.translation_matrices(ts, "H", self.device, classes)
        return ti.m2l_matrices_scaled(ts, r, self.device, classes)

    # }}}

    # {{{ particle hooks (helmholtz3d.py:316-362): P2M and L2P over the
    # boxes that own particles, P2P, M2P and P2L over the lists; with
    # dipole_vec set, P2M, P2P and P2L run the dipole kernels

    def _p2m(self, q):
        tree = self.tree
        return self._with_dipoles(
            "p2m", (self._sources,), q,
            tree.box_source_starts, tree.box_source_counts_nonchild,
            self._source_rows, self.centers, self.box_scale, self._w_nm,
            self.k, self.order)

    def _l2p(self, local_exps):
        tree = self.tree
        return hops.l2p_helmholtz3d(
            self._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, self._target_rows,
            local_exps.contiguous(), self.centers, self.box_scale, self.k,
            self.order)

    def _p2p(self, target_boxes, starts, lists, q):
        tree = self.tree
        return self._with_dipoles(
            "p2p", (self._targets, self._sources), q,
            tree.box_target_starts, tree.box_target_counts_nonchild,
            tree.box_source_starts, tree.box_source_counts_nonchild,
            target_boxes, starts, lists, self.k)

    def _m2p(self, rows, starts, lists, mpole_exps):
        tree = self.tree
        return hops.m2p_helmholtz3d(
            self._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, rows, starts, lists,
            mpole_exps.contiguous(), self.centers, self.box_scale, self.k,
            self.order)

    def _p2l(self, rows, starts, lists, q, out):
        tree = self.tree
        return self._with_dipoles(
            "p2l", (self._sources,), q,
            tree.box_source_starts, tree.box_source_counts_nonchild, rows,
            starts, lists, self.centers, self.box_scale, self._w_nm, self.k,
            self.order, out)

    # }}}


class Helmholtz3DPairsExpansionWrangler(Helmholtz3DExpansionWrangler):
    """3D Helmholtz FMM wrangler with no complex value on the card: real
    float64 charges, ``[re | im]`` real-pair coefficients of 2 (p+1)^2
    values, operators pair-expanded from the complex wrangler's stacks on
    the card, and potentials as ``(ntargets, 2)`` float64 ``[re, im]``
    lanes; the counterpart of ``boxtree_tpu``'s wrangler of the same name
    (``helmholtz3d.py:373-523``).  Real *helmholtz_k* only."""

    dtype = torch.float64
    _pot_extra_dims = (2,)

    def __init__(self, tree_indep, traversal, **kwargs):
        if complex(tree_indep.k).imag != 0:
            raise NotImplementedError(
                "the real-pair Helmholtz wrangler needs a real helmholtz_k")
        super().__init__(tree_indep, traversal, **kwargs)
        ti = tree_indep
        # w_nm = i w_c, so the pair kernels take the real w_c
        self._w_nm = torch.as_tensor(4 * np.pi * ti.k * ti.D ** 2,
                                     device=self.device)

    def reorder_sources(self, source_array):
        if torch.as_tensor(source_array).is_complex():
            raise TypeError(
                "the real-pair wrangler takes REAL source weights; complex "
                "weights are linear: drive the real and imaginary parts "
                "separately and combine")
        return super().reorder_sources(source_array)

    def _ncoeff(self):
        return 2 * sh.ncoeffs(self.order)

    def _coeff_orders(self):
        return np.tile(self.tree_indep.nm_n, 2)

    # {{{ operators: the complex stacks, pair-expanded on the card

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


def make_helmholtz_wrangler(traversal, helmholtz_k, order, *, pairs=None,
                            **kwargs):
    """Helmholtz wrangler for *traversal*, 2D or 3D by its tree
    (``boxtree_tpu/models/helmholtz3d.py:526-572``), with a real
    *helmholtz_k*.

    :arg pairs: the ``[re | im]`` real-pair wrangler
        (:class:`~boxtree_torch.models.helmholtz.
        Helmholtz2DPairsExpansionWrangler` in 2D,
        :class:`Helmholtz3DPairsExpansionWrangler` in 3D; potentials come
        back as ``(ntargets, 2)`` float64 lanes), else the complex one
        (:class:`~boxtree_torch.models.helmholtz.
        Helmholtz2DExpansionWrangler`,
        :class:`Helmholtz3DExpansionWrangler`).  *None* follows the
        reference's rule, keyed on the tree's device as
        :func:`~boxtree_torch.models.make_laplace_wrangler` keys it: pairs
        on CUDA unless a complex ``dtype=`` is given, complex on the CPU.
        The pairs take a complex ``dtype=`` as its real counterpart.

    ``level_to_order``, a complex *helmholtz_k*, ``m2l_mode="rotation"``
    (the reference's rotation M2L fails its own delta-sparsity check of
    the axial operators on the 3D Helmholtz wranglers,
    ``boxtree_tpu/models/rotation_m2l.py:213-215``, and is 3D-only) and
    dtypes other than complex128 (complex) and float64 (pairs) raise
    :class:`NotImplementedError` (the rotation refusal from the wrangler);
    an ``m2l_mode`` other than ``"dense"`` and ``"rotation"`` raises
    :class:`ValueError`.  Other keyword arguments (``rscale``, ``dtype``,
    ``dipole_vec``, ``dipoles_already_reordered`` and ``m2l_mode``, in 2D
    and 3D) go to the wrangler."""
    dim = traversal.tree.dimensions
    if dim not in (2, 3):
        raise NotImplementedError(f"no Helmholtz wrangler for dim={dim}")
    if kwargs.pop("level_to_order", None) is not None:
        raise NotImplementedError("level_to_order is not ported yet")
    if complex(helmholtz_k).imag != 0:
        if kwargs.get("rscale") is not None:
            # the reference's own limit (helmholtz3d.py:198-200)
            raise NotImplementedError("rscale with complex helmholtz_k")
        raise NotImplementedError("complex helmholtz_k is not ported yet")
    dt = kwargs.get("dtype")
    complex_dt = dt is not None and as_torch_dtype(dt).is_complex
    if pairs is None:
        pairs = (traversal.tree.box_levels.device.type != "cpu"
                 and not complex_dt)
    if pairs and complex_dt:
        kwargs["dtype"] = as_torch_dtype(dt).to_real()
    if dim == 2:
        from boxtree_torch.models.helmholtz import (
            Helmholtz2DExpansionWrangler,
            Helmholtz2DPairsExpansionWrangler,
            HelmholtzTreeIndependentDataForWrangler,
        )
        ti = HelmholtzTreeIndependentDataForWrangler(
            2, complex(helmholtz_k).real, order)
        cls = (Helmholtz2DPairsExpansionWrangler if pairs
               else Helmholtz2DExpansionWrangler)
        return cls(ti, traversal, **kwargs)
    ti = Helmholtz3DTreeIndependentDataForWrangler(helmholtz_k, order)
    cls = (Helmholtz3DPairsExpansionWrangler if pairs
           else Helmholtz3DExpansionWrangler)
    return cls(ti, traversal, **kwargs)
