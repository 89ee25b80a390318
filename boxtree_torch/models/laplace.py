"""Laplace expansion wranglers: 2D on complex power series, 3D on complex
solid-harmonic coefficients, each also on ``[re | im]`` real pairs.

Port of ``boxtree_tpu/models/laplace.py:42-366, 379-657``.

**2D** (``laplace.py:68-366``): kernel ``G(t, s) = log(t - s)``
(complex; the potential is its real part), multipole ``a_0 log w + sum_k
a_k w^-k``, local ``sum_l b_l w^l`` (:mod:`boxtree_torch.ops.laplace2d`).
With rscale on, coefficients are stored as ``a~_k = a_k / r^k`` and ``b~_l
= b_l r^l``: every translation argument is divided by the participating
rscale, with diagonal ``(r_child / r_parent)^k`` corrections, and the M2L
table's ``b_0`` entry gains ``+ log(r)`` (``laplace.py:129-158``).  M2M and
L2L come from the host builders (``:92-127``), batched per level; the M2L
table of every level is built on the wrangler's device in one launch of
K72-K74 (``_m2l_ops_device``, ``:160-189`` and ``:271-316``;
:func:`boxtree_torch.ops.m2l_ops.m2l_table_2d`).  Two
wranglers: :class:`Laplace2DExpansionWrangler` on complex128 coefficients,
and :class:`Laplace2DPairsExpansionWrangler` on ``[re | im]`` pair lanes
of float64 or float32 (real potentials).  Every particle stage of both
runs a kernel of :mod:`boxtree_torch.ops.laplace2d` (P2M K38, P2P K19, M2P
K20, P2L K21, L2P K40), and both take dipole sources (K39, K41, K42).

**3D** (``laplace.py:379-612``): kernel ``G(t, s) = 1/|t - s|`` with scaled
solid harmonics (:mod:`boxtree_torch.ops.solid_harmonics`), in which every
translation is a plain spherical convolution:

- ``M_n^m = sum_j q_j conj(R_n^m(y_j - c))``;
  ``phi(x) = sum M_n^m S_n^m(x - c)``
- M2M (centre shift by ``t`` = new - old): ``M'_a = sum_b conj(R_{a-b}(-t))
  M_b``
- M2L (``t`` = c_tgt - c_src): ``L_a = (-1)^{n_a} sum_b S_{a+b}(t) M_b``
- L2L (``t`` = new - old): ``L'_a = sum_b conj(R_{b-a}(t)) L_b``
- local eval: ``phi(x) = sum L_n^m conj(R_n^m(x - c))``

Coefficients are stored rscaled (``M~_n = M_n / r^n``, ``L~_n = L_n r^n``).
M2M and L2L are built on the host in complex float64, one solid-harmonic
evaluation per level over its eight shifts; the M2L table of every level
on the wrangler's device in one launch of K69-K71, in float64, cast to the
coefficient dtype at the store (:func:`boxtree_torch.ops.m2l_ops.
m2l_table_3d`).  With ``m2l_mode="rotation"`` the 3D wranglers build no
table and run the point-and-shoot M2L instead
(:mod:`boxtree_torch.models.rotation_m2l`; ``expansion_base.py:361-378``).
Two wranglers: :class:`Laplace3DExpansionWrangler` on ``(p+1)^2``
complex128 coefficients, and :class:`Laplace3DPairsExpansionWrangler` on
``[re | im]`` pairs of float64 or float32 with real potentials, its
operators pair-expanded.  Every particle stage of both runs a kernel of
:mod:`boxtree_torch.ops.laplace3d` (P2M K28, P2P K2, M2P K3, P2L K4, L2P
K30), which picks the layout by the charges' or the coefficients' dtype.
Both take dipole sources (K29, K22, K23), and every Laplace
wrangler takes ``level_to_order`` (:mod:`boxtree_torch.models.
expansion_base`).
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.config import as_torch_dtype
from boxtree_torch.fmm.drive import TreeIndependentDataForWrangler
from boxtree_torch.models.expansion_base import ExpansionWranglerBase
from boxtree_torch.ops import laplace2d, laplace3d, m2l_ops
from boxtree_torch.ops import solid_harmonics as sh
from boxtree_torch.ops.m2l_ops import binom_table as _binom_table


class LaplaceTreeIndependentDataForWrangler(TreeIndependentDataForWrangler):
    """Expansion order, the binomial table and, in 3D, the (n, m) of every
    coefficient (``laplace.py:51-60``)."""

    def __init__(self, dim, order):
        self.dim = dim
        self.order = order
        self.binom = _binom_table(order)
        if dim == 3:
            self.nm_n = np.concatenate(
                [[n] * (2 * n + 1) for n in range(order + 1)]).astype(
                    np.int64)
            self.nm_m = np.concatenate(
                [np.arange(-n, n + 1) for n in range(order + 1)])


class _LaplaceParticleStages:
    """The particle stages of the Laplace wranglers, each a kernel wrapper
    of ``_kernels`` (``{stage: wrapper}``, the dipole forms under
    ``"<stage>_dipole"``): P2M and L2P over the boxes that own particles,
    P2P, M2P and P2L over the lists; with ``dipole_vec`` set, P2M, P2P and
    P2L run their dipole kernels (``_with_dipoles``).  Also their M2L
    table."""

    def _m2l_table(self, used, classes):
        """The M2L table of every level in one launch (K69-K71 in 3D,
        K72-K74 in 2D on the card; :func:`boxtree_torch.ops.m2l_ops.
        m2l_table`); its inputs stay in ``_m2l_table_args``."""
        self._m2l_table_args = self._m2l_table_inputs(used, classes)
        return m2l_ops.m2l_table(self.dim, *self._m2l_table_args,
                                 self.order, self.dtype, self.device,
                                 self.level_orders)

    def _p2m(self, q):
        tree = self.tree
        return self._with_dipoles(
            "p2m", (self._sources,), q, tree.box_source_starts,
            tree.box_source_counts_nonchild, self._source_rows, self.centers,
            self.box_scale, self.order)

    def _l2p(self, local_exps):
        tree = self.tree
        return self._kernels["l2p"](
            self._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, self._target_rows,
            local_exps.contiguous(), self.centers, self.box_scale,
            self.order)

    def _p2p(self, target_boxes, starts, lists, q):
        tree = self.tree
        return self._with_dipoles(
            "p2p", (self._targets, self._sources), q, tree.box_target_starts,
            tree.box_target_counts_nonchild, tree.box_source_starts,
            tree.box_source_counts_nonchild, target_boxes, starts, lists)

    def _m2p(self, rows, starts, lists, mpole_exps):
        tree = self.tree
        return self._kernels["m2p"](
            self._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, rows, starts, lists,
            mpole_exps.contiguous(), self.centers, self.box_scale,
            self.order)

    def _p2l(self, rows, starts, lists, q, out):
        tree = self.tree
        return self._with_dipoles(
            "p2l", (self._sources,), q, tree.box_source_starts,
            tree.box_source_counts_nonchild, rows, starts, lists,
            self.centers, self.box_scale, self.order, out)


# {{{ 2D

class Laplace2DExpansionWrangler(_LaplaceParticleStages,
                                 ExpansionWranglerBase):
    """2D Laplace FMM wrangler on complex128 power-series coefficients
    (see module doc); the counterpart of ``boxtree_tpu``'s wrangler of the
    same name.  Takes dipole sources (K39, K41, K42)."""

    dtype = torch.complex128
    _supports_rscale = True
    _supports_dipoles = True
    #: the coefficient dtypes the class computes in
    _dtypes = (torch.complex128,)
    _kernels = {
        "p2m": laplace2d.p2m_laplace2d,
        "p2m_dipole": laplace2d.p2m_laplace2d_dipole,
        "l2p": laplace2d.l2p_laplace2d, "p2p": laplace2d.p2p_laplace2d,
        "p2p_dipole": laplace2d.p2p_laplace2d_dipole,
        "m2p": laplace2d.m2p_laplace2d, "p2l": laplace2d.p2l_laplace2d,
        "p2l_dipole": laplace2d.p2l_laplace2d_dipole}

    def __init__(self, tree_indep, traversal, **kwargs):
        self.order = tree_indep.order
        dt = kwargs.get("dtype")
        dt = self.dtype if dt is None else as_torch_dtype(dt)
        if dt not in self._dtypes:
            raise NotImplementedError(
                f"{type(self).__name__} is ported in "
                f"{', '.join(map(str, self._dtypes))}, not {dt}")
        if traversal.tree.box_levels.device.type == "cuda":
            # K20, K21 and K42 refuse here what they would refuse mid-FMM
            laplace2d.check_order(self.order, dt)
        super().__init__(tree_indep, traversal, **kwargs)

    def _ncoeff(self):
        return self.order + 1

    def _coeff_orders(self):
        return np.arange(self.order + 1)

    # {{{ host operators (laplace.py:92-158), batched over the shifts

    def _m2m_host(self, t):
        """``(n, p+1, p+1)``: ``a'_l = sum_k A[l, k] a_k`` for the centre
        shifts ``z_old - z_new = t`` (complex, ``(n,)``)."""
        p, binom = self.order, self.tree_indep.binom
        ell = np.arange(p + 1)
        tp = t[:, None] ** ell                               # (n, p+1)
        lm, km = np.meshgrid(ell, ell, indexing="ij")
        tri = (km >= 1) & (km <= lm)
        a = np.where(tri, binom[np.maximum(lm - 1, 0), np.maximum(km - 1, 0)]
                     * tp[:, np.where(tri, lm - km, 0)], 0)
        a[:, 1:, 0] = -tp[:, 1:] / ell[1:]
        a[:, 0, 0] = 1.0
        return a

    def _l2l_host(self, t):
        """``(n, p+1, p+1)``: ``b'_l = sum_k B[l, k] b_k`` for the centre
        shifts ``z_old - z_new = t``."""
        p, binom = self.order, self.tree_indep.binom
        ell = np.arange(p + 1)
        tp = (-t)[:, None] ** ell
        lm, km = np.meshgrid(ell, ell, indexing="ij")
        upper = km >= lm
        return np.where(upper, binom[km, lm]
                        * tp[:, np.where(upper, km - lm, 0)], 0)

    @staticmethod
    def _z(ts):
        ts = np.asarray(ts, np.float64)
        return ts[:, 0] + 1j * ts[:, 1]

    def _m2m_complex(self, ts, r_child, r_parent):
        # ts = new - old
        a = self._m2m_host(-self._z(ts) / r_parent)
        if r_child != r_parent:
            a = a * (r_child / r_parent) ** np.arange(
                self.order + 1)[None, None, :]
        return a

    def _l2l_complex(self, ts, r_parent, r_child):
        b = self._l2l_host(-self._z(ts) / r_parent)
        if r_child != r_parent:
            b = b * ((r_child / r_parent) ** np.arange(
                self.order + 1))[None, :, None]
        return b

    _m2m_matrices = _m2m_complex
    _l2l_matrices = _l2l_complex

    def _m2l_lanes(self, classes, size, r):
        """Real and imaginary parts, ``(C, p+1, p+1)`` float64 on the
        wrangler's device, of the M2L operators of the translations
        ``classes * size`` (``c_tgt - c_src``) at rscale *r*
        (:func:`boxtree_torch.ops.m2l_ops.m2l_lanes_2d`)."""
        return m2l_ops.m2l_lanes_2d(np.asarray(classes, np.float64) * size,
                                    r, self.order, self.device)

    def _m2l_matrices(self, classes, size, r):
        return torch.complex(*self._m2l_lanes(classes, size, r))

    # }}}


class Laplace2DPairsExpansionWrangler(Laplace2DExpansionWrangler):
    """2D Laplace FMM wrangler on ``[re | im]`` pair-lane coefficients of
    float64 (the default) or float32, with real potentials; the
    counterpart of ``boxtree_tpu``'s wrangler of the same name."""

    dtype = torch.float64
    _dtypes = (torch.float64, torch.float32)

    def _ncoeff(self):
        return 2 * (self.order + 1)

    def _coeff_orders(self):
        return np.tile(np.arange(self.order + 1), 2)

    def reorder_sources(self, source_array):
        a = torch.as_tensor(source_array, device=self.device)
        if a.is_complex():
            # the reference casts the weights to its real dtype in P2M,
            # P2P and P2L (laplace.py:320, expansion_base.py:1264, 1643):
            # their imaginary part is dropped
            a = a.real
        return super().reorder_sources(a)

    def _m2m_matrices(self, ts, r_child, r_parent):
        return sh.pair_matrix(self._m2m_complex(ts, r_child, r_parent))

    def _l2l_matrices(self, ts, r_parent, r_child):
        return sh.pair_matrix(self._l2l_complex(ts, r_parent, r_child))

    def _m2l_matrices(self, classes, size, r):
        return sh.pair_blocks(*self._m2l_lanes(classes, size, r))

# }}}


# {{{ 3D


class Laplace3DExpansionWrangler(_LaplaceParticleStages,
                                 ExpansionWranglerBase):
    """3D Laplace FMM wrangler on complex128 solid-harmonic coefficients
    (see module doc); the counterpart of ``boxtree_tpu``'s wrangler of the
    same name.  Takes dipole sources (K22, K23)."""

    dtype = torch.complex128
    _supports_rscale = True
    _supports_dipoles = True
    _rotation_refusal = None
    #: the coefficient dtypes the class computes in
    _dtypes = (torch.complex128,)
    _kernels = {
        "p2m": laplace3d.p2m_laplace3d,
        "p2m_dipole": laplace3d.p2m_laplace3d_dipole,
        "l2p": laplace3d.l2p_laplace3d, "p2p": laplace3d.p2p_laplace3d,
        "p2p_dipole": laplace3d.p2p_laplace3d_dipole,
        "m2p": laplace3d.m2p_laplace3d, "p2l": laplace3d.p2l_laplace3d,
        "p2l_dipole": laplace3d.p2l_laplace3d_dipole}

    def __init__(self, tree_indep, traversal, **kwargs):
        self.order = tree_indep.order
        dt = kwargs.get("dtype")
        dt = self.dtype if dt is None else as_torch_dtype(dt)
        if dt not in self._dtypes:
            raise NotImplementedError(
                f"{type(self).__name__} is ported in "
                f"{', '.join(map(str, self._dtypes))}, not {dt}")
        super().__init__(tree_indep, traversal, **kwargs)

    def _ncoeff(self):
        return sh.ncoeffs(self.order)

    def _coeff_orders(self):
        return self.tree_indep.nm_n

    # {{{ operators (laplace.py:402-460): M2M / L2L on the host, batched
    # over a level's shifts; the M2L table in torch on the device

    def _shift_matrices(self, rb, rows_minus_cols):
        """``(n, K, K)`` operators ``mat[a, b] = rb[:, a - b]`` (M2M) or
        ``rb[:, b - a]`` (L2L) of the per-shift coefficients *rb* ``(n,
        K)``, zero where the difference is not an (n, m) pair."""
        ti = self.tree_indep
        sign = 1 if rows_minus_cols else -1
        j = sign * (ti.nm_n[:, None] - ti.nm_n[None, :])
        k = sign * (ti.nm_m[:, None] - ti.nm_m[None, :])
        valid = (j >= 0) & (np.abs(k) <= j)
        idx = np.where(valid, j * j + j + k, 0)
        return np.where(valid[None], rb[:, idx], 0)

    def _m2m_complex(self, ts, r_child, r_parent):
        # ts = new - old; M'_a = sum_b conj(R_{a-b}(-t)) M_b
        rb = np.conj(sh.regular(-np.asarray(ts, np.float64).T / r_parent,
                                self.order))
        mat = self._shift_matrices(rb, True)
        if r_child != r_parent:
            mat = mat * (r_child / r_parent) ** self.tree_indep.nm_n
        return mat

    def _l2l_complex(self, ts, r_parent, r_child):
        # L'_a = sum_b conj(R_{b-a}(t)) L_b
        rb = np.conj(sh.regular(np.asarray(ts, np.float64).T / r_parent,
                                self.order))
        mat = self._shift_matrices(rb, False)
        if r_child != r_parent:
            mat = mat * ((r_child / r_parent)
                         ** self.tree_indep.nm_n)[:, None]
        return mat

    _m2m_matrices = _m2m_complex
    _l2l_matrices = _l2l_complex

    def _m2l_lanes(self, classes, size, r):
        """Real and imaginary parts, ``(C, K, K)`` float64 on the
        wrangler's device, of the M2L operators ``L_a = (-1)^{n_a} sum_b
        S_{a+b}(t / r) M_b / r`` of the translations ``t = classes * size``
        (``c_tgt - c_src``) at rscale *r*
        (:func:`boxtree_torch.ops.m2l_ops.m2l_lanes_3d`)."""
        return m2l_ops.m2l_lanes_3d(np.asarray(classes, np.float64) * size,
                                    r, self.order, self.device)

    def _m2l_matrices(self, classes, size, r):
        return torch.complex(*self._m2l_lanes(classes, size, r))

    # }}}


class Laplace3DPairsExpansionWrangler(Laplace3DExpansionWrangler):
    """3D Laplace FMM wrangler on ``[re | im]`` real-pair coefficients of
    float64 (the default) or float32, with real potentials (see module
    doc); the counterpart of ``boxtree_tpu``'s wrangler of the same
    name."""

    dtype = torch.float64
    _dtypes = (torch.float64, torch.float32)

    def _ncoeff(self):
        return 2 * sh.ncoeffs(self.order)

    def _coeff_orders(self):
        return np.tile(self.tree_indep.nm_n, 2)

    def reorder_sources(self, a):
        if torch.as_tensor(a).is_complex():
            raise TypeError("the real-pair wrangler takes REAL source "
                            "weights")
        return super().reorder_sources(a)

    def _m2m_matrices(self, ts, r_child, r_parent):
        return sh.pair_matrix(self._m2m_complex(ts, r_child, r_parent))

    def _l2l_matrices(self, ts, r_parent, r_child):
        return sh.pair_matrix(self._l2l_complex(ts, r_parent, r_child))

    def _m2l_matrices(self, classes, size, r):
        return sh.pair_blocks(*self._m2l_lanes(classes, size, r))

# }}}


def make_laplace_wrangler(traversal, order=None, *, level_to_order=None,
                          pairs=None, **kwargs):
    """Laplace wrangler for *traversal*, by dimension (``boxtree_tpu/models/
    laplace.py:615-657``).

    Pass exactly one of *order* and *level_to_order* (a ``level -> order``
    callable; the wrangler's order is the largest over the tree's levels).

    :arg pairs: the ``[re | im]`` real-pair wrangler.  *None* follows the
        reference's rule, keyed on the tree's device: complex on the CPU,
        pairs on CUDA; a complex ``dtype=`` forces the complex wrangler.
        The pairs take a complex ``dtype=`` as its real counterpart.

    :arg m2l_mode: ``"dense"`` (the default: the M2L table and K35) or
        ``"rotation"``, the point-and-shoot M2L of
        :mod:`boxtree_torch.models.rotation_m2l` (K77-K79 over the edges
        that K75 / K76 classify), in 3D without ``level_to_order``; in 2D
        or with ``level_to_order`` it raises
        :class:`NotImplementedError`, as the reference does, and another
        mode :class:`ValueError`.

    Other keyword arguments (``rscale``, ``dtype``, ``dipole_vec``,
    ``dipoles_already_reordered``) go to the wrangler.  Complex64 and
    dimensions other than 2 and 3 raise :class:`NotImplementedError`.
    """
    if (order is None) == (level_to_order is None):
        raise TypeError("pass exactly one of order / level_to_order")
    dim = traversal.tree.dimensions
    if dim not in (2, 3):
        raise NotImplementedError(f"no Laplace wrangler for dim={dim}")
    if level_to_order is not None:
        order = max(int(level_to_order(lev))
                    for lev in range(traversal.tree.nlevels))
        kwargs["level_to_order"] = level_to_order
    # the port's M2L always runs in full precision
    kwargs.pop("m2l_accurate", None)
    dt = kwargs.get("dtype")
    complex_dt = dt is not None and as_torch_dtype(dt).is_complex
    if pairs is None:
        pairs = (traversal.tree.box_levels.device.type != "cpu"
                 and not complex_dt)
    if pairs:
        if complex_dt:
            kwargs["dtype"] = as_torch_dtype(dt).to_real()
        cls = (Laplace2DPairsExpansionWrangler if dim == 2
               else Laplace3DPairsExpansionWrangler)
    else:
        cls = (Laplace2DExpansionWrangler if dim == 2
               else Laplace3DExpansionWrangler)
    ti = LaplaceTreeIndependentDataForWrangler(dim, order)
    return cls(ti, traversal, **kwargs)
