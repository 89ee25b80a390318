"""3D Laplace expansion wrangler on ``[re | im]`` real-pair coefficients.

Port of ``boxtree_tpu/models/laplace.py:42-66, 379-657``: kernel
``G(t, s) = 1/|t - s|`` with scaled solid harmonics
(:mod:`boxtree_torch.ops.solid_harmonics`), in which every translation is a
plain spherical convolution:

- ``M_n^m = sum_j q_j conj(R_n^m(y_j - c))``;
  ``phi(x) = sum M_n^m S_n^m(x - c)``
- M2M (centre shift by ``t`` = new - old): ``M'_a = sum_b conj(R_{a-b}(-t))
  M_b``
- M2L (``t`` = c_tgt - c_src): ``L_a = (-1)^{n_a} sum_b S_{a+b}(t) M_b``
- L2L (``t`` = new - old): ``L'_a = sum_b conj(R_{b-a}(t)) L_b``
- local eval: ``phi(x) = sum L_n^m conj(R_n^m(x - c))``

Coefficients are stored rscaled (``M~_n = M_n / r^n``, ``L~_n = L_n r^n``)
and as real pairs; the host builds the complex operators in float64 and
expands them with :func:`~boxtree_torch.ops.solid_harmonics.pair_matrix`.
Potentials are computed directly as their real part.
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.fmm.drive import TreeIndependentDataForWrangler
from boxtree_torch.models.expansion_base import ExpansionWranglerBase
from boxtree_torch.ops import laplace3d
from boxtree_torch.ops import solid_harmonics as sh


class LaplaceTreeIndependentDataForWrangler(TreeIndependentDataForWrangler):
    """Expansion order + the (n, m) of every coefficient."""

    def __init__(self, dim, order):
        self.dim = dim
        self.order = order
        self.nm_n = np.concatenate(
            [[n] * (2 * n + 1) for n in range(order + 1)]).astype(np.int64)
        self.nm_m = np.concatenate(
            [np.arange(-n, n + 1) for n in range(order + 1)])


class Laplace3DPairsExpansionWrangler(ExpansionWranglerBase):
    """3D Laplace FMM wrangler on real-pair coefficients (see module doc);
    the counterpart of ``boxtree_tpu``'s wrangler of the same name."""

    dtype = torch.float64
    _supports_rscale = True

    def __init__(self, tree_indep, traversal, **kwargs):
        self.order = tree_indep.order
        super().__init__(tree_indep, traversal, **kwargs)

    def _ncoeff(self):
        return 2 * sh.ncoeffs(self.order)

    def reorder_sources(self, a):
        if torch.as_tensor(a).is_complex():
            raise TypeError("the real-pair wrangler takes REAL source "
                            "weights")
        return super().reorder_sources(a)

    # {{{ host operators: complex builders (laplace.py:402-447),
    # pair-expanded

    def _m2m_matrix(self, t, r_child=1.0, r_parent=1.0):
        ti = self.tree_indep
        rb = np.conj(sh.regular(-np.asarray(t)[:, None] / r_parent,
                                self.order)[0])
        j = ti.nm_n[:, None] - ti.nm_n[None, :]
        k = ti.nm_m[:, None] - ti.nm_m[None, :]
        valid = (j >= 0) & (np.abs(k) <= j)
        jj = np.where(valid, j, 0)
        kk = np.where(valid, k, 0)
        mat = np.where(valid, rb[jj * jj + jj + kk], 0)
        if r_child != r_parent:
            mat = mat * (r_child / r_parent) ** ti.nm_n[None, :]
        return sh.pair_matrix(mat)

    def _l2l_matrix(self, t, r_parent=1.0, r_child=1.0):
        ti = self.tree_indep
        rb = np.conj(sh.regular(np.asarray(t)[:, None] / r_parent,
                                self.order)[0])
        j = ti.nm_n[None, :] - ti.nm_n[:, None]
        k = ti.nm_m[None, :] - ti.nm_m[:, None]
        valid = (j >= 0) & (np.abs(k) <= j)
        jj = np.where(valid, j, 0)
        kk = np.where(valid, k, 0)
        mat = np.where(valid, rb[jj * jj + jj + kk], 0)
        if r_child != r_parent:
            mat = mat * ((r_child / r_parent) ** ti.nm_n)[:, None]
        return sh.pair_matrix(mat)

    def _m2m_matrices(self, ts, r_child, r_parent):
        return np.stack([self._m2m_matrix(t, r_child, r_parent)
                         for t in ts])

    def _l2l_matrices(self, ts, r_parent, r_child):
        return np.stack([self._l2l_matrix(t, r_parent, r_child)
                         for t in ts])

    def _m2l_matrices(self, classes, size, r):
        """(C, K, K) real M2L operators of the translations ``classes *
        size`` at rscale *r*."""
        ti = self.tree_indep
        ts = np.asarray(classes * size, np.float64)
        rs = np.full(len(ts), r)
        sb = sh.irregular(ts.T / rs[None, :], 2 * self.order)
        n_sum = ti.nm_n[:, None] + ti.nm_n[None, :]
        m_sum = ti.nm_m[:, None] + ti.nm_m[None, :]
        sign = (-1.0) ** ti.nm_n[:, None]
        idx = n_sum * n_sum + n_sum + m_sum
        return sh.pair_matrix(sign[None] * sb[:, idx] / rs[:, None, None])

    # }}}

    # {{{ particle hooks (laplace.py:581-593)

    def _p2m_terms(self, rel, q, scale):
        # conj(R) * q  ->  [Rr | -Ri] * q
        rp = sh.regular_pairs(rel, self.order)
        k = sh.ncoeffs(self.order)
        return torch.cat([rp[..., :k], -rp[..., k:]], dim=-1) * q[..., None]

    def _l2p_eval(self, rel, loc, scale):
        # Re(sum conj(R) * loc) = Rr.lr + Ri.li
        rp = sh.regular_pairs(rel, self.order)
        k = sh.ncoeffs(self.order)
        return (rp[..., :k] * loc[..., :k] + rp[..., k:] * loc[..., k:]).sum(-1)

    # }}}

    # {{{ list-stage hooks: the K2-K4 kernels

    def _p2p(self, target_boxes, starts, lists, q):
        tree = self.tree
        return laplace3d.p2p_laplace3d(
            self._targets, self._sources, q.contiguous(),
            tree.box_target_starts, tree.box_target_counts_nonchild,
            tree.box_source_starts, tree.box_source_counts_nonchild,
            target_boxes, starts, lists)

    def _m2p(self, rows, starts, lists, mpole_exps):
        tree = self.tree
        return laplace3d.m2p_laplace3d(
            self._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, rows, starts, lists,
            mpole_exps.contiguous(), self.centers, self.box_scale,
            self.order)

    def _p2l(self, rows, starts, lists, q, out):
        tree = self.tree
        return laplace3d.p2l_laplace3d(
            self._sources, q.contiguous(), tree.box_source_starts,
            tree.box_source_counts_nonchild, rows, starts, lists,
            self.centers, self.box_scale, self.order, out)

    # }}}


def make_laplace_wrangler(traversal, order=None, *, level_to_order=None,
                          pairs=None, **kwargs):
    """Laplace wrangler for *traversal* (``boxtree_tpu/models/laplace.py:
    615-657``).  The port covers the 3D real-pair wrangler; ``pairs=False``,
    ``level_to_order`` and 2D raise :class:`NotImplementedError`.  Other
    keyword arguments (``rscale``, ``dtype``) go to the wrangler."""
    if level_to_order is not None:
        raise NotImplementedError("level_to_order is not ported yet")
    if order is None:
        raise TypeError("pass order")
    dim = traversal.tree.dimensions
    if dim != 3:
        raise NotImplementedError(f"no Laplace wrangler for dim={dim} yet")
    if pairs is False:
        raise NotImplementedError("the complex Laplace wrangler is not "
                                  "ported yet; use pairs=True")
    if kwargs.pop("dipole_vec", None) is not None:
        raise NotImplementedError("dipole sources are not ported yet")
    if kwargs.pop("m2l_mode", "dense") != "dense":
        raise NotImplementedError("rotation M2L is not ported yet")
    # the port's M2L always runs in full precision
    kwargs.pop("m2l_accurate", None)
    dt = kwargs.get("dtype")
    if dt is not None and not isinstance(dt, torch.dtype) and \
            np.issubdtype(np.dtype(dt), np.complexfloating):
        kwargs["dtype"] = np.zeros(0, dt).real.dtype
    ti = LaplaceTreeIndependentDataForWrangler(dim, order)
    return Laplace3DPairsExpansionWrangler(ti, traversal, **kwargs)
