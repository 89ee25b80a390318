"""The M2L operator tables of the Laplace wranglers, one launch a setup.

Port of ``boxtree_tpu/models/laplace.py:160-189`` and ``:271-316`` (2D)
and ``:449-460`` and ``:561-575`` (3D) ``_m2l_ops_device``, which the
reference runs as one device program per setup
(``expansion_base.py:398-424``).  A table holds one ``(K, K)`` operator per
used (level, translation class) of List 2, transposed for row vectors,
with the level's ``level_to_order`` mask applied to its rows and columns,
in the wrangler's layout: complex128, or the real pair blocks ``[[Tr,
-Ti], [Ti, Tr]]`` (:func:`~boxtree_torch.ops.solid_harmonics.pair_blocks`)
of float64 or float32.

Inputs, per operator, on the host: the translation ``t = c_tgt - c_src``
(``ts``, ``(nops, d)`` float64), its level's rscale ``r`` (``rs``) and its
level (``levels``; the table's operators come level by level), and, with
``level_to_order``, the order of each level (``level_orders``).

- 3D: ``L_a = (-1)^{n_a} sum_b S_{a+b}(t / r) M_b / r``, the irregular
  solid harmonics of order 2p at ``t / r`` spread by the static ``(n_a +
  n_b, m_a + m_b)`` index map (:func:`m2l_lanes_3d`).
- 2D: with ``z0 = -t / r``, ``b[l, k] = (-1)^k C(l+k-1, l) z0^-(l+k)``
  for ``k >= 1``, ``b[l, 0] = -z0^-l / l`` for ``l >= 1`` and ``b[0, 0] =
  log(-z0) + log(r)`` (:func:`m2l_lanes_2d`).

:func:`m2l_table` (:func:`m2l_table_3d`, :func:`m2l_table_2d`) runs the
plain twins (:func:`m2l_table_3d_plain`, :func:`m2l_table_2d_plain`: the
per-level torch path of the wranglers before the kernels, level by level)
for the CPU device, and on a CUDA device launches the hand-written kernel
of ``csrc/m2l_ops.cu`` once for the whole table (K69-K71 in 3D, K72-K74
in 2D: ``_c128``, ``_f64``, ``_f32``), or raises;
:func:`table_launch_args` gives that launch's arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from boxtree_torch.ops import kernels
from boxtree_torch.ops import solid_harmonics as sh

_DTYPES = (torch.complex128, torch.float64, torch.float32)


def binom_table(p):
    """``(2p+2, 2p+2)`` binomial coefficients ``C(i, j)``
    (``laplace.py:42-48``)."""
    c = np.zeros((2 * p + 2, 2 * p + 2))
    c[:, 0] = 1
    for i in range(1, 2 * p + 2):
        for j in range(1, i + 1):
            c[i, j] = c[i - 1, j - 1] + c[i - 1, j]
    return c


def nm_indices(p):
    """``(n, m)`` of each 3D coefficient ``n^2 + n + m``, as int64."""
    nm_n = np.concatenate([[n] * (2 * n + 1)
                           for n in range(p + 1)]).astype(np.int64)
    nm_m = np.concatenate([np.arange(-n, n + 1) for n in range(p + 1)])
    return nm_n, nm_m


def coeff_orders(dim, p):
    """The least order that holds each complex coefficient."""
    return nm_indices(p)[0] if dim == 3 else np.arange(p + 1)


# {{{ the lanes (the wranglers' builders before the kernels)

def m2l_lanes_3d(ts, r, p, device):
    """Real and imaginary parts, ``(C, K, K)`` float64 on *device*, of the
    3D M2L operators of the translations *ts* ``(C, 3)`` at rscale *r*."""
    nm_n, nm_m = nm_indices(p)
    ts = torch.as_tensor(np.asarray(ts, np.float64), device=device)
    sb = sh.irregular_pairs(ts.T / r, 2 * p)
    k2 = sh.ncoeffs(2 * p)
    n_sum = nm_n[:, None] + nm_n[None, :]
    idx = torch.as_tensor(n_sum * n_sum + n_sum + nm_m[:, None]
                          + nm_m[None, :], device=device)
    sign = torch.as_tensor((-1.0) ** nm_n[:, None] / r, device=device)
    return sign * sb[:, idx], sign * sb[:, k2 + idx]


def m2l_coef_2d(p):
    """``(p+1, p+1)``: ``(-1)^k C(l+k-1, l)`` at ``[l, k]`` for ``k >= 1``,
    0 in column 0."""
    binom = binom_table(p)
    ell = np.arange(p + 1)
    coef = np.zeros((p + 1, p + 1))
    for k in range(1, p + 1):
        coef[:, k] = ((-1.0) ** k) * binom[ell + k - 1, ell]
    return coef


def m2l_lanes_2d(ts, r, p, device):
    """Real and imaginary parts, ``(C, p+1, p+1)`` float64 on *device*, of
    the 2D M2L operators of the translations *ts* ``(C, 2)`` at rscale
    *r*; ``log(-z0)`` takes the argument of ``t`` with its zeros as they
    are, as both references do."""
    ts = torch.as_tensor(np.asarray(ts, np.float64), device=device)
    tx, ty = ts[:, 0], ts[:, 1]
    x0, y0 = -tx / r, -ty / r
    n2 = x0 * x0 + y0 * y0
    ixr, ixi = x0 / n2, -y0 / n2                         # 1 / z0
    zpr, zpi = [torch.ones_like(x0)], [torch.zeros_like(x0)]
    for _ in range(1, 2 * p + 2):
        pr, pi = zpr[-1], zpi[-1]
        zpr.append(pr * ixr - pi * ixi)
        zpi.append(pr * ixi + pi * ixr)
    zpr, zpi = torch.stack(zpr, dim=1), torch.stack(zpi, dim=1)
    ell = np.arange(p + 1)
    coef = torch.as_tensor(m2l_coef_2d(p), device=device)
    lk = torch.as_tensor(ell[:, None] + ell[None, :], device=device)
    br, bi = coef * zpr[:, lk], coef * zpi[:, lk]
    lr = 0.5 * torch.log((tx * tx + ty * ty) / (r * r)) + math.log(r)
    li = torch.atan2(ty, tx)
    linv = torch.as_tensor(1.0 / ell[1:], device=device)
    br[:, :, 0] = torch.cat([lr[:, None], -zpr[:, 1:p + 1] * linv], 1)
    bi[:, :, 0] = torch.cat([li[:, None], -zpi[:, 1:p + 1] * linv], 1)
    return br, bi

# }}}


# {{{ the tables

def _check(ts, rs, levels, dim, dtype):
    if dtype not in _DTYPES:
        raise TypeError(f"no M2L table kernel for {dtype}")
    ts = np.asarray(ts, np.float64)
    if ts.ndim != 2 or ts.shape[1] != dim:
        raise ValueError(f"translations must be (nops, {dim})")
    if len(rs) != len(ts) or len(levels) != len(ts):
        raise ValueError("one rscale and one level per translation")
    return ts


def _ncoeff(dim, p, dtype):
    k = sh.ncoeffs(p) if dim == 3 else p + 1
    return k if dtype.is_complex else 2 * k


def _segments(levels):
    """``(start, stop)`` runs of equal levels."""
    levels = np.asarray(levels)
    if not len(levels):
        return []
    cuts = np.concatenate([[0], np.nonzero(np.diff(levels))[0] + 1,
                           [len(levels)]])
    return list(zip(cuts[:-1].tolist(), cuts[1:].tolist()))


def _table_plain(lanes, dim, ts, rs, levels, p, dtype, device,
                 level_orders):
    """Per level: the lanes, the layout, the cast, the ``level_to_order``
    mask and the transpose (the wranglers' path before the kernels)."""
    ts = _check(ts, rs, levels, dim, dtype)
    k = _ncoeff(dim, p, dtype)
    orders = coeff_orders(dim, p)
    if not dtype.is_complex:
        orders = np.tile(orders, 2)
    out = []
    for s0, s1 in _segments(levels):
        br, bi = lanes(ts[s0:s1], float(rs[s0]), p, device)
        mats = (torch.complex(br, bi) if dtype.is_complex
                else sh.pair_blocks(br, bi))
        mats = torch.as_tensor(mats, dtype=dtype, device=device)
        if level_orders is not None:
            keep = torch.as_tensor(
                orders <= int(level_orders[int(levels[s0])]), device=device)
            mats = torch.where(keep[:, None] & keep[None, :], mats,
                               torch.zeros((), dtype=dtype, device=device))
        out.append(mats.transpose(1, 2))
    if not out:
        return torch.zeros((0, k, k), dtype=dtype, device=device)
    return torch.cat(out).contiguous()


def m2l_table_3d_plain(ts, rs, levels, p, dtype, device, level_orders=None):
    """Plain twin of :func:`m2l_table_3d`."""
    return _table_plain(m2l_lanes_3d, 3, ts, rs, levels, p, dtype,
                        torch.device(device), level_orders)


def m2l_table_2d_plain(ts, rs, levels, p, dtype, device, level_orders=None):
    """Plain twin of :func:`m2l_table_2d`."""
    return _table_plain(m2l_lanes_2d, 2, ts, rs, levels, p, dtype,
                        torch.device(device), level_orders)


def _op_orders(levels, p, level_orders):
    if level_orders is None:
        return np.full(len(levels), p, np.int32)
    return np.asarray(level_orders)[np.asarray(levels, np.int64)].astype(
        np.int32)


def smem_3d(p):
    """Bytes of shared memory K69-K71 take at order *p*: the order-2p
    irregular basis, ``[re | im]`` float64."""
    return 16 * sh.ncoeffs(2 * p)


def table_launch_args(dim, ts, rs, levels, p, dtype, device,
                      level_orders=None):
    """The arguments of K69-K71 (*dim* 3) or K72-K74 (*dim* 2) on the
    CUDA *device*: the inputs uploaded, the scalars, and last the empty
    ``(nops, K, K)`` table that the launch fills."""
    ts = _check(ts, rs, levels, dim, dtype)
    if dim == 3 and smem_3d(p) > kernels.SMEM_MAX:
        raise ValueError(
            f"the order-{2 * p} basis of the 3D M2L table "
            f"({smem_3d(p)} bytes) does not fit a CTA's shared memory")
    k = _ncoeff(dim, p, dtype)
    f64 = dict(dtype=torch.float64, device=device)
    rs = np.asarray(rs, np.float64)
    args = [torch.as_tensor(ts, **f64).contiguous(),
            torch.as_tensor(rs, **f64)]
    if dim == 2:
        args += [torch.as_tensor([math.log(r) for r in rs.tolist()], **f64),
                 torch.as_tensor(m2l_coef_2d(p), **f64).contiguous()]
    return [*args, torch.as_tensor(_op_orders(levels, p, level_orders),
                                   device=device), len(ts), p,
            torch.empty((len(ts), k, k), dtype=dtype, device=device)]


def m2l_table(dim, ts, rs, levels, p, dtype, device, level_orders=None):
    """``(nops, K, K)`` transposed M2L table (see module doc) of dimension
    *dim* on *device*, in *dtype* (complex128, or pairs of float64 /
    float32): the plain twin for the CPU, on CUDA K69-K71 (3D) or K72-K74
    (2D), one launch."""
    device = torch.device(device)
    if device.type == "cpu":
        plain = m2l_table_3d_plain if dim == 3 else m2l_table_2d_plain
        return plain(ts, rs, levels, p, dtype, device, level_orders)
    args = table_launch_args(dim, ts, rs, levels, p, dtype, device,
                             level_orders)
    if len(ts):
        kernels.launch(f"m2l_table_{dim}d", dtype, *args)
    return args[-1]


def m2l_table_3d(ts, rs, levels, p, dtype, device, level_orders=None):
    """:func:`m2l_table` in 3D (K69-K71)."""
    return m2l_table(3, ts, rs, levels, p, dtype, device, level_orders)


def m2l_table_2d(ts, rs, levels, p, dtype, device, level_orders=None):
    """:func:`m2l_table` in 2D (K72-K74)."""
    return m2l_table(2, ts, rs, levels, p, dtype, device, level_orders)

# }}}
