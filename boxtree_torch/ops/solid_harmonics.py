"""Solid harmonics for the 3D Laplace FMM.

Port of :mod:`boxtree_tpu.ops.solid_harmonics` with the same normalization
and coefficient layout (``(n, m) -> n*n + n + m``):

- regular:   ``R_n^m(x) = rho^n  P_n^|m|(cos th) e^{i m phi} / (n+|m|)!``
- irregular: ``S_n^m(x) = (n-|m|)! P_n^|m|(cos th) e^{i m phi} / rho^{n+1}``

so that ``1/|x - y| = sum conj(R_n^m(y)) S_n^m(x)`` for ``|y| < |x|``.
:func:`regular_pairs` / :func:`irregular_pairs` evaluate the recurrences on
torch tensors as ``[re | im]`` real pairs; :func:`regular` /
:func:`irregular` return them complex, as numpy arrays for numpy input
(the host M2M / L2L builders) or as complex tensors, on the input's device,
for a tensor (the M2L table and the complex hooks).
"""

from __future__ import annotations

import numpy as np
import torch


def nm_index(n, m):
    return n * n + n + m


def ncoeffs(p):
    return (p + 1) * (p + 1)


def _harmonics(coords, p, kind):
    """Complex R (kind='regular') or S (kind='irregular'), numpy.

    :arg coords: (3, ...) float array.
    :returns: complex array of shape ``(...,) + (ncoeffs(p),)``.
    """
    x, y, z = coords[0], coords[1], coords[2]
    r2 = x * x + y * y + z * z
    u = x + 1j * y
    cdtype = np.result_type(x.dtype, np.complex64)
    vals = [None] * ncoeffs(p)

    if kind == "regular":
        rmm = np.ones(x.shape, dtype=cdtype)
        vals[0] = rmm
        for m in range(1, p + 1):
            rmm = u * rmm / (2 * m)
            vals[nm_index(m, m)] = rmm
        for m in range(p + 1):
            prev2, prev1 = None, vals[nm_index(m, m)]
            for n in range(m + 1, p + 1):
                if n == m + 1:
                    cur = z * prev1
                else:
                    cur = ((2 * n - 1) * z * prev1 - r2 * prev2) \
                        / ((n + m) * (n - m))
                vals[nm_index(n, m)] = cur
                prev2, prev1 = prev1, cur
    else:
        rinv2 = 1.0 / r2
        smm = np.sqrt(rinv2).astype(cdtype)
        vals[0] = smm
        for m in range(1, p + 1):
            smm = (2 * m - 1) * u * smm * rinv2
            vals[nm_index(m, m)] = smm
        for m in range(p + 1):
            prev2, prev1 = None, vals[nm_index(m, m)]
            for n in range(m + 1, p + 1):
                if n == m + 1:
                    cur = (2 * n - 1) * z * prev1 * rinv2
                else:
                    cur = ((2 * n - 1) * z * prev1
                           - ((n - 1) * (n - 1) - m * m) * prev2) * rinv2
                vals[nm_index(n, m)] = cur
                prev2, prev1 = prev1, cur

    for n in range(p + 1):
        for m in range(1, n + 1):
            vals[nm_index(n, -m)] = ((-1) ** m) * np.conj(
                vals[nm_index(n, m)])
    return np.stack(vals, axis=-1)


def regular(coords, p):
    """Regular solid harmonics R_n^m: complex numpy for numpy *coords*, a
    complex tensor for a tensor."""
    if isinstance(coords, torch.Tensor):
        return as_complex(_harmonics_pairs(coords, p, "regular"))
    return _harmonics(coords, p, "regular")


def irregular(coords, p):
    """Irregular solid harmonics S_n^m: complex numpy for numpy *coords*, a
    complex tensor for a tensor."""
    if isinstance(coords, torch.Tensor):
        return as_complex(_harmonics_pairs(coords, p, "irregular"))
    return _harmonics(coords, p, "irregular")


def _harmonics_pairs(coords, p, kind):
    """The recurrences of :func:`_harmonics` on torch tensors with
    explicit ``(re, im)`` pairs (``boxtree_tpu/ops/solid_harmonics.py:
    118-192``).

    :returns: real tensor of shape ``(...,) + (2 * ncoeffs(p),)`` laid out
        ``[Re | Im]``.
    """
    x, y, z = coords[0], coords[1], coords[2]
    r2 = x * x + y * y + z * z
    nc = ncoeffs(p)
    re = [None] * nc
    im = [None] * nc

    def umul(ar, ai):
        # (ar + i ai) * (x + i y)
        return ar * x - ai * y, ar * y + ai * x

    if kind == "regular":
        rr, ri = torch.ones_like(x), torch.zeros_like(x)
        re[0], im[0] = rr, ri
        for m in range(1, p + 1):
            rr, ri = umul(rr, ri)
            rr, ri = rr / (2 * m), ri / (2 * m)
            re[nm_index(m, m)], im[nm_index(m, m)] = rr, ri
        for m in range(p + 1):
            p2r = p2i = None
            p1r, p1i = re[nm_index(m, m)], im[nm_index(m, m)]
            for n in range(m + 1, p + 1):
                if n == m + 1:
                    cr, ci = z * p1r, z * p1i
                else:
                    den = (n + m) * (n - m)
                    cr = ((2 * n - 1) * z * p1r - r2 * p2r) / den
                    ci = ((2 * n - 1) * z * p1i - r2 * p2i) / den
                re[nm_index(n, m)], im[nm_index(n, m)] = cr, ci
                p2r, p2i, p1r, p1i = p1r, p1i, cr, ci
    else:
        rinv2 = 1.0 / r2
        sr, si = torch.sqrt(rinv2), torch.zeros_like(x)
        re[0], im[0] = sr, si
        for m in range(1, p + 1):
            sr, si = umul(sr, si)
            sr = (2 * m - 1) * sr * rinv2
            si = (2 * m - 1) * si * rinv2
            re[nm_index(m, m)], im[nm_index(m, m)] = sr, si
        for m in range(p + 1):
            p2r = p2i = None
            p1r, p1i = re[nm_index(m, m)], im[nm_index(m, m)]
            for n in range(m + 1, p + 1):
                if n == m + 1:
                    cr = (2 * n - 1) * z * p1r * rinv2
                    ci = (2 * n - 1) * z * p1i * rinv2
                else:
                    c2 = (n - 1) * (n - 1) - m * m
                    cr = ((2 * n - 1) * z * p1r - c2 * p2r) * rinv2
                    ci = ((2 * n - 1) * z * p1i - c2 * p2i) * rinv2
                re[nm_index(n, m)], im[nm_index(n, m)] = cr, ci
                p2r, p2i, p1r, p1i = p1r, p1i, cr, ci

    for n in range(p + 1):
        for m in range(1, n + 1):
            s = (-1.0) ** m
            re[nm_index(n, -m)] = s * re[nm_index(n, m)]
            im[nm_index(n, -m)] = -s * im[nm_index(n, m)]
    return torch.stack(re + im, dim=-1)


def regular_pairs(coords, p):
    """Regular solid harmonics as ``[re | im]`` real pairs (torch)."""
    return _harmonics_pairs(coords, p, "regular")


def irregular_pairs(coords, p):
    """Irregular solid harmonics as ``[re | im]`` real pairs (torch)."""
    return _harmonics_pairs(coords, p, "irregular")


def as_complex(pairs):
    """``[re | im]`` pairs along the last axis as a complex tensor."""
    k = pairs.shape[-1] // 2
    return torch.complex(pairs[..., :k], pairs[..., k:])


def pair_blocks(mr, mi):
    """``[[mr, -mi], [mi, mr]]``, the real (..., 2K, 2K) operator on ``[re |
    im]`` vectors of the complex operator ``mr + i mi`` (numpy or
    tensors)."""
    if isinstance(mr, torch.Tensor):
        return torch.cat([torch.cat([mr, -mi], dim=-1),
                          torch.cat([mi, mr], dim=-1)], dim=-2)
    top = np.concatenate([mr, -mi], axis=-1)
    bot = np.concatenate([mi, mr], axis=-1)
    return np.concatenate([top, bot], axis=-2)


def pair_matrix(mat):
    """Expand a complex (..., K, K) operator into the real (..., 2K, 2K)
    operator on ``[re | im]`` vectors: ``[[Re M, -Im M], [Im M, Re M]]``
    (numpy)."""
    return pair_blocks(np.real(mat), np.imag(mat))


def pair_tensor(mats, device):
    """:func:`pair_matrix` of a complex (..., K, K) operator stack (a tensor
    or numpy) as a tensor, built on *device*."""
    mats = torch.as_tensor(mats, device=device)
    return pair_blocks(mats.real, mats.imag)
