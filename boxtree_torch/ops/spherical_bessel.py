"""Spherical Bessel functions j_n, y_n and the Hankel h^(1)_n on tensors.

Port of ``boxtree_tpu/ops/spherical_bessel.py:29-78`` with the same
recurrences, branch points and order of operations; ``csrc/bessel.cuh``
runs them again in the kernels, so the plain twins and the kernels agree
to rounding:

- ``j_n``: downward ratio recurrence ``r_n = j_n / j_{n-1} = 1 / ((2n+1)/x
  - r_{n+1})`` from ``nstart = p + 25`` (denominators below ``1e-300``
  clamped to ``1e-300``), then ``j_n = j_0 r_1 ... r_n`` with ``j_0 =
  sin(x)/x``; below ``|x| < 1e-6`` the leading series term
  ``x^n / (2n+1)!!``.  Under ``torch.func.jvp`` the tangent of ``j_0`` is
  ``-j_1 = -j_0 r_1``, not the reference's (that of ``sin(x)/x``, which
  cancels at small ``x``): ``csrc/bessel.cuh`` takes the same.
- ``y_n``: upward recurrence ``y_{n+1} = (2n+1)/x y_n - y_{n-1}`` (stable:
  y grows with n); not valid at ``x = 0``, which callers guard.
"""

from __future__ import annotations

import numpy as np
import torch

#: how far above the highest wanted order the j_n recurrence starts
JN_EXTRA = 25
#: below this |x| j_n is its leading series term
JN_SMALL_X = 1e-6
#: the smallest |denominator| of the j_n ratio recurrence
JN_DENOM_FLOOR = 1e-300


def double_factorial(n):
    return float(np.prod(np.arange(n, 0, -2), dtype=np.float64)) or 1.0


def spherical_jn(x, p, *, extra=JN_EXTRA):
    """j_n(x) for n = 0..p; shape ``x.shape + (p+1,)``."""
    small = x.abs() < JN_SMALL_X
    xs = torch.where(small, torch.ones_like(x), x)
    xinv = 1.0 / xs

    nstart = p + extra
    r = xs / (2 * nstart + 3)              # asymptotic seed r_{nstart+1}
    ratios = [None] * (p + 1)
    for n in range(nstart, 0, -1):
        denom = (2 * n + 1) * xinv - r
        denom = torch.where(denom.abs() < JN_DENOM_FLOOR,
                            torch.full_like(denom, JN_DENOM_FLOOR), denom)
        r = 1.0 / denom
        if n <= p:
            ratios[n] = r

    # j_0's tangent (under torch.func.jvp) is -j_1 = -j_0 r_1 (r holds
    # r_1 here), not that of the quotient, cos x / x - sin x / x^2, which
    # cancels to eps / x^2 of itself; the value is sin(x) / x unchanged
    j0 = torch.sin(xs) * xinv
    vals = [j0.detach() - (j0 * r).detach() * (xs - xs.detach())]
    for n in range(1, p + 1):
        vals.append(vals[n - 1] * ratios[n])
    out = torch.stack(vals, dim=-1)

    series = torch.stack([(x ** n) / double_factorial(2 * n + 1)
                          for n in range(p + 1)], dim=-1)
    return torch.where(small[..., None], series, out)


def spherical_yn(x, p):
    """y_n(x) for n = 0..p (upward recurrence); shape ``x.shape + (p+1,)``.
    Not valid at ``x == 0``."""
    xs = torch.where(x == 0, torch.ones_like(x), x)
    xinv = 1.0 / xs
    vals = [-torch.cos(xs) * xinv]
    if p >= 1:
        vals.append((-torch.cos(xs) * xinv - torch.sin(xs)) * xinv)
        for n in range(1, p):
            vals.append((2 * n + 1) * xinv * vals[n] - vals[n - 1])
    return torch.stack(vals, dim=-1)


def spherical_hn1(x, p):
    """h^(1)_n(x) = j_n(x) + i y_n(x) for n = 0..p (complex)."""
    return torch.complex(spherical_jn(x, p), spherical_yn(x, p))
