"""Cylindrical Bessel functions J_n, Y_n on tensors.

Port of ``boxtree_tpu/ops/cylinder_bessel.py:38-110`` with the same steps,
branch points and order of operations; ``csrc/cyl_bessel.cuh`` runs them
again in the 2D Helmholtz kernels, so the plain twins and the kernels agree
to rounding:

- ``J_n``: Miller's downward recurrence in ratio form, ``r_n = J_n /
  J_{n-1} = 1 / (2n/x - r_{n+1})`` from an even ``nstart`` (denominators
  below ``1e-300`` in magnitude set to ``+-1e-300``), then the products
  ``P_n = J_n / J_0 = r_1 ... r_n``, normalised by the Neumann identity
  ``J_0 + 2 sum_k J_{2k} = 1``.  Below ``|x| < 1e-8`` the leading series
  term ``(x/2)^n / n!``.
- ``Y_0``, ``Y_1``: the log series in the ``P_n`` (Abramowitz & Stegun
  9.1.88/89), ``Y_0 = (2/pi)[(ln(x/2) + g) J_0 + 2 sum_k (-1)^{k+1}
  J_{2k}/k]`` and ``Y_1 = (2/pi)[(ln(x/2) + g) J_1 - J_0/x - sum_k
  (-1)^{k+1} (J_{2k-1} - J_{2k+1})/k]``; then the upward recurrence
  ``Y_{n+1} = (2n/x) Y_n - Y_{n-1}``.  ``Y`` is not valid where ``x <= 0``
  (callers mask).  Below ``|x| < 1e-8`` the recurrence starts from the
  leading small-argument terms, ``Y_0 = (2/pi)(ln(x/2) + g) J_0`` with
  ``J_0 = 1`` and ``Y_1 = -2/(pi x)``, exact to double precision there.
  The reference evaluates ``Y`` at ``x = 1`` below that switch
  (``boxtree_tpu/ops/cylinder_bessel.py:54-55``), so the two part there;
  the port's tests against it leave that region out.

Under ``torch.func.jvp`` the tangent of ``F_n = J_n, Y_n``
is the reference's (``boxtree_tpu/models/helmholtz.py:58-111``,
``_device_JH`` / ``_device_JY``): ``dF_n/dx = (F_{n-1} - F_{n+1}) / 2``
with ``F_{-1} = -F_1``, the functions evaluated one order up from the same
*nstart*, not the derivative of the recurrence's steps.  The values are
those of the recurrence bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

_EULER_GAMMA = 0.5772156649015328606
#: below this |x| J_n is its leading series term
JN_SMALL_X = 1e-8
#: the smallest |denominator| of the ratio recurrence
DENOM_FLOOR = 1e-300


def miller_start(p, xmax):
    """Downward-recurrence start order for ``J_n`` accurate to ~1e-15 at
    ``n <= p``, ``x <= xmax`` (Numerical Recipes' rule of thumb:
    ``sqrt(40 n)`` above the larger of order and argument)."""
    n_eff = max(int(p), int(np.ceil(xmax)), 1)
    return n_eff + int(np.sqrt(40.0 * n_eff)) + 12


def even_start(nstart, p):
    """The start order the recurrence runs from: at least ``p + 2`` and 3,
    rounded up to even (which pairs up the Neumann sums)."""
    nstart = max(int(nstart), p + 2, 3)
    return nstart + (nstart % 2)


def cylindrical_jy(x, p, *, nstart):
    """``J_n(x)`` and ``Y_n(x)`` for ``n = 0..p``: two tensors of shape
    ``x.shape + (p+1,)``.  *nstart* is the start order of the downward
    recurrence (:func:`miller_start` of an upper bound on ``|x|``); the
    tangent in *x* is the order-up identity of the module doc."""
    return _CylindricalJY.apply(x, p, nstart)


def _order_up_derivative(f, p):
    """``(F_{n-1} - F_{n+1}) / 2`` for n = 0..p from ``F_0..F_{p+1}``, with
    ``F_{-1} = -F_1`` (``helmholtz.py:78-82``)."""
    lower = torch.cat([-f[..., 1:2], f[..., :p]], dim=-1)
    return 0.5 * (lower - f[..., 1:p + 2])


class _CylindricalJY(torch.autograd.Function):
    """:func:`cylindrical_jy` with the reference's tangent (forward mode
    only: nothing takes a reverse-mode gradient of it)."""

    @staticmethod
    def forward(x, p, nstart):
        return _jy_recurrence(x, p, nstart)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.p, ctx.nstart = inputs
        ctx.save_for_forward(x)

    @staticmethod
    def jvp(ctx, x_dot, _p, _nstart):
        x, = ctx.saved_tensors
        j, y = _jy_recurrence(x, ctx.p + 1, ctx.nstart)
        return (_order_up_derivative(j, ctx.p) * x_dot[..., None],
                _order_up_derivative(y, ctx.p) * x_dot[..., None])


def _jy_recurrence(x, p, nstart):
    """The recurrences of :func:`cylindrical_jy`."""
    small = x.abs() < JN_SMALL_X
    xs = torch.where(small, torch.ones_like(x), x)
    xinv = 1.0 / xs
    nstart = even_start(nstart, p)

    # downward ratio recurrence r_n = J_n / J_{n-1}
    r = xs / (2.0 * (nstart + 1))          # asymptotic seed r_{nstart+1}
    ratios = [None] * (nstart + 1)
    for n in range(nstart, 0, -1):
        denom = 2.0 * n * xinv - r
        fl = torch.full_like(denom, DENOM_FLOOR)
        floor = torch.where(denom < 0, -fl, fl)
        denom = torch.where(denom.abs() < DENOM_FLOOR, floor, denom)
        r = 1.0 / denom
        ratios[n] = r

    # P_n = J_n / J_0, and the Neumann and Y log-series sums relative to
    # J_0, in the reference's order
    prods = [torch.ones_like(xs)]
    for n in range(1, nstart + 1):
        prods.append(prods[n - 1] * ratios[n])
    s_norm = torch.ones_like(xs)
    s_y0 = torch.zeros_like(xs)
    s_y1 = torch.zeros_like(xs)
    for k in range(1, nstart // 2 + 1):
        sign = 1.0 if k % 2 == 1 else -1.0
        s_norm = s_norm + 2.0 * prods[2 * k]
        s_y0 = s_y0 + (sign / k) * prods[2 * k]
        if 2 * k + 1 <= nstart:
            s_y1 = s_y1 + (sign / k) * (prods[2 * k - 1]
                                        - prods[2 * k + 1])

    j0 = 1.0 / s_norm
    j = torch.stack([prods[n] * j0 for n in range(p + 1)], dim=-1)
    fact = np.cumprod(np.concatenate([[1.0], np.arange(1.0, p + 1)]))
    series = torch.stack([(x * 0.5) ** n / fact[n] for n in range(p + 1)],
                         dim=-1)
    j = torch.where(small[..., None], series, j)

    logterm = torch.log(0.5 * xs) + _EULER_GAMMA
    c = 2.0 / np.pi
    # below the switch: the leading terms, J_0 = 1, and the true 1/x
    yvals = [torch.where(small, c * (torch.log(0.5 * x) + _EULER_GAMMA),
                         c * (logterm + 2.0 * s_y0) * j0)]
    if p >= 1:
        yvals.append(torch.where(small, -c / x,
                                 c * (logterm * prods[1] - xinv - s_y1) * j0))
        xinv = torch.where(small, 1.0 / x, xinv)
        for n in range(1, p):
            yvals.append(2.0 * n * xinv * yvals[n] - yvals[n - 1])
    return j, torch.stack(yvals, dim=-1)
