"""Host-side rscale-scaled Bessel values (numpy, scalar argument).

A copy of ``boxtree_tpu/ops/scaled_bessel_host.py`` (its cylindrical half,
``:38-100``, and its spherical half, ``:102-133``), which the Helmholtz
translation builders need as

    Jhat_q(x; s) = J_q(x) * s**-q,    Yhat_q(x; s) = Y_q(x) * s**+q

(cylindrical, 2D) and ``jhat_q``, ``yhat_q`` alike (spherical, 3D) for
q = 0..qmax with s ~ x (the per-level rscale).  Forming the factors
separately overflows float64 long before the products do (``Y_70(1e-4) ~
1e399``), so the scaling is folded into the recurrences:

- ``Yhat``: the upward recurrence becomes ``Yhat_{q+1} = (2q/x) s Yhat_q -
  s^2 Yhat_{q-1}`` (spherical: ``(2q+1)/x``).
- ``Jhat``: Miller's downward recurrence on the values (not the ratios, so
  interior zeros do no harm), renormalised when it grows past 1e250, then
  normalised by the Wronskian: ``J_1 Y_0 - J_0 Y_1 = 2/(pi x)``
  (cylindrical, well conditioned at zeros of ``J_0``, where a plain
  ``J_0`` anchor would divide by a near-zero) or ``j_1 y_0 - j_0 y_1 =
  1/x^2`` (spherical).
"""

from __future__ import annotations

import numpy as np

from boxtree_torch.ops.cylinder_bessel import miller_start


def _miller_values(x, qmax, coeff, s):
    """Unnormalised downward Miller values ``fhat_q ~ A f_q s**-q`` of the
    recurrence ``f_{q-1} = coeff(q) f_q - f_{q+1}``, q = 0..qmax."""
    nstart = miller_start(qmax, abs(x)) + 8
    out = np.zeros(max(qmax, 1) + 1)
    f_hi = 0.0                       # fhat_{q+1}
    f = 1e-250                       # fhat_q at q = nstart
    if nstart <= qmax:
        out[nstart] = f
    for q in range(nstart, 0, -1):
        f_lo = coeff(q) * s * f - (s * s) * f_hi
        f_hi, f = f, f_lo
        if abs(f) > 1e250:
            f *= 1e-250
            f_hi *= 1e-250
            out *= 1e-250
        if q - 1 <= out.shape[0] - 1:
            out[q - 1] = f
    return out


def jv_scaled(x, qmax, s):
    """``J_q(x) * s**-q`` for q = 0..qmax (scalar x > 0, s > 0),
    normalised by the Wronskian ``J_1 Y_0 - J_0 Y_1 = 2/(pi x)``."""
    from scipy import special as sp
    x = float(x)
    f = _miller_values(x, qmax, lambda q: 2.0 * q / x, s)
    w = f[1] * s * sp.yv(0, x) - f[0] * sp.yv(1, x)
    alpha = (2.0 / (np.pi * x)) / w
    return f[:qmax + 1] * alpha


def yv_scaled(x, qmax, s):
    """``Y_q(x) * s**+q`` for q = 0..qmax."""
    from scipy import special as sp
    x = float(x)
    out = np.empty(qmax + 1)
    out[0] = sp.yv(0, x)
    if qmax >= 1:
        out[1] = sp.yv(1, x) * s
        for q in range(1, qmax):
            out[q + 1] = (2.0 * q / x) * s * out[q] - s * s * out[q - 1]
    return out


def hankel1_scaled(x, qmax, s):
    """``H^(1)_q(x) * s**+q``: the J part underflows harmlessly against the
    dominant scaled Y part."""
    jpart = jv_scaled(x, qmax, 1.0) * np.power(
        float(s), np.arange(qmax + 1, dtype=np.float64))
    return jpart + 1j * yv_scaled(x, qmax, s)


def spherical_jn_scaled(x, qmax, s):
    """``j_q(x) * s**-q`` for q = 0..qmax (scalar x > 0, s > 0)."""
    x = float(x)
    f = _miller_values(x, qmax, lambda q: (2.0 * q + 1.0) / x, s)
    y0 = -np.cos(x) / x
    y1 = -np.cos(x) / x ** 2 - np.sin(x) / x
    w = f[1] * s * y0 - f[0] * y1
    alpha = (1.0 / x ** 2) / w
    return f[:qmax + 1] * alpha


def spherical_yn_scaled(x, qmax, s):
    """``y_q(x) * s**+q`` for q = 0..qmax."""
    x = float(x)
    out = np.empty(qmax + 1)
    out[0] = -np.cos(x) / x
    if qmax >= 1:
        out[1] = (-np.cos(x) / x ** 2 - np.sin(x) / x) * s
        for q in range(1, qmax):
            out[q + 1] = ((2.0 * q + 1.0) / x) * s * out[q] \
                - s * s * out[q - 1]
    return out


def spherical_hn1_scaled(x, qmax, s):
    """``h^(1)_q(x) * s**+q``: the j part underflows harmlessly against the
    dominant scaled y part."""
    jpart = spherical_jn_scaled(x, qmax, 1.0) * np.power(
        float(s), np.arange(qmax + 1, dtype=np.float64))
    return jpart + 1j * spherical_yn_scaled(x, qmax, s)
