"""The particle stages of the 3D Helmholtz FMM: P2M, P2P (List 1), M2P
(List 3), P2L (List 4) and L2P, each as a kernel wrapper and its plain
twin, on two layouts (coordinates float64):

- complex128: complex charges, ``(nboxes, (p+1)^2)`` complex coefficients
  and complex potentials (the complex wrangler);
- float64 pairs: real charges, ``(nboxes, 2 (p+1)^2)`` ``[re | im]``
  coefficient rows and ``(n, 2)`` ``[re, im]`` potentials (the real-pair
  wrangler, ``boxtree_tpu/models/helmholtz3d.py:373-521``).  Its twins
  work on real lanes only (``*_pairs``, the reference's pair hooks); its
  kernels are the ``_f64`` entry points of the same kernels.

The layout follows the dtype of the charges or the expansions handed in.

Kernel ``G(t, s) = exp(ik|t - s|) / |t - s|`` for a real wavenumber k; the
basis is that of :mod:`boxtree_torch.models.helmholtz3d`: ``h_n(k r)
A_n^m(u)`` with ``A_n^m`` the regular solid harmonics on the unit sphere.
Each wrapper takes the tree's particle arrays in tree order, the per-box
particle ranges ``[box_*_starts, + box_*_counts_nonchild)`` and either a
CSR list whose rows name boxes (the list stages) or the rows alone, the
boxes that own particles (P2M, L2P).  On CPU tensors it runs the plain
PyTorch twin; on CUDA tensors it launches the hand-written kernel of
``csrc/helmholtz3d.cu`` or raises.

- P2M (K31, pairs K50): ``M_nm(b) = sum q_s w_nm j_n(k r) s^-n
  conj(A_n^m(u))`` over the sources box ``b`` owns, ``q w_00`` at ``n =
  0`` alone for ``r = 0`` (``helmholtz3d.py:316-328``; pairs ``:442``,
  the term in the imaginary lane).
- L2P (K32, pairs K51): ``phi(t) = sum L_nm(b) j_n(k r) s^-n
  A_n^m(u)``, ``L_00(b)`` at ``r = 0`` (``helmholtz3d.py:330-339``;
  pairs ``:461``, ``(loc[0], loc[K])``).
- P2P (K9, pairs K47): ``phi(t) = sum q_s exp(ik r)/r``, ``r = 0``
  skipped (``boxtree_tpu/models/helmholtz3d.py:362-368``; pairs ``:513``).
- M2P (K10, pairs K48): ``phi(t) += sum M_nm(b) h_n(k r) s^n A_n^m(u)``
  with ``r u = ((t - c_b) / s) s``, 0 at ``r = 0``
  (``helmholtz3d.py:341-349``; pairs ``:478``).
- P2L (K11, pairs K49): ``L_nm(b) += sum q_s w_nm h_n(k r) s^n
  conj(A_n^m(u))`` with ``r u = ((x_s - c_b) / s) s``
  (``helmholtz3d.py:351-360``; pairs ``:494``).

``s`` is the box's rscale (the source box's for M2P, the target box's for
P2L, the particle's own box's for P2M and L2P); the hooks of the reference
receive ``rel`` divided by it and work on ``rel * s``, which the twins and
the kernels repeat.  ``w_nm = 4 pi i k D_nm^2``; the pair layout takes
its real ``w_c = 4 pi k D_nm^2`` (``w_nm = i w_c``).

Dipole sources (a ``(3, nsources)`` tree-order ``dipole_vec`` *d*, the
potential ``q (d . grad_y) G(x, y)``): P2M, P2P and P2L each have a dipole
form, the JVP of the charge form in the source positions along *d*
(``boxtree_tpu/models/expansion_base.py:664-673``, ``:1314-1324``,
``:1688-1694``), whose twin is ``torch.func.jvp`` of the charge twin's
terms and whose kernel is the charge kernel on dual numbers (K57-K59,
pairs K60-K62).  P2M and P2L hand the terms the offset's tangent ``d /
s``, as the reference does.  At ``r = 0`` the dipole P2M takes the limit
of the tangent, ``(k / 3) q w_1m conj(R_1^m(d)) s^-1`` at ``n = 1``, where
the reference's guard gives 0 (it drops the dipole moment of a source on
its box's centre); the dipole P2L gives 0 there, as the reference.  The
tangent of ``j_0`` is ``-j_1`` (``spherical_bessel.spherical_jn``), not
the reference's quotient rule, which cancels at small ``k r``.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels
from boxtree_torch.ops import solid_harmonics as sh
from boxtree_torch.ops import spherical_bessel as sb
from boxtree_torch.ops.laplace3d import (
    _blocks,
    _edges,
    _max_count,
    _row_chunks,
    _row_particles,
)

#: element budget of one chunk's largest temporary in the plain twins
_PLAIN_CHUNK_ELEMS = 1 << 23
#: the kernels' threads per CTA (one warp), as in csrc/helmholtz3d.cu
_KERNEL_THREADS = 32


# {{{ the basis and the per-particle terms of each stage

def angular(rel, order):
    """``(r, ok, A)`` of (3, ...) offsets: the length, ``r > 0``, and the
    regular harmonics of the unit direction, complex ``(..., (p+1)^2)``;
    ``r = 0`` takes the direction (0, 0, 1) (``helmholtz3d.py:285-293``)."""
    r, ok, ar, ai = angular_pairs(rel, order)
    return r, ok, torch.complex(ar, ai)


def nm_orders(order, device):
    """(n of each coefficient) as an int64 tensor."""
    n = torch.arange(order + 1, device=device)
    return torch.repeat_interleave(n, 2 * n + 1)


def radial_j(r, k, order):
    """``j_n(k r)`` over the coefficient axis, ``(..., (p+1)^2)``."""
    return sb.spherical_jn(k * r, order)[..., nm_orders(order, r.device)]


def radial_h(r, k, order):
    """``h^(1)_n(k r)`` over the coefficient axis (complex)."""
    return sb.spherical_hn1(k * r, order)[..., nm_orders(order, r.device)]


def dpow(scale, sign, order):
    """``scale^(sign n)`` over the coefficient axis."""
    n = nm_orders(order, scale.device).to(scale.dtype)
    return scale[..., None] ** (sign * n)


def p2m_terms(rel, q, scale, w_nm, k, order):
    """Multipole coefficients of charges *q* at offsets *rel* pre-divided
    by *scale*; ``q w_00`` at ``n = 0`` alone where ``r = 0``, the exact
    limit (``helmholtz3d.py:316-328``)."""
    pw = dpow(scale, -1, order)
    r, ok, a = angular(rel * scale, order)
    basis = radial_j(r, k, order) * torch.conj(a) * pw
    qw = q[..., None] * w_nm
    zero_lim = torch.zeros_like(qw)
    zero_lim[..., 0] = qw[..., 0]
    return torch.where(ok[..., None], qw * basis, zero_lim)


def l2p_eval(rel, loc, scale, k, order):
    """Potentials of locals *loc* at offsets *rel* pre-divided by *scale*;
    ``loc[..., 0]`` where ``r = 0`` (``helmholtz3d.py:330-339``)."""
    pw = dpow(scale, -1, order)
    r, ok, a = angular(rel * scale, order)
    basis = radial_j(r, k, order) * a * pw
    return torch.where(ok, (loc * basis).sum(-1), loc[..., 0])


def m2p_eval(rel, mp, scale, k, order):
    """Potentials of multipoles *mp* at offsets *rel* pre-divided by
    *scale* (``helmholtz3d.py:341-349``)."""
    pw = dpow(scale, +1, order)
    r, ok, a = angular(rel * scale, order)
    basis = radial_h(r, k, order) * a * pw
    return torch.where(ok, (mp * basis).sum(-1), 0)


def p2l_terms(rel, q, scale, w_nm, k, order):
    """Local coefficients of charges *q* at offsets *rel* pre-divided by
    *scale* (``helmholtz3d.py:351-360``)."""
    pw = dpow(scale, +1, order)
    r, ok, a = angular(rel * scale, order)
    basis = radial_h(r, k, order) * torch.conj(a) * pw
    terms = q[..., None] * w_nm * basis
    return torch.where(ok[..., None], terms, 0)

# }}}


# {{{ the same on real pair lanes (helmholtz3d.py:432-521)

def angular_pairs(rel, order):
    """``(r, ok, A_re, A_im)``: :func:`angular` with the harmonics as two
    real ``(..., (p+1)^2)`` lanes (``helmholtz3d.py:432-440``); ``r = 0``
    takes the direction (0, 0, 1)."""
    r2 = (rel * rel).sum(0)
    ok = r2 > 0
    r = torch.sqrt(torch.where(ok, r2, torch.ones_like(r2)))
    up = torch.tensor([0.0, 0.0, 1.0], dtype=rel.dtype, device=rel.device)
    u = torch.where(ok, rel, up.reshape((3,) + (1,) * (rel.ndim - 1))) / r
    a = sh.regular_pairs(u, order)
    k = sh.ncoeffs(order)
    return r, ok, a[..., :k], a[..., k:]


def radial_y(r, k, order):
    """``y_n(k r)`` over the coefficient axis (``helmholtz3d.py:509``)."""
    return sb.spherical_yn(k * r, order)[..., nm_orders(order, r.device)]


def p2m_terms_pairs(rel, q, scale, w_c, k, order):
    """``[re | im]`` multipole coefficients of real charges *q*: ``q i w_c
    j_n conj(A)`` as ``(-q w_c b_i, q w_c b_r)``, and at ``r = 0`` ``q
    w_c`` in the imaginary lane of coefficient 0 alone
    (``helmholtz3d.py:442-459``)."""
    pw = dpow(scale, -1, order)
    r, ok, ar, ai = angular_pairs(rel * scale, order)
    j = radial_j(r, k, order)
    br, bi = j * ar * pw, -j * ai * pw
    qc = q[..., None] * w_c
    lim = torch.zeros_like(qc)
    lim[..., 0] = qc[..., 0]
    okc = ok[..., None]
    return torch.cat([torch.where(okc, -qc * bi, 0),
                      torch.where(okc, qc * br, lim)], dim=-1)


def l2p_eval_pairs(rel, loc, scale, k, order):
    """``(..., 2)`` potentials of ``[re | im]`` locals *loc*; ``(loc[0],
    loc[K])`` where ``r = 0`` (``helmholtz3d.py:461-476``)."""
    pw = dpow(scale, -1, order)
    r, ok, ar, ai = angular_pairs(rel * scale, order)
    j = radial_j(r, k, order)
    br, bi = j * ar * pw, j * ai * pw
    kc = sh.ncoeffs(order)
    lr, li = loc[..., :kc], loc[..., kc:]
    v_re = torch.where(ok, (lr * br - li * bi).sum(-1), lr[..., 0])
    v_im = torch.where(ok, (lr * bi + li * br).sum(-1), li[..., 0])
    return torch.stack([v_re, v_im], dim=-1)


def m2p_eval_pairs(rel, mp, scale, k, order):
    """``(..., 2)`` potentials of ``[re | im]`` multipoles *mp*, with ``h
    A = (j a_r - y a_i, j a_i + y a_r)``; 0 at ``r = 0``
    (``helmholtz3d.py:478-492``)."""
    pw = dpow(scale, +1, order)
    r, ok, ar, ai = angular_pairs(rel * scale, order)
    j, y = radial_j(r, k, order), radial_y(r, k, order)
    br, bi = (j * ar - y * ai) * pw, (j * ai + y * ar) * pw
    kc = sh.ncoeffs(order)
    mr, mi = mp[..., :kc], mp[..., kc:]
    return torch.stack([torch.where(ok, (mr * br - mi * bi).sum(-1), 0),
                        torch.where(ok, (mr * bi + mi * br).sum(-1), 0)],
                       dim=-1)


def p2l_terms_pairs(rel, q, scale, w_c, k, order):
    """``[re | im]`` local coefficients of real charges *q*, with ``h
    conj(A) = (j a_r + y a_i, y a_r - j a_i)``; 0 at ``r = 0``
    (``helmholtz3d.py:494-507``)."""
    pw = dpow(scale, +1, order)
    r, ok, ar, ai = angular_pairs(rel * scale, order)
    j, y = radial_j(r, k, order), radial_y(r, k, order)
    br, bi = (j * ar + y * ai) * pw, (y * ar - j * ai) * pw
    qc = q[..., None] * w_c
    okc = ok[..., None]
    return torch.cat([torch.where(okc, -qc * bi, 0),
                      torch.where(okc, qc * br, 0)], dim=-1)

# }}}


# {{{ the dipole terms: JVPs of the terms in the offsets

def _p2m_limit(rel, dip, scale, k):
    """``(ok, lim)``: ``r > 0`` at offsets *rel* pre-divided by *scale*,
    and where ``r = 0`` the limit of the tangent of ``j_n(k r) conj(A_n^m)
    s^-n`` along the offset tangent *dip* (pre-divided too) as ``r -> 0``:
    ``(k / 3) conj(R_1^m(dip s)) s^-1`` for ``m = -1, 0, 1``, complex
    ``(..., 3)``, since ``j_1(k r) A_1^m(u) = (k r / 3) R_1^m(u) + O(r^3)
    = (k / 3) R_1^m(x) + O(r^3)`` and the other orders' tangents vanish."""
    ok = ((rel * scale) ** 2).sum(0) > 0
    r1 = sh.regular(dip * scale, 1)[..., 1:4]
    return ok, (k / 3) * r1.conj() / scale[..., None]


def p2m_dipole_terms(rel, dip, q, scale, w_nm, k, order):
    """Multipole terms of dipole sources: the JVP of :func:`p2m_terms` in
    *rel* along *dip* (both pre-divided by *scale*), and at ``r = 0`` the
    limit of that tangent (:func:`_p2m_limit`), where the reference's
    guard gives 0."""
    t = torch.func.jvp(lambda r: p2m_terms(r, q, scale, w_nm, k, order),
                       (rel,), (dip,))[1]
    if order >= 1:
        ok, lim = _p2m_limit(rel, dip, scale, k)
        t[..., 1:4] = torch.where(ok[..., None], t[..., 1:4],
                                  q[..., None] * w_nm[1:4] * lim)
    return t


def p2m_dipole_terms_pairs(rel, dip, q, scale, w_c, k, order):
    """:func:`p2m_dipole_terms` on pair lanes: the JVP of
    :func:`p2m_terms_pairs`, the limit at ``r = 0`` as ``q i w_c lim``."""
    t = torch.func.jvp(
        lambda r: p2m_terms_pairs(r, q, scale, w_c, k, order), (rel,),
        (dip,))[1]
    if order < 1:
        return t
    ok, lim = _p2m_limit(rel, dip, scale, k)
    qc = q[..., None] * w_c[1:4]
    kc = sh.ncoeffs(order)
    okc = ok[..., None]
    t[..., 1:4] = torch.where(okc, t[..., 1:4], -qc * lim.imag)
    t[..., kc + 1:kc + 4] = torch.where(okc, t[..., kc + 1:kc + 4],
                                        qc * lim.real)
    return t


def p2l_dipole_terms(rel, dip, q, scale, w_nm, k, order):
    """Local terms of dipole sources: the JVP of :func:`p2l_terms` in
    *rel* along *dip* (both pre-divided by *scale*); 0 at ``r = 0``."""
    return torch.func.jvp(lambda r: p2l_terms(r, q, scale, w_nm, k, order),
                          (rel,), (dip,))[1]


def p2l_dipole_terms_pairs(rel, dip, q, scale, w_c, k, order):
    """:func:`p2l_dipole_terms` on pair lanes (:func:`p2l_terms_pairs`)."""
    return torch.func.jvp(
        lambda r: p2l_terms_pairs(r, q, scale, w_c, k, order), (rel,),
        (dip,))[1]

# }}}


# {{{ the two layouts

def _is_pairs(dtype):
    """Whether *dtype* is the pair layout (float64) rather than the complex
    one (complex128)."""
    return dtype == torch.float64


def _width(order, dtype):
    """Values of *dtype* in one coefficient row."""
    return sh.ncoeffs(order) * (2 if _is_pairs(dtype) else 1)


def _pot_zeros(n, dtype, device):
    """Zero potentials of *n* targets: ``(n, 2)`` float64 for the pairs,
    ``(n,)`` complex128 otherwise."""
    if _is_pairs(dtype):
        return torch.zeros((n, 2), dtype=torch.float64, device=device)
    return torch.zeros(n, dtype=torch.complex128, device=device)

# }}}


def _check_args(k, order, dtype, smem=None, smem_max=48 * 1024):
    """The kernels' dtypes and wavenumber, and their shared memory a CTA:
    *smem* bytes (default: K10 / K11's row and ``h_n s^n`` column a lane,
    the most of K9-K11, K31, K32) against *smem_max*."""
    if dtype not in (torch.float64, torch.complex128):
        raise TypeError("the Helmholtz kernels take complex128 or float64 "
                        f"pairs, not {dtype}")
    if not isinstance(k, float):
        raise TypeError("the Helmholtz kernels take a real wavenumber")
    if smem is None:
        smem = (sh.ncoeffs(order) + (order + 1) * _KERNEL_THREADS) * 16 + 32
    if smem > smem_max:
        raise ValueError(f"order {order} needs {smem} bytes of shared "
                         f"memory per CTA; the kernels take up to "
                         f"{smem_max // 1024} KiB")


def _check_dipole_args(k, order, dtype, stage):
    """:func:`_check_args` for the dipole P2M (*stage* ``"p2m"``, K57 /
    K60) or P2L (``"p2l"``, K59 / K62), whose CTA holds the box's row and
    a dual ``j_n`` (16 bytes) or dual complex ``h_n s^n`` (32 bytes)
    column a lane, as ``csrc/helmholtz3d.cu`` sizes it, in up to 227
    KiB."""
    per_value = {"p2m": 16, "p2l": 32}[stage]
    smem = (sh.ncoeffs(order) * 16
            + (order + 1) * _KERNEL_THREADS * per_value)
    _check_args(k, order, dtype, smem, kernels.SMEM_MAX)


# {{{ P2P

def p2p_helmholtz3d_plain(targets, sources, charges, box_target_starts,
                          box_target_counts_nonchild, box_source_starts,
                          box_source_counts_nonchild, target_boxes, starts,
                          lists, k):
    """Plain twin of :func:`p2p_helmholtz3d`."""
    out = _pot_zeros(targets.shape[1], charges.dtype, charges.device)
    tbox, sbox = _edges(starts, lists, target_boxes)
    if tbox.numel() == 0:
        return out
    pt = _max_count(box_target_counts_nonchild, tbox)
    ps = _max_count(box_source_counts_nonchild, sbox)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (pt * ps))
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb_ = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        tidx, tmask = _blocks(box_target_starts, box_target_counts_nonchild,
                              tb, pt)
        sidx, smask = _blocks(box_source_starts, box_source_counts_nonchild,
                              sb_, ps)
        q = torch.where(smask, charges[sidx], 0)
        diff = targets[:, tidx][..., :, None] - sources[:, sidx][..., None, :]
        r2 = (diff * diff).sum(0)                       # (E, pt, ps)
        ok = r2 > 0
        r = torch.sqrt(torch.where(ok, r2, torch.ones_like(r2)))
        kr = k * r
        if _is_pairs(charges.dtype):
            inv = torch.where(ok, 1.0 / r, 0)
            vals = torch.stack([((torch.cos(kr) * inv) * q[:, None, :])
                                .sum(-1), ((torch.sin(kr) * inv)
                                           * q[:, None, :]).sum(-1)], -1)
        else:
            g = torch.where(
                ok, torch.complex(torch.cos(kr), torch.sin(kr)) / r, 0)
            vals = (g * q[:, None, :]).sum(-1)           # (E, pt)
        out.index_add_(0, tidx[tmask], vals[tmask])
    return out


def p2p_helmholtz3d(targets, sources, charges, box_target_starts,
                    box_target_counts_nonchild, box_source_starts,
                    box_source_counts_nonchild, target_boxes, starts, lists,
                    k):
    """List-1 potentials (tree-order targets) of ``exp(ik|t - s|)/|t -
    s|``: complex128 for complex128 charges, ``(n, 2)`` float64 for real
    float64 charges.  The K9 kernel (pairs: K47) on CUDA tensors."""
    args = (targets, sources, charges, box_target_starts,
            box_target_counts_nonchild, box_source_starts,
            box_source_counts_nonchild, target_boxes, starts, lists)
    if targets.device.type == "cpu":
        return p2p_helmholtz3d_plain(*args, k)
    dt = charges.dtype
    _check_args(k, 0, dt)
    kernels.check_tensors(targets, sources, dtype=torch.float64)
    kernels.check_tensors(charges, dtype=dt)
    kernels.check_tensors(*args[3:], dtype=torch.int32)
    out = _pot_zeros(targets.shape[1], dt, targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2p_helmholtz3d", dt, targets, targets.shape[1],
        sources, sources.shape[1], charges, box_target_starts,
        box_target_counts_nonchild, box_source_starts,
        box_source_counts_nonchild, target_boxes, target_boxes.shape[0],
        starts, lists, k, out)
    return out


def p2p_helmholtz3d_dipole_plain(targets, sources, charges, dipole_vec,
                                 *args):
    """Plain twin of :func:`p2p_helmholtz3d_dipole`: the JVP of
    :func:`p2p_helmholtz3d_plain` in the source positions along
    *dipole_vec*."""
    return torch.func.jvp(
        lambda s: p2p_helmholtz3d_plain(targets, s, charges, *args),
        (sources,), (dipole_vec,))[1]


def p2p_helmholtz3d_dipole(targets, sources, charges, dipole_vec,
                           box_target_starts, box_target_counts_nonchild,
                           box_source_starts, box_source_counts_nonchild,
                           target_boxes, starts, lists, k):
    """List-1 potentials of dipole sources, ``sum q_s (d_s . grad_s)
    exp(ik|t - s|) / |t - s|`` (*dipole_vec* ``(3, nsources)`` in tree
    order), in :func:`p2p_helmholtz3d`'s layouts.  The K58 kernel (pairs:
    K61) on CUDA tensors."""
    args = (box_target_starts, box_target_counts_nonchild,
            box_source_starts, box_source_counts_nonchild, target_boxes,
            starts, lists)
    if targets.device.type == "cpu":
        return p2p_helmholtz3d_dipole_plain(targets, sources, charges,
                                            dipole_vec, *args, k)
    dt = charges.dtype
    _check_args(k, 0, dt)
    kernels.check_tensors(targets, sources, dipole_vec, dtype=torch.float64)
    kernels.check_tensors(charges, dtype=dt)
    kernels.check_tensors(*args, dtype=torch.int32)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    out = _pot_zeros(targets.shape[1], dt, targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2p_helmholtz3d_dipole", dt, targets, targets.shape[1], sources,
        sources.shape[1], charges, dipole_vec, box_target_starts,
        box_target_counts_nonchild, box_source_starts,
        box_source_counts_nonchild, target_boxes, target_boxes.shape[0],
        starts, lists, k, out)
    return out

# }}}


# {{{ M2P

def m2p_helmholtz3d_plain(targets, box_target_starts,
                          box_target_counts_nonchild, rows, starts, lists,
                          mpoles, centers, box_scale, k, order):
    """Plain twin of :func:`m2p_helmholtz3d`."""
    out = _pot_zeros(targets.shape[1], mpoles.dtype, mpoles.device)
    evaluate = m2p_eval_pairs if _is_pairs(mpoles.dtype) else m2p_eval
    tbox, sbox = _edges(starts, lists, rows)
    if tbox.numel() == 0:
        return out
    kc = sh.ncoeffs(order)
    pt = _max_count(box_target_counts_nonchild, tbox)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (pt * kc))
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb_ = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        tidx, tmask = _blocks(box_target_starts, box_target_counts_nonchild,
                              tb, pt)
        s = box_scale[sb_][:, None]                      # (E, 1)
        rel = (targets[:, tidx] - centers[:, sb_][..., None]) / s
        val = evaluate(rel, mpoles[sb_][:, None, :], s.expand(rel.shape[1:]),
                       k, order)
        out.index_add_(0, tidx[tmask], val[tmask])
    return out


def m2p_helmholtz3d(targets, box_target_starts, box_target_counts_nonchild,
                    rows, starts, lists, mpoles, centers, box_scale, k,
                    order):
    """List-3 potentials (tree-order targets) from the multipoles of the
    listed source boxes, complex128 or ``[re | im]`` float64 rows (then
    ``(n, 2)`` potentials); rows name target boxes.  The K10 kernel
    (pairs: K48) on CUDA tensors."""
    args = (targets, box_target_starts, box_target_counts_nonchild, rows,
            starts, lists, mpoles, centers, box_scale)
    if targets.device.type == "cpu":
        return m2p_helmholtz3d_plain(*args, k, order)
    dt = mpoles.dtype
    _check_args(k, order, dt)
    kernels.check_tensors(targets, centers, box_scale, dtype=torch.float64)
    kernels.check_tensors(mpoles, dtype=dt)
    kernels.check_tensors(*args[1:6], dtype=torch.int32)
    if mpoles.shape != (centers.shape[1], _width(order, dt)):
        raise ValueError("mpoles must be (nboxes, (order + 1)**2), twice "
                         "that in pairs")
    out = _pot_zeros(targets.shape[1], dt, targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "m2p_helmholtz3d", dt, targets, targets.shape[1],
        box_target_starts, box_target_counts_nonchild, rows, rows.shape[0],
        starts, lists, mpoles, centers, centers.shape[1], box_scale, k,
        order, out)
    return out

# }}}


# {{{ P2L

def _p2l_plain(sources, charges, dipole_vec, box_source_starts,
               box_source_counts_nonchild, rows, starts, lists, centers,
               box_scale, w_nm, k, order, out):
    """The plain P2L of charges (*dipole_vec* None) or dipoles."""
    tbox, sbox = _edges(starts, lists, rows)
    if tbox.numel() == 0:
        return out
    pairs = _is_pairs(out.dtype)
    kc = _width(order, out.dtype)
    ps = _max_count(box_source_counts_nonchild, sbox)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (ps * kc))
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb_ = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        sidx, smask = _blocks(box_source_starts, box_source_counts_nonchild,
                              sb_, ps)
        s = box_scale[tb][:, None]                       # (E, 1)
        rel = (sources[:, sidx] - centers[:, tb][..., None]) / s
        q = torch.where(smask, charges[sidx], 0)
        scale = s.expand(rel.shape[1:])
        if dipole_vec is None:
            terms = (p2l_terms_pairs if pairs else p2l_terms)(
                rel, q, scale, w_nm, k, order)
        else:
            terms = (p2l_dipole_terms_pairs if pairs else p2l_dipole_terms)(
                rel, dipole_vec[:, sidx] / s, q, scale, w_nm, k, order)
        terms = torch.where(smask[..., None], terms, 0)
        out.index_add_(0, tb, terms.sum(1))
    return out


def p2l_helmholtz3d_plain(sources, charges, *args):
    """Plain twin of :func:`p2l_helmholtz3d`."""
    return _p2l_plain(sources, charges, None, *args)


def p2l_helmholtz3d(sources, charges, box_source_starts,
                    box_source_counts_nonchild, rows, starts, lists, centers,
                    box_scale, w_nm, k, order, out):
    """Add the List-4 local-expansion contributions of the listed source
    boxes into ``out[rows]`` (``out`` is ``(nboxes, (order+1)^2)``
    complex128, or ``(nboxes, 2 (order+1)^2)`` ``[re | im]`` float64 with
    real charges); rows name target-or-target-parent boxes, each at most
    once.  *w_nm* is the ``(order+1)^2`` complex weight ``4 pi i k D^2``
    (pairs: its real ``4 pi k D^2``).  The K11 kernel (pairs: K49) on CUDA
    tensors.  Returns *out*."""
    args = (sources, charges, box_source_starts,
            box_source_counts_nonchild, rows, starts, lists, centers,
            box_scale, w_nm)
    if sources.device.type == "cpu":
        return p2l_helmholtz3d_plain(*args, k, order, out)
    dt = out.dtype
    _check_args(k, order, dt)
    kernels.check_tensors(sources, centers, box_scale, dtype=torch.float64)
    kernels.check_tensors(charges, w_nm, out, dtype=dt)
    kernels.check_tensors(*args[2:7], dtype=torch.int32)
    if out.shape != (centers.shape[1], _width(order, dt)) \
            or w_nm.shape != (sh.ncoeffs(order),):
        raise ValueError("out must be (nboxes, (order + 1)**2), twice that "
                         "in pairs, and w_nm ((order + 1)**2,)")
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2l_helmholtz3d", dt, sources, sources.shape[1],
        charges, box_source_starts, box_source_counts_nonchild, rows,
        rows.shape[0], starts, lists, centers, centers.shape[1], box_scale,
        w_nm, k, order, out)
    return out


def p2l_helmholtz3d_dipole_plain(sources, charges, dipole_vec, *args):
    """Plain twin of :func:`p2l_helmholtz3d_dipole`: per (source, target
    box) the JVP of the twin's terms in the source position along
    *dipole_vec* (:func:`p2l_dipole_terms`), added into *out* (the last of
    *args*)."""
    return _p2l_plain(sources, charges, dipole_vec, *args)


def p2l_helmholtz3d_dipole(sources, charges, dipole_vec, box_source_starts,
                           box_source_counts_nonchild, rows, starts, lists,
                           centers, box_scale, w_nm, k, order, out):
    """:func:`p2l_helmholtz3d` for dipole sources (*dipole_vec* ``(3,
    nsources)`` in tree order).  The K59 kernel (pairs: K62) on CUDA
    tensors.  Returns *out*."""
    args = (box_source_starts, box_source_counts_nonchild, rows, starts,
            lists, centers, box_scale, w_nm)
    if sources.device.type == "cpu":
        return p2l_helmholtz3d_dipole_plain(sources, charges, dipole_vec,
                                            *args, k, order, out)
    dt = out.dtype
    _check_dipole_args(k, order, dt, "p2l")
    kernels.check_tensors(sources, dipole_vec, centers, box_scale,
                          dtype=torch.float64)
    kernels.check_tensors(charges, w_nm, out, dtype=dt)
    kernels.check_tensors(*args[:5], dtype=torch.int32)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    if out.shape != (centers.shape[1], _width(order, dt)) \
            or w_nm.shape != (sh.ncoeffs(order),):
        raise ValueError("out must be (nboxes, (order + 1)**2), twice that "
                         "in pairs, and w_nm ((order + 1)**2,)")
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2l_helmholtz3d_dipole", dt, sources, sources.shape[1], charges,
        dipole_vec, box_source_starts, box_source_counts_nonchild, rows,
        rows.shape[0], starts, lists, centers, centers.shape[1], box_scale,
        w_nm, k, order, out)
    return out

# }}}


# {{{ P2M / L2P

def _p2m_plain(sources, charges, dipole_vec, box_source_starts,
               box_source_counts_nonchild, rows, centers, box_scale, w_nm,
               k, order):
    """The plain P2M of charges (*dipole_vec* None) or dipoles."""
    pairs = _is_pairs(charges.dtype)
    kc = _width(order, charges.dtype)
    out = charges.new_zeros((centers.shape[1], kc))
    idx, box = _row_particles(box_source_starts, box_source_counts_nonchild,
                              rows)
    for c in _row_chunks(idx.shape[0], kc):
        i, b = idx[c], box[c]
        s = box_scale[b]
        rel = (sources[:, i] - centers[:, b]) / s
        if dipole_vec is None:
            terms = (p2m_terms_pairs if pairs else p2m_terms)(
                rel, charges[i], s, w_nm, k, order)
        else:
            terms = (p2m_dipole_terms_pairs if pairs else p2m_dipole_terms)(
                rel, dipole_vec[:, i] / s, charges[i], s, w_nm, k, order)
        out.index_add_(0, b, terms)
    return out


def p2m_helmholtz3d_plain(sources, charges, *args):
    """Plain twin of :func:`p2m_helmholtz3d`."""
    return _p2m_plain(sources, charges, None, *args)


def p2m_helmholtz3d(sources, charges, box_source_starts,
                    box_source_counts_nonchild, rows, centers, box_scale,
                    w_nm, k, order):
    """Multipoles of the tree-order sources that the boxes *rows* own
    (their nonchild ranges, each box at most once): ``(nboxes,
    (order+1)^2)`` complex128 for complex128 charges, ``(nboxes, 2
    (order+1)^2)`` ``[re | im]`` float64 for real float64 ones; the other
    boxes' rows are zero.  *w_nm* is the ``(order+1)^2`` complex weight
    ``4 pi i k D^2`` (pairs: its real ``4 pi k D^2``).  The K31 kernel
    (pairs: K50) on CUDA tensors."""
    args = (sources, charges, box_source_starts,
            box_source_counts_nonchild, rows, centers, box_scale, w_nm)
    if sources.device.type == "cpu":
        return p2m_helmholtz3d_plain(*args, k, order)
    dt = charges.dtype
    _check_args(k, order, dt)
    kernels.check_tensors(sources, centers, box_scale, dtype=torch.float64)
    kernels.check_tensors(charges, w_nm, dtype=dt)
    kernels.check_tensors(box_source_starts, box_source_counts_nonchild,
                          rows, dtype=torch.int32)
    if w_nm.shape != (sh.ncoeffs(order),):
        raise ValueError("w_nm must be ((order + 1)**2,)")
    out = torch.zeros((centers.shape[1], _width(order, dt)), dtype=dt,
                      device=sources.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "p2m_helmholtz3d", dt, sources, sources.shape[1],
        charges, box_source_starts, box_source_counts_nonchild, rows,
        rows.shape[0], centers, centers.shape[1], box_scale, w_nm, k, order,
        out)
    return out


def p2m_helmholtz3d_dipole_plain(sources, charges, dipole_vec, *args):
    """Plain twin of :func:`p2m_helmholtz3d_dipole`: per source the JVP of
    the twin's terms in its position along *dipole_vec*, and the limit of
    that tangent for a source at its box's centre
    (:func:`p2m_dipole_terms`)."""
    return _p2m_plain(sources, charges, dipole_vec, *args)


def p2m_helmholtz3d_dipole(sources, charges, dipole_vec, box_source_starts,
                           box_source_counts_nonchild, rows, centers,
                           box_scale, w_nm, k, order):
    """:func:`p2m_helmholtz3d` for dipole sources (*dipole_vec* ``(3,
    nsources)`` in tree order); a source at its box's centre adds the
    limit of its tangent (see the module doc).  The K57 kernel (pairs:
    K60) on CUDA tensors."""
    args = (box_source_starts, box_source_counts_nonchild, rows, centers,
            box_scale, w_nm)
    if sources.device.type == "cpu":
        return p2m_helmholtz3d_dipole_plain(sources, charges, dipole_vec,
                                            *args, k, order)
    dt = charges.dtype
    _check_dipole_args(k, order, dt, "p2m")
    kernels.check_tensors(sources, dipole_vec, centers, box_scale,
                          dtype=torch.float64)
    kernels.check_tensors(charges, w_nm, dtype=dt)
    kernels.check_tensors(*args[:3], dtype=torch.int32)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    if w_nm.shape != (sh.ncoeffs(order),):
        raise ValueError("w_nm must be ((order + 1)**2,)")
    out = torch.zeros((centers.shape[1], _width(order, dt)), dtype=dt,
                      device=sources.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "p2m_helmholtz3d_dipole", dt, sources, sources.shape[1], charges,
        dipole_vec, box_source_starts, box_source_counts_nonchild, rows,
        rows.shape[0], centers, centers.shape[1], box_scale, w_nm, k, order,
        out)
    return out


def l2p_helmholtz3d_plain(targets, box_target_starts,
                          box_target_counts_nonchild, rows, local_exps,
                          centers, box_scale, k, order):
    """Plain twin of :func:`l2p_helmholtz3d`."""
    out = _pot_zeros(targets.shape[1], local_exps.dtype, local_exps.device)
    evaluate = l2p_eval_pairs if _is_pairs(local_exps.dtype) else l2p_eval
    idx, box = _row_particles(box_target_starts, box_target_counts_nonchild,
                              rows)
    for c in _row_chunks(idx.shape[0], local_exps.shape[1]):
        i, b = idx[c], box[c]
        s = box_scale[b]
        rel = (targets[:, i] - centers[:, b]) / s
        out[i] = evaluate(rel, local_exps[b], s, k, order)
    return out


def l2p_helmholtz3d(targets, box_target_starts, box_target_counts_nonchild,
                    rows, local_exps, centers, box_scale, k, order):
    """Potentials (tree-order targets) of the local expansions
    *local_exps* (complex128, or ``[re | im]`` float64 rows, then ``(n,
    2)`` potentials) at the targets that the boxes *rows* own (their
    nonchild ranges, each box at most once); the other targets' are zero.
    The K32 kernel (pairs: K51) on CUDA tensors."""
    args = (targets, box_target_starts, box_target_counts_nonchild, rows,
            local_exps, centers, box_scale)
    if targets.device.type == "cpu":
        return l2p_helmholtz3d_plain(*args, k, order)
    dt = local_exps.dtype
    _check_args(k, order, dt)
    kernels.check_tensors(targets, centers, box_scale, dtype=torch.float64)
    kernels.check_tensors(local_exps, dtype=dt)
    kernels.check_tensors(box_target_starts, box_target_counts_nonchild,
                          rows, dtype=torch.int32)
    if local_exps.shape != (centers.shape[1], _width(order, dt)):
        raise ValueError("local_exps must be (nboxes, (order + 1)**2), "
                         "twice that in pairs")
    out = _pot_zeros(targets.shape[1], dt, targets.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "l2p_helmholtz3d", dt, targets, targets.shape[1],
        box_target_starts, box_target_counts_nonchild, rows, rows.shape[0],
        local_exps, centers, centers.shape[1], box_scale, k, order, out)
    return out

# }}}
