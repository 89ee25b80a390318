"""The particle stages of the 2D Laplace FMM: P2M, P2P (List 1), M2P
(List 3), P2L (List 4) and L2P, and the dipole forms of P2M, P2P and P2L,
each as a kernel wrapper and its plain twin, and the expansions they
share.

Kernel ``G(t, s) = log(t - s)`` (complex; its real part ``log |t - s|`` is
the potential).  Expansions about a box centre ``c``, with ``w = (z - c) /
s`` the offset scaled by the box's rscale ``s`` (``boxtree_tpu/models/
laplace.py:68-240``):

- multipole: ``phi = a_0 (log w + log s) + sum_{k>=1} a_k w^-k``, P2M
  ``a_0 = q``, ``a_k = -q w_s^k / k``;
- local: ``phi = sum_l b_l w^l``, P2L ``b_0 = q (log(-z0) + log s)``,
  ``b_l = -q z0^-l / l`` with ``z0 = (y_s - c) / s``.

Two coefficient layouts, each with its own entry points:

- complex128 (the complex wrangler): ``p + 1`` complex coefficients, over
  float64 geometry, complex charges and potentials;
- real pairs (the pairs wrangler): ``[re_0..re_p | im_0..im_p]``, ``2 (p +
  1)`` real coefficients of float32 or float64, like the geometry, real
  charges and potentials ``Re phi`` (``laplace.py:243-366``).

Each follows its reference's edges, which differ:

- the complex value ``rel[0] + 1j * rel[1]`` of the reference holds a
  ``-0.0`` imaginary part as ``+0.0``: on a box's centre line, ``log w``
  is ``+i pi`` left of the centre, and ``log(-z0)`` is ``-i pi`` right of
  it.  The pairs' ``atan2`` takes the sign of the offset as it is;
- at ``w = 0`` the complex M2P evaluates at ``w = 1`` (``laplace.py:212``),
  the pairs' at ``1 / w = 0``; at ``z0 = 0`` the complex P2L takes ``z0 =
  1`` (``log(-1 - 0i) = -i pi``), the pairs' ``1 / z0 = 0`` and angle
  ``-0``.

Each wrapper takes the tree's particle arrays in tree order, the per-box
particle ranges ``[box_*_starts, + box_*_counts_nonchild)`` and either a
CSR list whose rows name boxes (the list stages) or the rows alone, the
boxes that own particles (P2M, L2P).  On CPU tensors it runs the plain
PyTorch twin; on CUDA tensors it launches the hand-written kernel of
``csrc/laplace2d.cu`` (K19-K21, K38-K42) or raises.

- P2P: ``phi(t) = sum q_s log |t - s| = sum q_s (1/2) log r^2``, ``r = 0``
  skipped (``laplace.py:232-240``).
- M2P: ``phi(t) += M2P(t - c_b) / s_b`` over the listed source boxes
  (``laplace.py:210-219``, pairs ``:340-354``).
- P2L: ``L(b) += P2L terms of (x_s - c_b) / s_b`` (``laplace.py:221-230``,
  pairs ``:356-366``), added into the box's coefficients in place.
- P2M (K38): ``M(b) = P2M terms of (x_s - c_b) / s_b`` over the sources box
  ``b`` owns (``laplace.py:191-198``, pairs ``:318-327``).
- L2P (K40): ``phi(t) = sum L_l(b) w^l``, its real part for the pairs
  (``laplace.py:200-207``, pairs ``:329-338``).
- Dipoles (K39, K41, K42): the JVP of P2M, P2P and P2L in the source
  positions along ``dipole_vec`` (``expansion_base.py:664-673``,
  ``:1314-1324``, ``:1688-1694``): P2M's and P2L's offsets take the
  tangent ``d / s``, P2P's difference ``-d``.  The twins take
  :func:`torch.func.jvp` of the charge twins in the source positions, the
  reference's own construction.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels
from boxtree_torch.ops.laplace3d import (
    _blocks,
    _edges,
    _max_count,
    _row_chunks,
    _row_particles,
)

#: element budget of one chunk's largest temporary in the plain twins
_PLAIN_CHUNK_ELEMS = 1 << 22
#: the kernels' threads per CTA (one warp), as in csrc/laplace2d.cu
_KERNEL_THREADS = 32
_DTYPES = (torch.float32, torch.float64, torch.complex128)


# {{{ the expansions the twins evaluate

def _complex(rel):
    """``rel[0] + 1j * rel[1]`` as the reference forms it: a ``-0.0``
    imaginary part comes out ``+0.0``."""
    return torch.complex(rel[0], rel[1] + 0.0)


def p2m_terms(rel, q, order):
    """``(..., p+1)`` complex multipole terms of charges *q* at scaled
    offsets *rel*: ``q, -q w/1, -q w^2/2, ...`` (``laplace.py:191-198``)."""
    z = _complex(rel)
    out = [q]
    zp = torch.ones_like(z)
    for k in range(1, order + 1):
        zp = zp * z
        out.append(-q * zp / k)
    return torch.stack(out, dim=-1)


def p2m_terms_pairs(rel, q, order):
    """Pair-lane :func:`p2m_terms` of real charges (``laplace.py:
    318-327``)."""
    zr, zi = rel[0], rel[1]
    re, im = [q], [torch.zeros_like(q)]
    pr, pi = torch.ones_like(zr), torch.zeros_like(zr)
    for k in range(1, order + 1):
        pr, pi = pr * zr - pi * zi, pr * zi + pi * zr
        re.append(-q * pr / k)
        im.append(-q * pi / k)
    return torch.stack(re + im, dim=-1)


def l2p_eval(rel, loc, order):
    """``sum_l loc_l w^l`` (``laplace.py:200-207``)."""
    w = _complex(rel)
    acc = loc[..., 0]
    wp = torch.ones_like(w)
    for ell in range(1, order + 1):
        wp = wp * w
        acc = acc + loc[..., ell] * wp
    return acc


def l2p_eval_pairs(rel, loc, order):
    """``Re sum_l loc_l w^l`` on pair lanes (``laplace.py:329-338``)."""
    wr, wi = rel[0], rel[1]
    nc = order + 1
    acc = loc[..., 0]
    pr, pi = torch.ones_like(wr), torch.zeros_like(wr)
    for ell in range(1, nc):
        pr, pi = pr * wr - pi * wi, pr * wi + pi * wr
        acc = acc + loc[..., ell] * pr - loc[..., nc + ell] * pi
    return acc


def m2p_eval(rel, mp, scale, order):
    """``mp_0 (log w + log s) + sum_k mp_k w^-k`` at scaled offsets *rel*,
    ``w = 0`` taken as 1 (``laplace.py:210-219``)."""
    w = _complex(rel)
    ws = torch.where(w == 0, torch.ones_like(w), w)
    winv = 1.0 / ws
    acc = mp[..., 0] * (torch.log(ws) + torch.log(scale))
    wp = torch.ones_like(w)
    for k in range(1, order + 1):
        wp = wp * winv
        acc = acc + mp[..., k] * wp
    return acc


def m2p_eval_pairs(rel, mp, scale, order):
    """``Re`` of :func:`m2p_eval` on pair lanes, ``1 / w = 0`` at ``w = 0``
    (``laplace.py:340-354``)."""
    wr, wi = rel[0], rel[1]
    nc = order + 1
    r2 = wr * wr + wi * wi
    zero = r2 == 0
    r2s = torch.where(zero, torch.ones_like(r2), r2)
    lgr = 0.5 * torch.log(r2s) + torch.log(scale)
    th = torch.atan2(wi, torch.where(zero, torch.ones_like(wr), wr))
    acc = mp[..., 0] * lgr - mp[..., nc] * th
    ixr, ixi = wr / r2s, -wi / r2s
    pr, pi = torch.ones_like(wr), torch.zeros_like(wr)
    for k in range(1, nc):
        pr, pi = pr * ixr - pi * ixi, pr * ixi + pi * ixr
        acc = acc + mp[..., k] * pr - mp[..., nc + k] * pi
    return acc


def p2l_terms(rel, q, scale, order):
    """``(..., p+1)`` local terms of charges *q* at scaled offsets *rel*:
    ``q (log(-z0) + log s)``, ``-q z0^-l / l``, ``z0 = 0`` taken as 1
    (``laplace.py:221-230``)."""
    z0 = _complex(rel)
    z0s = torch.where(z0 == 0, torch.ones_like(z0), z0)
    z0inv = 1.0 / z0s
    # -z0s part by part: torch's vectorised complex negation leaves a zero
    # imaginary part +0.0, the reference's -0.0 (log(-z0) = -i pi)
    mz = torch.complex(-z0s.real, -z0s.imag)
    out = [q * (torch.log(mz) + torch.log(scale))]
    zp = torch.ones_like(z0)
    for ell in range(1, order + 1):
        zp = zp * z0inv
        out.append(-q * zp / ell)
    return torch.stack(out, dim=-1)


def p2l_terms_pairs(rel, q, scale, order):
    """Pair-lane :func:`p2l_terms` of real charges, ``1 / z0 = 0`` at ``z0
    = 0`` (``laplace.py:356-366``)."""
    zr, zi = rel[0], rel[1]
    r2 = zr * zr + zi * zi
    zero = r2 == 0
    r2s = torch.where(zero, torch.ones_like(r2), r2)
    lgr = 0.5 * torch.log(r2s) + torch.log(scale)
    th = torch.atan2(-zi, torch.where(zero, torch.ones_like(zr), -zr))
    re, im = [q * lgr], [q * th]
    ixr, ixi = zr / r2s, -zi / r2s
    pr, pi = torch.ones_like(zr), torch.zeros_like(zr)
    for ell in range(1, order + 1):
        pr, pi = pr * ixr - pi * ixi, pr * ixi + pi * ixr
        re.append(-q * pr / ell)
        im.append(-q * pi / ell)
    return torch.stack(re + im, dim=-1)

# }}}


def ncoeffs(order, dtype):
    """Coefficients a box holds: ``p + 1`` complex, or ``2 (p + 1)`` real
    pair lanes."""
    return order + 1 if dtype.is_complex else 2 * (order + 1)


def smem_bytes(order, dtype):
    """Shared memory of one CTA of K21, as ``csrc/laplace2d.cu`` sizes it:
    each thread's terms, one column per thread, and their sums (K20 stages
    one multipole, less)."""
    return ncoeffs(order, dtype) * (_KERNEL_THREADS + 1) * dtype.itemsize


def check_order(order, dtype):
    """Refuse an order whose K21 scratch passes 227 KiB a CTA."""
    smem = smem_bytes(order, dtype)
    if smem > kernels.SMEM_MAX:
        raise ValueError(f"order {order} in {dtype} needs {smem} bytes of "
                         "shared memory per CTA; the kernels take up to "
                         "227 KiB")


def _check_dtypes(value_dtype, real_dtype):
    """The kernels take complex128 values over float64 geometry, or real
    values of the geometry's dtype."""
    if value_dtype not in _DTYPES or real_dtype != value_dtype.to_real():
        raise TypeError(f"the 2D Laplace kernels take complex128 over "
                        f"float64 or real pairs of float32 / float64, not "
                        f"{value_dtype} over {real_dtype}")


# {{{ P2P

def p2p_laplace2d_plain(targets, sources, charges, box_target_starts,
                        box_target_counts_nonchild, box_source_starts,
                        box_source_counts_nonchild, target_boxes, starts,
                        lists):
    """Plain twin of :func:`p2p_laplace2d`."""
    out = charges.new_zeros(targets.shape[1])
    tbox, sbox = _edges(starts, lists, target_boxes)
    if tbox.numel() == 0:
        return out
    pt = _max_count(box_target_counts_nonchild, tbox)
    ps = _max_count(box_source_counts_nonchild, sbox)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (pt * ps))
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        tidx, tmask = _blocks(box_target_starts, box_target_counts_nonchild,
                              tb, pt)
        sidx, smask = _blocks(box_source_starts, box_source_counts_nonchild,
                              sb, ps)
        q = torch.where(smask, charges[sidx], 0)
        diff = targets[:, tidx][..., :, None] - sources[:, sidx][..., None, :]
        r2 = diff[0] * diff[0] + diff[1] * diff[1]       # (E, pt, ps)
        ok = r2 > 0
        g = torch.where(ok, 0.5 * torch.log(torch.where(ok, r2, 1)), 0)
        vals = (g.to(q.dtype) * q[:, None, :]).sum(-1)   # (E, pt)
        out.index_add_(0, tidx[tmask], vals[tmask])
    return out


def _check_dipoles(sources, dipole_vec):
    kernels.check_tensors(sources, dipole_vec, dtype=sources.dtype)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")


def p2p_laplace2d(targets, sources, charges, box_target_starts,
                  box_target_counts_nonchild, box_source_starts,
                  box_source_counts_nonchild, target_boxes, starts, lists):
    """List-1 potentials (tree-order targets) of ``log |t - s|`` times
    real or complex charges; the K19 kernel on CUDA tensors."""
    args = (targets, sources, charges, box_target_starts,
            box_target_counts_nonchild, box_source_starts,
            box_source_counts_nonchild, target_boxes, starts, lists)
    if targets.device.type == "cpu":
        return p2p_laplace2d_plain(*args)
    _check_dtypes(charges.dtype, targets.dtype)
    kernels.check_tensors(targets, sources, dtype=targets.dtype)
    kernels.check_tensors(charges, dtype=charges.dtype)
    kernels.check_tensors(*args[3:], dtype=torch.int32)
    out = torch.zeros(targets.shape[1], dtype=charges.dtype,
                      device=targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2p_laplace2d", charges.dtype, targets, targets.shape[1], sources,
        sources.shape[1], charges, box_target_starts,
        box_target_counts_nonchild, box_source_starts,
        box_source_counts_nonchild, target_boxes, target_boxes.shape[0],
        starts, lists, out)
    return out


def p2p_laplace2d_dipole_plain(targets, sources, charges, dipole_vec,
                               *args):
    """Plain twin of :func:`p2p_laplace2d_dipole`: the JVP of
    :func:`p2p_laplace2d_plain` in the source positions along
    *dipole_vec*."""
    return torch.func.jvp(
        lambda s: p2p_laplace2d_plain(targets, s, charges, *args),
        (sources,), (dipole_vec,))[1]


def p2p_laplace2d_dipole(targets, sources, charges, dipole_vec,
                         box_target_starts, box_target_counts_nonchild,
                         box_source_starts, box_source_counts_nonchild,
                         target_boxes, starts, lists):
    """List-1 potentials of dipole sources, ``sum q_s d_s . (s - t) / |t -
    s|^2``, 0 at ``r = 0`` (*dipole_vec* ``(2, nsources)`` in tree order);
    the K41 kernel on CUDA tensors."""
    args = (box_target_starts, box_target_counts_nonchild,
            box_source_starts, box_source_counts_nonchild, target_boxes,
            starts, lists)
    if targets.device.type == "cpu":
        return p2p_laplace2d_dipole_plain(targets, sources, charges,
                                          dipole_vec, *args)
    _check_dtypes(charges.dtype, targets.dtype)
    kernels.check_tensors(targets, sources, dtype=targets.dtype)
    kernels.check_tensors(charges, dtype=charges.dtype)
    kernels.check_tensors(*args, dtype=torch.int32)
    _check_dipoles(sources, dipole_vec)
    out = torch.zeros(targets.shape[1], dtype=charges.dtype,
                      device=targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2p_laplace2d_dipole", charges.dtype, targets, targets.shape[1],
        sources, sources.shape[1], charges, dipole_vec, box_target_starts,
        box_target_counts_nonchild, box_source_starts,
        box_source_counts_nonchild, target_boxes, target_boxes.shape[0],
        starts, lists, out)
    return out

# }}}


# {{{ M2P

def m2p_laplace2d_plain(targets, box_target_starts,
                        box_target_counts_nonchild, rows, starts, lists,
                        mpoles, centers, box_scale, order):
    """Plain twin of :func:`m2p_laplace2d`."""
    out = mpoles.new_zeros(targets.shape[1])
    tbox, sbox = _edges(starts, lists, rows)
    if tbox.numel() == 0:
        return out
    pt = _max_count(box_target_counts_nonchild, tbox)
    evaluate = m2p_eval if mpoles.is_complex() else m2p_eval_pairs
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (pt * mpoles.shape[1]))
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        tidx, tmask = _blocks(box_target_starts, box_target_counts_nonchild,
                              tb, pt)
        s = box_scale[sb][:, None]                       # (E, 1)
        rel = (targets[:, tidx] - centers[:, sb][..., None]) / s
        val = evaluate(rel, mpoles[sb][:, None, :], s, order)
        out.index_add_(0, tidx[tmask], val[tmask])
    return out


def m2p_laplace2d(targets, box_target_starts, box_target_counts_nonchild,
                  rows, starts, lists, mpoles, centers, box_scale, order):
    """List-3 potentials (tree-order targets) from the multipoles of the
    listed source boxes; rows name target boxes.  Complex128 multipoles
    give complex potentials, pair-lane ones real.  The K20 kernel on CUDA
    tensors."""
    args = (targets, box_target_starts, box_target_counts_nonchild, rows,
            starts, lists, mpoles, centers, box_scale)
    if targets.device.type == "cpu":
        return m2p_laplace2d_plain(*args, order)
    _check_dtypes(mpoles.dtype, targets.dtype)
    check_order(order, mpoles.dtype)
    kernels.check_tensors(targets, centers, box_scale, dtype=targets.dtype)
    kernels.check_tensors(mpoles, dtype=mpoles.dtype)
    kernels.check_tensors(*args[1:6], dtype=torch.int32)
    if mpoles.shape != (centers.shape[1], ncoeffs(order, mpoles.dtype)):
        raise ValueError("mpoles must be (nboxes, ncoeffs)")
    out = torch.zeros(targets.shape[1], dtype=mpoles.dtype,
                      device=targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "m2p_laplace2d", mpoles.dtype, targets, targets.shape[1],
        box_target_starts, box_target_counts_nonchild, rows, rows.shape[0],
        starts, lists, mpoles, centers, centers.shape[1], box_scale, order,
        out)
    return out

# }}}


# {{{ P2L

def p2l_laplace2d_plain(sources, charges, box_source_starts,
                        box_source_counts_nonchild, rows, starts, lists,
                        centers, box_scale, order, out):
    """Plain twin of :func:`p2l_laplace2d`."""
    tbox, sbox = _edges(starts, lists, rows)
    if tbox.numel() == 0:
        return out
    ps = _max_count(box_source_counts_nonchild, sbox)
    terms_of = p2l_terms if out.is_complex() else p2l_terms_pairs
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (ps * out.shape[1]))
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        sidx, smask = _blocks(box_source_starts, box_source_counts_nonchild,
                              sb, ps)
        s = box_scale[tb][:, None]                       # (E, 1)
        rel = (sources[:, sidx] - centers[:, tb][..., None]) / s
        q = torch.where(smask, charges[sidx], 0)
        terms = terms_of(rel, q, s, order)
        terms = torch.where(smask[..., None], terms, 0)
        out.index_add_(0, tb, terms.sum(1))
    return out


def p2l_laplace2d(sources, charges, box_source_starts,
                  box_source_counts_nonchild, rows, starts, lists, centers,
                  box_scale, order, out):
    """Add the List-4 local-expansion contributions of the listed source
    boxes into ``out[rows]`` (``(nboxes, ncoeffs)``, complex128 or pair
    lanes); rows name target-or-target-parent boxes, each at most once.
    The K21 kernel on CUDA tensors.  Returns *out*."""
    args = (sources, charges, box_source_starts,
            box_source_counts_nonchild, rows, starts, lists, centers,
            box_scale)
    if sources.device.type == "cpu":
        return p2l_laplace2d_plain(*args, order, out)
    _check_p2l(sources, charges, centers, box_scale, order, out, *args[2:7])
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2l_laplace2d", out.dtype, sources, sources.shape[1], charges,
        box_source_starts, box_source_counts_nonchild, rows, rows.shape[0],
        starts, lists, centers, centers.shape[1], box_scale, order, out)
    return out


def _check_p2l(sources, charges, centers, box_scale, order, out, *ints):
    _check_dtypes(out.dtype, sources.dtype)
    check_order(order, out.dtype)
    kernels.check_tensors(sources, centers, box_scale, dtype=sources.dtype)
    kernels.check_tensors(charges, out, dtype=out.dtype)
    kernels.check_tensors(*ints, dtype=torch.int32)
    if out.shape != (centers.shape[1], ncoeffs(order, out.dtype)):
        raise ValueError("out must be (nboxes, ncoeffs)")


def p2l_laplace2d_dipole_plain(sources, charges, dipole_vec, *args):
    """Plain twin of :func:`p2l_laplace2d_dipole`: the JVP of
    :func:`p2l_laplace2d_plain` in the source positions along
    *dipole_vec*, added into *out* (the last of *args*)."""
    *args, out = args
    terms = torch.func.jvp(
        lambda s: p2l_laplace2d_plain(s, charges, *args,
                                      torch.zeros_like(out)),
        (sources,), (dipole_vec,))[1]
    return out.add_(terms)


def p2l_laplace2d_dipole(sources, charges, dipole_vec, box_source_starts,
                         box_source_counts_nonchild, rows, starts, lists,
                         centers, box_scale, order, out):
    """:func:`p2l_laplace2d` for dipole sources (*dipole_vec* ``(2,
    nsources)`` in tree order); the K42 kernel on CUDA tensors."""
    args = (box_source_starts, box_source_counts_nonchild, rows, starts,
            lists, centers, box_scale)
    if sources.device.type == "cpu":
        return p2l_laplace2d_dipole_plain(sources, charges, dipole_vec,
                                          *args, order, out)
    _check_p2l(sources, charges, centers, box_scale, order, out, *args[:5])
    _check_dipoles(sources, dipole_vec)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2l_laplace2d_dipole", out.dtype, sources, sources.shape[1],
        charges, dipole_vec, box_source_starts, box_source_counts_nonchild,
        rows, rows.shape[0], starts, lists, centers, centers.shape[1],
        box_scale, order, out)
    return out

# }}}


# {{{ P2M / L2P

def p2m_laplace2d_plain(sources, charges, box_source_starts,
                        box_source_counts_nonchild, rows, centers,
                        box_scale, order):
    """Plain twin of :func:`p2m_laplace2d`."""
    width = ncoeffs(order, charges.dtype)
    out = charges.new_zeros((centers.shape[1], width))
    terms_of = p2m_terms if charges.is_complex() else p2m_terms_pairs
    idx, box = _row_particles(box_source_starts, box_source_counts_nonchild,
                              rows)
    for c in _row_chunks(idx.shape[0], width):
        i, b = idx[c], box[c]
        rel = (sources[:, i] - centers[:, b]) / box_scale[b]
        out.index_add_(0, b, terms_of(rel, charges[i], order))
    return out


def _check_rows(pts, values, centers, box_scale, *ints):
    _check_dtypes(values.dtype, pts.dtype)
    kernels.check_tensors(pts, centers, box_scale, dtype=pts.dtype)
    kernels.check_tensors(values, dtype=values.dtype)
    kernels.check_tensors(*ints, dtype=torch.int32)


def p2m_laplace2d(sources, charges, box_source_starts,
                  box_source_counts_nonchild, rows, centers, box_scale,
                  order):
    """Multipoles ``(nboxes, ncoeffs)``, complex128 of complex charges or
    ``[re | im]`` pair lanes of real ones, of the tree-order sources that
    the boxes *rows* own (their nonchild ranges, each box at most once);
    the other boxes' rows are zero.  The K38 kernel on CUDA tensors."""
    args = (sources, charges, box_source_starts,
            box_source_counts_nonchild, rows, centers, box_scale, order)
    if sources.device.type == "cpu":
        return p2m_laplace2d_plain(*args)
    _check_rows(sources, charges, centers, box_scale, box_source_starts,
                box_source_counts_nonchild, rows)
    out = torch.zeros((centers.shape[1], ncoeffs(order, charges.dtype)),
                      dtype=charges.dtype, device=sources.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "p2m_laplace2d", charges.dtype, sources, sources.shape[1], charges,
        box_source_starts, box_source_counts_nonchild, rows, rows.shape[0],
        centers, centers.shape[1], box_scale, order, out)
    return out


def p2m_laplace2d_dipole_plain(sources, charges, dipole_vec, *args):
    """Plain twin of :func:`p2m_laplace2d_dipole`: the JVP of
    :func:`p2m_laplace2d_plain` in the source positions along
    *dipole_vec*."""
    return torch.func.jvp(
        lambda s: p2m_laplace2d_plain(s, charges, *args),
        (sources,), (dipole_vec,))[1]


def p2m_laplace2d_dipole(sources, charges, dipole_vec, box_source_starts,
                         box_source_counts_nonchild, rows, centers,
                         box_scale, order):
    """:func:`p2m_laplace2d` for dipole sources (*dipole_vec* ``(2,
    nsources)`` in tree order); the K39 kernel on CUDA tensors."""
    args = (box_source_starts, box_source_counts_nonchild, rows, centers,
            box_scale, order)
    if sources.device.type == "cpu":
        return p2m_laplace2d_dipole_plain(sources, charges, dipole_vec,
                                          *args)
    _check_rows(sources, charges, centers, box_scale, box_source_starts,
                box_source_counts_nonchild, rows)
    _check_dipoles(sources, dipole_vec)
    out = torch.zeros((centers.shape[1], ncoeffs(order, charges.dtype)),
                      dtype=charges.dtype, device=sources.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "p2m_laplace2d_dipole", charges.dtype, sources, sources.shape[1],
        charges, dipole_vec, box_source_starts, box_source_counts_nonchild,
        rows, rows.shape[0], centers, centers.shape[1], box_scale, order,
        out)
    return out


def l2p_laplace2d_plain(targets, box_target_starts,
                        box_target_counts_nonchild, rows, local_exps,
                        centers, box_scale, order):
    """Plain twin of :func:`l2p_laplace2d`."""
    out = local_exps.new_zeros(targets.shape[1])
    evaluate = l2p_eval if local_exps.is_complex() else l2p_eval_pairs
    idx, box = _row_particles(box_target_starts, box_target_counts_nonchild,
                              rows)
    for c in _row_chunks(idx.shape[0], local_exps.shape[1]):
        i, b = idx[c], box[c]
        rel = (targets[:, i] - centers[:, b]) / box_scale[b]
        out[i] = evaluate(rel, local_exps[b], order)
    return out


def l2p_laplace2d(targets, box_target_starts, box_target_counts_nonchild,
                  rows, local_exps, centers, box_scale, order):
    """Potentials (tree-order targets) of the local expansions
    *local_exps* (complex128, or ``[re | im]`` pairs with real potentials)
    at the targets that the boxes *rows* own (their nonchild ranges, each
    box at most once); the other targets' are zero.  The K40 kernel on
    CUDA tensors."""
    args = (targets, box_target_starts, box_target_counts_nonchild, rows,
            local_exps, centers, box_scale, order)
    if targets.device.type == "cpu":
        return l2p_laplace2d_plain(*args)
    _check_rows(targets, local_exps, centers, box_scale, box_target_starts,
                box_target_counts_nonchild, rows)
    if local_exps.shape != (centers.shape[1],
                            ncoeffs(order, local_exps.dtype)):
        raise ValueError("local_exps must be (nboxes, ncoeffs)")
    out = torch.zeros(targets.shape[1], dtype=local_exps.dtype,
                      device=targets.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "l2p_laplace2d", local_exps.dtype, targets, targets.shape[1],
        box_target_starts, box_target_counts_nonchild, rows, rows.shape[0],
        local_exps, centers, centers.shape[1], box_scale, order, out)
    return out

# }}}
