"""The particle stages of the 3D Laplace FMM: P2M, P2P (List 1), M2P
(List 3), P2L (List 4) and L2P, and the dipole forms of P2M, P2P and P2L,
each as a kernel wrapper and its plain twin.

Each wrapper takes the tree's particle arrays in tree order, the per-box
particle ranges ``[box_*_starts, + box_*_counts_nonchild)`` and either a
CSR list whose rows name boxes (the list stages) or the rows alone, the
boxes that own particles (P2M, L2P).  On CPU tensors it runs the plain
PyTorch twin; on CUDA tensors it launches the hand-written kernel
(``csrc/p2p.cu``, ``csrc/m2p.cu``, ``csrc/p2l.cu``, ``csrc/p2m.cu``,
``csrc/l2p.cu``) or raises.  The twins gather padded (edges, particles)
blocks, or the rows' particles, chunk by chunk, so their memory stays
bounded; the kernels read the particle ranges directly.

Two coefficient layouts, each with its entry points:

- complex128 (the complex wrangler): ``(p+1)^2`` complex coefficients
  over float64 geometry, complex charges and potentials;
- real pairs (the pairs wrangler): ``[re | im]``, ``2 (p+1)^2`` real
  coefficients of float32 or float64, like the geometry, real charges and
  potentials ``Re phi``.

The stages (``boxtree_tpu/models/laplace.py:473-500``, pairs ``:581-608``):

- P2M (K28): ``M(b) = sum conj(R((x_s - c_b) / r_b)) q_s`` over the
  sources box ``b`` owns (``:473-475``; the pairs ``[Rr | -Ri] q``,
  ``:581-586``; ``expansion_base.py:651-677``), ``r = 0`` included.
- L2P (K30): ``phi(t) = sum conj(R((t - c_b) / r_b)) L(b)`` (``:477-479``;
  the pairs ``Rr.lr + Ri.li``, ``:588-593``; ``expansion_base.py:
  1793-1803``), ``r = 0`` included.
- P2P: ``phi(t) = sum q_s / |t - s|``, ``r = 0`` skipped (``:492-497``).
- M2P: ``phi(t) += sum S((t - c_s) / r_s) M(s) / r_s`` (``:481-484``;
  the pairs its real part, ``:595-602``).
- P2L: ``L(b) += sum q_s S((x_s - c_b) / r_b) / r_b`` (``:486-490``,
  ``:604-608``, ``expansion_base.py:1680-1684``).
- Dipole P2P (K22): the JVP of P2P in the source positions along the
  dipoles, ``phi(t) = sum q_s d_s . (t - s) / |t - s|^3``, 0 at ``r = 0``
  (``expansion_base.py:1314-1324``).
- Dipole P2L (K23): the JVP of P2L's terms in the source offsets along
  ``d_s / r_b`` (``expansion_base.py:1688-1694``).
- Dipole P2M (K29): the JVP of P2M's terms in the source offsets along
  ``d_s / r_b`` (``expansion_base.py:664-673``).

The dipole twins take :func:`torch.func.jvp` of the P2M, P2P and P2L twins
in the source coordinates, the reference's own construction.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels
from boxtree_torch.ops.solid_harmonics import (
    irregular,
    irregular_pairs,
    ncoeffs,
    regular,
    regular_pairs,
)
from boxtree_torch.traversal.containers import csr_rows

#: element budget of one chunk's largest temporary in the plain twins
_PLAIN_CHUNK_ELEMS = 1 << 24
#: element budget of one chunk of the P2M and L2P twins' per-particle
#: coefficients
_PARTICLE_CHUNK_ELEMS = 1 << 26
#: (value dtype, geometry dtype) pairs the kernels have entry points for
_DTYPES = ((torch.complex128, torch.float64), (torch.float64, torch.float64),
           (torch.float32, torch.float32))


def _edges(starts, lists, rows):
    """(row box, listed box) int64 pairs of a CSR list whose rows name
    the boxes *rows*."""
    row_box = rows.to(torch.int64)[csr_rows(starts, lists.shape[0])]
    return row_box, lists.to(torch.int64)


def _blocks(box_starts, box_counts, boxes, width):
    """(E, width) particle indices of *boxes* and their validity mask."""
    lane = torch.arange(width, device=boxes.device)
    idx = box_starts[boxes].to(torch.int64)[:, None] + lane
    mask = lane < box_counts[boxes].to(torch.int64)[:, None]
    return torch.where(mask, idx, torch.zeros_like(idx)), mask


def _max_count(box_counts, boxes):
    return max(1, int(box_counts[boxes].max())) if boxes.numel() else 1


def smem_bytes(order, real_dtype):
    """Dynamic shared memory a CTA of K3 and K30 takes at *order* (K4, K23,
    K28 and K29 take 4 values less): the box's 2 (p+1)^2 coefficient
    values and its centre and scale."""
    return (2 * ncoeffs(order) + 4) * torch.finfo(real_dtype).bits // 8


def _check_order(order, dtype):
    smem = smem_bytes(order, dtype)
    if smem > kernels.SMEM_MAX:
        raise ValueError(f"order {order} needs {smem} bytes of shared "
                         f"memory per CTA; the kernels take up to "
                         f"{kernels.SMEM_MAX}")


def _check_dtypes(value_dtype, real_dtype):
    """The kernels' entry points: complex128 values over float64
    geometry, or real values of the geometry's type."""
    if (value_dtype, real_dtype) not in _DTYPES:
        raise TypeError(f"no 3D Laplace kernel for {value_dtype} values "
                        f"over {real_dtype} points")


def _irregular(rel, order, cplx):
    """``S(rel)``: complex, or ``[re | im]`` pairs."""
    return irregular(rel, order) if cplx else irregular_pairs(rel, order)


# {{{ P2P

def p2p_laplace3d_plain(targets, sources, charges, box_target_starts,
                        box_target_counts_nonchild, box_source_starts,
                        box_source_counts_nonchild, target_boxes, starts,
                        lists):
    """Plain twin of :func:`p2p_laplace3d`."""
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
        r2 = (diff * diff).sum(0)                       # (E, pt, ps)
        g = torch.where(r2 > 0, 1 / torch.sqrt(torch.where(r2 > 0, r2, 1)),
                        0)
        vals = (g * q[:, None, :]).sum(-1)               # (E, pt)
        out.index_add_(0, tidx[tmask], vals[tmask])
    return out


def p2p_laplace3d(targets, sources, charges, box_target_starts,
                  box_target_counts_nonchild, box_source_starts,
                  box_source_counts_nonchild, target_boxes, starts, lists):
    """List-1 potentials (tree-order targets) of the Laplace kernel
    ``1/|t - s|`` of real or complex charges; the K2 kernel on CUDA
    tensors."""
    args = (targets, sources, charges, box_target_starts,
            box_target_counts_nonchild, box_source_starts,
            box_source_counts_nonchild, target_boxes, starts, lists)
    _check_dtypes(charges.dtype, targets.dtype)
    if targets.device.type == "cpu":
        return p2p_laplace3d_plain(*args)
    kernels.check_tensors(targets, sources, dtype=targets.dtype)
    kernels.check_tensors(charges, dtype=charges.dtype)
    kernels.check_tensors(*args[3:], dtype=torch.int32)
    out = torch.zeros(targets.shape[1], dtype=charges.dtype,
                      device=targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2p_laplace3d", charges.dtype, targets, targets.shape[1], sources,
        sources.shape[1], charges, box_target_starts,
        box_target_counts_nonchild, box_source_starts,
        box_source_counts_nonchild, target_boxes, target_boxes.shape[0],
        starts, lists, out)
    return out


def p2p_laplace3d_dipole_plain(targets, sources, charges, dipole_vec,
                               *args):
    """Plain twin of :func:`p2p_laplace3d_dipole`: the JVP of
    :func:`p2p_laplace3d_plain` in the source positions along
    *dipole_vec*."""
    return torch.func.jvp(
        lambda s: p2p_laplace3d_plain(targets, s, charges, *args),
        (sources,), (dipole_vec,))[1]


def p2p_laplace3d_dipole(targets, sources, charges, dipole_vec,
                         box_target_starts, box_target_counts_nonchild,
                         box_source_starts, box_source_counts_nonchild,
                         target_boxes, starts, lists):
    """List-1 potentials of dipole sources, ``sum q_s d_s . (t - s) / |t -
    s|^3`` (*dipole_vec* ``(3, nsources)`` in tree order); the K22 kernel
    on CUDA tensors."""
    args = (box_target_starts, box_target_counts_nonchild,
            box_source_starts, box_source_counts_nonchild, target_boxes,
            starts, lists)
    _check_dtypes(charges.dtype, targets.dtype)
    if targets.device.type == "cpu":
        return p2p_laplace3d_dipole_plain(targets, sources, charges,
                                          dipole_vec, *args)
    kernels.check_tensors(targets, sources, dipole_vec, dtype=targets.dtype)
    kernels.check_tensors(charges, dtype=charges.dtype)
    kernels.check_tensors(*args, dtype=torch.int32)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    out = torch.zeros(targets.shape[1], dtype=charges.dtype,
                      device=targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2p_laplace3d_dipole", charges.dtype, targets, targets.shape[1],
        sources, sources.shape[1], charges, dipole_vec, box_target_starts,
        box_target_counts_nonchild, box_source_starts,
        box_source_counts_nonchild, target_boxes, target_boxes.shape[0],
        starts, lists, out)
    return out

# }}}


# {{{ M2P

def m2p_laplace3d_plain(targets, box_target_starts,
                        box_target_counts_nonchild, rows, starts, lists,
                        mpoles, centers, box_scale, order):
    """Plain twin of :func:`m2p_laplace3d`."""
    out = mpoles.new_zeros(targets.shape[1])
    tbox, sbox = _edges(starts, lists, rows)
    if tbox.numel() == 0:
        return out
    k = ncoeffs(order)
    cplx = mpoles.is_complex()
    pt = _max_count(box_target_counts_nonchild, tbox)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (pt * 2 * k))
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        tidx, tmask = _blocks(box_target_starts, box_target_counts_nonchild,
                              tb, pt)
        s = box_scale[sb]
        rel = (targets[:, tidx] - centers[:, sb][..., None]) / s[:, None]
        ok = (rel * rel).sum(0) > 0
        sp = _irregular(torch.where(ok, rel, 1), order, cplx)
        mp = mpoles[sb][:, None, :]
        if cplx:
            val = (sp * mp).sum(-1)
        else:
            val = (sp[..., :k] * mp[..., :k]
                   - sp[..., k:] * mp[..., k:]).sum(-1)
        val = torch.where(ok, val, 0) / s[:, None]
        out.index_add_(0, tidx[tmask], val[tmask])
    return out


def m2p_laplace3d(targets, box_target_starts, box_target_counts_nonchild,
                  rows, starts, lists, mpoles, centers, box_scale, order):
    """List-3 potentials (tree-order targets) from the multipoles of the
    listed source boxes; rows name target boxes.  The K3 kernel on CUDA
    tensors."""
    args = (targets, box_target_starts, box_target_counts_nonchild, rows,
            starts, lists, mpoles, centers, box_scale)
    _check_dtypes(mpoles.dtype, targets.dtype)
    if targets.device.type == "cpu":
        return m2p_laplace3d_plain(*args, order)
    kernels.check_tensors(targets, centers, box_scale, dtype=targets.dtype)
    kernels.check_tensors(mpoles, dtype=mpoles.dtype)
    kernels.check_tensors(*args[1:6], dtype=torch.int32)
    _check_order(order, targets.dtype)
    out = torch.zeros(targets.shape[1], dtype=mpoles.dtype,
                      device=targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "m2p_laplace3d", mpoles.dtype, targets, targets.shape[1],
        box_target_starts, box_target_counts_nonchild, rows, rows.shape[0],
        starts, lists, mpoles, centers, centers.shape[1], box_scale, order,
        out)
    return out

# }}}


# {{{ P2L

def p2l_laplace3d_plain(sources, charges, box_source_starts,
                        box_source_counts_nonchild, rows, starts, lists,
                        centers, box_scale, order, out):
    """Plain twin of :func:`p2l_laplace3d`."""
    tbox, sbox = _edges(starts, lists, rows)
    if tbox.numel() == 0:
        return out
    k = ncoeffs(order)
    ps = _max_count(box_source_counts_nonchild, sbox)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (ps * 2 * k))
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        sidx, smask = _blocks(box_source_starts, box_source_counts_nonchild,
                              sb, ps)
        s = box_scale[tb]
        rel = (sources[:, sidx] - centers[:, tb][..., None]) / s[:, None]
        ok = (rel * rel).sum(0) > 0
        sp = _irregular(torch.where(ok, rel, 1), order, charges.is_complex())
        q = torch.where(smask, charges[sidx], 0)
        terms = torch.where(ok[..., None], sp * q[..., None], 0) \
            / s[:, None, None]
        out.index_add_(0, tb, terms.sum(1))
    return out


def _check_p2l(sources, charges, centers, box_scale, order, out, *ints):
    _check_dtypes(charges.dtype, sources.dtype)
    kernels.check_tensors(sources, centers, box_scale, dtype=sources.dtype)
    kernels.check_tensors(charges, out, dtype=charges.dtype)
    kernels.check_tensors(*ints, dtype=torch.int32)
    _check_order(order, sources.dtype)
    k = ncoeffs(order) * (1 if charges.is_complex() else 2)
    if out.shape != (centers.shape[1], k):
        raise ValueError(f"out must be (nboxes, {k})")


def p2l_laplace3d(sources, charges, box_source_starts,
                  box_source_counts_nonchild, rows, starts, lists, centers,
                  box_scale, order, out):
    """Add the List-4 local-expansion contributions of the listed source
    boxes into ``out[rows]`` (``out`` is ``(nboxes, (order+1)^2)``
    complex128, or ``(nboxes, 2 (order+1)^2)`` pairs); rows name
    target-or-target-parent boxes, each at most once.  The K4 kernel on
    CUDA tensors.  Returns *out*."""
    args = (sources, charges, box_source_starts,
            box_source_counts_nonchild, rows, starts, lists, centers,
            box_scale)
    if sources.device.type == "cpu":
        _check_dtypes(charges.dtype, sources.dtype)
        return p2l_laplace3d_plain(*args, order, out)
    _check_p2l(sources, charges, centers, box_scale, order, out, *args[2:7])
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2l_laplace3d", charges.dtype, sources, sources.shape[1], charges,
        box_source_starts, box_source_counts_nonchild, rows, rows.shape[0],
        starts, lists, centers, centers.shape[1], box_scale, order, out)
    return out


def p2l_laplace3d_dipole_plain(sources, charges, dipole_vec, *args):
    """Plain twin of :func:`p2l_laplace3d_dipole`: the JVP of
    :func:`p2l_laplace3d_plain` in the source positions along
    *dipole_vec*, added into *out* (the last of *args*)."""
    *args, out = args
    terms = torch.func.jvp(
        lambda s: p2l_laplace3d_plain(s, charges, *args,
                                      torch.zeros_like(out)),
        (sources,), (dipole_vec,))[1]
    return out.add_(terms)


def p2l_laplace3d_dipole(sources, charges, dipole_vec, box_source_starts,
                         box_source_counts_nonchild, rows, starts, lists,
                         centers, box_scale, order, out):
    """:func:`p2l_laplace3d` for dipole sources (*dipole_vec* ``(3,
    nsources)`` in tree order); the K23 kernel on CUDA tensors."""
    args = (box_source_starts, box_source_counts_nonchild, rows, starts,
            lists, centers, box_scale)
    if sources.device.type == "cpu":
        _check_dtypes(charges.dtype, sources.dtype)
        return p2l_laplace3d_dipole_plain(sources, charges, dipole_vec,
                                          *args, order, out)
    _check_p2l(sources, charges, centers, box_scale, order, out, *args[:5])
    kernels.check_tensors(sources, dipole_vec, dtype=sources.dtype)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2l_laplace3d_dipole", charges.dtype, sources, sources.shape[1],
        charges, dipole_vec, box_source_starts, box_source_counts_nonchild,
        rows, rows.shape[0], starts, lists, centers, centers.shape[1],
        box_scale, order, out)
    return out

# }}}


# {{{ P2M / L2P

def _row_particles(box_starts, box_counts, rows):
    """``(particles, boxes)``: int64 indices of the particles in the
    ranges ``[box_starts, + box_counts)`` of the boxes *rows*, row by
    row, and the box of each."""
    rows = rows.to(torch.int64)
    counts = box_counts[rows].to(torch.int64)
    box = torch.repeat_interleave(rows, counts)
    first = torch.cumsum(counts, 0) - counts
    lane = torch.arange(box.shape[0], device=rows.device) \
        - torch.repeat_interleave(first, counts)
    return box_starts[box].to(torch.int64) + lane, box


def _row_chunks(n, width):
    chunk = max(1, _PARTICLE_CHUNK_ELEMS // width)
    for c0 in range(0, n, chunk):
        yield slice(c0, min(n, c0 + chunk))


def p2m_terms(rel, q, order):
    """``(..., K)`` multipole terms ``conj(R(rel)) q`` of charges *q* at
    scaled offsets *rel* ``(3, ...)``: complex for complex charges,
    ``[Rr | -Ri] q`` pairs for real ones (``laplace.py:473-475``,
    ``:581-586``)."""
    if q.is_complex():
        return regular(rel, order).conj() * q[..., None]
    rp = regular_pairs(rel, order)
    k = ncoeffs(order)
    return torch.cat([rp[..., :k], -rp[..., k:]], dim=-1) * q[..., None]


def l2p_eval(rel, loc, order):
    """Potentials ``sum conj(R(rel)) loc`` of local coefficients *loc*
    ``(..., K)`` at scaled offsets *rel*: complex for complex coefficients,
    the real part ``Rr.lr + Ri.li`` for pairs (``laplace.py:477-479``,
    ``:588-593``)."""
    if loc.is_complex():
        return (regular(rel, order).conj() * loc).sum(-1)
    rp = regular_pairs(rel, order)
    k = ncoeffs(order)
    return (rp[..., :k] * loc[..., :k] + rp[..., k:] * loc[..., k:]).sum(-1)


def _p2m_width(order, charges):
    return ncoeffs(order) * (1 if charges.is_complex() else 2)


def p2m_laplace3d_plain(sources, charges, box_source_starts,
                        box_source_counts_nonchild, rows, centers,
                        box_scale, order):
    """Plain twin of :func:`p2m_laplace3d`."""
    width = _p2m_width(order, charges)
    out = charges.new_zeros((centers.shape[1], width))
    idx, box = _row_particles(box_source_starts, box_source_counts_nonchild,
                              rows)
    for c in _row_chunks(idx.shape[0], width):
        i, b = idx[c], box[c]
        s = box_scale[b]
        rel = (sources[:, i] - centers[:, b]) / s
        out.index_add_(0, b, p2m_terms(rel, charges[i], order))
    return out


def _check_p2m(sources, charges, centers, box_scale, order, *ints):
    _check_dtypes(charges.dtype, sources.dtype)
    kernels.check_tensors(sources, centers, box_scale, dtype=sources.dtype)
    kernels.check_tensors(charges, dtype=charges.dtype)
    kernels.check_tensors(*ints, dtype=torch.int32)
    _check_order(order, sources.dtype)


def p2m_laplace3d(sources, charges, box_source_starts,
                  box_source_counts_nonchild, rows, centers, box_scale,
                  order):
    """Multipoles ``(nboxes, (order+1)^2)`` complex128 of complex charges,
    or ``(nboxes, 2 (order+1)^2)`` ``[re | im]`` pairs of real ones, of the
    tree-order sources that the boxes *rows* own (their nonchild ranges,
    each box at most once); the other boxes' rows are zero.  The K28
    kernel on CUDA tensors."""
    args = (sources, charges, box_source_starts,
            box_source_counts_nonchild, rows, centers, box_scale, order)
    if sources.device.type == "cpu":
        _check_dtypes(charges.dtype, sources.dtype)
        return p2m_laplace3d_plain(*args)
    _check_p2m(sources, charges, centers, box_scale, order,
               box_source_starts, box_source_counts_nonchild, rows)
    out = torch.zeros((centers.shape[1], _p2m_width(order, charges)),
                      dtype=charges.dtype, device=sources.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "p2m_laplace3d", charges.dtype, sources, sources.shape[1], charges,
        box_source_starts, box_source_counts_nonchild, rows, rows.shape[0],
        centers, centers.shape[1], box_scale, order, out)
    return out


def p2m_laplace3d_dipole_plain(sources, charges, dipole_vec, *args):
    """Plain twin of :func:`p2m_laplace3d_dipole`: the JVP of
    :func:`p2m_laplace3d_plain` in the source positions along
    *dipole_vec*."""
    return torch.func.jvp(
        lambda s: p2m_laplace3d_plain(s, charges, *args),
        (sources,), (dipole_vec,))[1]


def p2m_laplace3d_dipole(sources, charges, dipole_vec, box_source_starts,
                         box_source_counts_nonchild, rows, centers,
                         box_scale, order):
    """:func:`p2m_laplace3d` for dipole sources (*dipole_vec* ``(3,
    nsources)`` in tree order); the K29 kernel on CUDA tensors."""
    args = (box_source_starts, box_source_counts_nonchild, rows, centers,
            box_scale, order)
    if sources.device.type == "cpu":
        _check_dtypes(charges.dtype, sources.dtype)
        return p2m_laplace3d_dipole_plain(sources, charges, dipole_vec,
                                          *args)
    _check_p2m(sources, charges, centers, box_scale, order,
               box_source_starts, box_source_counts_nonchild, rows)
    kernels.check_tensors(sources, dipole_vec, dtype=sources.dtype)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    out = torch.zeros((centers.shape[1], _p2m_width(order, charges)),
                      dtype=charges.dtype, device=sources.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "p2m_laplace3d_dipole", charges.dtype, sources, sources.shape[1],
        charges, dipole_vec, box_source_starts, box_source_counts_nonchild,
        rows, rows.shape[0], centers, centers.shape[1], box_scale, order,
        out)
    return out


def l2p_laplace3d_plain(targets, box_target_starts,
                        box_target_counts_nonchild, rows, local_exps,
                        centers, box_scale, order):
    """Plain twin of :func:`l2p_laplace3d`."""
    out = local_exps.new_zeros(targets.shape[1])
    idx, box = _row_particles(box_target_starts, box_target_counts_nonchild,
                              rows)
    for c in _row_chunks(idx.shape[0], local_exps.shape[1]):
        i, b = idx[c], box[c]
        s = box_scale[b]
        rel = (targets[:, i] - centers[:, b]) / s
        out[i] = l2p_eval(rel, local_exps[b], order)
    return out


def l2p_laplace3d(targets, box_target_starts, box_target_counts_nonchild,
                  rows, local_exps, centers, box_scale, order):
    """Potentials (tree-order targets) of the local expansions
    *local_exps* (complex128, or ``[re | im]`` pairs with real potentials)
    at the targets that the boxes *rows* own (their nonchild ranges, each
    box at most once); the other targets' are zero.  The K30 kernel on
    CUDA tensors."""
    args = (targets, box_target_starts, box_target_counts_nonchild, rows,
            local_exps, centers, box_scale, order)
    _check_dtypes(local_exps.dtype, targets.dtype)
    if targets.device.type == "cpu":
        return l2p_laplace3d_plain(*args)
    kernels.check_tensors(targets, centers, box_scale, dtype=targets.dtype)
    kernels.check_tensors(local_exps, dtype=local_exps.dtype)
    kernels.check_tensors(box_target_starts, box_target_counts_nonchild,
                          rows, dtype=torch.int32)
    _check_order(order, targets.dtype)
    k = ncoeffs(order) * (1 if local_exps.is_complex() else 2)
    if local_exps.shape != (centers.shape[1], k):
        raise ValueError(f"local_exps must be (nboxes, {k})")
    out = torch.zeros(targets.shape[1], dtype=local_exps.dtype,
                      device=targets.device)
    if rows.numel() == 0:
        return out
    kernels.launch(
        "l2p_laplace3d", local_exps.dtype, targets, targets.shape[1],
        box_target_starts, box_target_counts_nonchild, rows, rows.shape[0],
        local_exps, centers, centers.shape[1], box_scale, order, out)
    return out

# }}}
