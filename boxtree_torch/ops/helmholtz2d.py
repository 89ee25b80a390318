"""The particle stages of the 2D Helmholtz FMM: P2M, P2P (List 1), M2P
(List 3), P2L (List 4) and L2P, each as a kernel wrapper and its plain
twin, over the expansion basis they share, on two layouts (coordinates
float64):

- complex128: complex charges, ``(nboxes, 2p+1)`` complex coefficients
  and complex potentials (the complex wrangler);
- float64 pairs: real charges, ``(nboxes, 2 (2p+1))`` ``[re | im]``
  coefficient rows and ``(n, 2)`` ``[re, im]`` potentials (the real-pair
  wrangler, ``boxtree_tpu/models/helmholtz.py:296-418``).  Its twins work
  on real lanes only (``*_pairs``: the real ``(J, Y)`` recurrences and the
  phase as (cos, sin) lanes, ``helmholtz.py:342-418``); its kernels are
  the ``_f64`` entry points of the same kernels (K52-K56).

The layout follows the dtype of the charges or the expansions handed in.

Kernel ``G(t, s) = (i/4) H_0^(1)(k |t - s|)`` for a real wavenumber k.
Expansions about a box centre ``c``, with ``(r, th)`` the polar form of
``z - c`` and the coefficient index n running over ``-p..p``
(``boxtree_tpu/models/helmholtz.py:1-30``):

- multipole: ``phi = sum_n a_n H_n(k r) e^{i n th}``;
- local: ``phi = sum_n b_n J_n(k r) e^{i n th}``.

Scaled by the box's rscale s, a multipole coefficient is ``a_n s^-|n|``
and a local one ``b_n s^|n|``, so the bases carry ``s^+|n|`` (H) and
``s^-|n|`` (J).  Each wrapper takes the tree's particle arrays in tree
order, the per-box particle ranges ``[box_*_starts, +
box_*_counts_nonchild)`` and either a CSR list whose rows name boxes (the
list stages) or the rows alone, the boxes that own particles (P2M, L2P).
On CPU tensors it runs the plain PyTorch twin; on CUDA tensors it launches
the hand-written kernel of ``csrc/helmholtz2d.cu`` or raises.

- P2M (K33, pairs K55): ``a_n(b) = sum (i/4) q_s J_n(k r) e^{-i n th}
  s^-|n|`` over the sources box ``b`` owns, the one-hot ``J_n(0) = [n ==
  0]`` at ``r = 0`` (``helmholtz.py:267-269``; pairs ``:378``).
- L2P (K34, pairs K56): ``phi(t) = sum_n b_n(b) J_n(k r) e^{i n th}
  s^-|n|``, ``b_0(b)`` at ``r = 0`` (``helmholtz.py:271-273``; pairs
  ``:384``).
- P2P (K16, pairs K52): ``phi(t) = sum q_s (i/4) H_0(k r)``, ``r = 0``
  skipped (``helmholtz.py:284-294``; pairs ``:407``).
- M2P (K17, pairs K53): ``phi(t) += sum_n a_n(b) H_n(k r) e^{i n th}
  s^|n|`` with ``r e^{i th} = ((t - c_b) / s) s``, 0 at ``r = 0``
  (``helmholtz.py:275-277``; pairs ``:391``).
- P2L (K18, pairs K54): ``b_n(b) += (i/4) q H_n(k r) e^{-i n th} s^|n|``
  with ``r e^{i th} = ((x_s - c_b) / s) s`` (``helmholtz.py:279-282``;
  pairs ``:400``).

``s`` is the box's rscale (the source box's for M2P, the target box's for
P2L, the particle's own box's for P2M and L2P); the hooks of the reference
receive ``rel`` divided by it and work on ``rel * s``, which the twins and
the kernels repeat.  *nstart* is the start order of the J recurrence
(:func:`~boxtree_torch.ops.cylinder_bessel.miller_start` of the wrangler's
bound on ``k r``).  K17, K18, K33 and K34 keep the recurrence's ratios in
a global scratch buffer, one column a thread of a fixed grid whose CTAs
take rows from a counter (:func:`launch_grid`, :func:`scratch_bytes`), so
a large ``k r`` costs memory traffic but is never refused; only their
tables of ``2p + 1`` or ``p + 1`` values a lane stay in shared memory
(:func:`smem_bytes`).

Dipole sources (a ``(2, nsources)`` tree-order ``dipole_vec`` *d*, the
potential ``q (d . grad_y) (i/4) H_0(k |x - y|)``): P2M, P2P and P2L each
have a dipole form, the JVP of the charge form in the source positions
along *d* (``boxtree_tpu/models/expansion_base.py:664-673``,
``:1314-1324``, ``:1688-1694``), whose twin is ``torch.func.jvp`` of the
charge twin's terms (the Bessel tangents of
:func:`~boxtree_torch.ops.cylinder_bessel.cylindrical_jy`, one order up)
and whose kernel takes the ladder identity ``(d . grad)[Z_n(k r) e^{-i n
th}] = (k/2) [(d_x - i d_y) Z_{n-1} e^{-i (n-1) th} - (d_x + i d_y)
Z_{n+1} e^{-i (n+1) th}]`` (Z = J or H, orders up to p + 1) and, for P2P,
``(i/4) q k H_1(k r) d . (t - s) / r``: K63-K65 (complex128), K66-K68
(pairs).  P2M and P2L hand the terms the offset's tangent ``d / s``, as
the reference does.  At ``r = 0`` the dipole P2M takes the limit of the
tangent, ``(i/4) q (k/2) (d_x - i d_y) s^-1`` at ``n = 1`` and ``-(i/4) q
(k/2) (d_x + i d_y) s^-1`` at ``n = -1`` (*s* the box's rscale: the
multipole's ``s^-|n|``), where the reference's guard gives 0 (it drops
the dipole moment of a source on its box's centre); the dipole P2L and
P2P give 0 there, as the reference.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels
from boxtree_torch.ops.cylinder_bessel import cylindrical_jy, even_start
from boxtree_torch.ops.helmholtz3d import _is_pairs, _pot_zeros
from boxtree_torch.ops.laplace3d import (
    _blocks,
    _edges,
    _max_count,
    _row_particles,
)

#: budget of one chunk of the plain twins in elements times recurrence
#: steps: the J recurrence keeps ~nstart temporaries of its argument alive
_PLAIN_CHUNK_WORK = 1 << 27
#: the kernels' threads per CTA (one warp), as in csrc/helmholtz2d.cu
_KERNEL_THREADS = 32
#: CTAs a streaming multiprocessor of the fixed grid that K17, K18, K33 and
#: K34 take their rows with (twice what shared memory let K17 / K18 keep
#: resident when their scratch lived there: more warps to hide the
#: recurrence's latency)
_CTAS_PER_SM = 16


def _plain_chunk(width, order, nstart):
    """Rows of *width* elements a plain twin takes at once."""
    return max(1, _PLAIN_CHUNK_WORK // (width * even_start(nstart, order)))


# {{{ the basis and the per-particle terms of each stage

def coeff_orders(order, device):
    """The coefficient index ``n = -p..p`` as an int64 tensor."""
    return torch.arange(-order, order + 1, device=device)


def dpow(scale, sign, order):
    """``scale^(sign |n|)`` over the coefficient axis."""
    d = coeff_orders(order, scale.device).abs().to(scale.dtype)
    return scale[..., None] ** (sign * d)


def basis(rel, kind, conj_phase, scale, k, order, nstart):
    """``(values, ok)``: the ``(..., 2p+1)`` values of ``J_n(k r) e^{+-i n
    th} s^-|n|`` (*kind* ``"J"``) or ``H_n(k r) e^{+-i n th} s^+|n|``
    (``"H"``), n = -p..p, at the (2, ...) offsets *rel* pre-divided by
    *scale*, and ``r > 0`` (``helmholtz.py:232-265``).  Negative orders
    come from ``F_{-n} = (-1)^n F_n``; at ``r = 0`` the J kind takes its
    exact limit ``J_n(0) = [n == 0]`` (the H-kind callers mask by *ok*)."""
    vr, vi, ok = basis_pairs(rel, kind, conj_phase, scale, k, order, nstart)
    return torch.complex(vr, vi), ok


def m2p_eval(rel, mp, scale, k, order, nstart):
    """Potentials of multipoles *mp* at offsets *rel* pre-divided by
    *scale* (``helmholtz.py:275-277``)."""
    vals, ok = basis(rel, "H", +1, scale, k, order, nstart)
    return torch.where(ok, (mp * vals).sum(-1), 0)


def p2l_terms(rel, q, scale, k, order, nstart):
    """Local coefficients of charges *q* at offsets *rel* pre-divided by
    *scale* (``helmholtz.py:279-282``)."""
    vals, ok = basis(rel, "H", -1, scale, k, order, nstart)
    return torch.where(ok[..., None], 0.25j * q[..., None] * vals, 0)


def p2m_terms(rel, q, scale, k, order, nstart):
    """Multipole coefficients of charges *q* at offsets *rel* pre-divided
    by *scale* (``helmholtz.py:267-269``)."""
    vals, _ = basis(rel, "J", -1, scale, k, order, nstart)
    return 0.25j * q[..., None] * vals


def l2p_eval(rel, loc, scale, k, order, nstart):
    """Potentials of locals *loc* at offsets *rel* pre-divided by *scale*
    (``helmholtz.py:271-273``)."""
    vals, _ = basis(rel, "J", +1, scale, k, order, nstart)
    return (loc * vals).sum(-1)

# }}}


# {{{ the same on real pair lanes (helmholtz.py:342-418)

def basis_pairs(rel, kind, conj_phase, scale, k, order, nstart):
    """``(v_re, v_im, ok)``: :func:`basis` as two real ``(..., 2p+1)``
    lanes, from the real ``(J, Y)`` recurrences, with the phase as (cos,
    ``conj_phase`` sin) lanes (``helmholtz.py:342-376``)."""
    pw = dpow(scale, -1 if kind == "J" else +1, order)
    rel = rel * scale
    r = torch.sqrt(rel[0] ** 2 + rel[1] ** 2)
    ok = r > 0
    th = torch.atan2(rel[1], rel[0])
    j, y = cylindrical_jy(k * torch.where(ok, r, torch.ones_like(r)), order,
                          nstart=nstart)
    signs = (-1.0) ** torch.arange(1, order + 1, device=rel.device,
                                   dtype=rel.dtype)

    def full(base):
        return torch.cat([(base[..., 1:] * signs).flip(-1), base], dim=-1)

    ang = coeff_orders(order, rel.device).to(rel.dtype) * th[..., None]
    c, sn = torch.cos(ang), conj_phase * torch.sin(ang)
    fj = full(j)
    if kind == "J":
        vr, vi = fj * c, fj * sn
    else:
        fy = full(y)
        vr, vi = fj * c - fy * sn, fj * sn + fy * c
    vr, vi = vr * pw, vi * pw
    if kind == "J":
        # the exact r = 0 limit: J_n(0) = [n == 0]
        one_hot = torch.zeros(2 * order + 1, dtype=vr.dtype,
                              device=vr.device)
        one_hot[order] = 1.0
        vr = torch.where(ok[..., None], vr, one_hot)
        vi = torch.where(ok[..., None], vi, 0)
    return vr, vi, ok


def p2m_terms_pairs(rel, q, scale, k, order, nstart):
    """``[re | im]`` multipole coefficients of real charges *q*: ``0.25 i q
    v`` as ``(-0.25 q v_i, 0.25 q v_r)`` (``helmholtz.py:378-382``)."""
    vr, vi, _ = basis_pairs(rel, "J", -1, scale, k, order, nstart)
    qq = 0.25 * q[..., None]
    return torch.cat([-qq * vi, qq * vr], dim=-1)


def l2p_eval_pairs(rel, loc, scale, k, order, nstart):
    """``(..., 2)`` potentials of ``[re | im]`` locals *loc*
    (``helmholtz.py:384-389``)."""
    vr, vi, _ = basis_pairs(rel, "J", +1, scale, k, order, nstart)
    nc = 2 * order + 1
    lr, li = loc[..., :nc], loc[..., nc:]
    return torch.stack([(lr * vr - li * vi).sum(-1),
                        (lr * vi + li * vr).sum(-1)], dim=-1)


def m2p_eval_pairs(rel, mp, scale, k, order, nstart):
    """``(..., 2)`` potentials of ``[re | im]`` multipoles *mp*; 0 at ``r =
    0`` (``helmholtz.py:391-398``)."""
    vr, vi, ok = basis_pairs(rel, "H", +1, scale, k, order, nstart)
    nc = 2 * order + 1
    mr, mi = mp[..., :nc], mp[..., nc:]
    return torch.stack([torch.where(ok, (mr * vr - mi * vi).sum(-1), 0),
                        torch.where(ok, (mr * vi + mi * vr).sum(-1), 0)],
                       dim=-1)


def p2l_terms_pairs(rel, q, scale, k, order, nstart):
    """``[re | im]`` local coefficients of real charges *q*; 0 at ``r = 0``
    (``helmholtz.py:400-405``)."""
    vr, vi, ok = basis_pairs(rel, "H", -1, scale, k, order, nstart)
    qq = 0.25 * q[..., None]
    okc = ok[..., None]
    return torch.cat([torch.where(okc, -qq * vi, 0),
                      torch.where(okc, qq * vr, 0)], dim=-1)

# }}}


# {{{ the dipole terms: JVPs of the terms in the offsets

def _p2m_limit(rel, dip, scale, k):
    """``(ok, lim)``: ``r > 0`` at offsets *rel* pre-divided by *scale*,
    and where ``r = 0`` the limit of the tangent of ``J_n(k r) e^{-i n th}
    s^-|n|`` along the offset tangent *dip* (pre-divided too) as ``r ->
    0``, complex ``(..., 2)`` at ``n = -1, 1``: ``J_{+-1}(k r) e^{-+i th} =
    +-(k/2) (x -+ i y) + O(r^3)`` and the other orders' tangents vanish."""
    x = rel * scale
    ok = x[0] ** 2 + x[1] ** 2 > 0
    d = dip * scale
    half_k = (0.5 * k) / scale
    return ok, torch.stack([-half_k * torch.complex(d[0], d[1]),
                            half_k * torch.complex(d[0], -d[1])], dim=-1)


def p2m_dipole_terms(rel, dip, q, scale, k, order, nstart):
    """Multipole terms of dipole sources: the JVP of :func:`p2m_terms` in
    *rel* along *dip* (both pre-divided by *scale*), and at ``r = 0`` the
    limit of that tangent (:func:`_p2m_limit`), where the reference's
    guard gives 0."""
    t = torch.func.jvp(
        lambda r: p2m_terms(r, q, scale, k, order, nstart), (rel,),
        (dip,))[1]
    if order >= 1:
        ok, lim = _p2m_limit(rel, dip, scale, k)
        sl = slice(order - 1, order + 2, 2)
        t[..., sl] = torch.where(ok[..., None], t[..., sl],
                                 0.25j * q[..., None] * lim)
    return t


def p2m_dipole_terms_pairs(rel, dip, q, scale, k, order, nstart):
    """:func:`p2m_dipole_terms` on pair lanes: the JVP of
    :func:`p2m_terms_pairs`, the limit at ``r = 0`` as ``(-0.25 q Im lim,
    0.25 q Re lim)``."""
    t = torch.func.jvp(
        lambda r: p2m_terms_pairs(r, q, scale, k, order, nstart), (rel,),
        (dip,))[1]
    if order < 1:
        return t
    ok, lim = _p2m_limit(rel, dip, scale, k)
    qq = 0.25 * q[..., None]
    okc = ok[..., None]
    nc = 2 * order + 1
    re, im = slice(order - 1, order + 2, 2), slice(nc + order - 1,
                                                   nc + order + 2, 2)
    t[..., re] = torch.where(okc, t[..., re], -qq * lim.imag)
    t[..., im] = torch.where(okc, t[..., im], qq * lim.real)
    return t


def p2l_dipole_terms(rel, dip, q, scale, k, order, nstart):
    """Local terms of dipole sources: the JVP of :func:`p2l_terms` in
    *rel* along *dip* (both pre-divided by *scale*); 0 at ``r = 0``."""
    return torch.func.jvp(
        lambda r: p2l_terms(r, q, scale, k, order, nstart), (rel,),
        (dip,))[1]


def p2l_dipole_terms_pairs(rel, dip, q, scale, k, order, nstart):
    """:func:`p2l_dipole_terms` on pair lanes (:func:`p2l_terms_pairs`)."""
    return torch.func.jvp(
        lambda r: p2l_terms_pairs(r, q, scale, k, order, nstart), (rel,),
        (dip,))[1]

# }}}


def _width(order, dtype):
    """Values of *dtype* in one coefficient row."""
    return (2 * order + 1) * (2 if _is_pairs(dtype) else 1)


def smem_bytes(name, order, dipole=False):
    """Shared memory of one CTA of K17 (``"m2p"``), K18 (``"p2l"``), K33
    (``"p2m"``) or K34 (``"l2p"``), as ``csrc/helmholtz2d.cu`` sizes it: a
    table of the p + 1 radial values (H: complex; J: real) a thread, and
    the box's expansion and geometry (K17, K34), each thread's terms and
    their sums (K18), or the box's sums (K33).  With *dipole*, of the
    dipole P2L (K65 / K68) or P2M (K63 / K66), whose tables hold p + 2
    values."""
    nc = 2 * order + 1
    rows = order + (2 if dipole else 1)
    if name in ("m2p", "p2l"):
        table = rows * _KERNEL_THREADS * 16
        if name == "p2l":
            return table + nc * (_KERNEL_THREADS + 1) * 16
        return table + nc * 16 + 3 * 8
    table = rows * _KERNEL_THREADS * 8
    return table + nc * 16 + (3 * 8 if name == "l2p" else 0)


def launch_grid(device, nrows):
    """CTAs of the fixed grid K17, K18, K33 and K34 launch over *nrows*
    rows on *device*: a few an SM, never more than the rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(int(nrows), _CTAS_PER_SM * sms)


def scratch_bytes(grid, order, nstart):
    """Bytes of the ratio scratch of one launch on *grid* CTAs: the
    recurrence's ``even_start(nstart, order)`` ratios for each thread (a
    dipole P2M or P2L runs its recurrence to order p + 1: pass that)."""
    return even_start(nstart, order) * grid * _KERNEL_THREADS * 8


def _launch_scratch(device, nrows, order, nstart):
    """``(grid, scratch, counter)`` of one launch: the grid, its ratio
    buffer, ``(ns, grid x 32)`` float64, one column a thread, and the
    zeroed int32 counter its CTAs take rows from."""
    grid = launch_grid(device, nrows)
    ns = even_start(nstart, order)
    return (grid, torch.empty((ns, grid * _KERNEL_THREADS),
                              dtype=torch.float64, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def _check_args(k, dtype, order=None, dipole=False):
    """The kernels' dtypes and wavenumber, and at *order* their shared
    memory a CTA: that of K17, K18, K33 and K34, or with *dipole* that of
    the dipole P2M and P2L, in up to 227 KiB."""
    if dtype not in (torch.float64, torch.complex128):
        raise TypeError("the Helmholtz kernels take complex128 or float64 "
                        f"pairs, not {dtype}")
    if not isinstance(k, float):
        raise TypeError("the Helmholtz kernels take a real wavenumber")
    if order is not None:
        names = ("p2l", "p2m") if dipole else ("m2p", "p2l", "p2m", "l2p")
        smem = max(smem_bytes(name, order, dipole) for name in names)
        if smem > kernels.SMEM_MAX:
            raise ValueError(
                f"order {order} needs {smem} bytes of shared memory per "
                "CTA; the kernels take up to 227 KiB")


# {{{ P2P

def p2p_helmholtz2d_plain(targets, sources, charges, box_target_starts,
                          box_target_counts_nonchild, box_source_starts,
                          box_source_counts_nonchild, target_boxes, starts,
                          lists, k, nstart):
    """Plain twin of :func:`p2p_helmholtz2d`."""
    out = _pot_zeros(targets.shape[1], charges.dtype, charges.device)
    tbox, sbox = _edges(starts, lists, target_boxes)
    if tbox.numel() == 0:
        return out
    pt = _max_count(box_target_counts_nonchild, tbox)
    ps = _max_count(box_source_counts_nonchild, sbox)
    chunk = _plain_chunk(pt * ps, 0, nstart)
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb_ = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        tidx, tmask = _blocks(box_target_starts, box_target_counts_nonchild,
                              tb, pt)
        sidx, smask = _blocks(box_source_starts, box_source_counts_nonchild,
                              sb_, ps)
        q = torch.where(smask, charges[sidx], 0)
        diff = targets[:, tidx][..., :, None] - sources[:, sidx][..., None, :]
        r = torch.sqrt((diff * diff).sum(0))             # (E, pt, ps)
        ok = (r > 0) & smask[:, None, :]
        j, y = cylindrical_jy(k * torch.where(ok, r, torch.ones_like(r)), 0,
                              nstart=nstart)
        if _is_pairs(charges.dtype):
            # 0.25 i (J_0 + i Y_0) = (-0.25 Y_0, 0.25 J_0)
            gr = torch.where(ok, -0.25 * y[..., 0], 0)
            gi = torch.where(ok, 0.25 * j[..., 0], 0)
            vals = torch.stack([(gr * q[:, None, :]).sum(-1),
                                (gi * q[:, None, :]).sum(-1)], -1)
        else:
            g = torch.where(ok, 0.25j * torch.complex(j[..., 0], y[..., 0]),
                            0)
            vals = (g * q[:, None, :]).sum(-1)           # (E, pt)
        out.index_add_(0, tidx[tmask], vals[tmask])
    return out


def p2p_helmholtz2d(targets, sources, charges, box_target_starts,
                    box_target_counts_nonchild, box_source_starts,
                    box_source_counts_nonchild, target_boxes, starts, lists,
                    k, nstart):
    """List-1 potentials (tree-order targets) of ``(i/4) H_0(k |t - s|)``:
    complex128 for complex128 charges, ``(n, 2)`` float64 for real float64
    charges.  The K16 kernel (pairs: K52) on CUDA tensors.  The kernel
    evaluates ``H_0`` with CUDA's double ``j0``/``y0``, the twin with the J
    recurrence from *nstart* (as the reference)."""
    args = (targets, sources, charges, box_target_starts,
            box_target_counts_nonchild, box_source_starts,
            box_source_counts_nonchild, target_boxes, starts, lists)
    if targets.device.type == "cpu":
        return p2p_helmholtz2d_plain(*args, k, nstart)
    dt = charges.dtype
    _check_args(k, dt)
    kernels.check_tensors(targets, sources, dtype=torch.float64)
    kernels.check_tensors(charges, dtype=dt)
    kernels.check_tensors(*args[3:], dtype=torch.int32)
    out = _pot_zeros(targets.shape[1], dt, targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2p_helmholtz2d", dt, targets, targets.shape[1],
        sources, sources.shape[1], charges, box_target_starts,
        box_target_counts_nonchild, box_source_starts,
        box_source_counts_nonchild, target_boxes, target_boxes.shape[0],
        starts, lists, k, out)
    return out


def p2p_helmholtz2d_dipole_plain(targets, sources, charges, dipole_vec,
                                 *args):
    """Plain twin of :func:`p2p_helmholtz2d_dipole`: the JVP of
    :func:`p2p_helmholtz2d_plain` in the source positions along
    *dipole_vec*."""
    return torch.func.jvp(
        lambda s: p2p_helmholtz2d_plain(targets, s, charges, *args),
        (sources,), (dipole_vec,))[1]


def p2p_helmholtz2d_dipole(targets, sources, charges, dipole_vec,
                           box_target_starts, box_target_counts_nonchild,
                           box_source_starts, box_source_counts_nonchild,
                           target_boxes, starts, lists, k, nstart):
    """List-1 potentials of dipole sources, ``sum q_s (d_s . grad_s) (i/4)
    H_0(k |t - s|) = sum q_s (i/4) k H_1(k r) d_s . (t - s) / r`` (*dipole_vec*
    ``(2, nsources)`` in tree order; ``r = 0`` skipped), in
    :func:`p2p_helmholtz2d`'s layouts.  The K64 kernel (pairs: K67) on CUDA
    tensors, with CUDA's double ``j1``/``y1``."""
    args = (box_target_starts, box_target_counts_nonchild,
            box_source_starts, box_source_counts_nonchild, target_boxes,
            starts, lists)
    if targets.device.type == "cpu":
        return p2p_helmholtz2d_dipole_plain(targets, sources, charges,
                                            dipole_vec, *args, k, nstart)
    dt = charges.dtype
    _check_args(k, dt)
    kernels.check_tensors(targets, sources, dipole_vec, dtype=torch.float64)
    kernels.check_tensors(charges, dtype=dt)
    kernels.check_tensors(*args, dtype=torch.int32)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    out = _pot_zeros(targets.shape[1], dt, targets.device)
    if lists.numel() == 0:
        return out
    kernels.launch(
        "p2p_helmholtz2d_dipole", dt, targets, targets.shape[1], sources,
        sources.shape[1], charges, dipole_vec, box_target_starts,
        box_target_counts_nonchild, box_source_starts,
        box_source_counts_nonchild, target_boxes, target_boxes.shape[0],
        starts, lists, k, out)
    return out

# }}}


# {{{ M2P

def m2p_helmholtz2d_plain(targets, box_target_starts,
                          box_target_counts_nonchild, rows, starts, lists,
                          mpoles, centers, box_scale, k, order, nstart):
    """Plain twin of :func:`m2p_helmholtz2d`."""
    out = _pot_zeros(targets.shape[1], mpoles.dtype, mpoles.device)
    evaluate = m2p_eval_pairs if _is_pairs(mpoles.dtype) else m2p_eval
    tbox, sbox = _edges(starts, lists, rows)
    if tbox.numel() == 0:
        return out
    pt = _max_count(box_target_counts_nonchild, tbox)
    chunk = _plain_chunk(pt * (2 * order + 1), order, nstart)
    for c0 in range(0, tbox.shape[0], chunk):
        tb, sb_ = tbox[c0:c0 + chunk], sbox[c0:c0 + chunk]
        tidx, tmask = _blocks(box_target_starts, box_target_counts_nonchild,
                              tb, pt)
        s = box_scale[sb_][:, None]                      # (E, 1)
        rel = (targets[:, tidx] - centers[:, sb_][..., None]) / s
        val = evaluate(rel, mpoles[sb_][:, None, :], s.expand(rel.shape[1:]),
                       k, order, nstart)
        out.index_add_(0, tidx[tmask], val[tmask])
    return out


def m2p_helmholtz2d(targets, box_target_starts, box_target_counts_nonchild,
                    rows, starts, lists, mpoles, centers, box_scale, k,
                    order, nstart):
    """List-3 potentials (tree-order targets) from the multipoles of the
    listed source boxes, complex128 or ``[re | im]`` float64 rows (then
    ``(n, 2)`` potentials); rows name target boxes.  The K17 kernel
    (pairs: K53) on CUDA tensors."""
    args = (targets, box_target_starts, box_target_counts_nonchild, rows,
            starts, lists, mpoles, centers, box_scale)
    if targets.device.type == "cpu":
        return m2p_helmholtz2d_plain(*args, k, order, nstart)
    dt = mpoles.dtype
    _check_args(k, dt, order)
    kernels.check_tensors(targets, centers, box_scale, dtype=torch.float64)
    kernels.check_tensors(mpoles, dtype=dt)
    kernels.check_tensors(*args[1:6], dtype=torch.int32)
    if mpoles.shape != (centers.shape[1], _width(order, dt)):
        raise ValueError("mpoles must be (nboxes, 2 * order + 1), twice that "
                         "in pairs")
    out = _pot_zeros(targets.shape[1], dt, targets.device)
    if lists.numel() == 0:
        return out
    grid, scratch, counter = _launch_scratch(targets.device, rows.shape[0],
                                             order, nstart)
    kernels.launch(
        "m2p_helmholtz2d", dt, targets, targets.shape[1],
        box_target_starts, box_target_counts_nonchild, rows, rows.shape[0],
        starts, lists, mpoles, centers, centers.shape[1], box_scale, k,
        order, even_start(nstart, order), grid, scratch, counter, out)
    return out

# }}}


# {{{ P2L

def _p2l_plain(sources, charges, dipole_vec, box_source_starts,
               box_source_counts_nonchild, rows, starts, lists, centers,
               box_scale, k, order, nstart, out):
    """The plain P2L of charges (*dipole_vec* None) or dipoles."""
    tbox, sbox = _edges(starts, lists, rows)
    if tbox.numel() == 0:
        return out
    pairs = _is_pairs(out.dtype)
    ps = _max_count(box_source_counts_nonchild, sbox)
    chunk = _plain_chunk(ps * (2 * order + 1), order, nstart)
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
                rel, q, scale, k, order, nstart)
        else:
            terms = (p2l_dipole_terms_pairs if pairs else p2l_dipole_terms)(
                rel, dipole_vec[:, sidx] / s, q, scale, k, order, nstart)
        terms = torch.where(smask[..., None], terms, 0)
        out.index_add_(0, tb, terms.sum(1))
    return out


def p2l_helmholtz2d_plain(sources, charges, *args):
    """Plain twin of :func:`p2l_helmholtz2d`."""
    return _p2l_plain(sources, charges, None, *args)


def p2l_helmholtz2d(sources, charges, box_source_starts,
                    box_source_counts_nonchild, rows, starts, lists, centers,
                    box_scale, k, order, nstart, out):
    """Add the List-4 local-expansion contributions of the listed source
    boxes into ``out[rows]`` (``out`` is ``(nboxes, 2 order + 1)``
    complex128, or ``(nboxes, 2 (2 order + 1))`` ``[re | im]`` float64 with
    real charges); rows name target-or-target-parent boxes, each at most
    once.  The K18 kernel (pairs: K54) on CUDA tensors.  Returns *out*."""
    args = (sources, charges, box_source_starts,
            box_source_counts_nonchild, rows, starts, lists, centers,
            box_scale)
    if sources.device.type == "cpu":
        return p2l_helmholtz2d_plain(*args, k, order, nstart, out)
    dt = out.dtype
    _check_args(k, dt, order)
    kernels.check_tensors(sources, centers, box_scale, dtype=torch.float64)
    kernels.check_tensors(charges, out, dtype=dt)
    kernels.check_tensors(*args[2:7], dtype=torch.int32)
    if out.shape != (centers.shape[1], _width(order, dt)):
        raise ValueError("out must be (nboxes, 2 * order + 1), twice that "
                         "in pairs")
    if lists.numel() == 0:
        return out
    grid, scratch, counter = _launch_scratch(sources.device, rows.shape[0],
                                             order, nstart)
    kernels.launch(
        "p2l_helmholtz2d", dt, sources, sources.shape[1],
        charges, box_source_starts, box_source_counts_nonchild, rows,
        rows.shape[0], starts, lists, centers, centers.shape[1], box_scale,
        k, order, even_start(nstart, order), grid, scratch, counter, out)
    return out


def p2l_helmholtz2d_dipole_plain(sources, charges, dipole_vec, *args):
    """Plain twin of :func:`p2l_helmholtz2d_dipole`: per (source, target
    box) the JVP of the twin's terms in the source position along
    *dipole_vec* (:func:`p2l_dipole_terms`), added into *out* (the last of
    *args*)."""
    return _p2l_plain(sources, charges, dipole_vec, *args)


def p2l_helmholtz2d_dipole(sources, charges, dipole_vec, box_source_starts,
                           box_source_counts_nonchild, rows, starts, lists,
                           centers, box_scale, k, order, nstart, out):
    """:func:`p2l_helmholtz2d` for dipole sources (*dipole_vec* ``(2,
    nsources)`` in tree order).  The K65 kernel (pairs: K68) on CUDA
    tensors, its recurrence run to order p + 1.  Returns *out*."""
    args = (box_source_starts, box_source_counts_nonchild, rows, starts,
            lists, centers, box_scale)
    if sources.device.type == "cpu":
        return p2l_helmholtz2d_dipole_plain(sources, charges, dipole_vec,
                                            *args, k, order, nstart, out)
    dt = out.dtype
    _check_args(k, dt, order, dipole=True)
    kernels.check_tensors(sources, dipole_vec, centers, box_scale,
                          dtype=torch.float64)
    kernels.check_tensors(charges, out, dtype=dt)
    kernels.check_tensors(*args[:5], dtype=torch.int32)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    if out.shape != (centers.shape[1], _width(order, dt)):
        raise ValueError("out must be (nboxes, 2 * order + 1), twice that "
                         "in pairs")
    if lists.numel() == 0:
        return out
    grid, scratch, counter = _launch_scratch(sources.device, rows.shape[0],
                                             order + 1, nstart)
    kernels.launch(
        "p2l_helmholtz2d_dipole", dt, sources, sources.shape[1], charges,
        dipole_vec, box_source_starts, box_source_counts_nonchild, rows,
        rows.shape[0], starts, lists, centers, centers.shape[1], box_scale,
        k, order, even_start(nstart, order + 1), grid, scratch, counter,
        out)
    return out

# }}}


# {{{ P2M / L2P

def _p2m_plain(sources, charges, dipole_vec, box_source_starts,
               box_source_counts_nonchild, rows, centers, box_scale, k,
               order, nstart):
    """The plain P2M of charges (*dipole_vec* None) or dipoles."""
    pairs = _is_pairs(charges.dtype)
    nc = _width(order, charges.dtype)
    out = charges.new_zeros((centers.shape[1], nc))
    idx, box = _row_particles(box_source_starts, box_source_counts_nonchild,
                              rows)
    chunk = _plain_chunk(nc, order, nstart)
    for c0 in range(0, idx.shape[0], chunk):
        i, b = idx[c0:c0 + chunk], box[c0:c0 + chunk]
        s = box_scale[b]
        rel = (sources[:, i] - centers[:, b]) / s
        if dipole_vec is None:
            terms = (p2m_terms_pairs if pairs else p2m_terms)(
                rel, charges[i], s, k, order, nstart)
        else:
            terms = (p2m_dipole_terms_pairs if pairs else p2m_dipole_terms)(
                rel, dipole_vec[:, i] / s, charges[i], s, k, order, nstart)
        out.index_add_(0, b, terms)
    return out


def p2m_helmholtz2d_plain(sources, charges, *args):
    """Plain twin of :func:`p2m_helmholtz2d`."""
    return _p2m_plain(sources, charges, None, *args)


def p2m_helmholtz2d(sources, charges, box_source_starts,
                    box_source_counts_nonchild, rows, centers, box_scale, k,
                    order, nstart):
    """Multipoles of the tree-order sources that the boxes *rows* own
    (their nonchild ranges, each box at most once): ``(nboxes, 2 order +
    1)`` complex128 for complex128 charges, ``(nboxes, 2 (2 order + 1))``
    ``[re | im]`` float64 for real float64 ones; the other boxes' rows are
    zero.  The K33 kernel (pairs: K55) on CUDA tensors."""
    args = (sources, charges, box_source_starts,
            box_source_counts_nonchild, rows, centers, box_scale)
    if sources.device.type == "cpu":
        return p2m_helmholtz2d_plain(*args, k, order, nstart)
    dt = charges.dtype
    _check_args(k, dt, order)
    kernels.check_tensors(sources, centers, box_scale, dtype=torch.float64)
    kernels.check_tensors(charges, dtype=dt)
    kernels.check_tensors(box_source_starts, box_source_counts_nonchild,
                          rows, dtype=torch.int32)
    out = torch.zeros((centers.shape[1], _width(order, dt)), dtype=dt,
                      device=sources.device)
    if rows.numel() == 0:
        return out
    grid, scratch, counter = _launch_scratch(sources.device, rows.shape[0],
                                             order, nstart)
    kernels.launch(
        "p2m_helmholtz2d", dt, sources, sources.shape[1],
        charges, box_source_starts, box_source_counts_nonchild, rows,
        rows.shape[0], centers, centers.shape[1], box_scale, k, order,
        even_start(nstart, order), grid, scratch, counter, out)
    return out


def p2m_helmholtz2d_dipole_plain(sources, charges, dipole_vec, *args):
    """Plain twin of :func:`p2m_helmholtz2d_dipole`: per source the JVP of
    the twin's terms in its position along *dipole_vec*, and the limit of
    that tangent for a source at its box's centre
    (:func:`p2m_dipole_terms`)."""
    return _p2m_plain(sources, charges, dipole_vec, *args)


def p2m_helmholtz2d_dipole(sources, charges, dipole_vec, box_source_starts,
                           box_source_counts_nonchild, rows, centers,
                           box_scale, k, order, nstart):
    """:func:`p2m_helmholtz2d` for dipole sources (*dipole_vec* ``(2,
    nsources)`` in tree order); a source at its box's centre adds the
    limit of its tangent (see the module doc).  The K63 kernel (pairs:
    K66) on CUDA tensors, its recurrence run to order p + 1."""
    args = (box_source_starts, box_source_counts_nonchild, rows, centers,
            box_scale)
    if sources.device.type == "cpu":
        return p2m_helmholtz2d_dipole_plain(sources, charges, dipole_vec,
                                            *args, k, order, nstart)
    dt = charges.dtype
    _check_args(k, dt, order, dipole=True)
    kernels.check_tensors(sources, dipole_vec, centers, box_scale,
                          dtype=torch.float64)
    kernels.check_tensors(charges, dtype=dt)
    kernels.check_tensors(*args[:3], dtype=torch.int32)
    if dipole_vec.shape != sources.shape:
        raise ValueError("dipole_vec must be shaped like the sources")
    out = torch.zeros((centers.shape[1], _width(order, dt)), dtype=dt,
                      device=sources.device)
    if rows.numel() == 0:
        return out
    grid, scratch, counter = _launch_scratch(sources.device, rows.shape[0],
                                             order + 1, nstart)
    kernels.launch(
        "p2m_helmholtz2d_dipole", dt, sources, sources.shape[1], charges,
        dipole_vec, box_source_starts, box_source_counts_nonchild, rows,
        rows.shape[0], centers, centers.shape[1], box_scale, k, order,
        even_start(nstart, order + 1), grid, scratch, counter, out)
    return out


def l2p_helmholtz2d_plain(targets, box_target_starts,
                          box_target_counts_nonchild, rows, local_exps,
                          centers, box_scale, k, order, nstart):
    """Plain twin of :func:`l2p_helmholtz2d`."""
    out = _pot_zeros(targets.shape[1], local_exps.dtype, local_exps.device)
    evaluate = l2p_eval_pairs if _is_pairs(local_exps.dtype) else l2p_eval
    idx, box = _row_particles(box_target_starts, box_target_counts_nonchild,
                              rows)
    chunk = _plain_chunk(local_exps.shape[1], order, nstart)
    for c0 in range(0, idx.shape[0], chunk):
        i, b = idx[c0:c0 + chunk], box[c0:c0 + chunk]
        s = box_scale[b]
        rel = (targets[:, i] - centers[:, b]) / s
        out[i] = evaluate(rel, local_exps[b], s, k, order, nstart)
    return out


def l2p_helmholtz2d(targets, box_target_starts, box_target_counts_nonchild,
                    rows, local_exps, centers, box_scale, k, order, nstart):
    """Potentials (tree-order targets) of the local expansions
    *local_exps* (complex128, or ``[re | im]`` float64 rows, then ``(n,
    2)`` potentials) at the targets that the boxes *rows* own (their
    nonchild ranges, each box at most once); the other targets' are zero.
    The K34 kernel (pairs: K56) on CUDA tensors."""
    args = (targets, box_target_starts, box_target_counts_nonchild, rows,
            local_exps, centers, box_scale)
    if targets.device.type == "cpu":
        return l2p_helmholtz2d_plain(*args, k, order, nstart)
    dt = local_exps.dtype
    _check_args(k, dt, order)
    kernels.check_tensors(targets, centers, box_scale, dtype=torch.float64)
    kernels.check_tensors(local_exps, dtype=dt)
    kernels.check_tensors(box_target_starts, box_target_counts_nonchild,
                          rows, dtype=torch.int32)
    if local_exps.shape != (centers.shape[1], _width(order, dt)):
        raise ValueError("local_exps must be (nboxes, 2 * order + 1), twice "
                         "that in pairs")
    out = _pot_zeros(targets.shape[1], dt, targets.device)
    if rows.numel() == 0:
        return out
    grid, scratch, counter = _launch_scratch(targets.device, rows.shape[0],
                                             order, nstart)
    kernels.launch(
        "l2p_helmholtz2d", dt, targets, targets.shape[1],
        box_target_starts, box_target_counts_nonchild, rows, rows.shape[0],
        local_exps, centers, centers.shape[1], box_scale, k, order,
        even_start(nstart, order), grid, scratch, counter, out)
    return out

# }}}
