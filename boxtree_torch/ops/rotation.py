"""The rotation ("point-and-shoot") M2L of the 3D Laplace wranglers, and
the classification of List 2's edges by (level, translation class) that
it runs on.

- Classification (``boxtree_tpu/models/particle_blocks.py:214``
  ``M2LPlan._classify_dev``): each List-2 edge gets the packed key
  ``((level * nclasses + class) << bits) | edge`` (``npossible`` for an
  edge outside the translation window), the keys are sorted, and the
  sorted keys give the edges' target and source boxes in operator order
  and the histogram of the operator keys.  :func:`classify_edges` runs
  K75 (the keys), ``torch.sort`` (the reference's ``lax.sort``) and K76
  (the boxes and the histogram) on CUDA tensors; its twin
  :func:`classify_edges_plain` the reference's steps in torch.
- M2L (``boxtree_tpu/models/rotation_m2l.py:221`` ``RotationM2L.apply``
  as ``expansion_base.py:1135`` ``multipole_to_local_edges`` drives it):
  each edge's multipole row, as a row vector, is rotated per degree ``n``
  by its rotation class's ``(2n+1)^2`` block ``W_S^-1``, translated along
  z by its operator's axial blocks (one ``(p+1-|m|)^2`` block per ``m``),
  unrotated per degree by ``conj(W_A)`` and added into its target's local
  row.  :func:`m2l_rotation` launches K77-K79 (``_c128``, ``_f64``,
  ``_f32``) once on CUDA tensors; its twin :func:`m2l_rotation_plain`
  gathers the rows of each operator's edges and runs the three stages as
  matmuls per degree and per ``m``, then ``index_add_``.

Blocks (:class:`RotationBlocks`) are complex128 and laid out for right
multiplication of row vectors (``y[j] = sum_k x[k] B[k, j]``): the
rotation blocks once per rotation class, degree after degree, each
row-major; the axial blocks once per operator, ``m = -p .. p``, each
``A_m[n' - |m|, n - |m|]`` taking coefficient ``(n', -m)`` to ``(n, m)``.
Real-pair rows (``[re | im]``) take the same complex arithmetic: the
twin expands each block ``B`` to ``[[Br, Bi], [-Bi, Br]]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from boxtree_torch.ops import kernels, morton
from boxtree_torch.traversal.containers import csr_rows

_DTYPES = (torch.float32, torch.float64, torch.complex128)
#: edges of one tile of K77-K79 at most
MAX_TILE = 64
#: shared memory a tile's two row buffers may take (two CTAs an SM)
_TILE_SMEM = 100 * 1024


def key_bits(nedges):
    """Bits of the edge index in the packed keys (``particle_blocks.py``)."""
    return max(1, int(nedges - 1).bit_length())


# {{{ classification (K75, K76)

def classify_edges_plain(prefixes, box_levels, starts, lists, totp, table,
                         *, dim, radius, nclasses, npossible):
    """Plain twin of :func:`classify_edges`, the reference's steps."""
    nedges = lists.shape[0]
    width = 2 * radius + 1
    rows = csr_rows(starts, nedges)
    tgt = totp.to(torch.int64)[rows]
    src = lists.to(torch.int64)
    cells = morton.deinterleave(prefixes, dim)
    dvec = cells[:, tgt] - cells[:, src]
    idx = torch.zeros(nedges, dtype=torch.int64, device=lists.device)
    for a in range(dim):
        idx = idx + (dvec[a] + radius) * width ** a
    in_range = ((dvec + radius >= 0) & (dvec + radius < width)).all(dim=0)
    cls = torch.where(in_range, table[idx.clamp(0, table.shape[0] - 1)], -1)
    opkey = torch.where(cls >= 0, box_levels.to(torch.int64)[tgt] * nclasses
                        + cls, npossible)
    bits = key_bits(nedges)
    packed = (opkey << bits) | torch.arange(nedges, dtype=torch.int64,
                                            device=lists.device)
    skey = torch.sort(packed).values
    eidx = skey & ((1 << bits) - 1)
    okey = skey >> bits
    bounds = torch.arange(npossible + 2, dtype=torch.int64,
                          device=lists.device)
    cuts = torch.searchsorted(okey, bounds)
    hist = cuts[1:] - cuts[:-1]
    return (tgt[eidx].to(torch.int32), src[eidx].to(torch.int32), hist)


def classify_edges(prefixes, box_levels, starts, lists, totp, table, *, dim,
                   radius, nclasses, npossible):
    """List 2's edges (``starts``, ``lists`` over the rows ``totp``) in
    (level, class) order: ``(tgt, src, hist)``, the edges' target and
    source boxes (int32) and the ``(npossible + 1,)`` int64 counts of the
    operator keys, the last for edges outside the window.  *table* maps
    the window's offsets (axis 0 fastest, each shifted by *radius*) to
    their class, -1 for none.  The twin on CPU tensors; on CUDA K75, one
    ``torch.sort`` and K76."""
    if lists.device.type == "cpu":
        return classify_edges_plain(
            prefixes, box_levels, starts, lists, totp, table, dim=dim,
            radius=radius, nclasses=nclasses, npossible=npossible)
    kernels.check_tensors(prefixes, table, dtype=torch.int64)
    kernels.check_tensors(box_levels, starts, lists, totp, dtype=torch.int32)
    nedges = lists.shape[0]
    nrows = starts.shape[0] - 1
    dev = lists.device
    bits = key_bits(nedges)
    if (npossible + 1) >> (62 - bits):
        raise ValueError("List 2 is too long for packed keys")
    keys = torch.empty(nedges, dtype=torch.int64, device=dev)
    tgt = torch.empty(nedges, dtype=torch.int32, device=dev)
    src = torch.empty(nedges, dtype=torch.int32, device=dev)
    hist = torch.zeros(npossible + 1, dtype=torch.int64, device=dev)
    if nedges == 0:
        return tgt, src, hist
    kernels.launch("m2l_classify_keys", None, prefixes, box_levels, starts,
                   lists, totp, table, nedges, nrows, dim, radius, nclasses,
                   npossible, bits, keys)
    keys = torch.sort(keys).values
    kernels.launch("m2l_classify_unpack", None, keys, starts, lists, totp,
                   nedges, nrows, bits, tgt, src, hist)
    return tgt, src, hist

# }}}


# {{{ edge groups and blocks

@dataclasses.dataclass
class EdgeGroups:
    """List 2's edges sorted by operator: ``tgt`` / ``src`` (int32, on the
    device) and the edges of each operator, ``sizes`` (host int64)."""

    tgt: Any
    src: Any
    sizes: np.ndarray
    _tiles: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nedges(self):
        return int(self.tgt.shape[0])

    def tiles(self, tile):
        """``(tile_op, tile_start, tile_len)`` int32 on the device: each
        operator's edges cut into runs of at most *tile*; cached."""
        if tile not in self._tiles:
            sizes = np.asarray(self.sizes, np.int64)
            ntile = -(-sizes // tile)
            op = np.repeat(np.arange(len(sizes)), ntile)
            first = np.concatenate([[0], np.cumsum(sizes)])[:-1]
            k = np.arange(int(ntile.sum())) - np.repeat(
                np.concatenate([[0], np.cumsum(ntile)])[:-1], ntile)
            start = first[op] + k * tile
            length = np.minimum(tile, sizes[op] - k * tile)
            dev = self.tgt.device
            self._tiles[tile] = tuple(
                torch.as_tensor(a.astype(np.int32), device=dev)
                for a in (op, start, length))
        return self._tiles[tile]

    def select(self, ops):
        """The edges of the operators *ops* only (the others get none)."""
        sizes = np.asarray(self.sizes, np.int64)
        first = np.concatenate([[0], np.cumsum(sizes)])
        keep = np.zeros(len(sizes), bool)
        keep[np.asarray(ops, np.int64)] = True
        idx = np.concatenate([np.arange(first[o], first[o + 1])
                              for o in np.nonzero(keep)[0]] or [[]])
        idx = torch.as_tensor(idx.astype(np.int64), device=self.tgt.device)
        return EdgeGroups(self.tgt[idx].contiguous(),
                          self.src[idx].contiguous(),
                          np.where(keep, sizes, 0))


def rotation_offsets(p):
    """Start of each degree's block in a rotation-class row of blocks, and
    the row's length."""
    off = np.concatenate([[0], np.cumsum((2 * np.arange(p + 1) + 1) ** 2)])
    return off[:-1], int(off[-1])


def axial_offsets(p):
    """Start of each ``m = -p .. p`` block in an operator's row of axial
    blocks, and the row's length."""
    sz = (p + 1 - np.abs(np.arange(-p, p + 1))) ** 2
    off = np.concatenate([[0], np.cumsum(sz)])
    return off[:-1], int(off[-1])


@dataclasses.dataclass
class RotationBlocks:
    """The blocks of the rotation M2L (see module doc), complex128 on the
    device: ``rot`` / ``unrot`` ``(nrotations, sum_n (2n+1)^2)``, ``ax``
    ``(nops, sum_m (p+1-|m|)^2)``, and ``rc_of_op`` (int32) the rotation
    class of each operator."""

    order: int
    rc_of_op: Any
    rot: Any
    unrot: Any
    ax: Any
    _flat: dict = dataclasses.field(default_factory=dict, repr=False)
    _mats: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size()
                   for t in (self.rot, self.unrot, self.ax))

    def flat(self, real):
        """``rot``, ``unrot``, ``ax`` as interleaved (re, im) *real*
        tensors, what K77-K79 read; cached."""
        if real not in self._flat:
            self._flat[real] = tuple(
                torch.view_as_real(t).to(real).contiguous()
                for t in (self.rot, self.unrot, self.ax))
        return self._flat[real]

    def matrices(self, dtype):
        """Per degree the ``(nrotations, 2n+1, 2n+1)`` rotate and unrotate
        blocks, per m the ``(nops, a, a)`` axial blocks, in *dtype*: complex,
        or pair-expanded for a real dtype; cached."""
        if dtype not in self._mats:
            p = self.order
            roff, _ = rotation_offsets(p)
            aoff, _ = axial_offsets(p)

            def layout(b):
                if dtype.is_complex:
                    return b.to(dtype)
                br, bi = b.real.to(dtype), b.imag.to(dtype)
                return torch.cat([torch.cat([br, bi], -1),
                                  torch.cat([-bi, br], -1)], -2)

            rot, unrot, ax = [], [], []
            for n in range(p + 1):
                dn = 2 * n + 1
                sl = slice(int(roff[n]), int(roff[n]) + dn * dn)
                rot.append(layout(self.rot[:, sl].reshape(-1, dn, dn)))
                unrot.append(layout(self.unrot[:, sl].reshape(-1, dn, dn)))
            for i, m in enumerate(range(-p, p + 1)):
                a = p + 1 - abs(m)
                sl = slice(int(aoff[i]), int(aoff[i]) + a * a)
                ax.append(layout(self.ax[:, sl].reshape(-1, a, a)))
            self._mats[dtype] = (rot, unrot, ax)
        return self._mats[dtype]


def _column_sets(p, pairs, device):
    """Per degree the coefficient columns ``n^2 .. (n+1)^2``, per m those of
    ``(n, m)`` (destination) and ``(n, -m)`` (source), ``n >= |m|``;
    pair-expanded over ``[re | im]``."""
    kc = (p + 1) ** 2

    def cols(ix):
        ix = np.asarray(ix, np.int64)
        if pairs:
            ix = np.concatenate([ix, kc + ix])
        return torch.as_tensor(ix, device=device)

    deg = [cols(np.arange(n * n, (n + 1) * (n + 1))) for n in range(p + 1)]
    dst, src = [], []
    for m in range(-p, p + 1):
        ns = np.arange(abs(m), p + 1)
        dst.append(cols(ns * ns + ns + m))
        src.append(cols(ns * ns + ns - m))
    return deg, dst, src

# }}}


# {{{ M2L (K77-K79)

def _check(mpole, edges, blocks):
    if mpole.dtype not in _DTYPES:
        raise TypeError(f"no rotation M2L for {mpole.dtype}")
    kc = (blocks.order + 1) ** 2
    k = kc if mpole.dtype.is_complex else 2 * kc
    if mpole.ndim != 2 or mpole.shape[1] != k:
        raise ValueError(f"multipoles must be (nboxes, {k})")
    if len(edges.sizes) != blocks.ax.shape[0]:
        raise ValueError("one axial block row per operator group")


def m2l_rotation_plain(mpole, edges, blocks, chunk=1 << 16):
    """Plain twin of :func:`m2l_rotation`: per operator group, the source
    rows gathered, rotated per degree, translated per m, unrotated per
    degree, and ``index_add_``-ed into the locals."""
    _check(mpole, edges, blocks)
    out = torch.zeros_like(mpole)
    p = blocks.order
    rot, unrot, ax = blocks.matrices(mpole.dtype)
    deg, dst, src = _column_sets(p, not mpole.dtype.is_complex,
                                 mpole.device)
    rc = blocks.rc_of_op.tolist()
    tgt, srcb = edges.tgt.to(torch.int64), edges.src.to(torch.int64)
    e0 = 0
    for o, g in enumerate(np.asarray(edges.sizes).tolist()):
        for c0 in range(e0, e0 + g, chunk):
            c1 = min(e0 + g, c0 + chunk)
            x = mpole[srcb[c0:c1]]
            y = torch.empty_like(x)
            for n, ix in enumerate(deg):
                y[:, ix] = x[:, ix] @ rot[n][rc[o]]
            z = torch.empty_like(x)
            for i in range(2 * p + 1):
                z[:, dst[i]] = y[:, src[i]] @ ax[i][o]
            w = torch.empty_like(x)
            for n, ix in enumerate(deg):
                w[:, ix] = z[:, ix] @ unrot[n][rc[o]]
            out.index_add_(0, tgt[c0:c1], w)
        e0 += g
    return out


def tile_edges(k, dtype):
    """Edges a tile of K77-K79 takes for *k* complex coefficients a row:
    the largest power of two up to :data:`MAX_TILE` whose two row buffers
    fit :data:`_TILE_SMEM` (at least 1)."""
    item = 8 if dtype == torch.float32 else 16
    tile = MAX_TILE
    while tile > 1 and 2 * tile * k * item > _TILE_SMEM:
        tile //= 2
    return tile


def m2l_rotation(mpole, edges, blocks):
    """Local expansions ``(nboxes, K)`` of the rotation M2L of *mpole* over
    the operator-sorted edges *edges* (an :class:`EdgeGroups`) with
    *blocks* (a :class:`RotationBlocks`): the twin on CPU tensors, K77-K79
    on CUDA tensors, one launch and no host read."""
    _check(mpole, edges, blocks)
    if mpole.device.type == "cpu":
        return m2l_rotation_plain(mpole, edges, blocks)
    mpole = mpole.contiguous()
    kernels.check_tensors(mpole, dtype=mpole.dtype)
    kernels.check_tensors(edges.tgt, edges.src, blocks.rc_of_op,
                          dtype=torch.int32)
    if edges.nedges >= 2 ** 31:
        raise ValueError("too many List-2 edges for int32 tiles")
    p = blocks.order
    real = mpole.dtype.to_real()
    tile = tile_edges((p + 1) ** 2, mpole.dtype)
    tile_op, tile_start, tile_len = edges.tiles(tile)
    rot, unrot, ax = blocks.flat(real)
    kernels.check_tensors(rot, unrot, ax, dtype=real)
    out = torch.zeros_like(mpole)
    if tile_op.shape[0]:
        kernels.launch("m2l_rotate", mpole.dtype, mpole, edges.tgt,
                       edges.src, tile_op, tile_start, tile_len,
                       blocks.rc_of_op, rot, unrot, ax, tile_op.shape[0], p,
                       tile, out)
    return out

# }}}
