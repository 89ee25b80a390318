"""The row moves of the distributed FMM: the multipole exchange's pack
(K80) and unpack (K81), and the masked merge (K82) of weights,
potentials and partial multipoles.  Each has a kernel wrapper and its
plain twin; on CPU tensors the wrapper runs the twin, on CUDA tensors it
launches the hand-written kernel (``csrc/exchange.cu``) or raises.

Rows are the first axis of a contiguous tensor of float32, float64 or
complex128; a row is everything after it (``(ncoeff,)`` multipoles, ``()``
scalar potentials, ``(2,)`` real-pair potentials).  Index tables are int32
with ``-1`` for a padding slot.

- K80 :func:`pack_rows` (``boxtree_tpu/parallel/distributed.py:494-497``):
  ``send[j] = mp[idx[j]]``, zero where ``idx[j] < 0``.
- K81 :func:`unpack_rows` (``distributed.py:498-505``): ``mp[idx[j]] +=
  recv[j]`` ("add") or ``= recv[j]`` ("set"), dropping ``-1``; the ids of
  one stage are unique, so each row has one writer.
- K82 :func:`masked_merge` (``distributed.py:530``, ``:552-557`` and the
  dense ``psum`` of ``:490``): ``out[i] += x[i]`` where ``keep[box_map[i]]``
  (or everywhere, with no mask), in place; rows not kept are not written.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels

_DTYPES = (torch.float32, torch.float64, torch.complex128)
_OPS = ("add", "set")


def _check_rows(x):
    if x.dtype not in _DTYPES:
        raise TypeError(f"no exchange kernel for {x.dtype}")
    if x.dim() < 1:
        raise ValueError("rows need a leading axis")


def _width(x):
    """Values of one row (complex values counted once)."""
    w = 1
    for s in x.shape[1:]:
        w *= s
    return w


def _check_index(idx, device):
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("index tables must be 1-D int32")
    if idx.device != device:
        raise ValueError("index table on another device than the rows")


# {{{ K80 pack_rows

def pack_rows_plain(mp, idx):
    """Plain twin of :func:`pack_rows`."""
    i = idx.to(torch.int64)
    ok = i >= 0
    send = torch.zeros((idx.shape[0], *mp.shape[1:]), dtype=mp.dtype,
                       device=mp.device)
    send[ok] = mp[i[ok]]
    return send


def pack_rows(mp, idx):
    """``(len(idx), *mp.shape[1:])`` rows ``mp[idx[j]]``, zero where
    ``idx[j] < 0``.  The K80 kernel on CUDA tensors."""
    _check_rows(mp)
    _check_index(idx, mp.device)
    if mp.device.type == "cpu":
        return pack_rows_plain(mp, idx)
    kernels.check_tensors(mp, dtype=mp.dtype)
    kernels.check_tensors(idx, dtype=torch.int32)
    send = torch.empty((idx.shape[0], *mp.shape[1:]), dtype=mp.dtype,
                       device=mp.device)
    kernels.launch("pack_rows", mp.dtype, mp, idx, idx.shape[0], _width(mp),
                   send)
    return send

# }}}


# {{{ K81 unpack_rows

def _check_unpack(mp, idx, recv, op):
    _check_rows(mp)
    _check_index(idx, mp.device)
    if op not in _OPS:
        raise ValueError(f"bad op: {op!r}")
    if recv.dtype != mp.dtype or recv.device != mp.device or tuple(
            recv.shape) != (idx.shape[0], *mp.shape[1:]):
        raise ValueError("received rows do not fit the index table")


def unpack_rows_plain(mp, idx, recv, op):
    """Plain twin of :func:`unpack_rows`."""
    _check_unpack(mp, idx, recv, op)
    i = idx.to(torch.int64)
    ok = i >= 0
    rows = i[ok]
    mp[rows] = (mp[rows] + recv[ok]) if op == "add" else recv[ok]
    return mp


def unpack_rows(mp, idx, recv, op):
    """In place, for every ``idx[j] >= 0``: ``mp[idx[j]] += recv[j]``
    (*op* "add") or ``mp[idx[j]] = recv[j]`` ("set"); the ids >= 0 must be
    unique.  Returns *mp*.  The K81 kernel on CUDA tensors."""
    if mp.device.type == "cpu":
        return unpack_rows_plain(mp, idx, recv, op)
    _check_unpack(mp, idx, recv, op)
    kernels.check_tensors(mp, recv, dtype=mp.dtype)
    kernels.check_tensors(idx, dtype=torch.int32)
    kernels.launch("unpack_rows", mp.dtype, mp, idx, recv, idx.shape[0],
                   _width(mp), int(op == "set"))
    return mp

# }}}


# {{{ K82 masked_merge

def _check_merge(out, x, keep, box_map):
    _check_rows(out)
    if x.dtype != out.dtype or x.device != out.device or x.shape != out.shape:
        raise ValueError("merged rows must match the output's shape, dtype "
                         "and device")
    if (keep is None) != (box_map is None):
        raise ValueError("pass both keep and box_map, or neither")
    if keep is not None:
        if keep.dtype != torch.bool or keep.dim() != 1:
            raise TypeError("keep must be a 1-D bool mask over the boxes")
        _check_index(box_map, out.device)
        if keep.device != out.device or box_map.shape[0] != out.shape[0]:
            raise ValueError("keep / box_map do not fit the rows")


def masked_merge_plain(out, x, keep=None, box_map=None):
    """Plain twin of :func:`masked_merge`."""
    _check_merge(out, x, keep, box_map)
    if keep is None:
        out += x
        return out
    k = keep[box_map.to(torch.int64)]
    out[k] = out[k] + x[k]
    return out


def masked_merge(out, x, keep=None, box_map=None):
    """In place, ``out[i] += x[i]`` for the rows ``i`` with
    ``keep[box_map[i]]`` (every row when *keep* is None); other rows are
    left as they are.  Returns *out*.  The K82 kernel on CUDA tensors."""
    if out.device.type == "cpu":
        return masked_merge_plain(out, x, keep, box_map)
    _check_merge(out, x, keep, box_map)
    kernels.check_tensors(out, x, dtype=out.dtype)
    if keep is None:
        flags, ids, has_keep = out, out, 0
    else:
        kernels.check_tensors(box_map, dtype=torch.int32)
        flags, ids, has_keep = keep.contiguous().view(torch.uint8), box_map, 1
    kernels.launch("masked_merge", out.dtype, out, x, flags, ids,
                   out.shape[0], _width(out), has_keep)
    return out

# }}}
