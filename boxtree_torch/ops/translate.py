"""The translation stages of the expansion wranglers, M2L (K35), M2M (K36)
and L2L (K37): rows of expansions, gathered through the traversal's box
tables, times small operator tables.  Each has a kernel wrapper and its
plain twin; on CPU tensors the wrapper runs the twin, on CUDA tensors it
launches the hand-written kernel (``csrc/translate.cu``) or raises.

Operators are ``(K, K)`` and transposed for row vectors (``row @ opT``),
in the coefficient dtype: float32 or float64 (the real-pair wranglers), or
complex128.  Box tables are int32 with -1 for none: ``child`` ``(nboxes,
2^d)`` holds each box's children by digit, ``tgt_child`` the children
that are target-or-target-parent boxes.

- M2L (``boxtree_tpu/models/expansion_base.py:915-1086``, the parent-block
  form): :class:`ParentBlockPlan` holds one operator per (level,
  translation class) that some List-2 pair uses (``particle_blocks.py:148``
  ``M2LPlan`` order), an ``opid`` ``(nlevels, m, 2^d, 2^d)`` into it per
  (colleague slot, source digit, target digit), the target parents of
  every level, padded per level to whole tiles of :data:`ROW_PAD` rows,
  and their source boxes per (slot, source digit), the colleagues'
  children.  K35
  runs all levels in one launch and reads nothing back to the host.  Its
  twin is the edge form (``expansion_base.py:1135``
  ``multipole_to_local_edges``): List 2's
  edges classified by (level, class), one matmul per operator, then
  ``index_add_`` into the targets, a different formulation from the
  kernel's parent blocks, so that the two check each other.
- M2M (``expansion_base.py:684``): one level, in place, every parent row
  of the level above adds its children's multipoles times the level's
  per-digit operators.
- L2L (``expansion_base.py:723``): one level, in place, every
  target-or-target-parent child adds its parent's local times its digit's
  operator.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from boxtree_torch.ops import kernels
from boxtree_torch.traversal.containers import csr_rows

#: K35's rows of each level are padded to a multiple of this many (every
#: tile height of the kernels divides it)
ROW_PAD = 128
#: element budget of one chunk of the twins' gathered rows
_CHUNK_ELEMS = 1 << 24
_DTYPES = (torch.float32, torch.float64, torch.complex128)


@dataclasses.dataclass
class ParentBlockPlan:
    """The M2L tables that K35 and its twin share (see module doc); the
    reference's edge plan ``M2LPlan`` is :class:`boxtree_torch.models.
    particle_blocks.M2LPlan`."""

    #: (nops, K, K) operators, transposed, one per used (level, class)
    ops: Any
    #: the (level, class) pair of each operator, in table order
    used: list
    #: (nlevels, m, 2^d, 2^d) int32 operator of (slot, source digit,
    #: target digit) at each child level, -1 where none applies
    opid: Any
    #: (npad,) int32 target parents (-1: padding), ascending by level
    rows: Any
    #: (npad, m) int32 colleague of each row in each slot (-1: none)
    pmap: Any
    #: (m 2^d, npad) int32 source box of each (slot j, source digit qs)
    #: pair, ``j * 2^d + qs``, and row: the colleague's child (-1: none)
    src: Any
    #: (npad,) int32 child level of each row (padding: its level's)
    row_level: Any
    child: Any
    tgt_child: Any
    # the twin's edge form: List 2 and the classification of its edges
    #: (nlevels, nclasses) int64 operator of each (level, class), -1
    level_opid: Any
    #: ((2 r + 1)^d,) int64 class of each offset (last axis fastest), -1
    class_of_offset: Any
    radius: int
    #: (d, nboxes) int64 cells of the boxes on their levels
    cells: Any
    box_levels: Any
    l2_rows: Any
    l2_starts: Any
    l2_lists: Any

    @property
    def nbytes(self):
        return self.ops.numel() * self.ops.element_size()


def _check_dtype(dtype):
    if dtype not in _DTYPES:
        raise TypeError(f"no translation kernel for {dtype}")


def _check_square(ops, k):
    if tuple(ops.shape[-2:]) != (k, k):
        raise ValueError(f"operators must be ({k}, {k}), got "
                         f"{tuple(ops.shape[-2:])}")


# {{{ M2L (K35)

def m2l_translate_plain(mpole, plan):
    """Plain twin of :func:`m2l_translate`: List 2's edges classified by
    (target level, translation class), one matmul per operator, each
    ``index_add_``-ed into its targets."""
    out = torch.zeros_like(mpole)
    nedges = plan.l2_lists.shape[0]
    if nedges == 0:
        return out
    tgt = plan.l2_rows.to(torch.int64)[csr_rows(plan.l2_starts, nedges)]
    src = plan.l2_lists.to(torch.int64)
    dvec = plan.cells[:, tgt] - plan.cells[:, src]
    width = 2 * plan.radius + 1
    lin = torch.zeros_like(tgt)
    for a in range(dvec.shape[0]):
        lin = lin * width + dvec[a] + plan.radius
    op = plan.level_opid[plan.box_levels[tgt],
                         plan.class_of_offset[lin]]
    if bool((op < 0).any()):
        raise RuntimeError("a List-2 edge has no M2L operator")
    op, order = torch.sort(op, stable=True)
    tgt, src = tgt[order], src[order]
    ops, counts = torch.unique_consecutive(op, return_counts=True)
    chunk = max(1, _CHUNK_ELEMS // mpole.shape[1])
    e0 = 0
    for o, n in zip(ops.tolist(), counts.tolist()):
        for c0 in range(e0, e0 + n, chunk):
            c1 = min(e0 + n, c0 + chunk)
            out.index_add_(0, tgt[c0:c1], mpole[src[c0:c1]] @ plan.ops[o])
        e0 += n
    return out


def m2l_translate(mpole, plan):
    """Local expansions ``(nboxes, K)`` of the M2L stage from the
    multipoles *mpole* over *plan* (a :class:`ParentBlockPlan` of the same
    device and dtype): zero but for the target-or-target-parent boxes with
    a target parent.  The K35 kernel on CUDA tensors, one launch for all
    levels."""
    _check_dtype(mpole.dtype)
    if mpole.device.type == "cpu":
        return m2l_translate_plain(mpole, plan)
    k = mpole.shape[1]
    kernels.check_tensors(mpole, plan.ops, dtype=mpole.dtype)
    kernels.check_tensors(plan.opid, plan.rows, plan.src, plan.row_level,
                          plan.tgt_child, dtype=torch.int32)
    _check_square(plan.ops, k)
    npairs, npad = plan.src.shape
    nchild = plan.tgt_child.shape[1]
    if plan.rows.shape[0] != npad or npad % ROW_PAD:
        raise ValueError("M2L plan rows must be padded to whole tiles")
    out = torch.zeros_like(mpole)
    if npad == 0 or plan.ops.shape[0] == 0:
        return out
    kernels.launch(
        "m2l_translate", mpole.dtype, mpole, plan.ops, plan.opid, plan.rows,
        plan.src, plan.row_level, plan.tgt_child, npad, npairs, nchild, k,
        out)
    return out

# }}}


# {{{ M2M (K36)

def m2m_translate_plain(mpole, ops, child, row0, nrows):
    """Plain twin of :func:`m2m_translate`: per digit, a gather of the
    children, one matmul and an ``index_add_`` into the parents."""
    par = torch.arange(row0, row0 + nrows, device=mpole.device)
    ch = child[row0:row0 + nrows].to(torch.int64)
    for q in range(ch.shape[1]):
        ok = ch[:, q] >= 0
        if bool(ok.any()):
            mpole.index_add_(0, par[ok], mpole[ch[ok, q]] @ ops[q])
    return mpole


def m2m_translate(mpole, ops, child, row0, nrows):
    """M2M of one level, in place: each box ``row0 <= b < row0 + nrows``
    (the parents, one level above the children) adds ``sum_q
    mpole[child[b, q]] @ ops[q]`` over its children, *ops* ``(2^d, K,
    K)``.  Returns *mpole*.  The K36 kernel on CUDA tensors."""
    _check_dtype(mpole.dtype)
    if mpole.device.type == "cpu":
        return m2m_translate_plain(mpole, ops, child, row0, nrows)
    kernels.check_tensors(mpole, ops, dtype=mpole.dtype)
    kernels.check_tensors(child, dtype=torch.int32)
    k = mpole.shape[1]
    _check_square(ops, k)
    if ops.shape[0] != child.shape[1] or not (
            0 <= row0 and row0 + nrows <= child.shape[0]):
        raise ValueError("M2M operators or rows do not fit the child table")
    if nrows > 0:
        kernels.launch("m2m_translate", mpole.dtype, mpole, ops, child,
                       row0, nrows, child.shape[1], k)
    return mpole

# }}}


# {{{ L2L (K37)

def l2l_translate_plain(local, ops, rows, tgt_child):
    """Plain twin of :func:`l2l_translate`: per digit, a gather of the
    parents, one matmul and an ``index_add_`` into the children."""
    par = rows.to(torch.int64)
    tc = tgt_child[par].to(torch.int64)
    for q in range(tc.shape[1]):
        ok = tc[:, q] >= 0
        if bool(ok.any()):
            local.index_add_(0, tc[ok, q], local[par[ok]] @ ops[q])
    return local


def l2l_translate(local, ops, rows, tgt_child):
    """L2L of one level, in place: for each parent box of *rows* and
    digit q with ``c = tgt_child[p, q] >= 0``, ``local[c] += local[p] @
    ops[q]``, *ops* ``(2^d, K, K)``.  Returns *local*.  The K37 kernel on
    CUDA tensors."""
    _check_dtype(local.dtype)
    if local.device.type == "cpu":
        return l2l_translate_plain(local, ops, rows, tgt_child)
    kernels.check_tensors(local, ops, dtype=local.dtype)
    kernels.check_tensors(rows, tgt_child, dtype=torch.int32)
    k = local.shape[1]
    _check_square(ops, k)
    if ops.shape[0] != tgt_child.shape[1]:
        raise ValueError("L2L operators do not fit the child table")
    if rows.numel():
        kernels.launch("l2l_translate", local.dtype, local, ops, rows,
                       tgt_child, rows.shape[0], tgt_child.shape[1], k)
    return local

# }}}
