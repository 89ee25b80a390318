"""The clamped neighbour table and the traversal's lists, and the K24-K27
kernels.

Port of ``boxtree_tpu/traversal/neighbors.py:64-155`` (the table) and of
the table-mode passes of ``boxtree_tpu/traversal/build.py`` on the
``well_sep_is_n_away == 1`` path: ``:942`` ``_rowlists_emit_pass`` (the
colleagues, Lists 2 and 4 by row) and ``:1151`` ``_edge_emit_pass`` (the
List-1 and List-3 edge keys), with ``:342`` ``_gen_list1_source_side``
where the targets have extents.

- :func:`neighbor_table` (K24): the ``(nboxes, 3^d)`` table, one launch
  per level.
- :func:`row_lists_sl_l2` (K25): the same-level colleagues (rows = all
  boxes) and List 2 (rows = the target-or-target-parent boxes), as CSR.
- :func:`lists_43` (K26): List 4 as CSR over the target-or-target-parent
  rows and the sorted List-3 keys ``(target_box << 32) | w`` of each
  source level, for targets without extents (K14 and K15 serve the
  others).
- :func:`list1` (K27): List 1 as CSR over the target rows, from its
  target side and its source side.
- :func:`traversal_lists`: K25, K26 and K27 together, with one host read
  of all their totals between the count and the fill passes.

CUDA tensors launch the kernels (``csrc/traversal.cu``): a count pass, a
``torch.cumsum`` for the starts, one host read of the totals, a fill pass;
edge keys are then sorted with ``torch.sort``.  CPU tensors take the plain
twins (``*_plain``), which run the generators of
:mod:`boxtree_torch.traversal.neighbors` over one level's rows at a time
in chunks, sorting and compacting the candidate rows.  Both give every
row ascending, as the reference's sorted ``(row << 32) | id`` keys do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from boxtree_torch.ops import kernels, morton
from boxtree_torch.ops.peers import _lookup, _touch
from boxtree_torch.traversal import neighbors as nbr
from boxtree_torch.tree.containers import box_flags_enum

_F = box_flags_enum
#: rows of one chunk of the plain twins (bounds their candidate tensors)
_ROW_CHUNK = 1 << 16
_INT32_MAX = 2 ** 31 - 1


@dataclass(frozen=True)
class ListInputs:
    """What K25-K27 and their twins read of a tree: its box arrays
    (``child_rows`` is ``(nboxes, 2^d)``), the clamped table, the
    target-or-target-parent, target and source-or-target box lists with
    their host level starts, the target row of each box (int64, ``-1``
    for boxes that are not target boxes), the box level starts as a host
    tuple and as an int64 tensor, and whether the targets have extents."""

    dimensions: int
    lsb: tuple
    lsb_t: Any
    prefixes: Any
    parents: Any
    flags: Any
    child_rows: Any
    ntable: Any
    totp_boxes: Any
    ls_totp_h: list
    target_boxes: Any
    ls_tgt_h: list
    part_boxes: Any
    ls_part_h: list
    tgt_row_of_box: Any
    ext: bool

    @property
    def device(self):
        return self.prefixes.device

    @property
    def nlevels(self):
        return len(self.lsb) - 1


# {{{ K24: the clamped neighbour table

def _table_maps(d):
    """Static maps of :func:`neighbor_table_plain`: child digit ``q``'s
    neighbour at ``offs[j]`` is the child with digit ``cdig[q, j]`` of the
    parent's neighbour in column ``pcol[q, j]``."""
    offs = nbr._offsets(d, 1)
    nchild, m = 2 ** d, offs.shape[0]
    col_w = 3 ** (d - 1 - np.arange(d))
    pcol = np.zeros((nchild, m), np.int64)
    cdig = np.zeros((nchild, m), np.int64)
    for q in range(nchild):
        qb = np.array([(q >> (d - 1 - a)) & 1 for a in range(d)])
        for j in range(m):
            dp = (qb + offs[j]) >> 1
            pcol[q, j] = ((dp + 1) * col_w).sum()
            cdig[q, j] = (((qb + offs[j]) & 1)
                          << (d - 1 - np.arange(d))).sum()
    return pcol, cdig


def neighbor_table_plain(prefixes, parents, child_rows, box_flags,
                         tgt_box_mask, *, dimensions, lsb):
    """Plain twin of :func:`neighbor_table`, level by level from the
    parent's row::

        cell(child q) + delta = 2 * pcell + q + delta
          -> parent column (q + delta) >> 1, child digit (q + delta) & 1

    Where the parent-level entry is already coarser, or its child at the
    needed digit is absent, the parent-level entry itself propagates down
    (the clamp).
    """
    d = dimensions
    dev = prefixes.device
    m = 3 ** d
    nchild = 2 ** d
    nboxes = lsb[-1]

    iota = torch.arange(nboxes, dtype=torch.int32, device=dev)
    ent = (iota
           | torch.where((box_flags & _F.IS_SOURCE_BOX) != 0, nbr.SRC_BIT, 0)
           | torch.where(tgt_box_mask, nbr.TGT_BIT, 0)).to(torch.int32)
    child_t = child_rows.to(torch.int64)                  # (nboxes, 2^d)
    child_ent = torch.where(child_t > 0, ent[child_t.clamp(min=0)],
                            torch.full_like(ent[child_t], -1))
    pcol, cdig = (torch.as_tensor(a, device=dev) for a in _table_maps(d))

    table = torch.full((nboxes, m), -1, dtype=torch.int32, device=dev)
    table[0, m // 2] = ent[0]
    for lev in range(1, len(lsb) - 1):
        b0, b1 = lsb[lev], lsb[lev + 1]
        p0 = lsb[lev - 1]
        par = parents[b0:b1].to(torch.int64)
        digit = prefixes[b0:b1] & (nchild - 1)
        pn = table[par]                                   # (B, m)
        pid = (pn.clamp(min=0) & nbr.ID_MASK).to(torch.int64)
        # child lookups mean something only where the parent-level entry
        # is AT the parent level
        at_plev = (pn >= 0) & (pid >= p0)
        cols = pcol[digit]                                # (B, m)
        pn_sel = torch.gather(pn, 1, cols)
        pid_sel = torch.gather(pid, 1, cols)
        ch = child_ent[pid_sel, cdig[digit]]              # (B, m)
        ch = torch.where(torch.gather(at_plev, 1, cols), ch,
                         torch.full_like(ch, -1))
        table[b0:b1] = torch.where(ch >= 0, ch, pn_sel)
    return table


def neighbor_table(prefixes, parents, child_rows, box_flags, tgt_box_mask,
                   *, dimensions, lsb):
    """(nboxes, 3^d) int32 clamped neighbour table
    (``boxtree_tpu/traversal/neighbors.py:65-155``): ``table[b, j]`` is
    the deepest existing box containing cell ``cell(b) + offs[j]`` at
    ``b``'s level, with bit 29 set for IS_SOURCE_BOX and bit 30 where
    *tgt_box_mask* holds, ``-1`` outside the domain.

    CPU tensors take :func:`neighbor_table_plain`.  CUDA tensors launch
    K24 (``csrc/traversal.cu``) once per level, one thread per (box,
    column), each level reading the rows the launch before wrote.
    """
    if prefixes.device.type == "cpu":
        return neighbor_table_plain(prefixes, parents, child_rows,
                                    box_flags, tgt_box_mask,
                                    dimensions=dimensions, lsb=lsb)
    kernels.check_tensors(parents, child_rows, box_flags, dtype=torch.int32)
    kernels.check_tensors(prefixes, dtype=torch.int64)
    kernels.check_tensors(tgt_box_mask, dtype=torch.bool)
    nboxes = lsb[-1]
    if tuple(child_rows.shape) != (nboxes, 2 ** dimensions):
        raise ValueError("child_rows must be (nboxes, 2^d)")
    table = torch.empty((nboxes, 3 ** dimensions), dtype=torch.int32,
                        device=prefixes.device)
    mask = tgt_box_mask.view(torch.uint8)
    for lev in range(len(lsb) - 1):
        kernels.launch("neighbor_table", None, prefixes, parents, child_rows,
                       box_flags, mask, table, lsb[lev], lsb[lev + 1],
                       lsb[lev - 1] if lev else 0, dimensions)
    return table

# }}}


# {{{ the plain twins' row machinery

def _csr_from_candidates(counts_and_values, nrows, device):
    """Concatenate per-chunk ``(counts, values)`` into CSR
    ``(starts[int32, nrows + 1], lists[int32])``."""
    if counts_and_values:
        counts = torch.cat([c for c, _ in counts_and_values])
        lists = torch.cat([v for _, v in counts_and_values])
    else:
        counts = torch.zeros(0, dtype=torch.int64, device=device)
        lists = torch.zeros(0, dtype=torch.int32, device=device)
    if counts.shape[0] != nrows:
        raise RuntimeError("CSR rows out of step")
    starts = torch.zeros(nrows + 1, dtype=torch.int64, device=device)
    starts[1:] = torch.cumsum(counts, 0)
    return starts.to(torch.int32), lists.to(torch.int32)


def _row_sorted(cand):
    """Per-row counts and the row-major values of a ``(B, K)`` candidate
    block (``-1`` invalid), each row's values ascending."""
    valid = cand >= 0
    srt = torch.sort(torch.where(valid, cand, torch.full_like(
        cand, _INT32_MAX)), dim=1).values
    counts = valid.sum(dim=1)
    return counts, srt[srt != _INT32_MAX]


def _row_lists(gen, rows):
    """Run *gen* over *rows* in chunks; returns a list of
    ``(counts, values)``."""
    out = []
    for c0 in range(0, rows.shape[0], _ROW_CHUNK):
        out.append(_row_sorted(gen(rows[c0:c0 + _ROW_CHUNK])))
    return out


def _valid_keys(gen, rows):
    """Run a key generator over *rows* in chunks; returns its valid
    int64 keys."""
    parts = []
    for c0 in range(0, rows.shape[0], _ROW_CHUNK):
        keys = gen(rows[c0:c0 + _ROW_CHUNK])
        parts.append(keys[keys != nbr._INVALID_KEY])
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=rows.device)
    return torch.cat(parts)


def _level_ids(lsb, lev, device):
    return torch.arange(lsb[lev], lsb[lev + 1], dtype=torch.int32,
                        device=device)


def _empty_rows(rows):
    return (torch.zeros(rows.shape[0], dtype=torch.int64,
                        device=rows.device),
            torch.zeros(0, dtype=torch.int32, device=rows.device))


def _csr_of_keys(keys, nrows):
    """CSR ``(starts, lists)`` (int32) over *nrows* rows of int64 keys
    ``(row << 32) | value``, sorted here."""
    keys = torch.sort(keys).values
    starts = torch.searchsorted(
        keys >> 32, torch.arange(nrows + 1, device=keys.device))
    return starts.to(torch.int32), (keys & 0xFFFFFFFF).to(torch.int32)


def _sort_levels(keys, bounds):
    """Each level's slice ``keys[bounds[l]:bounds[l + 1]]``, sorted."""
    return [torch.sort(keys[bounds[lev]:bounds[lev + 1]]).values
            for lev in range(len(bounds) - 1)]

# }}}


# {{{ K25: colleagues and List 2

def row_lists_sl_l2_plain(inp):
    """Plain twin of :func:`row_lists_sl_l2`."""
    lsb, dev = inp.lsb, inp.device
    parts = []
    for lev in range(inp.nlevels):
        parts += _row_lists(
            lambda r, lev=lev: nbr.fgen_slnws(r, inp.ntable,
                                              lsb_lev=lsb[lev]),
            _level_ids(lsb, lev, dev))
    sl = _csr_from_candidates(parts, lsb[-1], dev)
    parts = []
    for lev in range(inp.nlevels):
        rows = inp.totp_boxes[inp.ls_totp_h[lev]:inp.ls_totp_h[lev + 1]]
        if lev == 0:
            parts.append(_empty_rows(rows))
            continue
        parts += _row_lists(
            lambda r, lev=lev: nbr.fgen_list2(
                r, inp.ntable, inp.child_rows, inp.parents, inp.prefixes,
                dimensions=inp.dimensions, min_id=lsb[lev - 1]), rows)
    l2 = _csr_from_candidates(parts, inp.totp_boxes.shape[0], dev)
    return (*sl, *l2)


def _exclusive_cumsum(counts):
    starts = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                         device=counts.device)
    starts[1:] = torch.cumsum(counts, 0)
    return starts


def _check(inp):
    kernels.check_tensors(inp.parents, inp.flags, inp.child_rows,
                          inp.ntable, inp.totp_boxes, inp.target_boxes,
                          inp.part_boxes, dtype=torch.int32)
    kernels.check_tensors(inp.prefixes, inp.tgt_row_of_box, inp.lsb_t,
                          dtype=torch.int64)


def _row_lists_sl_l2_passes(inp):
    """K25's count pass; yields its totals, takes them back on the host,
    runs the fill pass and returns the lists."""
    _check(inp)
    dev = inp.device
    nboxes, ntotp = inp.lsb[-1], inp.totp_boxes.shape[0]
    sl_counts = torch.zeros(nboxes, dtype=torch.int32, device=dev)
    l2_counts = torch.zeros(ntotp, dtype=torch.int32, device=dev)

    def run(fill, sl_starts, l2_starts, sl_lists, l2_lists):
        kernels.launch(
            "row_lists_sl_l2", None, inp.ntable, inp.parents, inp.prefixes,
            inp.child_rows, inp.totp_boxes, inp.lsb_t, nboxes, ntotp,
            inp.nlevels, inp.dimensions, sl_counts, l2_counts, sl_starts,
            l2_starts, sl_lists, l2_lists, fill)

    run(0, inp.lsb_t, inp.lsb_t, sl_counts, l2_counts)
    sl_starts, l2_starts = (_exclusive_cumsum(c)
                            for c in (sl_counts, l2_counts))
    n_sl, n_l2 = yield torch.stack([sl_starts[-1], l2_starts[-1]])
    sl_lists = torch.empty(n_sl, dtype=torch.int32, device=dev)
    l2_lists = torch.empty(n_l2, dtype=torch.int32, device=dev)
    if n_sl or n_l2:
        run(1, sl_starts, l2_starts, sl_lists, l2_lists)
    return (sl_starts.to(torch.int32), sl_lists, l2_starts.to(torch.int32),
            l2_lists)


def row_lists_sl_l2(inp):
    """``(sl_starts, sl_lists, l2_starts, l2_lists)``, all int32: the
    same-level non-well-separated boxes of every box
    (``boxtree_tpu/traversal/neighbors.py:287``) and List 2 over the
    ``inp.totp_boxes`` rows, the children of the parent's colleagues that
    are well separated from the box (``:335-383``).

    CPU tensors take :func:`row_lists_sl_l2_plain`.  CUDA tensors launch
    K25 (``csrc/traversal.cu``) twice, one warp per row over both row
    sets: a count pass and, after ``torch.cumsum`` and one host read of
    the two totals, a fill pass that ranks each row's candidates.
    """
    if inp.device.type == "cpu":
        return row_lists_sl_l2_plain(inp)
    return _together(_row_lists_sl_l2_passes(inp))[0]

# }}}


# {{{ K26: List 4 and the List-3 keys, without target extents

def lists_43_plain(inp):
    """Plain twin of :func:`lists_43`."""
    lsb, dev, d = inp.lsb, inp.device, inp.dimensions
    parts = []
    for lev in range(inp.nlevels):
        rows = inp.totp_boxes[inp.ls_totp_h[lev]:inp.ls_totp_h[lev + 1]]
        if lev == 0:
            parts.append(_empty_rows(rows))
            continue
        parts += _row_lists(
            lambda r, lev=lev: nbr.fgen_list4(
                r, inp.ntable, inp.parents, inp.prefixes, lb=lev,
                dimensions=d, lsb=lsb), rows)
    l4_starts, l4_lists = _csr_from_candidates(
        parts, inp.totp_boxes.shape[0], dev)
    l3 = [torch.zeros(0, dtype=torch.int64, device=dev)] + [
        torch.sort(_valid_keys(
            lambda r, ls=ls: nbr.fgen_list3(
                r, inp.ntable, inp.parents, inp.prefixes, inp.flags, ls=ls,
                dimensions=d, lsb=lsb),
            _level_ids(lsb, ls, dev))).values
        for ls in range(1, inp.nlevels)]
    return l4_starts, l4_lists, l3


def _lists_43_passes(inp):
    """K26's count pass; yields its totals (List 4's, and the List-3
    key starts at each level start), then fills."""
    _check(inp)
    dev = inp.device
    nboxes, ntotp = inp.lsb[-1], inp.totp_boxes.shape[0]
    l4_counts = torch.zeros(ntotp, dtype=torch.int32, device=dev)
    l3_counts = torch.zeros(nboxes, dtype=torch.int32, device=dev)

    def run(fill, l4_starts, l3_starts, l4_lists, l3_keys):
        kernels.launch(
            "lists_43", None, inp.ntable, inp.parents, inp.prefixes,
            inp.flags, inp.totp_boxes, inp.lsb_t, ntotp, nboxes,
            inp.nlevels, inp.dimensions, l4_counts, l3_counts, l4_starts,
            l3_starts, l4_lists, l3_keys, fill)

    run(0, inp.lsb_t, inp.lsb_t, l4_counts, inp.lsb_t)
    l4_starts, l3_starts = (_exclusive_cumsum(c)
                            for c in (l4_counts, l3_counts))
    totals = yield torch.cat([l4_starts[-1:], l3_starts[inp.lsb_t]])
    l4_lists = torch.empty(totals[0], dtype=torch.int32, device=dev)
    l3_keys = torch.empty(totals[-1], dtype=torch.int64, device=dev)
    if totals[0] or totals[-1]:
        run(1, l4_starts, l3_starts, l4_lists, l3_keys)
    return (l4_starts.to(torch.int32), l4_lists,
            _sort_levels(l3_keys, totals[1:]))


def lists_43(inp):
    """``(l4_starts, l4_lists, l3_keys)``: List 4 (int32 CSR over the
    ``inp.totp_boxes`` rows), the coarser source leaves that touch the
    box's parent but not the box (``boxtree_tpu/traversal/neighbors.py:
    419-441``), and for every source level the sorted int64 List-3 keys
    ``(target_box << 32) | w``, the coarser target leaves that touch the
    parent of ``w`` but not ``w`` (``:533-555``; level 0's are empty).
    Targets without extents only.

    CPU tensors take :func:`lists_43_plain`.  CUDA tensors launch K26
    (``csrc/traversal.cu``) twice, one warp per row over the
    target-or-target-parent boxes and then every box: a count pass and,
    after ``torch.cumsum`` and one host read of the totals, a fill pass;
    each level's keys are then sorted with ``torch.sort``.
    """
    if inp.device.type == "cpu":
        return lists_43_plain(inp)
    return _together(_lists_43_passes(inp))[0]

# }}}


# {{{ K27: List 1

def _gen_list1_source_side(rows, prefixes, box_flags, tgt_row_of_box, *,
                           ls, dimensions, lsb):
    """Source-side List-1 keys ``(tgt << 32) | b`` of the boxes *rows* at
    level *ls*: the target boxes at every coarser level that touch ``b``
    (``boxtree_tpu/traversal/build.py:342-362``), found by binary search
    in each level's Morton prefixes."""
    rows_i = rows.to(torch.int64)
    cells = morton.deinterleave(prefixes[rows_i], dimensions)
    offs = torch.as_tensor(nbr._offsets(dimensions, 1), device=rows.device)
    emitter_is_src = ((box_flags[rows_i] & _F.IS_SOURCE_BOX) != 0)[:, None]
    out = []
    for lt in range(ls):
        cand = (cells >> (ls - lt))[:, :, None] + offs.T[:, None, :]
        found, box_id = _lookup(prefixes[lsb[lt]:lsb[lt + 1]], lsb[lt],
                                cand, lt)
        is_tgt = tgt_row_of_box[torch.where(found, box_id, 0)] >= 0
        valid = (found & is_tgt & _touch(cand, lt, cells[:, :, None], ls)
                 & emitter_is_src)
        out.append(torch.where(valid, (box_id.to(torch.int64) << 32)
                               | rows_i[:, None], nbr._INVALID_KEY))
    return torch.cat(out, dim=1)


def list1_plain(inp):
    """Plain twin of :func:`list1`."""
    lsb, d = inp.lsb, inp.dimensions
    keys = []
    for lt in range(inp.nlevels):
        rows = inp.target_boxes[inp.ls_tgt_h[lt]:inp.ls_tgt_h[lt + 1]]
        for c0 in range(0, rows.shape[0], _ROW_CHUNK):
            r = rows[c0:c0 + _ROW_CHUNK]
            cand = nbr.fgen_list1_tgt(r, inp.ntable, inp.prefixes, lt=lt,
                                      dimensions=d, lsb=lsb)
            trow = inp.tgt_row_of_box[r.to(torch.int64)]
            k = (trow[:, None] << 32) | cand.to(torch.int64)
            keys.append(k[cand >= 0])
        if lt > 0:
            prow = inp.part_boxes[inp.ls_part_h[lt]:inp.ls_part_h[lt + 1]]
            if inp.ext:
                def gen_src(r, lt=lt):
                    return _gen_list1_source_side(
                        r, inp.prefixes, inp.flags, inp.tgt_row_of_box,
                        ls=lt, dimensions=d, lsb=lsb)
            else:
                def gen_src(r, lt=lt):
                    return nbr.fgen_list1_src(r, inp.ntable, inp.prefixes,
                                              lt=lt, dimensions=d, lsb=lsb)
            src_keys = _valid_keys(gen_src, prow)
            keys.append((inp.tgt_row_of_box[src_keys >> 32] << 32)
                        | (src_keys & 0xFFFFFFFF))
    keys = (torch.cat(keys) if keys else
            torch.zeros(0, dtype=torch.int64, device=inp.device))
    return _csr_of_keys(keys, inp.target_boxes.shape[0])


def _list1_passes(inp):
    """K27's count pass; yields its total, then fills and sorts."""
    _check(inp)
    dev = inp.device
    ntgt, npart = inp.target_boxes.shape[0], inp.part_boxes.shape[0]
    counts = torch.zeros(ntgt + npart, dtype=torch.int32, device=dev)

    def run(fill, starts, keys):
        kernels.launch(
            "list1", None, inp.ntable, inp.prefixes, inp.flags,
            inp.target_boxes, inp.part_boxes, inp.tgt_row_of_box, inp.lsb_t,
            ntgt, npart, inp.nlevels, inp.dimensions, int(inp.ext), counts,
            starts, keys, fill)

    run(0, inp.lsb_t, inp.lsb_t)
    starts = _exclusive_cumsum(counts)
    (n,) = yield starts[-1:]
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        run(1, starts, keys)
    return _csr_of_keys(keys, ntgt)


def list1(inp):
    """``(starts, lists)``, int32 CSR over the ``inp.target_boxes`` rows:
    List 1, the source leaves adjacent to each target box.  Its target
    side holds the row's table entries at its level or coarser
    (``boxtree_tpu/traversal/neighbors.py:444-472``), its source side the
    finer source leaves whose own entries are the target box
    (``:506-530``) or, where targets have extents, that touch a target box
    at a coarser level, found by binary search in that level's Morton
    prefixes (``boxtree_tpu/traversal/build.py:342-362``).

    CPU tensors take :func:`list1_plain`.  CUDA tensors launch K27
    (``csrc/traversal.cu``) twice, one warp per target row and per
    source-or-target box: a count pass and, after ``torch.cumsum`` and one
    host read of the total, a fill pass of the int64 keys ``(target_row <<
    32) | source_box``, which ``torch.sort`` and ``torch.searchsorted``
    then make CSR.
    """
    if inp.device.type == "cpu":
        return list1_plain(inp)
    return _together(_list1_passes(inp))[0]

# }}}


def _together(*passes):
    """Run kernel passes side by side: each yields a tensor of totals
    after its count pass; they are read to the host in one transfer and
    each pass gets its own back as a list of ints to fill with."""
    totals = [next(p) for p in passes]
    host = torch.cat(totals).tolist()
    out, i = [], 0
    for p, t in zip(passes, totals):
        try:
            p.send(host[i:i + t.shape[0]])
        except StopIteration as done:
            out.append(done.value)
        else:
            raise RuntimeError("a kernel pass yielded twice")
        i += t.shape[0]
    return out


def traversal_lists(inp, plain=False):
    """``(row_lists_sl_l2(inp), lists_43(inp), list1(inp))``, the second
    None where the targets have extents.  On CUDA tensors the count
    passes of K25-K27 run first and one host read takes all their totals.
    *plain* runs the plain twins on any device (to time them beside the
    kernels)."""
    if plain or inp.device.type == "cpu":
        return (row_lists_sl_l2_plain(inp),
                None if inp.ext else lists_43_plain(inp), list1_plain(inp))
    if inp.ext:
        sl_l2, l1 = _together(_row_lists_sl_l2_passes(inp),
                              _list1_passes(inp))
        return sl_l2, None, l1
    return tuple(_together(_row_lists_sl_l2_passes(inp),
                           _lists_43_passes(inp), _list1_passes(inp)))
