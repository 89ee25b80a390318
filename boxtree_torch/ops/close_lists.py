"""Lists 3 and 4 of a traversal whose targets have extents, with their
"close" halves, and the K14 and K15 kernels.

Port of ``boxtree_tpu/traversal/build.py:134-180`` (the box centres and the
sep-smaller / sep-bigger criteria), ``:264-301`` (``_gen_list4``, its
with-extent branch), ``:398-496`` (``_gen_list3_ext``) and ``:499-538``
(``_gen_list4_close``) on the neighbour-table path: every candidate comes
from one clamped row of :func:`boxtree_torch.traversal.neighbors.
build_neighbor_table`, and an entry counts only where it lies at the level
probed.

- :func:`list4_ext`: List 4 over the target-or-target-parent rows and the
  close List 4 over the target rows.  K14 (``csrc/close_lists.cu``) on
  CUDA tensors, a count pass and a fill pass; :func:`list4_ext_plain`, over
  the generator :func:`gen_list4_ext`, on CPU tensors.
- :func:`list3_ext`: the sorted List-3 keys ``(target_box << 32) | w`` of
  every source level, and the sorted close List-3 keys.  K15 on CUDA
  tensors, appending through device counters; :func:`list3_ext_plain`,
  over :func:`gen_list3_ext`, on CPU tensors.

The criteria run in float64 (the reference's ``root_extent`` and
stick-out factor are float64, ``:1700-1702``), with the centres computed
from the integer cells in the coordinates' dtype first, as the reference
does.  Every row's entries ascend, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from boxtree_torch.ops import kernels, morton
from boxtree_torch.ops.peers import _touch
from boxtree_torch.traversal import neighbors as nbr
from boxtree_torch.tree.containers import box_flags_enum

_F = box_flags_enum
_EPS = float(np.finfo(np.float64).eps)
_INVALID_KEY = nbr._INVALID_KEY
_INT64_MAX = torch.iinfo(torch.int64).max
_ROW_CHUNK = 1 << 13
CRITERIA = ("static_linf", "precise_linf", "static_l2")


@dataclass(frozen=True)
class ExtentGeometry:
    """What the with-extent criteria read besides the table: ``bbox_min``
    (``(d,)``, coordinate dtype), ``root_extent`` and ``sof`` (python
    floats, used as float64), ``src_cumul`` (int32 source counts of each
    subtree) and the target bounding boxes (``(d, nboxes)``)."""

    bbox_min: Any
    root_extent: float
    sof: float
    src_cumul: Any
    tbb_min: Any
    tbb_max: Any

    @classmethod
    def of_tree(cls, tree):
        """The reference's ``ext_data`` (``traversal/build.py:1697-1707``)."""
        return cls(
            bbox_min=(tree.box_centers[:, 0]
                      - 0.5 * torch.as_tensor(tree.root_extent)).contiguous(),
            root_extent=float(tree.root_extent),
            sof=float(tree.stick_out_factor),
            src_cumul=tree.box_source_counts_cumul,
            tbb_min=tree.box_target_bounding_box_min,
            tbb_max=tree.box_target_bounding_box_max)


# {{{ geometry (boxtree_tpu/traversal/build.py:134-180), float64

def _centers(cells, level, geo):
    """Float64 centres of the boxes with integer *cells* ``(d, ...)`` at
    *level*: ``bbox_min + (cell + 0.5) * width``, the parenthesis in the
    coordinate dtype."""
    dt = geo.bbox_min.dtype
    width = geo.root_extent * 2.0 ** -level
    shape = (cells.shape[0],) + (1,) * (cells.ndim - 1)
    return (geo.bbox_min.reshape(shape).to(torch.float64)
            + (cells.to(dt) + 0.5).to(torch.float64) * width)


def _level_rad(level, geo):
    return geo.root_extent * 2.0 ** -(level + 1)


def _linf(v):
    out = v[0]
    for ax in range(1, v.shape[0]):
        out = torch.maximum(out, v[ax])
    return out


def _meets_sep_smaller(tgt_c, tgt_lev, src_c, src_lev, geo, *, crit,
                       tgt_ext_c=None, tgt_rvec=None):
    src_rad = _level_rad(src_lev, geo)
    if crit == "precise_linf":
        l_inf = _linf((tgt_ext_c - src_c).abs() - tgt_rvec - src_rad)
        return l_inf.clamp(min=0.0) >= (2 - 8 * _EPS) * src_rad
    tgt_stick = (1.0 + geo.sof) * _level_rad(tgt_lev, geo)
    if crit == "static_linf":
        l_inf = _linf((tgt_c - src_c).abs() - tgt_stick - src_rad)
        return l_inf.clamp(min=0.0) >= (2 - 8 * _EPS) * src_rad
    dx = tgt_c - src_c
    sq = dx[0] * dx[0]
    for ax in range(1, dx.shape[0]):
        sq = sq + dx[ax] * dx[ax]
    rhs = (torch.sqrt(sq) - float(np.sqrt(dx.shape[0])) * tgt_stick
           - src_rad)
    return (2 - 8 * _EPS) * src_rad <= rhs


def _meets_sep_bigger(tgt_c, tgt_lev, src_c, src_lev, geo):
    max_allowed = (3.0 * (1.0 + geo.sof) * _level_rad(tgt_lev, geo)
                   + _level_rad(src_lev, geo))
    return _linf((tgt_c - src_c).abs()) >= max_allowed * (1 - 8 * _EPS)

# }}}


def _ancestors(parents, ids, level):
    """``{l: ids of the level-l ancestors}`` of boxes *ids* at *level*,
    for ``l`` in ``0..level``."""
    a = ids.to(torch.int64)
    anc = {level: a}
    for lev in range(level - 1, -1, -1):
        a = parents[a].to(torch.int64)
        anc[lev] = a
    return anc


def _tally(work, **parts):
    """Adds to the dict *work* (if given) what the kernel's threads read
    and test: the count of each boolean mask, the distinct ids of each
    integer tensor."""
    if work is None:
        return
    for key, v in parts.items():
        if v.dtype == torch.bool:
            work[key] = work.get(key, 0) + int(v.sum())
        else:
            ids = v.reshape(-1)
            if key in work:
                ids = torch.cat([work[key], ids])
            work[key] = torch.unique(ids)


def _table_entries(ntable, anc_ids, level, lsb, cols=None):
    """``(found, ids)`` of the clamped table row of each *anc_ids* box:
    found where an entry lies at *level* itself."""
    t = ntable[anc_ids]
    if cols is not None:
        t = t[:, cols]
    ids = (t.clamp(min=0) & nbr.ID_MASK).to(torch.int64)
    return (t >= 0) & (ids >= lsb[level]), ids


# {{{ List 4 (K14)

def gen_list4_ext(rows, ntable, parents, prefixes, box_flags,
                  tgt_row_of_box, geo, *, lb, dimensions, lsb, work=None):
    """``(far, close)`` candidate ids (``(B, K)``, ``-1`` invalid) of the
    target-or-target-parent boxes *rows* at level *lb*: List 4 with target
    extents (``boxtree_tpu/traversal/build.py:288-301``) and the close
    List 4 (``:499-538``, only where the row is a target box).

    *work*, a dict, gathers what K14 reads and tests for these rows: the
    boxes whose parent (``parent_reads``) and table row (``table_rows``)
    it reads, the candidates whose flags it reads (``flag_reads``), the
    count of ``rows``, of candidates that get to the sep-bigger test
    (``probes``) and of those that also get the parent's (``parent_tests``).
    """
    d = dimensions
    rows_i = rows.to(torch.int64)
    cells = morton.deinterleave(prefixes[rows_i], d)
    pcells = cells >> 1
    b_c = _centers(cells, lb, geo)[:, :, None]
    p_c = _centers(pcells, lb - 1, geo)[:, :, None]
    b_is_tgt = (tgt_row_of_box[rows_i] >= 0)[:, None]
    anc = _ancestors(parents, rows_i, lb)
    _tally(work, rows=torch.ones_like(rows_i, dtype=torch.bool),
           parent_reads=torch.cat([anc[lev] for lev in range(2, lb + 1)]))
    m = 3 ** d
    cols = torch.as_tensor([j for j in range(m) if j != m // 2],
                           device=rows.device)
    offs = torch.as_tensor(nbr._offsets(d, 1, exclude_zero=True),
                           device=rows.device)
    far, close = [], []
    for wl in range(1, lb):
        found, ids = _table_entries(ntable, anc[wl], wl, lsb, cols)
        cand = (cells >> (lb - wl))[:, :, None] + offs.T[:, None, :]
        is_src = (box_flags[torch.where(found, ids, 0)]
                  & _F.IS_SOURCE_BOX) != 0
        base = (found & is_src
                & ~_touch(cand, wl, cells[:, :, None], lb))
        s_c = _centers(cand, wl, geo)
        meets_b = _meets_sep_bigger(b_c, lb, s_c, wl, geo)
        touch_p = _touch(cand, wl, pcells[:, :, None], lb - 1)
        meets_p = _meets_sep_bigger(p_c, lb - 1, s_c, wl, geo)
        _tally(work, table_rows=anc[wl], flag_reads=ids[found], probes=base,
               parent_tests=base & meets_b & ~touch_p)
        far.append(torch.where(base & meets_b & (touch_p | ~meets_p),
                               ids, -1))
        close.append(torch.where(base & ~meets_b & b_is_tgt, ids, -1))
    if not far:
        empty = torch.full((rows.shape[0], 0), -1, dtype=torch.int64,
                           device=rows.device)
        return empty, empty
    return torch.cat(far, dim=1), torch.cat(close, dim=1)


def _csr(counts, nrows, device):
    starts = torch.zeros(nrows + 1, dtype=torch.int64, device=device)
    starts[1:] = torch.cumsum(counts, 0)
    return starts


def list4_ext_plain(totp_boxes, ls_totp, ntable, parents, prefixes,
                    box_flags, tgt_row_of_box, ntarget_boxes, geo, *,
                    dimensions, lsb, work=None):
    """Plain twin of :func:`list4_ext`; *work* as in
    :func:`gen_list4_ext`."""
    dev = totp_boxes.device
    far_counts = torch.zeros(totp_boxes.shape[0], dtype=torch.int64,
                             device=dev)
    close_counts = torch.zeros(ntarget_boxes, dtype=torch.int64, device=dev)
    far_vals, close_keys = [], []
    for lb in range(2, len(lsb) - 1):
        for c0 in range(ls_totp[lb], ls_totp[lb + 1], _ROW_CHUNK):
            c1 = min(c0 + _ROW_CHUNK, ls_totp[lb + 1])
            rows = totp_boxes[c0:c1]
            far, close = gen_list4_ext(
                rows, ntable, parents, prefixes, box_flags, tgt_row_of_box,
                geo, lb=lb, dimensions=dimensions, lsb=lsb, work=work)
            valid = far >= 0
            far_counts[c0:c1] = valid.sum(dim=1)
            # each row ascending, its valid entries first
            srt = torch.sort(torch.where(valid, far, _INT64_MAX),
                             dim=1).values
            far_vals.append(srt[srt != _INT64_MAX])
            trow = tgt_row_of_box[rows.to(torch.int64)]
            keys = (trow[:, None] << 32) | close
            close_keys.append(keys[close >= 0])
    far_lists = (torch.cat(far_vals) if far_vals else
                 torch.zeros(0, dtype=torch.int64, device=dev))
    ck = (torch.sort(torch.cat(close_keys)).values if close_keys else
          torch.zeros(0, dtype=torch.int64, device=dev))
    close_counts.index_add_(0, ck >> 32, torch.ones_like(ck))
    return (_csr(far_counts, far_counts.shape[0], dev).to(torch.int32),
            far_lists.to(torch.int32),
            _csr(close_counts, ntarget_boxes, dev).to(torch.int32),
            (ck & 0xFFFFFFFF).to(torch.int32))


def list4_ext(totp_boxes, ls_totp, ntable, parents, prefixes, box_flags,
              tgt_row_of_box, ntarget_boxes, geo, *, dimensions, lsb):
    """``(starts, lists, close_starts, close_lists)``, all int32: List 4
    with target extents over the *totp_boxes* rows (host level starts
    *ls_totp*), and the close List 4 over the target rows (``ntarget_boxes``
    of them; *tgt_row_of_box* int64, ``-1`` for non-target boxes).

    CPU tensors take :func:`list4_ext_plain`.  CUDA tensors launch K14
    (``csrc/close_lists.cu``) twice over the rows at levels 2 and deeper,
    one thread per row: a count pass and, after ``torch.cumsum``, a fill
    pass.
    """
    if totp_boxes.device.type == "cpu":
        return list4_ext_plain(totp_boxes, ls_totp, ntable, parents,
                               prefixes, box_flags, tgt_row_of_box,
                               ntarget_boxes, geo, dimensions=dimensions,
                               lsb=lsb)
    dt = geo.bbox_min.dtype
    dev = totp_boxes.device
    nlevels = len(lsb) - 1
    lsb_t = torch.as_tensor(lsb, dtype=torch.int64, device=dev)
    kernels.check_tensors(totp_boxes, parents, box_flags, ntable,
                          dtype=torch.int32)
    kernels.check_tensors(prefixes, tgt_row_of_box, dtype=torch.int64)
    kernels.check_tensors(geo.bbox_min, dtype=dt)
    ntotp = totp_boxes.shape[0]
    r0 = ls_totp[min(2, nlevels)]
    far_counts = torch.zeros(ntotp, dtype=torch.int32, device=dev)
    close_counts = torch.zeros(ntarget_boxes, dtype=torch.int32, device=dev)
    far_starts = _csr(far_counts, ntotp, dev)
    close_starts = _csr(close_counts, ntarget_boxes, dev)
    far_lists = torch.zeros(0, dtype=torch.int32, device=dev)
    close_lists = far_lists

    def run(fill):
        kernels.launch(
            "list4_ext", dt, totp_boxes, r0, ntotp, prefixes, parents,
            box_flags, ntable, tgt_row_of_box, lsb_t, nlevels, geo.bbox_min,
            geo.root_extent, geo.sof, dimensions, far_counts, close_counts,
            far_starts, far_lists, close_starts, close_lists, fill)

    run(0)
    far_starts = _csr(far_counts, ntotp, dev)
    close_starts = _csr(close_counts, ntarget_boxes, dev)
    nfar, nclose = torch.stack([far_starts[-1], close_starts[-1]]).tolist()
    far_lists = torch.empty(nfar, dtype=torch.int32, device=dev)
    close_lists = torch.empty(nclose, dtype=torch.int32, device=dev)
    if nfar or nclose:
        run(1)
    return (far_starts.to(torch.int32), far_lists,
            close_starts.to(torch.int32), close_lists)

# }}}


# {{{ List 3 (K15)

def gen_list3_ext(rows, ntable, parents, prefixes, box_flags,
                  tgt_row_of_box, geo, *, ls, dimensions, lsb, crit,
                  min_nsources, work=None):
    """``(far_keys, close_keys)`` (``(B, K)`` int64 ``(tgt << 32) | w``,
    ``_INVALID_KEY`` invalid) of the boxes *rows* at source level *ls*
    (``boxtree_tpu/traversal/build.py:398-496``, table mode).

    *work*, a dict, gathers what K15 reads and tests for these rows: the
    count of ``boxes`` whose flags it reads and of the ``rows`` it goes on
    with; the boxes whose parent (``parent_reads``), table row
    (``table_rows``) and source count (``src_cumul_reads``) it reads, the
    candidates whose target row (``tgt_reads``) and bounding box
    (``bbox_reads``) it reads; the count of candidates that get to the
    criteria (``probes``), of the chain's criterion tests
    (``chain_tests``) and of the tests at ``w`` (``w_tests``).
    """
    d = dimensions
    rows_i = rows.to(torch.int64)
    cells = morton.deinterleave(prefixes[rows_i], d)
    w_flags = box_flags[rows_i]
    gate_far = ((w_flags & (_F.IS_SOURCE_BOX
                            | _F.HAS_SOURCE_CHILD_BOXES)) != 0)[:, None]
    gate_close = ((w_flags & _F.IS_SOURCE_BOX) != 0)[:, None]
    if min_nsources > 0:
        w_forced = (geo.src_cumul[rows_i] < min_nsources)[:, None]
    else:
        w_forced = torch.zeros_like(gate_far)
    w_c = _centers(cells, ls, geo)[:, :, None]
    anc = _ancestors(parents, rows_i, ls)
    gated = gate_far[:, 0]
    _tally(work, boxes=torch.ones_like(gated), rows=gated,
           parent_reads=torch.cat([anc[lev][gated]
                                   for lev in range(1, ls + 1)]))
    if min_nsources > 0:
        _tally(work, src_cumul_reads=rows_i[gated])
    offs = torch.as_tensor(nbr._offsets(d, 1), device=rows.device)
    far, close = [], []
    for lt in range(ls):
        found, ids = _table_entries(ntable, anc[lt], lt, lsb)
        idc = torch.where(found, ids, 0)
        cand = (cells >> (ls - lt))[:, :, None] + offs.T[:, None, :]
        is_tgt = tgt_row_of_box[idc] >= 0
        b_c = _centers(cand, lt, geo)
        ext = {}
        if crit == "precise_linf":
            lo, hi = geo.tbb_min[:, idc], geo.tbb_max[:, idc]
            ext = dict(tgt_ext_c=(0.5 * (lo + hi)).to(torch.float64),
                       tgt_rvec=(0.5 * (hi - lo)).to(torch.float64))

        def meets(src_c, src_lev):
            return _meets_sep_smaller(b_c, lt, src_c, src_lev, geo,
                                      crit=crit, **ext)

        meets_w = meets(w_c, ls)
        not_touch_w = ~_touch(cand, lt, cells[:, :, None], ls)
        probes = gate_far & found & is_tgt & not_touch_w
        _tally(work, table_rows=anc[lt][gated],
               tgt_reads=ids[gate_far & found], probes=probes)
        if crit == "precise_linf":
            _tally(work, bbox_reads=ids[probes])
        if min_nsources > 0:
            chain = torch.ones_like(found)
            for la in range(lt + 1, ls):
                anc_a = cells >> (ls - la)
                touch_a = _touch(cand, lt, anc_a[:, :, None], la)
                meets_a = meets(_centers(anc_a, la, geo)[:, :, None], la)
                forced_a = (geo.src_cumul[anc[la]] < min_nsources)[:, None]
                if work is not None:
                    # the kernel reads the count only past the touch test,
                    # and stops at the first ancestor that keeps b
                    reads = probes & chain & ~touch_a
                    _tally(work, src_cumul_reads=anc[la][reads.any(dim=1)],
                           chain_tests=reads & ~forced_a)
                chain = chain & (touch_a | ~meets_a | forced_a)
        elif lt < ls - 1:
            parent = cells >> 1
            touch_p = _touch(cand, lt, parent[:, :, None], ls - 1)
            _tally(work, chain_tests=probes & ~touch_p)
            chain = touch_p | ~meets(_centers(parent, ls - 1, geo)[:, :, None],
                                     ls - 1)
        else:
            chain = torch.ones_like(found)
        _tally(work, w_tests=probes & chain)
        base = found & is_tgt & not_touch_w & chain
        keys = (ids << 32) | rows_i[:, None]
        far.append(torch.where(base & meets_w & ~w_forced & gate_far, keys,
                               _INVALID_KEY))
        close.append(torch.where(base & (~meets_w | w_forced) & gate_close,
                                 keys, _INVALID_KEY))
    return torch.cat(far, dim=1), torch.cat(close, dim=1)


def _check_crit(crit, min_nsources):
    if crit not in CRITERIA:
        raise ValueError(f"unexpected value of 'from_sep_smaller_crit': "
                         f"{crit}")
    if min_nsources < 0:
        raise ValueError("min_nsources must be >= 0")


def list3_ext_plain(ntable, parents, prefixes, box_flags, tgt_row_of_box,
                    geo, *, dimensions, lsb, crit, min_nsources=0,
                    work=None):
    """Plain twin of :func:`list3_ext`; *work* as in
    :func:`gen_list3_ext`."""
    _check_crit(crit, min_nsources)
    dev = prefixes.device
    far_levels, close = [torch.zeros(0, dtype=torch.int64, device=dev)], []
    for ls in range(1, len(lsb) - 1):
        far = []
        for c0 in range(lsb[ls], lsb[ls + 1], _ROW_CHUNK):
            rows = torch.arange(c0, min(c0 + _ROW_CHUNK, lsb[ls + 1]),
                                device=dev)
            f, c = gen_list3_ext(
                rows, ntable, parents, prefixes, box_flags, tgt_row_of_box,
                geo, ls=ls, dimensions=dimensions, lsb=lsb, crit=crit,
                min_nsources=min_nsources, work=work)
            far.append(f[f != _INVALID_KEY])
            close.append(c[c != _INVALID_KEY])
        far_levels.append(torch.sort(torch.cat(far)).values)
    close = (torch.sort(torch.cat(close)).values if close else
             torch.zeros(0, dtype=torch.int64, device=dev))
    return far_levels, close


def list3_ext(ntable, parents, prefixes, box_flags, tgt_row_of_box, geo, *,
              dimensions, lsb, crit, min_nsources=0):
    """``(far_keys_by_level, close_keys)``: for every source level ``ls``
    the sorted int64 List-3 keys ``(target_box << 32) | w`` of the boxes
    ``w`` at that level (level 0's are empty), and the sorted keys of the
    close List 3, under the ``from_sep_smaller_crit`` *crit* and the
    reference's ``_from_sep_smaller_min_nsources_cumul`` *min_nsources*.

    CPU tensors take :func:`list3_ext_plain`.  CUDA tensors launch K15
    (``csrc/close_lists.cu``) once over every box below the root, one
    thread per box; keys go out through device counters into buffers
    sized for the most a box can emit (its level times ``3^d``), and are
    then sorted with ``torch.sort``.
    """
    _check_crit(crit, min_nsources)
    if prefixes.device.type == "cpu":
        return list3_ext_plain(ntable, parents, prefixes, box_flags,
                               tgt_row_of_box, geo, dimensions=dimensions,
                               lsb=lsb, crit=crit, min_nsources=min_nsources)
    dt = geo.bbox_min.dtype
    dev = prefixes.device
    nlevels = len(lsb) - 1
    m = 3 ** dimensions
    caps = [(lsb[ls + 1] - lsb[ls]) * ls * m for ls in range(nlevels)]
    off = np.concatenate([[0], np.cumsum(caps)])
    kernels.check_tensors(parents, box_flags, ntable, geo.src_cumul,
                          dtype=torch.int32)
    kernels.check_tensors(prefixes, tgt_row_of_box, dtype=torch.int64)
    tbb_min = geo.tbb_min.contiguous()
    tbb_max = geo.tbb_max.contiguous()
    kernels.check_tensors(geo.bbox_min, tbb_min, tbb_max, dtype=dt)
    far_keys = torch.empty(int(off[-1]), dtype=torch.int64, device=dev)
    close_keys = torch.empty(int(off[-1]), dtype=torch.int64, device=dev)
    counts = torch.zeros(nlevels + 1, dtype=torch.int64, device=dev)
    if nlevels > 1:
        kernels.launch(
            "list3_ext", dt, lsb[1], lsb[-1], prefixes, parents, box_flags,
            ntable, tgt_row_of_box, geo.src_cumul, tbb_min, tbb_max,
            geo.bbox_min, geo.root_extent, geo.sof,
            torch.as_tensor(lsb, dtype=torch.int64, device=dev), nlevels,
            dimensions, CRITERIA.index(crit), min_nsources, far_keys,
            torch.as_tensor(off[:-1], dtype=torch.int64, device=dev),
            counts, close_keys, counts[nlevels:])
    counts = counts.tolist()
    far_levels = [torch.sort(far_keys[off[ls]:off[ls] + counts[ls]]).values
                  for ls in range(nlevels)]
    return far_levels, torch.sort(close_keys[:counts[nlevels]]).values

# }}}
