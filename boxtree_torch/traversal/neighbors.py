"""The interaction-list generators that read the clamped per-box neighbor
table (the ``well_sep_is_n_away == 1`` path).

Port of :mod:`boxtree_tpu.traversal.neighbors` (``neighbors.py:59-557``);
the table itself is built by :func:`boxtree_torch.ops.traversal.
neighbor_table` (K24).  ``table[b, j]`` is the deepest existing box
containing cell ``cell(b) + delta_j`` at ``b``'s level: the same-level
neighbor where it exists, else the finest coarser box covering that cell,
``-1`` outside the domain.
Column ``j`` follows ``_offsets(d, 1)`` (axis 0 slowest); the centre
column is the box itself.  Entries pack two predicate bits into the spare
high bits of the int32 id: bit 29 IS_SOURCE_BOX, bit 30 "is a target
box".  Every generator takes a tensor of box ids at one level and returns
candidate ids (``-1`` invalid) or int64 edge keys (``_INVALID_KEY``
invalid).
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.ops import morton
from boxtree_torch.tree.containers import box_flags_enum

_F = box_flags_enum
_INVALID_KEY = int(np.iinfo(np.int64).max)

ID_MASK = (1 << 29) - 1
SRC_BIT = 1 << 29
TGT_BIT = 1 << 30


def _offsets(dimensions, radius, *, exclude_zero=False, min_inf_norm=None):
    """(m, dimensions) int64 numpy array of integer offsets in
    ``[-radius, radius]^d`` (``boxtree_tpu/traversal/build.py:76-87``)."""
    grids = np.meshgrid(*([np.arange(-radius, radius + 1)] * dimensions),
                        indexing="ij")
    offs = np.stack([g.ravel() for g in grids], axis=1).astype(np.int64)
    norm = np.abs(offs).max(axis=1)
    keep = np.ones(len(offs), bool)
    if exclude_zero:
        keep &= norm > 0
    if min_inf_norm is not None:
        keep &= norm > min_inf_norm
    return offs[keep]


# {{{ helpers

def _id_level(ids, lsb):
    """Level of each box id (valid where ``ids >= 0``): ids are
    level-major, so the level is the number of level starts <= id."""
    lev = torch.zeros(ids.shape, dtype=torch.int32, device=ids.device)
    for b in lsb[1:-1]:
        lev = lev + (ids >= b).to(torch.int32)
    return lev


def _canonical_mask(cells, lev_e, row_level, dimensions):
    """Keep each clamped coarser entry in exactly one lane
    (``neighbors.py:227-253``): lane offset ``o`` is canonical iff per
    axis ``o == 0`` or ``c + o`` leaves the row cell's level-``s`` block,
    ``s = row_level - level(entry)``."""
    offs = torch.as_tensor(_offsets(dimensions, 1), device=cells.device)
    s = (row_level - lev_e.to(torch.int64)).clamp(min=0)      # (B, m)
    ok = torch.ones(lev_e.shape, dtype=torch.bool, device=cells.device)
    for a in range(dimensions):
        o = offs[:, a][None, :]
        c = cells[a][:, None]
        ok = ok & ((o == 0) | (((c + o) >> s) != (c >> s)))
    return ok


def _not_touching(cells_f, level_f, anchor_cells, anchor_level, lev_e,
                  dimensions):
    """True where the lane's entry does NOT touch the fine box
    (``neighbors.py:256-280``)."""
    offs = torch.as_tensor(_offsets(dimensions, 1), device=cells_f.device)
    s_anc = (anchor_level - lev_e.to(torch.int64)).clamp(min=0)
    t = s_anc + (level_f - anchor_level)
    touch = torch.ones(lev_e.shape, dtype=torch.bool, device=cells_f.device)
    for a in range(dimensions):
        o = offs[:, a][None, :]
        q = (anchor_cells[a][:, None] + o) >> s_anc
        cf = cells_f[a][:, None]
        touch = touch & ((q << t) <= cf + 1) & (cf <= ((q + 1) << t))
    return ~touch


def _ids(t):
    return t.clamp(min=0) & ID_MASK


def _has(t, bit):
    return (t >= 0) & ((t & bit) != 0)

# }}}


# {{{ generators

def fgen_slnws(rows, ntable, *, lsb_lev):
    """Colleagues: the same-level entries of the row without the centre
    column (``neighbors.py:287-298``)."""
    m = ntable.shape[1]
    t = ntable[rows.to(torch.int64)]
    t = torch.cat([t[:, :m // 2], t[:, m // 2 + 1:]], dim=1)
    ids = _ids(t)
    return torch.where((t >= 0) & (ids >= lsb_lev), ids,
                       torch.full_like(ids, -1))


def _list2_pair_index(dimensions):
    """(2^d, K) static lane index into a parent's (m * 2^d) child lanes:
    for child digit r, the (neighbor column j, child digit q) whose
    candidate is well separated from r (``neighbors.py:310-332``)."""
    d = dimensions
    offs = _offsets(d, 1)
    nchild = 2 ** d

    def bits(q):
        return np.array([(q >> (d - 1 - a)) & 1 for a in range(d)])

    return np.asarray([
        [j * nchild + q
         for j in range(len(offs)) for q in range(nchild)
         if (np.abs(2 * offs[j] + bits(q) - bits(r)) > 1).any()]
        for r in range(nchild)])


def fgen_list2(rows, ntable, child_rows, parents, prefixes, *, dimensions,
               min_id):
    """List 2 of each row box: the children of its parent's colleagues
    that are well separated from it (``neighbors.py:335-383``, one row per
    child box).  *min_id* (first box id of the parent level) filters
    clamped coarser parent-row entries."""
    nchild = 2 ** dimensions
    rows_i = rows.to(torch.int64)
    pn = ntable[parents[rows_i].to(torch.int64)]          # (B, m)
    pid = _ids(pn).to(torch.int64)
    ok = (pn >= 0) & (pid >= min_id)
    ch = child_rows[pid]                                  # (B, m, 2^d)
    cand = torch.where(ok[..., None] & (ch > 0), ch,
                       torch.full_like(ch, -1)).reshape(len(rows), -1)
    pair_idx = torch.as_tensor(_list2_pair_index(dimensions),
                               device=rows.device)
    digit = prefixes[rows_i] & (nchild - 1)
    return torch.gather(cand, 1, pair_idx[digit])


def fgen_list4(rows, ntable, parents, prefixes, *, lb, dimensions, lsb):
    """List 4 at target level *lb*: coarser source leaves touching the
    parent of each row box but not the box itself, from one clamped row of
    the parent (``neighbors.py:419-441``)."""
    d = dimensions
    rows_i = rows.to(torch.int64)
    cells = morton.deinterleave(prefixes[rows_i], d)
    pcells = cells >> 1
    t = ntable[parents[rows_i].to(torch.int64)]
    ids = _ids(t)
    lev = _id_level(ids, lsb)
    valid = (_has(t, SRC_BIT)
             & _canonical_mask(pcells, lev, lb - 1, d)
             & _not_touching(cells, lb, pcells, lb - 1, lev, d))
    return torch.where(valid, ids, torch.full_like(ids, -1))


def fgen_list1_tgt(rows, ntable, prefixes, *, lt, dimensions, lsb):
    """Target-side List 1 of target boxes at level *lt*: the source
    leaves of the row at its level or coarser (``neighbors.py:444-472``)."""
    rows_i = rows.to(torch.int64)
    t = ntable[rows_i]
    ids = _ids(t)
    lev = _id_level(ids, lsb)
    row_is_tgt = _has(t[:, 3 ** dimensions // 2], TGT_BIT)
    cells = morton.deinterleave(prefixes[rows_i], dimensions)
    canon = _canonical_mask(cells, lev, lt, dimensions)
    return torch.where(_has(t, SRC_BIT) & canon & row_is_tgt[:, None], ids,
                       torch.full_like(ids, -1))


def fgen_list1_src(rows, ntable, prefixes, *, lt, dimensions, lsb):
    """Source-side List-1 keys ``(tgt << 32) | b``: the coarser target
    leaves touching source leaf *b* at level *lt*
    (``neighbors.py:506-530``)."""
    rows_i = rows.to(torch.int64)
    t = ntable[rows_i]
    ids = _ids(t)
    lev = _id_level(ids, lsb)
    row_is_src = _has(t[:, 3 ** dimensions // 2], SRC_BIT)
    cells = morton.deinterleave(prefixes[rows_i], dimensions)
    canon = _canonical_mask(cells, lev, lt, dimensions)
    valid = (_has(t, TGT_BIT) & (ids < lsb[lt]) & canon
             & row_is_src[:, None])
    keys = (ids.to(torch.int64) << 32) | rows_i[:, None]
    return torch.where(valid, keys, torch.full_like(keys, _INVALID_KEY))


def fgen_list3(rows, ntable, parents, prefixes, box_flags, *, ls,
               dimensions, lsb):
    """List-3 keys ``(tgt_box << 32) | w`` at source level *ls*: coarser
    target leaves touching parent(w) but not w (``neighbors.py:533-555``)."""
    d = dimensions
    rows_i = rows.to(torch.int64)
    cells = morton.deinterleave(prefixes[rows_i], d)
    pcells = cells >> 1
    t = ntable[parents[rows_i].to(torch.int64)]
    ids = _ids(t)
    lev = _id_level(ids, lsb)
    w_has_src = (box_flags[rows_i]
                 & (_F.IS_SOURCE_BOX | _F.HAS_SOURCE_CHILD_BOXES)) != 0
    valid = (_has(t, TGT_BIT)
             & _canonical_mask(pcells, lev, ls - 1, d)
             & _not_touching(cells, ls, pcells, ls - 1, lev, d)
             & w_has_src[:, None])
    keys = (ids.to(torch.int64) << 32) | rows_i[:, None]
    return torch.where(valid, keys, torch.full_like(keys, _INVALID_KEY))

# }}}
