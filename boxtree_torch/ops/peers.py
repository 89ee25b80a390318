"""Peer lists, and the K8 kernel.

Port of ``boxtree_tpu/geometry/area_query.py:293-369``: the peers of a box
at level ``l`` are the boxes at levels ``lp <= l`` that touch it and are
either at level ``l`` or, coarser, are leaves or have no existing child
touching the box.  Candidates come in the reference's order (coarser
level ``lp`` ascending, then the ``_offsets(d, 1)`` order), so the lists
equal the reference's, order included.

:func:`peer_lists` launches ``csrc/peers.cu`` (K8) twice on CUDA tensors,
a count pass and a fill pass with ``torch.cumsum`` between them, and runs
:func:`peer_lists_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels, morton
from boxtree_torch.traversal.neighbors import _offsets
from boxtree_torch.tree.containers import box_flags_enum

#: rows of one chunk of the plain twin (bounds its candidate tensors)
_ROW_CHUNK = 1 << 14


def _touch(cells_a, level_a, cells_b, level_b):
    """Closed-box intersection of boxes given by integer cells at static
    levels (``boxtree_tpu/traversal/build.py:183-194``)."""
    if level_a > level_b:
        cells_a, cells_b = cells_b, cells_a
        level_a, level_b = level_b, level_a
    s = level_b - level_a
    lo = cells_a << s
    hi = (cells_a + 1) << s
    return ((lo <= cells_b + 1) & (cells_b <= hi)).all(dim=0)


def _lookup(prefixes_l, level_start, cand_cells, level):
    """``(found, box_id)`` of the boxes at *level* with the given integer
    cells (``boxtree_tpu/traversal/build.py:229-239``)."""
    nl = prefixes_l.shape[0]
    nb = 1 << level
    in_range = ((cand_cells >= 0) & (cand_cells < nb)).all(dim=0)
    pfx = morton.interleave(cand_cells.clamp(0, nb - 1))
    idx = torch.searchsorted(prefixes_l, pfx)
    idxc = idx.clamp(0, nl - 1)
    found = in_range & (idx < nl) & (prefixes_l[idxc] == pfx)
    return found, (level_start + idxc).to(torch.int32)


def _gen_peers(rows_pfx, prefixes, box_flags, *, level, dimensions, lsb):
    """``(rows, K)`` peer candidates (``-1`` invalid) of boxes at *level*
    (``boxtree_tpu/geometry/area_query.py:293-337``)."""
    d = dimensions
    offs = torch.as_tensor(_offsets(d, 1), device=rows_pfx.device)
    cells = morton.deinterleave(rows_pfx, d)
    chunks = []
    for lp in range(level + 1):
        anc = cells >> (level - lp)
        cand = anc[:, :, None] + offs.T[:, None, :]
        found, box_id = _lookup(prefixes[lsb[lp]:lsb[lp + 1]], lsb[lp],
                                cand, lp)
        ok = found & _touch(cand, lp, cells[:, :, None], level)
        if lp == level:
            valid = ok
        else:
            idc = torch.where(found, box_id, 0).to(torch.int64)
            is_leaf = (box_flags[idc] & box_flags_enum.IS_LEAF_BOX) != 0
            any_child_touch = torch.zeros_like(ok)
            for digit in range(2 ** d):
                bits = torch.as_tensor(
                    [(digit >> (d - 1 - ax)) & 1 for ax in range(d)],
                    device=cand.device)
                ccell = (cand << 1) + bits[:, None, None]
                cfound, _ = _lookup(prefixes[lsb[lp + 1]:lsb[lp + 2]],
                                    lsb[lp + 1], ccell, lp + 1)
                any_child_touch |= cfound & _touch(
                    ccell, lp + 1, cells[:, :, None], level)
            valid = ok & (is_leaf | ~any_child_touch)
        chunks.append(torch.where(valid, box_id, -1))
    return torch.cat(chunks, dim=1)


def _starts(counts):
    starts = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                         device=counts.device)
    starts[1:] = torch.cumsum(counts.to(torch.int64), 0)
    return starts


def peer_lists_plain(prefixes, box_flags, *, dimensions, lsb):
    """Plain twin of :func:`peer_lists`."""
    counts, values = [], []
    for lev in range(len(lsb) - 1):
        for c0 in range(lsb[lev], lsb[lev + 1], _ROW_CHUNK):
            cand = _gen_peers(prefixes[c0:min(c0 + _ROW_CHUNK,
                                              lsb[lev + 1])],
                              prefixes, box_flags, level=lev,
                              dimensions=dimensions, lsb=lsb)
            counts.append((cand >= 0).sum(dim=1))
            values.append(cand[cand >= 0])
    dev = prefixes.device
    counts = torch.cat(counts) if counts else torch.zeros(
        0, dtype=torch.int64, device=dev)
    lists = torch.cat(values) if values else torch.zeros(
        0, dtype=torch.int32, device=dev)
    return _starts(counts).to(torch.int32), lists.to(torch.int32)


def peer_lists(prefixes, box_flags, *, dimensions, lsb):
    """CSR ``(starts, lists)``, both int32, of the peers of every box.

    :arg prefixes: ``(nboxes,)`` int64 Morton prefixes, level-major.
    :arg box_flags: ``(nboxes,)`` int32 box flags.
    :arg lsb: host tuple of the ``nlevels + 1`` level starts.

    CPU tensors take :func:`peer_lists_plain`.  CUDA tensors launch K8
    (``csrc/peers.cu``) twice, one thread per box: a count pass, then,
    after ``torch.cumsum`` of the counts, a fill pass.
    """
    if prefixes.device.type == "cpu":
        return peer_lists_plain(prefixes, box_flags, dimensions=dimensions,
                                lsb=lsb)
    if dimensions not in (1, 2, 3):
        raise ValueError(f"unsupported dimensions {dimensions}")
    kernels.check_tensors(prefixes, dtype=torch.int64)
    kernels.check_tensors(box_flags, dtype=torch.int32)
    dev = prefixes.device
    nboxes = lsb[-1]
    lsb_t = torch.as_tensor(lsb, dtype=torch.int64, device=dev)
    nlevels = len(lsb) - 1
    counts = torch.zeros(nboxes, dtype=torch.int32, device=dev)
    # count pass: starts and lists are not read
    kernels.launch("peer_lists", None, prefixes, box_flags, lsb_t, nlevels,
                   dimensions, nboxes, counts, lsb_t, counts, 0)
    starts = _starts(counts)
    lists = torch.empty(int(starts[-1]), dtype=torch.int32, device=dev)
    kernels.launch("peer_lists", None, prefixes, box_flags, lsb_t, nlevels,
                   dimensions, nboxes, counts, starts, lists, 1)
    return starts.to(torch.int32), lists
