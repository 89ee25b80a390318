"""Stick-out levels and box bounding boxes of trees with extents, and the
K12 and K13 kernels.

Port of ``boxtree_tpu/tree/build.py:85-107`` (``_stick_levels``) and
``:535-553`` (``_box_extents``):

- :func:`stick_levels`: for each particle with radius ``r``, the deepest
  level whose cell, enlarged by the stick-out factor, still holds the
  particle with its radius; a particle stops descending there.  K12
  (``csrc/extents.cu``) on CUDA tensors, :func:`stick_levels_plain` on CPU
  tensors.  Both run the reference's float steps in the coordinates' dtype
  and order with no FMA, so they agree bit for bit.
- :func:`box_extents`: each box's bounding box of its particles +-
  radius, combined bottom-up; every box starts at its own centre.  K13 on
  CUDA tensors (one launch over every box's own particle range, then one
  per level, finest first), :func:`box_extents_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels, morton


def _check_norm(extent_norm):
    if extent_norm not in ("linf", "l2"):
        raise ValueError(f"unexpected extent_norm: {extent_norm}")


# {{{ K12

def stick_levels_plain(coords, radii, bbox_min, root_extent, *, dimensions,
                       depth, extent_norm, stick_out_factor):
    """Plain twin of :func:`stick_levels`."""
    _check_norm(extent_norm)
    dt = coords.dtype
    cells = morton.cells_from_coords(coords, bbox_min, root_extent, depth)
    sof1 = torch.tensor(1.0 + float(stick_out_factor), dtype=torch.float64
                        ).to(dt)
    root_extent = torch.as_tensor(root_extent, dtype=dt)
    stick = torch.zeros(coords.shape[1], dtype=torch.int32,
                        device=coords.device)
    ok = torch.ones(coords.shape[1], dtype=torch.bool, device=coords.device)
    for lev in range(1, depth + 1):
        size = root_extent / (1 << lev)
        half = size / 2
        centers = (bbox_min[:, None] + (cells >> (depth - lev)).to(dt) * size
                   + half)
        sor = sof1 * half
        if extent_norm == "linf":
            fits = ((coords + radii < centers + sor)
                    & (coords - radii >= centers - sor)).all(dim=0)
        else:
            dx = coords - centers
            sq = dx[0] * dx[0]
            for ax in range(1, dimensions):
                sq = sq + dx[ax] * dx[ax]
            dist = torch.sqrt(sq) + radii
            fits = dist * dist < (dimensions * sor) * sor
        ok = ok & fits
        stick = stick + ok.to(torch.int32)
    return stick


def stick_levels(coords, radii, bbox_min, root_extent, *, dimensions, depth,
                 extent_norm, stick_out_factor):
    """int32 ``(n,)`` stick-out level of each particle of *coords*
    ``(d, n)`` with *radii* ``(n,)``, in the bounding box ``bbox_min``,
    ``root_extent`` and the tree's full Morton *depth*.

    CPU tensors take :func:`stick_levels_plain`; CUDA tensors launch K12
    (``csrc/extents.cu``), one thread per particle, which replaces
    ``boxtree_tpu/tree/build.py:85`` ``_stick_levels``.
    """
    if coords.device.type == "cpu":
        return stick_levels_plain(
            coords, radii, bbox_min, root_extent, dimensions=dimensions,
            depth=depth, extent_norm=extent_norm,
            stick_out_factor=stick_out_factor)
    _check_norm(extent_norm)
    dt = coords.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported coordinate dtype {dt}")
    if dimensions not in (2, 3) or coords.shape[0] != dimensions:
        raise ValueError(f"unsupported dimensions {dimensions}")
    n = coords.shape[1]
    coords = coords.contiguous()
    radii = radii.to(dt).contiguous()
    bbox_min = bbox_min.to(dt).contiguous()
    root_extent = torch.as_tensor(root_extent, dtype=dt,
                                  device=coords.device).reshape(1)
    kernels.check_tensors(coords, radii, bbox_min, root_extent, dtype=dt)
    if radii.shape != (n,):
        raise ValueError("radii must have one entry per particle")
    out = torch.empty(n, dtype=torch.int32, device=coords.device)
    kernels.launch("stick_levels", dt, coords, radii, n, bbox_min,
                   root_extent, dimensions, depth,
                   int(extent_norm == "l2"), 1.0 + float(stick_out_factor),
                   out)
    return out

# }}}


# {{{ K13

def box_extents_plain(coords, radii, box_starts, box_counts_nonchild,
                      box_centers, box_child_ids, *, lsb):
    """Plain twin of :func:`box_extents`: the reference's scatter-min and
    scatter-max of every particle into its box, then each level's boxes
    fold in their children, finest first."""
    dev = coords.device
    d, nboxes = box_centers.shape
    counts = box_counts_nonchild.to(torch.int64)
    owner = torch.repeat_interleave(
        torch.arange(nboxes, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = (box_starts.to(torch.int64)[owner]
           + torch.arange(owner.shape[0], device=dev) - first[owner])
    r = radii[pos] if radii is not None else 0.0
    x = coords[:, pos]
    idx = owner[None, :].expand(d, -1)
    bmin = box_centers.clone().scatter_reduce_(1, idx, x - r, "amin")
    bmax = box_centers.clone().scatter_reduce_(1, idx, x + r, "amax")
    for lev in range(len(lsb) - 3, -1, -1):
        ids = torch.arange(lsb[lev], lsb[lev + 1], device=dev)
        ch = box_child_ids[:, ids].to(torch.int64)        # (2^d, nl)
        has = (ch > 0)[None]
        for b, fold in ((bmin, torch.amin), (bmax, torch.amax)):
            own = b[:, ids][:, None]                      # (d, 1, nl)
            b[:, ids] = fold(torch.cat(
                [own, torch.where(has, b[:, ch], own)], dim=1), dim=1)
    return bmin, bmax


def box_extents(coords, radii, box_starts, box_counts_nonchild, box_centers,
                box_child_ids, *, lsb):
    """``(bmin, bmax)``, each ``(d, nboxes)``: every box's bounding box of
    the particles of its subtree, each grown by its radius (*radii* None:
    no radius), and of its own centre.

    *coords* ``(d, n)`` are in tree order, and box ``b``'s own particles
    are ``coords[:, box_starts[b]:box_starts[b] + box_counts_nonchild[b]]``
    (int32 ranges); *lsb* is the host tuple of level starts.

    CPU tensors take :func:`box_extents_plain`; CUDA tensors launch K13
    (``csrc/extents.cu``) once over every box, then once per level from
    the finest up; it replaces ``boxtree_tpu/tree/build.py:536``
    ``_box_extents``.
    """
    if coords.device.type == "cpu":
        return box_extents_plain(coords, radii, box_starts,
                                 box_counts_nonchild, box_centers,
                                 box_child_ids, lsb=lsb)
    dt = coords.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported coordinate dtype {dt}")
    d, nboxes = box_centers.shape
    if d not in (2, 3):
        raise ValueError(f"unsupported dimensions {d}")
    coords = coords.contiguous()
    has_radii = radii is not None
    radii = radii.to(dt).contiguous() if has_radii else coords
    box_centers = box_centers.contiguous()
    kernels.check_tensors(coords, radii, box_centers, dtype=dt)
    kernels.check_tensors(box_starts, box_counts_nonchild, box_child_ids,
                          dtype=torch.int32)
    bmin = torch.empty_like(box_centers)
    bmax = torch.empty_like(box_centers)
    args = (coords, radii, int(has_radii), coords.shape[1], box_starts,
            box_counts_nonchild, box_centers, box_child_ids, nboxes)
    kernels.launch("box_extents", dt, *args, -1, -1, d, bmin, bmax)
    for lev in range(len(lsb) - 3, -1, -1):
        kernels.launch("box_extents", dt, *args, lsb[lev], lsb[lev + 1], d,
                       bmin, bmax)
    return bmin, bmax

# }}}
