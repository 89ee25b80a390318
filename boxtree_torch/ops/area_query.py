"""The level-by-level sweep behind the area queries, and the K6 and K7
kernels.

Port of ``boxtree_tpu/geometry/area_query.py:86-174, 259-286``.  A ball
is an l-inf ball (centre, radius); it overlaps a box when
``max_i |c_i - b_i| <= box_radius + radius``.  The sweep starts from every
``(ball, root)`` pair and, level by level, expands each frontier pair to
the overlapping children of its box: children that are leaves are hits,
the others the next frontier.  The host reads the number of hits and of
next pairs once per level, as the reference does.

- :func:`expand_frontier` is one level of the sweep: the K6 kernel
  (``csrc/area_query.cu``) on CUDA tensors, :func:`expand_frontier_plain`
  on CPU tensors.  The kernel appends in no fixed order; the keys are
  sorted at the end, which restores the reference's order.
- :func:`ball_leaf_keys` runs the whole sweep and returns the sorted
  ``(ball << 32) | leaf`` keys.
- :func:`space_invader` is the sweep with a leaf operation in place of the
  append: for each leaf, the largest l-inf distance from its centre to
  the centre of a ball overlapping it, as float32.  K7 on CUDA tensors;
  :func:`space_invader_plain` (the keys of the plain sweep, then a
  scatter-max) on CPU tensors.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels
from boxtree_torch.tree.containers import box_flags_enum

_IS_LEAF = box_flags_enum.IS_LEAF_BOX


def _box_radius(root_extent, levels):
    """``root_extent / (1 << (level + 1))`` in the root extent's dtype."""
    return root_extent / (1 << (levels.to(torch.int64) + 1))


# {{{ one level of the sweep (K6)

def expand_frontier_plain(ball_idx, box_idx, centers, radii, tree):
    """Plain twin of :func:`expand_frontier`, in the reference's order
    (``boxtree_tpu/geometry/area_query.py:86-127``)."""
    nchild = tree.box_child_ids.shape[0]
    children = tree.box_child_ids[:, box_idx.to(torch.int64)]   # (2^d, F)
    ch = children.to(torch.int64)
    bc = centers[:, ball_idx.to(torch.int64)]
    br = radii[ball_idx.to(torch.int64)]
    crad = _box_radius(tree.root_extent, tree.box_levels[ch])
    dist = (tree.box_centers[:, ch] - bc[:, None, :]).abs().amax(dim=0)
    overlap = (children > 0) & (dist <= crad + br[None, :])
    is_leaf = (tree.box_flags[ch] & _IS_LEAF) != 0
    balls = ball_idx[None, :].expand(nchild, -1).reshape(-1)
    boxes = children.reshape(-1)
    hit = (overlap & is_leaf).reshape(-1)
    descend = (overlap & ~is_leaf).reshape(-1)
    keys = (balls.to(torch.int64) << 32) | boxes.to(torch.int64)
    return (keys[hit], balls[descend].to(torch.int32),
            boxes[descend].to(torch.int32))


def _common_dtype(tree, centers, radii):
    return torch.promote_types(torch.promote_types(tree.coord_dtype,
                                                   centers.dtype),
                               radii.dtype)


def _kernel_args(tree, centers, radii):
    """The tree's arrays for K6/K7, in one float dtype.  The reference
    computes in the promoted dtype of its operands; casting every float to
    the common dtype of the three is the same arithmetic unless the
    radii are wider than the centres and the tree."""
    dt = _common_dtype(tree, centers, radii)
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported ball dtype {dt}")
    centers = centers.to(dt).contiguous()
    radii = radii.to(dt).contiguous()
    box_centers = tree.box_centers.to(dt).contiguous()
    root_extent = torch.as_tensor(tree.root_extent).to(
        device=centers.device, dtype=dt).reshape(1)
    child_ids = tree.box_child_ids.contiguous()
    kernels.check_tensors(centers, radii, box_centers, root_extent,
                          dtype=dt)
    kernels.check_tensors(child_ids, tree.box_levels, tree.box_flags,
                          dtype=torch.int32)
    return dt, (centers, centers.shape[1], radii, child_ids, tree.nboxes,
                box_centers, tree.box_levels, tree.box_flags, root_extent,
                tree.dimensions)


def expand_frontier(ball_idx, box_idx, centers, radii, tree):
    """One level of the sweep over the int32 frontier pairs ``(ball_idx,
    box_idx)``: returns ``(hit_keys, next_ball_idx, next_box_idx)``.

    CPU tensors take :func:`expand_frontier_plain`.  CUDA tensors launch
    K6 over (frontier pair, child digit); it appends through device
    counters into buffers of capacity ``2^d F``, in no fixed order.
    """
    if ball_idx.device.type == "cpu":
        return expand_frontier_plain(ball_idx, box_idx, centers, radii,
                                     tree)
    dt, args = _kernel_args(tree, centers, radii)
    kernels.check_tensors(ball_idx, box_idx, dtype=torch.int32)
    f = ball_idx.shape[0]
    cap = f * tree.box_child_ids.shape[0]
    dev = ball_idx.device
    hits = torch.empty(cap, dtype=torch.int64, device=dev)
    nb = torch.empty(cap, dtype=torch.int32, device=dev)
    nx = torch.empty(cap, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    if f:
        kernels.launch("area_query_sweep", dt, ball_idx, box_idx, f, *args,
                       hits, nb, nx, counts)
    n_hits, n_next = counts.tolist()
    return hits[:n_hits], nb[:n_next], nx[:n_next]

# }}}


# {{{ the sweep

def _root_is_leaf(tree):
    return bool(int(tree.box_flags[0]) & _IS_LEAF)


def _root_hits(tree, centers, radii):
    """Balls overlapping the root box, ascending (the root-is-leaf branch,
    ``area_query.py:142-153``)."""
    rad0 = float(tree.root_extent) / 2
    dist = (centers - tree.box_centers[:, 0][:, None]).abs().amax(dim=0)
    return torch.nonzero(dist <= rad0 + radii)[:, 0]


def ball_leaf_keys(tree, centers, radii, *, plain=False):
    """Sorted int64 ``(ball << 32) | leaf`` keys of every overlapping
    (ball, leaf) pair (``boxtree_tpu/geometry/area_query.py:130-174``).

    Each level runs :func:`expand_frontier`, or with *plain* its twin
    whatever the device.
    """
    dev = centers.device
    nballs = centers.shape[1]
    chunks = []
    if _root_is_leaf(tree):
        chunks.append(_root_hits(tree, centers, radii) << 32)
        ball_idx = box_idx = torch.zeros(0, dtype=torch.int32, device=dev)
    else:
        ball_idx = torch.arange(nballs, dtype=torch.int32, device=dev)
        box_idx = torch.zeros(nballs, dtype=torch.int32, device=dev)
    expand = expand_frontier_plain if plain else expand_frontier
    while ball_idx.shape[0]:
        hits, ball_idx, box_idx = expand(ball_idx, box_idx, centers, radii,
                                         tree)
        chunks.append(hits)
    if not chunks:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    return torch.sort(torch.cat(chunks)).values

# }}}


# {{{ space invader (K7)

def space_invader_plain(tree, centers, radii):
    """Plain twin of :func:`space_invader`: the keys of the plain sweep,
    then a scatter-max of the float32 distances (``area_query.py:
    259-286``, ``area_query_elementwise(..., combine="max")``)."""
    keys = ball_leaf_keys(tree, centers, radii, plain=True)
    balls = keys >> 32
    leaves = keys & 0xFFFFFFFF
    dist = (centers[:, balls] - tree.box_centers[:, leaves]).abs().amax(
        dim=0).to(torch.float32)
    out = torch.zeros(tree.nboxes, dtype=torch.float32, device=centers.device)
    return out.scatter_reduce(0, leaves, dist, reduce="amax",
                              include_self=True)


def space_invader(tree, centers, radii):
    """For each box, the largest l-inf distance from its centre to the
    centre of a ball overlapping it (0 where none, and for non-leaves),
    as float32.

    CPU tensors take :func:`space_invader_plain`.  CUDA tensors run the
    sweep with K7 at every level: on a hit it casts the distance to
    float32 and takes an integer ``atomicMax`` of its bits, which orders
    non-negative floats as the floats; nothing is appended but the next
    frontier, and nothing is sorted.
    """
    if centers.device.type == "cpu":
        return space_invader_plain(tree, centers, radii)
    dev = centers.device
    nballs = centers.shape[1]
    out = torch.zeros(tree.nboxes, dtype=torch.float32, device=dev)
    if _root_is_leaf(tree):
        # the root-is-leaf branch: no sweep, as in the reference
        balls = _root_hits(tree, centers, radii)
        if balls.shape[0]:
            out[0] = (centers[:, balls] - tree.box_centers[:, :1]).abs().amax(
                dim=0).to(torch.float32).max()
        return out
    if nballs == 0:
        return out
    dt, args = _kernel_args(tree, centers, radii)
    ball_idx = torch.arange(nballs, dtype=torch.int32, device=dev)
    box_idx = torch.zeros(nballs, dtype=torch.int32, device=dev)
    nchild = tree.box_child_ids.shape[0]
    while ball_idx.shape[0]:
        f = ball_idx.shape[0]
        nb = torch.empty(f * nchild, dtype=torch.int32, device=dev)
        nx = torch.empty(f * nchild, dtype=torch.int32, device=dev)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        kernels.launch("space_invader_sweep", dt, ball_idx, box_idx, f,
                       *args, out, nb, nx, count)
        n_next = int(count)
        ball_idx, box_idx = nb[:n_next], nx[:n_next]
    return out

# }}}
