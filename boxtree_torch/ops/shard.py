"""The per-rank steps of the sharded tree build: the K83-K88 kernels.

Each runs on one rank's tensors, on that rank's device; the collectives
between ranks are :class:`boxtree_torch.parallel.mesh.Mesh`'s.  Keys are
int64 with ``PAD = INT64_MAX`` for an empty slot (it sorts last).

- K83 :func:`bucket_pack` (``boxtree_tpu/parallel/shard_sort.py:109-121``
  and ``:317-324``): the fixed-capacity send buffer of the sample sort and
  of the permutation's requests, ``send[b, j] = local[start[b] + j]`` for
  ``j < len[b]``, else PAD (payloads 0), and the overflow flag.
- K84 :func:`rebalance_place` (``shard_sort.py:211-232``): the received
  neighbour segments placed into the rank's equal shard.
- K85 :func:`permute_serve` (``shard_sort.py:327-340``): the owner gathers
  the requested rows of its data block and records the inverse
  permutation.
- K86 :func:`permute_unpack` (``shard_sort.py:342-350``): the requester
  puts the replied rows back in slot order.
- K87 :func:`shard_leaf_levels` (``boxtree_tpu/parallel/shard_build.py:
  296-333``, the adaptive branch): a rank's leaf levels and its share of
  the per-level box counts, from its keys and the gathered boundary
  summaries of :func:`leaf_summary`.
- K88 :func:`shard_box_skeleton` (``shard_build.py:713-870``, without
  sources flags and extents): a rank's boxes of one level, from the
  level's cumulative counts and the gathered :func:`skeleton_summary`.

Every wrapper runs its plain twin (the ``*_plain`` function, the
reference's step in PyTorch) on CPU tensors and launches its kernel
(``csrc/shard.cu``) on CUDA tensors; both give the same integers and
move the same values.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import kernels

#: the empty slot of a key buffer (``shard_sort.py:37``)
PAD = torch.iinfo(torch.int64).max

_I64 = torch.int64


def _vals2d(vals, per, device):
    """Payload columns as one ``(V, per)`` int64 tensor (V may be 0)."""
    if vals is None:
        return torch.zeros((0, per), dtype=_I64, device=device)
    return vals.to(_I64).reshape(-1, per)


# {{{ K83 bucket_pack

def bucket_pack_plain(local, vals, starts, cap, val_offset=0):
    """Plain twin of :func:`bucket_pack`."""
    per = local.shape[0]
    nb = starts.shape[0] - 1
    vals = _vals2d(vals, per, local.device)
    lens = starts[1:] - starts[:-1]
    j = torch.arange(cap, dtype=_I64, device=local.device)
    rows = (starts[:-1, None] + j[None, :]).clamp(0, max(per - 1, 0))
    valid = j[None, :] < lens[:, None]
    send = torch.where(valid, local[rows], PAD)
    vsend = torch.where(valid[None], vals[:, rows] + val_offset, 0)
    over = (lens > cap).any().to(torch.int32).reshape(1)
    return send.reshape(nb, cap), vsend.reshape(-1, nb, cap), over


def bucket_pack(local, vals, starts, cap, val_offset=0):
    """The fixed-capacity send buffer of sorted keys cut into buckets.

    :arg local: ``(per,)`` int64 keys, ascending.
    :arg vals: ``(V, per)`` int64 payload columns, or None.
    :arg starts: ``(nranks + 1,)`` int64 bucket starts, ``starts[0] = 0``,
        ``starts[-1] = per``.
    :arg cap: the slots of a bucket.
    :arg val_offset: added to the payloads of the filled slots (the
        permutation's requests carry ``rank * per + j``).
    :returns: ``(send, vsend, over)``: ``(nranks, cap)`` keys, PAD where a
        bucket is shorter; ``(V, nranks, cap)`` payloads, 0 there; and an
        int32 ``(1,)`` flag, 1 if a bucket holds more than *cap* keys
        (those past *cap* are not sent).
    """
    if local.device.type == "cpu":
        return bucket_pack_plain(local, vals, starts, cap, val_offset)
    per = local.shape[0]
    nb = starts.shape[0] - 1
    vals = _vals2d(vals, per, local.device).contiguous()
    starts = starts.to(_I64).contiguous()
    kernels.check_tensors(local, vals, starts, dtype=_I64)
    send = torch.empty((nb, cap), dtype=_I64, device=local.device)
    vsend = torch.empty((vals.shape[0], nb, cap), dtype=_I64,
                        device=local.device)
    over = torch.zeros(1, dtype=torch.int32, device=local.device)
    kernels.launch("bucket_pack", None, local, per, vals, vals.shape[0],
                   starts, nb, cap, int(val_offset), send, vsend, over)
    return send, vsend, over

# }}}


# {{{ K84 rebalance_place

def rebalance_place_plain(segments, per, nvals):
    """Plain twin of :func:`rebalance_place`."""
    dev = segments[0][3].device if segments else None
    out = torch.full((per,), PAD, dtype=_I64, device=dev)
    vout = torch.zeros((nvals, per), dtype=_I64, device=dev)
    for src, dst, ln, keys, vals in segments:
        out[dst:dst + ln] = keys[src:src + ln]
        for v in range(nvals):
            vout[v, dst:dst + ln] = vals[v][src:src + ln]
    return out, vout


def rebalance_place(segments, per, nvals, device=None):
    """A rank's equal shard from the segments it receives.

    :arg segments: ``(src, dst, len, keys, vals)`` tuples: *len* keys of
        the int64 tensor *keys* from slot *src* on go to slots *dst* on,
        with the same slots of each of the *nvals* int64 tensors *vals*.
        The tensors lie on the rank's device (a sender's own buffer where
        the two ranks share it).
    :arg device: the rank's device, for a rank that receives nothing.
    :returns: ``(out, vout)``: ``(per,)`` keys, PAD where no segment
        lands, and ``(nvals, per)`` payloads, 0 there.
    """
    if device is None:
        device = segments[0][3].device
    if torch.device(device).type == "cpu":
        if not segments:
            return (torch.full((per,), PAD, dtype=_I64),
                    torch.zeros((nvals, per), dtype=_I64))
        return rebalance_place_plain(segments, per, nvals)
    # the header table: one row a segment, (src, dst, len, key pointer,
    # payload pointers); the kernel reads every segment where it lies
    rows = []
    for src, dst, ln, keys, vals in segments:
        kernels.check_tensors(keys, *vals, dtype=_I64)
        if keys.device != torch.device(device):
            raise ValueError("a segment lies on another device")
        rows.append([src, dst, ln, keys.data_ptr(),
                     *(v.data_ptr() for v in vals)])
    out = torch.empty(per, dtype=_I64, device=device)
    vout = torch.empty((nvals, per), dtype=_I64, device=device)
    table = torch.tensor(rows, dtype=_I64).reshape(-1, 4 + nvals).to(
        device)
    kernels.launch("rebalance_place", None, table, table.shape[0], nvals,
                   per, out, vout)
    # the table is read by the kernel after this returns: the caching
    # allocator hands its memory out again only to later work on this
    # stream, so dropping the reference here is safe
    return out, vout

# }}}


# {{{ K85 permute_serve

def permute_serve_plain(got_o, got_s, data, base):
    """Plain twin of :func:`permute_serve`."""
    per, k = data.shape
    valid = got_o != PAD
    loc = (got_o - base).clamp(0, per - 1)
    reply = torch.where(valid[..., None], data[loc.reshape(-1)].reshape(
        *got_o.shape, k), torch.zeros((), dtype=data.dtype,
                                      device=data.device))
    inv = torch.zeros(per + 1, dtype=_I64, device=data.device)
    inv[torch.where(valid, loc, per).reshape(-1)] = got_s.reshape(-1)
    return reply, inv[:per]


def permute_serve(got_o, got_s, data, base):
    """The owner's side of a permutation.

    :arg got_o: ``(nranks, cap)`` int64 requested original indices, PAD
        for an empty slot.
    :arg got_s: ``(nranks, cap)`` int64 sorted slots of the requests.
    :arg data: ``(per, k)`` float32 / float64 rows of the originals
        ``base .. base + per - 1``.
    :returns: ``(reply, inverse)``: ``(nranks, cap, k)`` requested rows, 0
        for an empty slot, and the ``(per,)`` int64 sorted slot of each of
        the rank's originals (0 where none was requested).
    """
    if data.device.type == "cpu":
        return permute_serve_plain(got_o, got_s, data, base)
    kernels.check_tensors(got_o, got_s, dtype=_I64)
    kernels.check_tensors(data, dtype=data.dtype)
    per, k = data.shape
    reply = torch.empty((*got_o.shape, k), dtype=data.dtype,
                        device=data.device)
    inv = torch.zeros(per, dtype=_I64, device=data.device)
    kernels.launch("permute_serve", data.dtype, got_o, got_s, got_o.numel(),
                   data, per, k, int(base), reply, inv)
    return reply, inv

# }}}


# {{{ K86 permute_unpack

def permute_unpack_plain(reply, starts, j_sorted):
    """Plain twin of :func:`permute_unpack`."""
    per = j_sorted.shape[0]
    cap, k = reply.shape[1], reply.shape[2]
    t = torch.arange(per, dtype=_I64, device=reply.device)
    dest = torch.searchsorted(starts[1:].contiguous(), t, right=True)
    lane = (t - starts[dest]).clamp(0, cap - 1)
    out = torch.zeros((per, k), dtype=reply.dtype, device=reply.device)
    out[j_sorted] = reply[dest, lane]
    return out


def permute_unpack(reply, starts, j_sorted):
    """The requester's side of a permutation: ``out[j_sorted[t]] =
    reply[b, t - starts[b]]``, *b* the bucket of position *t*.

    :arg reply: ``(nranks, cap, k)`` float32 / float64 rows, block *b*
        from owner *b*.
    :arg starts: ``(nranks + 1,)`` int64 bucket starts of the requests.
    :arg j_sorted: ``(per,)`` int64 slots of the requests in bucket order
        (a permutation of ``0 .. per - 1``).
    :returns: ``(per, k)`` rows in slot order.
    """
    if reply.device.type == "cpu":
        return permute_unpack_plain(reply, starts, j_sorted)
    kernels.check_tensors(reply, dtype=reply.dtype)
    starts = starts.to(_I64).contiguous()
    kernels.check_tensors(starts, j_sorted, dtype=_I64)
    per = j_sorted.shape[0]
    nb, cap, k = reply.shape
    out = torch.empty((per, k), dtype=reply.dtype, device=reply.device)
    kernels.launch("permute_unpack", reply.dtype, reply, nb, cap, k, starts,
                   j_sorted, per, out)
    return out

# }}}


# {{{ K87 shard_leaf_levels (sharded phase A)

def level_masks(dimensions, depth, device):
    """``(depth + 1,)`` int64: the key bits below each level's prefix."""
    shifts = dimensions * (depth - torch.arange(depth + 1, dtype=_I64,
                                                device=device))
    return torch.bitwise_left_shift(torch.ones_like(shifts), shifts) - 1


def leaf_summary(codes, cumw, masks):
    """A rank's boundary summary for :func:`shard_leaf_levels`, one row of
    ``3 + 2 (depth + 1)`` int64: its first and last key, its total
    weight, and at every level the weight of its first and of its last
    prefix run (the head and the tail).  Library ``searchsorted``s.

    :arg codes: ``(per,)`` int64 keys, ascending.
    :arg cumw: ``(per + 1,)`` int64 exclusive cumulative weights, or None
        for unit weights.
    :arg masks: :func:`level_masks`.
    """
    per = codes.shape[0]
    c0, cl = codes[:1], codes[-1:]
    head_end = torch.searchsorted(codes, c0 | masks, right=True)
    tail_start = torch.searchsorted(codes, cl & ~masks)
    if cumw is None:
        total = torch.full((1,), per, dtype=_I64, device=codes.device)
        head, tail = head_end, per - tail_start
    else:
        total = cumw[-1:]
        head, tail = cumw[head_end], total - cumw[tail_start]
    return torch.cat([c0, cl, total, head, tail])


def halo_weights(summ, rank, dimensions, depth):
    """``(left, right)`` lists of ``depth + 1`` ints: at every level the
    weight that other ranks add to the box of rank *rank*'s first key
    (left) and of its last key (right).  A box may span several shards;
    a shard strictly inside it is a single prefix run, whose weight is
    its whole (``shard_build.py:53-152``)."""
    rows = summ.tolist()
    nranks = len(rows)
    ncol = depth + 1
    left, right = [0] * ncol, [0] * ncol
    for lev in range(ncol):
        s = dimensions * (depth - lev)
        p0, p1 = rows[rank][0] >> s, rows[rank][1] >> s
        for q in range(rank - 1, -1, -1):
            if rows[q][1] >> s != p0:
                break
            single = rows[q][0] >> s == p0
            left[lev] += rows[q][2] if single else rows[q][3 + ncol + lev]
            if not single:
                break
        for q in range(rank + 1, nranks):
            if rows[q][0] >> s != p1:
                break
            single = rows[q][1] >> s == p1
            right[lev] += rows[q][2] if single else rows[q][3 + lev]
            if not single:
                break
    return left, right


def cumulative_weights(weights):
    """``(per + 1,)`` int64 exclusive cumulative refine weights (a library
    ``cumsum``), or None for unit weights."""
    if weights is None:
        return None
    cumw = torch.zeros(weights.shape[0] + 1, dtype=_I64,
                       device=weights.device)
    cumw[1:] = torch.cumsum(weights.to(_I64), 0)
    return cumw


def shard_leaf_levels_plain(codes, cumw, summ, rank, max_weight, *,
                            dimensions, depth):
    """Plain twin of :func:`shard_leaf_levels`: the reference's level loop
    on one rank, its boundary boxes' weights completed from *summ*."""
    from boxtree_torch.ops.tree import segment_totals

    per = codes.shape[0]
    dev = codes.device
    w = (cumw[1:] - cumw[:-1] if cumw is not None
         else torch.ones(per, dtype=_I64, device=dev))
    left, right = halo_weights(summ, rank, dimensions, depth)
    left_last = int(summ[rank - 1, 1]) if rank > 0 else None
    counts = torch.zeros(depth + 2, dtype=_I64, device=dev)
    leaf = torch.full((per,), depth, dtype=torch.int32, device=dev)
    assigned = torch.zeros(per, dtype=torch.bool, device=dev)
    for lev in range(depth + 1):
        if bool(assigned.all()):
            break
        s = dimensions * (depth - lev)
        pfx = codes >> s
        is_start = torch.ones(per, dtype=torch.bool, device=dev)
        is_start[1:] = pfx[1:] != pfx[:-1]
        wt = segment_totals(w[None], is_start)[0]
        wt = wt + torch.where(pfx == pfx[0], left[lev], 0) \
            + torch.where(pfx == pfx[-1], right[lev], 0)
        glob_start = is_start.clone()
        if left_last is not None:
            glob_start[0] = (left_last >> s) != int(pfx[0])
        active = ~assigned
        counts[lev] = (glob_start & active).sum()
        done = active & (wt <= max_weight)
        leaf = torch.where(done, torch.full_like(leaf, lev), leaf)
        assigned = assigned | done
    n_unfit = (~assigned).sum().reshape(1)
    return leaf, torch.cat([counts, n_unfit])


def shard_leaf_levels(codes, cumw, summ, rank, max_weight, *,
                      dimensions, depth):
    """One rank's leaf levels and its share of the boxes of every level.

    :arg codes: ``(per,)`` int64 keys of the rank's shard, ascending; the
        shards in rank order are the globally sorted keys.
    :arg cumw: :func:`cumulative_weights` of the shard's refine weights,
        or None for unit weights.
    :arg summ: ``(nranks, 3 + 2 (depth + 1))`` int64: every rank's
        :func:`leaf_summary`, gathered.
    :arg rank: this rank.
    :returns: ``(leaf, packed)``: ``(per,)`` int32 leaf levels, and
        ``(depth + 3,)`` int64: the rank's box starts at every level ``0
        .. depth + 1`` and its particles in overfull boxes at *depth*;
        summed over the ranks these are ``_phase_a``'s counts.

    CPU tensors take :func:`shard_leaf_levels_plain`; CUDA tensors launch
    K87 once.
    """
    if codes.device.type == "cpu":
        return shard_leaf_levels_plain(codes, cumw, summ, rank, max_weight,
                                       dimensions=dimensions, depth=depth)
    per = codes.shape[0]
    dev = codes.device
    has_w = cumw is not None
    cumw = cumw if has_w else codes   # a placeholder with unit weights
    summ = summ.contiguous()
    kernels.check_tensors(codes, cumw, summ, dtype=_I64)
    leaf = torch.empty(per, dtype=torch.int32, device=dev)
    packed = torch.zeros(depth + 3, dtype=_I64, device=dev)
    kernels.launch("shard_leaf_levels", None, codes, per, cumw,
                   int(has_w), summ, summ.shape[0], rank,
                   int(max_weight), dimensions, depth, leaf, packed)
    return leaf, packed

# }}}


# {{{ K88 shard_box_skeleton (sharded phase B)

#: the columns of a :func:`skeleton_summary` row before its digits
SKEL_COLS = 5


def level_starts_and_counts(leaf, thr, level):
    """The box starts of one level on a rank: the inclusive count of
    starts (int64 ``(per,)``) and the exclusive count of particles at or
    below the level (int64 ``(per + 1,)``), two library ``cumsum``s."""
    act = leaf >= level
    cs = torch.cumsum(act & (thr < level), 0, dtype=_I64)
    ca = torch.zeros(leaf.shape[0] + 1, dtype=_I64, device=leaf.device)
    ca[1:] = torch.cumsum(act, 0, dtype=_I64)
    return cs, ca


def skeleton_summary(codes, leaf, cs, ca, prev_cs, level, *, dimensions,
                     depth):
    """A rank's row of one level for :func:`shard_box_skeleton`, int64
    ``(5 + 2^d,)``: its box starts, its first prefix, whether its first
    particle is at or below the level, the particles before its first
    start that are (the continuation of the box spanning its left
    boundary), how many of its first boxes have their parent on an
    earlier rank (at most ``2^d``), and the child digits of its first
    ``2^d`` boxes (``shard_build.py:769-866``).  Small library ops."""
    per = codes.shape[0]
    nchild = 2 ** dimensions
    dev = codes.device
    s = dimensions * (depth - level)
    k = torch.arange(1, nchild + 1, dtype=_I64, device=dev)
    nloc = cs[-1:]
    first = torch.searchsorted(cs, k[:1])
    reps = torch.searchsorted(cs, k).clamp(max=per - 1)
    digits = (codes[reps] >> s) & (nchild - 1)
    if prev_cs is None:
        remote = torch.zeros(1, dtype=_I64, device=dev)
    else:
        remote = ((k <= nloc) & (prev_cs[reps] < 1)).sum().reshape(1)
    return torch.cat([nloc, codes[:1] >> s, (leaf[:1] >= level).to(_I64),
                      ca[first], remote, digits])


def _exclusive(col, rank):
    return int(col[:rank].sum())


def shard_box_skeleton_plain(codes, leaf, thr, cs, ca, prev_cs, summ,
                             prev_summ, rowbase, out, *, rank, level, b0,
                             prev_lstart, base, dimensions, depth):
    """Plain twin of :func:`shard_box_skeleton`: the reference's level
    body on one rank (``shard_build.py:713-870``)."""
    per = codes.shape[0]
    nchild = 2 ** dimensions
    cap = out["box_id"].shape[0]
    dev = codes.device
    s = dimensions * (depth - level)
    rows = summ.tolist()
    nloc = rows[rank][0]
    offset = _exclusive(summ[:, 0], rank)
    nmine = int(rowbase[level])
    # the chain of following shards that continue my last box
    p_last = int(codes[-1]) >> s
    contribs = 0
    for q in range(rank + 1, len(rows)):
        if not (rows[q][1] == p_last and rows[q][2] == 1):
            break
        contribs += rows[q][3]
        if rows[q][0] > 0:
            break
    is_start = (leaf >= level) & (thr < level)
    reps = torch.nonzero(is_start)[:, 0]
    kk = torch.arange(reps.shape[0], dtype=_I64, device=dev)
    nxt = torch.cat([reps[1:], reps.new_full((1,), per)])
    cumul = ca[nxt] - ca[reps]
    cumul[-1:] += contribs
    gid = b0 + offset + kk
    row = nmine + kk
    keep = row < cap
    pfx = codes[reps] >> s
    out["box_id"][row[keep]] = gid[keep]
    out["box_morton"][row[keep]] = pfx[keep]
    out["box_level"][row[keep]] = level
    out["box_start"][row[keep]] = base + reps[keep]
    out["box_count_cumul"][row[keep]] = cumul[keep]
    if level == 0:
        return out
    prev_offset = _exclusive(prev_summ[:, 0], rank)
    prev_rowbase = int(rowbase[level - 1])
    pc = prev_cs[reps]
    par = prev_lstart + prev_offset + pc - 1
    out["box_parent"][row[keep]] = par[keep]
    digit = pfx & (nchild - 1)
    prow = prev_rowbase + pc - 1
    ok = (pc >= 1) & (prow < cap)
    out["box_child"][prow[ok], digit[ok]] = gid[ok]
    # children that other ranks hold of my box spanning their left
    # boundary
    my_lo = prev_lstart + prev_offset
    my_hi = my_lo + int(prev_summ[rank, 0])
    for q in range(len(rows)):
        par_q = prev_lstart + _exclusive(prev_summ[:, 0], q) - 1
        if not my_lo <= par_q < my_hi:
            continue
        prow2 = prev_rowbase + par_q - my_lo
        if prow2 >= cap:
            continue
        off_q = _exclusive(summ[:, 0], q)
        for j in range(rows[q][4]):
            out["box_child"][prow2, rows[q][SKEL_COLS + j]] = b0 + off_q + j
    return out


def shard_box_skeleton(codes, leaf, thr, cs, ca, prev_cs, summ, prev_summ,
                       rowbase, out, *, rank, level, b0, prev_lstart, base,
                       dimensions, depth):
    """Write a rank's boxes of one level into its skeleton rows *out*.

    :arg codes: ``(per,)`` int64 keys of the rank, ascending.
    :arg leaf: ``(per,)`` int32 leaf levels.
    :arg thr: ``(per,)`` int32: the deepest level at which each particle
        continues its predecessor's box (its predecessor on the left rank
        for the first; -1 on rank 0), so it starts a box at level *l*
        exactly when ``thr < l <= leaf``.
    :arg cs, ca: :func:`level_starts_and_counts` of the level.
    :arg prev_cs: the same *cs* of the level above (ignored at level 0).
    :arg summ, prev_summ: ``(nranks, 5 + 2^d)`` int64
        :func:`skeleton_summary` rows of every rank at this level and the
        level above (ignored at level 0).
    :arg rowbase: ``(nlevels + 1,)`` int64: the rank's rows before each
        level.
    :arg out: the rank's rows (``box_id``, ``box_morton``, ``box_level``,
        ``box_start``, ``box_count_cumul``, ``box_parent``, ``box_child``),
        updated in place; ``box_child`` rows of the level above gain their
        children.
    :arg b0: the level's first global box id; *prev_lstart* the level
        above's; *base* the rank's first global particle.

    CPU tensors take :func:`shard_box_skeleton_plain`; CUDA tensors launch
    K88 once.
    """
    kw = dict(rank=rank, level=level, b0=b0, prev_lstart=prev_lstart,
              base=base, dimensions=dimensions, depth=depth)
    if codes.device.type == "cpu":
        return shard_box_skeleton_plain(codes, leaf, thr, cs, ca, prev_cs,
                                        summ, prev_summ, rowbase, out, **kw)
    if prev_cs is None:
        prev_cs, prev_summ = cs, summ
    summ, prev_summ = summ.contiguous(), prev_summ.contiguous()
    kernels.check_tensors(codes, cs, ca, prev_cs, summ, prev_summ, rowbase,
                          dtype=_I64)
    kernels.check_tensors(leaf, thr, dtype=torch.int32)
    kernels.check_tensors(out["box_id"], out["box_morton"],
                          out["box_start"], out["box_count_cumul"],
                          out["box_parent"], out["box_child"], dtype=_I64)
    kernels.check_tensors(out["box_level"], dtype=torch.int32)
    kernels.launch("shard_box_skeleton", None, codes, codes.shape[0], leaf,
                   thr, cs, ca, prev_cs, summ, prev_summ, summ.shape[0],
                   rowbase, rank, level, b0, prev_lstart, base,
                   out["box_id"].shape[0], dimensions, depth, out["box_id"],
                   out["box_morton"], out["box_level"], out["box_start"],
                   out["box_count_cumul"], out["box_parent"],
                   out["box_child"])
    return out

# }}}
