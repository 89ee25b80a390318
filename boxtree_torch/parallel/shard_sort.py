"""Distributed key sort, rebalance and permutation over a
:class:`~boxtree_torch.parallel.mesh.Mesh` of rank slots.

Port of :mod:`boxtree_tpu.parallel.shard_sort` (``shard_sort.py:1-375``),
the front of the sharded tree build.  The reference's sample sort, recast
for fixed shapes:

1. each rank sorts its keys (library ``torch.sort``, stable),
2. a sample of every rank is gathered and ``nranks - 1`` splitters read
   off the sorted whole sample,
3. each rank's sorted keys split into ``nranks`` contiguous buckets
   (library ``searchsorted``),
4. one ``all_to_all`` ships bucket *b* of every rank to rank *b* in a
   padded buffer of fixed capacity (K83 packs it and flags an overflow),
5. each rank sorts what it received; the padding (``INT64_MAX``) sorts
   last.

:func:`sharded_rebalance` then equalizes the ragged shards by neighbour
segments (K84), and :func:`sharded_permute` applies a distributed
permutation to rows held in original order (K83 for the requests, K85 on
the owners, K86 on the requesters).

A sharded array is a list of one tensor a rank, each on its rank's
device, in rank order; ``torch.stack`` of one whose ranks share a device
is the reference's ``(nranks, ...)`` array.  The functions take a whole
``(n, ...)`` tensor as well (split into equal row blocks).  The ``ok``
flags and the counts are returned, never asserted: the caller retries, as
:func:`boxtree_torch.parallel.shard_build.sharded_build_tree` does.  A key
sort and a permutation read the host once each (their counts and flags,
packed); a rebalance reads nothing, its segments following from the
counts the sort gave the host.
"""

from __future__ import annotations

import numpy as np
import torch

from boxtree_torch.ops import shard
from boxtree_torch.parallel.mesh import Mesh

PAD = shard.PAD


def as_mesh(mesh, device):
    """A :class:`Mesh`: *mesh* itself, or for an int that many ranks on
    the cards of *device*'s type (``Mesh.of_ranks``)."""
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh.of_ranks(int(mesh), device)


def shards_of(x, mesh):
    """A sharded array on *mesh*: a list of per-rank tensors is moved to
    the ranks' devices; a ``(n, ...)`` tensor is cut into ``nranks``
    equal row blocks (views where a rank's device is the tensor's)."""
    nranks = mesh.size
    if isinstance(x, (list, tuple)):
        if len(x) != nranks:
            raise ValueError(f"{len(x)} shards for {nranks} ranks")
        return [torch.as_tensor(s).to(d) for s, d in zip(x, mesh.devices)]
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % nranks:
        raise ValueError(f"n={n} not divisible by nranks={nranks}")
    per = n // nranks
    return [x[r * per:(r + 1) * per].to(d)
            for r, d in enumerate(mesh.devices)]


def _as_tuple(vals):
    """The payloads: a tuple holds several, anything else (a tensor, a
    list of shards) is one."""
    if vals is None:
        return ()
    return vals if isinstance(vals, tuple) else (vals,)


def _lex_sort(keys, vals, num_keys):
    """*keys* and *vals* sorted stably by ``(keys, vals[0], ...)``, the
    first *num_keys* of them (``lax.sort((keys, *vals), num_keys=...)``):
    one stable sort a sort key, the last first."""
    cols = [keys, *vals]
    perm = None
    for col in reversed(cols[:num_keys]):
        c = col if perm is None else col[perm]
        idx = torch.sort(c, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return keys[perm], [v[perm] for v in vals]


def _host_status(mesh, rows):
    """One host read of the ranks' small int64 status rows, gathered on
    rank 0's device: a ``(nranks, k)`` CPU tensor."""
    return mesh.gather([r.to(torch.int64) for r in rows]).cpu()


def _returns(main, vals, vouts, tail):
    """The reference's return convention: the payloads as given, one or a
    tuple."""
    if vals is None:
        return (main, *tail)
    if not isinstance(vals, tuple):
        return (main, vouts[0], *tail)
    return (main, tuple(vouts), *tail)


def sharded_key_sort(keys, mesh, *, oversample=64, capacity_factor=2.0,
                     vals=None, num_keys=1):
    """Sort int64 *keys* distributed over *mesh* (``shard_sort.py:46``).

    :arg keys: ``(n,)`` int64, n divisible by the ranks, or its shards.
    :arg vals: optional ``(n,)`` int64 payload (a tensor, or a list of its
        shards), or a tuple of such, carried through the sort; ties keep
        input order.
    :arg num_keys: with 2 the first payload is a secondary sort key
        (splitters and buckets use the primary key only).
    :returns: ``(sorted_padded, counts, ok)``: per-rank ``(nranks *
        cap,)`` sorted shards, ``cap = ceil(capacity_factor * per /
        nranks)``, padded with ``INT64_MAX``; the ranks' valid counts, a
        ``(nranks,)`` int64 CPU tensor; and False if some bucket
        overflowed its capacity (retry with a larger factor).  With
        *vals*, ``(sorted_padded, vals_padded, counts, ok)``, the payloads
        padded with 0 and a tuple where *vals* was.
    """
    nranks = mesh.size
    keys_s = shards_of(keys, mesh)
    per = keys_s[0].shape[0]
    cap = int(np.ceil(capacity_factor * per / nranks))
    nsamp = min(per, oversample)
    vals_t = [shards_of(v, mesh) for v in _as_tuple(vals)]
    nvals = len(vals_t)
    if num_keys > 1 + nvals:
        raise ValueError("num_keys exceeds 1 + len(vals)")

    # local sort and the sample of each rank (primary key only)
    stride = max(1, per // nsamp)
    local, lvals, samples = [], [], []
    for r in range(nranks):
        k, vs = _lex_sort(keys_s[r], [v[r] for v in vals_t], num_keys)
        local.append(k)
        lvals.append(torch.stack(vs) if vs else None)
        samples.append(k[::stride][:nsamp])
    allsamp = mesh.all_gather(samples)

    # splitters, bucket starts and the padded send buffers (K83)
    sends, vsends, over = [], [], []
    for r, dev in enumerate(mesh.devices):
        srt = torch.sort(allsamp[r].reshape(-1)).values
        m = srt.shape[0]
        splitters = srt[(torch.arange(1, nranks, device=dev) * m) // nranks]
        starts = torch.cat([
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.searchsorted(local[r], splitters),
            torch.full((1,), per, dtype=torch.int64, device=dev)])
        send, vsend, ov = shard.bucket_pack(local[r], lvals[r], starts, cap)
        sends.append(send)
        vsends.append(vsend)
        over.append(ov)

    recv = mesh.all_to_all(sends)
    vrecv = [mesh.all_to_all([vs[v] for vs in vsends]) for v in range(nvals)]
    merged, mvals, status = [], [[] for _ in range(nvals)], []
    for r in range(nranks):
        k, vs = _lex_sort(recv[r].reshape(-1),
                          [vr[r].reshape(-1) for vr in vrecv], num_keys)
        merged.append(k)
        for v in range(nvals):
            mvals[v].append(vs[v])
        status.append(torch.cat([(k != PAD).sum().reshape(1),
                                 over[r].to(torch.int64)]))
    status = _host_status(mesh, status)
    counts, ok = status[:, 0], not bool(status[:, 1].any())
    return _returns(merged, vals, mvals, (counts, ok))


def sharded_rebalance(merged, counts, mesh, *, radius=2, vals=None):
    """Equalize the sample sort's ragged shards to ``n / nranks`` keys
    each, keeping the global order (``shard_sort.py:150``).

    The key at global position *p* belongs to rank ``p // per``; each rank
    keeps its diagonal slice and receives from the ranks within *radius*
    the segments that land in its shard, placed by K84.  The segments
    follow from *counts* on the host.

    :arg merged: per-rank padded sorted shards (``sharded_key_sort``).
    :arg counts: the ranks' valid counts (host values: a CPU tensor, a
        list or an array); their sum must be divisible by the ranks.
    :arg vals: optional payload shards, or a tuple of such.
    :returns: ``(shards, ok)``: per-rank ``(per,)`` shards, and False if
        some key needed to travel farther than *radius* ranks (its slots
        then hold ``INT64_MAX``, and 0 in the payloads).  With *vals*,
        ``(shards, val_shards, ok)``.
    """
    nranks = mesh.size
    counts_h = [int(c) for c in (counts.tolist() if isinstance(
        counts, torch.Tensor) else counts)]
    n = sum(counts_h)
    if n % nranks:
        raise ValueError(f"total={n} not divisible by nranks={nranks}")
    per = n // nranks
    merged = shards_of(merged, mesh)
    vals_t = [shards_of(v, mesh) for v in _as_tuple(vals)]
    nvals = len(vals_t)
    off = np.concatenate([[0], np.cumsum(counts_h)[:-1]]).tolist()

    # every key of rank s must land within radius ranks of s
    ok = all(c == 0 or (off[s] // per >= s - radius
                        and (off[s] + c - 1) // per <= s + radius)
             for s, c in enumerate(counts_h))

    # one ppermute a rank offset j (keys and each payload): rank s sends
    # to rank s + j the slots of its keys that land in that rank's shard
    segments = [[] for _ in range(nranks)]
    for j in range(-radius, radius + 1):
        moves = []
        for s in range(nranks):
            t = s + j
            if not 0 <= t < nranks:
                continue
            g0 = max(off[s], t * per)
            ln = min(off[s] + counts_h[s], (t + 1) * per) - g0
            if ln > 0:
                moves.append((s, t, g0 - off[s], g0 - t * per, ln))
        perm = [(s, t) for s, t, *_ in moves]
        cols = []
        for col in [merged, *vals_t]:
            bufs = [None] * nranks
            for s, _, src, _, ln in moves:
                bufs[s] = col[s][src:src + ln]
            cols.append(mesh.ppermute(bufs, perm))
        for _, t, _, dst, ln in moves:
            segments[t].append((0, dst, ln, cols[0][t],
                                [c[t] for c in cols[1:]]))

    shards, vshards = [], [[] for _ in range(nvals)]
    for t, dev in enumerate(mesh.devices):
        out, vout = shard.rebalance_place(segments[t], per, nvals,
                                          device=dev)
        shards.append(out)
        for v in range(nvals):
            vshards[v].append(vout[v])
    return _returns(shards, vals, vshards, (ok,))


def sharded_permute(order, data, mesh, *, capacity_factor=2.0):
    """Apply a distributed permutation to row-sharded *data*
    (``shard_sort.py:255``): ``data[order]``, sharded as *order* is, and
    the inverse permutation.

    Rank *r* holds ``order[s]`` for its sorted slots *s*; rank *q* owns
    the rows of the originals ``q * per .. (q + 1) * per - 1``.  Three
    fixed-shape hops: the requests, bucketed by owner (library sort and
    ``searchsorted``), go out in one ``all_to_all`` (K83 packs them); the
    owners serve their rows and record the inverse (K85); a second
    ``all_to_all`` returns the rows, which the requesters put back in slot
    order (K86).

    :arg order: ``(n,)`` int64 permutation of ``0 .. n - 1``, or its
        shards.
    :arg data: ``(n, k)`` float32 / float64 rows in original order, or its
        ``(per, k)`` shards.
    :returns: ``(sorted_data, inverse, ok)``: per-rank ``(per, k)`` rows,
        per-rank ``(per,)`` int64 inverse, and False if an owner bucket
        overflowed its capacity (retry with a larger factor).
    """
    nranks = mesh.size
    order_s = shards_of(order, mesh)
    data_s = shards_of(data, mesh)
    per = order_s[0].shape[0]
    cap = int(np.ceil(capacity_factor * per / nranks))

    req_o, req_s, starts_r, j_r, over = [], [], [], [], []
    for r, dev in enumerate(mesh.devices):
        o_sorted, j_sorted = torch.sort(order_s[r], stable=True)
        starts = torch.cat([
            torch.searchsorted(o_sorted, torch.arange(
                nranks, dtype=torch.int64, device=dev) * per),
            torch.full((1,), per, dtype=torch.int64, device=dev)])
        send, vsend, ov = shard.bucket_pack(o_sorted, j_sorted[None], starts,
                                            cap, val_offset=r * per)
        req_o.append(send)
        req_s.append(vsend[0])
        starts_r.append(starts)
        j_r.append(j_sorted)
        over.append(ov)
    got_o = mesh.all_to_all(req_o)
    got_s = mesh.all_to_all(req_s)

    replies, inverse = [], []
    for q in range(nranks):
        reply, inv = shard.permute_serve(got_o[q], got_s[q], data_s[q],
                                         q * per)
        replies.append(reply)
        inverse.append(inv)
    back = mesh.all_to_all(replies)
    out = [shard.permute_unpack(back[r], starts_r[r], j_r[r])
           for r in range(nranks)]
    status = _host_status(mesh, over)
    return out, inverse, not bool(status.any())


def sharded_sort_gather(keys, mesh, **kwargs):
    """Sharded sort, retried with twice the capacity factor until no
    bucket overflows, and the valid keys concatenated on rank 0's device
    (for tests and small n; ``shard_sort.py:364``)."""
    while True:
        merged, counts, ok = sharded_key_sort(keys, mesh, **kwargs)
        if ok:
            break
        kwargs["capacity_factor"] = 2 * kwargs.get("capacity_factor", 2.0)
    dev = mesh.devices[0]
    return torch.cat([merged[r][:int(counts[r])].to(dev)
                      for r in range(mesh.size)])
