"""Rank slots of the distributed FMM and the collectives between them.

:class:`boxtree_tpu.parallel.distributed.DistributedFMMRunner` runs one
program over a ``jax.sharding.Mesh`` (``distributed.py:207-209``), its
ranks the mesh's devices.  The port keeps that single-controller model:
one process drives a :class:`Mesh` of rank slots, each a
:class:`torch.device`, and several ranks may share one card (their stages
then run one after another on its default stream).  The collectives are
copies between the ranks' tensors: peer to peer where the cards differ,
the buffer itself where they are the same; sums go through the K82 kernel
(:func:`boxtree_torch.ops.exchange.masked_merge`).  The sharded tree build
(:mod:`boxtree_torch.parallel.shard_sort`,
:mod:`boxtree_torch.parallel.shard_build`) adds :meth:`Mesh.all_gather`,
:meth:`Mesh.gather`, :meth:`Mesh.broadcast` and :meth:`Mesh.all_to_all`.
:attr:`Mesh.bytes_between_ranks` counts the bytes that every collective
moved from one rank to another (a rank's own block, and each rank's own
term of a sum, not counted), for the record.
"""

from __future__ import annotations

import torch

from boxtree_torch.ops import exchange


class Mesh:
    """One :class:`torch.device` per rank; a device may repeat."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        #: bytes sent from one rank to another by the collectives
        self.bytes_between_ranks = 0

    @classmethod
    def of_ranks(cls, nranks, device):
        """*nranks* ranks round-robin on the cards of *device*'s type, or
        all on the CPU for a CPU *device*."""
        device = torch.device(device)
        if nranks < 1:
            raise ValueError(f"bad number of ranks: {nranks}")
        if device.type == "cuda":
            ncards = torch.cuda.device_count()
            return cls([torch.device("cuda", r % ncards)
                        for r in range(nranks)])
        return cls([device] * nranks)

    @property
    def size(self):
        return len(self.devices)

    def placement(self):
        """``{device: [ranks]}`` as strings, for the record."""
        out = {}
        for r, d in enumerate(self.devices):
            out.setdefault(str(d), []).append(r)
        return out

    def ppermute(self, bufs, perm):
        """Each ``(src, dst)`` of *perm* sends ``bufs[src]`` to rank
        *dst*: returns one received tensor per rank, None where a rank
        receives nothing.  Every buffer must be complete before the call
        (a rank may send and receive in one permutation)."""
        recv = [None] * self.size
        for src, dst in perm:
            recv[dst] = bufs[src].to(self.devices[dst], non_blocking=True)
            if src != dst:
                self.bytes_between_ranks += _nbytes(bufs[src])
        return recv

    def psum(self, bufs):
        """The sum of the ranks' tensors, given to every rank: summed in
        rank order on rank 0's device by K82 (without a mask), then one
        copy to each other device."""
        total = torch.zeros_like(bufs[0])
        self.bytes_between_ranks += (self.size - 1) * 2 * _nbytes(total)
        for buf in bufs:
            exchange.masked_merge(total, buf.to(total.device,
                                                non_blocking=True))
        copies = {total.device: total}
        for d in self.devices:
            if d not in copies:
                copies[d] = total.to(d, non_blocking=True)
        return [copies[d] for d in self.devices]

    def all_gather(self, bufs):
        """Every rank's tensor, stacked in rank order, given to every rank:
        one ``(nranks, *shape)`` tensor a device, the same object for the
        ranks that share it (``lax.all_gather(x, axis)``)."""
        stacked = {}
        for d in self.devices:
            if d not in stacked:
                stacked[d] = torch.stack([b.to(d, non_blocking=True)
                                          for b in bufs])
        self.bytes_between_ranks += (self.size - 1) * sum(
            _nbytes(b) for b in bufs)
        return [stacked[d] for d in self.devices]

    def gather(self, bufs):
        """Every rank's tensor stacked in rank order on rank 0's device,
        ``(nranks, *shape)``."""
        dev = self.devices[0]
        self.bytes_between_ranks += sum(_nbytes(b) for b in bufs[1:])
        return torch.stack([b.to(dev, non_blocking=True) for b in bufs])

    def broadcast(self, buf):
        """*buf*, which one rank holds, given to every rank: one copy a
        device, the same object for the ranks that share it."""
        copies = {}
        for d in self.devices:
            if d not in copies:
                copies[d] = buf.to(d, non_blocking=True)
        self.bytes_between_ranks += (self.size - 1) * _nbytes(buf)
        return [copies[d] for d in self.devices]

    def all_to_all(self, bufs):
        """Rank ``s`` sends block ``d`` of its ``(nranks, cap, ...)``
        buffer to rank ``d``; rank ``d`` receives ``(nranks, cap, ...)``,
        block ``s`` from rank ``s`` (``lax.all_to_all(x, axis, 0, 0,
        tiled=False)``).  One stacking copy a rank: ``nranks`` blocks."""
        n = self.size
        for b in bufs:
            if b.shape[0] != n:
                raise ValueError(f"all_to_all needs a leading axis of {n} "
                                 f"blocks, got {tuple(b.shape)}")
        recv = []
        for d, dev in enumerate(self.devices):
            recv.append(torch.stack([bufs[s][d].to(dev, non_blocking=True)
                                     for s in range(n)]))
            self.bytes_between_ranks += sum(
                _nbytes(bufs[s][d]) for s in range(n) if s != d)
        return recv


def _nbytes(t):
    return t.numel() * t.element_size()
