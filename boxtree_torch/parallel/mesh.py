"""Rank slots of the distributed FMM and the collectives between them.

:class:`boxtree_tpu.parallel.distributed.DistributedFMMRunner` runs one
program over a ``jax.sharding.Mesh`` (``distributed.py:207-209``), its
ranks the mesh's devices.  The port keeps that single-controller model:
one process drives a :class:`Mesh` of rank slots, each a
:class:`torch.device`, and several ranks may share one card (their stages
then run one after another on its default stream).  The collectives are
copies between the ranks' tensors: peer to peer where the cards differ,
the buffer itself where they are the same; sums go through the K82 kernel
(:func:`boxtree_torch.ops.exchange.masked_merge`).
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
        return recv

    def psum(self, bufs):
        """The sum of the ranks' tensors, given to every rank: summed in
        rank order on rank 0's device by K82 (without a mask), then one
        copy to each other device."""
        total = torch.zeros_like(bufs[0])
        for buf in bufs:
            exchange.masked_merge(total, buf.to(total.device,
                                                non_blocking=True))
        copies = {total.device: total}
        for d in self.devices:
            if d not in copies:
                copies[d] = total.to(d, non_blocking=True)
        return [copies[d] for d in self.devices]
