"""Distributed FMM over a :class:`~boxtree_torch.parallel.mesh.Mesh` of
rank slots.

Port of :mod:`boxtree_tpu.parallel.distributed` (``distributed.py:1-692``),
the counterpart of ``boxtree/distributed/``: the tree is partitioned into
cost-balanced, Morton-DFS-contiguous box segments
(:func:`~boxtree_torch.parallel.partition.partition_ranks`), each rank owns
one, and

- every rank forms multipoles from *its* responsible sources only (its
  weights masked by K82) and runs M2M over the whole tree; the partial
  multipole trees are combined by the relevance-filtered hypercube
  exchange of :func:`_mpole_exchange_schedule` (each stage: pack by K80,
  a copy to the partner rank, unpack by K81), or with
  ``communicate_mpoles="allreduce"`` by one dense sum (K82 without a
  mask);
- the interaction-list work is divided by rows, through rank-restricted
  traversals, the reference boxtree's local traversals
  (``boxtree/distributed/local_traversal.py``): rank r's view
  (:func:`rank_traversal`) keeps the rows of Lists 1 and 3 whose target
  box it owns and the rows of Lists 2 and 4 of its responsible-or-ancestor
  boxes (the routing of ``distributed.py:255-301``), and the wrangler
  that *wrangler_factory* builds on that view runs every stage kernel
  unchanged on the rank's rows;
- the downward pass runs along each rank's responsible-and-ancestor
  chain; each rank's potentials are masked to its responsible boxes and
  merged by K82 (``distributed.py:552-557``).

One process drives all ranks (the reference's single-controller
``shard_map``): upward pass rank by rank, the exchange, then each rank's
list stages, downward pass and merge, on the ranks' own devices.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from boxtree_torch.cost.model import FMMCostModel
from boxtree_torch.models.constant_one import (
    ConstantOneExpansionWrangler,
    ConstantOneTreeIndependentDataForWrangler,
)
from boxtree_torch.ops import exchange
from boxtree_torch.parallel.mesh import Mesh
from boxtree_torch.parallel.partition import partition_ranks
from boxtree_torch.traversal.containers import BuiltList

logger = logging.getLogger(__name__)

#: why ``local_particles=True`` is refused
LOCAL_PARTICLES_REFUSAL = (
    "local_particles=True (per-rank local particle blocks, the reference's "
    "_build_step_local) is not ported: per-rank local particles come with "
    "the sharded runner, built by exchange from sharded coordinates "
    "(ROADMAP Queue 1 #8, 'Next' (3))")


def _mpole_exchange_schedule(needed, contrib, nboxes):
    """The sparse multipole-exchange schedule
    (``boxtree_tpu/parallel/distributed.py:81-149``): XOR-hypercube rounds
    over the largest power-of-two subset of ranks, with fold-in / fold-out
    stages for the others.  In each stage rank ``src`` sends
    ``mp[send_idx[src]]`` to its partner ``dst``, which merges it at
    ``recv_idx[dst]``; a message carries only the boxes the sender
    contributes to and some rank the receiver can still reach *needs*.

    :arg needed: ``(nranks, nboxes)`` bool, the multipole sources of each
        rank.
    :arg contrib: ``(nranks, nboxes)`` bool, the boxes each rank's partial
        multipoles cover.
    :returns: ``(stages, stats)``, each stage ``(perm, send_idx, recv_idx,
        op)`` with int32 ``(nranks, maxlen)`` tables (``-1`` pads) and op
        "add" (disjoint contributions) or "set" (fold-out: the complete
        rows replace).
    """
    nranks = needed.shape[0]
    dev = needed.device
    p2 = 1
    while p2 * 2 <= nranks:
        p2 *= 2
    extras = nranks - p2

    def eff(u):
        return u - p2 if u >= p2 else u

    contrib = contrib.clone()
    stage_kinds = ([("fold_in",)] if extras else []) \
        + [("hyper", k) for k in range(p2.bit_length() - 1)] \
        + ([("fold_out",)] if extras else [])

    stages = []
    stats = []
    for kind in stage_kinds:
        sends = []                      # (src, dst, box mask, op)
        if kind[0] == "fold_in":
            filt = needed.any(dim=0)
            for e in range(p2, nranks):
                sends.append((e, e - p2, contrib[e] & filt, "add"))
        elif kind[0] == "hyper":
            k = kind[1]
            for r in range(p2):
                t = r ^ (1 << k)
                group = [u for u in range(nranks)
                         if eff(u) % (2 << k) == t % (2 << k)]
                filt = needed[group].any(dim=0)
                sends.append((r, t, contrib[r] & filt, "add"))
        else:                           # fold_out
            for e in range(p2, nranks):
                sends.append((e - p2, e, contrib[e - p2] & needed[e],
                              "set"))

        if not sends:
            continue
        ids = [torch.nonzero(m)[:, 0].to(torch.int32)
               for (_, _, m, _) in sends]
        maxlen = max(1, max(int(i.shape[0]) for i in ids))
        send_idx = torch.full((nranks, maxlen), -1, dtype=torch.int32,
                              device=dev)
        recv_idx = torch.full((nranks, maxlen), -1, dtype=torch.int32,
                              device=dev)
        perm = []
        for (src, dst, _, _), i in zip(sends, ids):
            send_idx[src, :i.shape[0]] = i
            recv_idx[dst, :i.shape[0]] = i
            perm.append((src, dst))
        for (src, dst, m, _) in sends:
            contrib[dst] |= m
        stages.append((tuple(perm), send_idx, recv_idx, sends[0][3]))
        stats.append({"stage": kind[0], "boxes": maxlen,
                      "ranks": len(sends)})
    return stages, stats


# {{{ rank-restricted traversals

def _restrict_rows(row_boxes, keep_box, starts, lists):
    """The rows of a CSR list over *row_boxes* whose box *keep_box* keeps:
    ``(row mask, starts, lists)``, in the input's dtypes."""
    keep = keep_box[row_boxes.to(torch.int64)]
    st = starts.to(torch.int64)
    counts = st[1:] - st[:-1]
    # the kept rows' counts summed up to each row; a kept row's start is
    # the sum before it
    ends = torch.cumsum(torch.where(keep, counts, 0), 0)
    new_starts = torch.cat([torch.zeros(1, dtype=torch.int64,
                                        device=starts.device), ends[keep]])
    edge_keep = torch.repeat_interleave(keep, counts,
                                        output_size=lists.shape[0])
    return keep, new_starts.to(starts.dtype), lists[edge_keep]


def _level_starts(rows, tree, like):
    """``(nlevels + 1,)`` starts of each level among the level-sorted box
    ids *rows*, in the dtype of *like*."""
    lev = tree.box_levels.to(torch.int64)[rows.to(torch.int64)]
    return torch.searchsorted(
        lev, torch.arange(tree.nlevels + 1, device=lev.device)).to(
            like.dtype)


def rank_traversal(traversal, responsible, resp_or_anc):
    """The traversal of one rank: a copy of *traversal* on the same tree
    whose target rows are the rank's (the reference boxtree's local
    traversal, ``boxtree/distributed/local_traversal.py``).

    - ``target_boxes``: the responsible target boxes, with their rows of
      List 1 and of List 3 (each source level), as
      ``boxtree_tpu/parallel/distributed.py:255-277`` routes them;
    - ``target_or_target_parent_boxes``: the responsible-or-ancestor ones,
      with their rows of Lists 2 and 4 (``:279-301``);
    - level starts recomputed, CSR lists compacted, on the traversal's
      device; the source-side fields and the colleagues stay global.

    :arg responsible: ``(nboxes,)`` bool, the rank's responsible boxes.
    :arg resp_or_anc: ``(nboxes,)`` bool, those and their ancestors.

    Unmerged close lists raise :class:`NotImplementedError`, the reference
    runner's check (``distributed.py:201-206``).
    """
    if traversal.from_sep_close_smaller_starts is not None:
        raise NotImplementedError(
            "DistributedFMMRunner does not yet drive traversals with "
            "target extents (close halves of Lists 3/4 would be "
            "silently dropped); call traversal.merge_close_lists() "
            "or merge_close_lists(traversal) first")
    tree = traversal.tree
    tb = traversal.target_boxes
    totp = traversal.target_or_target_parent_boxes

    keep_t, l1_starts, l1_lists = _restrict_rows(
        tb, responsible, traversal.neighbor_source_boxes_starts,
        traversal.neighbor_source_boxes_lists)
    new_tb = tb[keep_t]
    keep_p, l2_starts, l2_lists = _restrict_rows(
        totp, resp_or_anc, traversal.from_sep_siblings_starts,
        traversal.from_sep_siblings_lists)
    _, l4_starts, l4_lists = _restrict_rows(
        totp, resp_or_anc, traversal.from_sep_bigger_starts,
        traversal.from_sep_bigger_lists)
    new_totp = totp[keep_p]

    l3, l3_rows = [], []
    for bl, rows in zip(traversal.from_sep_smaller_by_level,
                        traversal.target_boxes_sep_smaller_by_source_level):
        keep, starts, lists = _restrict_rows(rows, responsible, bl.starts,
                                             bl.lists)
        kept = rows[keep]
        l3_rows.append(kept)
        l3.append((starts, lists, torch.searchsorted(
            new_tb.to(torch.int64), kept.to(torch.int64)).to(
                bl.nonempty_indices.dtype)))
    from_sep_smaller = tuple(
        BuiltList(count=int(lists.shape[0]), starts=starts, lists=lists,
                  num_nonempty_lists=int(rows.shape[0]), nonempty_indices=ne)
        for (starts, lists, ne), rows in zip(l3, l3_rows))

    return dataclasses.replace(
        traversal,
        target_boxes=new_tb,
        level_start_target_box_nrs=_level_starts(
            new_tb, tree, traversal.level_start_target_box_nrs),
        target_or_target_parent_boxes=new_totp,
        level_start_target_or_target_parent_box_nrs=_level_starts(
            new_totp, tree,
            traversal.level_start_target_or_target_parent_box_nrs),
        neighbor_source_boxes_starts=l1_starts,
        neighbor_source_boxes_lists=l1_lists,
        from_sep_siblings_starts=l2_starts,
        from_sep_siblings_lists=l2_lists,
        from_sep_smaller_by_level=from_sep_smaller,
        target_boxes_sep_smaller_by_source_level=tuple(l3_rows),
        from_sep_bigger_starts=l4_starts,
        from_sep_bigger_lists=l4_lists)


def _to_device(obj, device, memo):
    """*obj* (a tensor, tuple or dataclass of them) with every tensor on
    *device*; dataclasses met twice (the tree) are moved once."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(_to_device(x, device, memo) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        if id(obj) not in memo:
            memo[id(obj)] = dataclasses.replace(obj, **{
                f.name: _to_device(getattr(obj, f.name), device, memo)
                for f in dataclasses.fields(obj)})
        return memo[id(obj)]
    return obj

# }}}


def _default_wrangler_factory(traversal):
    return ConstantOneExpansionWrangler(
        ConstantOneTreeIndependentDataForWrangler(), traversal)


class DistributedFMMRunner:
    """Set up and drive a distributed FMM over *mesh*
    (``boxtree_tpu/parallel/distributed.py:167-475``; the reference boxtree's
    ``boxtree/distributed/__init__.py:269-310``).

    :arg mesh: a :class:`~boxtree_torch.parallel.mesh.Mesh`, or a number
        of ranks R: R ranks round-robin on the cards of the traversal's
        device type (all on the CPU for a CPU traversal); several ranks may
        share a card.  The placement is logged and kept in
        :attr:`placement`.
    :arg wrangler_factory: ``traversal -> wrangler``, called once a rank on
        the rank's :func:`rank_traversal`; any wrangler of
        :mod:`boxtree_torch.models`.  Defaults to the counting wrangler.
    :arg cost_per_box: ``(nboxes,)`` costs the partition balances; by
        default :class:`~boxtree_torch.cost.model.FMMCostModel` at order 3
        (``distributed.py:227-230``).
    :arg communicate_mpoles: "hypercube" (the sparse exchange of
        :func:`_mpole_exchange_schedule`) or "allreduce" (one dense sum,
        the reference's ``communicate_mpoles_via_allreduce`` debug path).
    :arg local_particles: not ported; True raises
        :class:`NotImplementedError`.
    """

    def __init__(self, mesh, traversal, wrangler_factory=None,
                 cost_per_box=None, communicate_mpoles="hypercube",
                 local_particles=False):
        if communicate_mpoles not in ("hypercube", "allreduce"):
            raise ValueError(f"bad communicate_mpoles: "
                             f"{communicate_mpoles}")
        self.communicate_mpoles = communicate_mpoles
        if local_particles:
            raise NotImplementedError(LOCAL_PARTICLES_REFUSAL)
        tree = traversal.tree
        dev = tree.box_levels.device
        if isinstance(mesh, int):
            mesh = Mesh.of_ranks(mesh, dev)
        self.mesh = mesh
        self.traversal = traversal
        self.tree = tree
        nranks = mesh.size
        #: ``{device: [ranks]}``
        self.placement = mesh.placement()
        logger.info("DistributedFMMRunner: %d ranks on %s", nranks,
                    self.placement)

        if wrangler_factory is None:
            wrangler_factory = _default_wrangler_factory
        if cost_per_box is None:
            orders = {lev: 3 for lev in range(tree.nlevels)}
            cost_per_box = FMMCostModel().cost_per_box(traversal, orders)

        rp = partition_ranks(cost_per_box, traversal, nranks)
        self.rank_partition = rp
        resp = rp.responsible_masks()
        roa = rp.resp_or_anc_masks()
        views = [rank_traversal(traversal, resp[r], roa[r])
                 for r in range(nranks)]

        if communicate_mpoles == "hypercube" and nranks > 1:
            # multipole sources: List-2 sources of the rank's rows (its
            # responsible-or-ancestor boxes) and List-3 sources of its
            # responsible rows (``distributed.py:357-370``)
            needed = torch.zeros((nranks, tree.nboxes), dtype=torch.bool,
                                 device=dev)
            for r, v in enumerate(views):
                for lists in (v.from_sep_siblings_lists, *(
                        bl.lists for bl in v.from_sep_smaller_by_level)):
                    needed[r, lists.to(torch.int64)] = True
            stages, self.mpole_comm_stats = _mpole_exchange_schedule(
                needed, roa, tree.nboxes)
        else:
            stages, self.mpole_comm_stats = [], []
        #: per stage, the rows that carry a box (the tables' ids >= 0)
        self.mpole_rows_sent = [int((s[1] >= 0).sum()) for s in stages]

        memos = {}
        devs = mesh.devices
        self.rank_traversals = [
            _to_device(v, d, memos.setdefault(d, {}))
            for v, d in zip(views, devs)]
        #: each rank's List-2 edges (the global count: the traversal's)
        self.list2_pairs = [int(v.from_sep_siblings_lists.shape[0])
                            for v in views]
        self.wranglers = [wrangler_factory(v) for v in self.rank_traversals]
        #: rank 0's wrangler: it reorders the weights and potentials
        self.wrangler = self.wranglers[0]
        self._resp = [resp[r].to(d) for r, d in enumerate(devs)]
        self._resp_out = [resp[r].to(devs[0]) for r in range(nranks)]
        self._box_of_source = [
            v.tree.box_id_of_source.to(torch.int32) for v in
            self.rank_traversals]
        self._pot_box_map = self.wrangler.potential_box_map().to(torch.int32)
        self._stages = [
            (perm, [send[r].to(d) for r, d in enumerate(devs)],
             [recv[r].to(d) for r, d in enumerate(devs)], op)
            for perm, send, recv, op in stages]
        logger.info(
            "DistributedFMMRunner: List-2 edges per rank %s of %d, mpole "
            "stages %d", self.list2_pairs,
            int(traversal.from_sep_siblings_lists.shape[0]), len(stages))

    def _exchange_mpoles(self, mps):
        """The sparse hypercube exchange: per stage every sender packs its
        rows (K80), the buffers go to the partners, and each receiver
        merges them (K81); or the dense sum (K82)."""
        if not self._stages:
            return self.mesh.psum(mps)
        for perm, send_idx, recv_idx, op in self._stages:
            bufs = [None] * self.mesh.size
            for src, _ in perm:
                bufs[src] = exchange.pack_rows(mps[src], send_idx[src])
            recv = self.mesh.ppermute(bufs, perm)
            for _, dst in perm:
                exchange.unpack_rows(mps[dst], recv_idx[dst], recv[dst], op)
        return mps

    def drive_dfmm(self, source_weights):
        """Run the distributed FMM; returns potentials in user target order
        (``boxtree_tpu/parallel/distributed.py:665-692``)."""
        w0 = self.wrangler
        q = w0.reorder_sources(source_weights)
        qs, mps = [], []
        for r, (w, v) in enumerate(zip(self.wranglers,
                                       self.rank_traversals)):
            q_r = q.to(self.mesh.devices[r])
            mine = exchange.masked_merge(torch.zeros_like(q_r), q_r,
                                         self._resp[r],
                                         self._box_of_source[r])
            mp = w.form_multipoles(v.level_start_source_box_nrs,
                                   v.source_boxes, [mine])
            mps.append(w.coarsen_multipoles(
                v.level_start_source_parent_box_nrs, v.source_parent_boxes,
                mp))
            qs.append(q_r)

        mps = self._exchange_mpoles(mps)

        out = None
        for r, (w, v) in enumerate(zip(self.wranglers,
                                       self.rank_traversals)):
            mp, q_r = mps[r], qs[r]
            pot = w.eval_direct(v.target_boxes,
                                v.neighbor_source_boxes_starts,
                                v.neighbor_source_boxes_lists, [q_r])
            loc = w.multipole_to_local(
                v.level_start_target_or_target_parent_box_nrs,
                v.target_or_target_parent_boxes, v.from_sep_siblings_starts,
                v.from_sep_siblings_lists, mp)
            pot = pot + w.eval_multipoles(
                v.target_boxes_sep_smaller_by_source_level,
                v.from_sep_smaller_by_level, mp)
            loc = w.form_locals(
                v.level_start_target_or_target_parent_box_nrs,
                v.target_or_target_parent_boxes, v.from_sep_bigger_starts,
                v.from_sep_bigger_lists, [q_r], loc)
            loc = w.refine_locals(
                v.level_start_target_or_target_parent_box_nrs,
                v.target_or_target_parent_boxes, loc)
            pot = pot + w.eval_locals(v.level_start_target_box_nrs,
                                      v.target_boxes, loc)
            pot = pot.to(self.mesh.devices[0], non_blocking=True)
            if out is None:
                out = torch.zeros_like(pot)
            exchange.masked_merge(out, pot, self._resp_out[r],
                                  self._pot_box_map)
        return w0.finalize_potentials(w0.reorder_potentials(out))
