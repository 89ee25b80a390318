"""The distributed FMM of boxtree_torch (``boxtree_torch.parallel``)
against boxtree_tpu's, on the CPU.

- The partition: the DFS order, ``partition_work``, ``partition_ranks``
  (every field of the JAX ``RankPartition``, bridged into the port's) and
  ``get_box_masks`` equal the reference's exactly, on a 2D and a 3D tree
  at 1, 3, 4 and 8 ranks, with random costs.
- The multipole-exchange schedule equals the reference's
  ``_mpole_exchange_schedule`` exactly (perms, ops, tables, stats), on
  random masks at 2 to 8 ranks and inside the runners (the reference's
  runners are constructed but not run); each rank's traversal holds the
  same List 1-4 edges as the reference runner's slices of that rank.
- The counting runner: exactly ``nsources`` in 2D and 3D, 3 ranks on the
  hypercube and 4 on the allreduce (and 1, 5, 8 ranks); one JAX counting
  ``drive_dfmm`` (3D, 3 ranks) on integer weights, equal exactly.
- One recorded JAX Laplace ``drive_dfmm`` (3D, 4 ranks, float64, order 6,
  600 points), the port's complex and float64 pair runners within 1e-11
  rel l-inf.
- The port alone: its runner against its own single-device ``drive_fmm``
  within 1e-12 (Laplace complex128 and float64 pairs, 3D Helmholtz pairs,
  2D Laplace with separate sources and targets, a merged extent
  traversal).
- K80-K82's twins and CPU wrappers against numpy, ``-1`` entries, both
  ops, every dtype; the merge of masked partials equals one masked select
  bit for bit.
- The refusals, and the mesh's placement and collectives.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import make_helmholtz_wrangler, make_laplace_wrangler
from boxtree_torch.ops import exchange
from boxtree_torch.parallel import (
    DistributedFMMRunner,
    dfs_box_order,
    get_box_masks,
    partition_work,
)
from boxtree_torch.parallel.distributed import (
    _mpole_exchange_schedule,
    rank_traversal,
)
from boxtree_torch.parallel.mesh import Mesh
from boxtree_torch.parallel.partition import partition_ranks
from boxtree_torch.traversal import build_traversal
from boxtree_torch.traversal.containers import csr_rows
from boxtree_torch.utils.bridge import (
    exchange_stages_from_numpy,
    rank_partition_from_numpy,
)
from boxtree_tpu.cost.model import PythonFMMCostModel as JaxPythonCostModel
from boxtree_tpu.models.laplace import (
    make_laplace_wrangler as jax_make_laplace_wrangler,
)
from boxtree_tpu.parallel import distributed as jax_distributed
from boxtree_tpu.parallel import partition as jax_partition
from test_torch_helmholtz3d import _jax_traversal
from torch_threads import one_torch_thread  # noqa: F401

NRANKS = [1, 3, 4, 8]
#: the port's runner against its own single-device FMM
SELF_RTOL = 1e-12
#: the port's runner against the recorded JAX runner (float64, order 6)
JAX_RTOL = 1e-11


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _t(x):
    return torch.tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _normal_trav(dim):
    """A port traversal of 3,000 normal points, the reference's copy of
    it, and a random cost vector."""
    pts = np.random.default_rng(5).standard_normal((dim, 3000))
    trav = build_traversal(build_tree(pts, max_particles_in_box=20,
                                      device="cpu"))
    cost = np.random.default_rng(9).uniform(0.5, 2.0, trav.tree.nboxes)
    return trav, _jax_traversal(trav), cost


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def travs(request):
    return _normal_trav(request.param)


# {{{ the partition

def test_dfs_box_order(travs):
    trav, jtrav, _ = travs
    got = dfs_box_order(trav.tree)
    assert torch.equal(got, _t(jax_partition.dfs_box_order(jtrav.tree)))
    # children follow their parent in box_child_ids' slot order
    pos = torch.empty_like(got)
    pos[got] = torch.arange(got.shape[0])
    child = trav.tree.box_child_ids.to(torch.int64)
    has = child > 0
    cpos = torch.where(has, pos[child], -1)
    for slot in range(1, child.shape[0]):
        both = has[slot] & has[slot - 1]
        assert (cpos[slot][both] > cpos[slot - 1][both]).all()


@pytest.mark.parametrize("nranks", NRANKS)
def test_partition(travs, nranks):
    """partition_work, partition_ranks (bridged field by field) and the
    masks, exactly."""
    trav, jtrav, cost = travs
    masks = partition_work(torch.as_tensor(cost), trav, nranks)
    jmasks = jax_partition.partition_work(cost, jtrav, nranks)
    assert torch.equal(masks, _t(jmasks))

    rp = partition_ranks(cost, trav, nranks)
    jrp = rank_partition_from_numpy(
        jax_partition.partition_ranks(cost, jtrav, nranks))
    for f in dataclasses.fields(rp):
        a, b = getattr(rp, f.name), getattr(jrp, f.name)
        assert (a == b if f.name == "nranks" else torch.equal(a, b)), f.name
    assert torch.equal(rp.responsible_masks(), masks)
    roa = rp.resp_or_anc_masks()
    for r in range(nranks):
        bm = get_box_masks(trav, masks[r])
        jbm = jax_partition.get_box_masks(jtrav, jmasks[r])
        for f in dataclasses.fields(bm):
            assert torch.equal(getattr(bm, f.name),
                               _t(getattr(jbm, f.name))), (r, f.name)
        assert torch.equal(roa[r], bm.responsible_boxes | bm.ancestor_boxes)

# }}}


# {{{ the exchange schedule

def _stages_equal(got, ref, stats, ref_stats):
    ref = exchange_stages_from_numpy(ref)
    assert len(got) == len(ref) and stats == ref_stats
    for (perm, send, recv, op), (rperm, rsend, rrecv, rop) in zip(got, ref):
        assert perm == rperm and op == rop
        assert torch.equal(send, rsend) and torch.equal(recv, rrecv)


@pytest.mark.parametrize("nranks", [2, 3, 4, 5, 6, 8])
def test_exchange_schedule(nranks):
    rng = np.random.default_rng(nranks)
    nboxes = 300
    needed = rng.random((nranks, nboxes)) < 0.2
    contrib = rng.random((nranks, nboxes)) < 0.3
    ref, ref_stats = jax_distributed._mpole_exchange_schedule(
        needed, contrib, nboxes)
    got, stats = _mpole_exchange_schedule(_t(needed), _t(contrib), nboxes)
    _stages_equal(got, ref, stats, ref_stats)


def _edges(tgt, src):
    """Sorted (target, source) pairs as one int64 key each."""
    return torch.sort((tgt.to(torch.int64) << 32) | src.to(torch.int64))[0]


def _view_edges(v):
    def flat(rows, starts, lists):
        return rows[csr_rows(starts, lists.shape[0])], lists
    l3 = [flat(rows, bl.starts, bl.lists) for rows, bl in zip(
        v.target_boxes_sep_smaller_by_source_level,
        v.from_sep_smaller_by_level) if bl.count]
    return {
        "e1": _edges(*flat(v.target_boxes, v.neighbor_source_boxes_starts,
                           v.neighbor_source_boxes_lists)),
        "e2": _edges(*flat(v.target_or_target_parent_boxes,
                           v.from_sep_siblings_starts,
                           v.from_sep_siblings_lists)),
        "e3": _edges(torch.cat([t for t, _ in l3]),
                     torch.cat([s for _, s in l3])),
        "e4": _edges(*flat(v.target_or_target_parent_boxes,
                           v.from_sep_bigger_starts,
                           v.from_sep_bigger_lists)),
    }


@pytest.mark.parametrize("nranks,communicate_mpoles", [
    (3, "hypercube"), (8, "hypercube"), (4, "allreduce")])
def test_runner_against_reference_setup(travs, nranks, communicate_mpoles):
    """The runner's partition, schedule and per-rank edges against the
    reference runner's (constructed, not run)."""
    trav, jtrav, cost = travs
    runner = DistributedFMMRunner(nranks, trav, cost_per_box=cost,
                                  communicate_mpoles=communicate_mpoles)
    jr = jax_distributed.DistributedFMMRunner(
        nranks, jtrav, cost_per_box=cost,
        communicate_mpoles=communicate_mpoles)
    jrp = rank_partition_from_numpy(jr.rank_partition)
    for f in dataclasses.fields(jrp):
        if f.name != "nranks":
            assert torch.equal(getattr(runner.rank_partition, f.name),
                               getattr(jrp, f.name)), f.name
    ref = [(perm, np.asarray(s), np.asarray(r), op) for perm, (s, r), op in
           zip(jr._mpole_perms, jr._mpole_tables, jr._mpole_ops)]
    got = [(perm, torch.stack(send), torch.stack(recv), op)
           for perm, send, recv, op in runner._stages]
    _stages_equal(got, ref, runner.mpole_comm_stats, jr.mpole_comm_stats)
    for r, v in enumerate(runner.rank_traversals):
        edges = _view_edges(v)
        for name in ("e1", "e2", "e3", "e4"):
            e = _t(np.asarray(getattr(jr, name))[r])
            e = e[e[:, 0] >= 0]
            assert torch.equal(edges[name], _edges(e[:, 0], e[:, 1])), \
                (r, name)
        assert runner.list2_pairs[r] == edges["e2"].shape[0]


def test_one_rank_traversal_is_the_traversal(travs):
    trav = travs[0]
    every = torch.ones(trav.tree.nboxes, dtype=torch.bool)
    v = rank_traversal(trav, every, every)
    for f in dataclasses.fields(trav):
        a, b = getattr(v, f.name), getattr(trav, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        elif f.name == "from_sep_smaller_by_level":
            for x, y in zip(a, b):
                assert x.count == y.count
                assert x.num_nonempty_lists == y.num_nonempty_lists
                for g in ("starts", "lists", "nonempty_indices"):
                    assert torch.equal(getattr(x, g), getattr(y, g)), g
        elif f.name == "target_boxes_sep_smaller_by_source_level":
            assert all(torch.equal(x, y) for x, y in zip(a, b))

# }}}


# {{{ the counting runner

@pytest.mark.parametrize("nranks,communicate_mpoles", [
    (1, "hypercube"), (3, "hypercube"), (4, "allreduce"), (5, "hypercube"),
    (8, "hypercube")])
def test_counting_runner_exact(travs, nranks, communicate_mpoles):
    trav = travs[0]
    n = trav.tree.nsources
    runner = DistributedFMMRunner(nranks, trav,
                                  communicate_mpoles=communicate_mpoles)
    pot = runner.drive_dfmm(np.ones(n))
    assert pot.shape == (trav.tree.ntargets,) and pot.dtype == torch.float64
    assert (pot == n).all(), int((pot != n).sum())


def test_counting_runner_against_jax():
    """One JAX counting drive_dfmm (3D, 3 ranks, hypercube) on integer
    weights: every potential is an exact integer sum in both."""
    trav, jtrav, cost = _normal_trav(3)
    q = np.random.default_rng(3).integers(-5, 6, trav.tree.nsources)
    q = q.astype(np.float64)
    ref = jax_distributed.DistributedFMMRunner(
        3, jtrav, cost_per_box=cost).drive_dfmm(q)
    got = DistributedFMMRunner(3, trav, cost_per_box=cost).drive_dfmm(q)
    assert torch.equal(got, _t(ref))

# }}}


# {{{ Laplace against the recorded JAX runner

@pytest.fixture(scope="module")
def laplace_case():
    rng = np.random.default_rng(5)
    n = 600
    pts = rng.random((3, n))
    trav = build_traversal(build_tree(pts, max_particles_in_box=20,
                                      device="cpu"))
    q = rng.standard_normal(n)
    jtrav = _jax_traversal(trav)
    cost = JaxPythonCostModel().cost_per_box(
        jtrav, {lev: 3 for lev in range(trav.tree.nlevels)})
    runner = jax_distributed.DistributedFMMRunner(
        4, jtrav, cost_per_box=cost,
        wrangler_factory=lambda t: jax_make_laplace_wrangler(t, order=6))
    return trav, q, cost, np.asarray(runner.drive_dfmm(q))


@pytest.mark.parametrize("pairs", [False, True], ids=["complex", "pairs"])
def test_laplace_runner_against_jax(laplace_case, pairs):
    trav, q, cost, ref = laplace_case
    kw = dict(pairs=True, dtype=torch.float64) if pairs else {}
    runner = DistributedFMMRunner(
        4, trav, cost_per_box=cost,
        wrangler_factory=lambda t: make_laplace_wrangler(t, order=6, **kw))
    pot = runner.drive_dfmm(q).numpy()
    assert pot.shape == ref.shape[:1] + pot.shape[1:]
    assert _rel(pot, ref) <= JAX_RTOL


@pytest.mark.parametrize("nranks", [2, 4])
def test_laplace_runner_default_cost_against_jax(laplace_case, nranks):
    """The default cost (the port's FMMCostModel) and another rank count
    change only the summation order."""
    trav, q, _, ref = laplace_case
    runner = DistributedFMMRunner(
        nranks, trav,
        wrangler_factory=lambda t: make_laplace_wrangler(t, order=6))
    assert _rel(runner.drive_dfmm(q).numpy(), ref) <= JAX_RTOL

# }}}


# {{{ the port's runner against its own single-device FMM

def _uniform_trav(dim, n, seed, **kw):
    rng = np.random.default_rng(seed)
    pts = rng.random((dim, n))
    return build_traversal(build_tree(pts, max_particles_in_box=20,
                                      device="cpu", **kw)), rng


def _laplace3d_c128(t):
    return make_laplace_wrangler(t, order=6, pairs=False, rscale="auto")


def _laplace3d_f64(t):
    return make_laplace_wrangler(t, order=6, pairs=True, rscale="auto",
                                 dtype=torch.float64)


def _helmholtz3d_pairs(t):
    return make_helmholtz_wrangler(t, 2.0, 6, pairs=True, rscale="auto")


@pytest.mark.parametrize("factory", [_laplace3d_c128, _laplace3d_f64,
                                     _helmholtz3d_pairs],
                         ids=["laplace_c128", "laplace_f64",
                              "helmholtz3d_pairs"])
@pytest.mark.parametrize("nranks,communicate_mpoles", [
    (4, "hypercube"), (3, "hypercube"), (4, "allreduce")])
def test_runner_against_single_device(factory, nranks, communicate_mpoles):
    trav, rng = _uniform_trav(3, 800, 12)
    q = rng.standard_normal(trav.tree.nsources)
    ref = drive_fmm(factory(trav), [torch.as_tensor(q)])
    runner = DistributedFMMRunner(nranks, trav, wrangler_factory=factory,
                                  communicate_mpoles=communicate_mpoles)
    pot = runner.drive_dfmm(q)
    assert pot.shape == ref.shape and pot.dtype == ref.dtype
    assert _rel(pot.numpy(), ref.numpy()) <= SELF_RTOL


def test_runner_separate_sources_and_targets():
    """2D Laplace with separate source and target sets
    (``tests/test_distributed.py:134-157``'s split)."""
    rng = np.random.default_rng(6)
    sources = rng.standard_normal((2, 1500))
    targets = rng.random((2, 1000))
    trav = build_traversal(build_tree(sources, targets=targets,
                                      max_particles_in_box=15, device="cpu"))
    q = rng.standard_normal(1500)

    def factory(t):
        return make_laplace_wrangler(t, order=8)

    ref = drive_fmm(factory(trav), [torch.as_tensor(q)])
    pot = DistributedFMMRunner(5, trav, wrangler_factory=factory).drive_dfmm(q)
    assert pot.shape == (1000,)
    assert _rel(pot.numpy(), ref.numpy()) <= SELF_RTOL
    count = DistributedFMMRunner(3, trav).drive_dfmm(np.ones(1500))
    assert (count == 1500).all()


def test_runner_merged_extent_traversal():
    """Target extents, close lists merged into List 1
    (``tests/test_distributed.py:243-270``); unmerged they are refused."""
    rng = np.random.default_rng(22)
    n = 900
    pts = rng.random((2, n))
    radii = 2.0 ** rng.uniform(-9, -3, n)
    trav = build_traversal(build_tree(
        pts, targets=pts, max_particles_in_box=15, target_radii=radii,
        stick_out_factor=0.25, device="cpu"))
    with pytest.raises(NotImplementedError, match="merge_close_lists"):
        DistributedFMMRunner(4, trav)
    merged = trav.merge_close_lists()
    q = rng.standard_normal(n)

    def factory(t):
        return make_laplace_wrangler(t, order=8)

    ref = drive_fmm(factory(merged), [torch.as_tensor(q)])
    pot = DistributedFMMRunner(4, merged, wrangler_factory=factory
                               ).drive_dfmm(q)
    assert _rel(pot.numpy(), ref.numpy()) <= SELF_RTOL

# }}}


# {{{ K80-K82 against numpy

DTYPES = [torch.float32, torch.float64, torch.complex128]


def _rows(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if dtype.is_complex:
        x = x + 1j * rng.standard_normal(shape)
    return torch.as_tensor(x).to(dtype)


def _index(nboxes, n, seed):
    """*n* unique ids of ``range(nboxes)`` with ``-1`` entries among them
    and at the end."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(nboxes)[:n].astype(np.int32)
    idx[rng.random(n) < 0.25] = -1
    idx[-3:] = -1
    return torch.as_tensor(idx)


@pytest.mark.parametrize("trail", [(), (7,), (2,)], ids=["scalar", "k7",
                                                           "pair"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pack_rows(dtype, trail):
    mp = _rows((50, *trail), dtype, 1)
    idx = _index(50, 30, 2)
    want = mp.numpy()[np.clip(idx.numpy(), 0, None)]
    want[idx.numpy() < 0] = 0
    for fn in (exchange.pack_rows, exchange.pack_rows_plain):
        got = fn(mp, idx)
        assert got.dtype == dtype and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["add", "set"])
@pytest.mark.parametrize("trail", [(), (7,)], ids=["scalar", "k7"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_unpack_rows(dtype, trail, op):
    mp = _rows((50, *trail), dtype, 3)
    idx = _index(50, 30, 4)
    recv = _rows((30, *trail), dtype, 5)
    want = mp.numpy().copy()
    ok = idx.numpy() >= 0
    rows = idx.numpy()[ok]
    want[rows] = (want[rows] + recv.numpy()[ok]) if op == "add" \
        else recv.numpy()[ok]
    for fn in (exchange.unpack_rows, exchange.unpack_rows_plain):
        got = fn(mp.clone(), idx, recv, op)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("trail", [(), (2,), (7,)], ids=["scalar", "pair",
                                                           "k7"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_masked_merge(dtype, trail):
    """Against numpy; and the ranks' masks partition the boxes, so the
    merge of every rank's rows equals one masked select bit for bit."""
    n, nboxes, nranks = 60, 13, 4
    rng = np.random.default_rng(6)
    box_map = torch.as_tensor(rng.integers(0, nboxes, n).astype(np.int32))
    owner = rng.integers(0, nranks, nboxes)
    out0 = _rows((n, *trail), dtype, 7)
    x = _rows((n, *trail), dtype, 8)
    keep = torch.as_tensor(owner == 1)
    want = out0.numpy().copy()
    k = keep.numpy()[box_map.numpy()]
    want[k] += x.numpy()[k]
    for fn in (exchange.masked_merge, exchange.masked_merge_plain):
        assert np.array_equal(fn(out0.clone(), x, keep, box_map).numpy(),
                              want)
        assert np.array_equal(fn(out0.clone(), x).numpy(),
                              out0.numpy() + x.numpy())
        # the ranks' partials merged into zeros: one masked select
        parts = [_rows((n, *trail), dtype, 10 + r) for r in range(nranks)]
        out = torch.zeros_like(out0)
        for r in range(nranks):
            fn(out, parts[r], torch.as_tensor(owner == r), box_map)
        sel = np.stack([p.numpy() for p in parts])[
            owner[box_map.numpy()], np.arange(n)]
        assert np.array_equal(out.numpy(), sel)
        # the weights' mask: zeros in, the kept rows out
        masked = fn(torch.zeros_like(x), x, keep, box_map)
        assert np.array_equal(masked.numpy(),
                              np.where(k.reshape((n,) + (1,) * len(trail)),
                                       x.numpy(), 0))

# }}}


# {{{ refusals, the mesh

def test_runner_refusals(travs):
    trav = travs[0]
    with pytest.raises(ValueError, match="communicate_mpoles"):
        DistributedFMMRunner(2, trav, communicate_mpoles="ring")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DistributedFMMRunner(2, trav, local_particles=True)


def test_exchange_refusals():
    mp = torch.zeros((5, 3))
    idx = torch.tensor([0, 1, -1], dtype=torch.int32)
    with pytest.raises(TypeError):
        exchange.pack_rows(mp.to(torch.float16), idx)
    with pytest.raises(TypeError):
        exchange.pack_rows(mp, idx.to(torch.int64))
    with pytest.raises(ValueError, match="op"):
        exchange.unpack_rows(mp, idx, torch.zeros((3, 3)), "max")
    with pytest.raises(ValueError):
        exchange.unpack_rows(mp, idx, torch.zeros((2, 3)), "add")
    with pytest.raises(ValueError):
        exchange.masked_merge(mp, torch.zeros((5, 2)))
    with pytest.raises(ValueError):
        exchange.masked_merge(mp, mp.clone(), torch.ones(4, dtype=bool))
    with pytest.raises(TypeError):
        exchange.masked_merge(mp, mp.clone(), torch.ones(4),
                              torch.zeros(5, dtype=torch.int32))


def test_mesh():
    m = Mesh.of_ranks(3, "cpu")
    assert m.size == 3 and m.placement() == {"cpu": [0, 1, 2]}
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        Mesh.of_ranks(0, "cpu")
    bufs = [torch.full((4, 2), float(r)) for r in range(3)]
    recv = m.ppermute(bufs, ((0, 1), (1, 0)))
    assert torch.equal(recv[1], bufs[0]) and torch.equal(recv[0], bufs[1])
    assert recv[2] is None
    total = m.psum(bufs)
    assert all(torch.equal(t, torch.full((4, 2), 3.0)) for t in total)


def test_runner_on_explicit_mesh(travs):
    """A mesh given as devices, one of them repeated, and its placement."""
    trav = travs[0]
    runner = DistributedFMMRunner(Mesh(["cpu", torch.device("cpu")]), trav)
    assert runner.placement == {"cpu": [0, 1]}
    n = trav.tree.nsources
    assert (runner.drive_dfmm(np.ones(n)) == n).all()

# }}}
