"""boxtree_torch.parallel.shard_sort against boxtree_tpu.parallel.shard_sort
on the CPU, and K83-K86 (ops/shard.py) against numpy.

The same keys, payloads and permutations, made with numpy from a seed, go
through the reference on ``tests/conftest.py``'s virtual devices (8, and
a 4-device mesh) and through the port on a CPU mesh of as many ranks,
where every wrapper takes its plain twin.  Everything is integers or
moved values, so everything must agree exactly: the padded shards, the
payloads (pads included), the counts and the flags.  Each reference runs
once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxtree_torch.ops import shard
from boxtree_torch.parallel import shard_sort as port
from boxtree_torch.parallel.mesh import Mesh
from boxtree_torch.utils.bridge import shards_from_numpy
from boxtree_tpu.parallel import shard_sort as ref
from torch_threads import one_torch_thread  # noqa: F401

PAD = np.iinfo(np.int64).max


def _jax_mesh(nranks):
    from jax.sharding import Mesh as JMesh
    devs = jax.devices()
    if len(devs) < nranks:
        pytest.skip(f"needs {nranks} (virtual) devices")
    return JMesh(np.array(devs[:nranks]), ("ranks",))


def _np(shards):
    """A sharded array of the port as stacked numpy."""
    return torch.stack(shards).numpy()


def _assert_shards_equal(got, want):
    """The port's shards (a list, or a tuple of lists) equal the
    reference's per-rank arrays, every rank, pads included."""
    want = shards_from_numpy(want)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
    else:
        got, want = (got,), (want,)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for r, (g, w) in enumerate(zip(gs, ws)):
            assert g.dtype == w.dtype and torch.equal(g, w), r


def _keys(case, rng):
    if case == "unique":
        n = 1 << 14
        return ((rng.integers(0, 1 << 40, n, dtype=np.int64) << 20)
                | np.arange(n, dtype=np.int64)), None, 2.0, 1
    if case == "skewed":
        n = 1 << 13
        a = rng.integers(1000, 1010, (9 * n) // 10, dtype=np.int64)
        b = rng.integers(0, 1 << 50, n - a.shape[0], dtype=np.int64)
        keys = np.concatenate([a, b])
        rng.shuffle(keys)
        return keys, None, 2.0, 1
    if case == "duplicates":
        n = 1 << 13
        return (rng.integers(0, 64, n, dtype=np.int64),
                np.arange(n, dtype=np.int64), 4.0, 1)
    if case == "two_keys":
        n = 1 << 13
        return (rng.integers(0, 32, n, dtype=np.int64),
                (rng.integers(0, 5, n, dtype=np.int64),
                 np.arange(n, dtype=np.int64)), 4.0, 2)
    if case == "overflow":
        n = 1 << 12
        return np.full(n, 42, np.int64), np.arange(n, dtype=np.int64), 1.5, 1
    raise AssertionError(case)


SORT_CASES = ["unique", "skewed", "duplicates", "two_keys", "overflow"]


def _as_jax(vals):
    if vals is None:
        return None
    if isinstance(vals, tuple):
        return tuple(jnp.asarray(v) for v in vals)
    return jnp.asarray(vals)


def _as_torch(vals):
    if vals is None:
        return None
    if isinstance(vals, tuple):
        return tuple(torch.as_tensor(v) for v in vals)
    return torch.as_tensor(vals)


@pytest.fixture(scope="module")
def sort_results():
    """{(case, nranks): (inputs, reference outputs, port outputs)}."""
    out = {}
    for nranks in (8, 4):
        jmesh = _jax_mesh(nranks)
        mesh = Mesh.of_ranks(nranks, "cpu")
        for i, case in enumerate(SORT_CASES):
            keys, vals, cf, nk = _keys(case, np.random.default_rng(30 + i))
            kw = dict(capacity_factor=cf, num_keys=nk)
            r = ref.sharded_key_sort(jnp.asarray(keys), jmesh,
                                     vals=_as_jax(vals), **kw)
            p = port.sharded_key_sort(torch.as_tensor(keys), mesh,
                                      vals=_as_torch(vals), **kw)
            out[case, nranks] = ((keys, vals), r, p, mesh, jmesh)
    return out


@pytest.mark.parametrize("nranks", [8, 4])
@pytest.mark.parametrize("case", SORT_CASES)
def test_sharded_key_sort(sort_results, case, nranks):
    """Padded shards, payloads (pads too), counts and the flag equal the
    reference's; the valid keys are the sorted keys, ties in input
    order."""
    (keys, vals), r, p, _, _ = sort_results[case, nranks]
    assert len(r) == len(p)
    assert p[-1] == r[-1] == (case != "overflow")
    np.testing.assert_array_equal(p[-2].numpy(), np.asarray(r[-2]))
    for got, want in zip(p[:-2], r[:-2]):
        _assert_shards_equal(got, want)
    if case != "overflow":
        counts = p[-2].numpy()
        merged = _np(p[0])
        flat = np.concatenate([merged[d, :counts[d]]
                               for d in range(nranks)])
        np.testing.assert_array_equal(flat, np.sort(keys))


@pytest.mark.parametrize("radius", [1, 7])
def test_sharded_rebalance_radius(radius):
    """Constant keys land on one rank: radius 1 is flagged, radius 7 not;
    both give the reference's shards."""
    n = 1 << 12
    keys = np.full(n, 7, np.int64)
    jmesh = _jax_mesh(8)
    mesh = Mesh.of_ranks(8, "cpu")
    merged, counts, ok = ref.sharded_key_sort(jnp.asarray(keys), jmesh,
                                              capacity_factor=8.0)
    pm, pc, pok = port.sharded_key_sort(torch.as_tensor(keys), mesh,
                                        capacity_factor=8.0)
    assert ok and pok
    shards, ok2 = ref.sharded_rebalance(merged, counts, jmesh, radius=radius)
    pshards, pok2 = port.sharded_rebalance(pm, pc, mesh, radius=radius)
    assert pok2 == ok2 == (radius == 7)
    _assert_shards_equal(pshards, shards)


@pytest.mark.parametrize("case", ["unique", "duplicates", "two_keys"])
def test_sharded_rebalance(sort_results, case):
    """Equal shards with their payloads, as the reference's."""
    _, r, p, mesh, jmesh = sort_results[case, 8]
    rr = ref.sharded_rebalance(r[0], r[-2], jmesh, vals=r[1] if len(r) == 4
                               else None)
    pp = port.sharded_rebalance(p[0], p[-2], mesh, vals=p[1] if len(p) == 4
                                else None)
    assert rr[-1] and pp[-1]
    assert len(rr) == len(pp)
    for got, want in zip(pp[:-1], rr[:-1]):
        _assert_shards_equal(got, want)


def test_sharded_sort_gather():
    rng = np.random.default_rng(36)
    keys = rng.integers(0, 1 << 30, 1 << 12, dtype=np.int64)
    got = port.sharded_sort_gather(torch.as_tensor(keys),
                                   Mesh.of_ranks(8, "cpu"),
                                   capacity_factor=0.5)
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


def _overflow_order(n, nranks):
    per = n // nranks
    order = np.arange(n, dtype=np.int64)
    order[:per] = np.arange(7 * per, 8 * per)
    order[7 * per:] = np.arange(per)
    return order


@pytest.mark.parametrize("case,cf", [("random", 2.0), ("overflow", 2.0),
                                     ("overflow", 8.0)],
                         ids=["random", "overflow", "overflow_cf8"])
def test_sharded_permute(case, cf):
    """data[order], the inverse and the flag equal the reference's, also
    when a bucket overflows."""
    rng = np.random.default_rng(35)
    if case == "random":
        n = 1 << 13
        order = rng.permutation(n).astype(np.int64)
        data = rng.standard_normal((n, 3)).astype(np.float32)
    else:
        n = 1 << 12
        order = _overflow_order(n, 8)
        data = np.arange(n, dtype=np.float64)[:, None]
    out, inv, ok = ref.sharded_permute(jnp.asarray(order), jnp.asarray(data),
                                       _jax_mesh(8), capacity_factor=cf)
    pout, pinv, pok = port.sharded_permute(
        torch.as_tensor(order), torch.as_tensor(data),
        Mesh.of_ranks(8, "cpu"), capacity_factor=cf)
    assert pok == ok == (case == "random" or cf == 8.0)
    _assert_shards_equal(pout, out)
    _assert_shards_equal(pinv, inv)
    if pok:
        np.testing.assert_array_equal(_np(pout).reshape(n, -1), data[order])
        np.testing.assert_array_equal(_np(pinv).reshape(-1),
                                      np.argsort(order))


def test_mesh_collectives_count_bytes():
    mesh = Mesh.of_ranks(3, "cpu")
    bufs = [torch.full((3, 2), r, dtype=torch.int64) for r in range(3)]
    recv = mesh.all_to_all(bufs)
    for d in range(3):
        np.testing.assert_array_equal(recv[d].numpy(),
                                      np.repeat(np.arange(3), 2).reshape(3, 2))
    assert mesh.bytes_between_ranks == 3 * 2 * 2 * 8
    g = mesh.all_gather([torch.tensor([r]) for r in range(3)])
    assert g[0] is g[2] and g[1].tolist() == [[0], [1], [2]]
    assert mesh.gather([torch.tensor([r]) for r in range(3)]).shape == (3, 1)
    assert mesh.broadcast(torch.zeros(2))[1].shape == (2,)
    with pytest.raises(ValueError):
        mesh.all_to_all([torch.zeros(2, 1)] * 3)


# {{{ K83-K86 against numpy

def test_bucket_pack_against_numpy():
    """Pads, an empty bucket, an overflowing one, payload offset."""
    local = torch.tensor([1, 2, 3, 5, 8, 13, 21], dtype=torch.int64)
    vals = torch.arange(7, dtype=torch.int64)[None] * 10
    starts = torch.tensor([0, 3, 3, 7], dtype=torch.int64)
    for fn in (shard.bucket_pack, shard.bucket_pack_plain):
        send, vsend, over = fn(local, vals, starts, 3, val_offset=100)
        np.testing.assert_array_equal(
            send.numpy(), [[1, 2, 3], [PAD, PAD, PAD], [5, 8, 13]])
        np.testing.assert_array_equal(
            vsend.numpy(), [[[100, 110, 120], [0, 0, 0], [130, 140, 150]]])
        assert over.tolist() == [1]
        _, _, over = fn(local, None, starts, 4)
        assert over.tolist() == [0]


def test_rebalance_place_against_numpy():
    a = torch.tensor([10, 11, 12, 13], dtype=torch.int64)
    b = torch.tensor([20, 21], dtype=torch.int64)
    segs = [(1, 0, 2, a, [a + 100]), (0, 3, 2, b, [b + 100])]
    for fn in (shard.rebalance_place, shard.rebalance_place_plain):
        out, vout = fn(segs, 6, 1)
        np.testing.assert_array_equal(out.numpy(),
                                      [11, 12, PAD, 20, 21, PAD])
        np.testing.assert_array_equal(vout.numpy(),
                                      [[111, 112, 0, 120, 121, 0]])
    out, vout = shard.rebalance_place([], 3, 2, device="cpu")
    assert out.tolist() == [PAD] * 3 and vout.shape == (2, 3)


def test_permute_serve_and_unpack_against_numpy():
    """The owner's rows and inverse (pads give zeros and are dropped), and
    the requester's unpack through bucket starts with an empty bucket."""
    data = torch.arange(12, dtype=torch.float64).reshape(4, 3) + 0.5
    got_o = torch.tensor([[5, PAD], [7, 4]], dtype=torch.int64)
    got_s = torch.tensor([[9, 0], [2, 6]], dtype=torch.int64)
    for fn in (shard.permute_serve, shard.permute_serve_plain):
        reply, inv = fn(got_o, got_s, data, 4)
        want = np.zeros((2, 2, 3))
        want[0, 0], want[1, 0], want[1, 1] = (data[1].numpy(),
                                              data[3].numpy(),
                                              data[0].numpy())
        np.testing.assert_array_equal(reply.numpy(), want)
        np.testing.assert_array_equal(inv.numpy(), [6, 9, 0, 2])
    reply = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)
    starts = torch.tensor([0, 0, 3], dtype=torch.int64)
    j_sorted = torch.tensor([2, 0, 1], dtype=torch.int64)
    for fn in (shard.permute_unpack, shard.permute_unpack_plain):
        out = fn(reply, starts, j_sorted)
        want = np.zeros((3, 2), np.float32)
        want[j_sorted.numpy()] = reply[1].numpy()
        np.testing.assert_array_equal(out.numpy(), want)

# }}}
