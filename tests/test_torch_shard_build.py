"""boxtree_torch.parallel.shard_build against boxtree_tpu.parallel.
shard_build on the CPU, and K87 / K88 (ops/shard.py) against numpy and
the single-device build.

The same points, made with numpy from a seed, go through the reference on
``tests/conftest.py``'s 8 virtual devices and through the port on a CPU
mesh of 8 ranks, where every wrapper takes its plain twin.  Codes, the
root box, leaf levels, level counts, the box skeleton and every integer
field of the tree must agree exactly, the centres within rtol 5e-16 (the
reference's host assembly rounds the centre's product and sum apart from
XLA's fused form, ``tests/test_shard_build.py:110-128``).  The port's
sharded tree must also equal the port's ``build_tree`` bit for bit,
centres included, and drive the port's counting FMM exactly.  The
reference's ``sharded_box_skeleton`` and ``sharded_build_tree`` run once
each, in module fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxtree_torch import build_tree, config
from boxtree_torch.ops import shard
from boxtree_torch.ops import tree as tree_ops
from boxtree_torch.parallel import shard_build as port
from boxtree_torch.parallel.mesh import Mesh
from boxtree_torch.parallel.shard_sort import shards_of
from boxtree_torch.tree.build import MaxLevelsExceeded
from boxtree_torch.utils.bridge import skeleton_from_numpy
from boxtree_tpu.parallel import shard_build as ref
from torch_threads import one_torch_thread  # noqa: F401

NRANKS = 8


@pytest.fixture(scope="module")
def jmesh():
    from jax.sharding import Mesh as JMesh
    devs = jax.devices()
    if len(devs) < NRANKS:
        pytest.skip("needs 8 (virtual) devices")
    return JMesh(np.array(devs[:NRANKS]), ("ranks",))


@pytest.fixture(scope="module")
def mesh():
    return Mesh.of_ranks(NRANKS, "cpu")


def _clustered(dims, n, seed, width):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.random((dims, n // 2)) * width,
                           rng.random((dims, n // 2))], axis=1)


def _np(x):
    if isinstance(x, list):
        return torch.stack(x).numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _sorted_codes(pts, mesh, depth):
    """Full-depth codes (the port's K1 twin) in sorted order, and the
    sort's permutation."""
    codes, _, _ = port.sharded_morton_codes(torch.as_tensor(pts), mesh,
                                            depth=depth)
    codes = torch.cat(codes).numpy()
    order = np.argsort(codes, kind="stable")
    return codes[order], order


# {{{ codes, leaf levels

def test_sharded_morton_codes(jmesh, mesh):
    pts = _clustered(3, 1 << 13, 71, 0.05)
    codes, bbox_min, root_extent = ref.sharded_morton_codes(pts, jmesh)
    pc, pmin, pext = port.sharded_morton_codes(torch.as_tensor(pts), mesh)
    np.testing.assert_array_equal(torch.cat(pc).numpy(), np.asarray(codes))
    np.testing.assert_array_equal(pmin.numpy(), bbox_min)
    assert pext.item() == root_extent


LEAF_CASES = {
    "2d_uniform": (2, 1 << 12, 41, None, 30),
    "3d_uniform": (3, 1 << 13, 41, None, 30),
    "2d_clustered_weights": (2, 1 << 12, 42, 0.02, 17),
    "3d_clustered": (3, 1 << 13, 61, 0.03, 30),
}


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_sharded_leaf_levels(jmesh, mesh, case):
    """Leaf levels and the packed counts equal the reference's, with refine
    weights 1-3 on the clustered 2D points (boxes span shard boundaries
    at many levels)."""
    dims, n, seed, width, max_w = LEAF_CASES[case]
    if width is None:
        pts = np.random.default_rng(seed).random((dims, n))
    else:
        pts = _clustered(dims, n, seed, width)
    depth = config.max_morton_depth(dims)
    codes_s, order = _sorted_codes(pts, mesh, depth)
    weights = np.ones(n, np.int64)
    if "weights" in case:
        weights = np.random.default_rng(seed).integers(1, 4, n).astype(
            np.int64)
    w_s = weights[order]
    leaf, counts = ref.sharded_leaf_levels(
        jnp.asarray(codes_s), jnp.asarray(w_s), jmesh, max_weight=max_w,
        dimensions=dims, depth=depth)
    pleaf, pcounts = port.sharded_leaf_levels(
        torch.as_tensor(codes_s), torch.as_tensor(w_s), mesh,
        max_weight=max_w, dimensions=dims, depth=depth)
    np.testing.assert_array_equal(torch.cat(pleaf).numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(pcounts.numpy(), counts)


def _np_leaf_levels(codes, w, max_w, d, depth):
    """The single-device phase A in numpy: the first level at which a
    particle's box weighs at most *max_w*, and the boxes of every level."""
    n = codes.shape[0]
    leaf = np.full(n, -1)
    counts = np.zeros(depth + 2, np.int64)
    for lev in range(depth + 1):
        pfx = codes >> (d * (depth - lev))
        _, inv = np.unique(pfx, return_inverse=True)
        tot = np.bincount(inv, w)[inv]
        start = np.r_[True, pfx[1:] != pfx[:-1]]
        active = leaf < 0
        counts[lev] = (start & active).sum()
        leaf[active & (tot <= max_w)] = lev
    unfit = int((leaf < 0).sum())
    leaf[leaf < 0] = depth
    return leaf, np.r_[counts, unfit]


@pytest.mark.parametrize("nranks,weighted", [(3, False), (12, True),
                                             (4, True)])
def test_leaf_levels_twin_against_numpy(nranks, weighted):
    """K87's wrapper and twin on small shards, where level-1 and level-2
    boxes span three and more shards: the ranks' leaf levels and summed
    counts equal the single-device phase A in numpy, and each rank's twin
    call equals its wrapper."""
    d, depth, per = 2, 3, 4
    rng = np.random.default_rng(nranks)
    codes = np.sort(np.r_[rng.integers(0, 4, 3 * nranks),
                          rng.integers(0, 1 << (d * depth), nranks)])
    w = rng.integers(1, 3, codes.shape[0]) if weighted else np.ones_like(
        codes)
    m = Mesh.of_ranks(nranks, "cpu")
    assert codes.shape[0] == per * nranks
    leaf, counts = port.sharded_leaf_levels(
        torch.as_tensor(codes), torch.as_tensor(w), m, max_weight=5,
        dimensions=d, depth=depth)
    want_leaf, want_counts = _np_leaf_levels(codes, w, 5, d, depth)
    np.testing.assert_array_equal(torch.cat(leaf).numpy(), want_leaf)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    # the single-device K43 twin agrees
    lf, packed = tree_ops.leaf_levels_plain(
        torch.as_tensor(codes), torch.as_tensor(w), None, 5, dimensions=d,
        depth=depth)
    np.testing.assert_array_equal(lf.numpy(), want_leaf)
    np.testing.assert_array_equal(packed[:depth + 3].numpy(), want_counts)
    # one rank through the wrapper and the twin
    masks = shard.level_masks(d, depth, "cpu")
    cs = shards_of(torch.as_tensor(codes), m)
    cw = [shard.cumulative_weights(x)
          for x in shards_of(torch.as_tensor(w), m)]
    summ = torch.stack([shard.leaf_summary(c, x, masks)
                        for c, x in zip(cs, cw)])
    r = nranks // 2
    a = shard.shard_leaf_levels(cs[r], cw[r], summ, r, 5, dimensions=d,
                                depth=depth)
    b = shard.shard_leaf_levels_plain(cs[r], cw[r], summ, r, 5,
                                      dimensions=d, depth=depth)
    assert all(torch.equal(x, y) for x, y in zip(a, b))

# }}}


# {{{ the box skeleton

def _skeleton_inputs(pts, mesh, max_w):
    dims = pts.shape[0]
    depth = config.max_morton_depth(dims)
    codes_s, _ = _sorted_codes(pts, mesh, depth)
    leaf, counts = port.sharded_leaf_levels(
        torch.as_tensor(codes_s), None, mesh, max_weight=max_w,
        dimensions=dims, depth=depth)
    return codes_s, torch.cat(leaf).numpy(), counts.numpy(), depth


def _assert_skeletons_equal(got, want):
    """Every key, every rank, pads included, in the port's layout."""
    want = skeleton_from_numpy(want)
    assert set(got) == set(want) == set(port.SKELETON_KEYS)
    for key in port.SKELETON_KEYS:
        for r, (g, w) in enumerate(zip(got[key], want[key], strict=True)):
            assert g.dtype == w.dtype and torch.equal(g, w), (key, r)


def test_sharded_box_skeleton_2d(jmesh, mesh):
    """Every key of the reference's skeleton dict, every rank, pads
    included, on clustered 2D points."""
    pts = _clustered(2, 1 << 12, 81, 0.04)
    codes_s, leaf, counts, depth = _skeleton_inputs(pts, mesh, 25)
    want = ref.sharded_box_skeleton(jnp.asarray(codes_s),
                                    jnp.asarray(leaf), counts, jmesh,
                                    dimensions=2, depth=depth)
    got = port.sharded_box_skeleton(torch.as_tensor(codes_s),
                                    torch.as_tensor(leaf), counts, mesh,
                                    dimensions=2, depth=depth)
    _assert_skeletons_equal(got, want)


@pytest.mark.parametrize("nranks", [5, 8])
def test_skeleton_twin_against_single_device(nranks):
    """K88's wrapper on small shards (a handful of particles a rank, boxes
    spanning three and more shards): the rows, scattered to their ids,
    equal the single-device phase B twin's arrays, and every child link
    made across ranks is there."""
    d = 2
    per = 8
    pts = _clustered(d, per * nranks, nranks, 0.1)
    m = Mesh.of_ranks(nranks, "cpu")
    codes_s, leaf, counts, depth = _skeleton_inputs(pts, m, 3)
    skel = port.sharded_box_skeleton(torch.as_tensor(codes_s),
                                     torch.as_tensor(leaf), counts, m,
                                     dimensions=d, depth=depth)
    nlevels, lsb, _ = port._skeleton_cap(counts[:-1], per)
    single = tree_ops.box_levels_plain(
        torch.as_tensor(codes_s), torch.as_tensor(leaf, dtype=torch.int32),
        torch.zeros(d, dtype=torch.float64), torch.tensor(1.0),
        dimensions=d, depth=depth, level_starts=tuple(lsb))
    ids = _np(skel["box_id"]).reshape(-1)
    valid = ids >= 0
    assert valid.sum() == lsb[-1] == _np(skel["nboxes"]).sum()

    def scatter(key):
        vals = _np(skel[key]).reshape(valid.shape[0], -1)[valid]
        out = np.empty_like(vals)
        out[ids[valid]] = vals
        return out.squeeze(-1) if out.shape[1] == 1 else out
    np.testing.assert_array_equal(scatter("box_morton"),
                                  single["box_morton"].numpy())
    np.testing.assert_array_equal(scatter("box_level"),
                                  single["box_level"].numpy())
    np.testing.assert_array_equal(scatter("box_start"),
                                  single["box_start"].numpy())
    np.testing.assert_array_equal(scatter("box_count_cumul"),
                                  single["box_count_cumul"].numpy())
    parent = scatter("box_parent")
    parent[0] = 0
    np.testing.assert_array_equal(parent, single["box_parent"].numpy())
    child = scatter("box_child")
    np.testing.assert_array_equal(np.where(child < 0, 0, child).T,
                                  single["box_child"].numpy())
    # at least one box must span three shards for this case to bite
    starts, cumul = scatter("box_start"), scatter("box_count_cumul")
    assert ((starts + cumul - 1) // per - starts // per >= 2).any()

# }}}


# {{{ the whole build

@pytest.fixture(scope="module")
def builds(jmesh, mesh):
    """The reference's sharded tree and skeleton, the port's, and the
    port's ``build_tree``, on ``tests/test_shard_build.py:138-143``'s
    8,192 clustered 3D points."""
    pts = _clustered(3, 1 << 13, 71, 0.05)
    tree_r, skel_r = ref.sharded_build_tree(
        pts, jmesh, max_particles_in_box=30, return_skeleton=True)
    tree_p, skel_p = port.sharded_build_tree(
        torch.as_tensor(pts), mesh, max_particles_in_box=30,
        return_skeleton=True)
    return pts, tree_r, skel_r, tree_p, skel_p, build_tree(
        torch.as_tensor(pts), max_particles_in_box=30)


TREE_FIELDS = ("box_morton_prefixes", "box_levels", "box_parent_ids",
               "box_child_ids", "box_flags", "box_source_starts",
               "box_source_counts_cumul", "box_source_counts_nonchild",
               "box_target_starts", "box_target_counts_cumul",
               "box_target_counts_nonchild", "user_source_ids",
               "sorted_target_ids", "box_id_of_source", "box_id_of_target",
               "sources", "targets")


@pytest.mark.parametrize("field", TREE_FIELDS)
def test_sharded_build_tree_matches_reference(builds, field):
    _, tree_r, _, tree_p, _, _ = builds
    np.testing.assert_array_equal(getattr(tree_p, field).numpy(),
                                  np.asarray(getattr(tree_r, field)),
                                  err_msg=field)


def test_sharded_build_tree_box_geometry(builds):
    _, tree_r, _, tree_p, _, _ = builds
    assert tree_p.level_start_box_nrs == tree_r.level_start_box_nrs
    assert tree_p.root_extent.item() == float(tree_r.root_extent)
    np.testing.assert_allclose(tree_p.box_centers.numpy(),
                               np.asarray(tree_r.box_centers), rtol=5e-16)


def test_sharded_build_tree_depth_departs_from_reference(builds):
    """The port keys at ``build_tree``'s shallow first-try depth, the
    reference's sharded build at the full depth: a documented departure,
    pinned here."""
    pts, tree_r, _, tree_p, _, tree = builds
    dims, n = pts.shape
    assert tree_r.max_depth == config.max_morton_depth(dims)
    assert tree_p.max_depth == tree.max_depth \
        == (63 - (n - 1).bit_length()) // dims
    assert tree_p.max_depth < tree_r.max_depth


def test_sharded_skeleton_matches_reference(builds):
    """The skeleton the build returns: every key, every rank, as the
    reference's."""
    _, _, skel_r, _, skel_p, _ = builds
    _assert_skeletons_equal(skel_p, skel_r)


def test_sharded_build_tree_equals_build_tree(builds):
    """Every field of the port's own ``build_tree``, bit for bit."""
    _, _, _, tree_p, _, tree = builds
    for f in dataclasses.fields(tree):
        a, b = getattr(tree_p, f.name), getattr(tree, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_counting_fmm_on_sharded_tree(builds):
    """The port's traversal and counting FMM on the sharded tree: every
    potential equals the number of sources."""
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import ConstantOneExpansionWrangler
    from boxtree_torch.traversal import build_traversal
    tree_p = builds[3]
    n = tree_p.nsources
    pot = drive_fmm(ConstantOneExpansionWrangler(None,
                                                 build_traversal(tree_p)),
                    [torch.ones(n, dtype=torch.float64)])
    assert (pot == n).all()


def test_sharded_build_tree_timing_and_int_mesh():
    pts = torch.as_tensor(np.random.default_rng(3).random((2, 1200)))
    info = {}
    tree = port.sharded_build_tree(pts, 4, max_particles_in_box=20,
                                   timing_data=info)
    assert set(info["stage_s"]) == {"codes", "sort", "rebalance",
                                    "leaf_levels", "skeleton", "assembly",
                                    "permute", "box_ids"}
    assert info["radius"] == 2 and info["depth"] == tree.max_depth
    ref_tree = build_tree(pts, max_particles_in_box=20)
    assert torch.equal(tree.box_child_ids, ref_tree.box_child_ids)
    assert torch.equal(tree.sources, ref_tree.sources)

# }}}


# {{{ refusals and the reference's errors

def test_refusals_name_the_roadmap():
    pts = torch.as_tensor(np.random.default_rng(4).random((3, 64)))
    for kw in (dict(kind="non-adaptive"),
               dict(kind="adaptive-level-restricted"),
               dict(targets=pts), dict(targets=pts, source_radii=pts[0])):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.sharded_build_tree(pts, 4, max_particles_in_box=8, **kw)
    m = Mesh.of_ranks(4, "cpu")
    codes = torch.arange(64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.sharded_leaf_levels(codes, None, m, max_weight=8,
                                 dimensions=3, depth=20, adaptive=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.sharded_leaf_levels(codes, None, m, max_weight=8, dimensions=3,
                                 depth=20, stick_s=codes)
    for kw in (dict(is_src_s=codes), dict(with_extents=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port.sharded_box_skeleton(codes, codes, np.ones(23), m,
                                      dimensions=3, depth=20, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.sharded_morton_codes(pts, m, radii=pts[0])


def test_reference_errors():
    pts = torch.as_tensor(np.random.default_rng(5).random((3, 66)))
    with pytest.raises(ValueError, match="unknown tree kind"):
        port.sharded_build_tree(pts, 4, max_particles_in_box=8, kind="x")
    with pytest.raises(ValueError, match="not divisible"):
        port.sharded_build_tree(pts, 4, max_particles_in_box=8)
    with pytest.raises(ValueError, match="zero particles"):
        port.sharded_build_tree(pts[:, :0], 4, max_particles_in_box=8)
    same = torch.full((3, 64), 0.5, dtype=torch.float64)
    same[:, 0] = 0.0
    with pytest.raises(MaxLevelsExceeded):
        port.sharded_build_tree(same, 4, max_particles_in_box=8)

# }}}
