"""Level-restricted trees and the geometric queries of boxtree_torch
against boxtree_tpu, on the CPU (Config B's path).

One 3D and one 2D level-restricted tree of points on the unit sphere
(circle), some of them in a small cap so that the restriction has work to
do, are built by both packages, once, in a module fixture (the JAX
restriction compiles once per deepest level; the trees are kept to 6 and
7 levels, since the JAX compiles grow with the depth).  On them:

- every ``Tree`` field: box centres to 1 ulp (the reference's XLA build may
  contract ``bbox_min + (cell + 0.5) * size`` into an FMA), the rest
  exactly;
- the area query (balls inside and outside the bounding box, and a tree
  whose root is a leaf), leaves-to-balls and peer lists in 2D: starts and
  lists exactly, order included;
- the space invader, float32, bit for bit, and ``area_query_elementwise``
  with add (integers exactly, floats to 1e-12 relative: another summation
  order) and max (exactly);
- peer lists in 3D against the adjacency and same-level-completeness
  oracle of ``tests/test_geometry.py:142-158``;
- every field of the port's ``build_traversal`` on the restricted tree
  against the reference's, and the counting FMM on it, exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxtree_tpu
from boxtree_torch import Tree, build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.geometry import (
    AreaQueryBuilder,
    LeavesToBallsLookupBuilder,
    PeerListFinder,
    SpaceInvaderQueryBuilder,
    area_query_elementwise,
)
from boxtree_torch.models import ConstantOneExpansionWrangler
from boxtree_torch.traversal import FMMTraversalInfo, build_traversal
from boxtree_torch.utils.bridge import to_numpy
from boxtree_tpu.geometry import (
    AreaQueryBuilder as JaxAreaQueryBuilder,
    LeavesToBallsLookupBuilder as JaxLeavesToBallsLookupBuilder,
    PeerListFinder as JaxPeerListFinder,
    SpaceInvaderQueryBuilder as JaxSpaceInvaderQueryBuilder,
    area_query_elementwise as jax_area_query_elementwise,
)
from boxtree_tpu.traversal import build_traversal as jax_build_traversal
from boxtree_tpu.utils.particles import make_surface_particle_array
from torch_threads import one_torch_thread  # noqa: F401

KIND = "adaptive-level-restricted"
#: dimensions, points, seed, points in the cap, cap width
DIMS = {"3d": (3, 3000, 11, 100, 0.05), "2d": (2, 2000, 5, 300, 0.3)}
TREE_FIELDS = [f.name for f in dataclasses.fields(Tree)]
TRAV_FIELDS = [f.name for f in dataclasses.fields(FMMTraversalInfo)
               if f.name != "tree"]


def _points(dims, n, seed, ncap, width):
    """*n* points on the unit sphere, *ncap* of them in a cap of about
    *width* around the diagonal: leaves levels apart that the restriction
    must grade."""
    base = make_surface_particle_array(n - ncap, dims, np.float64, seed)
    cap = (np.full((dims, 1), dims ** -0.5) + width
           * np.random.default_rng(seed).standard_normal((dims, ncap)))
    return np.concatenate([base, cap / np.sqrt((cap * cap).sum(0))], axis=1)


def _balls(dims, n, seed):
    """Balls inside and outside the bounding box of the unit sphere."""
    rng = np.random.default_rng(seed)
    centers = np.concatenate([rng.uniform(-1, 1, (dims, n - n // 4)),
                              rng.uniform(-3, 3, (dims, n // 4))], axis=1)
    radii = rng.uniform(0.0, 0.3, n)
    return centers, radii


@pytest.fixture(scope="module")
def setups():
    out = {}
    for name, (dims, n, seed, *_) in DIMS.items():
        pts = _points(*DIMS[name])
        ref = boxtree_tpu.build_tree(pts, kind=KIND, max_particles_in_box=30)
        got = build_tree(torch.from_numpy(pts), kind=KIND,
                         max_particles_in_box=30)
        out[name] = dict(ref=ref, got=got, balls=_balls(dims, 200, seed))
    return out


def _same(val, ref):
    ref = np.asarray(ref)
    val = to_numpy(val)
    assert val.dtype == ref.dtype and val.shape == ref.shape
    np.testing.assert_array_equal(val, ref)


# {{{ the tree

@pytest.mark.parametrize("field", TREE_FIELDS)
@pytest.mark.parametrize("dims", list(DIMS))
def test_restricted_tree_field(setups, dims, field):
    ref_tree, got_tree = setups[dims]["ref"], setups[dims]["got"]
    ref, val = getattr(ref_tree, field), to_numpy(getattr(got_tree, field))
    if field.endswith("_dtype"):
        assert val == np.dtype(ref)
    elif field == "level_start_box_nrs":
        assert tuple(val) == tuple(ref)
    elif ref is None or isinstance(ref, (bool, int, float, str)):
        assert val == ref
    elif field == "box_centers":
        ref = np.asarray(ref)
        assert val.dtype == ref.dtype and val.shape == ref.shape
        assert np.abs(val - ref).max() <= np.spacing(np.abs(ref).max())
    else:
        _same(val, ref)


@pytest.mark.parametrize("dims", list(DIMS))
def test_restriction_refined(setups, dims):
    """The restriction changed the tree: it has more boxes than the plain
    adaptive tree of the same points."""
    pts = _points(*DIMS[dims])
    plain = build_tree(torch.from_numpy(pts), max_particles_in_box=30)
    assert setups[dims]["got"].nboxes > plain.nboxes

# }}}


# {{{ area query, leaves-to-balls, space invader, elementwise

@pytest.fixture(scope="module")
def queries(setups):
    out = {}
    for name, s in setups.items():
        centers, radii = s["balls"]
        ref, got = s["ref"], s["got"]
        tc, tr = torch.from_numpy(centers), torch.from_numpy(radii)
        out[name] = dict(
            aq=(JaxAreaQueryBuilder()(ref, centers, radii),
                AreaQueryBuilder()(got, tc, tr)),
            l2b=(JaxLeavesToBallsLookupBuilder()(ref, centers, radii),
                 LeavesToBallsLookupBuilder()(None, got, tc, tr)),
            si=(JaxSpaceInvaderQueryBuilder()(ref, centers, radii),
                SpaceInvaderQueryBuilder()(got, tc, tr)))
    return out


@pytest.mark.parametrize("field", ["leaves_near_ball_starts",
                                   "leaves_near_ball_lists"])
@pytest.mark.parametrize("dims", list(DIMS))
def test_area_query(queries, dims, field):
    ref, got = queries[dims]["aq"]
    assert got.leaves_near_ball_lists.shape[0] > 0
    _same(getattr(got, field), getattr(ref, field))


@pytest.mark.parametrize("field", ["balls_near_box_starts",
                                   "balls_near_box_lists"])
@pytest.mark.parametrize("dims", list(DIMS))
def test_leaves_to_balls(queries, dims, field):
    ref, got = queries[dims]["l2b"]
    _same(getattr(got, field), getattr(ref, field))


@pytest.mark.parametrize("dims", list(DIMS))
def test_space_invader_bit_equal(queries, dims):
    ref, got = queries[dims]["si"]
    assert float(got.max()) > 0
    _same(got, ref)


def test_to_numpy_of_query_results(queries):
    aq = to_numpy(queries["2d"]["aq"][1])
    l2b = to_numpy(queries["2d"]["l2b"][1])
    assert set(aq) == {"tree", "leaves_near_ball_starts",
                       "leaves_near_ball_lists"}
    assert set(l2b) == {"tree", "balls_near_box_starts",
                        "balls_near_box_lists"}
    assert isinstance(aq["leaves_near_ball_lists"], np.ndarray)
    assert isinstance(aq["tree"]["box_centers"], np.ndarray)


def test_area_query_root_is_leaf():
    pts = make_surface_particle_array(20, 3, np.float64, 2)
    centers, radii = _balls(3, 40, 9)
    ref_tree = boxtree_tpu.build_tree(pts, kind=KIND, max_particles_in_box=30)
    tree = build_tree(torch.from_numpy(pts), kind=KIND,
                      max_particles_in_box=30)
    assert tree.nboxes == 1
    ref = JaxAreaQueryBuilder()(ref_tree, centers, radii)
    got = AreaQueryBuilder()(tree, torch.from_numpy(centers),
                             torch.from_numpy(radii))
    _same(got.leaves_near_ball_starts, ref.leaves_near_ball_starts)
    _same(got.leaves_near_ball_lists, ref.leaves_near_ball_lists)
    ref_si = JaxSpaceInvaderQueryBuilder()(ref_tree, centers, radii)
    _same(SpaceInvaderQueryBuilder()(tree, torch.from_numpy(centers),
                                     torch.from_numpy(radii)), ref_si)


@pytest.mark.parametrize("combine", ["add", "max"])
@pytest.mark.parametrize("dims", list(DIMS))
def test_area_query_elementwise(setups, dims, combine):
    """Per ball: the number of overlapping leaves (int64), and the sum or
    the largest of their box radii (float64).  The ball generator hands
    out the balls in reverse order (the same balls, so the JAX sweep
    reuses its compiled levels)."""
    s = setups[dims]
    centers, radii = s["balls"]
    nballs = centers.shape[1]
    root = float(np.asarray(s["ref"].root_extent))
    ref_levels = s["ref"].box_levels
    levels = s["got"].box_levels
    jc, jr = jnp.asarray(centers), jnp.asarray(radii)
    tc, tr = torch.from_numpy(centers), torch.from_numpy(radii)

    def jax_gen(idx):
        return jc[:, nballs - 1 - idx], jr[nballs - 1 - idx]

    def gen(idx):
        return tc[:, nballs - 1 - idx], tr[nballs - 1 - idx]

    ref_rad = jax_area_query_elementwise(
        s["ref"], jax_gen, nballs,
        lambda b, le: (root / 2.0 ** (ref_levels[le] + 1.0), b),
        jnp.zeros(nballs, jnp.float64), combine=combine)
    got_rad = area_query_elementwise(
        s["got"], gen, nballs,
        lambda b, le: (root / 2.0 ** (levels[le].to(torch.float64) + 1.0),
                       b),
        torch.zeros(nballs, dtype=torch.float64), combine=combine)
    ref_rad = np.asarray(ref_rad)
    if combine == "add":
        assert np.abs(got_rad.numpy() - ref_rad).max() \
            <= 1e-12 * np.abs(ref_rad).max()
        ref_cnt = jax_area_query_elementwise(
            s["ref"], jax_gen, nballs, lambda b, le: (jnp.ones_like(b), b),
            jnp.zeros(nballs, jnp.int64), combine="add")
        got_cnt = area_query_elementwise(
            s["got"], gen, nballs, lambda b, le: (torch.ones_like(b), b),
            torch.zeros(nballs, dtype=torch.int64), combine="add")
        assert int(got_cnt.sum()) > 0
        _same(got_cnt, ref_cnt)
    else:
        _same(got_rad, ref_rad)

# }}}


# {{{ peer lists

def test_peer_lists_2d(setups):
    ref = JaxPeerListFinder()(setups["2d"]["ref"])
    got = PeerListFinder()(setups["2d"]["got"])
    _same(got.peer_list_starts, ref.peer_list_starts)
    _same(got.peer_lists, ref.peer_lists)


def test_peer_lists_3d_oracle(setups):
    """Peers are adjacent and at the box's level or coarser, and every
    adjacent box at the same level is a peer (``tests/test_geometry.py:
    142-158``), for every box."""
    tree = setups["3d"]["got"]
    pl = PeerListFinder()(tree)
    starts = pl.peer_list_starts.numpy()
    lists = pl.peer_lists.numpy()
    levels = tree.box_levels.numpy()
    centers = tree.box_centers.numpy()
    root = float(tree.root_extent)
    rad = root / (1 << (levels + 1)).astype(np.float64)
    assert lists.shape[0] > tree.nboxes
    for b in range(tree.nboxes):
        peers = lists[starts[b]:starts[b + 1]]
        dist = np.abs(centers - centers[:, b:b + 1]).max(axis=0)
        adjacent = dist <= (rad + rad[b]) * (1 + 1e-9)
        assert (levels[peers] <= levels[b]).all()
        assert adjacent[peers].all()
        same = np.nonzero(adjacent & (levels == levels[b]))[0]
        assert set(same) <= set(peers)

# }}}


# {{{ traversal and counting FMM on the restricted tree

@pytest.fixture(scope="module")
def traversals(setups):
    s = setups["3d"]
    return jax_build_traversal(s["ref"]), build_traversal(s["got"])


@pytest.mark.parametrize("field", TRAV_FIELDS)
def test_restricted_traversal_field(traversals, field):
    ref, got = traversals
    ref, val = getattr(ref, field), getattr(got, field)
    if field == "from_sep_smaller_by_level":
        assert len(val) == len(ref)
        for g, r in zip(val, ref):
            for f in ("count", "num_nonempty_lists"):
                assert getattr(g, f) == int(getattr(r, f))
            for f in ("starts", "lists", "nonempty_indices"):
                _same(getattr(g, f), getattr(r, f))
    elif field == "target_boxes_sep_smaller_by_source_level":
        assert len(val) == len(ref)
        for v, r in zip(val, ref):
            _same(v, r)
    elif ref is None or isinstance(ref, (int, np.integer)):
        assert val == ref
    else:
        _same(val, ref)


@pytest.mark.parametrize("dims", list(DIMS))
def test_counting_fmm_exact_on_restricted_tree(setups, dims):
    tree = setups[dims]["got"]
    w = ConstantOneExpansionWrangler(None, build_traversal(tree))
    pot = drive_fmm(w, [torch.ones(tree.nsources, dtype=torch.float64)])
    assert torch.equal(pot, torch.full_like(pot, tree.nsources))

# }}}
