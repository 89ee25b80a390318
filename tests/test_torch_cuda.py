"""The CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips without one.  The file imports neither JAX nor boxtree_tpu, so it
also runs where only PyTorch is installed::

    python -m pytest --noconftest -p no:randomly -q -m cuda \
        tests/test_torch_cuda.py

K1 must be bit-exact; K2-K4 agree with their twins to rel l-inf 1e-5 in
float32 (rsqrt and another summation order) and 1e-12 in float64; K9-K11
(Helmholtz, complex128) to 1e-10, the bar of ``chip_smoke.py`` (Bessel
recurrences in another rounding, FMA contraction, another summation
order), and the Helmholtz FMM on the card matches the CPU port to 1e-10.
K16-K18 (2D Helmholtz, complex128) agree with their twins to 1e-12 (K16's
H_0 comes from CUDA's j0/y0, K17/K18 repeat the twin's recurrence), also
where a particle sits on a box centre (r = 0) or within k r < 1e-8 of it
(where K16's CUDA y0 and the twin's small-argument Y agree), and the 2D
Helmholtz FMM on the card matches the CPU port to 1e-10.  K19-K21 (2D
Laplace) agree with their twins to 1e-12 in complex128 and float64 pairs
and 1e-5 in float32 pairs, also at r = 0, w = 0, on centre lines with
either zero sign, on empty rows and at order 35; the 2D Laplace FMM on
the card matches the CPU port.  K2-K4's complex128 entry points and the
dipole kernels K22 (P2P) and K23 (P2L) agree with their twins to 1e-12 in
complex128 and float64 and 1e-5 in float32, also at r = 0; both 3D
layouts build their M2L tables on the card; the 3D FMM on the card, with
and without dipoles and ``level_to_order``, matches the CPU port.
K28-K30 (3D Laplace P2M, dipole P2M and L2P) agree with their twins to
1e-12 in complex128 and float64 and 1e-5 in float32, each box's multipole
row held to its own largest value: at the FMM's shapes with separate
targets, with ``level_to_order`` masks, at r = 0, on a tree whose sources
and targets stop in boxes with children (more than 32 a box), at order 0
and past the 48-KiB shared-memory default, on a one-box tree; each 3D
Laplace FMM launches K28 (K29 with dipoles) and K30 once.  K5-K8
(level restriction, area-query sweep, space invader, peer lists) compute
integers, or a float maximum that does not depend on order, so they must
equal their twins exactly, and a level-restricted tree built on the card
must equal the one built on the CPU.  K12-K15 (stick levels, box
bounding boxes, Lists 4 and 3 with target extents) must equal their twins
exactly, and a tree with extents and its traversal built on the card must
equal the ones built on the CPU.  K24-K27 (the neighbour table, the
colleagues and List 2, Lists 4 and 3, List 1) compute integers and must
equal their twins bit for bit, CSR order included, on 3D uniform, 2D
clustered, level-restricted and extent trees, and the traversal they build
on the card must equal the CPU port's field by field.  K35-K37 (M2L, M2M
and L2L) agree with their twins to 1e-12 in complex128 and float64 and
1e-5 in float32, per coefficient column, on the 3D Laplace (dipoles,
``level_to_order``), 3D and 2D Helmholtz and 2D Laplace wranglers and on
the order-31 line (1,024 and 2,048 coefficients a row); an FMM launches
K35 once, K36 and K37 once a level; the order-31 line on the card meets
the reference's stability bar.  K38-K42 (2D Laplace P2M and L2P, dipole
P2M, P2P and P2L) agree with their twins to 1e-12 in complex128 and
float64 pairs and 1e-5 in float32 pairs, per coefficient column, on a
starfish curve with separate targets and on the clustered tree, at r = 0,
w = z0 = 0 and on centre lines, at orders 0, 1 and 35; the 2D double
layer on the card matches the CPU port and launches each of its kernels
once.  K43-K46 (the tree build's phase A and phase B, the restriction's
sweep and recount) compute integers and box centres in the twins'
rounding, so they must equal their twins bit for bit on 3D uniform, 2D
clustered, restricted, extent, non-adaptive, weighted and given-bbox
trees (and K43 on coincident points and at 1D's full depth); a tree built
on the card must equal the CPU build field by field, launching K43 once,
K44 once a level and, restricted, K45 once a level a round and K46 once.
K47-K56 (the real-pair Helmholtz layout's float64 entry points of K9-K11,
K31, K32, K16-K18, K33 and K34) agree with their twins to 1e-12 per
coefficient column and per potential lane (a lane that is zero but for
rounding held to the array's largest value), also at r = 0 and, in 2D, at
k = 200; ``pairs=None`` on the card gives the pair wranglers, whose FMM
launches only the float64 entry points and matches the complex FMM to
1e-12.  K57-K62 (the 3D Helmholtz dipole P2M, P2P and P2L, complex128 and
pairs) agree with their twins no looser than their charge kernels' bars
(1e-10 for the complex P2P / P2L, 1e-12 for the rest), per coefficient
column and potential lane: normal and random dipoles, rscale on and off,
at r = 0 and k r < 1e-6, on empty rows, at orders 0 and 15; each dipole
FMM on the card launches the dipole entry points of its layout once and
no charge P2M / P2P / P2L, and matches the CPU port to 1e-10.  K69-K74
(the 3D and 2D M2L tables, three layouts each) agree with their twins per
operator to 1e-12 (1e-6 in float32), with rscale 1 and below 1, with
``level_to_order`` masks, and in 3D at order 31 (the operators split over
CTAs); a Laplace wrangler on the card builds its table in one launch.
K80-K82 (the distributed FMM's pack, unpack and masked merge) equal
their twins exactly, every dtype, with -1 entries, both unpack ops, masked
and unmasked merges; the distributed runner on the card (4 ranks
hypercube and allreduce, 3 ranks) matches the single-device FMM (1e-12
float64, 1e-5 float32), launches K80-K82 (the allreduce K82 alone) and
one K35 a rank, each rank with fewer List-2 edges than the traversal, and
its counting runner is exact.  K75 / K76 (List 2 classified by (level,
class)) equal their twin exactly; K77-K79 (the rotation M2L) agree with their twin to 1e-12
(1e-5 in float32) over the locals at orders 4 and 8, with operator groups
longer and shorter than a tile, and the rotation FMM on the card launches
them once and no K35 and matches the dense FMM to 1e-12 (float32 pairs
1e-5 against complex128).  K83-K88 (the sharded build's bucket pack,
rebalance placement, permutation serve and unpack, sharded phases A and
B) move or count integers and must equal their twins exactly; the
sharded build on the card (4 and 8 ranks) gives the CPU twins' skeleton
and ``build_tree``'s tree field for field, launches K83-K88 as its design
says and drives the counting FMM exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.geometry import (
    AreaQueryBuilder,
    LeavesToBallsLookupBuilder,
    PeerListFinder,
    SpaceInvaderQueryBuilder,
)
from boxtree_torch.models import (
    ConstantOneExpansionWrangler,
    make_helmholtz_wrangler,
    make_laplace_wrangler,
)
from boxtree_torch.ops import (
    area_query,
    close_lists,
    extents,
    helmholtz2d,
    helmholtz3d,
    kernels,
    laplace2d,
    laplace3d,
    morton,
    peers,
    restrict,
)
from boxtree_torch.ops import traversal as tops
from boxtree_torch.ops import translate as tops_translate
from boxtree_torch.ops import tree as tree_ops
from boxtree_torch.traversal import build_traversal
from boxtree_torch.traversal.build import close_list_inputs, list_inputs
from boxtree_torch.traversal.neighbors import _offsets
from boxtree_torch.tree.build import _phase_a, _root_box
from boxtree_torch.tree.level_restrict import restrict_leaf_levels

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _sphere(n, seed=11):
    x = np.random.default_rng(seed).standard_normal((3, n))
    return x / np.sqrt((x * x).sum(0))


def _rel(got, ref):
    if not ref.is_complex():
        got, ref = got.double(), ref.double()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _cols_rel(got, ref):
    """Worst column of (boxes, coefficients) expansions, each held to its
    own largest ``|ref|``: the columns span many decades."""
    scale = ref.abs().amax(0)
    assert (scale > 0).all()
    return ((got - ref).abs().amax(0) / scale).max().item()


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def setup(request, device):
    dt = request.param
    n = 20000
    pts = torch.as_tensor(_sphere(n), dtype=dt, device=device)
    q = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                        dtype=dt, device=device)
    tree = build_tree(pts, max_particles_in_box=30)
    trav = build_traversal(tree)
    w = make_laplace_wrangler(trav, order=6, pairs=True, rscale="auto",
                              dtype=dt)
    return dt, tree, trav, w, w.reorder_sources(q), pts, q


def test_morton_encode_bit_exact(setup):
    dt, tree = setup[:2]
    coords = tree.sources
    lo = torch.amin(coords, dim=1)
    extent = torch.max(torch.amax(coords, dim=1) - lo) * 1.0001
    for iota_bits in (None, 15):
        got = morton.encode_points(coords, lo, extent, 16, iota_bits)
        ref = morton.encode_points_plain(coords, lo, extent, 16, iota_bits)
        assert torch.equal(got, ref)


def test_p2p_kernel(setup):
    dt, tree, trav, w, q = setup[:5]
    args = (w._targets, w._sources, q, tree.box_target_starts,
            tree.box_target_counts_nonchild, tree.box_source_starts,
            tree.box_source_counts_nonchild, trav.target_boxes,
            trav.neighbor_source_boxes_starts,
            trav.neighbor_source_boxes_lists)
    assert _rel(laplace3d.p2p_laplace3d(*args),
                laplace3d.p2p_laplace3d_plain(*args)) <= RTOL[dt]


def test_m2p_kernel(setup):
    dt, tree, trav, w, q = setup[:5]
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                            [q]))
    args = (w._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, *w._l3_csr, mp, w.centers,
            w.box_scale, w.order)
    assert w._l3_csr[0].numel() > 0
    assert _rel(laplace3d.m2p_laplace3d(*args),
                laplace3d.m2p_laplace3d_plain(*args)) <= RTOL[dt]


def test_p2l_kernel(setup):
    dt, tree, trav, w, q = setup[:5]
    args = (w._sources, q, tree.box_source_starts,
            tree.box_source_counts_nonchild, *w._l4_csr, w.centers,
            w.box_scale, w.order)
    assert w._l4_csr[0].numel() > 0
    got = laplace3d.p2l_laplace3d(*args, w.local_expansion_zeros())
    ref = laplace3d.p2l_laplace3d_plain(*args, w.local_expansion_zeros())
    assert _rel(got, ref) <= RTOL[dt]


def test_fmm_on_card_matches_cpu(setup):
    dt, tree, trav, w, _, pts, q = setup
    if dt != torch.float64:
        pytest.skip("compared in float64")
    kernels.reset_launch_counts()
    got = drive_fmm(w, [q])
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("p2p_laplace3d", "m2p_laplace3d",
                                       "p2l_laplace3d"))
    assert counts["p2m_laplace3d"] == counts["l2p_laplace3d"] == 1
    trav_cpu = build_traversal(build_tree(pts.cpu(),
                                          max_particles_in_box=30))
    w_cpu = make_laplace_wrangler(trav_cpu, order=6, pairs=True,
                                  rscale="auto", dtype=torch.float64)
    ref = drive_fmm(w_cpu, [q.cpu()])
    assert _rel(got.cpu(), ref) <= 1e-11


def test_counting_fmm_on_card(device):
    pts = torch.as_tensor(np.random.default_rng(17).random(
        (3, 100000), dtype=np.float32), device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    pot = drive_fmm(ConstantOneExpansionWrangler(None, trav),
                    [torch.ones(100000, dtype=torch.float64, device=device)])
    assert torch.equal(pot, torch.full_like(pot, 100000))


# {{{ K5-K8 on a level-restricted tree

def _capped_sphere(n, seed=3):
    """Points on the unit sphere, a tenth of them in a small cap, so that
    the restriction has work to do."""
    ncap = n // 10
    base = _sphere(n - ncap, seed)
    cap = (np.full((3, 1), 3 ** -0.5)
           + 0.01 * np.random.default_rng(seed).standard_normal((3, ncap)))
    return np.concatenate([base, cap / np.sqrt((cap * cap).sum(0))], axis=1)


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def geometry(request, device):
    dt = request.param
    n = 20000
    pts = torch.as_tensor(_capped_sphere(n), dtype=dt, device=device)
    tree = build_tree(pts, kind="adaptive-level-restricted",
                      max_particles_in_box=30)
    rng = np.random.default_rng(7)
    anchor = torch.as_tensor(rng.choice(n, 2000, replace=False),
                             device=device)
    radii = torch.as_tensor(rng.uniform(0.005, 0.05, 2000), dtype=dt,
                            device=device)
    return dt, pts, tree, pts[:, anchor] * (1 + radii), radii


def test_restrict_demand_kernel(geometry):
    _, pts, *_ = geometry
    n = pts.shape[1]
    iota_bits = max(1, int(n - 1).bit_length())
    depth = (63 - iota_bits) // 3
    codes_s, _, leaf, counts, n_unfit, _, _ = _phase_a(
        pts, 30, dimensions=3, depth=depth)
    assert n_unfit == 0
    max_level = int(torch.nonzero(counts)[-1, 0])
    for m in range(max_level, 1, -1):
        got = restrict.demand_pass(codes_s, leaf, m=m, dimensions=3,
                                   depth=depth)
        ref = restrict.demand_pass_plain(codes_s, leaf, m=m, dimensions=3,
                                         depth=depth)
        assert torch.equal(got, ref), m
        leaf = ref
    got = restrict_leaf_levels(codes_s, leaf, dimensions=3, depth=depth,
                               max_level=max_level)
    ref = restrict_leaf_levels(codes_s, leaf, dimensions=3, depth=depth,
                               max_level=max_level, plain=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[2] == ref[2]


def test_restricted_tree_on_card_matches_cpu(geometry):
    _, pts, tree = geometry[:3]
    ref = build_tree(pts.cpu(), kind="adaptive-level-restricted",
                     max_particles_in_box=30)
    assert tree.level_start_box_nrs == ref.level_start_box_nrs
    for name in ("box_morton_prefixes", "box_levels", "box_parent_ids",
                 "box_child_ids", "box_flags", "box_centers",
                 "user_source_ids", "box_source_starts",
                 "box_source_counts_cumul", "box_source_counts_nonchild"):
        assert torch.equal(getattr(tree, name).cpu(), getattr(ref, name)), \
            name


def test_area_query_kernel(geometry):
    _, _, tree, centers, radii = geometry
    got = area_query.ball_leaf_keys(tree, centers, radii)
    ref = area_query.ball_leaf_keys(tree, centers, radii, plain=True)
    assert ref.shape[0] > centers.shape[1]
    assert torch.equal(got, ref)


def test_space_invader_kernel(geometry):
    _, _, tree, centers, radii = geometry
    got = area_query.space_invader(tree, centers, radii)
    ref = area_query.space_invader_plain(tree, centers, radii)
    assert float(ref.max()) > 0
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_peer_lists_kernel(geometry):
    tree = geometry[2]
    args = (tree.box_morton_prefixes, tree.box_flags)
    kw = dict(dimensions=3, lsb=tree.level_start_box_nrs)
    got = peers.peer_lists(*args, **kw)
    ref = peers.peer_lists_plain(*args, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_config_b_path_launches_k5_to_k8(geometry):
    _, pts, _, centers, radii = geometry
    kernels.reset_launch_counts()
    tree = build_tree(pts, kind="adaptive-level-restricted",
                      max_particles_in_box=30)
    AreaQueryBuilder()(tree, centers, radii)
    LeavesToBallsLookupBuilder()(tree, centers, radii)
    SpaceInvaderQueryBuilder()(tree, centers, radii)
    PeerListFinder()(tree)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in (
        "morton_encode", "restrict_demand", "area_query_sweep",
        "space_invader_sweep", "peer_lists")), counts

# }}}


# {{{ K9-K11: the Helmholtz FMM

HELM_RTOL = 1e-10


@pytest.fixture(scope="module")
def helmholtz(device):
    n = 20000
    pts = torch.as_tensor(_sphere(n), device=device)
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n),
                        device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    w = make_helmholtz_wrangler(trav, 2.0, 12, rscale="auto",
                                pairs=False)
    return trav, w, w.reorder_sources(q), pts, q


def test_build_tree_numpy_lands_on_card(device):
    tree = build_tree(_sphere(1000), max_particles_in_box=30)
    assert tree.sources.device.type == "cuda"


def test_p2p_helmholtz_kernel(helmholtz):
    trav, w, q = helmholtz[:3]
    tree = trav.tree
    args = (w._targets, w._sources, q, tree.box_target_starts,
            tree.box_target_counts_nonchild, tree.box_source_starts,
            tree.box_source_counts_nonchild, trav.target_boxes,
            trav.neighbor_source_boxes_starts,
            trav.neighbor_source_boxes_lists, w.k)
    assert _rel(helmholtz3d.p2p_helmholtz3d(*args),
                helmholtz3d.p2p_helmholtz3d_plain(*args)) <= HELM_RTOL


def test_m2p_helmholtz_kernel(helmholtz):
    trav, w, q = helmholtz[:3]
    tree = trav.tree
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                            [q]))
    args = (w._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, *w._l3_csr, mp, w.centers,
            w.box_scale, w.k, w.order)
    assert w._l3_csr[0].numel() > 0
    assert _rel(helmholtz3d.m2p_helmholtz3d(*args),
                helmholtz3d.m2p_helmholtz3d_plain(*args)) <= HELM_RTOL


def test_p2l_helmholtz_kernel(helmholtz):
    trav, w, q = helmholtz[:3]
    tree = trav.tree
    args = (w._sources, q, tree.box_source_starts,
            tree.box_source_counts_nonchild, *w._l4_csr, w.centers,
            w.box_scale, w._w_nm, w.k, w.order)
    assert w._l4_csr[0].numel() > 0
    got = helmholtz3d.p2l_helmholtz3d(*args, w.local_expansion_zeros())
    ref = helmholtz3d.p2l_helmholtz3d_plain(*args,
                                            w.local_expansion_zeros())
    assert _cols_rel(got, ref) <= HELM_RTOL


def test_helmholtz_fmm_on_card_matches_cpu(helmholtz):
    trav, w, _, pts, q = helmholtz
    kernels.reset_launch_counts()
    got = drive_fmm(w, [q])
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("p2p_helmholtz3d", "m2p_helmholtz3d",
                                       "p2l_helmholtz3d")), counts
    assert counts["p2m_helmholtz3d"] == counts["l2p_helmholtz3d"] == 1
    trav_cpu = build_traversal(build_tree(pts.cpu(),
                                          max_particles_in_box=30))
    w_cpu = make_helmholtz_wrangler(trav_cpu, 2.0, 12, rscale="auto",
                                    pairs=False)
    ref = drive_fmm(w_cpu, [q.cpu()])
    assert got.dtype == torch.complex128
    assert _rel(got.cpu(), ref) <= HELM_RTOL

# }}}


# {{{ K12-K15: trees with extents and the close lists

def _qbx_inputs(n, ncenters, dims, seed=5):
    """Points on the unit sphere (circle) and QBX-like centres: sampled
    points pushed out along the normal by their radius, radii uniform in
    [0.005, 0.02]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((dims, n))
    x /= np.sqrt((x * x).sum(0))
    radii = rng.uniform(0.005, 0.02, ncenters)
    anchor = rng.choice(n, ncenters, replace=False)
    return x, x[:, anchor] * (1 + radii), radii


@pytest.fixture(scope="module", params=[(3, "linf", torch.float64),
                                        (3, "linf", torch.float32),
                                        (2, "l2", torch.float64)],
                ids=["3d_linf_f64", "3d_linf_f32", "2d_l2_f64"])
def extent(request, device):
    dims, norm, dt = request.param
    src, centres, radii = _qbx_inputs(20000, 2000, dims)
    kw = dict(target_radii=torch.as_tensor(radii, dtype=dt),
              stick_out_factor=0.25, extent_norm=norm,
              max_particles_in_box=30)
    src, centres = (torch.as_tensor(a, dtype=dt) for a in (src, centres))
    kernels.reset_launch_counts()
    tree = build_tree(src.to(device), targets=centres.to(device), **kw)
    trav = build_traversal(tree)
    launches = kernels.launch_counts()
    ref_tree = build_tree(src, targets=centres, **kw)
    return tree, trav, ref_tree, launches


def test_extent_tree_on_card_matches_cpu(extent):
    tree, _, ref, _ = extent
    assert tree.level_start_box_nrs == ref.level_start_box_nrs
    assert ((ref.box_flags & 16) == 0).logical_and(
        ref.box_target_counts_nonchild > 0).any()
    for f in dataclasses.fields(ref):
        val, want = getattr(tree, f.name), getattr(ref, f.name)
        if isinstance(want, torch.Tensor):
            assert torch.equal(val.cpu(), want), f.name
        else:
            assert val == want, f.name


def test_stick_levels_kernel(extent):
    tree = extent[0]
    coords = torch.cat([tree.sources, tree.targets], dim=1)
    radii = torch.cat([torch.zeros_like(tree.sources[0]), tree.target_radii])
    lo, extent_ = _root_box(coords, radii)
    kw = dict(dimensions=tree.dimensions, depth=tree.max_depth,
              extent_norm=tree.extent_norm, stick_out_factor=0.25)
    got = extents.stick_levels(coords, radii, lo, extent_, **kw)
    ref = extents.stick_levels_plain(coords, radii, lo, extent_, **kw)
    assert torch.equal(got, ref)
    assert len(torch.unique(ref)) > 2


@pytest.mark.parametrize("what", ["source", "target"])
def test_box_extents_kernel(extent, what):
    tree = extent[0]
    args = (getattr(tree, f"{what}s"), getattr(tree, f"{what}_radii"),
            getattr(tree, f"box_{what}_starts"),
            getattr(tree, f"box_{what}_counts_nonchild"), tree.box_centers,
            tree.box_child_ids)
    lsb = tree.level_start_box_nrs
    got = extents.box_extents(*args, lsb=lsb)
    ref = extents.box_extents_plain(*args, lsb=lsb)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_list4_ext_kernel(extent):
    (args, kw), _ = close_list_inputs(extent[0])
    got = close_lists.list4_ext(*args, **kw)
    ref = close_lists.list4_ext_plain(*args, **kw)
    assert ref[1].shape[0] > 0 and ref[3].shape[0] > 0
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("crit,min_nsources", [
    ("precise_linf", 0), ("static_linf", 0), ("static_l2", 0),
    ("precise_linf", 30)])
def test_list3_ext_kernel(extent, crit, min_nsources):
    _, (args, kw) = close_list_inputs(extent[0])
    kw = dict(kw, crit=crit, min_nsources=min_nsources)
    far, close = close_lists.list3_ext(*args, **kw)
    far_ref, close_ref = close_lists.list3_ext_plain(*args, **kw)
    assert sum(f.shape[0] for f in far_ref) > 0 and close_ref.shape[0] > 0
    assert len(far) == len(far_ref)
    assert all(torch.equal(g, r) for g, r in zip(far, far_ref))
    assert torch.equal(close, close_ref)


def test_extent_traversal_on_card_matches_cpu(extent):
    _, trav, ref_tree, _ = extent
    ref = build_traversal(ref_tree)
    for f in dataclasses.fields(ref):
        if f.name == "tree":
            continue
        val, want = getattr(trav, f.name), getattr(ref, f.name)
        if f.name == "from_sep_smaller_by_level":
            for a, b in zip(val, want):
                assert a.count == b.count
                for part in ("starts", "lists", "nonempty_indices"):
                    assert torch.equal(getattr(a, part).cpu(),
                                       getattr(b, part)), f.name
        elif f.name == "target_boxes_sep_smaller_by_source_level":
            assert all(torch.equal(a.cpu(), b) for a, b in zip(val, want))
        elif isinstance(want, torch.Tensor):
            assert torch.equal(val.cpu(), want), f.name
        else:
            assert val == want, f.name


def test_extent_path_launches_k12_to_k15(extent):
    launches = extent[3]
    assert all(launches[k] > 0 for k in (
        "morton_encode", "stick_levels", "box_extents", "list4_ext",
        "list3_ext")), launches


def test_extent_counting_fmm_on_card(extent):
    trav = extent[1]
    n = trav.tree.nsources
    ones = [torch.ones(n, dtype=torch.float64, device=trav.tree.sources.device)]
    for t in (trav, trav.merge_close_lists()):
        pot = drive_fmm(ConstantOneExpansionWrangler(None, t), ones)
        assert torch.equal(pot, torch.full_like(pot, n))

# }}}


# {{{ K16-K18: the 2D Helmholtz FMM

H2D_RTOL = 1e-12


def _clustered_2d(n, seed=23):
    rng = np.random.default_rng(seed)
    pts = rng.random((2, n))
    m = n * 400 // 1500
    pts[:, :m] = 0.1 * rng.random((2, m)) + 0.4
    return pts


@pytest.fixture(scope="module")
def helmholtz2d_setup(device):
    n = 20000
    pts = torch.as_tensor(_clustered_2d(n), device=device)
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n),
                        device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    w = make_helmholtz_wrangler(trav, 3.0, 16, rscale="auto",
                                pairs=False)
    return trav, w, w.reorder_sources(q), pts, q


def _h2d_args(trav, w, q, which, targets=None, sources=None):
    tree = trav.tree
    tgt = w._targets if targets is None else targets
    src = w._sources if sources is None else sources
    if which == "p2p":
        return (tgt, src, q, tree.box_target_starts,
                tree.box_target_counts_nonchild, tree.box_source_starts,
                tree.box_source_counts_nonchild, trav.target_boxes,
                trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists, w.k, w._nstart)
    if which == "m2p":
        mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                                [q]))
        return (tgt, tree.box_target_starts,
                tree.box_target_counts_nonchild, *w._l3_csr, mp, w.centers,
                w.box_scale, w.k, w.order, w._nstart)
    return (src, q, tree.box_source_starts, tree.box_source_counts_nonchild,
            *w._l4_csr, w.centers, w.box_scale, w.k, w.order, w._nstart)


def _h2d_compare(which, args, w):
    fn = getattr(helmholtz2d, f"{which}_helmholtz2d")
    plain = getattr(helmholtz2d, f"{which}_helmholtz2d_plain")
    if which == "p2l":
        got = fn(*args, w.local_expansion_zeros())
        ref = plain(*args, w.local_expansion_zeros())
        return _cols_rel(got, ref)
    return _rel(fn(*args), plain(*args))


@pytest.mark.parametrize("which", ["p2p", "m2p", "p2l"])
def test_helmholtz2d_kernel(helmholtz2d_setup, which):
    trav, w, q = helmholtz2d_setup[:3]
    assert w._l3_csr[0].numel() > 0 and w._l4_csr[0].numel() > 0
    assert _h2d_compare(which, _h2d_args(trav, w, q, which), w) <= H2D_RTOL


@pytest.mark.parametrize("which", ["p2p", "m2p", "p2l"])
def test_helmholtz2d_kernel_edges(helmholtz2d_setup, which):
    """Particles moved onto the centre of a box they interact with (r = 0:
    masked) and to 1e-10 from it (k r below the series switch), and, for
    P2P, sources moved onto targets."""
    trav, w, q = helmholtz2d_setup[:3]
    tree = trav.tree
    pts = w._sources.clone()
    centers = w.centers.cpu()
    if which == "p2p":
        # the second particle of the first 200 target boxes onto the first
        tb = trav.target_boxes[:200].to(torch.int64)
        first = tree.box_target_starts[tb].to(torch.int64)
        two = tree.box_target_counts_nonchild[tb] >= 2
        pts[:, first[two] + 1] = pts[:, first[two]]
        near = pts[:, first[two]].clone()
        near[0] += 1e-10
        pts[:, first[two] + 2] = near
        args = _h2d_args(trav, w, q, which, targets=pts, sources=pts)
    else:
        rows, starts, lists = (t.cpu().to(torch.int64) for t in (
            w._l3_csr if which == "m2p" else w._l4_csr))
        # M2P: a target of the row's box onto the centre of its first
        # listed source box; P2L: a source of the first listed box onto
        # the centre of the row's (target) box
        n = min(200, rows.shape[0])
        lst = lists[starts[:n]]
        if which == "m2p":
            moved = tree.box_target_starts.cpu()[rows[:n]].to(torch.int64)
            ctr = centers[:, lst]
        else:
            moved = tree.box_source_starts.cpu()[lst].to(torch.int64)
            ctr = centers[:, rows[:n]]
        pts[:, moved] = ctr.to(pts.device)
        near = ctr.clone()
        near[0] += 1e-10
        counts = (tree.box_target_counts_nonchild if which == "m2p"
                  else tree.box_source_counts_nonchild).cpu()
        box = rows[:n] if which == "m2p" else lst
        two = counts[box] >= 2
        pts[:, moved[two] + 1] = near[:, two].to(pts.device)
        args = _h2d_args(trav, w, q, which, targets=pts, sources=pts)
    assert _h2d_compare(which, args, w) <= H2D_RTOL


@pytest.mark.parametrize("order,k", [(24, 3.0), (16, 20.0)])
def test_helmholtz2d_kernel_large_smem(device, order, k):
    """K17/K18 at the settings that took them past the default 48 KiB of
    shared memory a CTA while their recurrence scratch lived there: order
    24 at k = 3, and order 16 at k = 20 (a recurrence from 338), on the
    unit square.  Their tables now stay under it, the ratios going to
    global scratch."""
    n = 5000
    pts = torch.as_tensor(_clustered_2d(n, seed=5), device=device)
    rng = np.random.default_rng(6)
    q = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n),
                        device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    w = make_helmholtz_wrangler(trav, k, order, rscale="auto",
                                pairs=False)
    assert max(helmholtz2d.smem_bytes(name, order)
               for name in ("m2p", "p2l")) < 48 * 1024
    tq = w.reorder_sources(q)
    for which in ("m2p", "p2l"):
        args = _h2d_args(trav, w, tq, which)
        assert _h2d_compare(which, args, w) <= H2D_RTOL, which


def test_helmholtz2d_wrangler_past_old_smem_limit(device):
    """Order 16 at k = 200 on the unit square (a recurrence from 954, past
    the 227 KiB a CTA that K17/K18's shared scratch once needed) builds a
    wrangler on the card, and K17, K18, K33 and K34 match their twins
    there, per coefficient column."""
    n = 3000
    pts = torch.as_tensor(_clustered_2d(n, seed=8), device=device)
    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n),
                        device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    w = make_helmholtz_wrangler(trav, 200.0, 16, rscale="auto",
                                pairs=False)
    from boxtree_torch.ops.cylinder_bessel import even_start
    assert even_start(w._nstart, 16) == 954
    tq = w.reorder_sources(q)
    assert w._l3_csr[0].numel() > 0 and w._l4_csr[0].numel() > 0
    for which in ("m2p", "p2l"):
        args = _h2d_args(trav, w, tq, which)
        assert _h2d_compare(which, args, w) <= H2D_RTOL, which
    for which in ("p2m", "l2p"):
        args = _helm_p2m_l2p_args(w, tq, which, _random_locals(w))
        assert _helm_p2m_l2p_compare(2, which, args) <= H2D_RTOL, which


def test_helmholtz2d_fmm_on_card_matches_cpu(helmholtz2d_setup):
    trav, w, _, pts, q = helmholtz2d_setup
    kernels.reset_launch_counts()
    got = drive_fmm(w, [q])
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("p2p_helmholtz2d", "m2p_helmholtz2d",
                                       "p2l_helmholtz2d")), counts
    assert counts["p2m_helmholtz2d"] == counts["l2p_helmholtz2d"] == 1
    trav_cpu = build_traversal(build_tree(pts.cpu(),
                                          max_particles_in_box=30))
    w_cpu = make_helmholtz_wrangler(trav_cpu, 3.0, 16, rscale="auto",
                                    pairs=False)
    ref = drive_fmm(w_cpu, [q.cpu()])
    assert got.dtype == torch.complex128
    assert _rel(got.cpu(), ref) <= HELM_RTOL

# }}}


# {{{ K19-K21: the 2D Laplace FMM

#: K19-K21 against their twins: complex128 and float64 pairs (logs and
#: powers in another rounding, FMA contraction, sums in another order), and
#: float32 pairs
L2D_RTOL = {torch.complex128: 1e-12, torch.float64: 1e-12,
            torch.float32: 1e-5}
L2D_KINDS = {"c128": (False, torch.complex128),
             "f64": (True, torch.float64), "f32": (True, torch.float32)}


def _clustered_laplace(n, seed=20):
    """``tests/test_laplace.py:27-31``'s points at *n*."""
    rng = np.random.default_rng(seed)
    pts = rng.random((2, n))
    m = n * 600 // 2500
    pts[:, :m] = 0.1 * rng.random((2, m)) + 0.45
    return pts


def _zero_safe_cols_rel(got, ref):
    """:func:`_cols_rel`, with a column that is zero in the reference held
    to zero."""
    scale = ref.abs().amax(0)
    err = (got - ref).abs().amax(0)
    assert (err[scale == 0] == 0).all()
    return (err[scale > 0] / scale[scale > 0]).max().item()


@pytest.fixture(scope="module")
def laplace2d_setup(device):
    n = 20000
    pts = torch.as_tensor(_clustered_laplace(n), device=device)
    rng = np.random.default_rng(2)
    qc = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n),
                         device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=20))
    ws = {kind: make_laplace_wrangler(trav, 20, pairs=pairs, dtype=dt,
                                      rscale="auto")
          for kind, (pairs, dt) in L2D_KINDS.items()}
    return trav, ws, pts, qc


def _l2d_args(trav, w, q, which, pts=None, centers=None):
    """K19-K21's arguments from wrangler *w* (charges *q* in its dtype),
    with the particles (tree order) and box centres replaced if given."""
    tree = trav.tree
    pts = w._sources if pts is None else pts.to(w.real_dtype)
    centers = w.centers if centers is None else centers.to(w.real_dtype)
    if which == "p2p":
        return (pts, pts, q, tree.box_target_starts,
                tree.box_target_counts_nonchild, tree.box_source_starts,
                tree.box_source_counts_nonchild, trav.target_boxes,
                trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists)
    if which == "m2p":
        mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                                [q]))
        return (pts, tree.box_target_starts,
                tree.box_target_counts_nonchild, *w._l3_csr, mp, centers,
                w.box_scale, w.order)
    return (pts, q, tree.box_source_starts, tree.box_source_counts_nonchild,
            *w._l4_csr, centers, w.box_scale, w.order)


def _l2d_compare(which, args, w):
    fn = getattr(laplace2d, f"{which}_laplace2d")
    plain = getattr(laplace2d, f"{which}_laplace2d_plain")
    if which == "p2l":
        got = fn(*args, w.local_expansion_zeros())
        ref = plain(*args, w.local_expansion_zeros())
        return _zero_safe_cols_rel(got, ref)
    return _rel(fn(*args), plain(*args))


def _l2d_charges(w, qc):
    """Complex charges for the complex wrangler, their real part for the
    pairs."""
    return w.reorder_sources(qc if w.dtype.is_complex else qc.real)


@pytest.mark.parametrize("which", ["p2p", "m2p", "p2l"])
@pytest.mark.parametrize("kind", sorted(L2D_KINDS))
def test_laplace2d_kernel(laplace2d_setup, kind, which):
    trav, ws, _, qc = laplace2d_setup
    w = ws[kind]
    assert w._l3_csr[0].numel() > 0 and w._l4_csr[0].numel() > 0
    err = _l2d_compare(which, _l2d_args(trav, w, _l2d_charges(w, qc),
                                        which), w)
    assert err <= L2D_RTOL[w.dtype]


@pytest.mark.parametrize("which", ["p2p", "m2p", "p2l"])
@pytest.mark.parametrize("kind", sorted(L2D_KINDS))
def test_laplace2d_kernel_edges(laplace2d_setup, kind, which):
    """Edges, with the twins' reference semantics: P2P with sources moved
    onto targets (r = 0); M2P with targets moved onto the centre of their
    row's first listed box (w = 0: the complex form takes w = 1, the pairs
    1/w = 0) and onto its horizontal centre line on either side (+-pi); P2L
    the same with sources and the row's box; and on boxes whose centre y is
    set to +0.0 with particles at y = -0.0 (the complex form holds the
    offset's -0.0 as +0.0, the pairs keep it)."""
    trav, ws, pts0, qc = laplace2d_setup
    w = ws[kind]
    tree = trav.tree
    q = _l2d_charges(w, qc)
    pts = w._sources.to(torch.float64).clone()
    centers = w.centers.to(torch.float64).clone()
    if which == "p2p":
        tb = trav.target_boxes[:200].to(torch.int64)
        first = tree.box_target_starts[tb].to(torch.int64)
        two = tree.box_target_counts_nonchild[tb] >= 2
        pts[:, first[two] + 1] = pts[:, first[two]]
    else:
        rows, starts, lists = (t.to(torch.int64) for t in (
            w._l3_csr if which == "m2p" else w._l4_csr))
        n = min(300, rows.shape[0])
        lst = lists[starts[:n]]
        part = "target" if which == "m2p" else "source"
        # the particle box and the centre box of each row's first entry
        pbox, cbox = (rows[:n], lst) if which == "m2p" else (lst, rows[:n])
        first = getattr(tree, f"box_{part}_starts")[pbox].to(torch.int64)
        count = getattr(tree, f"box_{part}_counts_nonchild")[pbox]
        ctr = centers[:, cbox]
        s = w.box_scale[cbox].to(torch.float64)
        # a third each: on the centre, left of it, right of it
        third = torch.arange(n, device=pts.device) % 3
        dx = torch.where(third == 1, -0.75 * s, 0.75 * s)
        dx = torch.where(third == 0, torch.zeros_like(dx), dx)
        pts[0, first] = ctr[0] + dx
        pts[1, first] = ctr[1]
        # the second particle of the first 30 rows at y = -0.0, their
        # centres' y at +0.0
        sel = (count[:30] >= 2).nonzero()[:, 0]
        centers[1, cbox[sel]] = 0.0
        pts[1, first[sel] + 1] = -0.0
        pts[0, first[sel] + 1] = ctr[0, sel] + torch.where(
            third[sel] == 1, -0.5, 0.5) * s[sel]
    args = _l2d_args(trav, w, q, which, pts=pts, centers=centers)
    assert _l2d_compare(which, args, w) <= L2D_RTOL[w.dtype]


@pytest.mark.parametrize("which", ["p2p", "m2p", "p2l"])
@pytest.mark.parametrize("kind", sorted(L2D_KINDS))
def test_laplace2d_kernel_empty_rows(laplace2d_setup, kind, which):
    """Rows with no entries (every other row emptied) leave their targets
    at zero, or their coefficients as they were; no entries at all
    launch nothing."""
    trav, ws, _, qc = laplace2d_setup
    w = ws[kind]
    q = _l2d_charges(w, qc)
    args = list(_l2d_args(trav, w, q, which))
    i = {"p2p": 8, "m2p": 4, "p2l": 5}[which]            # the CSR starts
    starts, lists = args[i].to(torch.int64), args[i + 1].to(torch.int64)
    counts = starts[1:] - starts[:-1]
    keep_row = torch.arange(counts.shape[0], device=counts.device) % 2 == 0
    keep = torch.repeat_interleave(keep_row, counts)
    new_starts = torch.zeros_like(starts)
    new_starts[1:] = torch.cumsum(torch.where(keep_row, counts, 0), 0)
    args[i], args[i + 1] = (new_starts.to(torch.int32),
                            lists[keep].to(torch.int32))
    assert _l2d_compare(which, tuple(args), w) <= L2D_RTOL[w.dtype]
    args[i] = torch.zeros_like(args[i])
    args[i + 1] = args[i + 1][:0]
    kernels.reset_launch_counts()
    fn = getattr(laplace2d, f"{which}_laplace2d")
    out = (fn(*args, w.local_expansion_zeros()) if which == "p2l"
           else fn(*args))
    assert not out.abs().any()
    assert kernels.launch_counts()[f"{which}_laplace2d"] == 0


def test_laplace2d_order35_on_card(device):
    """``tests/test_stability.py:28-65``'s line at order 35 on the card:
    K20/K21 (19,008 B of scratch a CTA) against their twins on it, and
    both wranglers' FMM against the CPU port and (1/2)^36 of the direct
    sum."""
    line = np.array([2.0 ** -i for i in range(15)])
    line = np.hstack([line, 3 - line])
    sources = np.vstack([line, np.zeros(30)])
    targets = sources * (1 + 1e-3)
    d = sources[:, None, :] - targets[:, :, None]
    ref = torch.as_tensor(0.5 * np.log((d * d).sum(0)) @ np.ones(30))
    ones = torch.ones(30, dtype=torch.float64, device=device)
    for pairs in (False, True):
        got = {}
        for dev in (device, torch.device("cpu")):
            tree = build_tree(sources, targets=targets,
                              max_particles_in_box=2, device=dev)
            assert tree.nlevels >= 15
            trav = build_traversal(tree)
            w = make_laplace_wrangler(trav, 35, pairs=pairs, rscale="auto")
            got[dev.type] = drive_fmm(w, [ones.to(dev)]).cpu()
            if dev.type == "cuda":
                q = w.reorder_sources(ones)
                for which in ("m2p", "p2l"):
                    if (w._l3_csr if which == "m2p" else w._l4_csr) is None:
                        continue
                    assert _l2d_compare(which, _l2d_args(trav, w, q, which),
                                        w) <= 1e-12, (pairs, which)
        assert _rel(got["cuda"], got["cpu"]) <= 1e-12
        assert not got["cuda"].real.isnan().any()
        assert _rel(got["cuda"].real, ref) < 0.5 ** 36


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float16])
def test_laplace2d_wrappers_refuse_dtypes(laplace2d_setup, dtype):
    """A CUDA tensor of a dtype the kernels lack raises TypeError, before
    any launch."""
    trav, ws, _, qc = laplace2d_setup
    w = ws["c128" if dtype.is_complex else "f32"]
    q = _l2d_charges(w, qc)
    kernels.reset_launch_counts()
    for which in ("p2p", "m2p", "p2l"):
        args = list(_l2d_args(trav, w, q, which))
        if which == "p2p":
            args[2] = args[2].to(dtype)
        elif which == "m2p":
            args[6] = args[6].to(dtype)
        fn = getattr(laplace2d, f"{which}_laplace2d")
        with pytest.raises(TypeError):
            if which == "p2l":
                fn(*args, w.local_expansion_zeros().to(dtype))
            else:
                fn(*args)
    assert not any(kernels.launch_counts()[f"{x}_laplace2d"]
                   for x in ("p2p", "m2p", "p2l"))


@pytest.mark.parametrize("kind", sorted(L2D_KINDS))
def test_laplace2d_fmm_on_card_matches_cpu(laplace2d_setup, kind):
    trav, ws, pts, qc = laplace2d_setup
    w = ws[kind]
    q = qc if w.dtype.is_complex else qc.real
    kernels.reset_launch_counts()
    got = drive_fmm(w, [q])
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("p2p_laplace2d", "m2p_laplace2d",
                                       "p2l_laplace2d")), counts
    trav_cpu = build_traversal(build_tree(pts.cpu(),
                                          max_particles_in_box=20))
    pairs, dt = L2D_KINDS[kind]
    w_cpu = make_laplace_wrangler(trav_cpu, 20, pairs=pairs, dtype=dt,
                                  rscale="auto")
    ref = drive_fmm(w_cpu, [q.cpu()])
    assert got.dtype == dt
    assert _rel(got.cpu(), ref) <= (1e-5 if dt == torch.float32 else 1e-10)

# }}}


# {{{ K38-K42: 2D Laplace P2M and L2P, and the dipole P2M, P2P and P2L

L2D_PARTICLE = {"p2m": "p2m_laplace2d", "p2m_dipole": "p2m_laplace2d_dipole",
                "l2p": "l2p_laplace2d", "p2p_dipole": "p2p_laplace2d_dipole",
                "p2l_dipole": "p2l_laplace2d_dipole"}


def _starfish(n, seed):
    """*n* points on ``r(theta) = 1 + 0.25 cos 5 theta`` at uniform random
    angles, and their unit outward normals."""
    th = np.random.default_rng(seed).uniform(0, 2 * np.pi, n)
    r, dr = 1 + 0.25 * np.cos(5 * th), -1.25 * np.sin(5 * th)
    tx = dr * np.cos(th) - r * np.sin(th)
    ty = dr * np.sin(th) + r * np.cos(th)
    nrm = np.stack([ty, -tx]) / np.hypot(tx, ty)
    return np.stack([r * np.cos(th), r * np.sin(th)]), nrm


@pytest.fixture(scope="module")
def laplace2d_dipoles(device, laplace2d_setup):
    """Per tree and kind, a 2D Laplace wrangler with dipoles at order 20,
    ``rscale="auto"``: ``"starfish"``, 2e4 sources on the five-armed
    starfish with their normals and 5,000 separate targets in [-1.5,
    1.5]^2; ``"clustered"``, ``laplace2d_setup``'s tree (sources =
    targets) with standard-normal dipoles.  Also the complex charges."""
    src, nrm = _starfish(20000, 24)
    tgt = np.random.default_rng(25).uniform(-1.5, 1.5, (2, 5000))
    trav_s = build_traversal(build_tree(
        torch.as_tensor(src, device=device),
        targets=torch.as_tensor(tgt, device=device),
        max_particles_in_box=20))
    trav_c, _, pts, qc = laplace2d_setup
    dip_c = np.random.default_rng(26).standard_normal(tuple(pts.shape))
    rng = np.random.default_rng(27)
    qs = torch.as_tensor(rng.standard_normal(20000)
                         + 1j * rng.standard_normal(20000), device=device)
    out = {"starfish_inputs": (src, tgt, nrm)}
    for tree, trav, dip, q in (("starfish", trav_s, nrm, qs),
                               ("clustered", trav_c, dip_c, qc)):
        for kind, (pairs, dt) in L2D_KINDS.items():
            out[tree, kind] = (make_laplace_wrangler(
                trav, 20, pairs=pairs, dtype=dt, rscale="auto",
                dipole_vec=torch.as_tensor(dip, device=device)), q)
    return out


def _l2d_particle_args(w, q, which, sources=None, targets=None,
                       centers=None, local_exps=None):
    """K38-K42's arguments from wrangler *w* (tree-order charges *q*), the
    particles and box centres replaced if given."""
    tree, trav = w.tree, w.traversal
    src = w._sources if sources is None else sources
    tgt = w._targets if targets is None else targets
    centers = w.centers if centers is None else centers
    dip = (w.dipole_vec,) if which.endswith("dipole") else ()
    if which == "l2p":
        return (tgt, tree.box_target_starts,
                tree.box_target_counts_nonchild, w._target_rows, local_exps,
                centers, w.box_scale, w.order)
    if which == "p2p_dipole":
        return (tgt, src, q, *dip, tree.box_target_starts,
                tree.box_target_counts_nonchild, tree.box_source_starts,
                tree.box_source_counts_nonchild, trav.target_boxes,
                trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists)
    if which == "p2l_dipole":
        return (src, q, *dip, tree.box_source_starts,
                tree.box_source_counts_nonchild, *w._l4_csr, centers,
                w.box_scale, w.order)
    return (src, q, *dip, tree.box_source_starts,
            tree.box_source_counts_nonchild, w._source_rows, centers,
            w.box_scale, w.order)


def _l2d_particle_compare(which, args, w):
    """K38-K42 against their twins on *args*: one launch; expansions per
    coefficient column (a column zero in the twin must be zero),
    potentials to their largest value."""
    name = L2D_PARTICLE[which]
    out = (w.local_expansion_zeros,) if which == "p2l_dipole" else ()
    kernels.reset_launch_counts()
    got = getattr(laplace2d, name)(*args, *(f() for f in out))
    assert kernels.launch_counts()[name] == 1
    torch.cuda.synchronize()
    ref = getattr(laplace2d, f"{name}_plain")(*args, *(f() for f in out))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got).all()
    if not ref.any():
        # the dipole P2M at order 0: a_0 has no tangent
        assert not got.any()
        return 0.0
    return _zero_safe_cols_rel(got, ref) if got.ndim == 2 else _rel(got,
                                                                   ref)


def _l2d_w_charges(w, q):
    return w.reorder_sources(q if w.dtype.is_complex else q.real)


@pytest.mark.parametrize("which", sorted(L2D_PARTICLE))
@pytest.mark.parametrize("kind", sorted(L2D_KINDS))
@pytest.mark.parametrize("tree", ["starfish", "clustered"])
def test_laplace2d_particle_kernel(laplace2d_dipoles, tree, kind, which):
    """K38-K42 at order 20 on both trees (the starfish's rows have
    separate targets), L2P on standard-normal locals."""
    w, q = laplace2d_dipoles[tree, kind]
    args = _l2d_particle_args(w, _l2d_w_charges(w, q), which,
                              local_exps=_random_locals(w))
    assert _l2d_particle_compare(which, args, w) <= L2D_RTOL[w.dtype]


@pytest.mark.parametrize("which", sorted(L2D_PARTICLE))
@pytest.mark.parametrize("kind", sorted(L2D_KINDS))
def test_laplace2d_particle_kernel_edges(laplace2d_dipoles, kind, which):
    """The twins' edges, on the clustered tree: the first particle of
    each of 300 rows moved onto the centre of the box it is expanded
    about (P2M zeta = 0, L2P w = 0, dipole P2L z0 = 0: the complex form's
    constant z0 = 1 adds nothing, the pairs' tangents of th and 1 / z0
    stay) or onto its horizontal centre line on either side, the second
    of 30 rows to y = -0.0 with the centre's y at +0.0; dipole P2P with
    the second target of 200 boxes moved onto the first (r = 0)."""
    w, q = laplace2d_dipoles["clustered", kind]
    tree, trav = w.tree, w.traversal
    pts = w._sources.clone()
    centers = w.centers.clone()
    if which == "p2p_dipole":
        tb = trav.target_boxes[:200].to(torch.int64)
        first = tree.box_target_starts[tb].to(torch.int64)
        two = tree.box_target_counts_nonchild[tb] >= 2
        pts[:, first[two] + 1] = pts[:, first[two]]
    else:
        if which == "p2l_dipole":
            rows, starts, lists = (t.to(torch.int64) for t in w._l4_csr)
            n = min(300, rows.shape[0])
            pbox, cbox = lists[starts[:n]], rows[:n]
        else:
            cbox = pbox = (w._target_rows if which == "l2p"
                           else w._source_rows)[:300].to(torch.int64)
        part = "target" if which == "l2p" else "source"
        first = getattr(tree, f"box_{part}_starts")[pbox].to(torch.int64)
        count = getattr(tree, f"box_{part}_counts_nonchild")[pbox]
        ctr = centers[:, cbox]
        s = w.box_scale[cbox]
        third = torch.arange(cbox.shape[0], device=pts.device) % 3
        dx = torch.where(third == 1, -0.75 * s, 0.75 * s)
        dx = torch.where(third == 0, torch.zeros_like(dx), dx)
        pts[0, first] = ctr[0] + dx
        pts[1, first] = ctr[1]
        sel = (count[:30] >= 2).nonzero()[:, 0]
        centers[1, cbox[sel]] = 0.0
        pts[1, first[sel] + 1] = -0.0
        pts[0, first[sel] + 1] = ctr[0, sel] + torch.where(
            third[sel] == 1, -0.5, 0.5) * s[sel]
    args = _l2d_particle_args(w, _l2d_w_charges(w, q), which, sources=pts,
                              targets=pts, centers=centers,
                              local_exps=_random_locals(w))
    assert _l2d_particle_compare(which, args, w) <= L2D_RTOL[w.dtype]


@pytest.mark.parametrize("which", ["p2m", "p2m_dipole", "l2p"])
@pytest.mark.parametrize("kind", sorted(L2D_KINDS))
@pytest.mark.parametrize("order", [0, 1, 35])
def test_laplace2d_particle_kernel_orders(laplace2d_dipoles, order, kind,
                                          which):
    """K38-K40 at orders 0, 1 and 35 on the starfish tree, with the
    wrangler's arguments at order 20 and the coefficient count of
    *order*."""
    w, q = laplace2d_dipoles["starfish", kind]
    args = list(_l2d_particle_args(w, _l2d_w_charges(w, q), which))
    args[-1] = order
    if which == "l2p":
        rng = np.random.default_rng(9)
        loc = rng.standard_normal((w.tree.nboxes,
                                   laplace2d.ncoeffs(order, w.dtype)))
        if w.dtype.is_complex:
            loc = loc + 1j * rng.standard_normal(loc.shape)
        args[4] = torch.as_tensor(loc, device=w.device).to(w.dtype)
    assert _l2d_particle_compare(which, tuple(args), w) <= L2D_RTOL[w.dtype]


@pytest.mark.parametrize("kind", sorted(L2D_KINDS))
def test_laplace2d_dipole_fmm_on_card_matches_cpu(laplace2d_dipoles, kind):
    """The starfish double layer on the card against the CPU port (1e-10,
    float32 1e-5), one launch each of K39, K41, K42, K20, K40 and K35, and
    none of K38 or of the charge kernels K19 and K21."""
    w, q = laplace2d_dipoles["starfish", kind]
    qr = q.real
    kernels.reset_launch_counts()
    got = drive_fmm(w, [qr])
    counts = kernels.launch_counts()
    want = dict.fromkeys(("p2m_laplace2d_dipole", "p2p_laplace2d_dipole",
                          "p2l_laplace2d_dipole", "m2p_laplace2d",
                          "l2p_laplace2d", "m2l_translate"), 1)
    want.update(dict.fromkeys(("p2m_laplace2d", "p2p_laplace2d",
                               "p2l_laplace2d"), 0))
    assert {k: counts[k] for k in want} == want
    src, tgt, nrm = laplace2d_dipoles["starfish_inputs"]
    trav_cpu = build_traversal(build_tree(src, targets=tgt,
                                          max_particles_in_box=20,
                                          device="cpu"))
    pairs, dt = L2D_KINDS[kind]
    w_cpu = make_laplace_wrangler(trav_cpu, 20, pairs=pairs, dtype=dt,
                                  rscale="auto", dipole_vec=nrm)
    ref = drive_fmm(w_cpu, [qr.cpu()])
    assert got.dtype == dt
    assert _rel(got.cpu(), ref) <= (1e-5 if dt == torch.float32 else 1e-10)


def test_laplace2d_particle_wrappers_refuse(laplace2d_dipoles):
    """A complex64 charge or coefficient array, or dipoles shaped other
    than the sources, raise before any launch."""
    w, q = laplace2d_dipoles["starfish", "c128"]
    kernels.reset_launch_counts()
    for which, name in L2D_PARTICLE.items():
        args = list(_l2d_particle_args(w, _l2d_w_charges(w, q), which,
                                       local_exps=_random_locals(w)))
        out = ((w.local_expansion_zeros(),) if which == "p2l_dipole"
               else ())
        i = 4 if which == "l2p" else 2 if which == "p2p_dipole" else 1
        bad = list(args)
        bad[i] = bad[i].to(torch.complex64)
        with pytest.raises(TypeError):
            getattr(laplace2d, name)(*bad, *out)
        if which.endswith("dipole"):
            bad = list(args)
            bad[i + 1] = bad[i + 1][:, :-1].contiguous()
            with pytest.raises(ValueError, match="dipole_vec"):
                getattr(laplace2d, name)(*bad, *out)
    assert not any(kernels.launch_counts()[k] for k in L2D_PARTICLE.values())

# }}}


# {{{ 3D Laplace: the complex128 entry points of K2-K4, dipoles (K22, K23)

L3D_RTOL = L2D_RTOL
L3D_KINDS = L2D_KINDS
L3D_KERNELS = {"p2p": "p2p_laplace3d", "p2p_dipole": "p2p_laplace3d_dipole",
               "m2p": "m2p_laplace3d", "p2l": "p2l_laplace3d",
               "p2l_dipole": "p2l_laplace3d_dipole"}


@pytest.fixture(scope="module")
def laplace3d_setup(device):
    """Sources on the unit sphere with their normals as dipoles, targets
    in [-1, 1]^3 (``tests/test_laplace.py:113-134``'s geometry), complex
    charges; a wrangler per entry point, order 8, ``rscale="auto"``."""
    ns, nt = 20000, 5000
    rng = np.random.default_rng(4)
    src = torch.as_tensor(_sphere(ns, 15), device=device)
    tgt = torch.as_tensor(rng.random((3, nt)) * 2 - 1, device=device)
    qc = torch.as_tensor(rng.standard_normal(ns)
                         + 1j * rng.standard_normal(ns), device=device)
    trav = build_traversal(build_tree(src, targets=tgt,
                                      max_particles_in_box=30))
    ws = {kind: make_laplace_wrangler(trav, 8, pairs=pairs, dtype=dt,
                                      rscale="auto", dipole_vec=src)
          for kind, (pairs, dt) in L3D_KINDS.items()}
    return trav, ws, src, tgt, qc


def _l3d_args(trav, w, q, which, centers=None):
    """K2-K4, K22 or K23's arguments from wrangler *w* (charges *q* in its
    dtype), the box centres replaced if given."""
    tree = trav.tree
    centers = w.centers if centers is None else centers
    if which.startswith("p2p"):
        dip = (w.dipole_vec,) if which == "p2p_dipole" else ()
        return (w._targets, w._sources, q, *dip, tree.box_target_starts,
                tree.box_target_counts_nonchild, tree.box_source_starts,
                tree.box_source_counts_nonchild, trav.target_boxes,
                trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists)
    if which == "m2p":
        mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                                [q]))
        return (w._targets, tree.box_target_starts,
                tree.box_target_counts_nonchild, *w._l3_csr, mp, centers,
                w.box_scale, w.order)
    dip = (w.dipole_vec,) if which == "p2l_dipole" else ()
    return (w._sources, q, *dip, tree.box_source_starts,
            tree.box_source_counts_nonchild, *w._l4_csr, centers,
            w.box_scale, w.order)


def _l3d_compare(which, args, w):
    fn = getattr(laplace3d, L3D_KERNELS[which])
    plain = getattr(laplace3d, f"{L3D_KERNELS[which]}_plain")
    if which.startswith("p2l"):
        got = fn(*args, w.local_expansion_zeros())
        ref = plain(*args, w.local_expansion_zeros())
        return _zero_safe_cols_rel(got, ref)
    return _rel(fn(*args), plain(*args))


@pytest.mark.parametrize("which", sorted(L3D_KERNELS))
@pytest.mark.parametrize("kind", sorted(L3D_KINDS))
def test_laplace3d_kernel(laplace3d_setup, kind, which):
    trav, ws, _, _, qc = laplace3d_setup
    w = ws[kind]
    assert w._l3_csr[0].numel() > 0 and w._l4_csr[0].numel() > 0
    q = w.reorder_sources(qc if w.dtype.is_complex else qc.real)
    kernels.reset_launch_counts()
    err = _l3d_compare(which, _l3d_args(trav, w, q, which), w)
    assert kernels.launch_counts()[L3D_KERNELS[which]] == 1
    assert err <= L3D_RTOL[w.dtype]


@pytest.mark.parametrize("which", ["p2p", "p2p_dipole", "p2l",
                                   "p2l_dipole"])
@pytest.mark.parametrize("kind", ["c128", "f64"])
def test_laplace3d_kernel_at_r0(laplace3d_setup, device, kind, which):
    """r = 0: P2P on a tree whose sources are its targets (each target on
    its own source), P2L with a List-4 row's centre moved onto a source of
    its first listed box.  The float32 entry points run the same template
    code; their sums at these points cancel beyond 1e-5 of the largest
    value (2.5e-5 on an H100), so they are held at the path's geometry
    (:func:`test_laplace3d_kernel`) only."""
    trav, ws, src, _, qc = laplace3d_setup
    pairs, dt = L3D_KINDS[kind]
    if which.startswith("p2p"):
        trav = build_traversal(build_tree(src, max_particles_in_box=30))
        w = make_laplace_wrangler(trav, 8, pairs=pairs, dtype=dt,
                                  rscale="auto", dipole_vec=src)
        centers = None
    else:
        w = ws[kind]
        rows, starts, lists = w._l4_csr
        tree = trav.tree
        s0 = int(tree.box_source_starts[int(lists[0])])
        centers = w.centers.clone()
        centers[:, int(rows[0])] = w._sources[:, s0]
    q = w.reorder_sources(qc if w.dtype.is_complex else qc.real)
    err = _l3d_compare(which, _l3d_args(trav, w, q, which, centers), w)
    assert err <= L3D_RTOL[w.dtype]


def test_laplace3d_m2l_table_on_card(laplace3d_setup):
    """Both 3D layouts build their M2L tables on the card, as tensors."""
    trav, ws, *_ = laplace3d_setup
    classes = _offsets(3, 3, min_inf_norm=1)
    for w in ws.values():
        t = w._m2l_opsT
        assert t.shape[0] == len(w._m2l_plan.used) > 0
        assert t.device.type == "cuda" and t.dtype == w.dtype
        table = w._m2l_matrices(classes, 0.25, 0.5)
        assert table.device.type == "cuda" and table.dtype in (
            torch.complex128, torch.float64)


def test_laplace3d_factory_on_card(laplace3d_setup):
    trav = laplace3d_setup[0]
    w = make_laplace_wrangler(trav, 4)
    assert type(w).__name__ == "Laplace3DPairsExpansionWrangler"
    w = make_laplace_wrangler(trav, 4, dtype=torch.complex128)
    assert type(w).__name__ == "Laplace3DExpansionWrangler"


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float16])
def test_laplace3d_wrappers_refuse_dtypes(laplace3d_setup, dtype):
    trav, ws, _, _, qc = laplace3d_setup
    w = ws["c128"]
    q = w.reorder_sources(qc).to(dtype)
    kernels.reset_launch_counts()
    for which in L3D_KERNELS:
        with pytest.raises(TypeError):
            args = list(_l3d_args(trav, w, w.reorder_sources(qc), which))
            # the charges, or the multipoles
            at = {"m2p": 6, "p2l": 1, "p2l_dipole": 1}.get(which, 2)
            args[at] = args[at].to(dtype) if which == "m2p" else q
            fn = getattr(laplace3d, L3D_KERNELS[which])
            if which.startswith("p2l"):
                fn(*args, w.local_expansion_zeros().to(dtype))
            else:
                fn(*args)
    assert not any(kernels.launch_counts()[k] for k in L3D_KERNELS.values())


@pytest.mark.parametrize("dipoles", [False, True])
@pytest.mark.parametrize("kind", sorted(L3D_KINDS))
def test_laplace3d_fmm_on_card_matches_cpu(laplace3d_setup, kind, dipoles):
    """The 3D FMM on the card (K2-K4, or K22 / K23 with dipoles and
    ``level_to_order``) against the CPU port on the same points."""
    trav, _, src, tgt, qc = laplace3d_setup
    pairs, dt = L3D_KINDS[kind]
    kw = dict(pairs=pairs, dtype=dt, rscale="auto")
    if dipoles:
        kw.update(level_to_order=lambda lev: 8 - min(lev, 3),
                  dipole_vec=src)
    else:
        kw["order"] = 8
    q = qc if dt.is_complex else qc.real
    w = make_laplace_wrangler(trav, **kw)
    kernels.reset_launch_counts()
    got = drive_fmm(w, [q])
    counts = kernels.launch_counts()
    names = (("p2p_laplace3d_dipole", "m2p_laplace3d",
              "p2l_laplace3d_dipole") if dipoles
             else ("p2p_laplace3d", "m2p_laplace3d", "p2l_laplace3d"))
    assert all(counts[k] > 0 for k in names), counts
    # P2M and L2P: one launch each, no twin, no JVP
    p2m = ("p2m_laplace3d_dipole", "p2m_laplace3d")[::1 if dipoles else -1]
    assert (counts[p2m[0]], counts[p2m[1]], counts["l2p_laplace3d"]) == (
        1, 0, 1), counts
    trav_cpu = build_traversal(build_tree(src.cpu(), targets=tgt.cpu(),
                                          max_particles_in_box=30))
    if dipoles:
        kw["dipole_vec"] = src.cpu()
    ref = drive_fmm(make_laplace_wrangler(trav_cpu, **kw), [q.cpu()])
    assert got.dtype == dt
    assert _rel(got.cpu(), ref) <= (1e-5 if dt == torch.float32 else 1e-10)

# }}}


# {{{ K28-K30: P2M, dipole P2M and L2P of the 3D Laplace wranglers

P2M_L2P_KERNELS = {"p2m": "p2m_laplace3d",
                   "p2m_dipole": "p2m_laplace3d_dipole",
                   "l2p": "l2p_laplace3d"}


def _rows_rel(got, ref):
    """Worst row of ``max |got - ref| / max |ref|`` (expansions: each box's
    row to its own largest value, a row that is zero in the twin must be
    zero, as all are for dipoles at order 0); potentials, one vector, to
    their largest value."""
    if not ref.is_complex():
        got, ref = got.double(), ref.double()
    if ref.ndim == 1:
        return _rel(got, ref)
    scale = (ref.abs().amax(1)).cpu()
    err = ((got - ref).abs().amax(1)).cpu()
    assert (err[scale == 0] == 0).all()
    return max((err[scale > 0] / scale[scale > 0]).tolist(), default=0.0)


def _p2m_l2p_args(w, q, which, local_exps=None, centers=None):
    """K28, K29 or K30's arguments from wrangler *w* (charges *q* in its
    dtype; K30's locals masked as the wrangler masks them), the box
    centres replaced if given."""
    tree = w.tree
    centers = w.centers if centers is None else centers
    if which == "l2p":
        return (w._targets, tree.box_target_starts,
                tree.box_target_counts_nonchild, w._target_rows,
                w._mask_levels(local_exps), centers, w.box_scale, w.order)
    dip = (w.dipole_vec,) if which == "p2m_dipole" else ()
    return (w._sources, q, *dip, tree.box_source_starts,
            tree.box_source_counts_nonchild, w._source_rows, centers,
            w.box_scale, w.order)


def _p2m_l2p_compare(which, args):
    """K28-K30 against their twins on *args*: one launch, and the rel
    error by :func:`_rows_rel`."""
    name = P2M_L2P_KERNELS[which]
    kernels.reset_launch_counts()
    got = getattr(laplace3d, name)(*args)
    assert kernels.launch_counts()[name] == 1
    torch.cuda.synchronize()
    ref = getattr(laplace3d, f"{name}_plain")(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    return _rows_rel(got, ref)


def _random_locals(w, seed=8):
    """Standard-normal local coefficients of *w*'s shape and dtype, made
    with numpy."""
    rng = np.random.default_rng(seed)
    loc = rng.standard_normal((w.tree.nboxes, w.ncoeff))
    if w.dtype.is_complex:
        loc = loc + 1j * rng.standard_normal(loc.shape)
    return torch.as_tensor(loc, device=w.device).to(w.dtype)


def _charges_of(w, qc):
    return w.reorder_sources(qc if w.dtype.is_complex else qc.real)


@pytest.mark.parametrize("which", sorted(P2M_L2P_KERNELS))
@pytest.mark.parametrize("kind", sorted(L3D_KINDS))
def test_p2m_l2p_kernel(laplace3d_setup, kind, which):
    """At order 8 on the sphere sources with separate targets."""
    trav, ws, _, _, qc = laplace3d_setup
    w = ws[kind]
    assert not trav.tree.sources_are_targets
    args = _p2m_l2p_args(w, _charges_of(w, qc), which, _random_locals(w))
    assert _p2m_l2p_compare(which, args) <= L3D_RTOL[w.dtype]


@pytest.mark.parametrize("which", sorted(P2M_L2P_KERNELS))
@pytest.mark.parametrize("kind", sorted(L3D_KINDS))
def test_p2m_l2p_kernel_level_to_order(laplace3d_setup, kind, which):
    """With ``level_to_order``: the wrangler's P2M and L2P stages (kernel,
    then mask) against the twins with the same masks."""
    trav, _, src, _, qc = laplace3d_setup
    pairs, dt = L3D_KINDS[kind]
    w = make_laplace_wrangler(
        trav, level_to_order=lambda lev: 8 - min(lev, 4), pairs=pairs,
        dtype=dt, rscale="auto",
        dipole_vec=src if which == "p2m_dipole" else None)
    q = _charges_of(w, qc)
    loc = _random_locals(w)
    args = _p2m_l2p_args(w, q, which, loc)
    plain = getattr(laplace3d, f"{P2M_L2P_KERNELS[which]}_plain")
    kernels.reset_launch_counts()
    if which == "l2p":
        got = w.eval_locals(None, None, loc)
        ref = plain(*args)
    else:
        got = w.form_multipoles(None, None, [q])
        ref = w._mask_levels(plain(*args))
        past = ~w._level_mask[w._box_levels]
        assert past.any() and (got[past] == 0).all()
    assert kernels.launch_counts()[P2M_L2P_KERNELS[which]] == 1
    assert _rows_rel(got, ref) <= L3D_RTOL[w.dtype]


@pytest.mark.parametrize("which", sorted(P2M_L2P_KERNELS))
@pytest.mark.parametrize("kind", sorted(L3D_KINDS))
def test_p2m_l2p_kernel_at_r0(laplace3d_setup, kind, which):
    """r = 0: the first row's box centre moved onto its first particle,
    which then adds its charge to ``R_0^0`` alone (its dipole to the n = 1
    terms alone), or reads ``L_0^0``."""
    trav, ws, _, _, qc = laplace3d_setup
    w = ws[kind]
    tree = trav.tree
    rows = w._target_rows if which == "l2p" else w._source_rows
    box = int(rows[0])
    pts = w._targets if which == "l2p" else w._sources
    first = int((tree.box_target_starts if which == "l2p"
                 else tree.box_source_starts)[box])
    centers = w.centers.clone()
    centers[:, box] = pts[:, first]
    loc = _random_locals(w)
    args = _p2m_l2p_args(w, _charges_of(w, qc), which, loc, centers)
    assert _p2m_l2p_compare(which, args) <= L3D_RTOL[w.dtype]
    got = getattr(laplace3d, P2M_L2P_KERNELS[which])(*args)
    if which == "l2p":
        want = loc[box, 0] if w.dtype.is_complex else loc[box, 0].real
        assert torch.isfinite(got).all() and got[first] == want
    else:
        assert torch.isfinite(got).all()


@pytest.fixture(scope="module")
def sticking_out(device):
    """3D trees (float64 and float32) whose sources and targets have radii
    (stick-out 0.25), so that both stop in boxes with children, with up
    to 64 particles a box: rows longer than a warp.  (The traversal
    refuses source extents, as the reference's does, so K28-K30 take
    their arguments from the tree.)"""
    rng = np.random.default_rng(31)
    src = _sphere(30000, 32)
    tgt = rng.random((3, 6000)) * 2 - 1
    radii = dict(source_radii=2 ** rng.uniform(-6, 0, 30000) * 0.1,
                 target_radii=2 ** rng.uniform(-6, 0, 6000) * 0.1)
    trees = {}
    for dt in (torch.float64, torch.float32):
        tree = trees[dt] = build_tree(
            torch.as_tensor(src, dtype=dt, device=device),
            targets=torch.as_tensor(tgt, dtype=dt, device=device),
            stick_out_factor=0.25, max_particles_in_box=64,
            **{k: torch.as_tensor(v, dtype=dt, device=device)
               for k, v in radii.items()})
        internal = (tree.box_flags & 16) == 0
        for what in ("source", "target"):
            counts = getattr(tree, f"box_{what}_counts_nonchild")
            assert (counts[internal] > 0).sum() >= 5
            assert counts.max() > 32
    return trees


@pytest.mark.parametrize("which", sorted(P2M_L2P_KERNELS))
@pytest.mark.parametrize("kind", sorted(L3D_KINDS))
def test_p2m_l2p_kernel_extent_tree(sticking_out, kind, which):
    _, dt = L3D_KINDS[kind]
    tree = sticking_out[torch.float32 if dt == torch.float32
                        else torch.float64]
    args = _direct_args(tree, which, kind == "c128", 6)
    assert _p2m_l2p_compare(which, args) <= L3D_RTOL[dt]


def _direct_args(tree, which, cplx, order, seed=41):
    """K28-K30's arguments on *tree* without a wrangler (at orders whose
    M2L table no wrangler could hold): box scale 1 / 2^level, charges,
    dipoles and locals from numpy."""
    rng = np.random.default_rng(seed)
    dt = tree.sources.dtype
    dev = tree.sources.device
    vdt = torch.complex128 if cplx else dt
    rows = [torch.nonzero(c > 0)[:, 0].to(torch.int32)
            for c in (tree.box_source_counts_nonchild,
                      tree.box_target_counts_nonchild)]
    scale = (0.5 ** tree.box_levels.to(torch.float64)).to(dt)
    centers = tree.box_centers.contiguous()
    if which == "l2p":
        k = (order + 1) ** 2 * (1 if cplx else 2)
        loc = rng.standard_normal((tree.nboxes, k))
        if cplx:
            loc = loc + 1j * rng.standard_normal(loc.shape)
        return (tree.targets.contiguous(), tree.box_target_starts,
                tree.box_target_counts_nonchild, rows[1],
                torch.as_tensor(loc, device=dev).to(vdt), centers, scale,
                order)
    q = rng.standard_normal(tree.nsources)
    if cplx:
        q = q + 1j * rng.standard_normal(tree.nsources)
    dip = (torch.as_tensor(rng.standard_normal((3, tree.nsources)),
                           dtype=dt, device=dev),) \
        if which == "p2m_dipole" else ()
    return (tree.sources.contiguous(),
            torch.as_tensor(q, device=dev).to(vdt), *dip,
            tree.box_source_starts, tree.box_source_counts_nonchild, rows[0],
            centers, scale, order)


#: per entry point, order 0 and the least order past the 48-KiB default
#: of shared memory a CTA, for K28-K30 alike
EDGE_ORDERS = {"c128": (0, 55), "f64": (0, 55), "f32": (0, 78)}


@pytest.mark.parametrize("which", sorted(P2M_L2P_KERNELS))
@pytest.mark.parametrize("kind,order", [(k, o) for k, os in
                                        EDGE_ORDERS.items() for o in os])
def test_p2m_l2p_kernel_edge_orders(device, kind, order, which):
    _, dt = L3D_KINDS[kind]
    rdt = torch.float64 if kind == "c128" else dt
    # K28 / K29 take 4 values less than smem_bytes
    smem = laplace3d.smem_bytes(order, rdt) - 4 * rdt.itemsize
    assert (smem > 48 * 1024) == (order > 0)
    assert laplace3d.smem_bytes(order - 1, rdt) <= 48 * 1024 or order == 0
    rng = np.random.default_rng(42)
    pts = torch.as_tensor(_sphere(3000, 43), dtype=rdt, device=device)
    tgt = torch.as_tensor(rng.random((3, 500)) * 2 - 1, dtype=rdt,
                          device=device)
    tree = build_tree(pts, targets=tgt, max_particles_in_box=30)
    args = _direct_args(tree, which, kind == "c128", order)
    assert _p2m_l2p_compare(which, args) <= L3D_RTOL[dt]


@pytest.mark.parametrize("which", sorted(P2M_L2P_KERNELS))
@pytest.mark.parametrize("kind", sorted(L3D_KINDS))
def test_p2m_l2p_kernel_one_box(device, kind, which):
    """A tree of one box: one row, five particles."""
    _, dt = L3D_KINDS[kind]
    rdt = torch.float64 if kind == "c128" else dt
    pts = torch.as_tensor(_sphere(5, 44), dtype=rdt, device=device)
    tree = build_tree(pts, max_particles_in_box=30)
    assert tree.nboxes == 1
    args = _direct_args(tree, which, kind == "c128", 8)
    assert _p2m_l2p_compare(which, args) <= L3D_RTOL[dt]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float16])
def test_p2m_l2p_wrappers_refuse_dtypes(laplace3d_setup, dtype):
    trav, ws, _, _, qc = laplace3d_setup
    w = ws["c128"]
    kernels.reset_launch_counts()
    for which, name in P2M_L2P_KERNELS.items():
        args = list(_p2m_l2p_args(w, _charges_of(w, qc), which,
                                  _random_locals(w)))
        args[4 if which == "l2p" else 1] = args[
            4 if which == "l2p" else 1].to(dtype)
        with pytest.raises(TypeError):
            getattr(laplace3d, name)(*args)
    assert not any(kernels.launch_counts()[k]
                   for k in P2M_L2P_KERNELS.values())

# }}}


# {{{ K31-K34: P2M and L2P of the 3D and 2D Helmholtz wranglers

HELM_P2M_L2P = [(dim, which) for dim in (3, 2) for which in ("p2m", "l2p")]
#: K31 / K32 against their twins: the j_n recurrence and the harmonics
#: with FMA contraction, the warp sums in another order; K33 / K34 repeat
#: the twin's uncontracted J recurrence (K16-K18's bar)
HELM_P2M_L2P_RTOL = {3: 1e-12, 2: H2D_RTOL}


def _helm_p2m_l2p_args(w, q, which, local_exps=None, centers=None):
    """K31-K34's arguments from Helmholtz wrangler *w*, the box centres
    replaced if given."""
    tree = w.tree
    centers = w.centers if centers is None else centers
    tail = (w.k, w.order) if w.dim == 3 else (w.k, w.order, w._nstart)
    if which == "l2p":
        return (w._targets, tree.box_target_starts,
                tree.box_target_counts_nonchild, w._target_rows, local_exps,
                centers, w.box_scale, *tail)
    w_nm = (w._w_nm,) if w.dim == 3 else ()
    return (w._sources, q, tree.box_source_starts,
            tree.box_source_counts_nonchild, w._source_rows, centers,
            w.box_scale, *w_nm, *tail)


def _helm_p2m_l2p_compare(dim, which, args):
    """K31-K34 against their twins on *args*: one launch; multipoles per
    coefficient column, potentials to their largest value."""
    mod = helmholtz3d if dim == 3 else helmholtz2d
    name = f"{which}_helmholtz{dim}d"
    kernels.reset_launch_counts()
    got = getattr(mod, name)(*args)
    assert kernels.launch_counts()[name] == 1
    torch.cuda.synchronize()
    ref = getattr(mod, f"{name}_plain")(*args)
    assert got.dtype == ref.dtype == torch.complex128
    assert got.shape == ref.shape
    return _cols_rel(got, ref) if got.ndim == 2 else _rel(got, ref)


@pytest.fixture(scope="module")
def helm_p2m_l2p(helmholtz, helmholtz2d_setup):
    return {3: helmholtz, 2: helmholtz2d_setup}


@pytest.mark.parametrize("dim,which", HELM_P2M_L2P)
def test_helmholtz_p2m_l2p_kernel(helm_p2m_l2p, dim, which):
    """At the FMM fixtures' shapes: 2e4 sphere points, order 12, k = 2
    (3D); 2e4 clustered points, order 16, k = 3 (2D); rscale "auto"."""
    trav, w, q = helm_p2m_l2p[dim][:3]
    args = _helm_p2m_l2p_args(w, q, which, _random_locals(w))
    assert _helm_p2m_l2p_compare(dim, which, args) \
        <= HELM_P2M_L2P_RTOL[dim]


@pytest.mark.parametrize("dim,which", HELM_P2M_L2P)
def test_helmholtz_p2m_l2p_kernel_at_r0(helm_p2m_l2p, dim, which):
    """r = 0: the first row's box centre moved onto its first particle,
    which then adds ``q w_00`` (3D) or ``(i/4) q`` (2D) to the ``n = 0``
    coefficient alone, or reads ``L_00`` / ``b_0`` exactly; and a second
    particle of the box 1e-10 from that centre (k r below the series
    switches)."""
    trav, w, q = helm_p2m_l2p[dim][:3]
    tree = trav.tree
    rows = w._target_rows if which == "l2p" else w._source_rows
    counts = (tree.box_target_counts_nonchild if which == "l2p"
              else tree.box_source_counts_nonchild)
    box = int(rows[torch.nonzero(counts[rows.to(torch.int64)] >= 2)[0, 0]])
    starts = (tree.box_target_starts if which == "l2p"
              else tree.box_source_starts)
    first = int(starts[box])
    pts = (w._targets if which == "l2p" else w._sources).clone()
    pts[:, first + 1] = pts[:, first]
    pts[0, first + 1] += 1e-10
    centers = w.centers.clone()
    centers[:, box] = pts[:, first]
    loc = _random_locals(w)
    args = list(_helm_p2m_l2p_args(w, q, which, loc, centers))
    args[0] = pts
    assert _helm_p2m_l2p_compare(dim, which, args) \
        <= HELM_P2M_L2P_RTOL[dim]
    mod = helmholtz3d if dim == 3 else helmholtz2d
    got = getattr(mod, f"{which}_helmholtz{dim}d")(*args)
    assert torch.isfinite(got).all()
    if which == "l2p":
        assert got[first] == loc[box, 0 if dim == 3 else w.order]


def _helm_direct_args(dim, which, order, device, seed=45):
    """K31-K34's arguments on a tree of 3,000 sources (3D: the sphere; 2D:
    the clustered square) and 500 separate targets without a wrangler:
    box scale min(k 2^-level, 1), charges, locals and the weights w_nm from
    numpy."""
    from boxtree_torch.ops.cylinder_bessel import miller_start
    rng = np.random.default_rng(seed)
    k = 2.0 if dim == 3 else 3.0
    src = _sphere(3000, 43) if dim == 3 else _clustered_2d(3000, 46)
    tgt = rng.random((dim, 500)) * 2 - 1
    tree = build_tree(torch.as_tensor(src, device=device),
                      targets=torch.as_tensor(tgt, device=device),
                      max_particles_in_box=30)
    nc = (order + 1) ** 2 if dim == 3 else 2 * order + 1
    rows = [torch.nonzero(c > 0)[:, 0].to(torch.int32)
            for c in (tree.box_source_counts_nonchild,
                      tree.box_target_counts_nonchild)]
    scale = torch.clamp(k * float(tree.root_extent)
                        * 0.5 ** tree.box_levels.to(torch.float64), max=1.0)
    centers = tree.box_centers.contiguous()
    tail = ((k, order) if dim == 3 else
            (k, order, miller_start(order + 2, k * float(tree.root_extent)
                                    * (2.0 * np.sqrt(2) + 1.0))))
    if which == "l2p":
        loc = rng.standard_normal((tree.nboxes, nc)) \
            + 1j * rng.standard_normal((tree.nboxes, nc))
        return (tree.targets.contiguous(), tree.box_target_starts,
                tree.box_target_counts_nonchild, rows[1],
                torch.as_tensor(loc, device=device), centers, scale, *tail)
    q = rng.standard_normal(tree.nsources) \
        + 1j * rng.standard_normal(tree.nsources)
    w_nm = (torch.as_tensor(rng.standard_normal(nc)
                            + 1j * rng.standard_normal(nc), device=device),
            ) if dim == 3 else ()
    return (tree.sources.contiguous(), torch.as_tensor(q, device=device),
            tree.box_source_starts, tree.box_source_counts_nonchild, rows[0],
            centers, scale, *w_nm, *tail)


@pytest.mark.parametrize("dim,which", HELM_P2M_L2P)
@pytest.mark.parametrize("edge", ["p0", "p1", "high"])
def test_helmholtz_p2m_l2p_kernel_edge_orders(device, dim, which, edge):
    """Orders 0 and 1, and order 20 in 3D / 24 in 2D, with separate
    targets."""
    order = {"p0": 0, "p1": 1, "high": 20 if dim == 3 else 24}[edge]
    args = _helm_direct_args(dim, which, order, device)
    assert _helm_p2m_l2p_compare(dim, which, args) \
        <= HELM_P2M_L2P_RTOL[dim]


def test_helmholtz_p2m_l2p_wrappers_refuse_dtypes(helm_p2m_l2p):
    kernels.reset_launch_counts()
    for dim, which in HELM_P2M_L2P:
        trav, w, q = helm_p2m_l2p[dim][:3]
        args = list(_helm_p2m_l2p_args(w, q, which, _random_locals(w)))
        i = 4 if which == "l2p" else 1
        args[i] = args[i].to(torch.complex64)
        with pytest.raises(TypeError):
            getattr(helmholtz3d if dim == 3 else helmholtz2d,
                    f"{which}_helmholtz{dim}d")(*args)
    assert not any(kernels.launch_counts()[f"{which}_helmholtz{dim}d"]
                   for dim, which in HELM_P2M_L2P)

# }}}


# {{{ K47-K56: the real-pair Helmholtz kernels and wranglers

HELM_PAIR_KERNELS = [(dim, which) for dim in (3, 2)
                     for which in ("p2p", "m2p", "p2l", "p2m", "l2p")]
#: K47-K56 against their twins, per potential lane and per coefficient
#: column: the math of K9-K11, K31, K32 (3D) and K16-K18, K33, K34 (2D) on
#: the pair layout, rounded as on theirs
HELM_PAIRS_RTOL = {3: 1e-12, 2: H2D_RTOL}
#: the pair FMM against the complex one on the card
#: (``tests/test_helmholtz3d.py:170``, ``tests/test_helmholtz.py:183``)
HELM_PAIRS_FMM_RTOL = 1e-12
#: a lane whose largest value is below this fraction of the array's is
#: rounding noise around 0 (with real charges the real lane of the 3D m = 0
#: and the 2D n = 0 multipoles), held to the array's largest value
ZERO_LANE = 1e-12


def _lanes_rel(got, ref):
    """Worst column of potentials ``(n, 2)`` or ``[re | im]`` expansions,
    each held to its own largest ``|ref|`` (noise lanes to the array's
    largest)."""
    scale = ref.abs().amax(0)
    top = scale.max()
    scale = torch.where(scale >= ZERO_LANE * top, scale, top)
    return ((got - ref).abs().amax(0) / scale).max().item()


@pytest.fixture(scope="module")
def helm_pairs(helmholtz, helmholtz2d_setup):
    """Per dimension, on the FMM fixtures' traversals: the pair wrangler
    (order 12, k = 2 in 3D; order 16, k = 3 in 2D; rscale "auto"), the
    real parts of the fixtures' charges (user order) and in tree order."""
    out = {}
    for dim, fix in ((3, helmholtz), (2, helmholtz2d_setup)):
        trav, _, _, _, q = fix
        k, order = (2.0, 12) if dim == 3 else (3.0, 16)
        w = make_helmholtz_wrangler(trav, k, order, rscale="auto",
                                    pairs=True)
        qr = q.real.contiguous()
        out[dim] = (trav, w, qr, w.reorder_sources(qr))
    return out


def _helm_pair_args(w, q, which):
    """The arguments of the pair kernel *which* of pair wrangler *w* on
    the tree-order real charges *q*, the multipoles or locals from its own
    P2M / a numpy draw."""
    trav, tree = w.traversal, w.tree
    tail = (w.k, w.order) if w.dim == 3 else (w.k, w.order, w._nstart)
    weight = (w._w_nm,) if w.dim == 3 else ()
    if which == "p2p":
        return (w._targets, w._sources, q, tree.box_target_starts,
                tree.box_target_counts_nonchild, tree.box_source_starts,
                tree.box_source_counts_nonchild, trav.target_boxes,
                trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists, *tail[:1], *tail[2:])
    if which == "m2p":
        mp = w.coarsen_multipoles(None, None,
                                  w.form_multipoles(None, None, [q]))
        return (w._targets, tree.box_target_starts,
                tree.box_target_counts_nonchild, *w._l3_csr, mp, w.centers,
                w.box_scale, *tail)
    if which == "p2l":
        return (w._sources, q, tree.box_source_starts,
                tree.box_source_counts_nonchild, *w._l4_csr, w.centers,
                w.box_scale, *weight, *tail)
    if which == "l2p":
        return (w._targets, tree.box_target_starts,
                tree.box_target_counts_nonchild, w._target_rows,
                _random_locals(w), w.centers, w.box_scale, *tail)
    return (w._sources, q, tree.box_source_starts,
            tree.box_source_counts_nonchild, w._source_rows, w.centers,
            w.box_scale, *weight, *tail)


def _helm_pair_compare(w, which, args):
    """The pair kernel *which* against its twin on *args*: one launch of
    its ``_f64`` entry point, none of its ``_c128`` one."""
    mod = helmholtz3d if w.dim == 3 else helmholtz2d
    name = f"{which}_helmholtz{w.dim}d"
    extra = (w.local_expansion_zeros(),) if which == "p2l" else ()
    kernels.reset_launch_counts()
    got = getattr(mod, name)(*args, *extra)
    counts = kernels.entry_launch_counts()
    assert counts[f"{name}_f64"] == 1 and counts[f"{name}_c128"] == 0
    torch.cuda.synchronize()
    extra = (w.local_expansion_zeros(),) if which == "p2l" else ()
    ref = getattr(mod, f"{name}_plain")(*args, *extra)
    assert got.dtype == ref.dtype == torch.float64
    assert got.shape == ref.shape
    assert got.shape[1] == (2 if which in ("p2p", "m2p", "l2p")
                            else w.ncoeff)
    return _lanes_rel(got, ref)


@pytest.mark.parametrize("dim,which", HELM_PAIR_KERNELS)
def test_helmholtz_pair_kernel(helm_pairs, dim, which):
    """K47-K51 (3D: P2P, M2P, P2L, P2M, L2P) and K52-K56 (2D) against
    their twins at the FMM fixtures' shapes."""
    w, q = helm_pairs[dim][1], helm_pairs[dim][3]
    assert w._l3_csr[0].numel() > 0 and w._l4_csr[0].numel() > 0
    args = _helm_pair_args(w, q, which)
    assert _helm_pair_compare(w, which, args) <= HELM_PAIRS_RTOL[dim]


@pytest.mark.parametrize("dim,which", HELM_P2M_L2P)
def test_helmholtz_pair_p2m_l2p_at_r0(helm_pairs, dim, which):
    """r = 0 on the pair layout: the first row's box centre moved onto its
    first particle, which adds ``q w_c`` (3D) or ``q / 4`` (2D) to the
    imaginary lane of the ``n = 0`` coefficient alone, or reads ``(L[0],
    L[K])``."""
    w, q = helm_pairs[dim][1], helm_pairs[dim][3]
    tree = w.tree
    rows = w._target_rows if which == "l2p" else w._source_rows
    box = int(rows[0])
    first = int((tree.box_target_starts if which == "l2p"
                 else tree.box_source_starts)[box])
    args = list(_helm_pair_args(w, q, which))
    centers = w.centers.clone()
    centers[:, box] = args[0][:, first]
    args[5] = centers
    assert _helm_pair_compare(w, which, args) <= HELM_PAIRS_RTOL[dim]
    got = getattr(helmholtz3d if dim == 3 else helmholtz2d,
                  f"{which}_helmholtz{dim}d")(*args)
    kc = w.ncoeff // 2
    n0 = 0 if dim == 3 else w.order
    if which == "l2p" and dim == 3:
        loc = args[4]
        assert (got[first] == loc[box, [n0, kc + n0]]).all()
    assert torch.isfinite(got).all()


def test_helmholtz_pair_wrangler_past_old_smem_limit(device):
    """The 2D pair wrangler at order 16 and k = 200 (a recurrence from 954)
    on 3,000 clustered points: K53-K56 against their twins."""
    n = 3000
    pts = torch.as_tensor(_clustered_2d(n, seed=8), device=device)
    q = torch.as_tensor(np.random.default_rng(9).standard_normal(n),
                        device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    w = make_helmholtz_wrangler(trav, 200.0, 16, rscale="auto")
    assert type(w).__name__ == "Helmholtz2DPairsExpansionWrangler"
    tq = w.reorder_sources(q)
    for which in ("m2p", "p2l", "p2m", "l2p"):
        args = _helm_pair_args(w, tq, which)
        assert _helm_pair_compare(w, which, args) <= H2D_RTOL, which


@pytest.mark.parametrize("dim", [3, 2])
def test_helmholtz_pair_fmm_matches_complex(device, dim):
    """At 1e4 points (the sphere in 3D, order 12, k = 2; the clustered
    square in 2D, order 16, k = 3): ``pairs=None`` on the card gives the
    pair wrangler, whose FMM launches K50 / K51 (K55 / K56) once and K47-K49
    (K52-K54) and no complex entry point, and matches the complex FMM on
    the same traversal."""
    n = 10000
    pts = _sphere(n, 3) if dim == 3 else _clustered_2d(n, seed=4)
    trav = build_traversal(build_tree(torch.as_tensor(pts, device=device),
                                      max_particles_in_box=30))
    q = torch.as_tensor(np.random.default_rng(10).standard_normal(n),
                        device=device)
    k, order = (2.0, 12) if dim == 3 else (3.0, 16)
    w = make_helmholtz_wrangler(trav, k, order, rscale="auto")
    assert w.dtype == torch.float64 and w._pot_extra_dims == (2,)
    kernels.reset_launch_counts()
    pot = drive_fmm(w, [q])
    counts = kernels.entry_launch_counts()
    sfx = f"helmholtz{dim}d"
    assert counts[f"p2m_{sfx}_f64"] == counts[f"l2p_{sfx}_f64"] == 1
    assert all(counts[f"{which}_{sfx}_f64"] > 0
               for which in ("p2p", "m2p", "p2l")), counts
    assert not any(counts[f"{which}_{sfx}_c128"]
                   for which in ("p2p", "m2p", "p2l", "p2m", "l2p"))
    ref = drive_fmm(make_helmholtz_wrangler(trav, k, order, rscale="auto",
                                            pairs=False), [q])
    assert pot.shape == (n, 2) and pot.dtype == torch.float64
    assert _rel(torch.complex(pot[:, 0], pot[:, 1]), ref) \
        <= HELM_PAIRS_FMM_RTOL


def test_helmholtz_pair_kernels_refuse_dtypes(helm_pairs):
    """float32 charges or expansions raise before any launch."""
    for dim, which in HELM_PAIR_KERNELS:
        w, q = helm_pairs[dim][1], helm_pairs[dim][3]
        args = list(_helm_pair_args(w, q, which))
        i = {"p2p": 2, "m2p": 6, "l2p": 4}.get(which, 1)
        args[i] = args[i].to(torch.float32)
        extra = (w.local_expansion_zeros(),) if which == "p2l" else ()
        name = f"{which}_helmholtz{dim}d"
        kernels.reset_launch_counts()
        with pytest.raises(TypeError):
            getattr(helmholtz3d if dim == 3 else helmholtz2d, name)(
                *args, *extra)
        assert kernels.launch_counts()[name] == 0

# }}}


# {{{ K57-K62: the 3D Helmholtz dipole kernels

HELM_DIPOLE_KERNELS = ["p2m", "p2p", "p2l"]
#: K57-K62 against their twins, per coefficient column and potential lane:
#: no looser than their charge kernels' bars (K9 / K11 1e-10, K31 1e-12;
#: on the pair layout K47-K51 1e-12)
HELM_DIPOLE_RTOL = {("c128", "p2m"): 1e-12, ("c128", "p2p"): HELM_RTOL,
                    ("c128", "p2l"): HELM_RTOL, ("f64", "p2m"): 1e-12,
                    ("f64", "p2p"): 1e-12, ("f64", "p2l"): 1e-12}


@pytest.fixture(scope="module")
def helm_dipoles(helmholtz):
    """On the 3D Helmholtz fixture's traversal (2e4 sphere points, order
    12, k = 2): per layout and rscale the wrangler with the normals as
    dipoles, and its tree-order charges (complex, or their real parts)."""
    trav, _, _, pts, q = helmholtz
    out = {}
    for layout in ("c128", "f64"):
        for rscale in ("auto", None):
            w = make_helmholtz_wrangler(trav, 2.0, 12, rscale=rscale,
                                        pairs=layout == "f64",
                                        dipole_vec=pts)
            qq = q if layout == "c128" else q.real.contiguous()
            out[layout, rscale] = (w, w.reorder_sources(qq), qq)
    return out


def _helm_dipole_args(w, q, which, sources=None, centers=None):
    """The arguments of the dipole kernel *which* of wrangler *w* on its
    tree-order charges *q* (P2L's without its ``out``), the sources or the
    box centres replaced if given."""
    trav, tree = w.traversal, w.tree
    src = w._sources if sources is None else sources
    centers = w.centers if centers is None else centers
    if which == "p2p":
        return (w._targets, src, q, w.dipole_vec, tree.box_target_starts,
                tree.box_target_counts_nonchild, tree.box_source_starts,
                tree.box_source_counts_nonchild, trav.target_boxes,
                trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists, w.k)
    if which == "p2l":
        return (src, q, w.dipole_vec, tree.box_source_starts,
                tree.box_source_counts_nonchild, *w._l4_csr, centers,
                w.box_scale, w._w_nm, w.k, w.order)
    return (src, q, w.dipole_vec, tree.box_source_starts,
            tree.box_source_counts_nonchild, w._source_rows, centers,
            w.box_scale, w._w_nm, w.k, w.order)


def _helm_dipole_compare(which, args, out=None):
    """The dipole kernel *which* against its twin on *args* (P2L into
    copies of *out*): one launch of the entry point of the charges' layout
    and none of the other's; per coefficient column or potential lane."""
    name = f"{which}_helmholtz3d_dipole"
    dt = args[2].dtype if which == "p2p" else args[1].dtype
    layout = "c128" if dt == torch.complex128 else "f64"
    other = "f64" if layout == "c128" else "c128"
    extra = (out.clone(),) if which == "p2l" else ()
    kernels.reset_launch_counts()
    got = getattr(helmholtz3d, name)(*args, *extra)
    counts = kernels.entry_launch_counts()
    assert counts[f"{name}_{layout}"] == 1 and counts[f"{name}_{other}"] == 0
    torch.cuda.synchronize()
    extra = (out.clone(),) if which == "p2l" else ()
    ref = getattr(helmholtz3d, f"{name}_plain")(*args, *extra)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got).all()
    if got.is_complex():
        return _cols_rel(got, ref) if got.ndim == 2 else _rel(got, ref)
    return _lanes_rel(got, ref)


def _p2l_out(w, seed=4):
    """Standard-normal local coefficients to add the dipole P2L into."""
    return _random_locals(w, seed)


@pytest.mark.parametrize("rscale", ["auto", None])
@pytest.mark.parametrize("which", HELM_DIPOLE_KERNELS)
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz3d_dipole_kernel(helm_dipoles, layout, which, rscale):
    """K57-K59 (complex charges) and K60-K62 (real charges) against their
    twins at the fixture's shapes, the normals as dipoles."""
    w, q, _ = helm_dipoles[layout, rscale]
    assert w._l4_csr[0].numel() > 0
    args = _helm_dipole_args(w, q, which)
    assert _helm_dipole_compare(which, args, _p2l_out(w)) \
        <= HELM_DIPOLE_RTOL[layout, which]


@pytest.mark.parametrize("which", HELM_DIPOLE_KERNELS)
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz3d_dipole_kernel_random_dipoles(helm_dipoles, layout,
                                                  which):
    """Standard-normal dipoles instead of the normals."""
    w, q, _ = helm_dipoles[layout, "auto"]
    args = list(_helm_dipole_args(w, q, which))
    dip = torch.as_tensor(np.random.default_rng(6).standard_normal(
        tuple(w.dipole_vec.shape)), device=w.device)
    args[3 if which == "p2p" else 2] = dip
    assert _helm_dipole_compare(which, args, _p2l_out(w)) \
        <= HELM_DIPOLE_RTOL[layout, which]


@pytest.mark.parametrize("which", HELM_DIPOLE_KERNELS)
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz3d_dipole_kernel_at_r0(helm_dipoles, layout, which):
    """r = 0 and k r < 1e-6: a box (P2M: its own; P2L: a List-4 row's
    target box; P2P: a List-1 target box) with its centre moved onto its
    first source, whose P2M terms are then the limit of the tangent (n = 1
    alone) and whose P2L terms 0, and a second source of that box placed
    1e-7 (k r = 2e-7) from that centre, which takes the j_n series."""
    w, q, _ = helm_dipoles[layout, "auto"]
    tree = w.tree
    counts = tree.box_source_counts_nonchild
    if which == "p2l":
        rows, starts, lists = w._l4_csr
        box = int(rows[0])
        sbox = int(lists[int(starts[0])])
    else:
        rows = w._source_rows if which == "p2m" else w.traversal.target_boxes
        good = torch.nonzero(counts[rows.to(torch.int64)] >= 2)[0, 0]
        box = sbox = int(rows[good])
    first = int(tree.box_source_starts[sbox])
    src = w._sources.clone()
    centers = w.centers.clone()
    centers[:, box] = src[:, first]
    if int(counts[sbox]) >= 2:
        src[:, first + 1] = src[:, first] + 1e-7 / np.sqrt(3.0)
    args = _helm_dipole_args(w, q, which, src, centers)
    if which == "p2p":
        # P2P takes no centre: the second source lands 1e-7 from the first
        # target (the first source, r = 0, is skipped)
        args = (src.clone(),) + args[1:]
    assert _helm_dipole_compare(which, args, _p2l_out(w)) \
        <= HELM_DIPOLE_RTOL[layout, which]


@pytest.mark.parametrize("which", HELM_DIPOLE_KERNELS)
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz3d_dipole_kernel_empty_rows(helm_dipoles, layout, which):
    """Rows without particles or list entries: P2M over every box (parents
    own none), P2P and P2L with an empty row appended to their lists, and
    no row at all (no launch)."""
    w, q, _ = helm_dipoles[layout, "auto"]
    tree = w.tree
    args = list(_helm_dipole_args(w, q, which))
    if which == "p2m":
        args[5] = torch.arange(tree.nboxes, dtype=torch.int32,
                               device=w.device)
    else:
        # a box that no row names (rows name each box at most once)
        i = 8 if which == "p2p" else 5
        rows, starts = args[i], args[i + 1]
        named = torch.zeros(tree.nboxes, dtype=torch.bool, device=w.device)
        named[rows.to(torch.int64)] = True
        spare = torch.nonzero(~named)[:1, 0].to(torch.int32)
        assert spare.numel() == 1
        args[i] = torch.cat([rows, spare])
        args[i + 1] = torch.cat([starts, starts[-1:]])
    assert _helm_dipole_compare(which, args, _p2l_out(w)) \
        <= HELM_DIPOLE_RTOL[layout, which]
    # no rows: nothing launched
    none = list(_helm_dipole_args(w, q, which))
    z = torch.zeros(0, dtype=torch.int32, device=w.device)
    if which == "p2m":
        none[5] = z
    else:
        i = 8 if which == "p2p" else 5
        none[i], none[i + 1], none[i + 2] = z, z[:0].new_zeros(1), z
    kernels.reset_launch_counts()
    extra = (_p2l_out(w),) if which == "p2l" else ()
    got = getattr(helmholtz3d, f"{which}_helmholtz3d_dipole")(*none, *extra)
    assert kernels.launch_counts()[f"{which}_helmholtz3d_dipole"] == 0
    if which == "p2l":
        assert torch.equal(got, _p2l_out(w))
    else:
        assert not got.any()


def _helm_dipole_direct_args(which, order, layout, device, seed=47):
    """The dipole kernel *which*'s arguments on a tree of 3,000 sphere
    sources (the normals as dipoles) and 500 separate targets, without a
    wrangler: box scale min(k 2^-level, 1), the weights w_nm, charges and
    P2L's out from numpy, the lists from ``build_traversal``."""
    from boxtree_torch.models.expansion_base import (
        nonempty_rows,
        rows_with_particles,
    )
    rng = np.random.default_rng(seed)
    k = 2.0
    src = torch.as_tensor(_sphere(3000, 43), device=device)
    tgt = torch.as_tensor(rng.random((3, 500)) * 2 - 1, device=device)
    tree = build_tree(src, targets=tgt, max_particles_in_box=30)
    trav = build_traversal(tree)
    nc = (order + 1) ** 2
    cplx = layout == "c128"
    q = rng.standard_normal(tree.nsources)
    w_nm = rng.standard_normal(nc)
    if cplx:
        q = q + 1j * rng.standard_normal(tree.nsources)
        w_nm = w_nm + 1j * rng.standard_normal(nc)
    q, w_nm = (torch.as_tensor(x, device=device) for x in (q, w_nm))
    scale = torch.clamp(k * float(tree.root_extent)
                        * 0.5 ** tree.box_levels.to(torch.float64), max=1.0)
    centers = tree.box_centers.contiguous()
    sources = tree.sources.contiguous()
    dip = sources.clone()
    if which == "p2p":
        return (tree.targets.contiguous(), sources, q, dip,
                tree.box_target_starts, tree.box_target_counts_nonchild,
                tree.box_source_starts, tree.box_source_counts_nonchild,
                trav.target_boxes, trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists, k), None
    if which == "p2l":
        l4 = nonempty_rows(trav.target_or_target_parent_boxes,
                           trav.from_sep_bigger_starts,
                           trav.from_sep_bigger_lists)
        assert l4[0].numel() > 0
        out = rng.standard_normal((tree.nboxes, nc * (1 if cplx else 2)))
        if cplx:
            out = out + 1j * rng.standard_normal(out.shape)
        return (sources, q, dip, tree.box_source_starts,
                tree.box_source_counts_nonchild, *l4, centers, scale, w_nm,
                k, order), torch.as_tensor(out, device=device)
    rows = rows_with_particles(tree.box_source_counts_nonchild)[0]
    return (sources, q, dip, tree.box_source_starts,
            tree.box_source_counts_nonchild, rows, centers, scale, w_nm, k,
            order), None


@pytest.mark.parametrize("order", [0, 15])
@pytest.mark.parametrize("which", ["p2m", "p2l"])
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz3d_dipole_kernel_orders(device, layout, which, order):
    """Orders 0 and 15 (``tests/test_stability.py:78``'s highest) with
    separate targets: K59 / K62 take 20 KiB of shared memory a CTA at
    order 15."""
    args, out = _helm_dipole_direct_args(which, order, layout, device)
    assert _helm_dipole_compare(which, args, out) \
        <= HELM_DIPOLE_RTOL[layout, which]


@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz3d_dipole_p2m_small_kr(device, layout):
    """K57 / K60 at k = 0.02 (k r from 1e-4 to 1e-2), order 12: there the
    quotient rule's tangent of j_0 = sin(x) / x keeps eps / x^2 of itself,
    so kernel and twin take -j_1 dx; each coefficient column, n = 0's
    included, agrees to the bar (with the quotient rule the n = 0 column
    was 2e-12 apart at the 1e6 sphere's k r = 0.007)."""
    args, _ = _helm_dipole_direct_args("p2m", 12, layout, device)
    args = args[:-2] + (0.02,) + args[-1:]
    assert _helm_dipole_compare("p2m", args) \
        <= HELM_DIPOLE_RTOL[layout, "p2m"]


@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz3d_dipole_p2p_separate_targets(device, layout):
    args, _ = _helm_dipole_direct_args("p2p", 0, layout, device)
    assert _helm_dipole_compare("p2p", args) \
        <= HELM_DIPOLE_RTOL[layout, "p2p"]


@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz3d_dipole_fmm_on_card_matches_cpu(helmholtz, layout):
    """The dipole FMM on the card (normals as dipoles, order 12, k = 2,
    rscale "auto") launches its dipole P2M, P2P and P2L entry points once
    each and not the charge ones (K31 / K9 / K11, pairs K50 / K47 / K49),
    and matches the CPU port to 1e-10."""
    trav, _, _, pts, q = helmholtz
    pairs = layout == "f64"
    qq = q.real.contiguous() if pairs else q
    w = make_helmholtz_wrangler(trav, 2.0, 12, rscale="auto", pairs=pairs,
                                dipole_vec=pts)
    kernels.reset_launch_counts()
    got = drive_fmm(w, [qq])
    counts = kernels.entry_launch_counts()
    for which in HELM_DIPOLE_KERNELS:
        assert counts[f"{which}_helmholtz3d_dipole_{layout}"] == 1, counts
        assert counts[f"{which}_helmholtz3d_{layout}"] == 0, counts
    assert counts[f"l2p_helmholtz3d_{layout}"] == 1
    assert counts[f"m2p_helmholtz3d_{layout}"] == 1
    assert not any(c for e, c in counts.items()
                   if "helmholtz3d" in e and not e.endswith(layout))
    trav_cpu = build_traversal(build_tree(pts.cpu(),
                                          max_particles_in_box=30))
    w_cpu = make_helmholtz_wrangler(trav_cpu, 2.0, 12, rscale="auto",
                                    pairs=pairs, dipole_vec=pts.cpu())
    ref = drive_fmm(w_cpu, [qq.cpu()])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if pairs:
        got, ref = (torch.complex(x[:, 0], x[:, 1]) for x in (got, ref))
    assert _rel(got.cpu(), ref) <= HELM_RTOL


def test_helmholtz3d_dipole_wrappers_refuse(helm_dipoles):
    """float32 dipoles, a 2D dipole array and an order past 227 KiB of
    shared memory raise before any launch."""
    w, q, _ = helm_dipoles["c128", "auto"]
    kernels.reset_launch_counts()
    for which in HELM_DIPOLE_KERNELS:
        args = list(_helm_dipole_args(w, q, which))
        extra = (_p2l_out(w),) if which == "p2l" else ()
        i = 3 if which == "p2p" else 2
        fn = getattr(helmholtz3d, f"{which}_helmholtz3d_dipole")
        bad = list(args)
        bad[i] = args[i].to(torch.float32)
        with pytest.raises(TypeError):
            fn(*bad, *extra)
        bad[i] = args[i][:2].contiguous()
        with pytest.raises(ValueError):
            fn(*bad, *extra)
        if which != "p2p":
            bad = list(args)
            bad[-1] = 200
            with pytest.raises(ValueError, match="shared memory"):
                fn(*bad, *extra)
    assert not any(kernels.launch_counts()[f"{which}_helmholtz3d_dipole"]
                   for which in HELM_DIPOLE_KERNELS)

# }}}


# {{{ K63-K68: the 2D Helmholtz dipole kernels

#: K63-K68 against their twins, per coefficient column and potential lane:
#: their charge kernels' bars (K16 / K18 1e-12, K33 1e-12; K52-K56 1e-12)
H2D_DIPOLE_RTOL = 1e-12


@pytest.fixture(scope="module")
def h2d_dipoles(helmholtz2d_setup):
    """On the 2D Helmholtz fixture's traversal (2e4 clustered points,
    order 16, k = 3): per layout and rscale the wrangler with
    standard-normal dipoles, and its tree-order charges (complex, or their
    real parts)."""
    trav, _, _, pts, q = helmholtz2d_setup
    dip = torch.as_tensor(np.random.default_rng(31).standard_normal(
        tuple(pts.shape)), device=pts.device)
    out = {}
    for layout in ("c128", "f64"):
        for rscale in ("auto", None):
            w = make_helmholtz_wrangler(trav, 3.0, 16, rscale=rscale,
                                        pairs=layout == "f64",
                                        dipole_vec=dip)
            qq = q if layout == "c128" else q.real.contiguous()
            out[layout, rscale] = (w, w.reorder_sources(qq), qq)
    return out


def _h2d_dipole_args(w, q, which, sources=None, centers=None):
    """The arguments of the 2D dipole kernel *which* of wrangler *w* on its
    tree-order charges *q* (P2L's without its ``out``), the sources or the
    box centres replaced if given."""
    trav, tree = w.traversal, w.tree
    src = w._sources if sources is None else sources
    centers = w.centers if centers is None else centers
    if which == "p2p":
        return (w._targets, src, q, w.dipole_vec, tree.box_target_starts,
                tree.box_target_counts_nonchild, tree.box_source_starts,
                tree.box_source_counts_nonchild, trav.target_boxes,
                trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists, w.k, w._nstart)
    if which == "p2l":
        return (src, q, w.dipole_vec, tree.box_source_starts,
                tree.box_source_counts_nonchild, *w._l4_csr, centers,
                w.box_scale, w.k, w.order, w._nstart)
    return (src, q, w.dipole_vec, tree.box_source_starts,
            tree.box_source_counts_nonchild, w._source_rows, centers,
            w.box_scale, w.k, w.order, w._nstart)


def _h2d_dipole_compare(which, args, out=None):
    """The 2D dipole kernel *which* against its twin on *args* (P2L into
    copies of *out*): one launch of the entry point of the charges' layout
    and none of the other's; per coefficient column or potential lane."""
    name = f"{which}_helmholtz2d_dipole"
    dt = args[2].dtype if which == "p2p" else args[1].dtype
    layout = "c128" if dt == torch.complex128 else "f64"
    other = "f64" if layout == "c128" else "c128"
    extra = (out.clone(),) if which == "p2l" else ()
    kernels.reset_launch_counts()
    got = getattr(helmholtz2d, name)(*args, *extra)
    counts = kernels.entry_launch_counts()
    assert counts[f"{name}_{layout}"] == 1 and counts[f"{name}_{other}"] == 0
    torch.cuda.synchronize()
    extra = (out.clone(),) if which == "p2l" else ()
    ref = getattr(helmholtz2d, f"{name}_plain")(*args, *extra)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got).all()
    if got.is_complex():
        return _cols_rel(got, ref) if got.ndim == 2 else _rel(got, ref)
    return _lanes_rel(got, ref)


@pytest.mark.parametrize("rscale", ["auto", None])
@pytest.mark.parametrize("which", HELM_DIPOLE_KERNELS)
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz2d_dipole_kernel(h2d_dipoles, layout, which, rscale):
    """K63-K65 (complex charges) and K66-K68 (real charges) against their
    twins at the fixture's shapes."""
    w, q, _ = h2d_dipoles[layout, rscale]
    assert w._l4_csr[0].numel() > 0
    args = _h2d_dipole_args(w, q, which)
    assert _h2d_dipole_compare(which, args, _random_locals(w, 4)) \
        <= H2D_DIPOLE_RTOL


@pytest.mark.parametrize("which", HELM_DIPOLE_KERNELS)
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz2d_dipole_kernel_at_r0(h2d_dipoles, layout, which):
    """r = 0 and k r < 1e-8: a box (P2M: its own; P2L: a List-4 row's
    target box; P2P: a List-1 target box) with its centre moved onto its
    first source, whose P2M terms are then the limit of the tangent (n =
    +-1 alone) and whose P2L terms 0, and a second source of that box
    placed 1e-10 from that centre (k r = 3e-10, the J series)."""
    w, q, _ = h2d_dipoles[layout, "auto"]
    tree = w.tree
    counts = tree.box_source_counts_nonchild
    if which == "p2l":
        rows, starts, lists = w._l4_csr
        box = int(rows[0])
        sbox = int(lists[int(starts[0])])
    else:
        rows = w._source_rows if which == "p2m" else w.traversal.target_boxes
        good = torch.nonzero(counts[rows.to(torch.int64)] >= 2)[0, 0]
        box = sbox = int(rows[good])
    first = int(tree.box_source_starts[sbox])
    src = w._sources.clone()
    centers = w.centers.clone()
    centers[:, box] = src[:, first]
    if int(counts[sbox]) >= 2:
        src[:, first + 1] = src[:, first] + 1e-10 / np.sqrt(2.0)
    args = _h2d_dipole_args(w, q, which, src, centers)
    if which == "p2p":
        # the second source lands 1e-10 from the first target (the first
        # source, r = 0, is skipped)
        args = (src.clone(),) + args[1:]
    assert _h2d_dipole_compare(which, args, _random_locals(w, 4)) \
        <= H2D_DIPOLE_RTOL


@pytest.mark.parametrize("which", HELM_DIPOLE_KERNELS)
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz2d_dipole_kernel_empty_rows(h2d_dipoles, layout, which):
    """Rows without particles or list entries: P2M over every box (parents
    own none), P2P and P2L with an empty row appended to their lists, and
    no row at all (no launch)."""
    w, q, _ = h2d_dipoles[layout, "auto"]
    tree = w.tree
    args = list(_h2d_dipole_args(w, q, which))
    if which == "p2m":
        args[5] = torch.arange(tree.nboxes, dtype=torch.int32,
                               device=w.device)
    else:
        i = 8 if which == "p2p" else 5
        rows, starts = args[i], args[i + 1]
        named = torch.zeros(tree.nboxes, dtype=torch.bool, device=w.device)
        named[rows.to(torch.int64)] = True
        spare = torch.nonzero(~named)[:1, 0].to(torch.int32)
        assert spare.numel() == 1
        args[i] = torch.cat([rows, spare])
        args[i + 1] = torch.cat([starts, starts[-1:]])
    assert _h2d_dipole_compare(which, args, _random_locals(w, 4)) \
        <= H2D_DIPOLE_RTOL
    none = list(_h2d_dipole_args(w, q, which))
    z = torch.zeros(0, dtype=torch.int32, device=w.device)
    if which == "p2m":
        none[5] = z
    else:
        i = 8 if which == "p2p" else 5
        none[i], none[i + 1], none[i + 2] = z, z[:0].new_zeros(1), z
    kernels.reset_launch_counts()
    extra = (_random_locals(w, 4),) if which == "p2l" else ()
    got = getattr(helmholtz2d, f"{which}_helmholtz2d_dipole")(*none, *extra)
    assert kernels.launch_counts()[f"{which}_helmholtz2d_dipole"] == 0
    if which == "p2l":
        assert torch.equal(got, _random_locals(w, 4))
    else:
        assert not got.any()


@pytest.mark.parametrize("order,k", [(0, 3.0), (24, 3.0), (16, 200.0)])
@pytest.mark.parametrize("which", ["p2m", "p2l"])
@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz2d_dipole_kernel_orders(device, layout, which, order, k):
    """Orders 0 and 24 at k = 3, and order 16 at k = 200 (a recurrence
    from 954 to order p + 1: the scratch holds it), on 3,000 clustered
    points with standard-normal dipoles."""
    n = 3000
    pts = torch.as_tensor(_clustered_2d(n, seed=8), device=device)
    rng = np.random.default_rng(9)
    qc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    w = make_helmholtz_wrangler(
        trav, k, order, rscale="auto", pairs=layout == "f64",
        dipole_vec=torch.as_tensor(rng.standard_normal((2, n)),
                                   device=device))
    q = w.reorder_sources(torch.as_tensor(
        qc if layout == "c128" else qc.real, device=device))
    args = _h2d_dipole_args(w, q, which)
    assert _h2d_dipole_compare(which, args, _random_locals(w, 4)) \
        <= H2D_DIPOLE_RTOL


@pytest.mark.parametrize("layout", ["c128", "f64"])
def test_helmholtz2d_dipole_fmm_on_card_matches_cpu(helmholtz2d_setup,
                                                    layout):
    """The 2D dipole FMM on the card (standard-normal dipoles, order 16, k
    = 3, rscale "auto") launches its dipole P2M, P2P and P2L entry points
    once each and not the charge ones (K33 / K16 / K18, pairs K55 / K52 /
    K54), and matches the CPU port to 1e-10."""
    trav, _, _, pts, q = helmholtz2d_setup
    pairs = layout == "f64"
    qq = q.real.contiguous() if pairs else q
    dip = torch.as_tensor(np.random.default_rng(31).standard_normal(
        tuple(pts.shape)), device=pts.device)
    w = make_helmholtz_wrangler(trav, 3.0, 16, rscale="auto", pairs=pairs,
                                dipole_vec=dip)
    kernels.reset_launch_counts()
    got = drive_fmm(w, [qq])
    counts = kernels.entry_launch_counts()
    for which in HELM_DIPOLE_KERNELS:
        assert counts[f"{which}_helmholtz2d_dipole_{layout}"] == 1, counts
        assert counts[f"{which}_helmholtz2d_{layout}"] == 0, counts
    assert counts[f"l2p_helmholtz2d_{layout}"] == 1
    assert counts[f"m2p_helmholtz2d_{layout}"] == 1
    assert not any(c for e, c in counts.items()
                   if "helmholtz2d" in e and not e.endswith(layout))
    trav_cpu = build_traversal(build_tree(pts.cpu(),
                                          max_particles_in_box=30))
    w_cpu = make_helmholtz_wrangler(trav_cpu, 3.0, 16, rscale="auto",
                                    pairs=pairs, dipole_vec=dip.cpu())
    ref = drive_fmm(w_cpu, [qq.cpu()])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if pairs:
        got, ref = (torch.complex(x[:, 0], x[:, 1]) for x in (got, ref))
    assert _rel(got.cpu(), ref) <= HELM_RTOL


def test_helmholtz2d_dipole_wrappers_refuse(h2d_dipoles):
    """float32 dipoles, a 1-row dipole array and an order past 227 KiB of
    shared memory raise before any launch."""
    w, q, _ = h2d_dipoles["c128", "auto"]
    kernels.reset_launch_counts()
    for which in HELM_DIPOLE_KERNELS:
        args = list(_h2d_dipole_args(w, q, which))
        extra = (_random_locals(w, 4),) if which == "p2l" else ()
        i = 3 if which == "p2p" else 2
        fn = getattr(helmholtz2d, f"{which}_helmholtz2d_dipole")
        bad = list(args)
        bad[i] = args[i].to(torch.float32)
        with pytest.raises(TypeError):
            fn(*bad, *extra)
        bad[i] = args[i][:1].contiguous()
        with pytest.raises(ValueError):
            fn(*bad, *extra)
        if which != "p2p":
            bad = list(args)
            bad[-2] = 200
            with pytest.raises(ValueError, match="shared memory"):
                fn(*bad, *extra)
    assert not any(kernels.launch_counts()[f"{which}_helmholtz2d_dipole"]
                   for which in HELM_DIPOLE_KERNELS)

# }}}


# {{{ K24-K27: the traversal

TRAVERSAL_TREES = ["3d_uniform", "2d_clustered", "3d_restricted",
                   "3d_extent"]


def _assert_traversals_equal(got, ref):
    """Every field of two traversals equal, each list's BuiltList fields
    too, *got* on any device and *ref* on the CPU."""
    for f in dataclasses.fields(ref):
        if f.name == "tree":
            continue
        val, want = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "from_sep_smaller_by_level":
            assert len(val) == len(want)
            for a, b in zip(val, want):
                assert a.count == b.count, f.name
                assert a.num_nonempty_lists == b.num_nonempty_lists, f.name
                for part in ("starts", "lists", "nonempty_indices"):
                    assert torch.equal(getattr(a, part).cpu(),
                                       getattr(b, part)), f.name
        elif f.name == "target_boxes_sep_smaller_by_source_level":
            assert len(val) == len(want)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(val, want))
        elif isinstance(want, torch.Tensor):
            assert val.dtype == want.dtype, f.name
            assert torch.equal(val.cpu(), want), f.name
        else:
            assert val == want, f.name


def _cpu(trav):
    """*trav* with every tensor field on the CPU."""
    out = {}
    for f in dataclasses.fields(trav):
        val = getattr(trav, f.name)
        if f.name == "from_sep_smaller_by_level":
            val = tuple(dataclasses.replace(
                bl, starts=bl.starts.cpu(), lists=bl.lists.cpu(),
                nonempty_indices=bl.nonempty_indices.cpu()) for bl in val)
        elif f.name == "target_boxes_sep_smaller_by_source_level":
            val = tuple(v.cpu() for v in val)
        elif isinstance(val, torch.Tensor):
            val = val.cpu()
        out[f.name] = val
    return dataclasses.replace(trav, **out)


@pytest.fixture(scope="module", params=TRAVERSAL_TREES)
def traversal_tree(request, device):
    """``(tree, traversal, launches, cpu_tree)``: the tree on the card,
    the traversal built from it with its launch counts, and the same tree
    built on the CPU."""
    n = 20000
    kw = dict(max_particles_in_box=30)
    if request.param == "3d_uniform":
        src = np.random.default_rng(31).random((3, n))
    elif request.param == "2d_clustered":
        src = _clustered_2d(n)
    elif request.param == "3d_restricted":
        src = _capped_sphere(n)
        kw["kind"] = "adaptive-level-restricted"
    else:
        src, centres, radii = _qbx_inputs(n, 2000, 3)
        kw.update(targets=centres, target_radii=radii, stick_out_factor=0.25)
    kernels.reset_launch_counts()
    tree = build_tree(src, device=device, **kw)
    trav = build_traversal(tree)
    launches = kernels.launch_counts()
    return tree, trav, launches, build_tree(src, device="cpu", **kw)


@pytest.mark.parametrize("twin", ["neighbor_table", "row_lists_sl_l2",
                                  "lists_43", "list1"])
def test_traversal_kernel(traversal_tree, twin):
    """Each of K24-K27 equals its plain twin on the card, bit for bit."""
    (targs, tkw), inp = list_inputs(traversal_tree[0])
    if twin == "neighbor_table":
        got = [tops.neighbor_table(*targs, **tkw)]
        ref = [tops.neighbor_table_plain(*targs, **tkw)]
    else:
        got = getattr(tops, twin)(inp)
        ref = getattr(tops, f"{twin}_plain")(inp)
    if twin == "lists_43":
        got, ref = [*got[:2], *got[2]], [*ref[:2], *ref[2]]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.dtype == r.dtype
        assert torch.equal(g, r)


def test_traversal_on_card_matches_cpu(traversal_tree):
    """The traversal built on the card by K24-K27 equals the CPU port's,
    field by field."""
    tree, trav, _, cpu_tree = traversal_tree
    _assert_traversals_equal(trav, build_traversal(cpu_tree))


def test_plain_traversal_on_card_matches_kernels(traversal_tree):
    """The twins run on the card (what ``chip_smoke.py`` times beside the
    kernels) build the same traversal, and launch none of K24-K27."""
    tree, trav, _, _ = traversal_tree
    kernels.reset_launch_counts()
    plain = build_traversal(tree, _plain=True)
    counts = kernels.launch_counts()
    assert not any(counts[k] for k in ("neighbor_table", "row_lists_sl_l2",
                                       "lists_43", "list1")), counts
    _assert_traversals_equal(plain, _cpu(trav))


@pytest.mark.parametrize("dims,n,targets", [(3, 5, False), (2, 5, True),
                                             (3, 60, False)],
                         ids=["one_box_3d", "one_box_2d_targets",
                              "two_levels_3d"])
def test_traversal_small_trees_on_card(device, dims, n, targets):
    """K24-K27 on trees of one box and of two levels (the rows of level
    0 emit nothing, the root lists itself in List 1) equal the CPU
    port."""
    rng = np.random.default_rng(3)
    kw = dict(max_particles_in_box=30)
    if targets:
        kw["targets"] = rng.random((dims, 3))
    src = rng.random((dims, n))
    tree = build_tree(src, device=device, **kw)
    assert tree.nlevels == (1 if n < 30 else 2)
    _assert_traversals_equal(build_traversal(tree), build_traversal(
        build_tree(src, device="cpu", **kw)))


def test_traversal_launches_k24_to_k27(traversal_tree):
    """The traversal on the card launches K24 once a level and K25-K27
    (K26 only without target extents), a count and a fill pass each."""
    tree, _, launches, _ = traversal_tree
    assert launches["neighbor_table"] == tree.nlevels
    assert launches["row_lists_sl_l2"] == 2
    assert launches["list1"] == 2
    if tree.targets_have_extent:
        assert launches["lists_43"] == 0
    else:
        # the fill pass only where Lists 3 or 4 have entries
        assert launches["lists_43"] in (1, 2)

# }}}


# {{{ K35-K37: M2L, M2M and L2L

#: per coefficient column (the pairs' two lanes as one complex value):
#: float64 and complex128 sums in another order, float32 likewise
TRANSLATE_RTOL = {torch.complex128: 1e-12, torch.float64: 1e-12,
                  torch.float32: 1e-5}
#: the same at order 31 (the line): dot products of 1,024 complex or 2,048
#: real terms, against 33-338 on the paths above, summed in another order;
#: the float64 pairs' M2L columns lie 2.1e-12 apart
LINE_TRANSLATE_RTOL = 1e-11
TRANSLATE_CASES = ["l3d_c128", "l3d_f64", "l3d_f32", "l3d_l2o", "h3d",
                   "h2d", "l2d_c128", "l2d_f64", "l2d_f32", "line_c128",
                   "line_f64"]


def _line_3d(device, nsources=30):
    """``tests/test_stability.py``'s geometric line in 3D (17 levels)."""
    line = np.array([2.0 ** -i for i in range(nsources // 2)])
    line = np.hstack([line, 3 - line])
    zero = np.zeros(nsources)
    src = np.vstack([line, zero, zero])
    tgt = src * (1 + 1e-3)
    tree = build_tree(torch.as_tensor(src, device=device),
                      targets=torch.as_tensor(tgt, device=device),
                      max_particles_in_box=2)
    return src, tgt, build_traversal(tree)


@pytest.fixture(scope="module")
def line_tree(device):
    return _line_3d(device)


@pytest.fixture(scope="module", params=TRANSLATE_CASES)
def translate_case(request, device, line_tree):
    """A wrangler of each path's kind (3D Laplace with dipoles in three
    entry points and with ``level_to_order``, 3D and 2D Helmholtz, 2D
    Laplace in three, the order-31 line at K = 1024 complex and 2048
    pairs) and tree-order charges in its dtype."""
    case = request.param
    rng = np.random.default_rng(31)
    if case.startswith("l3d"):
        src = torch.as_tensor(_sphere(20000, 15), device=device)
        trav = build_traversal(build_tree(src, max_particles_in_box=30))
        kw = ({"level_to_order": lambda lev: 8 - min(lev, 4),
               "pairs": True} if case == "l3d_l2o" else
              {"order": 8, "pairs": case != "l3d_c128",
               "dtype": L3D_KINDS[case[4:]][1]})
        w = make_laplace_wrangler(trav, rscale="auto", dipole_vec=src, **kw)
    elif case == "h3d":
        trav = build_traversal(build_tree(torch.as_tensor(
            _sphere(20000), device=device), max_particles_in_box=30))
        w = make_helmholtz_wrangler(trav, 2.0, 12, rscale="auto",
                                    pairs=False)
    elif case == "h2d":
        trav = build_traversal(build_tree(torch.as_tensor(
            _clustered_2d(20000), device=device), max_particles_in_box=30))
        w = make_helmholtz_wrangler(trav, 3.0, 16, rscale="auto",
                                    pairs=False)
    elif case.startswith("l2d"):
        trav = build_traversal(build_tree(torch.as_tensor(
            _clustered_laplace(20000), device=device),
            max_particles_in_box=20))
        pairs, dt = L2D_KINDS[case[4:]]
        w = make_laplace_wrangler(trav, 20, pairs=pairs, dtype=dt,
                                  rscale="auto")
    else:
        w = make_laplace_wrangler(line_tree[2], 31, rscale="auto",
                                  pairs=case == "line_f64",
                                  dtype=(torch.float64 if case == "line_f64"
                                         else torch.complex128))
    q = torch.as_tensor(rng.standard_normal(w.tree.nsources),
                        device=device)
    return case, w, w.reorder_sources(q), q


def _translate_rtol(case, w):
    return (LINE_TRANSLATE_RTOL if case.startswith("line")
            else TRANSLATE_RTOL[w.dtype])


def _coef_rel(got, ref):
    """Worst coefficient column, the pairs' two lanes as one complex
    coefficient (an ``m = 0`` imaginary lane is zero but for rounding);
    a column that is zero in *ref* must be zero in *got*."""
    if not ref.is_complex():
        k = ref.shape[1] // 2
        got, ref = (torch.complex(x[:, :k].double(), x[:, k:].double())
                    for x in (got, ref))
    return _zero_safe_cols_rel(got, ref)


def test_m2l_translate_kernel(translate_case):
    """K35 (one launch, every level) against its twin, the edge form, on
    the M2M output of the wrangler's own kernels."""
    case, w, q_tree, _ = translate_case
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                            [q_tree]))
    kernels.reset_launch_counts()
    got = tops_translate.m2l_translate(mp, w._m2l_plan)
    assert kernels.launch_counts()["m2l_translate"] == 1
    ref = tops_translate.m2l_translate_plain(mp, w._m2l_plan)
    assert ref.abs().max() > 0
    assert _coef_rel(got, ref) <= _translate_rtol(case, w), case


def test_m2m_translate_kernel(translate_case):
    """K36, level by level bottom-up, against its twin."""
    case, w, q_tree, _ = translate_case
    mp = w.form_multipoles(None, None, [q_tree])
    got, ref = mp.clone(), mp.clone()
    lsb = w._lsb
    for lev in range(w.tree.nlevels - 1, 2, -1):
        args = (w._m2m_opsT[lev], w._child, lsb[lev - 1],
                lsb[lev] - lsb[lev - 1])
        tops_translate.m2m_translate(got, *args)
        tops_translate.m2m_translate_plain(ref, *args)
    assert _coef_rel(got, ref) <= _translate_rtol(case, w), case


def test_l2l_translate_kernel(translate_case):
    """K37, level by level top-down, against its twin, on the M2L output
    plus P2L's."""
    case, w, q_tree, _ = translate_case
    trav = w.traversal
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                            [q_tree]))
    loc = w.form_locals(None, trav.target_or_target_parent_boxes,
                        trav.from_sep_bigger_starts,
                        trav.from_sep_bigger_lists, [q_tree],
                        tops_translate.m2l_translate(mp, w._m2l_plan))
    got, ref = loc.clone(), loc.clone()
    for lev in range(1, w.tree.nlevels):
        args = (w._l2l_opsT[lev], w._l2l_rows[lev], w._tgt_child)
        tops_translate.l2l_translate(got, *args)
        tops_translate.l2l_translate_plain(ref, *args)
    assert _coef_rel(got, ref) <= _translate_rtol(case, w), case


def test_translate_launches_per_fmm(translate_case):
    """An FMM launches K35 once, K36 once a level from the finest up to
    level 3, K37 once a level with target-or-target-parent parents."""
    case, w, _, q = translate_case
    kernels.reset_launch_counts()
    drive_fmm(w, [q])
    got = {k: v for k, v in kernels.launch_counts().items()
           if "translate" in k}
    nlevels = w.tree.nlevels
    want = {"m2l_translate": 1,
            "m2m_translate": max(0, nlevels - 3),
            "l2l_translate": sum(w._l2l_rows[lev].numel() > 0
                                 for lev in range(1, nlevels))}
    assert got == want, case


def test_line_tree_order31_on_card(line_tree):
    """``tests/test_stability.py:28``'s (3, 31) case on the card, through
    K28, K30 and K35-K37 at 1,024 coefficients a row: within the
    reference's bar (3/4)^32 of a direct sum, the M2L table ~0.18 GB."""
    src, tgt, trav = line_tree
    w = make_laplace_wrangler(trav, 31, rscale="auto", pairs=False)
    kernels.reset_launch_counts()
    pot = drive_fmm(w, [torch.ones(src.shape[1], dtype=torch.float64,
                                   device=trav.tree.sources.device)])
    launches = kernels.launch_counts()
    for name in ("p2m_laplace3d", "l2p_laplace3d", "m2l_translate"):
        assert launches[name] == 1, name
    assert w._m2l_plan.nbytes == len(w._m2l_plan.used) * 1024 ** 2 * 16
    pot = pot.real.cpu().numpy()
    diff = src[:, None, :] - tgt[:, :, None]
    ref = (1 / np.sqrt((diff * diff).sum(0))).sum(1)
    assert np.abs(pot - ref).max() / np.abs(ref).max() < 0.75 ** 32


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float16])
def test_translate_wrappers_refuse_dtypes(translate_case, dtype):
    _, w, q_tree, _ = translate_case
    mp = w.form_multipoles(None, None, [q_tree]).to(dtype)
    with pytest.raises(TypeError):
        tops_translate.m2l_translate(mp, w._m2l_plan)
    with pytest.raises(TypeError):
        tops_translate.m2m_translate(mp, w._m2m_opsT[3], w._child, 0, 1)
    with pytest.raises(TypeError):
        tops_translate.l2l_translate(mp, w._l2l_opsT[2], w._l2l_rows[2],
                                     w._tgt_child)

# }}}


# {{{ K43-K46: the tree build

TREE_BUILD_CASES = [*TRAVERSAL_TREES, "3d_nonadaptive", "2d_weights",
                    "3d_bbox_f32"]


def _tree_build_case(name, n=20000):
    """``(sources, build_tree keywords)`` of a tree of the traversal
    cases, or a non-adaptive, a weighted (zero weights included) or a
    given-bbox float32 one."""
    rng = np.random.default_rng(31)
    kw = dict(max_particles_in_box=30)
    if name == "3d_uniform":
        src = rng.random((3, n))
    elif name == "2d_clustered":
        src = _clustered_2d(n)
    elif name == "3d_restricted":
        src = _capped_sphere(n)
        kw["kind"] = "adaptive-level-restricted"
    elif name == "3d_extent":
        src, centres, radii = _qbx_inputs(n, 2000, 3)
        kw.update(targets=centres, target_radii=radii, stick_out_factor=0.25)
    elif name == "3d_nonadaptive":
        src = rng.random((3, n))
        kw["kind"] = "non-adaptive"
    elif name == "2d_weights":
        src = _clustered_2d(n)
        kw = dict(refine_weights=rng.integers(0, 10, n).astype(np.int32),
                  max_leaf_refine_weight=150)
    else:
        src = rng.random((3, n), dtype=np.float32)
        kw["bbox"] = np.array([[-0.25, 1.25]] * 3)
    return src, kw


def _build_inputs(src, kw, device):
    """What ``build_tree`` hands phase A (merged coordinates and the
    keywords of ``_phase_a`` at the depth of its first try) and K43's
    arguments from there: ``(merged, phase_a_kw, k43_args, k43_kw)``."""
    from boxtree_torch.tree.build import _build_inputs, _sort_keys

    inp = _build_inputs(src, device=device, **kw)
    codes_s, _, w_s, stick_s, _, _ = _sort_keys(inp.merged, **inp.keys)
    return (inp.merged, dict(inp.keys, adaptive=inp.adaptive,
                             max_weight=inp.max_weight),
            (codes_s, w_s, stick_s, inp.max_weight),
            dict(dimensions=inp.keys["dimensions"], depth=inp.keys["depth"],
                 adaptive=inp.adaptive))


@pytest.fixture(scope="module", params=TREE_BUILD_CASES)
def tree_build(request, device):
    """``(name, sources, keywords, tree, launches)``: a tree built on the
    card and the kernels its build launched."""
    src, kw = _tree_build_case(request.param)
    kernels.reset_launch_counts()
    tree = build_tree(src, device=device, **kw)
    return request.param, src, kw, tree, kernels.launch_counts()


def test_tree_build_on_card_matches_cpu(tree_build):
    """K43-K46 build the tree on the card equal to the CPU build (the
    twins), field by field, centres bit for bit."""
    _, src, kw, tree, _ = tree_build
    ref = build_tree(src, device="cpu", **kw)
    for f in dataclasses.fields(ref):
        val, want = getattr(tree, f.name), getattr(ref, f.name)
        if isinstance(want, torch.Tensor):
            assert val.device.type == "cuda", f.name
            assert val.dtype == want.dtype, f.name
            assert torch.equal(val.cpu(), want), f.name
        else:
            assert val == want, f.name


def test_tree_build_launches(tree_build):
    """One K43 launch per depth tried (one here), K44 once a level; the
    restricted build K45 once a level below the deepest a round (with K5
    once a level from 2 up) and K46 once; no other build launches K45 or
    K46."""
    name, _, _, tree, launches = tree_build
    assert launches["tree_leaf_levels"] == 1
    assert launches["tree_level_boxes"] == tree.nlevels
    if name == "3d_restricted":
        max_level = tree.nlevels - 1
        rounds = launches["restrict_sweep"] // max_level
        assert rounds >= 2
        assert launches["restrict_sweep"] == rounds * max_level
        assert launches["restrict_demand"] == rounds * (max_level - 1)
        assert launches["level_box_counts"] == 1
    else:
        assert launches["restrict_sweep"] == launches["restrict_demand"] \
            == launches["level_box_counts"] == 0


def test_leaf_levels_kernel(tree_build, device):
    """K43 equals its twin on the card: leaf levels and the packed counts,
    unfit count and level used."""
    _, src, kw, _, _ = tree_build
    _, _, args, opts = _build_inputs(src, kw, device)
    got = tree_ops.leaf_levels(*args, **opts)
    ref = tree_ops.leaf_levels_plain(*args, **opts)
    assert got[0].device.type == "cuda"
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_level_boxes_kernel(tree_build, device):
    """Phase B with K44 equals phase B with its twin on the card, every
    array bit for bit, and the tree's own arrays."""
    from boxtree_torch.tree.build import _phase_b

    name, src, kw, tree, _ = tree_build
    merged, akw, _, _ = _build_inputs(src, kw, device)
    max_weight = akw.pop("max_weight")
    (codes_s, order, leaf, counts, n_unfit, bmin, root) = _phase_a(
        merged, max_weight, **akw)
    assert n_unfit == 0
    if name == "3d_restricted":
        leaf, counts, _ = restrict_leaf_levels(
            codes_s, leaf, dimensions=3, depth=akw["depth"],
            max_level=int(torch.nonzero(counts)[-1, 0]))
        counts = counts.cpu()
    nlevels = int(torch.nonzero(counts)[-1, 0]) + 1
    lsb = tuple(int(x) for x in torch.cat([
        counts.new_zeros(1), torch.cumsum(counts[:nlevels], 0)]))
    assert lsb == tree.level_start_box_nrs
    nsrc = src.shape[1]
    bkw = dict(dimensions=akw["dimensions"], depth=akw["depth"],
               level_starts=lsb, nsources=nsrc,
               ntargets=merged.shape[1] - nsrc if "targets" in kw else nsrc,
               sources_are_targets="targets" not in kw,
               has_extents=akw["radii"] is not None)
    got = _phase_b(codes_s, order, leaf, merged, bmin, root, **bkw)
    ref = _phase_b(codes_s, order, leaf, merged, bmin, root, plain=True,
                   **bkw)
    for key, val in ref.items():
        assert got[key].dtype == val.dtype, key
        assert torch.equal(got[key], val), key
    assert torch.equal(got["box_centers"], tree.box_centers)


def test_restriction_kernels(device):
    """K45 (one sweep at each level) and K46 equal their twins on the
    card, and the restriction with K5, K45 and K46 equals the one with the
    twins: leaf levels, counts and rounds."""
    from boxtree_torch.tree.level_restrict import consistency_sweep

    src, kw = _tree_build_case("3d_restricted")
    _, _, args, opts = _build_inputs(src, kw, device)
    codes_s = args[0]
    leaf, packed = tree_ops.leaf_levels(*args, **opts)
    max_level = int(torch.nonzero(packed[:-2])[-1, 0])
    depth = opts["depth"]
    lev = leaf
    for m in range(max_level, 1, -1):
        lev = restrict.demand_pass(codes_s, lev, m=m, dimensions=3,
                                   depth=depth)
    for t in range(max_level):
        got = restrict.sweep(codes_s, lev, t=t, dimensions=3, depth=depth)
        ref = restrict.sweep_plain(codes_s, lev, t=t, dimensions=3,
                                   depth=depth)
        assert torch.equal(got, ref), t
        lev = ref
    assert torch.equal(
        consistency_sweep(codes_s, leaf, dimensions=3, depth=depth,
                          max_level=max_level),
        consistency_sweep(codes_s, leaf, dimensions=3, depth=depth,
                          max_level=max_level, plain=True))
    got = restrict_leaf_levels(codes_s, leaf, dimensions=3, depth=depth,
                               max_level=max_level)
    ref = restrict_leaf_levels(codes_s, leaf, dimensions=3, depth=depth,
                               max_level=max_level, plain=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[2] == ref[2] >= 2
    for lv in (leaf, got[0]):
        assert torch.equal(
            tree_ops.level_box_counts(codes_s, lv, dimensions=3, depth=depth,
                                      max_level=max_level),
            tree_ops.level_box_counts_plain(codes_s, lv, dimensions=3,
                                            depth=depth,
                                            max_level=max_level))


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_leaf_levels_kernel_edges(device, dims):
    """K43 on coincident points (every particle unfit, adaptive and
    non-adaptive), on one box, and at the full depth of 1D (62 levels,
    keys up to 2^62), against its twin."""
    from boxtree_torch import config

    depth = config.max_morton_depth(dims)
    rng = np.random.default_rng(dims)
    cases = [torch.zeros(40, dtype=torch.int64, device=device),
             torch.sort(torch.as_tensor(rng.integers(
                 0, 1 << (dims * depth), 4000), device=device)).values]
    for codes in cases:
        for adaptive in (True, False):
            for w in (None, torch.as_tensor(rng.integers(
                    0, 4, codes.shape[0]), device=device)):
                got = tree_ops.leaf_levels(codes, w, None, 30,
                                           dimensions=dims, depth=depth,
                                           adaptive=adaptive)
                ref = tree_ops.leaf_levels_plain(codes, w, None, 30,
                                                 dimensions=dims,
                                                 depth=depth,
                                                 adaptive=adaptive)
                assert torch.equal(got[0], ref[0])
                assert torch.equal(got[1], ref[1])
    one = tree_ops.leaf_levels(cases[1][:5], None, None, 30,
                               dimensions=dims, depth=depth)
    assert int(one[0].max()) == 0 and int(one[1][0]) == 1


def test_tree_wrappers_on_cpu_take_twins():
    """On CPU tensors the wrappers run their twins and launch nothing."""
    kernels.reset_launch_counts()
    pts = torch.as_tensor(np.random.default_rng(0).random((3, 500)))
    build_tree(pts, kind="adaptive-level-restricted",
               max_particles_in_box=10)
    counts = kernels.launch_counts()
    assert not any(counts.values()), counts

# }}}


# {{{ K69-K74: the M2L tables; K75-K79: the rotation M2L

from boxtree_torch.ops import m2l_ops  # noqa: E402
from boxtree_torch.ops import rotation as rot_ops  # noqa: E402

TABLE_RTOL = {torch.complex128: 1e-12, torch.float64: 1e-12,
              torch.float32: 1e-6}
ROT_RTOL = {torch.complex128: 1e-12, torch.float64: 1e-12,
            torch.float32: 1e-5}
TABLE_DTYPES = [torch.complex128, torch.float64, torch.float32]


def _table_inputs(dim, rscale, seed=3, levels=(2, 3, 4, 6)):
    classes = _offsets(dim, 3, min_inf_norm=1)
    rng = np.random.default_rng(seed)
    ts, rs, lv = [], [], []
    for lev in levels:
        used = np.sort(rng.choice(len(classes), len(classes) // 3,
                                  replace=False))
        size = 1.0001 / (1 << lev)
        ts.append(classes[used] * size)
        rs += [min(size, 1.0) if rscale else 1.0] * len(used)
        lv += [lev] * len(used)
    return np.concatenate(ts).astype(np.float64), np.array(rs), np.array(lv)


def _op_rel_t(got, ref):
    """Worst operator of max |got - ref| / max |ref| over (n, K, K)."""
    if not ref.is_complex():
        got, ref = got.double(), ref.double()
    err = (got - ref).abs().amax(dim=(1, 2))
    return (err / ref.abs().amax(dim=(1, 2))).max().item()


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("rscale", [False, True])
@pytest.mark.parametrize("dtype", TABLE_DTYPES)
@pytest.mark.parametrize("dim", [2, 3])
def test_m2l_table_kernel(device, dim, dtype, rscale, truncate):
    """K69-K74 against their twins per operator, with rscale 1 and below
    1 and with a level_to_order mask (masked entries exactly 0).  With
    rscale 1 the levels stop at 3: deeper, float32 overflows (|t| below
    1/4 raised to the -2p-1)."""
    ts, rs, levels = _table_inputs(
        dim, rscale, levels=(2, 3, 4, 6) if rscale else (2, 3))
    p = 8 if dim == 3 else 20
    lo = np.array([p, p, p, p - 1, p - 2, p - 3, p - 4]) if truncate else None
    fn, plain = ((m2l_ops.m2l_table_3d, m2l_ops.m2l_table_3d_plain)
                 if dim == 3 else
                 (m2l_ops.m2l_table_2d, m2l_ops.m2l_table_2d_plain))
    kernels.reset_launch_counts()
    got = fn(ts, rs, levels, p, dtype, device, lo)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[f"m2l_table_{dim}d"] == 1
    ref = plain(ts, rs, levels, p, dtype, device, lo)
    assert bool(torch.isfinite(ref).all())
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.equal(got == 0, ref == 0)
    assert _op_rel_t(got, ref) <= TABLE_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.complex128, torch.float64])
def test_m2l_table_kernel_order31(device, dtype):
    """K69 / K70 at the order-31 line's width: the order-62 basis (63.5
    KB of shared memory), the operators split over CTAs."""
    ts, rs, levels = _table_inputs(3, True, levels=(2, 9))
    ts, rs, levels = ts[::40], rs[::40], levels[::40]
    got = m2l_ops.m2l_table_3d(ts, rs, levels, 31, dtype, device)
    ref = m2l_ops.m2l_table_3d_plain(ts, rs, levels, 31, dtype, device)
    assert got.shape == (len(ts),) + (ref.shape[1],) * 2
    assert _op_rel_t(got, ref) <= 1e-12


def test_m2l_table_refuses_large_order(device):
    ts, rs, levels = _table_inputs(3, False, levels=(2,))
    with pytest.raises(ValueError, match="shared memory"):
        m2l_ops.m2l_table_3d(ts, rs, levels, 60, torch.float64, device)


@pytest.mark.parametrize("dim", [2, 3])
def test_m2l_table_once_per_setup(device, dim):
    """A Laplace wrangler on the card builds its table in one launch."""
    rng = np.random.default_rng(4)
    trav = build_traversal(build_tree(torch.as_tensor(
        rng.random((dim, 20000)), device=device), max_particles_in_box=20))
    for kw in (dict(pairs=True), dict(pairs=False),
               dict(pairs=True, dtype=torch.float32, rscale="auto")):
        kernels.reset_launch_counts()
        w = make_laplace_wrangler(trav, 6, **kw)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts[f"m2l_table_{dim}d"] == 1
        assert counts[f"m2l_table_{5 - dim}d"] == 0
        ref = m2l_ops.m2l_table_3d_plain if dim == 3 else \
            m2l_ops.m2l_table_2d_plain
        assert _op_rel_t(w._m2l_opsT, ref(*w._m2l_table_args, 6, w.dtype,
                                          device)) <= TABLE_RTOL[w.dtype]


@pytest.fixture(scope="module")
def rotation_tree(device):
    """A 3D tree whose operator groups run from a few edges to hundreds
    (many across tile boundaries), with sources on a sphere and in a
    cube."""
    rng = np.random.default_rng(21)
    pts = np.hstack([rng.random((3, 20000)), 0.5 + 0.3 * _sphere(10000)])
    return build_traversal(build_tree(torch.as_tensor(pts, device=device),
                                      max_particles_in_box=20))


def test_classify_kernels(rotation_tree):
    """K75 / K76 against their twin: boxes and histogram exactly equal."""
    trav = rotation_tree
    tree = trav.tree
    offs = _offsets(3, 3, min_inf_norm=1)
    table = np.full(7 ** 3, -1, np.int64)
    table[(offs + 3) @ (7 ** np.arange(3))] = np.arange(len(offs))
    args = (tree.box_morton_prefixes, tree.box_levels.to(torch.int32),
            trav.from_sep_siblings_starts, trav.from_sep_siblings_lists,
            trav.target_or_target_parent_boxes,
            torch.as_tensor(table, device=tree.box_levels.device))
    kw = dict(dim=3, radius=3, nclasses=len(offs),
              npossible=tree.nlevels * len(offs))
    kernels.reset_launch_counts()
    got = rot_ops.classify_edges(*args, **kw)
    counts = kernels.launch_counts()
    assert counts["m2l_classify_keys"] == counts["m2l_classify_unpack"] == 1
    ref = rot_ops.classify_edges_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert int(got[2][-1]) == 0 and int(got[2].sum()) == got[0].shape[0]


@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("dtype", TABLE_DTYPES)
def test_rotation_kernel(rotation_tree, dtype, order):
    """K77-K79 against their twin, rel l-inf over the locals, on random
    multipoles; a tile never spans two operators."""
    pairs = not dtype.is_complex
    w = make_laplace_wrangler(rotation_tree, order, pairs=pairs, dtype=dtype,
                              rscale="auto", m2l_mode="rotation")
    sizes = w.m2l_plan.edges.sizes
    tile = rot_ops.tile_edges((order + 1) ** 2, dtype)
    assert (sizes > tile).any() and ((sizes > 0) & (sizes < tile)).any()
    g = torch.Generator(device="cpu").manual_seed(5)
    mp = torch.randn((rotation_tree.tree.nboxes, w.ncoeff), generator=g,
                     dtype=torch.float64)
    if dtype.is_complex:
        mp = torch.complex(mp, torch.randn(mp.shape, generator=g,
                                           dtype=torch.float64))
    mp = mp.to(dtype).to(rotation_tree.tree.box_levels.device)
    kernels.reset_launch_counts()
    got = rot_ops.m2l_rotation(mp, w.m2l_plan.edges, w._m2l_rot.blocks)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["m2l_rotate"] == 1
    ref = rot_ops.m2l_rotation_plain(mp, w.m2l_plan.edges, w._m2l_rot.blocks)
    assert _rel(got, ref) <= ROT_RTOL[dtype]


@pytest.mark.parametrize("dtype", TABLE_DTYPES)
def test_rotation_fmm_on_card(rotation_tree, dtype):
    """The rotation FMM on the card: K77-K79 once, no K35, against the
    dense FMM of the same layout on the card (complex128 and float64
    1e-12; float32 1e-5: on the CPU the two float32 FMMs of this tree
    agree to 6.5e-8, and each is 1.8e-4 from the complex128 one)."""
    trav = rotation_tree
    n = trav.tree.nsources
    q = torch.as_tensor(np.random.default_rng(6).standard_normal(n),
                        device=trav.tree.box_levels.device)
    kw = dict(pairs=not dtype.is_complex, dtype=dtype, rscale="auto")
    q = q.to(dtype.to_real())
    ref = drive_fmm(make_laplace_wrangler(trav, 6, **kw), [q])
    w = make_laplace_wrangler(trav, 6, m2l_mode="rotation", **kw)
    kernels.reset_launch_counts()
    pot = drive_fmm(w, [q])
    counts = kernels.launch_counts()
    assert counts["m2l_rotate"] == 1 and counts["m2l_translate"] == 0
    err = _rel(pot, ref)
    assert err <= (1e-5 if dtype == torch.float32 else 1e-12), err

# }}}


# {{{ the distributed FMM: K80-K82 and the runner on the card

EXCHANGE_DTYPES = [torch.float32, torch.float64, torch.complex128]


def _exchange_rows(shape, dtype, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(shape, generator=g,
                                         dtype=torch.float64))
    return x.to(dtype).to(device)


def _exchange_index(nboxes, n, seed, device):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(nboxes)[:n].astype(np.int32)
    idx[rng.random(n) < 0.25] = -1
    idx[-5:] = -1
    return torch.as_tensor(idx, device=device)


@pytest.mark.parametrize("trail", [(), (2,), (162,)],
                         ids=["scalar", "pair", "k162"])
@pytest.mark.parametrize("dtype", EXCHANGE_DTYPES, ids=str)
def test_exchange_kernels(device, dtype, trail):
    """K80-K82 equal their twins exactly (they only move and add values),
    with -1 entries, both unpack ops, masked and unmasked merges; each
    wrapper launches its kernel once."""
    from boxtree_torch.ops import exchange
    nboxes, n = 5000, 3000
    mp = _exchange_rows((nboxes, *trail), dtype, 1, device)
    idx = _exchange_index(nboxes, n, 2, device)
    kernels.reset_launch_counts()
    got = exchange.pack_rows(mp, idx)
    assert torch.equal(got, exchange.pack_rows_plain(mp, idx))
    recv = _exchange_rows((n, *trail), dtype, 3, device)
    for op in ("add", "set"):
        assert torch.equal(
            exchange.unpack_rows(mp.clone(), idx, recv, op),
            exchange.unpack_rows_plain(mp.clone(), idx, recv, op))
    box_map = torch.as_tensor(np.random.default_rng(4).integers(
        0, 700, nboxes).astype(np.int32), device=device)
    keep = torch.as_tensor(np.random.default_rng(5).random(700) < 0.4,
                           device=device)
    x = _exchange_rows((nboxes, *trail), dtype, 6, device)
    for args in ((keep, box_map), ()):
        assert torch.equal(
            exchange.masked_merge(mp.clone(), x, *args),
            exchange.masked_merge_plain(mp.clone(), x, *args))
    counts = kernels.launch_counts()
    assert (counts["pack_rows"], counts["unpack_rows"],
            counts["masked_merge"]) == (1, 2, 2)


def test_exchange_kernels_empty(device):
    from boxtree_torch.ops import exchange
    mp = torch.zeros((4, 3), device=device)
    idx = torch.zeros(0, dtype=torch.int32, device=device)
    assert exchange.pack_rows(mp, idx).shape == (0, 3)
    exchange.unpack_rows(mp, idx, torch.zeros((0, 3), device=device), "add")
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def distributed_case(device):
    rng = np.random.default_rng(31)
    pts = rng.random((3, 30000))
    trav = build_traversal(build_tree(torch.as_tensor(pts, device=device),
                                      max_particles_in_box=30))
    return trav, torch.as_tensor(rng.standard_normal(30000), device=device)


@pytest.mark.parametrize("nranks,communicate_mpoles", [
    (4, "hypercube"), (3, "hypercube"), (4, "allreduce")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_distributed_fmm_on_card(distributed_case, dtype, nranks,
                                 communicate_mpoles):
    """The runner on the card against the single-device FMM on the same
    traversal (float64 1e-12, float32 1e-5: the partial multipoles sum in
    another order), launching K80-K82 (the allreduce K82 alone); every
    rank's List-2 edges fewer than the traversal's; the counting runner
    exact."""
    from boxtree_torch.parallel import DistributedFMMRunner
    trav, q = distributed_case
    q = q.to(dtype)

    def factory(t):
        return make_laplace_wrangler(t, 6, pairs=True, dtype=dtype,
                                     rscale="auto")

    ref = drive_fmm(factory(trav), [q])
    runner = DistributedFMMRunner(nranks, trav, wrangler_factory=factory,
                                  communicate_mpoles=communicate_mpoles)
    assert runner.placement == {"cuda:0": list(range(nranks))} or \
        torch.cuda.device_count() > 1
    kernels.reset_launch_counts()
    pot = runner.drive_dfmm(q)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    hyper = communicate_mpoles == "hypercube"
    assert (counts["pack_rows"] > 0) == hyper
    assert (counts["unpack_rows"] > 0) == hyper
    assert counts["masked_merge"] >= 2 * nranks
    assert counts["m2l_translate"] == nranks
    assert max(runner.list2_pairs) < trav.from_sep_siblings_lists.shape[0]
    assert _rel(pot, ref) <= (1e-5 if dtype == torch.float32 else 1e-12)
    n = trav.tree.nsources
    count = DistributedFMMRunner(nranks, trav,
                                 communicate_mpoles=communicate_mpoles
                                 ).drive_dfmm(torch.ones(n, device=q.device))
    assert (count == n).all()

# }}}


# {{{ the sharded tree build: K83-K88

def _shard_mesh(nranks, device):
    from boxtree_torch.parallel.mesh import Mesh
    return Mesh([device] * nranks)


def _clustered_points(dims, n, seed, width=0.05):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.random((dims, n // 2)) * width,
                           rng.random((dims, n // 2))], axis=1)


def test_shard_pack_and_permute_kernels(device):
    """K83-K86 equal their twins exactly: buckets empty, short and
    overflowing, payload offsets, pads, float32 and float64 rows; each
    wrapper launches its kernel once."""
    from boxtree_torch.ops import shard
    rng = np.random.default_rng(7)
    per, nb, cap = 20000, 8, 3000
    local = torch.as_tensor(np.sort(rng.integers(0, 1 << 40, per)),
                            device=device)
    vals = torch.as_tensor(rng.integers(0, 1 << 30, (2, per)), device=device)
    cuts = np.sort(rng.integers(0, per, nb - 1))
    cuts[2] = cuts[1]                                  # an empty bucket
    cuts[5] = cuts[4] + cap + 7                        # an overflowing one
    starts = torch.as_tensor(np.r_[0, np.sort(cuts), per], device=device)
    kernels.reset_launch_counts()
    got = shard.bucket_pack(local, vals, starts, cap, val_offset=12345)
    want = shard.bucket_pack_plain(local, vals, starts, cap,
                                   val_offset=12345)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[2][0]) == 1
    # segments of two source buffers into one shard, a gap left as PAD
    a = torch.as_tensor(rng.integers(0, 99, 5000), device=device)
    b = torch.as_tensor(rng.integers(0, 99, 3000), device=device)
    segs = [(100, 0, 4000, a, [a + 1]), (0, 4010, 2990, b, [b + 2])]
    got = shard.rebalance_place(segs, 7000, 1)
    want = shard.rebalance_place_plain(segs, 7000, 1)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    for dtype in (torch.float32, torch.float64):
        data = torch.as_tensor(rng.standard_normal((per, 3)), dtype=dtype,
                               device=device)
        slots = per // nb
        perm = rng.permutation(per)
        got_o = torch.as_tensor(perm.reshape(nb, slots) + 5 * per,
                                device=device)
        got_o[got_o % 7 == 0] = shard.PAD
        got_s = torch.as_tensor(rng.integers(0, 1 << 20, (nb, slots)),
                                device=device)
        got = shard.permute_serve(got_o, got_s, data, 5 * per)
        want = shard.permute_serve_plain(got_o, got_s, data, 5 * per)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        reply = torch.as_tensor(rng.standard_normal((nb, cap, 3)),
                                dtype=dtype, device=device)
        lens = np.full(nb, per // nb)
        lens[1], lens[2] = lens[1] + lens[2], 0
        ust = torch.as_tensor(np.r_[0, np.cumsum(lens)], device=device)
        j_sorted = torch.as_tensor(rng.permutation(per), device=device)
        assert torch.equal(shard.permute_unpack(reply, ust, j_sorted),
                           shard.permute_unpack_plain(reply, ust, j_sorted))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["bucket_pack"], counts["rebalance_place"],
            counts["permute_serve"], counts["permute_unpack"]) == (1, 1, 2, 2)


@pytest.mark.parametrize("dims,weighted", [(3, False), (2, True)])
def test_shard_leaf_levels_kernel(device, dims, weighted):
    """K87 equals its twin on every rank of 8: clustered points, so boxes
    span several shards, with and without refine weights; the ranks'
    summed counts equal K43's on the whole."""
    from boxtree_torch import config
    from boxtree_torch.ops import shard
    from boxtree_torch.parallel.shard_build import sharded_morton_codes
    n = 1 << 16
    mesh = _shard_mesh(8, device)
    depth = config.max_morton_depth(dims)
    codes, _, _ = sharded_morton_codes(
        torch.as_tensor(_clustered_points(dims, n, 5), device=device), mesh,
        depth=depth)
    codes = torch.sort(torch.cat(codes)).values
    w = (torch.as_tensor(np.random.default_rng(1).integers(1, 4, n),
                         device=device) if weighted else None)
    per = n // 8
    cs = [codes[r * per:(r + 1) * per] for r in range(8)]
    cw = [shard.cumulative_weights(w[r * per:(r + 1) * per])
          if weighted else None for r in range(8)]
    masks = shard.level_masks(dims, depth, device)
    summ = torch.stack([shard.leaf_summary(c, x, masks)
                        for c, x in zip(cs, cw)])
    total = 0
    for r in range(8):
        got = shard.shard_leaf_levels(cs[r], cw[r], summ, r, 30,
                                      dimensions=dims, depth=depth)
        want = shard.shard_leaf_levels_plain(cs[r], cw[r], summ, r, 30,
                                             dimensions=dims, depth=depth)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), r
        total = total + got[1]
    _, packed = tree_ops.leaf_levels(codes, w, None, 30, dimensions=dims,
                                     depth=depth)
    assert torch.equal(total, packed[:depth + 3])


@pytest.mark.parametrize("nranks", [4, 8])
def test_sharded_build_on_card(device, nranks):
    """The sharded build on the card: its box skeleton (K88 a rank a
    level) equals the CPU twins', its tree equals ``build_tree``'s on the
    card field for field (centres bit for bit), K83-K88 are launched as
    the design says, and the counting FMM on it is exact."""
    import dataclasses

    from boxtree_torch.parallel.shard_build import sharded_build_tree
    from boxtree_torch.parallel.mesh import Mesh
    pts = _clustered_points(3, 1 << 16, 9)
    kernels.reset_launch_counts()
    info = {}
    tree, skel = sharded_build_tree(torch.as_tensor(pts, device=device),
                                    _shard_mesh(nranks, device),
                                    max_particles_in_box=30,
                                    return_skeleton=True, timing_data=info)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    _, skel_cpu = sharded_build_tree(torch.as_tensor(pts),
                                     Mesh.of_ranks(nranks, "cpu"),
                                     max_particles_in_box=30,
                                     return_skeleton=True)
    for key in skel:
        for a, b in zip(skel[key], skel_cpu[key]):
            assert torch.equal(a.cpu(), b), key
    ref = build_tree(torch.as_tensor(pts, device=device),
                     max_particles_in_box=30)
    for f in dataclasses.fields(ref):
        a, b = getattr(tree, f.name), getattr(ref, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    # one launch a rank a try of the sort and of the permutation; a
    # clustered input retries at twice the capacity factor
    tries = sum(int(np.log2(info[k] / 2.0)) + 1
                for k in ("capacity_factor", "permute_capacity_factor"))
    assert counts["bucket_pack"] == tries * nranks
    assert counts["permute_serve"] == counts["permute_unpack"] == nranks * (
        int(np.log2(info["permute_capacity_factor"] / 2.0)) + 1)
    assert counts["rebalance_place"] == nranks * (
        int(np.log2(info["radius"] / 2)) + 1)
    assert counts["shard_leaf_levels"] == nranks
    assert counts["shard_box_skeleton"] == nranks * tree.nlevels
    assert counts["tree_leaf_levels"] == counts["tree_level_boxes"] == 0
    n = tree.nsources
    pot = drive_fmm(ConstantOneExpansionWrangler(None, build_traversal(tree)),
                    [torch.ones(n, dtype=torch.float64, device=device)])
    assert (pot == n).all()

# }}}
