"""boxtree_torch on trees with extents against boxtree_tpu: the tree, the
traversal with its close lists, and the FMM on it.

Inputs are made with numpy from fixed seeds and go through both packages.

- Trees (3D ``linf`` with target radii; 2D ``l2`` with source and target
  radii) must equal the reference field by field: integers and radii
  exactly, centres to 1 ulp (the reference's XLA build may contract
  ``bbox_min + (cell + 0.5) * size`` into an FMA, ROADMAP Queue 3).  The
  bounding boxes hold the centres and the particles +- radii; each is
  held exactly to K13's plain twin run on the reference's own centres, so
  only where a centre sets a bound may it differ, by that centre's ulp.
- The plain twins of K12 and K13 equal the reference's ``_stick_levels``
  and ``_box_extents``, called directly on the same inputs, exactly.
- The traversal (3D, ``precise_linf``) equals the reference's, every field
  exactly, the close lists included: the file's one JAX traversal
  compile.  The other criteria and the ``min_nsources`` forcing are held
  pair for pair to the reference-rule stack walk of
  ``tests/test_close_lists.py`` (numpy only, no JAX compile).
- The counting FMM is exact with the close lists and after
  ``merge_close_lists()``; the 3D Laplace FMM at order 6 in float64 matches
  one recorded JAX ``drive_fmm`` (run on the port's traversal, carried
  across) stage by stage and whole to 1e-11, P2M and L2P also through the
  twins of K28 and K30 called directly, and at order 10 the float64
  direct sum to 1e-5.
- The rows of K28-K30 (the boxes that own particles, on every level)
  cover every source and target exactly once, in the box
  ``box_id_of_*`` names, on both extent trees: targets (3D) and sources
  and targets (2D) stop in boxes with children.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_close_lists import _csr_pairs, _HostOracle
from test_torch_helmholtz3d import _jax_traversal
from test_torch_laplace3d import assert_rows_cover

import boxtree_tpu
from boxtree_torch import Tree, box_flags_enum, build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import (
    ConstantOneExpansionWrangler,
    make_laplace_wrangler,
)
from boxtree_torch.models.expansion_base import rows_with_particles
from boxtree_torch.ops import close_lists, extents, laplace3d, morton
from boxtree_torch.traversal import FMMTraversalInfo, build_traversal
from boxtree_torch.traversal.build import close_list_inputs
from boxtree_torch.utils.bridge import to_numpy, traversal_from_numpy
from boxtree_tpu.fmm import drive_fmm as jax_drive_fmm
from boxtree_tpu.models.laplace import (
    make_laplace_wrangler as jax_make_laplace_wrangler,
)
from boxtree_tpu.traversal import build_traversal as jax_build_traversal
from boxtree_tpu.tree.build import _box_extents, _stick_levels
from boxtree_tpu.utils.particles import (
    make_normal_particle_array,
    make_uniform_particle_array,
)
from torch_threads import one_torch_thread  # noqa: F401
from torch_translate import parent_block_m2l

RTOL = 1e-11
#: P2P against the correctly rounded direct sum, in units of
#: eps * sum_j |q_j| / r_ij (as tests/test_torch_laplace_stages.py)
P2P_EPS_COND = 16
SOF = 0.25


def _extent_inputs(dims, nsources, ntargets, seed, extent_norm,
                   source_radii=False, scale=0.1, low=-6):
    """Normal sources, uniform targets with radii ``2^U(low, 0) * scale``
    (``tests/test_close_lists.py:35-44`` with larger radii, so that many
    targets stop in boxes with children)."""
    rng = np.random.default_rng(seed)
    kw = dict(targets=make_uniform_particle_array(ntargets, dims,
                                                  np.float64, 2),
              target_radii=2 ** rng.uniform(low, 0, ntargets) * scale,
              stick_out_factor=SOF, extent_norm=extent_norm,
              max_particles_in_box=20)
    if source_radii:
        kw["source_radii"] = 2 ** rng.uniform(-10, 0, nsources) * 0.01
    return make_normal_particle_array(nsources, dims, np.float64, 1), kw


CONFIGS = {
    "3d_linf_targets": _extent_inputs(3, 900, 700, 11, "linf", scale=0.2,
                                      low=-4),
    "2d_l2_both": _extent_inputs(2, 1000, 900, 7, "l2", source_radii=True),
}
FIELDS = [f.name for f in dataclasses.fields(Tree)]
BBOX_FIELDS = [f"box_{w}_bounding_box_{m}" for w in ("source", "target")
               for m in ("min", "max")]


def _port_tree(name):
    src, kw = CONFIGS[name]
    return build_tree(src, device="cpu", **kw)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, (src, kw) in CONFIGS.items():
        out[name] = (boxtree_tpu.build_tree(src, **kw), _port_tree(name))
    return out


# {{{ trees

@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tree_field(trees, config, field):
    ref_tree, got_tree = trees[config]
    ref, val = getattr(ref_tree, field), to_numpy(getattr(got_tree, field))
    if field.endswith("_dtype"):
        assert val == np.dtype(ref)
    elif field == "level_start_box_nrs":
        assert tuple(val) == tuple(ref)
    elif ref is None or isinstance(ref, (bool, int, float, str)):
        assert val == ref
    else:
        ref = np.asarray(ref)
        assert val.dtype == ref.dtype and val.shape == ref.shape
        if field == "box_centers" or field in BBOX_FIELDS:
            ulp = np.spacing(np.abs(np.asarray(ref_tree.box_centers)).max())
            assert np.abs(val - ref).max() <= ulp
        else:
            np.testing.assert_array_equal(val, ref)


@pytest.mark.parametrize("what", ["source", "target"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_bounding_boxes_on_reference_centres(trees, config, what):
    """K13's twin on the port's tree and the reference's centres gives the
    reference's bounding boxes exactly."""
    ref, got = trees[config]
    bmin, bmax = extents.box_extents_plain(
        getattr(got, f"{what}s"), getattr(got, f"{what}_radii"),
        getattr(got, f"box_{what}_starts"),
        getattr(got, f"box_{what}_counts_nonchild"),
        torch.from_numpy(np.array(ref.box_centers)), got.box_child_ids,
        lsb=got.level_start_box_nrs)
    np.testing.assert_array_equal(
        bmin.numpy(), np.asarray(getattr(ref, f"box_{what}_bounding_box_min")))
    np.testing.assert_array_equal(
        bmax.numpy(), np.asarray(getattr(ref, f"box_{what}_bounding_box_max")))


def test_internal_boxes_hold_targets(trees):
    """The extent trees exercise what the extent path adds: targets that
    stop in boxes with children."""
    for _, got in trees.values():
        internal = (got.box_flags & box_flags_enum.IS_LEAF_BOX) == 0
        assert (got.box_target_counts_nonchild[internal] > 0).sum() >= 5


@pytest.mark.parametrize("config", list(CONFIGS))
def test_stick_levels_twin_vs_reference(config):
    src, kw = CONFIGS[config]
    pts = np.concatenate([src, kw["targets"]], axis=1)
    radii = np.concatenate([kw.get("source_radii", np.zeros(src.shape[1])),
                            kw["target_radii"]])
    dims = pts.shape[0]
    depth = 62 // dims
    lo = (pts - radii).min(axis=1)
    extent = float(((pts + radii).max(axis=1) - lo).max()) * (1 + 1e-4)
    args = dict(dimensions=dims, depth=depth,
                extent_norm=kw["extent_norm"], stick_out_factor=SOF)
    ref = np.asarray(_stick_levels(
        jnp.asarray(pts), jnp.asarray(radii), jnp.asarray(lo),
        jnp.asarray(extent), **args))
    got = extents.stick_levels_plain(
        torch.from_numpy(pts), torch.from_numpy(radii), torch.from_numpy(lo),
        torch.tensor(extent, dtype=torch.float64), **args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 2


@pytest.mark.parametrize("what", ["source", "target"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_box_extents_twin_vs_reference(trees, config, what):
    _, got = trees[config]
    radii = getattr(got, f"{what}_radii")
    coords = getattr(got, f"{what}s")
    ref = _box_extents(
        jnp.asarray(coords.numpy()),
        None if radii is None else jnp.asarray(radii.numpy()),
        jnp.asarray(getattr(got, f"box_id_of_{what}").numpy()),
        jnp.asarray(got.box_centers.numpy()),
        jnp.asarray(got.box_parent_ids.numpy()),
        lsb=got.level_start_box_nrs)
    out = extents.box_extents_plain(
        coords, radii, getattr(got, f"box_{what}_starts"),
        getattr(got, f"box_{what}_counts_nonchild"), got.box_centers,
        got.box_child_ids, lsb=got.level_start_box_nrs)
    for r, g in zip(ref, out):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("kwargs,exc", [
    (dict(target_radii=np.full(50, 0.01)), ValueError),       # no targets
    (dict(targets=np.zeros((3, 5)), target_radii=np.full(5, 0.01),
          extent_norm="l1"), ValueError),
    (dict(targets=np.zeros((3, 5)), target_radii=np.full(5, 0.01),
          kind="adaptive-level-restricted"), NotImplementedError),
])
def test_extent_tree_refusals(kwargs, exc):
    pts = np.random.default_rng(0).random((3, 50))
    with pytest.raises(exc):
        build_tree(pts, max_particles_in_box=10, device="cpu", **kwargs)

# }}}


# {{{ traversal

TRAV_FIELDS = [f.name for f in dataclasses.fields(FMMTraversalInfo)
               if f.name not in ("tree", "from_sep_smaller_by_level")]


@pytest.fixture(scope="module")
def traversals(trees):
    ref_tree, got_tree = trees["3d_linf_targets"]
    return jax_build_traversal(ref_tree), build_traversal(got_tree)


def _same(val, ref):
    if ref is None or isinstance(ref, (int, np.integer)):
        assert val == ref
        return
    ref = np.asarray(ref)
    assert val.dtype == ref.dtype and val.shape == ref.shape
    np.testing.assert_array_equal(val, ref)


@pytest.mark.parametrize("field", TRAV_FIELDS)
def test_traversal_field(traversals, field):
    ref, got = traversals
    val = to_numpy(getattr(got, field))
    if field == "target_boxes_sep_smaller_by_source_level":
        assert len(val) == len(getattr(ref, field))
        for v, r in zip(val, getattr(ref, field)):
            _same(v, r)
    else:
        _same(val, getattr(ref, field))


@pytest.mark.parametrize("field", ["count", "starts", "lists",
                                   "num_nonempty_lists", "nonempty_indices"])
def test_traversal_list3_by_level(traversals, field):
    ref, got = traversals
    assert len(got.from_sep_smaller_by_level) == len(
        ref.from_sep_smaller_by_level)
    for g, r in zip(got.from_sep_smaller_by_level,
                    ref.from_sep_smaller_by_level):
        _same(to_numpy(getattr(g, field)), getattr(r, field))


def test_close_lists_populated(traversals):
    _, got = traversals
    for what in ("from_sep_close_smaller", "from_sep_close_bigger",
                 "from_sep_bigger"):
        assert getattr(got, f"{what}_lists").shape[0] > 0, what
    assert sum(bl.count for bl in got.from_sep_smaller_by_level) > 0


GRID = {
    # (config, crit, min_nsources)
    "static_linf_2d": ("2d_linf", "static_linf", 0),
    "static_l2_3d_l2_tree": ("3d_l2", "static_l2", 0),
    "min_nsources_30_2d": ("2d_linf", "precise_linf", 30),
}
GRID_TREES = {
    "2d_linf": _extent_inputs(2, 900, 800, 11, "linf"),
    "3d_l2": _extent_inputs(3, 900, 800, 11, "l2"),
}


@pytest.mark.parametrize("case", list(GRID))
def test_membership_vs_host_walk(case):
    """Lists 3 and 4 and their close halves, pair for pair, against the
    reference-rule stack walk (``tests/test_close_lists.py:47-182``)."""
    config, crit, min_nsources = GRID[case]
    src, kw = GRID_TREES[config]
    tree = build_tree(src, device="cpu", **kw)
    trav = build_traversal(tree, from_sep_smaller_crit=crit,
                           _from_sep_smaller_min_nsources_cumul=min_nsources)
    oracle = _HostOracle(tree, 1, crit, min_nsources)

    tb = trav.target_boxes.numpy()
    far3, close3 = oracle.list3(tb)
    got_far3 = set()
    for lev, bl in enumerate(trav.from_sep_smaller_by_level):
        tsep = trav.target_boxes_sep_smaller_by_source_level[lev].numpy()
        got_far3 |= {(b, w, lev) for b, w in _csr_pairs(
            tsep, bl.starts.numpy(), bl.lists.numpy())}
    assert got_far3 == far3
    assert _csr_pairs(tb, trav.from_sep_close_smaller_starts,
                      trav.from_sep_close_smaller_lists) == close3
    assert close3

    totp = trav.target_or_target_parent_boxes.numpy()
    far4, close4 = oracle.list4(totp)
    assert _csr_pairs(totp, trav.from_sep_bigger_starts,
                      trav.from_sep_bigger_lists) == far4
    assert _csr_pairs(tb, trav.from_sep_close_bigger_starts,
                      trav.from_sep_close_bigger_lists) == close4


def _replay_work(tree, args4, args3, lsb, min_nsources):
    """K14's and K15's loops (``csrc/close_lists.cu``, ``precise_linf``)
    run one box and one table entry at a time, tallying what they read and
    test as the twins' ``work=`` dicts do: counts, and sets of box ids."""
    totp, ls_totp, ntable, parents, prefixes, flags, trow, _, geo = args4
    d, m, idm = tree.dimensions, 3 ** tree.dimensions, (1 << 29) - 1
    ntable, parents, flags, trow = (t.numpy() for t in (ntable, parents,
                                                        flags, trow))
    cells_of = morton.deinterleave(prefixes, d).numpy()
    level = np.searchsorted(lsb, np.arange(tree.nboxes), side="right") - 1
    src_cumul = geo.src_cumul.numpy()

    def offset(j):
        return [(j // 3 ** (d - 1 - ax)) % 3 - 1 for ax in range(d)]

    def touch(a, la, b, lb):
        s = lb - la
        return all(a[ax] << s <= b[ax] + 1 and b[ax] <= (a[ax] + 1) << s
                   for ax in range(d))

    def centre(cells, lev):
        return close_lists._centers(torch.as_tensor(
            np.asarray(cells, dtype=np.int64))[:, None], lev, geo)

    def sep_smaller(bc, lt, ac, la, i):
        lo, hi = geo.tbb_min[:, i:i + 1], geo.tbb_max[:, i:i + 1]
        return bool(close_lists._meets_sep_smaller(
            bc, lt, ac, la, geo, crit="precise_linf",
            tgt_ext_c=0.5 * (lo + hi), tgt_rvec=0.5 * (hi - lo))[0])

    def ancestors(b, lev, lowest, reads):
        anc = {lev: b}
        for lev_ in range(lev - 1, lowest - 1, -1):
            reads.add(anc[lev_ + 1])
            anc[lev_] = parents[anc[lev_ + 1]]
        return anc

    def entries(row, lev, skip_centre):
        for j in range(m):
            t = ntable[row, j]
            if (j == m // 2 and skip_centre) or t < 0 or t & idm < lsb[lev]:
                continue
            yield j, t & idm

    w4 = dict(rows=0, probes=0, parent_tests=0, parent_reads=set(),
              table_rows=set(), flag_reads=set())
    for b in totp.numpy()[ls_totp[2]:]:
        lb, cells = level[b], cells_of[:, b]
        w4["rows"] += 1
        anc = ancestors(b, lb, 1, w4["parent_reads"])
        bc = centre(cells, lb)
        for wl in range(1, lb):
            w4["table_rows"].add(anc[wl])
            for j, i in entries(anc[wl], wl, True):
                w4["flag_reads"].add(i)
                cand = [(cells[ax] >> (lb - wl)) + offset(j)[ax]
                        for ax in range(d)]
                if not flags[i] & 1 or touch(cand, wl, cells, lb):
                    continue
                w4["probes"] += 1
                w4["parent_tests"] += bool(close_lists._meets_sep_bigger(
                    bc, lb, centre(cand, wl), wl, geo)[0]) and not touch(
                        cand, wl, cells >> 1, lb - 1)

    w3 = dict(boxes=0, rows=0, probes=0, chain_tests=0, w_tests=0,
              **{k: set() for k in ("parent_reads", "table_rows",
                                    "tgt_reads", "bbox_reads",
                                    "src_cumul_reads")})
    for w in range(lsb[1], tree.nboxes):
        w3["boxes"] += 1
        if not flags[w] & 5:
            continue
        w3["rows"] += 1
        ls, cells = level[w], cells_of[:, w]
        if min_nsources:
            w3["src_cumul_reads"].add(w)
        anc = ancestors(w, ls, 0, w3["parent_reads"])
        for lt in range(ls):
            w3["table_rows"].add(anc[lt])
            for j, i in entries(anc[lt], lt, False):
                w3["tgt_reads"].add(i)
                cand = [(cells[ax] >> (ls - lt)) + offset(j)[ax]
                        for ax in range(d)]
                if trow[i] < 0 or touch(cand, lt, cells, ls):
                    continue
                w3["probes"] += 1
                w3["bbox_reads"].add(i)
                bc, chain = centre(cand, lt), True
                # with min_nsources the walk over every intermediate
                # ancestor, else the parent's test alone
                las = (range(lt + 1, ls) if min_nsources else
                       range(ls - 1, ls if lt < ls - 1 else ls - 1))
                for la in las:
                    ac = cells >> (ls - la)
                    if not chain or touch(cand, lt, ac, la):
                        continue
                    if min_nsources:
                        w3["src_cumul_reads"].add(anc[la])
                        if src_cumul[anc[la]] < min_nsources:
                            continue
                    w3["chain_tests"] += 1
                    chain = not sep_smaller(bc, lt, centre(ac, la), la, i)
                w3["w_tests"] += chain
    return w4, w3


@pytest.mark.parametrize("dims,nsources,min_nsources", [
    (2, 2000, 0), (2, 2000, 30), (3, 3000, 0)])
def test_close_list_work_matches_kernel_loops(dims, nsources, min_nsources):
    """The ``work=`` tallies of K14's and K15's twins, from which
    ``chip_smoke.py`` takes the kernels' bounds, count what the kernels'
    loops read and test, one box at a time.  The trees are deep enough
    that every filter drops some candidates."""
    src, kw = _extent_inputs(dims, nsources, 500, 5, "linf")
    tree = build_tree(src, device="cpu", **kw)
    (args4, kw4), (args3, kw3) = close_list_inputs(tree)
    got4, got3 = {}, {}
    close_lists.list4_ext_plain(*args4, **kw4, work=got4)
    close_lists.list3_ext_plain(*args3, **kw3, crit="precise_linf",
                                min_nsources=min_nsources, work=got3)
    want4, want3 = _replay_work(tree, args4, args3, kw4["lsb"],
                                min_nsources)
    for got, want, tests in ((got4, want4, ["parent_tests"]),
                             (got3, want3, ["chain_tests", "w_tests"])):
        assert all(0 < want[k] < want["probes"] for k in tests)
        for key, val in want.items():
            if isinstance(val, set):
                assert set(got.get(key, torch.zeros(0)).tolist()) == val, key
            else:
                assert got[key] == val, key


@pytest.mark.parametrize("kwargs,exc", [
    (dict(well_sep_is_n_away=2), NotImplementedError),
    (dict(from_sep_smaller_crit="static_linf"), ValueError),
    (dict(from_sep_smaller_crit="precise_l2"), ValueError),
])
def test_traversal_refusals(kwargs, exc):
    src, kw = _extent_inputs(2, 200, 200, 3, "l2")
    tree = build_tree(src, device="cpu", **kw)
    with pytest.raises(exc):
        build_traversal(tree, **kwargs)


def test_source_extents_rejected(trees):
    with pytest.raises(ValueError):
        build_traversal(trees["2d_l2_both"][1])

# }}}


# {{{ FMM

def test_counting_fmm_exact_and_merged(traversals):
    _, trav = traversals
    n = trav.tree.nsources
    ones = [torch.ones(n, dtype=torch.float64)]
    pot = drive_fmm(ConstantOneExpansionWrangler(None, trav), ones)
    assert (pot == n).all()

    merged = trav.merge_close_lists()
    assert merged.from_sep_close_smaller_starts is None
    assert merged.from_sep_close_bigger_lists is None
    assert merged.merge_close_lists() is merged
    pot2 = drive_fmm(ConstantOneExpansionWrangler(None, merged), ones)
    assert (pot2 == n).all()

    tb = trav.target_boxes.numpy()
    union = set()
    for what in ("neighbor_source_boxes", "from_sep_close_smaller",
                 "from_sep_close_bigger"):
        union |= _csr_pairs(tb, getattr(trav, f"{what}_starts"),
                            getattr(trav, f"{what}_lists"))
    got = _csr_pairs(tb, merged.neighbor_source_boxes_starts,
                     merged.neighbor_source_boxes_lists)
    assert got == union
    starts = merged.neighbor_source_boxes_starts.numpy()
    lists = merged.neighbor_source_boxes_lists.numpy()
    assert all((np.diff(lists[starts[i]:starts[i + 1]]) > 0).all()
               for i in range(len(tb)))


def test_counting_fmm_min_nsources():
    src, kw = GRID_TREES["2d_linf"]
    tree = build_tree(src, device="cpu", **kw)
    trav = build_traversal(tree, _from_sep_smaller_min_nsources_cumul=30)
    n = tree.nsources
    pot = drive_fmm(ConstantOneExpansionWrangler(None, trav),
                    [torch.ones(n, dtype=torch.float64)])
    assert (pot == n).all()


def test_bridge_carries_extent_fields(traversals):
    """``traversal_from_numpy`` carries the radii, the four bounding boxes
    and the close lists of the reference's traversal into the port's
    containers (and ``to_numpy`` back, in every test above)."""
    ref, got = traversals
    back = traversal_from_numpy(ref)
    for what in ("from_sep_close_smaller", "from_sep_close_bigger"):
        for part in ("starts", "lists"):
            name = f"{what}_{part}"
            assert torch.equal(getattr(back, name), getattr(got, name))
    for name in ["target_radii"] + BBOX_FIELDS:
        np.testing.assert_array_equal(to_numpy(getattr(back.tree, name)),
                                      np.asarray(getattr(ref.tree, name)))
    assert back.tree.source_radii is None
    assert back.tree.targets_have_extent and back.tree.extent_norm == "linf"
    assert back.tree.stick_out_factor == SOF


class _Recorder:
    """Forwards to a wrangler and keeps every output of each FMM stage
    (``eval_direct`` runs three times with close lists: List 1, close List
    3, close List 4)."""

    STAGES = ("form_multipoles", "coarsen_multipoles", "eval_direct",
              "multipole_to_local", "eval_multipoles", "form_locals",
              "refine_locals", "eval_locals")

    def __init__(self, inner):
        self._inner = inner
        self.outputs = {}

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self.STAGES:
            return attr

        def recorded(*args, **kwargs):
            out = attr(*args, **kwargs)
            self.outputs.setdefault(name, []).append(np.array(out))
            return out
        return recorded


def _charges(n):
    return np.random.default_rng(23).standard_normal(n)


def _direct(tree, starts, lists, q_tree, target_boxes):
    """Per tree-order target: the correctly rounded float64 sum of
    ``q_j / r_ij`` over the sources of its row's boxes, and ``sum_j |q_j|
    / r_ij``."""
    tgt, src = tree.targets.numpy(), tree.sources.numpy()
    q = q_tree.numpy()
    tst = tree.box_target_starts.numpy()
    tcn = tree.box_target_counts_nonchild.numpy()
    sst = tree.box_source_starts.numpy()
    scn = tree.box_source_counts_nonchild.numpy()
    starts, lists = starts.numpy(), lists.numpy()
    exact = np.zeros(tgt.shape[1])
    cond = np.zeros(tgt.shape[1])
    for row, box in enumerate(target_boxes.numpy()):
        boxes = lists[starts[row]:starts[row + 1]]
        if not len(boxes) or not tcn[box]:
            continue
        ti = np.arange(tst[box], tst[box] + tcn[box])
        sj = np.concatenate([np.arange(sst[b], sst[b] + scn[b])
                             for b in boxes])
        r = np.sqrt(((tgt[:, ti, None] - src[:, None, sj]) ** 2).sum(0))
        rs = np.where(r > 0, r, 1)
        terms = np.where(r > 0, q[sj] / rs, 0)
        exact[ti] = [math.fsum(t) for t in terms]
        cond[ti] = np.abs(terms).sum(1)
    return exact, cond


ORDER = 6
STAGES = ["P2M", "M2M", "P2P", "P2P_close3", "P2P_close4", "M2L", "M2P",
          "P2L", "L2L", "L2P"]


@pytest.fixture(scope="module")
def laplace(traversals):
    _, trav = traversals
    q = _charges(trav.tree.nsources)
    jw = _Recorder(jax_make_laplace_wrangler(
        _jax_traversal(trav), ORDER, pairs=True, rscale="auto",
        dtype=np.float64))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    ref = jw.outputs
    w = make_laplace_wrangler(trav, order=ORDER, pairs=True, rscale="auto",
                              dtype=torch.float64)
    tq = w.reorder_sources(torch.from_numpy(q))
    tree = trav.tree
    mp, mp_up = ref["form_multipoles"][0], ref["coarsen_multipoles"][0]
    loc, p2l = ref["multipole_to_local"][0], ref["form_locals"][0]
    loc2 = ref["refine_locals"][0]
    lsb_totp = trav.level_start_target_or_target_parent_box_nrs
    totp = trav.target_or_target_parent_boxes
    tb = trav.target_boxes

    def direct(what):
        starts = getattr(trav, f"{what}_starts")
        lists = getattr(trav, f"{what}_lists")
        return (_direct(tree, starts, lists, tq, tb),
                w.eval_direct(tb, starts, lists, [tq]))

    out = {
        "P2M": (mp, w.form_multipoles(trav.level_start_source_box_nrs,
                                      trav.source_boxes, [tq])),
        "M2M": (mp_up, w.coarsen_multipoles(
            trav.level_start_source_parent_box_nrs, trav.source_parent_boxes,
            torch.from_numpy(mp))),
        "P2P": direct("neighbor_source_boxes"),
        "P2P_close3": direct("from_sep_close_smaller"),
        "P2P_close4": direct("from_sep_close_bigger"),
        "M2L": (loc, w.multipole_to_local(
            lsb_totp, totp, trav.from_sep_siblings_starts,
            trav.from_sep_siblings_lists, torch.from_numpy(mp_up))),
        "M2P": (ref["eval_multipoles"][0], w.eval_multipoles(
            trav.target_boxes_sep_smaller_by_source_level,
            trav.from_sep_smaller_by_level, torch.from_numpy(mp_up))),
        "P2L": (p2l, w.form_locals(
            lsb_totp, totp, trav.from_sep_bigger_starts,
            trav.from_sep_bigger_lists, [tq])),
        "L2L": (loc2, w.refine_locals(lsb_totp, totp,
                                      torch.from_numpy(loc + p2l))),
        "L2P": (ref["eval_locals"][0], w.eval_locals(
            trav.level_start_target_box_nrs, tb, torch.from_numpy(loc2))),
    }
    assert len(ref["eval_direct"]) == 3
    return out, q, jpot, ref, w, tq


@pytest.mark.parametrize("stage", STAGES)
def test_laplace_stage_matches_reference(laplace, stage):
    ref, got = laplace[0][stage]
    got = got.numpy()
    if stage.startswith("P2P"):
        (exact, cond) = ref
        j = {"P2P": 0, "P2P_close3": 1, "P2P_close4": 2}[stage]
        eps = np.finfo(np.float64).eps
        assert got.shape == exact.shape and got.dtype == np.float64
        assert (np.abs(got - exact) <= P2P_EPS_COND * eps * cond).all()
        jref = laplace[3]["eval_direct"][j]
        assert (np.abs(jref - exact) <= P2P_EPS_COND * eps * cond).all()
        assert cond.max() > 0
        return
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


def test_m2l_parent_blocks_match_reference(laplace):
    """What K35 computes, from the plan's own tables, against the
    reference's M2L on its own multipoles (on the extent tree, whose
    sources stop on coarser boxes)."""
    out, w = laplace[0], laplace[4]
    mp_up, loc = out["M2M"][0], np.asarray(out["M2L"][0])
    got = parent_block_m2l(torch.from_numpy(np.asarray(mp_up)),
                           w._m2l_plan).numpy()
    assert np.abs(got - loc).max() <= RTOL * np.abs(loc).max()


@pytest.mark.parametrize("stage", ["P2M", "L2P"])
def test_p2m_l2p_twins_match_reference(laplace, stage):
    """K28 and K30's twins, called directly over the wrangler's rows,
    against the recorded reference stage: sources and targets in their
    nonchild ranges on every level, targets in boxes with children."""
    stages, _, _, ref, w, tq = laplace
    tree = w.tree
    if stage == "P2M":
        got = laplace3d.p2m_laplace3d_plain(
            w._sources, tq, tree.box_source_starts,
            tree.box_source_counts_nonchild, w._source_rows, w.centers,
            w.box_scale, w.order)
    else:
        got = laplace3d.l2p_laplace3d_plain(
            w._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, w._target_rows,
            torch.from_numpy(ref["refine_locals"][0]), w.centers,
            w.box_scale, w.order)
    want = np.asarray(stages[stage][0])
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def _sources_stick_out_tree():
    """A 3D tree (port only) whose sources have radii up to 0.2, so that
    sources too stop in boxes with children."""
    src, kw = _extent_inputs(3, 900, 700, 13, "linf")
    kw["source_radii"] = 2 ** np.random.default_rng(14).uniform(
        -4, 0, src.shape[1]) * 0.2
    return build_tree(src, device="cpu", **kw)


@pytest.mark.parametrize("what", ["source", "target"])
@pytest.mark.parametrize("config", [*CONFIGS, "3d_sources_stick_out"])
def test_particle_rows_cover_each_particle_once(trees, config, what):
    tree = (_sources_stick_out_tree() if config == "3d_sources_stick_out"
            else trees[config][1])
    internal = (tree.box_flags & box_flags_enum.IS_LEAF_BOX) == 0
    counts = getattr(tree, f"box_{what}_counts_nonchild")
    if what == "target" or config == "3d_sources_stick_out":
        assert (counts[internal] > 0).sum() >= 5
    rows = rows_with_particles(tree.box_source_counts_nonchild,
                               tree.box_target_counts_nonchild)
    assert_rows_cover(tree, what, rows[what == "target"])


def test_laplace_slice_matches_reference(traversals, laplace):
    _, trav = traversals
    _, q, jpot, *_ = laplace
    w = make_laplace_wrangler(trav, order=ORDER, pairs=True, rscale="auto",
                              dtype=torch.float64)
    got = drive_fmm(w, [torch.from_numpy(q)]).numpy()
    assert np.abs(got - jpot).max() <= RTOL * np.abs(jpot).max()


def test_laplace_order10_vs_direct_sum(traversals):
    _, trav = traversals
    tree = trav.tree
    src, kw = CONFIGS["3d_linf_targets"]
    q = _charges(tree.nsources)
    w = make_laplace_wrangler(trav, order=10, pairs=True, rscale="auto",
                              dtype=torch.float64)
    got = drive_fmm(w, [torch.from_numpy(q)]).numpy()
    d = kw["targets"][:, :, None] - src[:, None, :]
    ref = (1.0 / np.sqrt((d * d).sum(0))) @ q
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()

# }}}
