"""The tree build's phases, K43-K46, against boxtree_tpu's, and their
kernels' loops replayed.

- K43's twin (the port's ``_phase_a`` on the CPU) against JAX's
  ``_phase_a`` under ``jax.jit``: sorted keys, order, leaf levels, box
  counts and the unfit count, exactly, for the adaptive kind with unit
  and with refine weights (zeros among them), the non-adaptive kind (with
  weights, and in 1D), a given bbox and particle extents.
- K44's twin (the port's ``_phase_b``) against JAX's ``_phase_b`` on the
  same leaf levels: every per-box and per-particle array, integers exactly
  and centres within one ulp (XLA may contract the centre's multiply-add).
- K45's twin (a restriction round: the demand pass, then the sweep) and
  K46's twin against JAX's ``_restrict_pass`` and ``_recount_boxes``,
  round by round to the fixpoint.
- The loops of K43, K44, K45 and K46 (``csrc/tree.cu``,
  ``csrc/restrict.cu``) replayed one particle at a time in numpy, their
  binary searches narrowing as the kernels' do, against the twins.
- The counting FMM on non-adaptive trees (``tests/test_fmm.py:82``) and
  the Laplace FMM on one against a direct sum.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boxtree_torch import build_tree, config
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import (
    ConstantOneExpansionWrangler,
    make_laplace_wrangler,
)
from boxtree_torch.ops import restrict
from boxtree_torch.ops import tree as tree_ops
from boxtree_torch.traversal import build_traversal
from boxtree_torch.tree.build import _extent_order, _phase_a, _phase_b
from boxtree_torch.tree.level_restrict import consistency_sweep
from boxtree_tpu.tree import build as jax_build
from boxtree_tpu.tree import level_restrict as jax_restrict
from boxtree_tpu.utils.particles import make_surface_particle_array
from torch_threads import one_torch_thread  # noqa: F401


def _capped_sphere(n, seed=3):
    """Points on the unit sphere, a tenth of them in a small cap, so that
    the restriction has work to do."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, n - n // 10))
    cap = (np.full((3, 1), 3 ** -0.5)
           + 0.01 * rng.standard_normal((3, n // 10)))
    pts = np.concatenate([x, cap], axis=1)
    return pts / np.sqrt((pts * pts).sum(0))


def _configs():
    rng = np.random.default_rng(23)
    return {
        "3d_unit": dict(pts=make_surface_particle_array(2000, 3, np.float64,
                                                        11),
                        max_weight=20),
        "3d_weights_f32": dict(
            pts=rng.random((3, 2500), dtype=np.float32),
            weights=rng.integers(0, 10, 2500).astype(np.int32),
            max_weight=90),
        "2d_nonadaptive": dict(
            pts=make_surface_particle_array(2000, 2, np.float64, 5),
            max_weight=25, adaptive=False),
        "1d_nonadaptive_weights": dict(
            pts=rng.random((1, 1500)),
            weights=rng.integers(0, 6, 1500).astype(np.int32),
            max_weight=60, adaptive=False),
        "2d_bbox_f32": dict(
            pts=(rng.random((2, 2000)) * 0.6 + 0.1).astype(np.float32),
            bbox=np.array([[-0.5, 1.5], [0.0, 2.0]]), max_weight=15),
        "3d_extents": dict(
            pts=np.concatenate([_capped_sphere(1500, 4),
                                rng.random((3, 500)) * 2 - 1], axis=1),
            radii=np.concatenate([np.zeros(1500),
                                  rng.uniform(0.01, 0.2, 500)]),
            max_weight=20, stick_out_factor=0.25),
    }


CONFIGS = _configs()


def _depth(cfg):
    d, n = cfg["pts"].shape
    if "radii" in cfg:
        return config.max_morton_depth(d)
    iota_bits = max(1, int(n - 1).bit_length())
    return max(min(config.max_morton_depth(d), (63 - iota_bits) // d), 1)


def _bbox(cfg):
    if "bbox" not in cfg:
        return None
    bb = np.asarray(cfg["bbox"], cfg["pts"].dtype)
    return bb[:, 0].copy(), float(bb[0, 1] - bb[0, 0])


def _jax_phase_a(cfg):
    pts = cfg["pts"]
    d, n = pts.shape
    bb = _bbox(cfg)
    weights = cfg.get("weights", np.ones(n, np.int32))
    radii = cfg.get("radii")
    out = jax_build._phase_a(
        jnp.asarray(pts), jnp.asarray(weights),
        jnp.asarray(radii if radii is not None else np.zeros(1, pts.dtype)),
        jnp.asarray(bb[0] if bb else np.zeros(d, pts.dtype)),
        bb[1] if bb else 1.0, cfg["max_weight"],
        cfg.get("stick_out_factor", 0.0), dimensions=d, depth=_depth(cfg),
        adaptive=cfg.get("adaptive", True), use_bbox=bb is not None,
        has_extents=radii is not None,
        extent_norm="linf" if radii is not None else None)
    return [np.asarray(x) for x in out]


def _port_phase_a(cfg):
    pts = torch.from_numpy(cfg["pts"])
    d = pts.shape[0]
    bb = _bbox(cfg)
    w = cfg.get("weights")
    radii = cfg.get("radii")
    return _phase_a(
        pts, cfg["max_weight"], dimensions=d, depth=_depth(cfg),
        weights=torch.from_numpy(w) if w is not None else None,
        radii=torch.from_numpy(radii) if radii is not None else None,
        extent_norm="linf", stick_out_factor=cfg.get("stick_out_factor", 0.0),
        adaptive=cfg.get("adaptive", True),
        bbox=(torch.from_numpy(bb[0]),
              torch.tensor(bb[1], dtype=pts.dtype)) if bb else None)


@pytest.fixture(scope="module")
def phases():
    """Each configuration's phase A from both packages, then phase B from
    both on the port's leaf levels."""
    out = {}
    for name, cfg in CONFIGS.items():
        ref_a = _jax_phase_a(cfg)
        got_a = _port_phase_a(cfg)
        codes_s, order, leaf, counts, _, bmin, root = got_a
        d, n = cfg["pts"].shape
        nlevels = int(np.max(np.nonzero(counts.numpy())[0])) + 1
        lsb = tuple(int(x) for x in np.concatenate(
            [[0], np.cumsum(counts.numpy()[:nlevels])]))
        has_ext = "radii" in cfg
        merged = torch.from_numpy(cfg["pts"])
        nsrc = 1500 if has_ext else n
        kw = dict(dimensions=d, depth=_depth(cfg), level_starts=lsb,
                  nsources=nsrc, ntargets=n - nsrc if has_ext else n,
                  sources_are_targets=not has_ext, has_extents=has_ext)
        got_b = _phase_b(codes_s, order, leaf, merged, bmin, root, **kw)
        ref_b = jax_build._phase_b(
            jnp.asarray(codes_s.numpy()), jnp.asarray(order.numpy()),
            jnp.asarray(leaf.numpy()), jnp.asarray(cfg["pts"]),
            jnp.asarray(bmin.numpy()), jnp.asarray(root.numpy()),
            cap=lsb[-1], **kw)
        out[name] = dict(ref_a=ref_a, got_a=got_a, ref_b=ref_b, got_b=got_b,
                         kw=kw)
    return out


# {{{ K43: phase A

@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("what", ["codes_s", "order", "leaf_level",
                                  "counts", "n_unfit"])
def test_phase_a_matches_reference(phases, config, what):
    ref, got = phases[config]["ref_a"], phases[config]["got_a"]
    if what == "counts":
        np.testing.assert_array_equal(got[3].numpy(), ref[3][:-1])
    elif what == "n_unfit":
        assert got[4] == int(ref[3][-1]) == 0
    else:
        i = ["codes_s", "order", "leaf_level"].index(what)
        assert got[i].dtype == torch.from_numpy(ref[i].copy()).dtype
        np.testing.assert_array_equal(got[i].numpy(), ref[i])


def test_nonadaptive_one_leaf_level(phases):
    for name in ("2d_nonadaptive", "1d_nonadaptive_weights"):
        leaf = phases[name]["got_a"][2]
        assert int(leaf.min()) == int(leaf.max()) > 0


def test_nonadaptive_unfit_at_shallow_depth():
    """Coincident points never fit: the non-adaptive kind reports every
    particle unfit at the depth it tried, and its counts cover every
    level, as the reference's do."""
    pts = np.zeros((2, 40))
    pts[:, 20:] = 1.0
    ref = _jax_phase_a(dict(pts=pts, max_weight=10, adaptive=False))
    got = _port_phase_a(dict(pts=pts, max_weight=10, adaptive=False))
    assert got[4] == int(ref[3][-1]) == 40
    np.testing.assert_array_equal(got[3].numpy(), ref[3][:-1])
    np.testing.assert_array_equal(got[2].numpy(), ref[2])

# }}}


# {{{ K44: phase B

B_FIELDS = ["box_morton", "box_level", "box_parent", "box_child",
            "box_centers", "box_flags", "box_source_starts",
            "box_source_counts_cumul", "box_source_counts_nonchild",
            "box_target_starts", "box_target_counts_cumul",
            "box_target_counts_nonchild", "user_source_ids",
            "sorted_target_ids", "sources", "targets", "box_id_of_source",
            "box_id_of_target"]


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("field", B_FIELDS)
def test_phase_b_matches_reference(phases, config, field):
    ref = np.asarray(phases[config]["ref_b"][field])
    got = phases[config]["got_b"][field].numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if field == "box_centers":
        assert np.abs(got - ref).max() <= np.spacing(np.abs(ref).max())
    else:
        np.testing.assert_array_equal(got, ref)

# }}}


# {{{ K45 / K46: the restriction

@pytest.fixture(scope="module")
def restricted():
    """A 2D tree with a dense cluster, before the restriction (2D keeps
    JAX's unrolled restriction pass cheap to compile; the 3D restricted
    tree is held to the reference in ``test_torch_geometry.py``)."""
    rng = np.random.default_rng(8)
    pts = np.concatenate([rng.random((2, 1500)),
                          0.3 + 0.03 * rng.random((2, 500))], axis=1)
    depth = _depth(dict(pts=pts))
    codes_s, _, leaf, counts, n_unfit, _, _ = _phase_a(
        torch.from_numpy(pts), 20, dimensions=2, depth=depth)
    assert n_unfit == 0
    return codes_s, leaf, depth, int(np.max(np.nonzero(counts.numpy())[0]))


def test_restriction_rounds_match_reference(restricted):
    """Each round (demand pass, then K45's twin, the sweep) equals JAX's
    ``_restrict_pass``, and K46's twin its ``_recount_boxes``."""
    codes_s, leaf, depth, max_level = restricted
    kw = dict(dimensions=2, depth=depth)
    jcodes = jnp.asarray(codes_s.numpy())
    ref = jnp.asarray(leaf.numpy())
    changed_any = False
    for _ in range(max_level + 1):
        ref, changed = jax_restrict._restrict_pass(jcodes, ref,
                                                   max_level=max_level, **kw)
        got = leaf
        for m in range(max_level, 1, -1):
            got = restrict.demand_pass_plain(codes_s, got, m=m, **kw)
        got = consistency_sweep(codes_s, got, max_level=max_level, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert bool(changed) == bool((got != leaf).any())
        changed_any |= bool(changed)
        leaf = got
        if not bool(changed):
            break
    assert changed_any
    np.testing.assert_array_equal(
        tree_ops.level_box_counts_plain(codes_s, leaf, max_level=max_level,
                                        **kw).numpy(),
        np.asarray(jax_restrict._recount_boxes(jcodes, jnp.asarray(
            leaf.numpy()), max_level=max_level, **kw)))

# }}}


# {{{ the kernels' loops, one particle at a time

def _lower_bound(keys, lo, hi, key):
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if keys[mid] < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _lcp(codes, i, d, depth):
    if i == 0:
        return -1
    x = int(codes[i]) ^ int(codes[i - 1])
    return max(depth - (x.bit_length() + d - 1) // d, -1)


def _k43_replay(codes, w, stick, max_w, d, depth, adaptive):
    """K43's loops: each particle walks its levels with narrowing binary
    searches; the counts from the (lcp, leaf] ranges, with extents from
    the tags at the ranges' first positions."""
    codes = [int(c) for c in codes]
    n = len(codes)
    cumw = np.concatenate([[0], np.cumsum(w)]) if w is not None else None
    counts = np.zeros(depth + 2, np.int64)
    leaf = np.empty(n, np.int64)
    unfit, used = 0, -1
    if not adaptive:
        maxw = np.full(depth + 1, np.iinfo(np.int64).min)
        for i in range(n):
            lcp, hi = _lcp(codes, i, d, depth), n
            for lev in range(lcp + 1, depth + 1):
                s = d * (depth - lev)
                hi = _lower_bound(codes, i + 1, hi, ((codes[i] >> s) + 1) << s)
                wt = cumw[hi] - cumw[i] if cumw is not None else hi - i
                maxw[lev] = max(maxw[lev], wt)
                counts[lev] += 1
        fits = np.nonzero(maxw <= max_w)[0]
        if len(fits):
            used = int(fits[0])
            counts[used + 1:] = 0
        else:
            unfit, used = n, depth
        leaf[:] = used
        return leaf, counts, unfit, used
    if stick is not None:
        ww = w if w is not None else np.ones(n, np.int64)
        table = [np.concatenate([[0], np.cumsum(ww * (stick > lev))])
                 for lev in range(depth + 1)]
    for i in range(n):
        lo, hi, lf = 0, n, -1
        for lev in range(depth + 1):
            s = d * (depth - lev)
            if lev > 0:
                p = codes[i] >> s
                lo = _lower_bound(codes, lo, i, p << s)
                hi = _lower_bound(codes, i + 1, hi, (p + 1) << s)
            if stick is not None:
                wt = table[lev][hi] - table[lev][lo]
            else:
                wt = cumw[hi] - cumw[lo] if cumw is not None else hi - lo
            if (stick is not None and stick[i] <= lev) or wt <= max_w:
                lf = lev
                break
        if lf < 0:
            lf, unfit = depth, unfit + 1
        leaf[i] = lf
        if stick is None:
            counts[_lcp(codes, i, d, depth) + 1:lf + 1] += 1
    if stick is not None:
        tags = {}
        for i in range(n):
            lcp = _lcp(codes, i, d, depth)
            thr = -1 if i == 0 else min(lcp, leaf[i - 1])
            for lev in range(thr + 1, leaf[i] + 1):
                s = d * (depth - lev)
                first = i if lev > lcp else _lower_bound(
                    codes, 0, i, (codes[i] >> s) << s)
                if lev not in tags.setdefault(first, set()):
                    tags[first].add(lev)
                    counts[lev] += 1
    return leaf, counts, unfit, used


@pytest.mark.parametrize("config", list(CONFIGS))
def test_k43_loops_match_twin(phases, config):
    cfg = CONFIGS[config]
    codes_s, order, *_ = phases[config]["got_a"]
    d = cfg["pts"].shape[0]
    depth = _depth(cfg)
    w = cfg.get("weights")
    w_s = w[order.numpy()].astype(np.int64) if w is not None else None
    stick = None
    if "radii" in cfg:
        from boxtree_torch.tree.build import _sort_keys
        stick = _sort_keys(
            torch.from_numpy(cfg["pts"]), dimensions=d, depth=depth,
            radii=torch.from_numpy(cfg["radii"]), extent_norm="linf",
            stick_out_factor=cfg["stick_out_factor"])[3].numpy()
    adaptive = cfg.get("adaptive", True)
    leaf, counts, unfit, used = _k43_replay(codes_s.numpy(), w_s, stick,
                                            cfg["max_weight"], d, depth,
                                            adaptive)
    tleaf, packed = tree_ops.leaf_levels_plain(
        codes_s, torch.from_numpy(w_s) if w_s is not None else None,
        torch.from_numpy(stick) if stick is not None else None,
        cfg["max_weight"], dimensions=d, depth=depth, adaptive=adaptive)
    np.testing.assert_array_equal(leaf, tleaf.numpy())
    np.testing.assert_array_equal(
        np.concatenate([counts, [unfit, used]]), packed.numpy())


def _k44_replay(codes, leaf, d, depth, lsb, has_ext):
    """K44's loop, level by level, one particle at a time; returns the
    integer arrays."""
    codes = [int(c) for c in codes]
    n = len(codes)
    cap = lsb[-1]
    out = {k: np.zeros(cap, np.int64) for k in (
        "box_morton", "box_level", "box_start", "box_count_cumul",
        "box_count_nonchild", "box_has_children", "box_parent")}
    child = np.zeros((2 ** d, cap), np.int64)
    prev_box = np.zeros(n, np.int64)
    leaf_box = np.zeros(n, np.int64)
    thr = [-1 if i == 0 else min(_lcp(codes, i, d, depth), leaf[i - 1])
           for i in range(n)]
    cum_ge = np.arange(n + 1)
    for lev in range(len(lsb) - 1):
        cum_gt = np.concatenate([[0], np.cumsum(leaf > lev)])
        seg = np.cumsum([leaf[i] >= lev and thr[i] < lev for i in range(n)])
        for i in range(n):
            if leaf[i] < lev:
                continue
            b = lsb[lev] + seg[i] - 1
            if leaf[i] == lev:
                leaf_box[i] = b
            if thr[i] < lev:
                s = d * (depth - lev)
                p = codes[i] >> s
                out["box_morton"][b] = p
                out["box_level"][b] = lev
                out["box_start"][b] = i
                if has_ext:
                    nxt = i + 1 + int(np.searchsorted(seg[i + 1:], seg[i],
                                                      side="right"))
                    cumul = cum_ge[nxt] - cum_ge[i]
                    deeper = cum_gt[nxt] - cum_gt[i]
                else:
                    cumul = _lower_bound(codes, i + 1, n, (p + 1) << s) - i
                    deeper = cumul if leaf[i] > lev else 0
                out["box_count_cumul"][b] = cumul
                out["box_count_nonchild"][b] = cumul - deeper
                out["box_has_children"][b] = deeper > 0
                if lev > 0:
                    out["box_parent"][b] = prev_box[i]
                    child[p & (2 ** d - 1), prev_box[i]] = b
            prev_box[i] = b
        cum_ge = cum_gt
    out["box_child"] = child
    out["leaf_box"] = leaf_box
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_k44_loop_matches_twin(phases, config):
    codes_s, order, leaf = phases[config]["got_a"][:3]
    kw = phases[config]["kw"]
    d, depth, has_ext = kw["dimensions"], kw["depth"], kw["has_extents"]
    if has_ext:
        codes_s, _, leaf = _extent_order(codes_s, order, leaf, dimensions=d,
                                         depth=depth)
    twin = tree_ops.box_levels_plain(
        codes_s, leaf, torch.zeros(d, dtype=torch.float64),
        torch.tensor(1.0, dtype=torch.float64), dimensions=d, depth=depth,
        level_starts=kw["level_starts"], has_extents=has_ext)
    got = _k44_replay(codes_s.numpy(), leaf.numpy(), d, depth,
                      kw["level_starts"], has_ext)
    for name, val in got.items():
        np.testing.assert_array_equal(val, twin[name].numpy().astype(
            np.int64), err_msg=name)


def test_k45_k46_loops_match_twins(restricted):
    """K45's flag and raise passes over the runs' scan, and K46's
    (min(lcp_i, leaf_{i-1}), leaf_i] ranges, against the twins at every
    level of every round."""
    codes_s, leaf, depth, max_level = restricted
    kw = dict(dimensions=2, depth=depth)
    codes = codes_s.numpy()
    lcp = [_lcp(codes, i, 2, depth) for i in range(len(codes))]
    for _ in range(max_level + 1):
        leaf_in = leaf
        for m in range(max_level, 1, -1):
            leaf = restrict.demand_pass_plain(codes_s, leaf, m=m, **kw)
        for t in range(max_level):
            lv = leaf.numpy().copy()
            prev = np.concatenate([[-1], lv[:-1]])
            seg = np.cumsum((lv >= t) & (np.minimum(lcp, prev) < t))
            flag = np.zeros(len(lv) + 1, bool)
            flag[seg[lv > t] - 1] = True
            lv[(lv == t) & flag[seg - 1]] = t + 1
            leaf = restrict.sweep_plain(codes_s, leaf, t=t, **kw)
            np.testing.assert_array_equal(lv, leaf.numpy())
        if not bool((leaf != leaf_in).any()):
            break
    lv = leaf.numpy()
    counts = np.zeros(depth + 2, np.int64)
    for i in range(len(lv)):
        thr = -1 if i == 0 else min(lcp[i], lv[i - 1])
        counts[thr + 1:min(lv[i], max_level) + 1] += 1
    np.testing.assert_array_equal(counts, tree_ops.level_box_counts_plain(
        codes_s, leaf, max_level=max_level, **kw).numpy())

# }}}


# {{{ the non-adaptive tree downstream

@pytest.mark.parametrize("dims,ntargets", [(2, None), (3, None), (2, 1000)])
def test_counting_fmm_non_adaptive(dims, ntargets):
    """Every potential equals the number of sources
    (``tests/test_fmm.py:82``)."""
    rng = np.random.default_rng(dims)
    pts = make_surface_particle_array(1500, dims, np.float64, dims)
    tgt = rng.random((dims, ntargets)) if ntargets else None
    tree = build_tree(pts, kind="non-adaptive", max_particles_in_box=30,
                      targets=tgt, device="cpu")
    assert len(set(tree.box_levels[
        (tree.box_flags & 16) != 0].tolist())) == 1
    trav = build_traversal(tree)
    pot = drive_fmm(ConstantOneExpansionWrangler(None, trav),
                    [torch.ones(1500, dtype=torch.float64)])
    assert torch.equal(pot, torch.full_like(pot, 1500))


def test_laplace_fmm_non_adaptive_against_direct_sum():
    rng = np.random.default_rng(4)
    pts = rng.random((3, 2000))
    q = rng.standard_normal(2000)
    tree = build_tree(pts, kind="non-adaptive", max_particles_in_box=30,
                      device="cpu")
    w = make_laplace_wrangler(build_traversal(tree), order=10, pairs=True,
                              rscale="auto", dtype=np.float64)
    got = drive_fmm(w, [torch.from_numpy(q)]).numpy()
    d = pts[:, :, None] - pts[:, None, :]
    r = np.sqrt((d * d).sum(0))
    np.fill_diagonal(r, np.inf)
    ref = (q[None, :] / r).sum(1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5

# }}}
