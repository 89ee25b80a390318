"""The 2D Laplace FMM of boxtree_torch, complex128 and real pairs, against
boxtree_tpu's, and alone against direct sums.

- The binomial table exactly; the wrangler's per-level M2M, L2L and M2L
  operators against the JAX builders (``_m2m_matrix``, ``_l2l_matrix``,
  ``_m2l_matrix``) on the unscaled and the rscaled branches, and the M2L
  tables against the reference's own device builder (``_m2l_ops_device``),
  row by row to 1e-12 of each row's largest entry, imaginary parts and
  their branch (``+-i pi`` on the classes' axes) included.
- The expansion hooks K20 and K21's twins share (P2M, L2P, M2P, P2L, both
  layouts) against the reference's hooks under ``jax.jit``, on offsets on
  a centre line on either side, of either zero sign, and at ``w = 0``
  (1e-13 per column).
- Every FMM stage and the slice (rel l-inf <= 1e-11; expansions per
  coefficient column, complex parts included) for the complex wrangler
  with ``rscale="auto"`` and the pairs wrangler with ``rscale=None``, each
  from one recorded JAX ``drive_fmm`` on the port's traversal, each port
  stage fed the reference's inputs.  A tenth of the particles sit exactly
  on box-centre lines, so the logs' branches on those lines are compared
  too.  Pairs in float32 against the reference's float64 potentials
  (1e-5); complex charges on the pairs wrangler as the reference takes
  them.
- Port alone: the counting FMM exact; order 20 against the direct sum on
  ``tests/test_laplace.py:23-53``'s points (< 1e-5); the order-35 line of
  ``tests/test_stability.py:28-65`` (< (1/2)^36); the factory's dispatch
  and each option still refused; K19-K21's entry points and checks.
- K38-K42 (P2M, L2P, and the dipole P2M, P2P and P2L): their twins and
  CPU wrappers against the reference's hooks under ``jax.jit``, the
  dipoles through ``jax.jvp``, per entry point (complex128 and float64
  pairs 1e-12, float32 pairs 1e-5), on centre lines and at ``w = z0 =
  0``; their rows covering each particle once.
- The double layer (dipoles): every stage and the slice of the complex128
  and float64 pairs wranglers within 1e-11 of one recorded JAX
  ``drive_fmm`` on the points' traversal; the float32 pairs' particle
  stages and slice within 1e-5 of the float64 pairs' on a starfish curve
  with separate targets; ``tests/test_laplace.py:88-110`` against the
  direct sum (< 1e-5) and ``:200-225`` pairs against complex (<= 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.fmm.drive import FMM_STAGES
from boxtree_torch.models import (
    ConstantOneExpansionWrangler,
    Laplace2DExpansionWrangler,
    Laplace2DPairsExpansionWrangler,
    Laplace3DExpansionWrangler,
    LaplaceTreeIndependentDataForWrangler,
    make_laplace_wrangler,
)
from boxtree_torch.ops import kernels
from boxtree_torch.ops import laplace2d as l2
from boxtree_torch.ops.translate import ROW_PAD
from boxtree_torch.traversal import build_traversal
from boxtree_torch.traversal.neighbors import _offsets
from boxtree_tpu.fmm import drive_fmm as jax_drive_fmm
from boxtree_tpu.models.laplace import (
    LaplaceTreeIndependentDataForWrangler as JaxTreeIndependent,
    make_laplace_wrangler as jax_make_laplace_wrangler,
)
from test_torch_helmholtz3d import (
    _jax_traversal,
    _Recorder,
    _rel_linf,
    _rows_rel,
)
from torch_threads import one_torch_thread  # noqa: F401
from torch_translate import check_rows, parent_block_m2l

N = 800
MAX_IN_BOX = 30
ORDER = 10
RTOL = 1e-11
OP_RTOL = 1e-12
HOOK_RTOL = 1e-13
STAGES = ["P2M", "M2M", "P2P", "M2L", "M2P", "P2L", "M2L+P2L", "L2L",
          "L2P"]
#: the two recordings: (pairs, rscale, dtype)
KINDS = {"complex": (False, "auto", torch.complex128),
         "pairs": (True, None, torch.float64)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _cols_rel(got, ref):
    """Worst column of ``max |got - ref| / max |ref|`` over (rows,
    coefficients) expansions, each column to its own scale (the columns
    span many decades); a column that is zero in the reference (the
    imaginary lane of a real charge's ``a_0``) must be zero."""
    scale = np.abs(ref).max(axis=0)
    err = np.abs(got - ref).max(axis=0)
    assert (err[scale == 0] == 0).all()
    return (err[scale > 0] / scale[scale > 0]).max()


def clustered(n, seed):
    """``tests/test_laplace.py:27-31``'s points at *n*: uniform in the unit
    square, the first 24 % uniform in [0.45, 0.55]^2."""
    rng = np.random.default_rng(seed)
    pts = rng.random((2, n))
    m = n * 600 // 2500
    pts[:, :m] = 0.1 * rng.random((2, m)) + 0.45
    return pts


def direct_log(targets, sources, q):
    d = targets[:, :, None] - sources[:, None, :]
    r2 = (d * d).sum(0)
    return np.where(r2 > 0, 0.5 * np.log(np.where(r2 > 0, r2, 1.0)), 0) @ q


def _snap_to_centre_lines(pts, seed, max_particles_in_box):
    """A tenth of *pts* (none of the extremes, which fix the root box) with
    x or y, or both, set to the nearest box-centre coordinate of their
    tree: a tree rebuilt from them has the same grid of centres, so those
    particles sit exactly on centre lines."""
    tree = build_tree(pts, max_particles_in_box=max_particles_in_box,
                      device="cpu")
    cx, cy = (np.unique(c) for c in tree.box_centers.numpy())
    rng = np.random.default_rng(seed)
    extremes = {int(f(pts[a])) for a in (0, 1) for f in (np.argmin,
                                                         np.argmax)}
    pick = [i for i in rng.choice(pts.shape[1], pts.shape[1] // 10,
                                  replace=False) if i not in extremes]
    out = pts.copy()
    for j, i in enumerate(pick):
        for ax, c in ((0, cx), (1, cy)):
            if j % 3 != ax:
                out[ax, i] = c[np.abs(c - pts[ax, i]).argmin()]
    return out


@pytest.fixture(scope="module")
def points():
    pts = _snap_to_centre_lines(clustered(N, seed=7), 8, MAX_IN_BOX)
    q = np.random.default_rng(1).standard_normal(N)
    trav = build_traversal(build_tree(pts, max_particles_in_box=MAX_IN_BOX,
                                      device="cpu"))
    return pts, q, trav


# {{{ tables and operators

@pytest.mark.parametrize("order", [0, 5, 20, 35])
def test_binomial_table(order):
    got = LaplaceTreeIndependentDataForWrangler(2, order).binom
    ref = JaxTreeIndependent(2, order).binom
    np.testing.assert_array_equal(got, ref)
    assert not hasattr(LaplaceTreeIndependentDataForWrangler(2, 3), "nm_n")


def _lap(trav, kind, **kw):
    pairs, rscale, dtype = KINDS[kind]
    kw.setdefault("rscale", rscale)
    return make_laplace_wrangler(trav, ORDER, pairs=pairs, dtype=dtype, **kw)


@pytest.mark.parametrize("op", ["M2M", "L2L", "M2L"])
@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_level_operators_match_reference(recorded, points, kind, rscale,
                                         op):
    """The wrangler's per-level operators against the JAX builders at the
    same translations and rscales: unscaled without rscale, scaled below
    1 from level 1 on with it."""
    jw = recorded(kind)[2]
    w = _lap(points[2], kind, rscale=rscale)
    rs = w._rscale_np
    assert (rs == 1.0).all() if rscale is None else (rs[1:] < 1.0).all()
    classes = _offsets(2, 3, min_inf_norm=1)
    assert len(classes) == 40
    worst = 0.0
    for lev in range(1 if op != "M2L" else 2, w.tree.nlevels):
        size = w.root_extent / (1 << lev)
        if op == "M2L":
            # the table holds the (level, class) pairs that List 2 uses
            for i, (lv, c) in enumerate(w._m2l_plan.used):
                if lv == lev:
                    worst = max(worst, _rows_rel(
                        w._m2l_opsT[i].T.numpy(), jw._m2l_matrix(
                            classes[c] * size, float(rs[lev]))))
            continue
        for q in range(4):
            sign = np.array([1.0 if (q >> (1 - ax)) & 1 else -1.0
                             for ax in range(2)])
            off = sign * (size / 2)
            if op == "M2M":
                worst = max(worst, _rows_rel(
                    w._m2m_opsT[lev][q].T.numpy(),
                    jw._m2m_matrix(-off, float(rs[lev]),
                                   float(rs[lev - 1]))))
            else:
                worst = max(worst, _rows_rel(
                    w._l2l_opsT[lev][q].T.numpy(),
                    jw._l2l_matrix(off, float(rs[lev - 1]),
                                   float(rs[lev]))))
    assert worst <= OP_RTOL


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("r", [1.0, 0.03125])
def test_m2l_table_matches_reference_device_builder(recorded, points, kind,
                                                    r):
    """The torch M2L table against the reference's ``_m2l_ops_device``
    (what the reference runs for 2D), entry by entry per row: ``log(-z0)``
    of the classes on the axes takes ``+-i pi`` / ``+-i pi/2`` as there."""
    jw = recorded(kind)[2]
    w = _lap(points[2], kind)
    classes = _offsets(2, 3, min_inf_norm=1)
    size = 0.0625
    ts = classes * size
    got = w._m2l_matrices(classes, size, r).numpy()
    ref = np.asarray(jw._m2l_ops_device(jnp.asarray(ts.astype(np.float64)),
                                        jnp.full(len(ts), r)))
    assert got.shape == ref.shape
    assert _rows_rel(got.reshape(-1, got.shape[-1]),
                     ref.reshape(-1, ref.shape[-1])) <= OP_RTOL
    axis = (ts[:, 1] == 0) & (ts[:, 0] < 0)
    b00 = got[:, 0, 0] if kind == "complex" else got[:, ORDER + 1, 0]
    assert np.allclose(np.imag(b00[axis]) if kind == "complex"
                       else b00[axis], np.pi, rtol=1e-15)

# }}}


# {{{ the hooks against the reference's, on centre lines and at zero

def _hook_offsets():
    rng = np.random.default_rng(9)
    line = [[-0.7, 0.7, -0.7, 0.7, 0.0, -0.0, 0.0, -0.0, 0.0],
            [0.0, 0.0, -0.0, -0.0, 0.6, 0.6, -0.6, -0.6, 0.0]]
    return np.concatenate([rng.uniform(-2.5, 2.5, (2, 40)), line], axis=1)


def _jax_hook_wrangler(kind):
    """A reference wrangler object for its hooks only (the hooks read the
    order, the coefficient count and the dtype)."""
    from boxtree_tpu.models.laplace import (
        Laplace2DExpansionWrangler as JaxComplex,
        Laplace2DPairsExpansionWrangler as JaxPairs,
    )
    w = object.__new__(JaxComplex if kind == "complex" else JaxPairs)
    w.order = ORDER
    w.tree_indep = JaxTreeIndependent(2, ORDER)
    w.ncoeff = w._ncoeff()
    return w


@pytest.mark.parametrize("hook", ["p2m", "l2p", "m2p", "p2l"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_hooks_match_reference(kind, hook):
    """K20/K21's twins' expansions and the P2M/L2P hooks against the
    reference's hooks under ``jax.jit``: 40 random offsets, four on the
    horizontal centre line (either side, either zero sign), four on the
    vertical one, and ``w = 0`` (where the two references part: the
    complex takes ``w = 1``, the pairs ``1 / w = 0``)."""
    jw = _jax_hook_wrangler(kind)
    rel = _hook_offsets()
    n = rel.shape[1]
    rng = np.random.default_rng(10)
    s = rng.uniform(0.1, 1.0, n)
    q = rng.standard_normal(n)
    nc = ORDER + 1 if kind == "complex" else 2 * (ORDER + 1)
    coef = rng.standard_normal((n, nc))
    if kind == "complex":
        coef = coef + 1j * rng.standard_normal((n, nc))
    pairs = "" if kind == "complex" else "_pairs"
    tq = _t(q).to(torch.complex128) if kind == "complex" else _t(q)
    jq = q.astype(np.complex128) if kind == "complex" else q
    if hook == "p2m":
        got = getattr(l2, f"p2m_terms{pairs}")(_t(rel), tq, ORDER)
        ref = jax.jit(lambda r, qq: jw._p2m_terms(r, qq))(rel, jq)
    elif hook == "l2p":
        got = getattr(l2, f"l2p_eval{pairs}")(_t(rel), _t(coef), ORDER)
        ref = jax.jit(lambda r, c: jw._l2p_eval(r, c))(rel, coef)
    elif hook == "m2p":
        got = getattr(l2, f"m2p_eval{pairs}")(_t(rel), _t(coef), _t(s),
                                               ORDER)
        ref = jax.jit(lambda r, c, ss: jw._m2p_eval(r, c.T, ss))(rel, coef,
                                                                 s)
    else:
        got = getattr(l2, f"p2l_terms{pairs}")(_t(rel), tq, _t(s), ORDER)
        ref = jax.jit(lambda r, qq, ss: jw._p2l_terms(r, qq, ss))(rel, jq, s)
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.ndim == 1:
        assert np.abs(got - ref).max() <= HOOK_RTOL * np.abs(ref).max()
    else:
        assert _cols_rel(got, ref) <= HOOK_RTOL

# }}}


# {{{ against boxtree_tpu's recorded FMMs, stage by stage

def _record(trav, q, kind):
    """``(stages, w, jw, jpot)`` of one recorded JAX ``drive_fmm`` of
    *kind*: each stage's reference and port output (each port stage fed
    the reference's inputs), the port's and the reference's wranglers, and
    the reference's potentials."""
    pairs, rscale, _ = KINDS[kind]
    jw = _Recorder(jax_make_laplace_wrangler(
        _jax_traversal(trav), order=ORDER, pairs=pairs, rscale=rscale))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    ref = {name: np.asarray(v) for name, v in jw.outputs.items()}
    w = _lap(trav, kind)
    tq = w.reorder_sources(torch.from_numpy(q))

    mp, mp_up = ref["form_multipoles"], ref["coarsen_multipoles"]
    loc, p2l = ref["multipole_to_local"], ref["form_locals"]
    lsb_totp = trav.level_start_target_or_target_parent_box_nrs
    totp = trav.target_or_target_parent_boxes
    out = {
        "P2M": (mp, w.form_multipoles(trav.level_start_source_box_nrs,
                                      trav.source_boxes, [tq])),
        "M2M": (mp_up, w.coarsen_multipoles(
            trav.level_start_source_parent_box_nrs, trav.source_parent_boxes,
            _t(mp))),
        "P2P": (ref["eval_direct"], w.eval_direct(
            trav.target_boxes, trav.neighbor_source_boxes_starts,
            trav.neighbor_source_boxes_lists, [tq])),
        "M2L": (loc, w.multipole_to_local(
            lsb_totp, totp, trav.from_sep_siblings_starts,
            trav.from_sep_siblings_lists, _t(mp_up))),
        "M2P": (ref["eval_multipoles"], w.eval_multipoles(
            trav.target_boxes_sep_smaller_by_source_level,
            trav.from_sep_smaller_by_level, _t(mp_up))),
        "P2L": (p2l, w.form_locals(
            lsb_totp, totp, trav.from_sep_bigger_starts,
            trav.from_sep_bigger_lists, [tq])),
        # as the port's drive_fmm calls it: added in place into the M2L
        # output
        "M2L+P2L": (loc + p2l, w.form_locals(
            lsb_totp, totp, trav.from_sep_bigger_starts,
            trav.from_sep_bigger_lists, [tq], _t(loc))),
        "L2L": (ref["refine_locals"], w.refine_locals(
            lsb_totp, totp, _t(loc + p2l))),
        "L2P": (ref["eval_locals"], w.eval_locals(
            trav.level_start_target_box_nrs, trav.target_boxes,
            _t(ref["refine_locals"]))),
    }
    return out, w, jw._inner, jpot


@pytest.fixture(scope="module")
def recorded(points):
    """:func:`_record` per kind, each made on first use."""
    _, q, trav = points
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _record(trav, q, kind)
        return cache[kind]
    return get


def test_centre_lines_exercised(points):
    """Some List-3 targets and List-4 sources sit exactly on a centre line
    of the box at the other end of their list entry (one offset component
    +0.0), and the lists are populated."""
    pts, _, trav = points
    tree = trav.tree
    assert tree.nlevels >= 6
    w = _lap(trav, "pairs")
    centers = w.centers.numpy()
    zeros = {}
    for name, (rows, starts, lists), part in (
            ("m2p", w._l3_csr, "target"), ("p2l", w._l4_csr, "source")):
        rows, starts, lists = (x.numpy().astype(np.int64)
                               for x in (rows, starts, lists))
        row_box = np.repeat(rows, np.diff(starts))
        st = getattr(tree, f"box_{part}_starts").numpy()
        cn = getattr(tree, f"box_{part}_counts_nonchild").numpy()
        pts_tree = getattr(w, f"_{part}s").numpy()
        # the particles of the List-3 row's box against the listed box's
        # centre; the listed List-4 box's particles against the row's
        pbox, cbox = ((row_box, lists) if name == "m2p"
                      else (lists, row_box))
        count = 0
        for pb, cb in zip(pbox, cbox):
            rel = pts_tree[:, st[pb]:st[pb] + cn[pb]] - centers[:, cb, None]
            count += int((rel == 0).sum())
        zeros[name] = (count, len(lists))
    assert all(c > 0 and e > 0 for c, e in zeros.values()), zeros


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stages_match_reference(recorded, kind, stage):
    ref, got = recorded(kind)[0][stage]
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype == (np.complex128 if kind == "complex"
                                      else np.float64)
    # expansions: each coefficient's column to its own scale
    err = _cols_rel(got, ref) if got.ndim == 2 else _rel_linf(got, ref)
    assert err <= RTOL


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_m2l_parent_blocks_match_reference(recorded, kind):
    """What K35 computes, from the plan's own tables (m = 9 slots, 4
    digits), against the reference's M2L on its own multipoles; the
    plan's rows padded per level."""
    stages, w = recorded(kind)[:2]
    got = parent_block_m2l(_t(stages["M2M"][0]), w._m2l_plan)
    assert _cols_rel(got.numpy(), stages["M2L"][0]) <= RTOL
    check_rows(w._m2l_plan, w.tree, ROW_PAD)

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_slice_matches_reference(points, recorded, kind):
    q = points[1]
    _, w, _, jpot = recorded(kind)
    timing = {}
    got = drive_fmm(w, [torch.from_numpy(q)], timing_data=timing)
    assert got.dtype == KINDS[kind][2] and got.shape == (N,)
    assert set(timing) == set(FMM_STAGES)
    assert _rel_linf(got.numpy(), jpot) <= RTOL


def test_pairs_float32_matches_reference(points, recorded):
    """The pairs wrangler in float32 (``rscale=None``) against the
    reference's float64 pairs potentials, 1e-5."""
    _, q, trav = points
    jpot = recorded("pairs")[3]
    w = make_laplace_wrangler(trav, ORDER, pairs=True, dtype=np.float32)
    assert w.dtype == torch.float32 and w.centers.dtype == torch.float32
    got = drive_fmm(w, [torch.from_numpy(q.astype(np.float32))])
    assert got.dtype == torch.float32
    assert _rel_linf(got.numpy(), jpot) <= 1e-5


def test_pairs_complex_charges_as_reference(points, recorded):
    """Complex charges on the pairs wranglers: the reference casts them to
    its real dtype, keeping the real part; so does the port."""
    _, q, trav = points
    jw = recorded("pairs")[2]
    qc = q + 1j * np.random.default_rng(3).standard_normal(N)
    with np.errstate(all="ignore"):
        jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(qc)]))
    np.testing.assert_array_equal(jpot, recorded("pairs")[3])
    w = recorded("pairs")[1]
    got = drive_fmm(w, [torch.from_numpy(qc)])
    assert got.dtype == torch.float64
    assert _rel_linf(got.numpy(), jpot) <= RTOL


def test_pairs_match_complex(points, recorded):
    """The pairs wrangler against the complex one's real part, both with
    ``rscale="auto"`` on the port (``tests/test_laplace.py:200-227``)."""
    _, q, trav = points
    ref = recorded("complex")[3].real
    w = make_laplace_wrangler(trav, ORDER, pairs=True, rscale="auto")
    got = drive_fmm(w, [torch.from_numpy(q)]).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12

# }}}


# {{{ the port alone

def test_counting_fmm_2d(points):
    trav = points[2]
    w = ConstantOneExpansionWrangler(None, trav)
    pot = drive_fmm(w, [torch.ones(N, dtype=torch.float64)])
    assert torch.equal(pot, torch.full((N,), float(N), dtype=torch.float64))


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_order20_against_direct_sum(split, pairs):
    """``tests/test_laplace.py:23-53`` on the port: 2,500 sources, 600 of
    them clustered, order 20, sources = targets or 1,800 targets."""
    rng = np.random.default_rng(20)
    sources = rng.random((2, 2500))
    sources[:, :600] = 0.1 * rng.random((2, 600)) + 0.45
    q = rng.standard_normal(2500)
    targets = rng.random((2, 1800)) if split else None
    trav = build_traversal(build_tree(sources, targets=targets,
                                      max_particles_in_box=20, device="cpu"))
    w = make_laplace_wrangler(trav, 20, pairs=pairs)
    pot = drive_fmm(w, [torch.from_numpy(q)]).numpy().real
    ref = direct_log(targets if split else sources, sources, q)
    assert _rel_linf(pot, ref) < 1e-5


@pytest.mark.parametrize("pairs", [False, True])
def test_order35_stability(pairs):
    """``tests/test_stability.py:28-65`` (2D) on the port: 30 points spaced
    geometrically along y = 0, targets 1e-3 further out, order 35,
    ``rscale="auto"``: at least 15 levels, no NaN, rel error < (1/2)^36."""
    line = np.array([2.0 ** -i for i in range(15)])
    line = np.hstack([line, 3 - line])
    sources = np.vstack([line, np.zeros(30)])
    targets = sources * (1 + 1e-3)
    tree = build_tree(sources, targets=targets, max_particles_in_box=2,
                      device="cpu")
    assert tree.nlevels >= 15
    w = make_laplace_wrangler(build_traversal(tree), 35, pairs=pairs,
                              rscale="auto")
    pot = drive_fmm(w, [torch.ones(30, dtype=torch.float64)]).numpy().real
    assert not np.isnan(pot).any()
    assert _rel_linf(pot, direct_log(targets, sources, np.ones(30))) \
        < 0.5 ** 36


def test_factory_dispatch(points):
    trav = points[2]
    cases = [
        (dict(pairs=False), Laplace2DExpansionWrangler, torch.complex128),
        (dict(), Laplace2DExpansionWrangler, torch.complex128),   # CPU tree
        (dict(pairs=True), Laplace2DPairsExpansionWrangler, torch.float64),
        (dict(pairs=True, dtype=np.complex128),
         Laplace2DPairsExpansionWrangler, torch.float64),
        (dict(pairs=True, dtype=np.complex64),
         Laplace2DPairsExpansionWrangler, torch.float32),
        (dict(pairs=True, dtype="float32"), Laplace2DPairsExpansionWrangler,
         torch.float32),
        (dict(dtype=torch.complex128), Laplace2DExpansionWrangler,
         torch.complex128),
    ]
    for kw, cls, dt in cases:
        w = make_laplace_wrangler(trav, 6, **kw)
        assert type(w) is cls and w.dtype == dt, kw
        assert w.ncoeff == (7 if cls is Laplace2DExpansionWrangler else 14)
        assert w.real_dtype == dt.to_real()
    tree3 = build_tree(np.random.default_rng(2).random((3, 300)),
                       max_particles_in_box=30, device="cpu")
    # on a CPU tree, as in the reference: complex in 3D too
    w3 = make_laplace_wrangler(build_traversal(tree3), 3)
    assert type(w3) is Laplace3DExpansionWrangler


@pytest.mark.parametrize("kwargs", [
    dict(m2l_mode="rotation", pairs=True),
    dict(dtype=np.float16),
    dict(m2l_mode="rotation"),
    dict(pairs=False, dtype=np.complex64),
    dict(dtype=np.complex64),
    dict(pairs=False, dtype=np.float64),
    dict(pairs=True, dtype=np.float16),
])
def test_unported_options_raise(points, kwargs):
    with pytest.raises(NotImplementedError):
        make_laplace_wrangler(points[2], 4, **kwargs)


@pytest.mark.parametrize("pairs", [False, True])
def test_level_to_order_2d(points, pairs):
    """``level_to_order`` in 2D: the order is the largest over the levels,
    each level's expansions hold no coefficient past its order, and the
    potentials stay within the order-8 levels' truncation of the fixed
    order-10 FMM's."""
    _, q, trav = points
    w = make_laplace_wrangler(trav, level_to_order=lambda lev: 10 - min(lev,
                                                                        2),
                              pairs=pairs, rscale="auto")
    assert w.order == ORDER and list(w.level_orders[:3]) == [10, 9, 8]
    pot = drive_fmm(w, [torch.from_numpy(q)]).numpy().real
    ref = drive_fmm(make_laplace_wrangler(trav, ORDER, pairs=pairs,
                                          rscale="auto"),
                    [torch.from_numpy(q)]).numpy().real
    assert 0 < _rel_linf(pot, ref) < 1e-5
    mp = w.form_multipoles(None, None, [w.reorder_sources(
        torch.from_numpy(q))]).numpy()
    deg = np.arange(ORDER + 1) if not pairs else np.tile(
        np.arange(ORDER + 1), 2)
    lev = trav.tree.box_levels.numpy()
    assert (mp[deg[None, :] > w.level_orders[lev][:, None]] == 0).all()


def test_complex_3d_on_cpu():
    """``pairs=False`` in 3D gives the complex wrangler, as in the
    reference."""
    tree3 = build_tree(np.random.default_rng(2).random((3, 300)),
                       max_particles_in_box=30, device="cpu")
    w = make_laplace_wrangler(build_traversal(tree3), 3, pairs=False)
    assert type(w) is Laplace3DExpansionWrangler
    assert w.dtype == torch.complex128 and w.ncoeff == 16


def test_kernel_entry_points_2d():
    """K19-K21 have float32, float64 and complex128 entry points; K21's
    scratch fits 48 KiB at order 35 and opts in beyond, up to 227 KiB; the
    wrappers' dtype checks refuse before anything is built."""
    for name in ("p2p_laplace2d", "m2p_laplace2d", "p2l_laplace2d"):
        assert kernels._entry_names(name) == [
            f"{name}_f32", f"{name}_f64", f"{name}_c128"]
    assert l2.smem_bytes(35, torch.complex128) == 36 * 33 * 16 < 48 * 1024
    assert l2.smem_bytes(35, torch.float64) == 72 * 33 * 8
    assert l2.smem_bytes(100, torch.complex128) > 48 * 1024
    l2.check_order(400, torch.complex128)
    with pytest.raises(ValueError, match="shared memory"):
        l2.check_order(500, torch.complex128)
    l2._check_dtypes(torch.complex128, torch.float64)
    l2._check_dtypes(torch.float32, torch.float32)
    for val, real in ((torch.complex64, torch.float32),
                      (torch.float32, torch.float64),
                      (torch.complex128, torch.float32)):
        with pytest.raises(TypeError):
            l2._check_dtypes(val, real)

# }}}


# {{{ K38-K42's twins against the reference's hooks and their JVPs

#: the entry points: (reference layout, value dtype), and their bars
#: against the reference in float64
PKINDS = {"c128": ("complex", torch.complex128),
          "f64": ("pairs", torch.float64), "f32": ("pairs", torch.float32)}
PRTOL = {"c128": 1e-12, "f64": 1e-12, "f32": 1e-5}
PARTICLE = {"p2m": "p2m_laplace2d", "p2m_dipole": "p2m_laplace2d_dipole",
            "l2p": "l2p_laplace2d", "p2p_dipole": "p2p_laplace2d_dipole",
            "p2l_dipole": "p2l_laplace2d_dipole"}


def _particle_inputs(layout):
    """:func:`_hook_offsets` (centre lines, either zero sign, and ``w =
    z0 = 0`` last) with rscales, charges, dipoles and coefficients; P2P's
    20 targets and 30 sources, the fourth target on the eighth source.
    Complex charges and coefficients for the complex layout, real ones
    and pair lanes for the pairs."""
    rel = _hook_offsets()
    n = rel.shape[1]
    rng = np.random.default_rng(11)
    src = rng.uniform(-1, 1, (2, 30))
    tgt = rng.uniform(-1, 1, (2, 20))
    tgt[:, 3] = src[:, 7]
    x = dict(rel=rel, s=rng.uniform(0.1, 1.0, n),
             q=rng.standard_normal(n) + 1j * rng.standard_normal(n),
             dip=rng.standard_normal((2, n)),
             coef=rng.standard_normal((n, 2 * (ORDER + 1))), tgt=tgt,
             src=src, qp=rng.standard_normal(30)
             + 1j * rng.standard_normal(30),
             dipp=rng.standard_normal((2, 30)))
    if layout == "pairs":
        x["q"], x["qp"] = x["q"].real, x["qp"].real
    else:
        k = ORDER + 1
        x["coef"] = x["coef"][:, :k] + 1j * x["coef"][:, k:]
    return x


@pytest.fixture(scope="module")
def particle_refs():
    """Per layout, the reference's P2M, L2P, P2L and P2P hooks and the
    JVPs of P2M and P2L along ``d / s`` and of P2P along ``d`` at
    :func:`_particle_inputs`, each layout in one ``jax.jit``."""
    refs = {}
    for layout in ("complex", "pairs"):
        jw = _jax_hook_wrangler(layout)
        x = _particle_inputs(layout)
        valid = np.ones(30, bool)

        def f(rel, s, q, dip, coef, tgt, src, qp, dipp, jw=jw):
            p2m = lambda r: jw._p2m_terms(r, q)  # noqa: E731
            p2l = lambda r: jw._p2l_terms(r, q, s)  # noqa: E731
            p2p = lambda ss: jw._p2p(tgt, ss, valid, qp)  # noqa: E731
            return {"p2m": p2m(rel),
                    "p2m_dipole": jax.jvp(p2m, (rel,), (dip / s,))[1],
                    "l2p": jw._l2p_eval(rel, coef),
                    "p2l_dipole": jax.jvp(p2l, (rel,), (dip / s,))[1],
                    "p2p_dipole": jax.jvp(p2p, (src,), (dipp,))[1]}
        refs[layout] = {name: np.asarray(v) for name, v in jax.jit(f)(
            x["rel"], x["s"], x["q"], x["dip"], x["coef"], x["tgt"].T,
            x["src"].T, x["qp"], x["dipp"].T).items()}
    return refs


def _one_per_box(n):
    """CSR arguments with row box i listing box n + i, each box holding
    particle i: box starts and counts over 2n boxes, rows, starts,
    lists."""
    i32 = torch.arange(n, dtype=torch.int32)
    return (torch.cat([i32, i32]), torch.ones(2 * n, dtype=torch.int32),
            i32, torch.arange(n + 1, dtype=torch.int32), i32 + n)


@pytest.mark.parametrize("via", ["wrapper", "twin"])
@pytest.mark.parametrize("which", sorted(PARTICLE))
@pytest.mark.parametrize("kind", sorted(PKINDS))
def test_particle_twins_match_reference_hooks(particle_refs, kind, which,
                                              via):
    """K38-K42's twins and their CPU wrappers against the reference's
    hooks under ``jax.jit`` (the dipoles through ``jax.jvp``): one
    particle a box (centre 0, scale s_i) for P2M, L2P and the dipole P2L
    (row box i lists box n + i), one target box and one source box for
    the dipole P2P.  The last offset is 0: P2M puts the charge on ``a_0``
    alone and its dipole on ``a_1`` alone; the dipole P2L adds nothing
    there in the complex form (``z0 = 1`` is a constant) and keeps the
    tangents of ``th`` and ``1 / z0`` on the pairs."""
    layout, dt = PKINDS[kind]
    rdt = dt.to_real()
    x = {k: _t(v) for k, v in _particle_inputs(layout).items()}
    x = {k: v.to(dt if v.is_complex() or k in ("q", "qp", "coef") else rdt)
         for k, v in x.items()}
    ref = particle_refs[layout][which]
    name = PARTICLE[which]
    fn = getattr(l2, name if via == "wrapper" else f"{name}_plain")
    n = x["rel"].shape[1]
    starts, counts, rows, csr, lists = _one_per_box(n)
    pts = x["rel"] * x["s"]
    nc = ref.shape[-1] if ref.ndim == 2 else 0
    if which == "p2p_dipole":
        i32 = torch.zeros(1, dtype=torch.int32)
        got = fn(x["tgt"], x["src"], x["qp"], x["dipp"], i32,
                 torch.tensor([20], dtype=torch.int32), i32,
                 torch.tensor([30], dtype=torch.int32), i32,
                 torch.tensor([0, 1], dtype=torch.int32), i32)
    elif which == "l2p":
        got = fn(pts, starts[:n], counts[:n], rows, x["coef"],
                 torch.zeros((2, n), dtype=rdt), x["s"], ORDER)
    elif which == "p2l_dipole":
        out = torch.zeros((2 * n, nc), dtype=dt)
        got = fn(pts, x["q"], x["dip"], starts, counts, rows, csr, lists,
                 torch.zeros((2, 2 * n), dtype=rdt), torch.cat(
                     [x["s"], x["s"]]), ORDER, out)[:n]
        at = np.zeros(nc, bool)
        if layout == "pairs":
            at[[1, ORDER + 1, ORDER + 2]] = True
        assert (got[-1].numpy()[~at] == 0).all()
        assert (ref[-1][~at] == 0).all() and (ref[-1][at] != 0).all()
    else:
        dip = (x["dip"],) if which == "p2m_dipole" else ()
        got = fn(pts, x["q"], *dip, starts[:n], counts[:n], rows,
                 torch.zeros((2, n), dtype=rdt), x["s"], ORDER)
        lane = np.arange(nc) % (ORDER + 1)
        at = (lane == 0) if which == "p2m" else (lane == 1)
        assert (got[-1].numpy()[~at] == 0).all() and (ref[-1][~at] == 0).all()
    got = got.numpy()
    assert got.dtype == {torch.complex128: np.complex128,
                         torch.float64: np.float64,
                         torch.float32: np.float32}[dt]
    assert got.shape == ref.shape
    got = got.astype(ref.dtype)
    if got.ndim == 1:
        err = np.abs(got - ref).max() / np.abs(ref).max()
    else:
        err = _cols_rel(got, ref)
    assert err <= PRTOL[kind]


def test_particle_kernel_entry_points_2d():
    """K38-K42 have float32, float64 and complex128 entry points, with
    the argument lists of their 3D counterparts K28-K30, K22 and K23."""
    for name in PARTICLE.values():
        assert kernels._entry_names(name) == [
            f"{name}_f32", f"{name}_f64", f"{name}_c128"]
        assert kernels.SIGNATURES[name] == kernels.SIGNATURES[
            name.replace("2d", "3d")]

# }}}


# {{{ the double layer against boxtree_tpu's recorded FMM, stage by stage

#: the port wranglers held to the recorded complex double layer, in their
#: layout (the pairs' lanes, the real potentials): (pairs, dtype)
DKINDS = {"c128": (False, torch.complex128), "f64": (True, torch.float64)}
#: the float32 pairs' stages held to the float64 pairs'
STAGES32 = ["P2M", "P2P", "P2L", "L2P"]


def _dlayout(x, kind):
    """A complex reference array in the layout of *kind*: ``[re | im]``
    lanes of expansions and the real part of potentials for the pairs."""
    x = np.asarray(x)
    if not DKINDS[kind][0]:
        return x
    return x.real if x.ndim == 1 else np.concatenate([x.real, x.imag], 1)


@pytest.fixture(scope="module")
def dipole_recording(points, recorded):
    """One recorded JAX ``drive_fmm`` of the complex double layer on the
    points' traversal (a tenth of them on centre lines, sources = targets,
    so List 1 holds ``r = 0``) at ORDER with ``rscale="auto"`` and
    standard-normal dipoles: ``(stage outputs, potentials, dipoles)``.
    The complex recording's compiles serve it (~6 s instead of ~45 s)."""
    recorded("complex")
    _, q, trav = points
    dip = np.random.default_rng(12).standard_normal((2, N))
    jw = _Recorder(jax_make_laplace_wrangler(
        _jax_traversal(trav), order=ORDER, pairs=False, rscale="auto",
        dipole_vec=dip))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    return ({name: np.asarray(v) for name, v in jw.outputs.items()}, jpot,
            dip)


def _dwrangler(trav, kind, dip):
    pairs, dt = {**DKINDS, "f32": (True, torch.float32)}[kind]
    return make_laplace_wrangler(trav, ORDER, pairs=pairs, dtype=dt,
                                 rscale="auto", dipole_vec=dip)


@pytest.fixture(scope="module")
def dipole_stages(points, dipole_recording):
    """Per kind, each stage's reference (in the kind's layout) and port
    output, each port stage fed the reference's inputs, and the
    wrangler."""
    _, q, trav = points
    ref, _, dip = dipole_recording
    cache = {}

    def get(kind):
        if kind in cache:
            return cache[kind]
        w = _dwrangler(trav, kind, dip)
        tq = w.reorder_sources(torch.from_numpy(q))

        def lay(name):
            return _dlayout(ref[name], kind)
        mp_up, loc, p2l = (lay(k) for k in ("coarsen_multipoles",
                                             "multipole_to_local",
                                             "form_locals"))
        lsb_totp = trav.level_start_target_or_target_parent_box_nrs
        totp = trav.target_or_target_parent_boxes
        cache[kind] = ({
            "P2M": (lay("form_multipoles"),
                    w.form_multipoles(None, None, [tq])),
            "M2M": (mp_up, w.coarsen_multipoles(
                None, None, _t(lay("form_multipoles")))),
            "P2P": (lay("eval_direct"), w.eval_direct(
                trav.target_boxes, trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists, [tq])),
            "M2L": (loc, w.multipole_to_local(
                lsb_totp, totp, trav.from_sep_siblings_starts,
                trav.from_sep_siblings_lists, _t(mp_up))),
            "M2P": (lay("eval_multipoles"), w.eval_multipoles(
                trav.target_boxes_sep_smaller_by_source_level,
                trav.from_sep_smaller_by_level, _t(mp_up))),
            "P2L": (p2l, w.form_locals(
                lsb_totp, totp, trav.from_sep_bigger_starts,
                trav.from_sep_bigger_lists, [tq])),
            "M2L+P2L": (loc + p2l, w.form_locals(
                lsb_totp, totp, trav.from_sep_bigger_starts,
                trav.from_sep_bigger_lists, [tq], _t(loc))),
            "L2L": (lay("refine_locals"), w.refine_locals(
                lsb_totp, totp, _t(loc + p2l))),
            "L2P": (lay("eval_locals"), w.eval_locals(
                None, None, _t(lay("refine_locals")))),
        }, w)
        return cache[kind]
    return get


def _as_coeffs(x, kind):
    """Pair-lane expansions as complex columns, a coefficient's two lanes
    held to the coefficient's scale."""
    if kind != "c128" and x.ndim == 2:
        k = x.shape[1] // 2
        return x[:, :k] + 1j * x[:, k:]
    return x


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("kind", sorted(DKINDS))
def test_dipole_stages_match_reference(dipole_stages, kind, stage):
    """Every stage of the complex128 and float64 pairs double layer within
    1e-11 of the recorded reference, expansions per coefficient column:
    with dipoles ``a_0 = 0``, so the logs' branches on the centre lines,
    where the two references part, meet only zero coefficients."""
    ref, got = dipole_stages(kind)[0][stage]
    got = got.numpy()
    assert got.shape == ref.shape
    assert got.dtype == {"c128": np.complex128, "f64": np.float64}[kind]
    if got.ndim == 1:
        err = _rel_linf(got, ref)
    else:
        err = _cols_rel(_as_coeffs(got, kind), _as_coeffs(ref, kind))
    assert err <= RTOL


@pytest.mark.parametrize("kind", sorted(DKINDS))
def test_dipole_slice_matches_reference(points, dipole_recording,
                                        dipole_stages, kind):
    q = points[1]
    jpot = _dlayout(dipole_recording[1], kind)
    w = dipole_stages(kind)[1]
    timing = {}
    got = drive_fmm(w, [torch.from_numpy(q)], timing_data=timing)
    assert got.dtype == DKINDS[kind][1] and got.shape == (N,)
    assert set(timing) == set(FMM_STAGES)
    assert _rel_linf(got.numpy(), jpot) <= RTOL


def starfish(n, seed):
    """*n* points on the five-armed starfish ``r(theta) = 1 + 0.25 cos 5
    theta`` at uniform random angles, and their unit outward normals."""
    th = np.random.default_rng(seed).uniform(0, 2 * np.pi, n)
    r, dr = 1 + 0.25 * np.cos(5 * th), -1.25 * np.sin(5 * th)
    tx = dr * np.cos(th) - r * np.sin(th)
    ty = dr * np.sin(th) + r * np.cos(th)
    nrm = np.stack([ty, -tx]) / np.hypot(tx, ty)
    return np.stack([r * np.cos(th), r * np.sin(th)]), nrm


@pytest.fixture(scope="module")
def starfish_case():
    """2,000 starfish sources with their normals as dipoles, 600
    separate targets in [-1.5, 1.5]^2, standard-normal weights, each
    rounded to float32 (so that the float32 wrangler sees the float64
    one's inputs, and the bar measures its arithmetic, not the rounding
    of ``s - t`` that the kernel's ``1 / r^2`` magnifies near the
    curve); the float64 and float32 pairs wranglers and each one's
    weights, and the float64 one's locals."""
    src, nrm = starfish(2000, 30)
    rng = np.random.default_rng(31)
    tgt = rng.uniform(-1.5, 1.5, (2, 600))
    w = rng.standard_normal(2000)
    src, nrm, tgt, w = (a.astype(np.float32).astype(np.float64)
                        for a in (src, nrm, tgt, w))
    trav = build_traversal(build_tree(src, targets=tgt,
                                      max_particles_in_box=MAX_IN_BOX,
                                      device="cpu"))
    ws = {kind: _dwrangler(trav, kind, nrm) for kind in ("f64", "f32")}
    qs = {kind: wr.reorder_sources(torch.from_numpy(w))
          for kind, wr in ws.items()}
    return trav, ws, qs, w, fmm_locals(ws["f64"], qs["f64"])


def fmm_locals(w, q_tree):
    """The local expansions ``drive_fmm`` hands to L2P, stage by stage."""
    trav = w.traversal
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(
        None, None, [q_tree]))
    lsb, totp = (trav.level_start_target_or_target_parent_box_nrs,
                 trav.target_or_target_parent_boxes)
    loc = w.multipole_to_local(lsb, totp, trav.from_sep_siblings_starts,
                               trav.from_sep_siblings_lists, mp)
    loc = w.form_locals(lsb, totp, trav.from_sep_bigger_starts,
                        trav.from_sep_bigger_lists, [q_tree], loc)
    return w.refine_locals(lsb, totp, loc)


def _box_rows_rel(got, ref):
    """Worst box of ``max |got - ref| / max |ref|`` over its row of
    coefficients; a row that is zero in the reference must be zero."""
    scale = np.abs(ref).max(axis=1)
    err = np.abs(got - ref).max(axis=1)
    assert (err[scale == 0] == 0).all()
    return (err[scale > 0] / scale[scale > 0]).max()


@pytest.mark.parametrize("stage", [*STAGES32, "slice"])
def test_dipole_float32_matches_float64(starfish_case, stage):
    """The float32 pairs' particle stages (K39-K42 through their twins)
    and slice on the starfish double layer, within 1e-5 of the float64
    pairs': expansions box by box to each row's largest coefficient (a
    float32 centre keeps ~5 bits fewer of the offset ``y - c`` at the
    finest level, and ``zeta^k`` carries that k-fold into the high
    orders)."""
    trav, ws, qs, w_user, loc64 = starfish_case
    lsb_totp = trav.level_start_target_or_target_parent_box_nrs
    totp = trav.target_or_target_parent_boxes
    got = {}
    for kind, w in ws.items():
        q = qs[kind]
        if stage == "P2M":
            got[kind] = w.form_multipoles(None, None, [q])
        elif stage == "P2P":
            got[kind] = w.eval_direct(
                trav.target_boxes, trav.neighbor_source_boxes_starts,
                trav.neighbor_source_boxes_lists, [q])
        elif stage == "P2L":
            got[kind] = w.form_locals(
                lsb_totp, totp, trav.from_sep_bigger_starts,
                trav.from_sep_bigger_lists, [q])
        elif stage == "L2P":
            got[kind] = w.eval_locals(None, None, loc64.to(w.dtype))
        else:
            got[kind] = drive_fmm(w, [torch.from_numpy(w_user)])
    assert got["f32"].dtype == torch.float32
    g, r = got["f32"].double().numpy(), got["f64"].numpy()
    if g.ndim == 1:
        err = _rel_linf(g, r)
    else:
        err = _box_rows_rel(_as_coeffs(g, "f32"), _as_coeffs(r, "f32"))
    assert err <= 1e-5


@pytest.mark.parametrize("what", ["source", "target"])
@pytest.mark.parametrize("tree_of", ["sources_are_targets",
                                     "separate_targets"])
def test_particle_rows_cover_each_particle_once(points, starfish_case,
                                                tree_of, what):
    """K38 / K39's source rows and K40's target rows are the boxes with
    particles and cover each particle once."""
    from test_torch_laplace3d import assert_rows_cover
    trav = (points[2] if tree_of == "sources_are_targets"
            else starfish_case[0])
    assert trav.tree.sources_are_targets == (tree_of ==
                                             "sources_are_targets")
    w = make_laplace_wrangler(trav, 2, pairs=True)
    assert_rows_cover(trav.tree, what, getattr(w, f"_{what}_rows"))


def test_dipole_lists_populated(points, starfish_case):
    """Both double layers' trees hold every list."""
    for trav in (points[2], starfish_case[0]):
        w = _dwrangler(trav, "f64", None)
        assert w._l3_csr is not None and w._l4_csr[2].numel() > 0
        assert trav.from_sep_siblings_lists.numel() > 0

# }}}


# {{{ the double layer, the port alone

def _dipole_direct(tgt, src, w, dip):
    """``sum_s w_s d_s . (s - t) / |t - s|^2`` in float64."""
    diff = src[:, None, :] - tgt[:, :, None]
    r2 = (diff * diff).sum(axis=0)
    return ((dip[:, None, :] * diff).sum(axis=0) / r2) @ w


@pytest.mark.parametrize("pairs", [False, True])
def test_dipoles_against_direct_sum(pairs):
    """``tests/test_laplace.py:88-110`` on the port: 2,000 uniform
    sources with standard-normal dipoles and weights, 1,500 targets,
    order 20, rel l-inf < 1e-5."""
    rng = np.random.default_rng(44)
    sources = rng.random((2, 2000))
    targets = rng.random((2, 1500))
    weights = rng.standard_normal(2000)
    dip = rng.standard_normal((2, 2000))
    trav = build_traversal(build_tree(sources, targets=targets,
                                      max_particles_in_box=20,
                                      device="cpu"))
    w = make_laplace_wrangler(trav, 20, pairs=pairs, dipole_vec=dip)
    pot = drive_fmm(w, [torch.from_numpy(weights)]).numpy().real
    assert _rel_linf(pot, _dipole_direct(targets, sources, weights,
                                         dip)) < 1e-5


@pytest.mark.parametrize("case", ["order", "rscale", "level_to_order"])
def test_dipole_pairs_match_complex(case):
    """``tests/test_laplace.py:200-225``'s cases with dipoles: the pairs
    wrangler against the complex one's real part, <= 1e-12."""
    rng = np.random.default_rng(44)
    n = 1400
    pts = rng.random((2, n))
    trav = build_traversal(build_tree(pts, max_particles_in_box=25,
                                      device="cpu"))
    q = torch.from_numpy(rng.standard_normal(n))
    kw = {"order": {"order": 5},
          "rscale": {"order": 6, "rscale": "auto"},
          "level_to_order": {"level_to_order": lambda lev: max(3, 7 - lev),
                             "rscale": "auto"}}[case]
    kw["dipole_vec"] = rng.standard_normal((2, n))
    ref = drive_fmm(make_laplace_wrangler(trav, pairs=False, **kw),
                    [q]).numpy()
    pot = drive_fmm(make_laplace_wrangler(trav, pairs=True, **kw),
                    [q]).numpy()
    assert np.abs(pot - ref.real).max() / np.abs(ref).max() <= 1e-12


@pytest.mark.parametrize("shape", [(2, N - 1), (3, N)])
def test_dipole_vec_wrong_shape_raises_2d(points, shape):
    with pytest.raises(ValueError, match="dipole_vec"):
        make_laplace_wrangler(points[2], 4, dipole_vec=np.zeros(shape))


@pytest.mark.parametrize("pairs", [False, True])
def test_dipole_factory_2d(points, pairs):
    """Both 2D wranglers take dipoles, in user order or already in tree
    order, in the wrangler's real dtype."""
    trav = points[2]
    dip = np.random.default_rng(6).standard_normal((2, N))
    w = make_laplace_wrangler(trav, 4, pairs=pairs, dipole_vec=dip)
    assert type(w) is (Laplace2DPairsExpansionWrangler if pairs
                       else Laplace2DExpansionWrangler)
    assert w.dipole_vec.dtype == torch.float64
    tree_order = w.dipole_vec.numpy()
    b = make_laplace_wrangler(trav, 4, pairs=pairs, dipole_vec=tree_order,
                              dipoles_already_reordered=True)
    assert torch.equal(w.dipole_vec, b.dipole_vec)
    np.testing.assert_array_equal(
        tree_order, dip[:, trav.tree.user_source_ids.numpy()])

# }}}
