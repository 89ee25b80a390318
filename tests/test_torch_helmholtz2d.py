"""The 2D Helmholtz FMM of boxtree_torch (complex128): its Bessel functions,
basis, factory and accuracy.

- The cylindrical Bessel twin against scipy on the arguments of
  ``tests/test_helmholtz.py``'s oracle (J to 1e-12 absolute, Y to 1e-11
  relative) and its small-x branch; the host-side scaled values against
  the JAX package's (1e-13 relative); one copy of ``miller_start``.
- The expansion basis against scipy's ``jv``/``hankel1``, the r = 0 and
  small-x edges included (1e-12 per coefficient column).
- At order 16, the port against scipy's direct sum (< 1e-5) on the
  reference test's 1,500 clustered points, sources = targets and split
  targets.
- The factory's dispatch, each option the port does not cover in 2D, the
  numpy bridge both ways on a 2D traversal, and K16-K18's entry points.
- Against ``boxtree_tpu``, at order 8 with ``rscale`` None and ``"auto"``:
  every FMM stage (rel l-inf <= 1e-11, expansions per coefficient, each
  column against its own largest entry, since the columns span many
  decades), the per-level M2M, L2L and M2L operators (row by row to 1e-12
  of each row's largest entry, on the unscaled and the scaled branches)
  and the whole slice (1e-11).  Both packages run on the port's tree and
  traversal (handed to ``boxtree_tpu`` in its own containers), each port
  stage gets the reference's inputs, and the reference's stage outputs are
  those of its one recorded ``drive_fmm`` per rscale; also the cylindrical
  Bessel twin against the JAX function.
- The P2M and L2P terms (``p2m_terms`` / ``l2p_eval``) and the twins of
  K33 / K34, through their CPU wrappers too, against the reference's
  hooks ``_p2m_terms`` / ``_l2p_eval`` under one ``jax.jit``, with a
  particle on its box's centre (``r = 0``) and two within k r < 1e-8 of it
  (the series of J), ``rscale`` off (scale 1) and on (1e-11, expansions per
  coefficient column); the rows of K33 / K34 cover every particle once.
- With standard-normal dipoles, the dipole P2M, P2P and P2L stages and
  the slice against one more recorded JAX ``drive_fmm`` (``rscale="auto"``,
  1e-11), recorded after the charge one on the same traversal, whose
  compiles it reuses (``test_torch_helmholtz2d_dipoles.py`` holds the rest
  of the dipole path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special as sp

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.fmm.drive import FMM_STAGES
from boxtree_torch.models import (
    Helmholtz2DExpansionWrangler,
    HelmholtzTreeIndependentDataForWrangler,
    make_helmholtz_wrangler,
)
from boxtree_torch.ops import cylinder_bessel as t_cb
from boxtree_torch.ops import helmholtz2d as h2
from boxtree_torch.ops import kernels
from boxtree_torch.ops import scaled_bessel_host as t_sbh
from boxtree_torch.traversal import build_traversal
from boxtree_torch.traversal.neighbors import _offsets
from boxtree_torch.utils.bridge import to_numpy, traversal_from_numpy
from boxtree_tpu.fmm import drive_fmm as jax_drive_fmm
from boxtree_tpu.models.helmholtz3d import (
    make_helmholtz_wrangler as jax_make_helmholtz_wrangler,
)
from boxtree_tpu.ops import cylinder_bessel as j_cb
from boxtree_tpu.ops import scaled_bessel_host as j_sbh
from test_torch_helmholtz3d import (
    _jax_traversal,
    _Recorder,
    _rel_linf,
    _rows_rel,
)
from torch_threads import one_torch_thread  # noqa: F401
from torch_translate import parent_block_m2l

K = 3.0
N = 800
ORDER = 8
RTOL = 1e-11
OP_RTOL = 1e-12
RSCALES = (None, "auto")
STAGES = ["P2M", "M2M", "P2P", "M2L", "M2P", "P2L", "M2L+P2L", "L2L",
          "L2P"]


def clustered(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((2, n))
    m = n * 400 // 1500
    pts[:, :m] = 0.1 * rng.random((2, m)) + 0.4
    return pts


def charges(n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _direct(targets, sources, q):
    d = targets[:, :, None] - sources[:, None, :]
    r = np.sqrt((d * d).sum(0))
    return np.where(r > 0, 0.25j * sp.hankel1(0, K * np.where(r > 0, r, 1)),
                    0) @ q


# {{{ Bessel functions

def oracle_args():
    """``tests/test_helmholtz.py:79-102``'s arguments."""
    rng = np.random.default_rng(3)
    return np.concatenate([rng.uniform(1e-6, 0.5, 50),
                           rng.uniform(0.5, 5.0, 100),
                           rng.uniform(5.0, 40.0, 100),
                           sp.jn_zeros(0, 3)])


def check_jy(x, p, j_ref, y_ref):
    """The twin's J_n/Y_n at *x* against a reference: J to 1e-12
    absolute, Y to 1e-11 relative (absolute below 1)."""
    j, y = (v.numpy() for v in t_cb.cylindrical_jy(
        torch.from_numpy(x), p, nstart=t_cb.miller_start(p, 40.0)))
    assert j.shape == j_ref.shape == (len(x), p + 1)
    assert np.abs(j - j_ref).max() < 1e-12
    assert (np.abs(y - y_ref) / np.maximum(np.abs(y_ref), 1.0)).max() < 1e-11


def test_cylindrical_jy_twin():
    x = oracle_args()
    n = np.arange(25)[None, :]
    check_jy(x, 24, sp.jv(n, x[:, None]), sp.yv(n, x[:, None]))


def test_cylindrical_jy_against_jax():
    """The twin against the JAX function on the same arguments, none below
    the series switch: there the reference evaluates Y at x = 1 (its
    fault), the port the true Y (:func:`test_cylindrical_y_small_x`)."""
    x = oracle_args()
    assert x.min() >= t_cb.JN_SMALL_X
    j_ref, y_ref = (np.asarray(v) for v in j_cb.cylindrical_jy(
        jnp.asarray(x), 24, nstart=j_cb.miller_start(24, 40.0)))
    check_jy(x, 24, j_ref, y_ref)


def test_cylindrical_j_small_x():
    """Below |x| < 1e-8 J_n is its leading series term ``(x/2)^n / n!``,
    as in the reference."""
    x = np.array([0.0, 1e-12, 3e-9, -5e-9, 2e-8])
    j, _ = t_cb.cylindrical_jy(torch.from_numpy(x), 6, nstart=20)
    n = np.arange(7)[None, :]
    series = (x[:, None] / 2) ** n / sp.factorial(n)
    np.testing.assert_allclose(j.numpy()[:4], series[:4], rtol=1e-15, atol=0)
    assert np.abs(j.numpy() - sp.jv(n, x[:, None])).max() < 1e-15


@pytest.mark.parametrize("x", [1e-12, 3.7e-11, 1e-10, 2.2e-9, 9.9e-9])
def test_cylindrical_y_small_x(x):
    """Below |x| < 1e-8 the twin's Y_n, n = 0..16, against scipy's yv
    (1e-13 relative): the upward recurrence from the leading terms ``Y_0 =
    (2/pi)(ln(x/2) + g)`` and ``Y_1 = -2/(pi x)``
    (:func:`test_cylindrical_j_small_x` holds J_n there)."""
    p = 16
    _, y = (v.numpy()[0] for v in t_cb.cylindrical_jy(
        torch.tensor([x], dtype=torch.float64), p, nstart=20))
    n = np.arange(p + 1)
    ref = sp.yv(n, x)
    assert np.isfinite(ref).all()
    assert (np.abs(y - ref) / np.abs(ref)).max() < 1e-13


@pytest.mark.parametrize("fn", ["jv_scaled", "yv_scaled", "hankel1_scaled"])
@pytest.mark.parametrize("x,s", [(1e-4, 5e-5), (0.37, 0.25),
                                 (2.404825557695773, 1.0), (40.0, 1.0)])
def test_scaled_bessel_host_cylindrical(fn, x, s):
    got = getattr(t_sbh, fn)(x, 32, s)
    ref = getattr(j_sbh, fn)(x, 32, s)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert (np.abs(got - ref) <= 1e-13 * np.abs(ref)).all()


def test_miller_start_one_copy():
    assert t_sbh.miller_start is t_cb.miller_start
    for p in (0, 5, 18, 60):
        for xmax in (0.0, 0.3, 11.5, 120.0):
            assert t_cb.miller_start(p, xmax) == j_cb.miller_start(p, xmax)

# }}}


# {{{ the basis

def test_basis_against_scipy():
    """The J and H bases against scipy's ``jv``/``hankel1`` at offsets that
    include r = 0 (the J kind's one-hot limit, the H kind's mask) and k r
    below the series switch (there the port takes Y's small-argument
    terms; the reference, which evaluates Y at k r = 1, would fail the H
    kind)."""
    order, nstart = 8, 46
    rng = np.random.default_rng(4)
    rel = np.concatenate([rng.uniform(-0.5, 0.5, (2, 30)),
                          [[0.0, 1e-10, 0.0, -2e-9], [0.0, 0.0, 1e-10, 1e-9]]],
                         axis=1)
    scale = np.concatenate([np.full(17, 1.0), rng.uniform(0.01, 1.0, 17)])
    x = rel * scale
    r = np.hypot(x[0], x[1])
    th = np.arctan2(x[1], x[0])
    ns = np.arange(-order, order + 1)
    m = np.abs(ns)
    sign = np.where(ns < 0, (-1.0) ** m, 1.0)
    assert ((K * r > 0) & (K * r < t_cb.JN_SMALL_X)).sum() == 3
    for kind, conj in (("J", -1), ("J", 1), ("H", 1), ("H", -1)):
        got, ok = h2.basis(torch.from_numpy(rel), kind, conj,
                           torch.from_numpy(scale), K, order, nstart)
        got, ok = got.numpy(), ok.numpy()
        np.testing.assert_array_equal(ok, r > 0)
        fn = sp.jv if kind == "J" else sp.hankel1
        radial = fn(m[None, :], K * np.where(r > 0, r, 1.0)[:, None])
        ref = radial * sign * np.exp(1j * conj * ns * th[:, None]) \
            * scale[:, None] ** ((-1 if kind == "J" else 1) * m)
        if kind == "J":
            ref[r == 0] = ns == 0
            assert _rows_rel(got.T, ref.T) <= OP_RTOL
        else:
            assert _rows_rel(got[ok].T, ref[ok].T) <= OP_RTOL


# }}}


# {{{ the port alone against the direct sum, order 16

@pytest.mark.parametrize("split", [False, True])
def test_order16_against_direct_sum(split):
    """``tests/test_helmholtz.py:23-46`` on the port: 1,500 sources, 400 of
    them clustered, k = 3, order 16, sources = targets or 1,000 separate
    targets."""
    rng = np.random.default_rng(23)
    sources = rng.random((2, 1500))
    sources[:, :400] = 0.1 * rng.random((2, 400)) + 0.4
    q = rng.standard_normal(1500) + 1j * rng.standard_normal(1500)
    targets = rng.random((2, 1000)) if split else None
    trav = build_traversal(build_tree(sources, targets=targets,
                                      max_particles_in_box=20, device="cpu"))
    w = make_helmholtz_wrangler(trav, K, 16, rscale="auto")
    got = drive_fmm(w, [torch.from_numpy(q)]).numpy()
    ref = _direct(targets if split else sources, sources, q)
    assert _rel_linf(got, ref) < 1e-5

# }}}


# {{{ the factory, the options, the plumbing

@pytest.fixture(scope="module")
def points():
    pts = clustered(N, seed=7)
    trav = build_traversal(build_tree(pts, max_particles_in_box=12,
                                      device="cpu"))
    return pts, charges(N), trav


def test_factory_dispatch(points):
    w = make_helmholtz_wrangler(points[2], K, 6)
    assert type(w) is Helmholtz2DExpansionWrangler
    assert isinstance(w.tree_indep, HelmholtzTreeIndependentDataForWrangler)
    assert w.dtype == torch.complex128 and w.real_dtype == torch.float64
    assert w.ncoeff == 13 and w._rscale_factor() == K
    w = make_helmholtz_wrangler(points[2], K + 0j, 6, dtype="complex128")
    assert type(w) is Helmholtz2DExpansionWrangler and w.k == K
    with pytest.raises(NotImplementedError):
        HelmholtzTreeIndependentDataForWrangler(3, K, 6)


@pytest.mark.parametrize("k,kwargs", [
    (K, dict(pairs=True, dtype=np.float32)),
    (K, dict(level_to_order=lambda lev: 4)),
    (3.0 + 0.5j, dict(rscale="auto")),
    (3.0 + 0.5j, dict()),
    (K, dict(dtype=np.complex64)),
    (K, dict(dtype="float64")),
], ids=[  # as before dipoles were ported (test_torch_helmholtz2d_dipoles.py)
    "3.0-kwargs0", "3.0-kwargs2", "(3+0.5j)-kwargs3", "(3+0.5j)-kwargs4",
    "3.0-kwargs5", "3.0-kwargs6"])
def test_unported_options_raise_2d(points, k, kwargs):
    with pytest.raises(NotImplementedError):
        make_helmholtz_wrangler(points[2], k, 4, **kwargs)


def test_bridge_round_trip_2d(points):
    """A 2D traversal through numpy and back equals itself, field for
    field (the JAX containers of these tests are built from the same
    numpy fields)."""
    trav = points[2]
    back = traversal_from_numpy(_jax_traversal(trav))
    a, b = to_numpy(trav), to_numpy(back)
    assert a.keys() == b.keys()
    for name in a:
        if name == "tree":
            assert a[name].keys() == b[name].keys()
            for f in a[name]:
                np.testing.assert_array_equal(np.asarray(a[name][f]),
                                              np.asarray(b[name][f]), f)
        elif name == "from_sep_smaller_by_level":
            for x, y in zip(a[name], b[name], strict=True):
                for f in x:
                    np.testing.assert_array_equal(x[f], y[f])
        else:
            va, vb = a[name], b[name]
            if isinstance(va, tuple):
                assert len(va) == len(vb)
                for x, y in zip(va, vb):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                              name)


def test_kernel_entry_points_2d():
    """K16-K18 and K33-K34 exist in complex128 and, as K52-K56, in float64
    pairs; their shared memory holds tables of 2p + 1 and p + 1 values a
    lane, whatever the recurrence's start: a start of 2000 (k r about
    1,700) is accepted, its ratios going to a global scratch buffer of
    nstart values a thread of the launch's grid, and only a dtype other
    than complex128 and float64 raises."""
    names = ("p2p_helmholtz2d", "m2p_helmholtz2d", "p2l_helmholtz2d",
             "p2m_helmholtz2d", "l2p_helmholtz2d")
    for name in names:
        assert kernels._entry_names(name) == [f"{name}_f64",
                                              f"{name}_c128"]
    for order, nstart in ((16, 56), (24, 70), (16, 338), (16, 2000)):
        h2._check_args(K, torch.complex128, order)
        h2._check_args(K, torch.float64, order)
        assert max(h2.smem_bytes(name, order) for name in
                   ("m2p", "p2l", "p2m", "l2p")) < 48 * 1024
        assert h2.scratch_bytes(1056, order, nstart) == \
            t_cb.even_start(nstart, order) * 1056 * 32 * 8
    with pytest.raises(TypeError):
        h2._check_args(K, torch.complex64, 16)

# }}}


# {{{ against boxtree_tpu's recorded FMMs, stage by stage

def _t(x):
    return torch.from_numpy(np.array(x))


def _record(trav, q, rscale):
    """``(stages, w, jw, jpot)``: each stage's reference and port output,
    the port's and the reference's wranglers, and the reference's
    potentials, from one recorded JAX ``drive_fmm`` at *rscale*."""
    jw = _Recorder(jax_make_helmholtz_wrangler(
        _jax_traversal(trav), K, ORDER, pairs=False, rscale=rscale))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    ref = {name: np.asarray(v) for name, v in jw.outputs.items()}
    w = make_helmholtz_wrangler(trav, K, ORDER, pairs=False, rscale=rscale)
    tq = w.reorder_sources(torch.from_numpy(q))

    # each port stage gets the reference's inputs
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
    """:func:`_record` per rscale, each made on first use."""
    _, q, trav = points
    cache = {}

    def get(rscale):
        if rscale not in cache:
            cache[rscale] = _record(trav, q, rscale)
        return cache[rscale]
    return get


@pytest.fixture(scope="module")
def recorded_dipoles(points, recorded):
    """The reference's FMM with standard-normal dipoles (``rscale="auto"``),
    recorded stage by stage after the charge recording, whose compiles it
    reuses, and the port's wrangler with the same dipoles."""
    _, q, trav = points
    recorded("auto")
    dip = np.random.default_rng(17).standard_normal((2, N))
    jw = _Recorder(jax_make_helmholtz_wrangler(
        _jax_traversal(trav), K, ORDER, pairs=False, rscale="auto",
        dipole_vec=jnp.asarray(dip)))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    ref = {name: np.asarray(v) for name, v in jw.outputs.items()}
    w = make_helmholtz_wrangler(trav, K, ORDER, pairs=False, rscale="auto",
                                dipole_vec=dip)
    return ref, jpot, w, dip


def test_list_stages_exercised(points):
    trav = points[2]
    assert trav.tree.dimensions == 2 and trav.tree.nlevels >= 5
    assert sum(bl.count for bl in trav.from_sep_smaller_by_level) > 0
    assert trav.from_sep_bigger_lists.shape[0] > 0


def test_stage_inputs_clear_of_small_argument_region(points):
    """The stages meet the reference only where k r >= 1e-8 for every
    particle pair and every particle and box centre: below it the
    reference evaluates Y at k r = 1, the port the true Y."""
    pts, _, trav = points
    centers = trav.tree.box_centers.numpy()
    for other in (pts, centers):
        d = pts[:, :, None] - other[:, None, :]
        r = np.sqrt((d * d).sum(0))
        assert K * r[r > 0].min() >= t_cb.JN_SMALL_X


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("rscale", RSCALES)
def test_stages_match_reference(recorded, rscale, stage):
    ref, got = recorded(rscale)[0][stage]
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype == np.complex128
    # expansions: each coefficient's column to its own scale
    err = _rows_rel(got.T, ref.T) if got.ndim == 2 else _rel_linf(got, ref)
    assert err <= RTOL


@pytest.mark.parametrize("rscale", RSCALES)
def test_m2l_parent_blocks_match_reference(recorded, rscale):
    """What K35 computes, from the plan's own tables, against the
    reference's M2L on its own multipoles."""
    stages, w = recorded(rscale)[:2]
    got = parent_block_m2l(_t(stages["M2M"][0]), w._m2l_plan).numpy()
    assert _rows_rel(got.T, np.asarray(stages["M2L"][0]).T) <= RTOL

@pytest.mark.parametrize("op", ["M2M", "L2L", "M2L"])
@pytest.mark.parametrize("rscale", RSCALES)
def test_level_operators_match_reference(recorded, rscale, op):
    """The wrangler's per-level operators against the JAX builders
    (``_m2m_matrix``, ``_l2l_matrix``, ``_m2l_matrix``) at the same
    translations and rscales: unscaled everywhere without rscale, both
    branches with it (levels 0-1 have rscale 1)."""
    _, w, jw, _ = recorded(rscale)
    rs = w._rscale_np
    assert (rs == 1.0).all() if rscale is None else (
        (rs == 1.0).any() and (rs < 1.0).any())
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


@pytest.mark.parametrize("rscale", RSCALES)
def test_slice_matches_reference(points, recorded, rscale):
    """The port's ``drive_fmm`` against the reference's potentials, and
    the recurrence's start order against the reference wrangler's."""
    q = points[1]
    _, w, jw, jpot = recorded(rscale)
    assert w._nstart == jw._nstart
    assert t_cb.even_start(w._nstart, w.order) % 2 == 0
    timing = {}
    got = drive_fmm(w, [torch.from_numpy(q)], timing_data=timing)
    assert got.dtype == torch.complex128 and got.shape == (N,)
    assert set(timing) == set(FMM_STAGES)
    assert _rel_linf(got.numpy(), jpot) <= RTOL

@pytest.mark.parametrize("stage", ["P2M", "P2P", "P2L"])
def test_dipole_stages_match_reference(points, recorded_dipoles, stage):
    """The dipole P2M, P2P and P2L (the twins of K63-K65) against the
    reference's JVPs of its hooks, on the same traversal."""
    _, q, trav = points
    ref, _, w, _ = recorded_dipoles
    tq = w.reorder_sources(torch.from_numpy(q))
    if stage == "P2M":
        got = w.form_multipoles(trav.level_start_source_box_nrs,
                                trav.source_boxes, [tq])
        want = ref["form_multipoles"]
    elif stage == "P2P":
        got = w.eval_direct(trav.target_boxes,
                            trav.neighbor_source_boxes_starts,
                            trav.neighbor_source_boxes_lists, [tq])
        want = ref["eval_direct"]
    else:
        got = w.form_locals(trav.level_start_target_or_target_parent_box_nrs,
                            trav.target_or_target_parent_boxes,
                            trav.from_sep_bigger_starts,
                            trav.from_sep_bigger_lists, [tq])
        want = ref["form_locals"]
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = _rows_rel(got.T, want.T) if got.ndim == 2 else _rel_linf(got,
                                                                   want)
    assert err <= RTOL


def test_dipole_slice_matches_reference(points, recorded_dipoles):
    q, trav = points[1:]
    _, jpot, _, dip = recorded_dipoles
    w = make_helmholtz_wrangler(trav, K, ORDER, rscale="auto",
                                dipole_vec=dip)
    timing = {}
    got = drive_fmm(w, [torch.from_numpy(q)], timing_data=timing)
    assert got.dtype == torch.complex128 and got.shape == (N,)
    assert set(timing) == set(FMM_STAGES)
    assert _rel_linf(got.numpy(), jpot) <= RTOL

# }}}


# {{{ P2M / L2P: K33 and K34's twins against the reference's hooks

HOOK_N = 40


def _hook_inputs():
    """Offsets pre-divided by their box's rscale: the first at the origin,
    the next two within k r < 1e-8 of it at any rscale; rscales in [0.01,
    1], complex charges and local coefficients."""
    rng = np.random.default_rng(4)
    nc = 2 * ORDER + 1
    rel = rng.uniform(-0.5, 0.5, (2, HOOK_N))
    rel[:, 0] = 0.0
    rel[:, 1] = [1e-10, 0.0]
    rel[:, 2] = [-2e-10, 1e-10]
    return dict(rel=rel, s=rng.uniform(0.01, 1.0, HOOK_N),
                q=rng.standard_normal(HOOK_N)
                + 1j * rng.standard_normal(HOOK_N),
                coef=rng.standard_normal((HOOK_N, nc))
                + 1j * rng.standard_normal((HOOK_N, nc)))


@pytest.fixture(scope="module")
def hook_refs(recorded):
    """The reference's ``_p2m_terms`` and ``_l2p_eval`` at
    :func:`_hook_inputs`, with the scale 1 that ``rscale=None`` hands them
    and with the rscales, in one ``jax.jit``."""
    jw = recorded("auto")[2]
    x = _hook_inputs()

    def f(rel, s, q, coef):
        return {f"{hook}-{rscale}": fn(rel, arg, sc)
                for rscale, sc in ((None, 1.0), ("auto", s))
                for hook, fn, arg in (("p2m", jw._p2m_terms, q),
                                      ("l2p", jw._l2p_eval, coef))}
    out = jax.jit(f)(x["rel"], x["s"], x["q"], x["coef"])
    return {key: np.asarray(v) for key, v in out.items()}


def _hook_scale(rscale):
    x = _hook_inputs()
    return x["s"] if rscale == "auto" else np.ones(HOOK_N)


def _hook_err(got, ref):
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    return _rows_rel(got.T, ref.T) if got.ndim == 2 else _rel_linf(got, ref)


def test_hook_inputs_reach_the_series():
    x = _hook_inputs()
    for rscale in RSCALES:
        kr = K * np.hypot(*(x["rel"] * _hook_scale(rscale)))
        assert kr[0] == 0 and (kr[1:3] > 0).all()
        assert (kr[1:3] < t_cb.JN_SMALL_X).all()
        assert (kr[3:] >= t_cb.JN_SMALL_X).all()


@pytest.mark.parametrize("rscale", RSCALES)
@pytest.mark.parametrize("hook", ["p2m", "l2p"])
def test_particle_hooks_match_reference(recorded, hook_refs, hook, rscale):
    """``p2m_terms`` and ``l2p_eval``, the per-particle steps of K33 /
    K34's twins, against the reference's hooks."""
    x = {k: _t(v) for k, v in _hook_inputs().items()}
    s = _t(_hook_scale(rscale))
    nstart = recorded("auto")[1]._nstart
    if hook == "p2m":
        got = h2.p2m_terms(x["rel"], x["q"], s, K, ORDER, nstart)
    else:
        got = h2.l2p_eval(x["rel"], x["coef"], s, K, ORDER, nstart)
    assert _hook_err(got, hook_refs[f"{hook}-{rscale}"]) <= RTOL


@pytest.mark.parametrize("via", ["wrapper", "twin"])
@pytest.mark.parametrize("rscale", RSCALES)
@pytest.mark.parametrize("which", ["p2m", "l2p"])
def test_p2m_l2p_twins_match_reference_hooks(recorded, hook_refs, which,
                                            rscale, via):
    """K33 and K34's twins and their CPU wrappers, one particle per box
    (centre 0, scale s_i), against the reference's ``_p2m_terms`` and
    ``_l2p_eval`` at the same scaled offsets.  The first particle sits on
    its box's centre (``r = 0``): its charge lands on ``n = 0`` alone, as
    ``(i/4) q``, and its potential is ``b_0``."""
    x = _hook_inputs()
    nstart = recorded("auto")[1]._nstart
    ref = hook_refs[f"{which}-{rscale}"]
    s = _hook_scale(rscale)
    i32 = torch.arange(HOOK_N, dtype=torch.int32)
    ranges = (i32, torch.ones(HOOK_N, dtype=torch.int32), i32)
    centers = torch.zeros((2, HOOK_N), dtype=torch.float64)
    pts = _t(x["rel"] * s)
    name = f"{which}_helmholtz2d"
    fn = getattr(h2, name if via == "wrapper" else f"{name}_plain")
    if which == "p2m":
        got = fn(pts, _t(x["q"]), *ranges, centers, _t(s), K, ORDER,
                 nstart)
        row0 = got[0].numpy()
        others = np.arange(2 * ORDER + 1) != ORDER
        assert (row0[others] == 0).all() and (ref[0][others] == 0).all()
        assert row0[ORDER] == ref[0][ORDER] == 0.25j * x["q"][0]
    else:
        got = fn(pts, *ranges, _t(x["coef"]), centers, _t(s), K, ORDER,
                 nstart)
        assert got[0] == ref[0] == x["coef"][0, ORDER]
    assert _hook_err(got, ref) <= RTOL


@pytest.mark.parametrize("what", ["source", "target"])
def test_particle_rows_cover_each_particle_once(recorded, what):
    from test_torch_laplace3d import assert_rows_cover
    w = recorded("auto")[1]
    assert_rows_cover(w.tree, what, getattr(w, f"_{what}_rows"))

# }}}
