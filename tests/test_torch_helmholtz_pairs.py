"""The real-pair Helmholtz wranglers of boxtree_torch, 2D and 3D, against
boxtree_tpu's and against the port's complex wranglers.

Each wrangler keeps ``[re | im]`` coefficient rows and returns ``(ntargets,
2)`` float64 ``[re, im]`` potentials.  Tolerances:

- each particle hook of the port (P2M, L2P, M2P, P2L, P2P; the ``*_pairs``
  terms of ``ops/helmholtz3d.py`` / ``ops/helmholtz2d.py`` and, for P2P and
  the one-particle-a-box P2M / L2P, the kernels' CPU wrappers and twins)
  against the reference's pair hook, called eagerly on the same small
  arrays, ``rscale`` off (scale 1) and on, with one particle on its box's
  centre: rel l-inf <= 1e-11 per coefficient column and per potential lane
  (the same math rounded in another order);
- the M2M, L2L and M2L operator stacks against the reference pair
  wrangler's ``_m2m_matrix`` / ``_l2l_matrix`` / ``_m2l_matrix``: row by
  row to 1e-12 of each row's largest entry;
- every stage and the whole FMM (n = 700, order 6 in 3D and 8 in 2D,
  ``rscale="auto"``) against one recorded ``drive_fmm`` of the reference
  pair wrangler per dimension on the port's traversal: 1e-11;
- the pair FMM against the port's complex FMM on the same traversal,
  ``pot[:, 0] + 1j pot[:, 1]`` to 1e-12 (``tests/test_helmholtz3d.py:170``,
  ``tests/test_helmholtz.py:183``), rscale off and on;
- complex weights raise ``TypeError``; ``level_to_order``, a complex k
  and float32 pairs raise ``NotImplementedError`` (dipoles:
  ``test_torch_helmholtz{2,3}d_dipoles.py``); ``pairs=None``
  on a CPU tree gives the complex wrangler in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.fmm.drive import FMM_STAGES
from boxtree_torch.models import (
    Helmholtz2DExpansionWrangler,
    Helmholtz2DPairsExpansionWrangler,
    Helmholtz3DExpansionWrangler,
    Helmholtz3DPairsExpansionWrangler,
    make_helmholtz_wrangler,
)
from boxtree_torch.ops import cylinder_bessel as t_cb
from boxtree_torch.ops import helmholtz2d as h2
from boxtree_torch.ops import helmholtz3d as h3
from boxtree_torch.traversal import build_traversal
from boxtree_torch.traversal.neighbors import _offsets
from boxtree_tpu.fmm import drive_fmm as jax_drive_fmm
from boxtree_tpu.models.helmholtz import (
    Helmholtz2DExpansionWrangler as JaxHelmholtz2D,
    Helmholtz2DPairsExpansionWrangler as JaxHelmholtz2DPairs,
)
from boxtree_tpu.models.helmholtz3d import (
    Helmholtz3DExpansionWrangler as JaxHelmholtz3D,
    Helmholtz3DPairsExpansionWrangler as JaxHelmholtz3DPairs,
    make_helmholtz_wrangler as jax_make_helmholtz_wrangler,
)
from test_torch_helmholtz3d import (
    _jax_traversal,
    _Recorder,
    _rel_linf,
    _rows_rel,
)
from torch_threads import one_torch_thread  # noqa: F401

N = 700
#: wavenumber and order of each dimension's case
CASES = {3: (2.0, 6), 2: (3.0, 8)}
RTOL = 1e-11
OP_RTOL = 1e-12
#: pairs against the port's complex wrangler
COMPLEX_RTOL = 1e-12
#: a coefficient lane whose largest value is below this fraction of the
#: array's is rounding noise around 0 (the columns that carry values span
#: ~1e-10 to 1 at these orders and rscales)
ZERO_LANE = 1e-12
STAGES = ["P2M", "M2M", "P2P", "M2L", "M2P", "P2L", "M2L+P2L", "L2L",
          "L2P"]


def _points(dim):
    """Points on the unit sphere (3D); in the unit square with 4/15 of them
    in [0.4, 0.5]^2 (2D), so that Lists 3 and 4 are populated."""
    rng = np.random.default_rng(21 + dim)
    if dim == 3:
        x = rng.standard_normal((3, N))
        return x / np.sqrt((x * x).sum(0))
    pts = rng.random((2, N))
    m = N * 4 // 15
    pts[:, :m] = 0.1 * rng.random((2, m)) + 0.4
    return pts


def _charges():
    return np.random.default_rng(5).standard_normal(N)


def _t(x):
    return torch.from_numpy(np.array(x))


def _err(got, ref):
    """Rel l-inf of each column (coefficient or potential lane) against its
    own largest value, worst over the columns; 1-D arrays as a whole.  With
    real charges some lanes are zero but for rounding (the real lane of
    the 2D ``n = 0`` multipole, of the 3D ``m = 0`` ones): a column whose
    largest value is below ``ZERO_LANE`` of the array's goes against the
    array's largest value."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.ndim == 1:
        return _rel_linf(got, ref)
    scale = np.abs(ref).max(axis=0)
    top = scale.max()
    scale = np.where(scale >= ZERO_LANE * top, scale, top)
    return (np.abs(got - ref).max(axis=0) / scale).max()


@pytest.fixture(scope="module")
def travs():
    """One traversal per dimension, each built on first use."""
    cache = {}

    def get(dim):
        if dim not in cache:
            cache[dim] = build_traversal(build_tree(
                _points(dim), max_particles_in_box=12 if dim == 2 else 20,
                device="cpu"))
        return cache[dim]
    return get


def _record(trav):
    """``(stages, w, jw, jpot)`` of one recorded ``drive_fmm`` of the
    reference pair wrangler with ``rscale="auto"``: each stage's reference
    output beside the port's on the reference's inputs."""
    dim = trav.tree.dimensions
    k, order = CASES[dim]
    q = _charges()
    jw = _Recorder(jax_make_helmholtz_wrangler(
        _jax_traversal(trav), k, order, pairs=True, rscale="auto"))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    ref = {name: np.asarray(v) for name, v in jw.outputs.items()}
    w = make_helmholtz_wrangler(trav, k, order, pairs=True, rscale="auto")
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
def recorded(travs):
    """:func:`_record` per dimension, each made on first use."""
    cache = {}

    def get(dim):
        if dim not in cache:
            cache[dim] = _record(travs(dim))
        return cache[dim]
    return get


# {{{ the wranglers against the reference's, stage by stage

@pytest.mark.parametrize("dim", [2, 3])
def test_lists_exercised(travs, dim):
    trav = travs(dim)
    assert trav.tree.nlevels >= 4
    assert sum(bl.count for bl in trav.from_sep_smaller_by_level) > 0
    assert trav.from_sep_bigger_lists.shape[0] > 0


def test_2d_inputs_clear_of_small_argument_region(travs):
    """The 2D stages meet the reference only where k r >= 1e-8: below it
    the reference evaluates Y at k r = 1, the port the true Y."""
    trav = travs(2)
    pts = trav.tree.sources.numpy()
    for other in (pts, trav.tree.box_centers.numpy()):
        d = pts[:, :, None] - other[:, None, :]
        r = np.sqrt((d * d).sum(0))
        assert CASES[2][0] * r[r > 0].min() >= t_cb.JN_SMALL_X


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("dim", [2, 3])
def test_stages_match_reference(recorded, dim, stage):
    stages, w = recorded(dim)[:2]
    ref, got = stages[stage]
    got = got.numpy()
    assert got.dtype == np.float64
    assert got.shape[1] == (2 if stage in ("P2P", "M2P", "L2P")
                            else w.ncoeff)
    assert _err(got, ref) <= RTOL


@pytest.mark.parametrize("op", ["M2M", "L2L", "M2L"])
@pytest.mark.parametrize("dim", [2, 3])
def test_operators_match_reference(recorded, dim, op):
    """The pair wrangler's per-level operators (as the kernels take them,
    transposed) against the reference pair wrangler's builders at the
    same translations and rscales."""
    _, w, jw, _ = recorded(dim)
    rs = w._rscale_np
    worst = 0.0
    if op == "M2L":
        classes = _offsets(dim, 3, min_inf_norm=1)
        for i in range(0, len(w._m2l_plan.used), 3):
            lev, c = w._m2l_plan.used[i]
            size = w.root_extent / (1 << lev)
            ref = jw._m2l_matrix(classes[c] * size, float(rs[lev]))
            worst = max(worst, _rows_rel(w._m2l_opsT[i].T.numpy(), ref))
    else:
        for lev in range(1, w.tree.nlevels):
            size = w.root_extent / (1 << lev)
            ops = (w._m2m_opsT if op == "M2M" else w._l2l_opsT)[lev]
            for q in range(2 ** dim):
                sign = np.array([1.0 if (q >> (dim - 1 - ax)) & 1 else -1.0
                                 for ax in range(dim)])
                off = sign * (size / 2)
                ref = (jw._m2m_matrix(-off, float(rs[lev]),
                                      float(rs[lev - 1])) if op == "M2M"
                       else jw._l2l_matrix(off, float(rs[lev - 1]),
                                           float(rs[lev])))
                worst = max(worst, _rows_rel(ops[q].T.numpy(), ref))
    assert worst <= OP_RTOL


@pytest.mark.parametrize("dim", [2, 3])
def test_fmm_matches_reference(recorded, dim):
    _, w, jw, jpot = recorded(dim)
    assert type(jw) is (JaxHelmholtz2DPairs if dim == 2
                        else JaxHelmholtz3DPairs)
    if dim == 2:
        assert w._nstart == jw._nstart
    timing = {}
    got = drive_fmm(w, [torch.from_numpy(_charges())], timing_data=timing)
    assert set(timing) == set(FMM_STAGES)
    assert got.dtype == torch.float64 and got.shape == (N, 2)
    assert _err(got.numpy(), jpot) <= RTOL

# }}}


# {{{ the particle hooks against the reference's pair hooks

HOOK_N = 30


def _hook_inputs(dim, ncoeff):
    """Offsets pre-divided by their box's rscale (the first at the origin,
    a particle on its box's centre), rscales in [0.2, 1], real charges,
    ``[re | im]`` coefficient rows, and a source set for P2P with one
    source on a target."""
    rng = np.random.default_rng(30 + dim)
    rel = rng.uniform(-0.5, 0.5, (dim, HOOK_N))
    rel[:, 0] = 0.0
    src = rng.uniform(-0.5, 0.5, (dim, HOOK_N // 2))
    src[:, 0] = rel[:, 3]
    return dict(rel=rel, s=rng.uniform(0.2, 1.0, HOOK_N),
                q=rng.standard_normal(HOOK_N),
                coef=rng.standard_normal((HOOK_N, ncoeff)), src=src,
                qs=rng.standard_normal(HOOK_N // 2))


def _hooks(dim, rscale, jw, w):
    """``{hook: (port, reference)}`` for the five pair hooks at
    :func:`_hook_inputs`, the reference's called eagerly."""
    k, order = CASES[dim]
    x = _hook_inputs(dim, w.ncoeff)
    s = x["s"] if rscale == "auto" else np.ones(HOOK_N)
    ts = _t(s)
    jsc = jnp.asarray(s) if rscale == "auto" else 1.0
    rel, jrel = _t(x["rel"]), jnp.asarray(x["rel"])
    q, coef = _t(x["q"]), _t(x["coef"])
    if dim == 3:
        ops, weight, tail = h3, (w._w_nm,), (k, order)
    else:
        ops, weight, tail = h2, (), (k, order, w._nstart)
    port = {
        "p2m": ops.p2m_terms_pairs(rel, q, ts, *weight, *tail),
        "p2l": ops.p2l_terms_pairs(rel, q, ts, *weight, *tail),
        "l2p": ops.l2p_eval_pairs(rel, coef, ts, *tail),
        "m2p": ops.m2p_eval_pairs(rel, coef, ts, *tail),
    }
    ref = {
        "p2m": jw._p2m_terms(jrel, jnp.asarray(x["q"]), jsc),
        "p2l": jw._p2l_terms(jrel, jnp.asarray(x["q"]), jsc),
        "l2p": jw._l2p_eval(jrel, jnp.asarray(x["coef"]), jsc),
        "m2p": jw._m2p_eval(jrel, jnp.asarray(x["coef"]), jsc),
    }
    # P2P: one target box, one source box, through the CPU wrapper
    one = torch.zeros(1, dtype=torch.int32)
    ns = x["src"].shape[1]
    box = (one, torch.full((1,), HOOK_N, dtype=torch.int32), one,
           torch.full((1,), ns, dtype=torch.int32), one,
           torch.tensor([0, 1], dtype=torch.int32), one)
    p2p = h3.p2p_helmholtz3d if dim == 3 else h2.p2p_helmholtz2d
    p2p_extra = (k,) if dim == 3 else (k, w._nstart)
    port["p2p"] = p2p(rel, _t(x["src"]), _t(x["qs"]), *box, *p2p_extra)
    ref["p2p"] = jw._p2p(jrel.T, jnp.asarray(x["src"]).T,
                         jnp.ones(ns, bool), jnp.asarray(x["qs"]))
    return {h: (port[h].numpy(), np.asarray(ref[h])) for h in port}, x


@pytest.fixture(scope="module")
def hooks(recorded):
    """:func:`_hooks` per (dimension, rscale), each made on first use."""
    cache = {}

    def get(dim, rscale):
        if (dim, rscale) not in cache:
            _, w, jw, _ = recorded(dim)
            cache[dim, rscale] = _hooks(dim, rscale, jw, w)
        return cache[dim, rscale]
    return get


@pytest.mark.parametrize("hook", ["p2m", "l2p", "m2p", "p2l", "p2p"])
@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("dim", [2, 3])
def test_hooks_match_reference(hooks, dim, rscale, hook):
    (got, ref), x = hooks(dim, rscale)[0][hook], hooks(dim, rscale)[1]
    assert _err(got, ref) <= RTOL
    nc = got.shape[-1] // 2
    if hook == "p2m" and dim == 3:
        # r = 0: q w_c in the imaginary lane of coefficient 0 alone
        assert (np.delete(got[0], nc) == 0).all()
        assert got[0, nc] == ref[0, nc] != 0
    elif hook == "p2m":
        # r = 0: J_n(0) = [n == 0], so 0.25 q in the imaginary lane of n = 0
        order = CASES[2][1]
        assert (np.delete(got[0], nc + order) == 0).all()
        assert got[0, nc + order] == 0.25 * x["q"][0]
    elif hook == "l2p" and dim == 3:
        # r = 0: (loc[0], loc[K])
        kc = x["coef"].shape[1] // 2
        assert (got[0] == x["coef"][0, [0, kc]]).all()
    elif hook in ("m2p", "p2l"):
        assert (got[0] == 0).all() and (ref[0] == 0).all()


@pytest.mark.parametrize("via", ["wrapper", "twin"])
@pytest.mark.parametrize("which", ["p2m", "l2p"])
@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("dim", [2, 3])
def test_p2m_l2p_one_particle_a_box(recorded, hooks, dim, rscale, which,
                                    via):
    """The P2M / L2P kernels' CPU wrappers and twins on pair rows (K50 /
    K51, K55 / K56 on the card), one particle a box (centre 0, scale s_i,
    the first on its centre), against the reference's hooks."""
    w = recorded(dim)[1]
    ref = hooks(dim, rscale)[0][which][1]
    x = hooks(dim, rscale)[1]
    s = x["s"] if rscale == "auto" else np.ones(HOOK_N)
    i32 = torch.arange(HOOK_N, dtype=torch.int32)
    ranges = (i32, torch.ones(HOOK_N, dtype=torch.int32), i32)
    centers = torch.zeros((dim, HOOK_N), dtype=torch.float64)
    pts = _t(x["rel"] * s)
    ops = h3 if dim == 3 else h2
    name = f"{which}_helmholtz{dim}d"
    fn = getattr(ops, name if via == "wrapper" else f"{name}_plain")
    k, order = CASES[dim]
    tail = (k, order) if dim == 3 else (k, order, w._nstart)
    if which == "p2m":
        weight = (w._w_nm,) if dim == 3 else ()
        got = fn(pts, _t(x["q"]), *ranges, centers, _t(s), *weight, *tail)
    else:
        got = fn(pts, *ranges, _t(x["coef"]), centers, _t(s), *tail)
    assert got.dtype == torch.float64
    assert _err(got.numpy(), ref) <= RTOL

# }}}


# {{{ the pair FMM against the port's complex FMM, and the factory

@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("dim", [2, 3])
def test_pairs_match_complex(travs, dim, rscale):
    trav = travs(dim)
    k, order = CASES[dim]
    q = torch.from_numpy(_charges())
    ref = drive_fmm(make_helmholtz_wrangler(trav, k, order, pairs=False,
                                            rscale=rscale), [q]).numpy()
    pot = drive_fmm(make_helmholtz_wrangler(trav, k, order, pairs=True,
                                            rscale=rscale), [q]).numpy()
    assert pot.shape == (N, 2)
    assert _rel_linf(pot[:, 0] + 1j * pot[:, 1], ref) <= COMPLEX_RTOL


@pytest.mark.parametrize("dim", [2, 3])
def test_factory_pairs(travs, dim):
    """``pairs=True`` gives the pair wrangler, with a complex ``dtype=``
    taken as its real counterpart; ``pairs=None`` on a CPU tree gives the
    complex wrangler, as the reference's on a CPU backend."""
    trav = travs(dim)
    k = CASES[dim][0]
    pairs_cls = (Helmholtz2DPairsExpansionWrangler if dim == 2
                 else Helmholtz3DPairsExpansionWrangler)
    complex_cls = (Helmholtz2DExpansionWrangler if dim == 2
                   else Helmholtz3DExpansionWrangler)
    for kw in (dict(), dict(dtype=np.complex128), dict(dtype="float64")):
        w = make_helmholtz_wrangler(trav, k, 2, pairs=True, **kw)
        assert type(w) is pairs_cls and w.dtype == torch.float64
        assert w.ncoeff == 2 * (9 if dim == 3 else 5)
        assert w.output_zeros().shape == (N, 2)
    assert type(make_helmholtz_wrangler(trav, k, 2)) is complex_cls
    jw = jax_make_helmholtz_wrangler(_jax_traversal(trav), k, 2)
    assert type(jw) is (JaxHelmholtz2D if dim == 2 else JaxHelmholtz3D)


@pytest.mark.parametrize("dim", [2, 3])
def test_complex_weights_raise(travs, dim):
    w = make_helmholtz_wrangler(travs(dim), CASES[dim][0], 2, pairs=True)
    with pytest.raises(TypeError):
        drive_fmm(w, [torch.from_numpy(_charges() + 0j)])


_PAIR_OPTIONS = [
    (2.0, dict(level_to_order=lambda lev: 2)),
    (2.0 + 0.5j, dict()),
    (2.0, dict(dtype=np.float32)),
    (2.0, dict(dtype=np.complex64)),
]


@pytest.mark.parametrize("dim,k,kwargs", [
    # ids as before dipoles were ported (test_torch_helmholtz{2,3}d_dipoles.py)
    pytest.param(dim, k, kwargs, id=f"{dim}-{k}-kwargs{i}")
    for dim in (2, 3)
    for i, (k, kwargs) in enumerate(_PAIR_OPTIONS, start=1)])
def test_unported_pair_options_raise(travs, dim, k, kwargs):
    trav = travs(dim)
    with pytest.raises(NotImplementedError):
        make_helmholtz_wrangler(trav, k, 2, pairs=True, **kwargs)


def test_pairs_class_refuses_complex_k(travs):
    from boxtree_torch.models import Helmholtz3DTreeIndependentDataForWrangler
    ti = Helmholtz3DTreeIndependentDataForWrangler(2.0 + 0.5j, 2)
    with pytest.raises(NotImplementedError):
        Helmholtz3DPairsExpansionWrangler(ti, travs(3))

# }}}
