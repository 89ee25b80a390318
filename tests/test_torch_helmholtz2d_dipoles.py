"""The 2D Helmholtz dipole sources of boxtree_torch against boxtree_tpu's.

A dipole source of weight ``q`` and dipole ``d`` has the potential ``q (d .
grad_y) (i/4) H_0(k |x - y|)``; P2M, P2P and P2L of the dipole wranglers
are the JVPs of the charge stages in the source positions
(``boxtree_tpu/models/expansion_base.py:664-673``, ``:1314-1324``,
``:1688-1694``), the kernels K63-K65 (complex128) and K66-K68 (pairs).
``test_torch_helmholtz2d.py`` holds the dipole stages and the slice against
a recorded JAX ``drive_fmm``; this file holds the rest.

- The cylindrical Bessel twin's tangents under ``torch.func.jvp`` (the
  reference's ``dF_n/dx = (F_{n-1} - F_{n+1}) / 2``, one order up) against
  scipy's ``jvp`` / ``yvp`` and against JAX's custom JVPs of ``_device_JH``
  and ``_device_JY``; the values bit for bit those without the JVP.
- The dipole terms (``p2m_dipole_terms``, ``p2l_dipole_terms`` and their
  ``_pairs``), the plain twins and the CPU wrappers of K63-K68 against
  ``jax.jvp`` of the reference's hooks ``_p2m_terms`` / ``_p2l_terms`` /
  ``_p2p`` (complex and pair classes) in one ``jax.jit`` per layout, with
  scale 1 (rscale None) and rscales, a source at ``k r < 1e-6`` among them,
  and P2P with a source on a target (skipped); 1e-12 per coefficient
  column and potential lane.  The hooks are called on bare reference
  wranglers that hold only what they read (order, k, the coefficient
  index and the recurrence's start), so that no JAX wrangler is built.
- The dipole P2M at ``r = 0``: the reference's guard gives 0 there (it
  drops the dipole moment); the port takes the limit of the tangent, held
  to the reference's tangent at ``rel = 1e-9 d`` within 1e-6.
- ``tests/test_helmholtz.py:49-75`` and ``:128-151`` on the port, against
  their direct sums (< 1e-5); the pair wrangler against the port's complex
  one on real charges (<= 1e-12); the dipoles' reorder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special as sp

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import make_helmholtz_wrangler
from boxtree_torch.ops import cylinder_bessel as t_cb
from boxtree_torch.ops import helmholtz2d as h2
from boxtree_torch.traversal import build_traversal
from boxtree_tpu.models.helmholtz import (
    Helmholtz2DExpansionWrangler as JaxComplex,
    Helmholtz2DPairsExpansionWrangler as JaxPairs,
    _device_JH,
    _device_JY,
)
from test_torch_helmholtz3d import _rel_linf, _t
from torch_threads import one_torch_thread  # noqa: F401

K = 3.0
ORDER = 8
#: the recurrence's start of a wrangler of order 8 at k = 3 on the unit
#: square (``helmholtz.py:133-135``)
NSTART = t_cb.miller_start(ORDER + 2, K * (2.0 * np.sqrt(2.0) + 1.0))
RTOL = 1e-12
PAIRS_RTOL = 1e-12
DIRECT_RTOL = 1e-5
#: the port's r = 0 limit against the reference's tangent at r = 1e-9
LIMIT_RTOL = 1e-6


# {{{ the Bessel tangents

_X = np.array([1e-5, 1e-3, 0.37, 2.404825557695773, 7.0, 33.0])


def _jy_jvp(x, p):
    xt = torch.from_numpy(x)
    return torch.func.jvp(
        lambda t: t_cb.cylindrical_jy(t, p, nstart=t_cb.miller_start(
            p + 2, 40.0)), (xt,), (torch.ones_like(xt),))


def test_cylindrical_tangents_against_scipy():
    """``dJ_n/dx`` and ``dY_n/dx`` (n = 0..12) against scipy's ``jvp`` /
    ``yvp``: J's to 1e-12 absolute, Y's to 1e-11 relative (absolute below
    1), as the values in ``test_torch_helmholtz2d.py``; the values are the
    recurrence's bit for bit."""
    p = 12
    (j, y), (dj, dy) = _jy_jvp(_X, p)
    j0, y0 = t_cb.cylindrical_jy(torch.from_numpy(_X), p,
                                 nstart=t_cb.miller_start(p + 2, 40.0))
    assert torch.equal(j, j0) and torch.equal(y, y0)
    n = np.arange(p + 1)[None, :]
    assert np.abs(dj.numpy() - sp.jvp(n, _X[:, None])).max() < 1e-12
    ref = sp.yvp(n, _X[:, None])
    assert (np.abs(dy.numpy() - ref) / np.maximum(np.abs(ref), 1.0)).max() \
        < 1e-11


def test_cylindrical_tangents_against_jax():
    """The same tangents against JAX's custom JVPs of ``_device_JY`` and
    ``_device_JH`` (none of the arguments below the series switch, where
    the reference's Y is at fault)."""
    p = 12
    nstart = t_cb.miller_start(p + 2, 40.0)
    _, (dj, dy) = _jy_jvp(_X, p)
    x = jnp.asarray(_X)
    one = jnp.ones_like(x)
    _, (rj, ry) = jax.jvp(lambda t: _device_JY(p, nstart, t), (x,), (one,))
    _, (hj, hh) = jax.jvp(lambda t: _device_JH(p, nstart, t), (x,), (one,))
    for got, ref in ((dj, rj), (dy, ry), (dj, hj),
                     (torch.complex(dj, dy), hh)):
        ref = np.asarray(ref)
        assert (np.abs(got.numpy() - ref)
                / np.maximum(np.abs(ref), 1.0)).max() < 1e-12

# }}}


# {{{ the dipole hooks against jax.jvp of the reference's

HOOK_N = 40
#: P2P's targets
HOOK_T = 12


def _hook_inputs(pairs):
    """Offsets in [-1, 1]^2 pre-divided by their box's rscale (the first
    at the origin, the second at k r < 1e-6 but above the series switch
    of Y), dipoles, rscales in [0.2, 1], charges (real for the pairs) and
    P2P's targets (the first on the third source)."""
    rng = np.random.default_rng(21)
    rel = rng.uniform(-1.0, 1.0, (2, HOOK_N))
    rel[:, 0] = 0.0
    rel[:, 1] = np.array([0.6, -0.8]) * 1e-7
    q = rng.standard_normal(HOOK_N)
    if not pairs:
        q = q + 1j * rng.standard_normal(HOOK_N)
    tgt = rng.uniform(-1.0, 1.0, (2, HOOK_T))
    s = rng.uniform(0.2, 1.0, HOOK_N)
    tgt[:, 0] = rel[:, 2] * s[2]
    return dict(rel=rel, dip=rng.standard_normal((2, HOOK_N)), s=s, q=q,
                tgt=tgt)


def _bare(cls):
    """A reference wrangler of class *cls* holding only what its hooks
    read."""
    w = object.__new__(cls)
    w.__dict__.update(order=ORDER, k=K, _ns=np.arange(-ORDER, ORDER + 1),
                      _nstart=NSTART)
    return w


def _jax_hooks(pairs):
    """The reference's dipole hook values at :func:`_hook_inputs` under
    one ``jax.jit``: ``jax.jvp`` of ``_p2m_terms`` and ``_p2l_terms`` in
    the offsets along ``d / s`` (scale 1.0, as ``rscale=None`` hands them,
    and the rscales), of ``_p2p`` in the sources along ``d``, and of
    ``_p2m_terms`` at ``1e-9 d`` along the first source's ``d / s``."""
    x = _hook_inputs(pairs)
    hooks = _bare(JaxPairs if pairs else JaxComplex)

    def f(rel, dip, s, q, tgt, src):
        out = {}
        for rscale, sc in ((None, 1.0), ("auto", s)):
            tan = dip / sc
            for hook in ("p2m", "p2l"):
                fn = getattr(hooks, f"_{hook}_terms")
                out[f"{hook}-{rscale}"] = jax.jvp(
                    lambda r, fn=fn, sc=sc: fn(r, q, sc), (rel,), (tan,))[1]
            s0 = sc if rscale is None else sc[0]
            out[f"limit-{rscale}"] = jax.jvp(
                lambda r, s0=s0: hooks._p2m_terms(r, q[:1], s0),
                (1e-9 * dip[:, :1],), (tan[:, :1],))[1][0]
        out["p2p"] = jax.jvp(
            lambda y: hooks._p2p(tgt.T, y, jnp.ones(HOOK_N, bool), q),
            (src,), (dip.T,))[1]
        return out
    # the sources as the port's wrappers get them (P2P's first target on
    # the third exactly)
    res = jax.jit(f)(x["rel"], x["dip"], x["s"], x["q"], x["tgt"],
                     (x["rel"] * x["s"]).T)
    return {key: np.asarray(v) for key, v in res.items()}


@pytest.fixture(scope="module")
def hook_refs():
    return {layout: _jax_hooks(layout == "pairs")
            for layout in ("c128", "pairs")}


def _hook_err(got, ref):
    """Columns to their own scale; with real charges lanes that are zero
    but for rounding to the array's largest."""
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.ndim == 2:
        scale = np.abs(ref).max(0)
        scale = np.where(scale >= 1e-12 * scale.max(), scale, scale.max())
        return (np.abs(got - ref).max(0) / scale).max()
    return _rel_linf(got, ref)


def _scale(x, rscale):
    return x["s"] if rscale == "auto" else np.ones(HOOK_N)


def test_hook_inputs_reach_small_kr():
    x = _hook_inputs(False)
    for rscale in (None, "auto"):
        kr = K * np.hypot(*(x["rel"] * _scale(x, rscale)))
        assert kr[0] == 0 and t_cb.JN_SMALL_X <= kr[1] < 1e-6
        assert (kr[2:] > 1e-3).all()


@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("hook", ["p2m", "p2l"])
@pytest.mark.parametrize("layout", ["c128", "pairs"])
def test_dipole_terms_match_reference(hook_refs, layout, hook, rscale):
    """``p2m_dipole_terms`` / ``p2l_dipole_terms`` (and ``_pairs``), the
    per-particle steps of the twins, against the reference's JVPs; the
    first row (r = 0) is P2L's 0 in both and P2M's limit in the port
    (:func:`test_p2m_limit_at_r0`)."""
    x = _hook_inputs(layout == "pairs")
    s = _scale(x, rscale)
    fn = getattr(h2, f"{hook}_dipole_terms"
                 + ("_pairs" if layout == "pairs" else ""))
    got = fn(_t(x["rel"]), _t(x["dip"] / s), _t(x["q"]), _t(s), K, ORDER,
             NSTART)
    ref = hook_refs[layout][f"{hook}-{rscale}"]
    lo = 1 if hook == "p2m" else 0
    if hook == "p2l":
        assert (got[0] == 0).all() and (ref[0] == 0).all()
    assert _hook_err(got[lo:], ref[lo:]) <= RTOL


def _one_per_box(x, s):
    """Box ranges, rows and centres for one source a box at the origin,
    and the points (the pre-divided offsets times their scale)."""
    i32 = torch.arange(HOOK_N, dtype=torch.int32)
    return (_t(x["rel"] * s), (i32, torch.ones(HOOK_N, dtype=torch.int32)),
            i32, torch.zeros((2, HOOK_N), dtype=torch.float64))


@pytest.mark.parametrize("via", ["wrapper", "twin"])
@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("which", ["p2m", "p2p", "p2l"])
@pytest.mark.parametrize("layout", ["c128", "pairs"])
def test_dipole_kernels_match_reference_hooks(hook_refs, layout, which,
                                              rscale, via):
    """K63-K68's twins and CPU wrappers against the reference's JVPs: P2M
    and P2L one source a box (centre 0, scale s_i; P2L's rows list their
    own box), P2P all sources against ``HOOK_T`` targets in one List-1
    row (the first target on a source: skipped)."""
    pairs = layout == "pairs"
    x = _hook_inputs(pairs)
    s = _scale(x, rscale)
    pts, ranges, rows, centers = _one_per_box(x, s)
    q, dip = _t(x["q"]), _t(x["dip"])
    name = f"{which}_helmholtz2d_dipole"
    fn = getattr(h2, name if via == "wrapper" else f"{name}_plain")
    if which == "p2m":
        got = fn(pts, q, dip, *ranges, rows, centers, _t(s), K, ORDER,
                 NSTART)
        ref = hook_refs[layout][f"p2m-{rscale}"]
        got, ref = got[1:], ref[1:]
    elif which == "p2l":
        out = torch.zeros((HOOK_N, h2._width(ORDER, q.dtype)),
                          dtype=q.dtype)
        got = fn(pts, q, dip, *ranges, rows,
                 torch.arange(HOOK_N + 1, dtype=torch.int32), rows, centers,
                 _t(s), K, ORDER, NSTART, out)
        assert got is out
        ref = hook_refs[layout][f"p2l-{rscale}"]
    else:
        # the sources do not depend on the rscale
        z = torch.zeros(1, dtype=torch.int32)
        got = fn(_t(x["tgt"]), _t(x["rel"] * x["s"]), q, dip, z,
                 torch.tensor([HOOK_T], dtype=torch.int32), z,
                 torch.tensor([HOOK_N], dtype=torch.int32), z,
                 torch.tensor([0, 1], dtype=torch.int32), z, K, NSTART)
        ref = hook_refs[layout]["p2p"]
        assert got.dtype == (torch.float64 if pairs else torch.complex128)
    assert _hook_err(got, ref) <= RTOL


@pytest.mark.parametrize("via", ["terms", "wrapper"])
@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("layout", ["c128", "pairs"])
def test_p2m_limit_at_r0(hook_refs, layout, rscale, via):
    """A dipole source on its box's centre: the port's multipole terms are
    the limit of the tangent as r -> 0, ``+-(i/4) q (k/2) (d_x -+ i d_y)
    s^-1`` at n = +-1 alone, held to the reference's tangent at ``rel = 1e-9 d``
    (the reference itself gives 0 at r = 0)."""
    pairs = layout == "pairs"
    x = _hook_inputs(pairs)
    s = _scale(x, rscale)
    q, dip = _t(x["q"]), _t(x["dip"])
    if via == "terms":
        fn = h2.p2m_dipole_terms_pairs if pairs else h2.p2m_dipole_terms
        got = fn(_t(x["rel"]), dip / _t(s), q, _t(s), K, ORDER, NSTART)[0]
    else:
        pts, ranges, rows, centers = _one_per_box(x, s)
        got = h2.p2m_helmholtz2d_dipole(pts, q, dip, *ranges, rows, centers,
                                        _t(s), K, ORDER, NSTART)[0]
    got = got.numpy()
    ref = hook_refs[layout][f"limit-{rscale}"]
    assert np.abs(ref).max() > 1e-3
    assert np.abs(got - ref).max() <= LIMIT_RTOL * np.abs(ref).max()
    # only the n = +-1 coefficients are nonzero
    nc = 2 * ORDER + 1
    n1 = [ORDER - 1, ORDER + 1]
    if pairs:
        n1 += [nc + ORDER - 1, nc + ORDER + 1]
    rest = np.delete(got, n1)
    assert (rest == 0).all() and (got[n1] != 0).all()


def test_p2m_limit_scale():
    """``ROADMAP.md`` Queue 3's numbers: at order 4, k = 2 and dipole (1,
    0) on the centre, unit charge, the n = +-1 multipoles are +-0.25 i."""
    one = torch.ones(1, dtype=torch.float64)
    rel = torch.zeros((2, 1), dtype=torch.float64)
    dip = torch.tensor([[1.0], [0.0]], dtype=torch.float64)
    got = h2.p2m_dipole_terms(rel, dip, one.to(torch.complex128), one, 2.0,
                              4, 20)[0].numpy()
    ref = np.zeros(9, complex)
    ref[3], ref[5] = -0.25j, 0.25j
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-16)

# }}}


# {{{ the port's dipole FMM against direct sums

def _direct_dipoles(targets, sources, dipoles, weights, k):
    """``sum w (i/4) k H_1(k r) d . (x - y) / r``, r = 0 skipped."""
    diff = targets[:, :, None] - sources[:, None, :]
    r = np.sqrt((diff * diff).sum(0))
    rs = np.where(r > 0, r, 1.0)
    proj = (dipoles[:, None, :] * diff).sum(0) / rs
    return np.where(r > 0, 0.25j * k * sp.hankel1(1, k * rs) * proj,
                    0) @ weights


def test_dipoles_vs_direct():
    """``tests/test_helmholtz.py:49-75`` on the port: 1,200 sources, 900
    targets, k = 3, order 16, complex weights."""
    rng = np.random.default_rng(29)
    sources = rng.random((2, 1200))
    targets = rng.random((2, 900))
    weights = rng.standard_normal(1200) + 1j * rng.standard_normal(1200)
    dipole_vec = rng.standard_normal((2, 1200))
    trav = build_traversal(build_tree(sources, targets=targets,
                                      max_particles_in_box=20,
                                      device="cpu"))
    w = make_helmholtz_wrangler(trav, 3.0, 16, dipole_vec=dipole_vec)
    pot = drive_fmm(w, [torch.from_numpy(weights)]).numpy()
    ref = _direct_dipoles(targets, sources, dipole_vec, weights, 3.0)
    assert _rel_linf(pot, ref) < DIRECT_RTOL


@pytest.fixture(scope="module")
def rscale_case():
    """``tests/test_helmholtz.py:128-151``'s points: 400 in the unit
    square, real weights, standard-normal dipoles."""
    rng = np.random.default_rng(12)
    sources = rng.random((2, 400))
    weights = rng.standard_normal(400)
    dipvec = rng.standard_normal((2, 400))
    trav = build_traversal(build_tree(sources, max_particles_in_box=10,
                                      device="cpu"))
    return sources, weights, dipvec, trav


def test_rscale_dipoles_vs_direct(rscale_case):
    """``tests/test_helmholtz.py:128-151`` on the port: k = 2, order 14,
    ``rscale="auto"``."""
    sources, weights, dipvec, trav = rscale_case
    w = make_helmholtz_wrangler(trav, 2.0, 14, rscale="auto",
                                dipole_vec=dipvec)
    pot = drive_fmm(w, [torch.from_numpy(weights)]).numpy()
    ref = _direct_dipoles(sources, sources, dipvec, weights, 2.0)
    assert _rel_linf(pot, ref) < DIRECT_RTOL


@pytest.mark.parametrize("rscale", [None, "auto"])
def test_dipole_pairs_match_complex(rscale_case, rscale):
    """The pair wrangler with dipoles against the port's complex one on
    the same real weights (``tests/test_helmholtz.py:183``'s bar)."""
    _, weights, dipvec, trav = rscale_case
    q = torch.from_numpy(weights)
    ref = drive_fmm(make_helmholtz_wrangler(
        trav, 2.0, 10, pairs=False, rscale=rscale, dipole_vec=dipvec),
        [q]).numpy()
    w = make_helmholtz_wrangler(trav, 2.0, 10, pairs=True, rscale=rscale,
                                dipole_vec=dipvec)
    assert type(w).__name__ == "Helmholtz2DPairsExpansionWrangler"
    pot = drive_fmm(w, [q]).numpy()
    assert pot.shape == (400, 2)
    assert _rel_linf(pot[:, 0] + 1j * pot[:, 1], ref) <= PAIRS_RTOL


def test_dipoles_already_reordered(rscale_case):
    """Tree-order dipoles with ``dipoles_already_reordered`` give the
    wrangler the user-order dipoles' reorder; a 1-row array raises."""
    _, _, dip, trav = rscale_case
    w = make_helmholtz_wrangler(trav, 2.0, 2, dipole_vec=dip)
    tree_order = w.dipole_vec.numpy()
    w2 = make_helmholtz_wrangler(trav, 2.0, 2, dipole_vec=tree_order,
                                 dipoles_already_reordered=True,
                                 pairs=True)
    np.testing.assert_array_equal(w2.dipole_vec.numpy(), tree_order)
    ids = trav.tree.user_source_ids.numpy()
    np.testing.assert_array_equal(tree_order, dip[:, ids])
    with pytest.raises(ValueError):
        make_helmholtz_wrangler(trav, 2.0, 2, dipole_vec=dip[:1])

# }}}
