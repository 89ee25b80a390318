"""The 3D Helmholtz dipole sources of boxtree_torch against boxtree_tpu's.

A dipole source of weight ``q`` and dipole ``d`` has the potential ``q (d .
grad_y) G(x, y)``, ``G = exp(ik r) / r``; P2M, P2P and P2L of the dipole
wranglers are the JVPs of the charge stages in the source positions
(``boxtree_tpu/models/expansion_base.py:664-673``, ``:1314-1324``,
``:1688-1694``), the kernels K57-K59 (complex128) and K60-K62 (pairs).

- One recorded ``drive_fmm`` of the reference's complex wrangler with
  dipoles (order 6, ``rscale="auto"``, 500 points as
  ``tests/test_helmholtz3d.py:115``, but on the unit sphere, 10 a box, so
  that Lists 3 and 4 are populated) on the port's traversal, handed to
  ``boxtree_tpu`` in its own containers: the port's P2M, P2P and P2L stages
  on the reference's inputs and the whole slice, rel l-inf <= 1e-11
  (expansions per coefficient column).
- The pair wrangler with dipoles against the port's complex one on real
  charges, <= 1e-12 (``tests/test_helmholtz3d.py:170``).
- The dipole terms (``p2m_dipole_terms``, ``p2l_dipole_terms`` and their
  ``_pairs``), the plain twins and the CPU wrappers of K57-K62 against
  ``jax.jvp`` of the reference's hooks ``_p2m_terms`` / ``_p2l_terms`` /
  ``_p2p`` (complex and pair classes) in one ``jax.jit`` per layout, with
  scale 1 (rscale None) and rscales, a source at ``k r < 1e-6`` among them;
  P2P also with a source on a target (skipped).
- The dipole P2M at ``r = 0``: the reference's guard gives 0 there (it
  drops the dipole moment); the port takes the limit of the tangent, held
  to the reference's tangent at ``rel = 1e-9 dir`` within 1e-6.
- The port alone at order 12 against a direct sum of the dipole kernel
  (< 1e-5, ``tests/test_helmholtz3d.py:137``'s bar), and the dipoles'
  reorder (user order, or ``dipoles_already_reordered``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.fmm.drive import FMM_STAGES
from boxtree_torch.models import make_helmholtz_wrangler
from boxtree_torch.ops import helmholtz3d as h3
from boxtree_torch.ops import spherical_bessel as t_sb
from boxtree_torch.traversal import build_traversal
from boxtree_tpu.fmm import drive_fmm as jax_drive_fmm
from boxtree_tpu.models.helmholtz3d import (
    Helmholtz3DPairsExpansionWrangler as JaxPairs,
    make_helmholtz_wrangler as jax_make_helmholtz_wrangler,
)
from test_torch_helmholtz3d import _jax_traversal, _Recorder, _rel_linf, \
    _rows_rel, _sphere, _t
from torch_threads import one_torch_thread  # noqa: F401

K = 2.0
N = 500
ORDER = 6
RTOL = 1e-11
PAIRS_RTOL = 1e-12
#: the port's r = 0 limit against the reference's tangent at r = 1e-9
LIMIT_RTOL = 1e-6


@pytest.fixture(scope="module")
def points():
    pts = _sphere(N, seed=12)
    rng = np.random.default_rng(13)
    q = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    dip = rng.standard_normal((3, N))
    trav = build_traversal(build_tree(pts, max_particles_in_box=10,
                                      device="cpu"))
    return pts, q, dip, trav


@pytest.fixture(scope="module")
def recorded(points):
    """The reference's dipole FMM, recorded stage by stage, and the port's
    wrangler on the same traversal."""
    _, q, dip, trav = points
    jw = _Recorder(jax_make_helmholtz_wrangler(
        _jax_traversal(trav), K, ORDER, pairs=False, rscale="auto",
        dipole_vec=jnp.asarray(dip)))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    ref = {name: np.asarray(v) for name, v in jw.outputs.items()}
    w = make_helmholtz_wrangler(trav, K, ORDER, pairs=False, rscale="auto",
                                dipole_vec=dip)
    return ref, jpot, w, jw._inner


def test_dipole_stages_exercised(points, recorded):
    trav = points[3]
    assert sum(bl.count for bl in trav.from_sep_smaller_by_level) > 0
    assert trav.from_sep_bigger_lists.shape[0] > 0
    assert recorded[2]._supports_dipoles


@pytest.mark.parametrize("stage", ["P2M", "P2P", "P2L"])
def test_dipole_stage_matches_reference(points, recorded, stage):
    _, q, _, trav = points
    ref, _, w, _ = recorded
    tq = w.reorder_sources(torch.from_numpy(q))
    lsb_totp = trav.level_start_target_or_target_parent_box_nrs
    totp = trav.target_or_target_parent_boxes
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
        got = w.form_locals(lsb_totp, totp, trav.from_sep_bigger_starts,
                            trav.from_sep_bigger_lists, [tq])
        want = ref["form_locals"]
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.ndim == 2:
        assert _rows_rel(got.T, want.T) <= RTOL
    else:
        assert _rel_linf(got, want) <= RTOL


def test_dipole_slice_matches_reference(points, recorded):
    _, q, dip, trav = points
    jpot = recorded[1]
    w = make_helmholtz_wrangler(trav, K, ORDER, rscale="auto",
                                dipole_vec=dip)
    timing = {}
    got = drive_fmm(w, [torch.from_numpy(q)], timing_data=timing)
    assert got.dtype == torch.complex128 and got.shape == (N,)
    assert set(timing) == set(FMM_STAGES)
    assert _rel_linf(got.numpy(), jpot) <= RTOL


@pytest.mark.parametrize("rscale", [None, "auto"])
def test_dipole_pairs_match_complex(points, rscale):
    _, q, dip, trav = points
    qr = torch.from_numpy(q.real.copy())
    ref = drive_fmm(make_helmholtz_wrangler(
        trav, K, ORDER, pairs=False, rscale=rscale, dipole_vec=dip),
        [qr]).numpy()
    w = make_helmholtz_wrangler(trav, K, ORDER, pairs=True, rscale=rscale,
                                dipole_vec=dip)
    assert type(w).__name__ == "Helmholtz3DPairsExpansionWrangler"
    pot = drive_fmm(w, [qr]).numpy()
    assert pot.shape == (N, 2)
    assert _rel_linf(pot[:, 0] + 1j * pot[:, 1], ref) <= PAIRS_RTOL


def test_dipoles_already_reordered(points):
    """Tree-order dipoles with ``dipoles_already_reordered`` give the
    wrangler the user-order dipoles' reorder."""
    _, _, dip, trav = points
    w = make_helmholtz_wrangler(trav, K, 2, dipole_vec=dip)
    tree_order = w.dipole_vec.numpy()
    w2 = make_helmholtz_wrangler(trav, K, 2, dipole_vec=tree_order,
                                 dipoles_already_reordered=True)
    np.testing.assert_array_equal(w2.dipole_vec.numpy(), tree_order)
    ids = trav.tree.user_source_ids.numpy()
    np.testing.assert_array_equal(tree_order, dip[:, ids])
    with pytest.raises(ValueError):
        make_helmholtz_wrangler(trav, K, 2, dipole_vec=dip[:2])


def test_order12_against_direct_sum(points):
    """``w (d . grad_y) exp(ik r)/r`` summed directly, r = 0 skipped."""
    pts, q, dip, trav = points
    w = make_helmholtz_wrangler(trav, K, 12, rscale="auto", dipole_vec=dip)
    got = drive_fmm(w, [torch.from_numpy(q)]).numpy()
    d = pts[:, :, None] - pts[:, None, :]          # x_i - y_j
    r = np.sqrt((d * d).sum(0))
    rs = np.where(r > 0, r, 1.0)
    g = np.where(r > 0, np.exp(1j * K * rs) / rs, 0)
    gp = np.where(r > 0, (1j * K - 1 / rs) * g, 0)  # dG/dr
    cos = np.where(r > 0, ((-d) * dip[:, None, :]).sum(0) / rs, 0)
    ref = (gp * cos) @ q
    assert _rel_linf(got, ref) < 1e-5


# {{{ the dipole hooks against jax.jvp of the reference's

HOOK_N = 40
#: P2P's targets
HOOK_T = 12


def _hook_inputs(pairs):
    """Offsets in the unit ball pre-divided by their box's rscale (the
    first at the origin, the second at k r < 1e-6), physical dipoles,
    rscales in [0.2, 1], charges (real for the pairs), P2P's targets (the
    first on the third source) and the unit direction of the ``r = 0``
    limit."""
    rng = np.random.default_rng(19)
    rel = rng.uniform(-1.0, 1.0, (3, HOOK_N))
    rel[:, 0] = 0.0
    rel[:, 1] = np.array([1.0, -2.0, 2.0]) / 3 * 1e-7
    q = rng.standard_normal(HOOK_N)
    if not pairs:
        q = q + 1j * rng.standard_normal(HOOK_N)
    tgt = rng.uniform(-1.0, 1.0, (3, HOOK_T))
    s = rng.uniform(0.2, 1.0, HOOK_N)
    tgt[:, 0] = rel[:, 2] * s[2]
    return dict(rel=rel, dip=rng.standard_normal((3, HOOK_N)), s=s, q=q,
                tgt=tgt, dir=np.array([2.0, 3.0, -6.0]) / 7)


def _jax_hooks(jw, pairs):
    """The reference's dipole hook values at :func:`_hook_inputs` under
    one ``jax.jit``: ``jax.jvp`` of ``_p2m_terms`` and ``_p2l_terms`` in
    the offsets along ``d / s`` (scale 1.0, as ``rscale=None`` hands them,
    and the rscales), of ``_p2p`` in the sources along ``d``, and of
    ``_p2m_terms`` at ``1e-9 dir`` along the first source's ``d / s``."""
    x = _hook_inputs(pairs)
    if pairs:
        hooks = object.__new__(JaxPairs)
        hooks.__dict__.update(jw.__dict__)
    else:
        hooks = jw

    def f(rel, dip, s, q, tgt, dr, src):
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
                (1e-9 * dr[:, None],), (tan[:, :1],))[1][0]
        out["p2p"] = jax.jvp(
            lambda y: hooks._p2p(tgt.T, y, jnp.ones(HOOK_N, bool), q),
            (src,), (dip.T,))[1]
        return out
    # the sources as the port's wrappers get them (P2P's first target on
    # the third exactly)
    res = jax.jit(f)(x["rel"], x["dip"], x["s"], x["q"], x["tgt"],
                     x["dir"], (x["rel"] * x["s"]).T)
    return {key: np.asarray(v) for key, v in res.items()}


@pytest.fixture(scope="module")
def hook_refs(recorded):
    return {layout: _jax_hooks(recorded[3], layout == "pairs")
            for layout in ("c128", "pairs")}


def _weights(w, pairs):
    ti = w.tree_indep
    if pairs:
        return torch.as_tensor(4 * np.pi * ti.k * ti.D ** 2)
    return torch.as_tensor(4 * np.pi * 1j * ti.k * ti.D ** 2)


def _hook_err(got, ref):
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.ndim == 2:
        # columns to their own scale, lanes zero for real charges to the
        # array's largest
        scale = np.abs(ref).max(0)
        scale = np.where(scale >= 1e-12 * scale.max(), scale, scale.max())
        return (np.abs(got - ref).max(0) / scale).max()
    return _rel_linf(got, ref)


@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("hook", ["p2m", "p2l"])
@pytest.mark.parametrize("layout", ["c128", "pairs"])
def test_dipole_terms_match_reference(recorded, hook_refs, layout, hook,
                                      rscale):
    """``p2m_dipole_terms`` / ``p2l_dipole_terms`` (and ``_pairs``), the
    per-particle steps of the twins, against the reference's JVPs; the
    first row (r = 0) is P2L's 0 in both and P2M's limit in the port
    (:func:`test_p2m_limit_at_r0`)."""
    x = _hook_inputs(layout == "pairs")
    s = x["s"] if rscale == "auto" else np.ones(HOOK_N)
    fn = getattr(h3, f"{hook}_dipole_terms"
                 + ("_pairs" if layout == "pairs" else ""))
    got = fn(_t(x["rel"]), _t(x["dip"] / s), _t(x["q"]), _t(s),
             _weights(recorded[2], layout == "pairs"), K, ORDER)
    ref = hook_refs[layout][f"{hook}-{rscale}"]
    lo = 1 if hook == "p2m" else 0
    if hook == "p2l":
        assert (got[0] == 0).all() and (ref[0] == 0).all()
    assert _hook_err(got[lo:], ref[lo:]) <= RTOL


def _one_per_box(x, s):
    """Box ranges, centres and points for one source a box at the origin
    (the pre-divided offsets times their scale)."""
    i32 = torch.arange(HOOK_N, dtype=torch.int32)
    return (_t(x["rel"] * s), (i32, torch.ones(HOOK_N, dtype=torch.int32)),
            i32, torch.zeros((3, HOOK_N), dtype=torch.float64))


@pytest.mark.parametrize("via", ["wrapper", "twin"])
@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("which", ["p2m", "p2p", "p2l"])
@pytest.mark.parametrize("layout", ["c128", "pairs"])
def test_dipole_kernels_match_reference_hooks(recorded, hook_refs, layout,
                                              which, rscale, via):
    """K57-K62's twins and CPU wrappers against the reference's JVPs: P2M
    and P2L one source a box (centre 0, scale s_i; P2L's rows list their
    own box), P2P all sources against ``HOOK_T`` targets in one List-1
    row (the first target on a source: skipped)."""
    pairs = layout == "pairs"
    x = _hook_inputs(pairs)
    s = x["s"] if rscale == "auto" else np.ones(HOOK_N)
    pts, ranges, rows, centers = _one_per_box(x, s)
    q, dip, w_nm = _t(x["q"]), _t(x["dip"]), _weights(recorded[2], pairs)
    name = f"{which}_helmholtz3d_dipole"
    fn = getattr(h3, name if via == "wrapper" else f"{name}_plain")
    if which == "p2m":
        got = fn(pts, q, dip, *ranges, rows, centers, _t(s), w_nm, K, ORDER)
        ref = hook_refs[layout][f"p2m-{rscale}"]
        got, ref = got[1:], ref[1:]
    elif which == "p2l":
        out = torch.zeros((HOOK_N, h3._width(ORDER, q.dtype)),
                          dtype=q.dtype)
        got = fn(pts, q, dip, *ranges, rows,
                 torch.arange(HOOK_N + 1, dtype=torch.int32), rows, centers,
                 _t(s), w_nm, K, ORDER, out)
        assert got is out
        ref = hook_refs[layout][f"p2l-{rscale}"]
    else:
        # the sources do not depend on the rscale
        z = torch.zeros(1, dtype=torch.int32)
        got = fn(_t(x["tgt"]), _t(x["rel"] * x["s"]), q, dip, z,
                 torch.tensor([HOOK_T], dtype=torch.int32), z,
                 torch.tensor([HOOK_N], dtype=torch.int32), z,
                 torch.tensor([0, 1], dtype=torch.int32), z, K)
        ref = hook_refs[layout]["p2p"]
        if not pairs:
            assert got.dtype == torch.complex128
    assert _hook_err(got, ref) <= RTOL


@pytest.mark.parametrize("via", ["terms", "wrapper"])
@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("layout", ["c128", "pairs"])
def test_p2m_limit_at_r0(recorded, hook_refs, layout, rscale, via):
    """A dipole source on its box's centre: the port's multipole terms are
    the limit of the tangent as r -> 0, ``(k / 3) q w_1m conj(R_1^m(d))
    s^-1`` at n = 1 alone, held to the reference's tangent at ``rel =
    1e-9 dir`` (the reference itself gives 0 at r = 0)."""
    pairs = layout == "pairs"
    x = _hook_inputs(pairs)
    s = x["s"] if rscale == "auto" else np.ones(HOOK_N)
    q, dip, w_nm = _t(x["q"]), _t(x["dip"]), _weights(recorded[2], pairs)
    if via == "terms":
        fn = h3.p2m_dipole_terms_pairs if pairs else h3.p2m_dipole_terms
        got = fn(_t(x["rel"]), dip / _t(s), q, _t(s), w_nm, K, ORDER)[0]
    else:
        pts, ranges, rows, centers = _one_per_box(x, s)
        got = h3.p2m_helmholtz3d_dipole(pts, q, dip, *ranges, rows, centers,
                                        _t(s), w_nm, K, ORDER)[0]
    got = got.numpy()
    ref = hook_refs[layout][f"limit-{rscale}"]
    assert np.abs(ref).max() > 1.0
    assert np.abs(got - ref).max() <= LIMIT_RTOL * np.abs(ref).max()
    # only the n = 1 coefficients are nonzero
    kc = (ORDER + 1) ** 2
    n1 = [1, 2, 3] if not pairs else [1, 2, 3, kc + 1, kc + 2, kc + 3]
    rest = np.delete(got, n1)
    assert (rest == 0).all() and (got[n1] != 0).any()

# }}}


@pytest.mark.parametrize("x", [1e-5, 1e-3, 7e-3, 0.1, 2.5])
def test_jn_tangent(x):
    """The twin's tangent of j_n (``torch.func.jvp``) against scipy's
    derivative: j_0's is -j_1, to rounding, where the quotient rule's
    ``cos x / x - sin x / x^2`` keeps eps / x^2 of itself (1e-6 at x =
    1e-5); the values are those of ``spherical_jn`` bit for bit."""
    from scipy import special

    p = 4
    xt = torch.tensor([x], dtype=torch.float64)
    val, tan = torch.func.jvp(lambda t: t_sb.spherical_jn(t, p), (xt,),
                              (torch.ones_like(xt),))
    assert torch.equal(val, t_sb.spherical_jn(xt, p))
    ref = special.spherical_jn(np.arange(p + 1), x, derivative=True)
    assert abs(float(tan[0, 0]) - ref[0]) <= 1e-14 * abs(ref[0])
    np.testing.assert_allclose(tan[0].numpy(), ref, rtol=1e-13, atol=0)
