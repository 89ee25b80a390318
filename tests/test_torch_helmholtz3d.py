"""The 3D Helmholtz FMM of boxtree_torch (complex128) against boxtree_tpu's.

- The spherical Bessel twins against the JAX functions (the same
  recurrences: 1e-13 relative) and scipy (as ``tests/test_helmholtz3d.py``
  does); the host-side scaled values exactly, being the same numpy code.
- ``D``, the Gaunt tensor and the wrangler's per-level M2M, L2L and M2L
  operators against the JAX builders, row by row to 1e-12 of each row's
  largest entry (entries span many decades through the ``D`` ratios).
- Every FMM stage at order 4 with ``rscale="auto"``: rel l-inf <= 1e-11,
  the same math summed in another order, expansions per coefficient (each
  column against its own largest entry, since the columns span many
  decades).  Both packages run on the port's
  tree and traversal (handed to ``boxtree_tpu`` in its own containers;
  ``test_torch_tree.py`` and ``test_torch_traversal.py`` hold them equal to
  its own), and each port stage gets the reference's inputs.  The
  reference's stage outputs are those of its one ``drive_fmm``, recorded:
  its stages compile and run eagerly on the CPU for seconds each.  P2P is
  held instead to a correctly rounded direct sum over the same List-1
  pairs, within ``P2P_EPS_COND`` units of ``eps * sum |q_j| / r_ij`` per
  target, as in ``test_torch_laplace_stages.py``.
- The P2M and L2P terms (``p2m_terms`` / ``l2p_eval``) and the twins of
  K31 / K32, through their CPU wrappers too, against the reference's
  hooks ``_p2m_terms`` / ``_l2p_eval`` under one ``jax.jit``, a particle
  on its box's centre (``r = 0``) among them, with ``rscale`` off (scale
  1) and on (1e-11, expansions per coefficient column); the rows of K31 /
  K32 (the boxes that own particles) cover every particle once.
- The whole slice against ``boxtree_tpu``'s ``drive_fmm`` (1e-11) and, at
  order 12, against the direct sum (< 1e-5).
- Each option the port does not cover raises NotImplementedError (dipole
  sources are held in ``test_torch_helmholtz3d_dipoles.py``); the
  complex128 plumbing (dtype names, the kernels' entry points and argument
  checks, the numpy bridge) on its own.

Points on the unit sphere, so that Lists 3 and 4 are populated.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special as sp

import boxtree_tpu
from boxtree_torch import build_tree
from boxtree_torch.config import as_torch_dtype
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.fmm.drive import FMM_STAGES
from boxtree_torch.models import make_helmholtz_wrangler
from boxtree_torch.models.helmholtz3d import (
    Helmholtz3DExpansionWrangler,
    Helmholtz3DTreeIndependentDataForWrangler,
)
from boxtree_torch.ops import helmholtz3d as h3
from boxtree_torch.ops import kernels
from boxtree_torch.ops import scaled_bessel_host as t_sbh
from boxtree_torch.ops import spherical_bessel as t_sb
from boxtree_torch.traversal import build_traversal
from boxtree_torch.traversal.neighbors import _offsets
from boxtree_torch.utils.bridge import to_numpy
from boxtree_tpu.fmm import drive_fmm as jax_drive_fmm
from boxtree_tpu.models.helmholtz3d import (
    Helmholtz3DTreeIndependentDataForWrangler as JaxTreeIndependent,
    make_helmholtz_wrangler as jax_make_helmholtz_wrangler,
)
from boxtree_tpu.ops import scaled_bessel_host as j_sbh
from boxtree_tpu.ops import spherical_bessel as j_sb
from boxtree_tpu.ops.cylinder_bessel import miller_start as j_miller_start
from boxtree_tpu.traversal.containers import (
    BuiltList as JaxBuiltList,
    FMMTraversalInfo as JaxTraversal,
)
from boxtree_tpu.tree.containers import Tree as JaxTree
from torch_threads import one_torch_thread  # noqa: F401
from torch_translate import parent_block_m2l

K = 2.0
N = 800
ORDER = 4
RTOL = 1e-11
OP_RTOL = 1e-12
P2P_EPS_COND = 16
STAGES = ["P2M", "M2M", "P2P", "M2L", "M2P", "P2L", "M2L+P2L", "L2L",
          "L2P"]


def _sphere(n, seed=11):
    x = np.random.default_rng(seed).standard_normal((3, n))
    return x / np.sqrt((x * x).sum(0))


def _charges(n):
    rng = np.random.default_rng(1)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _rel_linf(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _rows_rel(got, ref):
    """Worst row of ``max |got - ref| / max |ref|`` over each row."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=-1)
    assert (scale > 0).all()
    return (np.abs(got - ref).max(axis=-1) / scale).max()


def _t(x):
    return torch.from_numpy(np.array(x))


# {{{ Bessel functions

_X = np.concatenate([np.logspace(-7, 1.5, 60), [0.0]])


@pytest.mark.parametrize("fn", ["jn", "yn", "hn1"])
def test_spherical_bessel_twin(fn):
    p = 20
    n = np.arange(p + 1)
    x = _X if fn == "jn" else _X[_X > 0]
    got = getattr(t_sb, f"spherical_{fn}")(torch.from_numpy(x), p).numpy()
    jax_ref = np.asarray(getattr(j_sb, f"spherical_{fn}")(jnp.asarray(x), p))
    assert got.dtype == jax_ref.dtype and got.shape == jax_ref.shape
    rel = np.abs(got - jax_ref) / np.maximum(np.abs(jax_ref), 1e-300)
    assert rel.max() <= 1e-13
    jn = sp.spherical_jn(n[None, :], x[:, None])
    yn = sp.spherical_yn(n[None, :], x[:, None]) if fn != "jn" else None
    if fn == "jn":
        assert np.abs(got - jn).max() < 1e-9
    elif fn == "yn":
        assert (np.abs(got - yn) / np.abs(yn)).max() < 1e-12
    else:
        assert np.abs(got.real - jn).max() < 1e-9
        assert (np.abs(got.imag - yn) / np.abs(yn)).max() < 1e-12


@pytest.mark.parametrize("fn", ["spherical_jn_scaled", "spherical_yn_scaled",
                                "spherical_hn1_scaled"])
@pytest.mark.parametrize("x,s", [(1e-4, 5e-5), (0.37, 0.25), (3.3, 1.0),
                                 (40.0, 1.0)])
def test_scaled_bessel_host_copy(fn, x, s):
    np.testing.assert_array_equal(getattr(t_sbh, fn)(x, 24, s),
                                  getattr(j_sbh, fn)(x, 24, s))


def test_miller_start_copy():
    for p in (0, 5, 24, 60):
        for xmax in (0.0, 0.3, 7.5, 120.0):
            assert t_sbh.miller_start(p, xmax) == j_miller_start(p, xmax)

# }}}


# {{{ tree-independent tables and operators

@pytest.fixture(scope="module")
def tree_indep():
    return (Helmholtz3DTreeIndependentDataForWrangler(K, 12),
            JaxTreeIndependent(K, 12))


@pytest.mark.parametrize("field", ["D", "gaunt", "phase_pair"])
def test_tree_independent_tables(tree_indep, field):
    got, ref = (getattr(ti, field) for ti in tree_indep)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert _rows_rel(got.reshape(got.shape[0], -1),
                     ref.reshape(ref.shape[0], -1)) <= 1e-14


@pytest.mark.parametrize("kind", ["J", "H"])
def test_translation_matrices_unscaled(tree_indep, kind):
    ti, jti = tree_indep
    ts = np.array([[0.05, 0.0, 0.05], [-0.3, 0.2, 0.1], [0.0, 0.0, -0.4]])
    got = ti.translation_matrices(ts, kind).numpy()
    for t, g in zip(ts, got):
        assert _rows_rel(g, jti.translation_matrix(t, kind)) <= OP_RTOL


class _Recorder:
    """Forwards to a wrangler and keeps the output of each FMM stage, so
    that one ``drive_fmm`` of the reference gives the slice and every
    stage's inputs and outputs."""

    def __init__(self, inner):
        self._inner = inner
        self.outputs = {}

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in FMM_STAGES:
            return attr

        def recorded(*args, **kwargs):
            out = self.outputs[name] = attr(*args, **kwargs)
            return out
        return recorded


def _jax_container(obj, cls, **given):
    """A ``boxtree_tpu`` container *cls* with the fields of the port's
    *obj* (tensors as jax arrays, dtypes as numpy dtypes)."""
    def conv(v):
        if isinstance(v, torch.Tensor):
            return jnp.asarray(v.numpy())
        if isinstance(v, torch.dtype):
            return to_numpy(v)
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return cls(**{f.name: given.get(f.name, conv(getattr(obj, f.name)))
                  for f in dataclasses.fields(cls)})


def _jax_traversal(trav):
    return _jax_container(
        trav, JaxTraversal,
        tree=_jax_container(trav.tree, JaxTree),
        from_sep_smaller_by_level=tuple(
            _jax_container(bl, JaxBuiltList)
            for bl in trav.from_sep_smaller_by_level))


@pytest.fixture(scope="module")
def points():
    pts = _sphere(N)
    trav = build_traversal(build_tree(pts, max_particles_in_box=20,
                                      device="cpu"))
    return pts, _charges(N), trav


@pytest.fixture(scope="module")
def stages(points):
    _, q, trav = points
    jw = _Recorder(jax_make_helmholtz_wrangler(
        _jax_traversal(trav), K, ORDER, pairs=False, rscale="auto"))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    ref = {name: np.asarray(v) for name, v in jw.outputs.items()}
    w = make_helmholtz_wrangler(trav, K, ORDER, pairs=False, rscale="auto")
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
        "P2P": (_direct_sum(trav, tq), w.eval_direct(
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
    return out, trav, w, jw._inner, jpot


def _direct_sum(trav, q_tree):
    """Per tree-order target: the correctly rounded sum (real and
    imaginary parts apart) of ``q_j exp(ik r_ij) / r_ij`` over the sources
    of its List-1 boxes, and ``sum_j |q_j| / r_ij``."""
    tree = trav.tree
    tgt, src = tree.targets.numpy(), tree.sources.numpy()
    q = q_tree.numpy()
    tst = tree.box_target_starts.numpy()
    tcn = tree.box_target_counts_nonchild.numpy()
    sst = tree.box_source_starts.numpy()
    scn = tree.box_source_counts_nonchild.numpy()
    starts = trav.neighbor_source_boxes_starts.numpy()
    lists = trav.neighbor_source_boxes_lists.numpy()
    exact = np.zeros(tgt.shape[1], np.complex128)
    cond = np.zeros(tgt.shape[1])
    for row, box in enumerate(trav.target_boxes.numpy()):
        ti = np.arange(tst[box], tst[box] + tcn[box])
        sj = np.concatenate([np.arange(sst[b], sst[b] + scn[b])
                             for b in lists[starts[row]:starts[row + 1]]])
        r = np.sqrt(((tgt[:, ti, None] - src[:, None, sj]) ** 2).sum(0))
        rs = np.where(r > 0, r, 1)
        terms = np.where(r > 0, q[sj] * np.exp(1j * K * rs) / rs, 0)
        exact[ti] = [complex(math.fsum(t.real), math.fsum(t.imag))
                     for t in terms]
        cond[ti] = np.where(r > 0, np.abs(q[sj]) / rs, 0).sum(1)
    return exact, cond


def test_list_stages_exercised(stages):
    trav = stages[1]
    assert sum(bl.count for bl in trav.from_sep_smaller_by_level) > 0
    assert trav.from_sep_bigger_lists.shape[0] > 0
    assert trav.tree.nlevels >= 4


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_reference(stages, stage):
    ref, got = stages[0][stage]
    got = got.numpy()
    if stage == "P2P":
        ref, cond = ref
        assert got.shape == ref.shape and got.dtype == ref.dtype
        eps = np.finfo(np.float64).eps
        assert (np.abs(got - ref) <= P2P_EPS_COND * eps * cond).all()
        return
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert got.dtype == np.complex128
    if got.ndim == 2:
        # expansions: each coefficient's column to its own scale, since
        # the columns span many decades
        assert _rows_rel(got.T, ref.T) <= RTOL
    else:
        assert _rel_linf(got, ref) <= RTOL


def test_m2l_parent_blocks_match_reference(stages):
    """What K35 computes, from the plan's own tables, against the
    reference's M2L on its own multipoles."""
    out, _, w = stages[:3]
    got = parent_block_m2l(_t(out["M2M"][0]), w._m2l_plan).numpy()
    assert _rows_rel(got.T, np.asarray(out["M2L"][0]).T) <= RTOL

@pytest.mark.parametrize("op", ["M2M", "L2L", "M2L"])
def test_level_operators_match_reference(stages, op):
    """The wrangler's per-level operators against the JAX builders
    (``_m2m_matrix``, ``_l2l_matrix``, ``_m2l_matrix``) at the same
    translations and rscales; both unscaled (rscale 1) and scaled levels
    occur."""
    _, trav, w, jw, _ = stages
    rs = w._rscale_np
    nlevels = trav.tree.nlevels
    assert (rs == 1.0).any() and (rs < 1.0).any()
    worst = 0.0
    if op == "M2L":
        classes = _offsets(3, 3, min_inf_norm=1)
        # the table holds the (level, class) pairs that List 2 uses
        assert {lev for lev, _ in w._m2l_plan.used} == set(
            range(2, nlevels))
        for i in range(0, len(w._m2l_plan.used), 3):
            lev, c = w._m2l_plan.used[i]
            size = w.root_extent / (1 << lev)
            ref = jw._m2l_matrix(classes[c] * size, float(rs[lev]))
            worst = max(worst, _rows_rel(w._m2l_opsT[i].T.numpy(), ref))
    else:
        for lev in range(1, nlevels):
            size = w.root_extent / (1 << lev)
            ops = (w._m2m_opsT if op == "M2M" else w._l2l_opsT)[lev]
            for q in range(8):
                sign = np.array([1.0 if (q >> (2 - ax)) & 1 else -1.0
                                 for ax in range(3)])
                off = sign * (size / 2)
                if op == "M2M":
                    ref = jw._m2m_matrix(-off, float(rs[lev]),
                                         float(rs[lev - 1]))
                else:
                    ref = jw._l2l_matrix(off, float(rs[lev - 1]),
                                         float(rs[lev]))
                worst = max(worst, _rows_rel(ops[q].T.numpy(), ref))
    assert worst <= OP_RTOL

# }}}


# {{{ P2M / L2P: K31 and K32's twins against the reference's hooks

HOOK_N = 40


def _hook_inputs():
    """Offsets in the unit ball pre-divided by their box's rscale (the
    first at the origin), rscales in [0.2, 1], complex charges and local
    coefficients."""
    rng = np.random.default_rng(9)
    kc = (ORDER + 1) ** 2
    rel = rng.uniform(-1.0, 1.0, (3, HOOK_N))
    rel[:, 0] = 0.0
    return dict(rel=rel, s=rng.uniform(0.2, 1.0, HOOK_N),
                q=rng.standard_normal(HOOK_N)
                + 1j * rng.standard_normal(HOOK_N),
                coef=rng.standard_normal((HOOK_N, kc))
                + 1j * rng.standard_normal((HOOK_N, kc)))


@pytest.fixture(scope="module")
def hook_refs(stages):
    """The reference's ``_p2m_terms`` and ``_l2p_eval`` at
    :func:`_hook_inputs`, with the scale 1 that ``rscale=None`` hands them
    and with the rscales, in one ``jax.jit``."""
    jw = stages[3]
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


@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("hook", ["p2m", "l2p"])
def test_particle_hooks_match_reference(stages, hook_refs, hook, rscale):
    """``p2m_terms`` and ``l2p_eval``, the per-particle steps of K31 /
    K32's twins, against the reference's hooks."""
    x = {k: _t(v) for k, v in _hook_inputs().items()}
    s = _t(_hook_scale(rscale))
    w = stages[2]
    if hook == "p2m":
        got = h3.p2m_terms(x["rel"], x["q"], s, w._w_nm, K, ORDER)
    else:
        got = h3.l2p_eval(x["rel"], x["coef"], s, K, ORDER)
    assert _hook_err(got, hook_refs[f"{hook}-{rscale}"]) <= RTOL


@pytest.mark.parametrize("via", ["wrapper", "twin"])
@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("which", ["p2m", "l2p"])
def test_p2m_l2p_twins_match_reference_hooks(stages, hook_refs, which,
                                            rscale, via):
    """K31 and K32's twins and their CPU wrappers, one particle per box
    (centre 0, scale s_i), against the reference's ``_p2m_terms`` and
    ``_l2p_eval`` at the same scaled offsets.  The first particle sits on
    its box's centre (``r = 0``): its charge lands on coefficient 0 alone,
    as ``q w_00``, and its potential is ``L_00``."""
    x = _hook_inputs()
    w = stages[2]
    ref = hook_refs[f"{which}-{rscale}"]
    s = _hook_scale(rscale)
    i32 = torch.arange(HOOK_N, dtype=torch.int32)
    ranges = (i32, torch.ones(HOOK_N, dtype=torch.int32), i32)
    centers = torch.zeros((3, HOOK_N), dtype=torch.float64)
    pts = _t(x["rel"] * s)
    name = f"{which}_helmholtz3d"
    fn = getattr(h3, name if via == "wrapper" else f"{name}_plain")
    if which == "p2m":
        got = fn(pts, _t(x["q"]), *ranges, centers, _t(s), w._w_nm, K,
                 ORDER)
        row0 = got[0].numpy()
        assert (row0[1:] == 0).all() and (ref[0][1:] == 0).all()
        assert row0[0] == ref[0][0] == x["q"][0] * w._w_nm[0].item()
    else:
        got = fn(pts, *ranges, _t(x["coef"]), centers, _t(s), K, ORDER)
        assert got[0] == ref[0] == x["coef"][0, 0]
    assert _hook_err(got, ref) <= RTOL


@pytest.mark.parametrize("what", ["source", "target"])
def test_particle_rows_cover_each_particle_once(stages, what):
    from test_torch_laplace3d import assert_rows_cover
    w = stages[2]
    assert_rows_cover(w.tree, what, getattr(w, f"_{what}_rows"))

# }}}


# {{{ the slice

def test_slice_matches_reference(points, stages):
    pts, q, trav = points
    ref = stages[4]
    w = make_helmholtz_wrangler(trav, K, ORDER, rscale="auto")
    timing = {}
    got = drive_fmm(w, [torch.from_numpy(q)], timing_data=timing)
    assert got.dtype == torch.complex128 and got.shape == (N,)
    assert set(timing) == set(FMM_STAGES)
    assert _rel_linf(got.numpy(), ref) <= RTOL


def test_order12_against_direct_sum(points, tree_indep):
    pts, q, trav = points
    w = Helmholtz3DExpansionWrangler(tree_indep[0], trav, rscale="auto")
    got = drive_fmm(w, [torch.from_numpy(q)]).numpy()
    d = pts[:, :, None] - pts[:, None, :]
    r = np.sqrt((d * d).sum(0))
    rs = np.where(r > 0, r, 1.0)
    ref = np.where(r > 0, np.exp(1j * K * rs) / rs, 0) @ q
    assert _rel_linf(got, ref) < 1e-5


@pytest.mark.parametrize("k,kwargs", [
    (K, dict(pairs=True, dtype=np.float32)),
    (K, dict(level_to_order=lambda lev: 4)),
    (2.0 + 0.5j, dict(rscale="auto")),
    (2.0 + 0.5j, dict()),
    (K, dict(dtype=np.complex64)),
    (K, dict(dtype="float64")),
], ids=[  # as before dipoles were ported (test_torch_helmholtz3d_dipoles.py)
    "2.0-kwargs0", "2.0-kwargs2", "(2+0.5j)-kwargs3", "(2+0.5j)-kwargs4",
    "2.0-kwargs5", "2.0-kwargs6"])
def test_unported_options_raise(points, k, kwargs):
    with pytest.raises(NotImplementedError):
        make_helmholtz_wrangler(points[2], k, 4, **kwargs)


@pytest.mark.parametrize("dtype", ["complex128", np.dtype("complex128"),
                                   torch.complex128])
def test_complex128_spellings_accepted(points, dtype):
    w = make_helmholtz_wrangler(points[2], K, 2, dtype=dtype)
    assert w.dtype == torch.complex128 and w.real_dtype == torch.float64


def test_2d_raises():
    """A 2D traversal gets the 2D wrangler (``test_torch_helmholtz2d.py``);
    the options the port does not cover raise there too."""
    pts = np.random.default_rng(0).random((2, 200))
    trav = build_traversal(build_tree(pts, max_particles_in_box=20,
                                      device="cpu"))
    with pytest.raises(NotImplementedError):
        make_helmholtz_wrangler(trav, K, 4, pairs=True,
                                level_to_order=lambda lev: 4)

# }}}


# {{{ complex128 plumbing

@pytest.mark.parametrize("spelling", [np.complex128, np.dtype("complex128"),
                                      "complex128", torch.complex128])
def test_as_torch_dtype_complex128(spelling):
    assert as_torch_dtype(spelling) == torch.complex128


def test_to_numpy_complex():
    t = torch.tensor([1 + 2j, 3 - 4j], dtype=torch.complex128)
    np.testing.assert_array_equal(to_numpy(t.conj()),
                                  np.array([1 - 2j, 3 + 4j]))


def test_kernel_entry_points():
    """K9-K11 exist in complex128 and, as K47-K49, in float64 pairs; K2-K4
    and the dipole kernels K22 and K23 in float32, float64 and
    complex128."""
    assert set(kernels.DTYPES) == set(kernels.SIGNATURES)
    for name in ("p2p_helmholtz3d", "m2p_helmholtz3d", "p2l_helmholtz3d"):
        assert kernels._entry_names(name) == [f"{name}_f64",
                                              f"{name}_c128"]
    for name in ("p2p_laplace3d", "m2p_laplace3d", "p2l_laplace3d",
                 "p2p_laplace3d_dipole", "p2l_laplace3d_dipole"):
        assert kernels._entry_names(name) == [
            f"{name}_f32", f"{name}_f64", f"{name}_c128"]
    assert kernels._entry_names("peer_lists") == ["peer_lists"]
    with pytest.raises(TypeError, match="unsupported dtype"):
        kernels.launch("p2p_helmholtz3d", torch.float32)
    with pytest.raises(TypeError, match="unsupported dtype"):
        kernels.launch("p2p_laplace3d", torch.complex64)


@pytest.mark.parametrize("form", ["conjugated", "strided"])
def test_kernel_refuses_complex_views(form):
    """A complex tensor passes as its interleaved values, so a lazily
    conjugated or strided one is refused (before anything is built)."""
    sig = kernels.SIGNATURES["p2p_helmholtz3d"]
    q = torch.zeros(8, dtype=torch.complex128)
    bad = q.conj() if form == "conjugated" else q[::2]
    args = [bad if kind == "p" else (1.0 if kind == "d" else 1)
            for kind in sig[:-1]]
    with pytest.raises(ValueError, match="complex argument"):
        kernels.launch("p2p_helmholtz3d", torch.complex128, *args)

# }}}
