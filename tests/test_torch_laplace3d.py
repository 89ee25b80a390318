"""The whole 3D Laplace FMM of boxtree_torch (complex128 and real pairs,
dipole sources, ``level_to_order``) against boxtree_tpu's, and alone
against direct sums.

- The M2L table, built in torch on the wrangler's device, against the
  reference's own device builder (``_m2l_ops_device``): in pair layout at
  all 316 classes, in complex layout as the recorded reference wranglers
  built it (``level_to_order`` included); the batched M2M / L2L builders
  against the reference's host builders per shift: ``<= 1e-12`` of each
  operator's largest entry (the bar of ``tests/test_laplace.py:137-163``).
- The hooks of both layouts: P2M and L2P, and the twins of K2-K4, K28,
  K30 and of the dipole kernels K22 / K23 / K29, against the reference's
  hooks (and their JVPs) under ``jax.jit``, with a particle on the
  expansion centre or on a source (``r = 0``) among them.
- Every FMM stage and the slice (rel l-inf <= 1e-11, expansions per
  coefficient column) of the complex wrangler with ``rscale="auto"``, and
  of the complex and the float64 pairs wranglers with dipoles,
  ``level_to_order`` and ``rscale="auto"``, from two recorded JAX
  ``drive_fmm``s of the reference's complex wrangler on the port's
  traversal, one without and one with the options; the pairs are held to
  the second in pair layout (``[Re | Im]`` expansions, real potentials),
  which shares its compiles with the first; the float64 pairs without the
  options are held to the first likewise.  P2P is held to a correctly
  rounded float64 direct sum over the same List-1 pairs instead, as in
  ``test_torch_laplace_stages.py``.  P2M and L2P also through the twins
  of K28-K30 called directly, and in float32 pairs (1e-5).
- The rows of K28-K30 (the boxes that own particles) cover every source
  and every target exactly once, in the box ``box_id_of_*`` names, also
  with separate targets.
- The port alone: ``tests/test_laplace.py:200-227``'s four cases in 3D
  (pairs against the complex real part, <= 1e-12); dipoles at order 12
  against a direct sum (< 1e-5, ``tests/test_laplace.py:113-134``); the
  float32 pairs with dipoles against the float64 (1e-5); the options'
  checks and the factory's rules on CPU tensors.

Sources on the unit sphere (sources = targets in the recordings), so that
Lists 3 and 4 are populated.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.fmm.drive import FMM_STAGES
from boxtree_torch.models import (
    Laplace3DExpansionWrangler,
    Laplace3DPairsExpansionWrangler,
    LaplaceTreeIndependentDataForWrangler,
    make_laplace_wrangler,
)
from boxtree_torch.ops import laplace3d as l3
from boxtree_torch.ops import translate as tops
from boxtree_torch.ops import solid_harmonics as sh
from boxtree_torch.traversal import build_traversal
from boxtree_torch.traversal.neighbors import _offsets
from boxtree_tpu.fmm import drive_fmm as jax_drive_fmm
from boxtree_tpu.models.laplace import (
    Laplace3DExpansionWrangler as JaxComplex,
    Laplace3DPairsExpansionWrangler as JaxPairs,
    LaplaceTreeIndependentDataForWrangler as JaxTreeIndependent,
    make_laplace_wrangler as jax_make_laplace_wrangler,
)
from boxtree_tpu.models.particle_blocks import M2LPlan as JaxM2LPlan
from test_torch_helmholtz3d import _jax_traversal, _Recorder, _rel_linf
from test_torch_laplace2d import _cols_rel, clustered
from torch_threads import one_torch_thread  # noqa: F401
from torch_translate import check_rows, parent_block_m2l

N = 800
MAX_IN_BOX = 20
ORDER = 5
#: the order of the hooks' comparisons, each of the recurrences' branches
HOOK_ORDER = 3
RTOL = 1e-11
OP_RTOL = 1e-12
HOOK_RTOL = 1e-13
#: P2P's tolerance in units of eps * sum_j |term_ij| per target (see
#: ``test_torch_laplace_stages.py``)
P2P_EPS_COND = 16
STAGES = ["P2M", "M2M", "P2P", "M2L", "M2P", "P2L", "M2L+P2L", "L2L",
          "L2P"]


def level_to_order(lev):
    """Per-level orders of the form of ``tests/test_laplace.py:213``:
    ORDER = 5 down to 2."""
    return max(2, 5 - lev)


#: the port wranglers held to the recordings: (pairs, dtype, dipoles and
#: level_to_order)
KINDS = {"complex": (False, torch.complex128, False),
         "complex_dipoles": (False, torch.complex128, True),
         "pairs": (True, torch.float64, False),
         "pairs_dipoles": (True, torch.float64, True)}
#: the float32 pairs, held to the recordings in P2M and L2P only
KINDS32 = {"pairs32": (True, torch.float32, False),
           "pairs32_dipoles": (True, torch.float32, True)}
#: P2M and L2P of the float32 pairs against the float64 references
RTOL32 = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _sphere(n, seed):
    x = np.random.default_rng(seed).standard_normal((3, n))
    return x / np.sqrt((x * x).sum(0))


def _op_rel(got, ref):
    """Worst operator of ``max |got - ref| / max |ref|`` over (C, K, K)
    stacks."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=(1, 2))
    assert (scale > 0).all()
    return (np.abs(got - ref).max(axis=(1, 2)) / scale).max()


@pytest.fixture(scope="module")
def points():
    """Sources = targets on the unit sphere, real charges, dipoles."""
    rng = np.random.default_rng(3)
    pts = _sphere(N, 5)
    q = rng.standard_normal(N)
    dip = rng.standard_normal((3, N))
    trav = build_traversal(build_tree(pts, max_particles_in_box=MAX_IN_BOX,
                                      device="cpu"))
    return pts, q, dip, trav


# {{{ operators

def _jax_ops(kind, order=ORDER):
    """A reference wrangler object for its operator and hook builders
    (they read the order, the tree-independent data and the dtype)."""
    w = object.__new__(JaxComplex if kind == "complex" else JaxPairs)
    w.order = order
    w.tree_indep = JaxTreeIndependent(3, order)
    w.ncoeff = w._ncoeff()
    return w


def _port_ops(points, kind, order=ORDER, **kw):
    return make_laplace_wrangler(points[3], order, pairs=kind == "pairs",
                                 **kw)


@pytest.mark.parametrize("r", [1.0, 0.125])
def test_m2l_table_pairs_matches_reference_device_builder(points, r):
    """The torch M2L table of all 316 translation classes in pair layout
    against the reference's pairs ``_m2l_ops_device`` at the same
    translations and rscale, at HOOK_ORDER (the basis at order 6: every
    branch of the recurrences and of the index map)."""
    w = _port_ops(points, "pairs", HOOK_ORDER)
    classes = _offsets(3, 3, min_inf_norm=1)
    assert len(classes) == 316
    size = 0.25
    got = w._m2l_matrices(classes, size, r)
    assert isinstance(got, torch.Tensor) and got.device == w.device
    assert got.dtype == torch.float64
    ts = classes * size
    ref = np.asarray(_jax_ops("pairs", HOOK_ORDER)._m2l_ops_device(
        jnp.asarray(ts.astype(np.float64)), jnp.full(len(ts), r)))
    assert got.shape == ref.shape
    assert _op_rel(got.numpy(), ref) <= OP_RTOL


@pytest.mark.parametrize("kind", ["complex", "complex_dipoles"])
def test_m2l_table_matches_recorded_reference(recorded, kind):
    """The complex wrangler's M2L table, level by level, against the table
    the recorded reference wrangler built with its ``_m2l_ops_device``
    for the (level, class) pairs its lists use, with ``rscale="auto"``
    and, for the second recording, truncated by ``level_to_order``."""
    _, w, _, jw = recorded(kind)
    ref = np.asarray(jw._m2l_opsT)
    assert jw.m2l_plan.nops == len(ref) > 0
    assert w._m2l_plan.used == jw.m2l_plan.used
    got = w._m2l_opsT.numpy()
    assert got.dtype == ref.dtype == np.complex128
    assert _op_rel(got, ref) <= OP_RTOL


@pytest.mark.parametrize("rs", [(1.0, 1.0), (0.25, 0.5)])
@pytest.mark.parametrize("op", ["M2M", "L2L"])
@pytest.mark.parametrize("kind", ["complex", "pairs"])
def test_shift_operators_match_reference(points, kind, op, rs):
    """The batched M2M / L2L builders (one solid-harmonic evaluation over a
    level's eight shifts) against the reference's per-shift builders, with
    the rscales equal and apart."""
    w = _port_ops(points, kind)
    jw = _jax_ops(kind)
    signs = np.array([[1.0 if (q >> (2 - ax)) & 1 else -1.0
                       for ax in range(3)] for q in range(8)])
    off = signs * 0.0625
    r_small, r_big = rs
    if op == "M2M":
        got = w._m2m_matrices(-off, r_small, r_big)
        ref = [jw._m2m_matrix(-o, r_small, r_big) for o in off]
    else:
        got = w._l2l_matrices(off, r_big, r_small)
        ref = [jw._l2l_matrix(o, r_big, r_small) for o in off]
    assert _op_rel(got, np.stack(ref)) <= OP_RTOL


def test_m2l_table_level_truncation(points):
    """With ``level_to_order`` each level's M2L operators keep the rows
    and columns of its order and nothing else; M2M and L2L join two
    levels' orders."""
    w = make_laplace_wrangler(points[3], level_to_order=level_to_order,
                              rscale="auto")
    assert w.order == ORDER
    nm_n = w.tree_indep.nm_n
    levels = np.array([lev for lev, _ in w._m2l_plan.used])
    for lev in np.unique(levels):
        ops = w._m2l_opsT[torch.as_tensor(levels == lev)]
        keep = nm_n <= level_to_order(lev)
        nz = (ops != 0).any(0)
        assert not nz[~keep].any() and not nz[:, ~keep].any()
        assert nz[keep][:, keep].any(1).all()
    for lev, ops in w._m2m_opsT.items():
        # transposed: rows the child's coefficients, columns the parent's
        nz = (ops != 0).any(0)
        assert not nz[nm_n > level_to_order(lev)].any()
        assert not nz[:, nm_n > level_to_order(lev - 1)].any()

# }}}


# {{{ the hooks and the kernels' twins against the reference's hooks

HOOK_N = 40


def _hook_inputs():
    """Scaled offsets in the unit ball (the first at the origin), rscales,
    complex charges, dipoles, coefficients; and P2P's 20 targets and 30
    sources, the fourth target on the eighth source."""
    rng = np.random.default_rng(9)
    n, k = HOOK_N, sh.ncoeffs(HOOK_ORDER)
    rel = rng.uniform(-1.0, 1.0, (3, n))
    rel[:, 0] = 0.0
    src = rng.uniform(-1, 1, (3, 30))
    tgt = rng.uniform(-1, 1, (3, 20))
    tgt[:, 3] = src[:, 7]
    return dict(
        rel=rel, s=rng.uniform(0.2, 1.0, n),
        q=rng.standard_normal(n) + 1j * rng.standard_normal(n),
        dip=rng.standard_normal((3, n)),
        coef=rng.standard_normal((n, 2 * k)),
        tgt=tgt, src=src,
        qp=rng.standard_normal(30) + 1j * rng.standard_normal(30),
        dipp=rng.standard_normal((3, 30)))


def _kind_inputs(kind):
    """:func:`_hook_inputs` for *kind*: real charges and pair coefficients
    for the pairs, complex ones for the complex layout."""
    x = _hook_inputs()
    k = sh.ncoeffs(HOOK_ORDER)
    if kind == "pairs":
        x["q"], x["qp"] = x["q"].real, x["qp"].real
    else:
        x["coef"] = x["coef"][:, :k] + 1j * x["coef"][:, k:]
    return x


@pytest.fixture(scope="module")
def hook_refs():
    """Per layout, the reference's hooks and their JVPs at
    :func:`_kind_inputs`, each layout in one ``jax.jit``."""
    refs = {}
    for kind in ("complex", "pairs"):
        jw = _jax_ops(kind, HOOK_ORDER)
        x = _kind_inputs(kind)
        valid = np.ones(30, bool)

        def f(rel, s, q, dip, coef, tgt, src, qp, dipp, jw=jw):
            p2l = lambda r: jw._p2l_terms(r, q, s[:, None])  # noqa: E731
            p2p = lambda ss: jw._p2p(tgt, ss, valid, qp)  # noqa: E731
            out = {"m2p": jw._m2p_eval(rel, coef, s), "p2l": p2l(rel),
                   "p2l_dipole": jax.jvp(p2l, (rel,), (dip / s,))[1],
                   "p2p": p2p(src),
                   "p2p_dipole": jax.jvp(p2p, (src,), (dipp,))[1],
                   "p2m": jw._p2m_terms(rel, q),
                   "l2p": jw._l2p_eval(rel, coef)}
            out["p2m_dipole"] = jax.jvp(lambda r: jw._p2m_terms(r, q),
                                        (rel,), (dip / s,))[1]
            return out
        refs[kind] = {name: np.asarray(v) for name, v in jax.jit(f)(
            x["rel"], x["s"], x["q"], x["dip"], x["coef"], x["tgt"].T,
            x["src"].T, x["qp"], x["dipp"].T).items()}
    return refs


def _one_per_box(n):
    """CSR arguments with row box i listing box n + i, each box holding
    particle i: box starts and counts over 2n boxes, rows, starts, lists."""
    i32 = torch.arange(n, dtype=torch.int32)
    return (torch.cat([i32, i32]), torch.ones(2 * n, dtype=torch.int32),
            i32, torch.arange(n + 1, dtype=torch.int32), i32 + n)


def _hook_compare(got, ref):
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.ndim == 1:
        return np.abs(got - ref).max() / np.abs(ref).max()
    return _cols_rel(got, ref)


@pytest.mark.parametrize("hook", ["p2m", "l2p", "p2m_dipole"])
@pytest.mark.parametrize("kind", ["complex", "pairs"])
def test_particle_hooks_match_reference(hook_refs, kind, hook):
    """The P2M and L2P terms of the plain twins of K28-K30 (each layout by
    its dtype) and P2M's dipole JVP against the reference's hooks."""
    x = {k: _t(v) for k, v in _kind_inputs(kind).items()}
    if hook == "p2m":
        got = l3.p2m_terms(x["rel"], x["q"], HOOK_ORDER)
    elif hook == "l2p":
        got = l3.l2p_eval(x["rel"], x["coef"], HOOK_ORDER)
    else:
        got = torch.func.jvp(lambda r: l3.p2m_terms(r, x["q"], HOOK_ORDER),
                             (x["rel"],), (x["dip"] / x["s"],))[1]
    assert _hook_compare(got, hook_refs[kind][hook]) <= HOOK_RTOL


@pytest.mark.parametrize("via", ["wrapper", "twin"])
@pytest.mark.parametrize("kind", ["complex", "pairs"])
@pytest.mark.parametrize("which", ["p2m", "p2m_dipole", "l2p"])
def test_p2m_l2p_twins_match_reference_hooks(hook_refs, which, kind, via):
    """K28, K29 and K30's twins and their CPU wrappers, one particle per
    box (centre 0, scale s_i), against the reference's ``_p2m_terms``
    (and its JVP along ``d / r``) and ``_l2p_eval`` at the same scaled
    offsets.  The first particle sits on its box's centre (``r = 0``):
    its charge lands on ``R_0^0`` alone, its dipole on the ``n = 1``
    terms alone, and its potential is ``L_0^0``."""
    x = _kind_inputs(kind)
    n = HOOK_N
    ref = hook_refs[kind][which]
    starts, counts, rows = _one_per_box(n)[:3]
    centers = torch.zeros((3, n), dtype=torch.float64)
    scale = _t(x["s"])
    pts = _t(x["rel"] * x["s"])
    name = {"p2m": "p2m_laplace3d", "p2m_dipole": "p2m_laplace3d_dipole",
            "l2p": "l2p_laplace3d"}[which]
    fn = getattr(l3, name if via == "wrapper" else f"{name}_plain")
    if which == "l2p":
        got = fn(pts, starts[:n], counts[:n], rows, _t(x["coef"]), centers,
                 scale, HOOK_ORDER)
        assert got[0] == ref[0] == x["coef"][0, 0]
    else:
        dip = (_t(x["dip"]),) if which == "p2m_dipole" else ()
        got = fn(pts, _t(x["q"]), *dip, starts[:n], counts[:n], rows,
                 centers, scale, HOOK_ORDER)
        k = sh.ncoeffs(HOOK_ORDER)
        lanes = np.arange(ref.shape[1]) % k
        at = (lanes == 0) if which == "p2m" else (lanes >= 1) & (lanes < 4)
        assert (got[0].numpy()[~at] == 0).all() and (ref[0][~at] == 0).all()
        assert (ref[0][at] != 0).any()
        if which == "p2m":
            assert got[0, 0] == ref[0, 0] == x["q"][0]
    assert _hook_compare(got, ref) <= HOOK_RTOL


@pytest.mark.parametrize("kind", ["complex", "pairs"])
@pytest.mark.parametrize("which", ["m2p", "p2l", "p2l_dipole"])
def test_list_twins_match_reference_hooks(hook_refs, kind, which):
    """K3, K4 and K23's twins, one particle per listed box, against the
    reference's ``_m2p_eval`` / ``_p2l_terms`` (and the JVP of the latter
    along ``d / r``) at the same scaled offsets, the origin among them."""
    x = _kind_inputs(kind)
    n = HOOK_N
    ref = hook_refs[kind][which]
    starts, counts, rows, csr, lists = _one_per_box(n)
    centers = torch.zeros((3, 2 * n), dtype=torch.float64)
    s = x["s"]
    scale = _t(np.concatenate([s, s]))
    pts = _t(x["rel"] * s)
    if which == "m2p":
        mp = torch.cat([torch.zeros_like(_t(x["coef"])), _t(x["coef"])])
        got = l3.m2p_laplace3d(pts, starts, counts, rows, csr, lists, mp,
                               centers, scale, HOOK_ORDER)
        assert got[0] == 0 and ref[0] == 0
    else:
        # row box i (centre 0, scale s_i) lists box n + i, source i
        out = torch.zeros((2 * n, ref.shape[1]), dtype=_t(ref).dtype)
        args = (starts, counts, rows, csr, lists, centers, scale,
                HOOK_ORDER, out)
        if which == "p2l":
            got = l3.p2l_laplace3d(pts, _t(x["q"]), *args)
        else:
            got = l3.p2l_laplace3d_dipole(pts, _t(x["q"]), _t(x["dip"]),
                                          *args)
        got = got[:n]
        assert (got[0] == 0).all() and (ref[0] == 0).all()
    assert _hook_compare(got, ref) <= HOOK_RTOL


@pytest.mark.parametrize("kind", ["complex", "pairs"])
@pytest.mark.parametrize("dipoles", [False, True])
def test_p2p_twins_match_reference_hook(hook_refs, kind, dipoles):
    """K2 and K22's twins against the reference's ``_p2p`` (and its JVP in
    the source positions) on one target box and one source box, one
    target on a source."""
    x = _kind_inputs(kind)
    i32 = torch.zeros(1, dtype=torch.int32)
    args = (i32, torch.tensor([20], dtype=torch.int32), i32,
            torch.tensor([30], dtype=torch.int32), i32,
            torch.tensor([0, 1], dtype=torch.int32), i32)
    tgt, src, q = _t(x["tgt"]), _t(x["src"]), _t(x["qp"])
    if dipoles:
        got = l3.p2p_laplace3d_dipole(tgt, src, q, _t(x["dipp"]), *args)
    else:
        got = l3.p2p_laplace3d(tgt, src, q, *args)
    ref = hook_refs[kind]["p2p_dipole" if dipoles else "p2p"]
    assert _hook_compare(got, ref) <= HOOK_RTOL

# }}}


# {{{ against boxtree_tpu's recorded FMMs, stage by stage

def _lap(trav, kind, dip):
    pairs, dtype, dipoles = {**KINDS, **KINDS32}[kind]
    if dipoles:
        kw = dict(level_to_order=level_to_order, dipole_vec=dip)
    else:
        kw = dict(order=ORDER)
    return make_laplace_wrangler(trav, pairs=pairs, dtype=dtype,
                                 rscale="auto", **kw)


def _p2p_direct(trav, q_tree, dip_tree):
    """Per tree-order target: the correctly rounded float64 sum of the
    List-1 terms ``q_j g_ij`` (``g = 1/r``, or ``d_j . (t_i - s_j) / r^3``
    with dipoles; ``r = 0`` skipped), real and imaginary parts apart, and
    ``sum_j |q_j g_ij|``."""
    tree = trav.tree
    tgt, src = tree.targets.numpy(), tree.sources.numpy()
    q = q_tree.numpy()
    tst = tree.box_target_starts.numpy()
    tcn = tree.box_target_counts_nonchild.numpy()
    sst = tree.box_source_starts.numpy()
    scn = tree.box_source_counts_nonchild.numpy()
    starts = trav.neighbor_source_boxes_starts.numpy()
    lists = trav.neighbor_source_boxes_lists.numpy()
    exact = np.zeros(tgt.shape[1], q.dtype)
    cond = np.zeros(tgt.shape[1])
    for row, box in enumerate(trav.target_boxes.numpy()):
        ti = np.arange(tst[box], tst[box] + tcn[box])
        sj = np.concatenate([np.arange(sst[b], sst[b] + scn[b])
                             for b in lists[starts[row]:starts[row + 1]]])
        d = tgt[:, ti, None] - src[:, None, sj]
        r = np.sqrt((d * d).sum(0))
        rs = np.where(r > 0, r, 1)
        g = 1 / rs if dip_tree is None else \
            (dip_tree.numpy()[:, None, sj] * d).sum(0) / rs ** 3
        terms = np.where(r > 0, q[sj] * g, 0)
        exact.real[ti] = [math.fsum(t) for t in terms.real]
        if np.iscomplexobj(exact):
            exact.imag[ti] = [math.fsum(t) for t in terms.imag]
        cond[ti] = np.abs(terms).sum(1)
    return exact, cond


def _as_layout(x, kind):
    """A complex reference array in the port wrangler's layout: ``[re |
    im]`` lanes of expansions and the real part of potentials for the
    pairs."""
    x = np.asarray(x)
    if {**KINDS, **KINDS32}[kind][0]:
        return x.real if x.ndim == 1 else np.concatenate([x.real, x.imag],
                                                         axis=1)
    return x


def _jax_recording(points, dipoles):
    """One recorded JAX ``drive_fmm`` of the complex wrangler at ORDER
    with ``rscale="auto"``, or with the dipoles and ``level_to_order``
    (whose largest order is ORDER): ``(stage outputs, potentials)``."""
    _, q, dip, trav = points
    if dipoles:
        kw = dict(level_to_order=level_to_order, dipole_vec=dip)
    else:
        kw = dict(order=ORDER)
    jw = _Recorder(jax_make_laplace_wrangler(
        _jax_traversal(trav), pairs=False, rscale="auto", **kw))
    jpot = np.asarray(jax_drive_fmm(jw, [jnp.asarray(q)]))
    return ({name: np.asarray(v) for name, v in jw.outputs.items()}, jpot,
            jw._inner)


def _record(points, ref, kind):
    """``(stages, w)``: each stage's reference and port output for the
    port wrangler of *kind* (each port stage fed the reference's inputs),
    and the wrangler."""
    _, q, dip, trav = points
    w = _lap(trav, kind, dip)
    tq = w.reorder_sources(torch.from_numpy(q))

    def lay(name):
        return _as_layout(ref[name], kind)

    mp, mp_up = lay("form_multipoles"), lay("coarsen_multipoles")
    loc, p2l = lay("multipole_to_local"), lay("form_locals")
    lsb_totp = trav.level_start_target_or_target_parent_box_nrs
    totp = trav.target_or_target_parent_boxes
    out = {
        "P2M": (mp, w.form_multipoles(trav.level_start_source_box_nrs,
                                      trav.source_boxes, [tq])),
        "M2M": (mp_up, w.coarsen_multipoles(
            trav.level_start_source_parent_box_nrs, trav.source_parent_boxes,
            _t(mp))),
        "P2P": (_p2p_direct(trav, tq, w.dipole_vec), w.eval_direct(
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
        # as the port's drive_fmm calls it: added in place into the M2L
        # output
        "M2L+P2L": (loc + p2l, w.form_locals(
            lsb_totp, totp, trav.from_sep_bigger_starts,
            trav.from_sep_bigger_lists, [tq], _t(loc))),
        "L2L": (lay("refine_locals"), w.refine_locals(
            lsb_totp, totp, _t(loc + p2l))),
        "L2P": (lay("eval_locals"), w.eval_locals(
            trav.level_start_target_box_nrs, trav.target_boxes,
            _t(lay("refine_locals")))),
    }
    return out, w


@pytest.fixture(scope="module")
def recordings(points):
    """The two recordings of :func:`_jax_recording`, by whether it has
    the dipoles and ``level_to_order``, each made on first use."""
    cache = {}

    def get(dipoles):
        if dipoles not in cache:
            cache[dipoles] = _jax_recording(points, dipoles)
        return cache[dipoles]
    return get


@pytest.fixture(scope="module")
def recorded(points, recordings):
    """``(stages, w, reference potentials, reference wrangler)`` per kind,
    each kind made on first use."""
    cache = {}

    def get(kind):
        if kind not in cache:
            ref, jpot, jw = recordings(KINDS[kind][2])
            cache[kind] = (*_record(points, ref, kind),
                           _as_layout(jpot, kind), jw)
        return cache[kind]
    return get


def test_lists_populated(points):
    trav = points[3]
    tree = trav.tree
    assert tree.nlevels >= 4 and tree.sources_are_targets
    w = _lap(trav, "complex", None)
    assert w._l3_csr is not None and w._l4_csr[2].numel() > 0
    assert trav.from_sep_siblings_lists.numel() > 0


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stages_match_reference(recorded, kind, stage):
    ref, got = recorded(kind)[0][stage]
    got = got.numpy()
    dtype = np.complex128 if not KINDS[kind][0] else np.float64
    assert got.dtype == dtype
    if stage == "P2P":
        exact, cond = ref
        err = np.abs(got - exact)
        assert (err <= P2P_EPS_COND * np.finfo(float).eps * cond).all()
        return
    assert got.shape == ref.shape and ref.dtype == dtype
    if got.ndim == 1:
        assert _rel_linf(got, ref) <= RTOL
        return
    if KINDS[kind][0]:
        # a coefficient's two lanes to the coefficient's scale, as in the
        # complex layout: the imaginary lane of an m = 0 coefficient of
        # real charges is zero but for rounding
        k = got.shape[1] // 2
        got, ref = (x[:, :k] + 1j * x[:, k:] for x in (got, ref))
    # expansions: each coefficient's column to its own scale; with
    # level_to_order the masked columns must be zero on both sides
    assert _cols_rel(got, ref) <= RTOL


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_slice_matches_reference(points, recorded, kind):
    q = points[1]
    _, w, jpot, _ = recorded(kind)
    timing = {}
    got = drive_fmm(w, [torch.from_numpy(q)], timing_data=timing)
    assert got.dtype == KINDS[kind][1] and got.shape == (N,)
    assert set(timing) == set(FMM_STAGES)
    assert _rel_linf(got.numpy(), jpot) <= RTOL


def _as_complex(x, kind):
    """Pair-layout expansions as complex columns, so that a coefficient's
    two lanes are held to the coefficient's scale."""
    if {**KINDS, **KINDS32}[kind][0] and x.ndim == 2:
        k = x.shape[1] // 2
        return x[:, :k] + 1j * x[:, k:]
    return x


@pytest.mark.parametrize("stage", ["P2M", "L2P"])
@pytest.mark.parametrize("kind", sorted(KINDS) + sorted(KINDS32))
def test_p2m_l2p_twins_match_recorded(points, recordings, kind, stage):
    """P2M and L2P through K28-K30's twins called directly (the level
    mask applied as the wrangler applies it) and, for the float32 pairs,
    through the wrangler's stages, against the recorded reference stage:
    1e-11 in complex128 and float64, 1e-5 in float32 (expansions per
    coefficient column)."""
    _, q, dip, trav = points
    pairs, dtype, dipoles = {**KINDS, **KINDS32}[kind]
    ref, _, _ = recordings(dipoles)
    w = _lap(trav, kind, dip)
    tree = trav.tree
    tq = w.reorder_sources(torch.from_numpy(q))
    if stage == "P2M":
        want = _as_layout(ref["form_multipoles"], kind)
        args = (tree.box_source_starts, tree.box_source_counts_nonchild,
                w._source_rows, w.centers, w.box_scale, w.order)
        if dipoles:
            twin = l3.p2m_laplace3d_dipole_plain(w._sources, tq,
                                                 w.dipole_vec, *args)
        else:
            twin = l3.p2m_laplace3d_plain(w._sources, tq, *args)
        got = [w._mask_levels(twin)]
        if dtype == torch.float32:
            got.append(w.form_multipoles(None, None, [tq]))
    else:
        want = _as_layout(ref["eval_locals"], kind)
        loc = w._mask_levels(_t(_as_layout(ref["refine_locals"],
                                           kind)).to(dtype))
        got = [l3.l2p_laplace3d_plain(
            w._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, w._target_rows, loc, w.centers,
            w.box_scale, w.order)]
        if dtype == torch.float32:
            got.append(w.eval_locals(None, None, loc))
    rtol = RTOL32 if dtype == torch.float32 else RTOL
    for g in got:
        g = g.numpy()
        assert g.dtype == {torch.complex128: np.complex128,
                           torch.float64: np.float64,
                           torch.float32: np.float32}[dtype]
        assert g.shape == want.shape
        if g.ndim == 1:
            assert _rel_linf(g, want) <= rtol
        else:
            assert _cols_rel(_as_complex(g.astype(want.dtype), kind),
                             _as_complex(want, kind)) <= rtol


def assert_rows_cover(tree, what, rows):
    """The ranges ``[box_<what>_starts, + box_<what>_counts_nonchild)`` of
    the boxes *rows* (int32, ascending) are the boxes with particles, and
    cover every particle exactly once, in the box ``box_id_of_<what>``
    names."""
    counts = getattr(tree, f"box_{what}_counts_nonchild").numpy()
    starts = getattr(tree, f"box_{what}_starts").numpy()
    owner = getattr(tree, f"box_id_of_{what}").numpy()
    rows = rows.numpy()
    assert rows.dtype == np.int32
    np.testing.assert_array_equal(rows, np.flatnonzero(counts > 0))
    idx = np.concatenate([np.arange(starts[b], starts[b] + counts[b])
                          for b in rows])
    np.testing.assert_array_equal(np.sort(idx), np.arange(len(owner)))
    np.testing.assert_array_equal(owner[idx], np.repeat(rows, counts[rows]))


@pytest.mark.parametrize("what", ["source", "target"])
@pytest.mark.parametrize("tree_of", ["sources_are_targets",
                                     "separate_targets"])
def test_particle_rows_cover_each_particle_once(points, dipole_case,
                                                tree_of, what):
    trav = (points[3] if tree_of == "sources_are_targets"
            else dipole_case[0])
    assert trav.tree.sources_are_targets == (tree_of ==
                                             "sources_are_targets")
    w = make_laplace_wrangler(trav, 2, pairs=True)
    assert_rows_cover(trav.tree, what, getattr(w, f"_{what}_rows"))


@pytest.mark.parametrize("kind", ["complex_dipoles", "pairs_dipoles"])
def test_level_to_order_masks_expansions(recorded, kind):
    """The multipoles and locals hold no coefficient past their box's
    level order."""
    stages, w, _, _ = recorded(kind)
    nm = w.tree_indep.nm_n
    if KINDS[kind][0]:
        nm = np.tile(nm, 2)
    lev = w.tree.box_levels.numpy()
    past = nm[None, :] > np.array([level_to_order(x) for x in lev])[:, None]
    assert past.any()
    for name in ("P2M", "M2M", "M2L+P2L", "L2L"):
        assert (stages[name][1].numpy()[past] == 0).all(), name

# }}}


# {{{ the M2L plan: its used keys, opid and rows, and K35's computation

def _expansions_rel(got, ref, kind):
    """Worst coefficient column of expansions, the pairs' two lanes of a
    coefficient to its complex scale (see test_stages_match_reference)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if {**KINDS, **KINDS32}[kind][0]:
        k = got.shape[1] // 2
        got, ref = (x[:, :k] + 1j * x[:, k:] for x in (got, ref))
    return _cols_rel(got, ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_m2l_parent_blocks_match_reference(recorded, kind):
    """What K35 computes, from the plan's own tables (the padded target
    parents, their colleague slots, ``opid``, the child tables), against
    the reference's M2L on its own multipoles."""
    stages, w, _, _ = recorded(kind)
    mp_up, loc = stages["M2M"][0], stages["M2L"][0]
    got = parent_block_m2l(_t(mp_up), w._m2l_plan)
    assert _expansions_rel(got.numpy(), loc, kind) <= RTOL


@pytest.mark.parametrize("stage", ["M2M", "M2L", "L2L"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_translate_twins_match_reference(recorded, kind, stage):
    """The plain twins of K35-K37, called as the wrangler's stages call
    the kernels (M2M and L2L level by level, in place), against the
    reference's stages."""
    stages, w, _, _ = recorded(kind)
    lsb = w._lsb
    if stage == "M2M":
        mp = _t(stages["P2M"][0])
        for lev in range(w.tree.nlevels - 1, 2, -1):
            tops.m2m_translate_plain(mp, w._m2m_opsT[lev], w._child,
                                     lsb[lev - 1], lsb[lev] - lsb[lev - 1])
        got, ref = mp, stages["M2M"][0]
    elif stage == "M2L":
        got = tops.m2l_translate_plain(_t(stages["M2M"][0]), w._m2l_plan)
        ref = stages["M2L"][0]
    else:
        got = _t(stages["M2L+P2L"][0])
        for lev in range(1, w.tree.nlevels):
            tops.l2l_translate_plain(got, w._l2l_opsT[lev],
                                     w._l2l_rows[lev], w._tgt_child)
        ref = stages["L2L"][0]
    assert _expansions_rel(got.numpy(), ref, kind) <= RTOL


def test_m2l_plan_rows(recorded):
    """K35's rows: each level's target parents, ascending, padded to
    whole tiles."""
    w = recorded("complex")[1]
    check_rows(w._m2l_plan, w.tree, tops.ROW_PAD)
    assert w._m2l_plan.pmap.shape == (w._m2l_plan.rows.shape[0], 27)


def test_m2l_opid_matches_reference(recorded):
    """``opid`` against the reference's ``(nlevels, m, qs, qt)`` map of
    its parent-block plan (``expansion_base.py:951-968``), and the
    colleague slots of the target parents against its ``pmap``."""
    w, jw = recorded("complex")[1], recorded("complex")[3]
    try:
        assert jw._build_m2l_parent_plan()
        jpmap, jopid = jw._m2l_parent[:2]
        jpmap = np.asarray(jpmap)
    finally:
        jw._m2l_parent = None
    plan = w._m2l_plan
    assert np.array_equal(plan.opid.numpy(), jopid)
    rows = plan.rows.numpy()
    ok = rows >= 0
    assert np.array_equal(plan.pmap.numpy()[ok], jpmap[rows[ok]])


def _uniform_tree():
    pts = np.random.default_rng(61).random((3, 1500))
    return build_traversal(build_tree(pts, max_particles_in_box=12,
                                      device="cpu"))


def _line_tree(dims, nsources=30):
    """``tests/test_stability.py:36-43``'s geometric line: a 15+-level
    tree of separate sources and targets."""
    line = np.array([2.0 ** -i for i in range(nsources // 2)])
    line = np.hstack([line, 3 - line])
    zero = np.zeros(nsources)
    src = np.vstack([line, zero, zero])[:dims]
    tgt = src * (1 + 1e-3)
    trav = build_traversal(build_tree(src, targets=tgt,
                                      max_particles_in_box=2, device="cpu"))
    assert trav.tree.nlevels >= 15
    return src, tgt, trav


@pytest.mark.parametrize("tree", ["uniform3d", "clustered2d", "line3d"])
def test_m2l_used_keys_match_reference(tree):
    """The table's (level, class) keys, and its row count, equal the
    reference ``M2LPlan``'s ``_used_keys`` on the port's traversal
    (``particle_blocks.py:148-298``, classified from List 2's edges): a
    uniform 3D tree, a clustered 2D tree and the line tree at order 8."""
    if tree == "uniform3d":
        trav = _uniform_tree()
        w = make_laplace_wrangler(trav, 2, pairs=True)
    elif tree == "clustered2d":
        trav = build_traversal(build_tree(clustered(1200, 62),
                                          max_particles_in_box=10,
                                          device="cpu"))
        w = make_laplace_wrangler(trav, 3, pairs=True)
    else:
        trav = _line_tree(3)[2]
        w = make_laplace_wrangler(trav, 8, rscale="auto")
    d = trav.tree.dimensions
    jplan = JaxM2LPlan(_jax_traversal(trav), _offsets(d, 3, min_inf_norm=1))
    keys = [lev * jplan.nclasses + c for lev, c in w._m2l_plan.used]
    assert len(keys) > 0
    assert np.array_equal(np.array(keys), jplan._used_keys)
    assert w._m2l_opsT.shape == (jplan.nops, w.ncoeff, w.ncoeff)


@pytest.mark.parametrize("order", [15, 31])
def test_line_tree_table_and_accuracy(order):
    """``tests/test_stability.py:28``'s 3D line at order 15 and 31 on the
    port: the M2L table holds one ((p+1)^2, (p+1)^2) complex128 operator
    per used (level, class), at most one a List-2 edge (15; not 316 a
    level: at order 31, 0.18 GB against ~79.5 GB), and the potentials meet
    the reference's bar (3/4)^(p+1).  Order 31 takes ~26 s and ~5 GB here,
    most of it the M2M / L2L operators of 16 levels."""
    src, tgt, trav = _line_tree(3)
    w = make_laplace_wrangler(trav, order, rscale="auto")
    k = (order + 1) ** 2
    nops = len(w._m2l_plan.used)
    assert 0 < nops <= trav.from_sep_siblings_lists.shape[0] == 15
    assert w._m2l_plan.nbytes == nops * k * k * 16
    pot = drive_fmm(w, [torch.ones(src.shape[1], dtype=torch.float64)])
    pot = pot.numpy().real
    assert not np.isnan(pot).any()
    diff = src[:, None, :] - tgt[:, :, None]
    ref = (1 / np.sqrt((diff * diff).sum(0))).sum(1)
    assert np.abs(pot - ref).max() / np.abs(ref).max() < (3 / 4) ** (
        order + 1)

# }}}


# {{{ the port alone

@pytest.mark.parametrize("case", ["plain", "rscale", "level_to_order",
                                  "dipoles"])
def test_pairs_match_complex(case):
    """``tests/test_laplace.py:200-227`` in 3D: the pairs wrangler against
    the complex one's real part, <= 1e-12."""
    rng = np.random.default_rng(44)
    n = 700
    pts = rng.random((3, n))
    trav = build_traversal(build_tree(pts, max_particles_in_box=25,
                                      device="cpu"))
    q = rng.standard_normal(n)
    kw = {"plain": {"order": 6},
          "rscale": {"order": 6, "rscale": "auto"},
          "level_to_order": {"level_to_order": lambda lev: max(3, 7 - lev),
                             "rscale": "auto"},
          "dipoles": {"order": 5,
                      "dipole_vec": rng.standard_normal((3, n))}}[case]
    ref = drive_fmm(make_laplace_wrangler(trav, pairs=False, **kw),
                    [torch.from_numpy(q)]).numpy()
    w = make_laplace_wrangler(trav, pairs=True, **kw)
    assert not w.dtype.is_complex
    pot = drive_fmm(w, [torch.from_numpy(q)]).numpy()
    assert np.abs(pot - ref.real).max() / np.abs(ref).max() <= 1e-12


def _dipole_direct(tgt, src, w, dip):
    diff = tgt[:, :, None] - src[:, None, :]
    r3 = ((diff * diff).sum(0)) ** 1.5
    return ((dip[:, None, :] * diff).sum(0) / r3) @ w


@pytest.fixture(scope="module")
def dipole_case():
    """``tests/test_laplace.py:113-134``'s geometry, smaller: sources on
    the unit sphere with normal dipoles, targets in [-1, 1]^3."""
    rng = np.random.default_rng(45)
    ns, nt = 400, 250
    src = _sphere(ns, 46)
    tgt = rng.random((3, nt)) * 2 - 1
    w = rng.standard_normal(ns)
    dip = rng.standard_normal((3, ns))
    trav = build_traversal(build_tree(src, targets=tgt,
                                      max_particles_in_box=30, device="cpu"))
    return trav, w, dip, _dipole_direct(tgt, src, w, dip)


def test_dipoles_order12_against_direct_sum(dipole_case):
    trav, w, dip, ref = dipole_case
    wr = make_laplace_wrangler(trav, 12, dipole_vec=dip, rscale="auto")
    assert type(wr) is Laplace3DExpansionWrangler
    pot = drive_fmm(wr, [torch.from_numpy(w)]).numpy()
    assert _rel_linf(pot.real, ref) < 1e-5


def test_dipoles_float32_pairs_match_float64(dipole_case):
    trav, w, dip, _ = dipole_case
    kw = dict(pairs=True, dipole_vec=dip, rscale="auto")
    ref = drive_fmm(make_laplace_wrangler(trav, 6, **kw),
                    [torch.from_numpy(w)]).numpy()
    w32 = make_laplace_wrangler(trav, 6, dtype=torch.float32, **kw)
    assert w32.dipole_vec.dtype == torch.float32
    got = drive_fmm(w32, [torch.from_numpy(w.astype(np.float32))])
    assert got.dtype == torch.float32
    assert _rel_linf(got.numpy(), ref) <= 1e-5


def test_dipoles_already_reordered(dipole_case):
    """Dipoles given in tree order with ``dipoles_already_reordered`` give
    the same wrangler state as in user order."""
    trav, _, dip, _ = dipole_case
    a = make_laplace_wrangler(trav, 3, dipole_vec=dip)
    tree_order = dip[:, trav.tree.user_source_ids.numpy()]
    b = make_laplace_wrangler(trav, 3, dipole_vec=tree_order,
                              dipoles_already_reordered=True)
    assert torch.equal(a.dipole_vec, b.dipole_vec)
    assert torch.equal(a.dipole_vec, torch.from_numpy(tree_order))


@pytest.mark.parametrize("shape", [(3, 10), (2, 400), (400, 3)])
def test_dipole_vec_wrong_shape_raises(dipole_case, shape):
    with pytest.raises(ValueError, match="dipole_vec"):
        make_laplace_wrangler(dipole_case[0], 3, dipole_vec=np.zeros(shape))


def test_factory_rules_3d(points):
    """The reference's rules (``laplace.py:615-657``) on a CPU tree."""
    trav, dip = points[3], points[2]
    cases = [
        (dict(), Laplace3DExpansionWrangler, torch.complex128),
        (dict(pairs=False), Laplace3DExpansionWrangler, torch.complex128),
        (dict(dtype=np.complex128), Laplace3DExpansionWrangler,
         torch.complex128),
        (dict(pairs=True), Laplace3DPairsExpansionWrangler, torch.float64),
        (dict(pairs=True, dtype=np.complex128),
         Laplace3DPairsExpansionWrangler, torch.float64),
        (dict(pairs=True, dtype=np.complex64),
         Laplace3DPairsExpansionWrangler, torch.float32),
        (dict(pairs=True, dtype="float32"), Laplace3DPairsExpansionWrangler,
         torch.float32),
        (dict(dipole_vec=dip), Laplace3DExpansionWrangler,
         torch.complex128),
        (dict(pairs=True, dipole_vec=dip), Laplace3DPairsExpansionWrangler,
         torch.float64),
    ]
    for kw, cls, dt in cases:
        w = make_laplace_wrangler(trav, 4, **kw)
        assert type(w) is cls and w.dtype == dt, kw
        assert w.ncoeff == (25 if cls is Laplace3DExpansionWrangler else 50)
        assert w.centers.device.type == "cpu"
        assert (w.dipole_vec is not None) == ("dipole_vec" in kw)
    w = make_laplace_wrangler(trav, level_to_order=lambda lev: 2 + lev)
    assert type(w) is Laplace3DExpansionWrangler
    assert w.order == 1 + trav.tree.nlevels
    assert list(w.level_orders) == [2 + lev
                                    for lev in range(trav.tree.nlevels)]
    ti = LaplaceTreeIndependentDataForWrangler(3, 4)
    assert w.tree_indep.nm_n.shape == (w.ncoeff,) and ti.nm_n.shape == (25,)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(), TypeError),
    (dict(order=4, level_to_order=lambda lev: 4), TypeError),
    (dict(order=4, pairs=False, dtype=np.complex64), NotImplementedError),
    (dict(order=4, dtype=np.complex64), NotImplementedError),
    (dict(order=4, pairs=False, dtype=np.float64), NotImplementedError),
    # rotation M2L is ported, but not with level_to_order, as in the
    # reference (expansion_base.py:370-372)
    (dict(level_to_order=lambda lev: 4, m2l_mode="rotation"),
     NotImplementedError),
])
def test_factory_refusals_3d(points, kwargs, exc):
    with pytest.raises(exc):
        make_laplace_wrangler(points[3], **kwargs)


def test_pairs_refuse_complex_weights(points):
    w = make_laplace_wrangler(points[3], 3, pairs=True)
    with pytest.raises(TypeError):
        w.reorder_sources(np.ones(N, np.complex128))


def test_wrappers_refuse_mismatched_dtypes():
    l3._check_dtypes(torch.complex128, torch.float64)
    l3._check_dtypes(torch.float32, torch.float32)
    for val, real in ((torch.complex64, torch.float32),
                      (torch.float32, torch.float64),
                      (torch.complex128, torch.float32)):
        with pytest.raises(TypeError):
            l3._check_dtypes(val, real)
    assert l3.smem_bytes(12, torch.float64) == (2 * 169 + 4) * 8
    l3._check_order(100, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        l3._check_order(150, torch.float64)

# }}}
