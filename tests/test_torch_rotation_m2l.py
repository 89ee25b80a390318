"""The rotation ("point-and-shoot") M2L of boxtree_torch's 3D Laplace
wranglers against boxtree_tpu's, and against the port's dense M2L.

- The edge plan (:class:`boxtree_torch.models.particle_blocks.M2LPlan`,
  the twin of K75 / K76 on the CPU) against the reference ``M2LPlan`` on
  the port's traversal: ``tgt``, ``src``, ``group_sizes`` and ``used``
  exactly equal.
- The rotation and axial blocks and their index sets against the
  reference ``RotationM2L``'s ``_rot_ops``, ``_unrot_ops``, ``_ax_ops``,
  ``_deg_idx``, ``_ax_src_idx`` and ``_ax_dst_idx`` (complex and pairs),
  to 1e-12 of each block's largest entry.
- The M2L stage in rotation mode (the twin of K77-K79) against the
  reference's ``multipole_to_local_edges`` on the same multipoles, made
  from a seed, to 1e-11 (complex128 and float64 pairs); the reference's
  eager grouped matmuls take ~10 s a layout here, so the stage is
  compared, not a whole reference FMM.
- The port alone: its rotation FMM against its dense FMM on the same
  traversal (1e-12 complex128 and float64 pairs, with charges and with
  dipoles; float32 pairs within 1e-5 of the complex128 dense FMM), the
  operator identity ``T(t) = conj(W_A)^T T(|t| z) W_S^-T`` of
  ``tests/test_laplace.py:257-293`` on the port's blocks and table
  builder (1e-12), the tiles K77-K79 run over, and the refusals: 2D,
  ``level_to_order`` and 3D Helmholtz (``NotImplementedError``) and a bad
  mode (``ValueError``); the Helmholtz factory takes ``"dense"``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import make_helmholtz_wrangler, make_laplace_wrangler
from boxtree_torch.models import rotation_m2l as rm
from boxtree_torch.ops import m2l_ops
from boxtree_torch.ops import rotation as rot
from boxtree_torch.ops import solid_harmonics as sh
from boxtree_torch.traversal import build_traversal
from boxtree_tpu.models.laplace import (
    make_laplace_wrangler as jax_make_laplace_wrangler,
)
from test_torch_helmholtz3d import _jax_traversal, _rel_linf
from torch_threads import one_torch_thread  # noqa: F401

N = 800
MAX_IN_BOX = 20
ORDER = 4
RTOL = 1e-11
OP_RTOL = 1e-12
FMM_RTOL = 1e-12
FMM_RTOL32 = 1e-5


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(33)
    pts = rng.random((3, N))
    q = rng.standard_normal(N)
    dip = rng.standard_normal((3, N))
    trav = build_traversal(build_tree(pts, max_particles_in_box=MAX_IN_BOX,
                                      device="cpu"))
    return trav, q, dip


@pytest.fixture(scope="module")
def references(case):
    """The reference rotation wranglers (complex, pairs) on the port's
    traversal, and the port's, by layout."""
    trav = case[0]
    jt = _jax_traversal(trav)
    out = {}
    for kind, pairs in (("complex", False), ("pairs", True)):
        jw = jax_make_laplace_wrangler(jt, order=ORDER, m2l_mode="rotation",
                                       pairs=pairs)
        w = make_laplace_wrangler(trav, ORDER, m2l_mode="rotation",
                                  pairs=pairs)
        out[kind] = (jw, w)
    return out


def test_plan_matches_reference(references):
    jw, w = references["complex"]
    jp, plan = jw.m2l_plan, w.m2l_plan
    assert plan.nops > 0 and plan.used == jp.used
    assert np.array_equal(plan._used_keys, jp._used_keys)
    for name in ("tgt", "src", "group_sizes"):
        got, ref = getattr(plan, name).numpy(), np.asarray(getattr(jp, name))
        assert got.dtype == np.int32 and np.array_equal(got, ref), name
    assert plan.edges.sizes.sum() == plan.tgt.shape[0]
    assert w._m2l_rot.nrotations == jw._m2l_rot.nrotations < plan.nops


def _blocks_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=(-2, -1))
    assert (scale > 0).all()
    return (np.abs(got - ref).max(axis=(-2, -1)) / scale).max()


@pytest.mark.parametrize("kind", ["complex", "pairs"])
def test_blocks_match_reference(references, kind):
    jw, w = references[kind]
    jr = jw._m2l_rot
    blocks = w._m2l_rot.blocks
    rotm, unrotm, axm = blocks.matrices(w.dtype)
    rc = blocks.rc_of_op.to(torch.int64)
    deg, dst, src = rot._column_sets(ORDER, kind == "pairs", "cpu")
    worst = 0.0
    for n in range(ORDER + 1):
        worst = max(worst, _blocks_rel(rotm[n][rc], jr._rot_ops[n]),
                    _blocks_rel(unrotm[n][rc], jr._unrot_ops[n]))
        assert np.array_equal(deg[n].numpy(), np.asarray(jr._deg_idx[n]))
    for i in range(2 * ORDER + 1):
        worst = max(worst, _blocks_rel(axm[i], jr._ax_ops[i]))
        assert np.array_equal(dst[i].numpy(), np.asarray(jr._ax_dst_idx[i]))
        assert np.array_equal(src[i].numpy(), np.asarray(jr._ax_src_idx[i]))
    assert worst <= OP_RTOL, worst


@pytest.mark.parametrize("kind", ["complex", "pairs"])
def test_m2l_stage_matches_reference(case, references, kind):
    """The M2L stage on multipoles made from a seed: the twin of K77-K79
    through ``multipole_to_local`` against the reference's
    ``multipole_to_local_edges`` on its own plan."""
    jw, w = references[kind]
    trav = case[0]
    rng = np.random.default_rng(8)
    mp = rng.standard_normal((trav.tree.nboxes, w.ncoeff))
    if kind == "complex":
        mp = mp + 1j * rng.standard_normal(mp.shape)
    jp = jw.m2l_plan
    ref = np.asarray(jw.multipole_to_local_edges(
        jp.tgt, jp.src, jp.group_sizes, jnp.asarray(mp)))
    got = w.multipole_to_local(
        trav.level_start_target_or_target_parent_box_nrs,
        trav.target_or_target_parent_boxes, trav.from_sep_siblings_starts,
        trav.from_sep_siblings_lists, torch.from_numpy(mp))
    assert _rel_linf(got.numpy(), ref) <= RTOL


@pytest.mark.parametrize("layout,dipoles", [
    ("complex", False), ("pairs", False), ("complex", True),
    ("pairs", True), ("pairs32", False)])
def test_rotation_fmm_matches_dense(case, layout, dipoles):
    """Rotation against dense on the same traversal; float32 pairs against
    the complex128 dense FMM."""
    trav, q, dip = case
    kw = dict(rscale="auto")
    if dipoles:
        kw["dipole_vec"] = dip
    pairs = layout != "complex"
    dtype = torch.float32 if layout == "pairs32" else None
    ref = drive_fmm(make_laplace_wrangler(trav, ORDER, pairs=False, **kw),
                    [q]).numpy()
    w = make_laplace_wrangler(trav, ORDER, pairs=pairs, dtype=dtype,
                              m2l_mode="rotation", **kw)
    assert w._m2l_rot is not None and w._m2l_rot.pairs == pairs
    assert not hasattr(w, "_m2l_opsT")
    pot = drive_fmm(w, [q]).numpy()
    err = _rel_linf(pot, ref.real if pairs else ref)
    assert err <= (FMM_RTOL32 if dtype else FMM_RTOL), err


def test_rotation_identity_direct():
    """``T(t) = conj(W_A)^T T(|t| z) W_S^-T`` with the port's blocks and
    table builder (``tests/test_laplace.py:257-293``)."""
    p = 5
    rng = np.random.default_rng(1)
    sample = rng.standard_normal((3, 2 * p + 7))
    sample /= np.linalg.norm(sample, axis=0)
    for t in ([3.0, -2.0, 1.0], [0.0, 3.0, 0.0], [-2.0, -2.0, -2.0]):
        t = np.asarray(t)
        rz = rm._rotation_to_z(t / np.linalg.norm(t))
        wa = sla.block_diag(*rm._fit_rotation_blocks(rz, p, sample))
        ws = sla.block_diag(*rm._fit_rotation_blocks(
            rz, p, sample, basis=sh.irregular))
        ts = np.stack([t, [0.0, 0.0, np.linalg.norm(t)]])
        tmat, tax = m2l_ops.m2l_table_3d(
            ts, [1.0, 1.0], [0, 0], p, torch.complex128,
            "cpu").transpose(1, 2).numpy()
        lhs = np.conj(wa).T @ tax @ np.linalg.inv(ws).T
        err = np.abs(lhs - tmat).max() / np.abs(tmat).max()
        assert err < OP_RTOL, (t, err)


def test_tiles_cover_each_edge_once(references):
    """The tiles of K77-K79: every edge once, in its operator's run, at
    most a tile long; and ``select`` keeps the chosen runs."""
    plan = references["pairs"][1].m2l_plan
    for tile in (1, 8, 64):
        op, start, length = (a.numpy() for a in plan.edges.tiles(tile))
        assert (length >= 1).all() and (length <= tile).all()
        first = np.concatenate([[0], np.cumsum(plan.edges.sizes)])
        assert (start >= first[op]).all()
        assert (start + length <= first[op + 1]).all()
        covered = np.zeros(plan.edges.nedges, int)
        for s, n in zip(start, length):
            covered[s:s + n] += 1
        assert (covered == 1).all()
    sub = plan.edges.select([0, 2])
    assert sub.nedges == plan.edges.sizes[[0, 2]].sum()
    assert rot.tile_edges((ORDER + 1) ** 2, torch.float32) == rot.MAX_TILE
    assert rot.tile_edges(1024, torch.complex128) == 2


def test_refusals(case):
    trav = case[0]
    with pytest.raises(ValueError):
        make_laplace_wrangler(trav, ORDER, m2l_mode="fast")
    with pytest.raises(NotImplementedError):
        make_laplace_wrangler(trav, level_to_order=lambda lev: 3,
                              m2l_mode="rotation")
    trav2 = build_traversal(build_tree(
        np.random.default_rng(2).random((2, 300)), max_particles_in_box=20,
        device="cpu"))
    with pytest.raises(NotImplementedError, match="3D-only"):
        make_laplace_wrangler(trav2, ORDER, m2l_mode="rotation")
    for pairs in (False, True):
        with pytest.raises(NotImplementedError, match="delta-sparsity"):
            make_helmholtz_wrangler(trav, 2.0, ORDER, pairs=pairs,
                                    m2l_mode="rotation")
    with pytest.raises(ValueError):
        make_helmholtz_wrangler(trav, 2.0, ORDER, m2l_mode="fast")
    with pytest.raises(NotImplementedError, match="3D-only"):
        make_helmholtz_wrangler(trav2, 2.0, ORDER, m2l_mode="rotation")


@pytest.mark.parametrize("dim", [2, 3])
def test_helmholtz_factory_takes_dense(case, dim):
    """``m2l_mode="dense"`` reaches the Helmholtz wranglers as the default
    does (it raised ``TypeError`` before)."""
    trav = case[0] if dim == 3 else build_traversal(build_tree(
        np.random.default_rng(2).random((2, 300)), max_particles_in_box=20,
        device="cpu"))
    w = make_helmholtz_wrangler(trav, 2.0, 3, pairs=False, m2l_mode="dense")
    ref = make_helmholtz_wrangler(trav, 2.0, 3, pairs=False)
    assert w.m2l_mode == "dense"
    assert torch.equal(w._m2l_opsT, ref._m2l_opsT)
