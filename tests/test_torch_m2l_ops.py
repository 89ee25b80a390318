"""The M2L operator tables of boxtree_torch's Laplace wranglers
(``boxtree_torch/ops/m2l_ops.py``, the twins of K69-K74 on the CPU)
against boxtree_tpu's ``_m2l_ops_device``, and the wranglers' tables
against the per-level path they were built by before the kernels.

- :func:`m2l_table_3d` / :func:`m2l_table_2d` at given translations and
  rscales (``tests/test_laplace.py:137-163``), spread over four levels,
  transposed back, against the reference's complex and pair
  ``_m2l_ops_device``: ``<= 1e-12`` of each operator's largest entry in
  complex128 and float64 pairs, ``<= 1e-6`` in float32 pairs (the cast),
  with rscale 1 and below 1, and with a ``level_to_order`` mask (the
  masked entries exactly 0).
- Every Laplace wrangler's table (2D and 3D; complex128, float64 and
  float32 pairs; rscale None and ``"auto"``; ``level_to_order``) equal bit
  for bit, zero signs included, to the per-level path
  (``ExpansionWranglerBase._m2l_table``: one ``_m2l_matrices`` call a
  level, then the cast, the mask and the transpose), and to the twin on
  the wrangler's own table inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.models import make_laplace_wrangler
from boxtree_torch.models.expansion_base import ExpansionWranglerBase
from boxtree_torch.ops import m2l_ops
from boxtree_torch.traversal import build_traversal
from boxtree_torch.traversal.neighbors import _offsets
from boxtree_tpu.models.laplace import (
    Laplace2DExpansionWrangler as Jax2D,
    Laplace2DPairsExpansionWrangler as Jax2DPairs,
    Laplace3DExpansionWrangler as Jax3D,
    Laplace3DPairsExpansionWrangler as Jax3DPairs,
    LaplaceTreeIndependentDataForWrangler as JaxTreeIndependent,
)
from torch_threads import one_torch_thread  # noqa: F401

#: orders: the 3D basis at order 8, the 2D powers to 19
ORDERS = {2: 9, 3: 4}
LEVELS = (2, 3, 4, 5)
ROOT = 1.0001
OP_RTOL = 1e-12
OP_RTOL32 = 1e-6
DTYPES = {"c128": torch.complex128, "f64": torch.float64,
          "f32": torch.float32}
TABLES = {2: m2l_ops.m2l_table_2d, 3: m2l_ops.m2l_table_3d}


def _inputs(dim, rscale, seed=5):
    """Per level of LEVELS a sorted random half of the window's classes:
    the translations, rscales and levels."""
    classes = _offsets(dim, 3, min_inf_norm=1)
    rng = np.random.default_rng(seed + dim)
    ts, rs, levels = [], [], []
    for lev in LEVELS:
        used = np.sort(rng.choice(len(classes), len(classes) // 2,
                                  replace=False))
        size = ROOT / (1 << lev)
        ts.append(classes[used].astype(np.float64) * size)
        r = 1.0 if rscale is None else min(size, 1.0)
        rs += [r] * len(used)
        levels += [lev] * len(used)
    return np.concatenate(ts), np.array(rs), np.array(levels)


def _jax_builder(dim, pairs):
    cls = {(2, False): Jax2D, (2, True): Jax2DPairs, (3, False): Jax3D,
           (3, True): Jax3DPairs}[dim, pairs]
    w = object.__new__(cls)
    w.order = ORDERS[dim]
    w.tree_indep = JaxTreeIndependent(dim, ORDERS[dim])
    w.ncoeff = w._ncoeff()
    return w


_REFS = {}


def _reference(dim, pairs, rscale):
    key = (dim, pairs, rscale)
    if key not in _REFS:
        ts, rs, _ = _inputs(dim, rscale)
        _REFS[key] = np.asarray(_jax_builder(dim, pairs)._m2l_ops_device(
            jnp.asarray(ts), jnp.asarray(rs)))
    return _REFS[key]


def _op_rel(got, ref):
    scale = np.abs(ref).max(axis=(1, 2))
    assert (scale > 0).all()
    return (np.abs(got - ref).max(axis=(1, 2)) / scale).max()


@pytest.mark.parametrize("rscale", [None, "auto"])
@pytest.mark.parametrize("layout", sorted(DTYPES))
@pytest.mark.parametrize("dim", [2, 3])
def test_table_matches_reference_device_builder(dim, layout, rscale):
    ts, rs, levels = _inputs(dim, rscale)
    dtype = DTYPES[layout]
    got = TABLES[dim](ts, rs, levels, ORDERS[dim], dtype, "cpu")
    assert got.dtype == dtype and got.is_contiguous()
    got = got.transpose(1, 2).numpy().astype(
        np.complex128 if dtype.is_complex else np.float64)
    ref = _reference(dim, layout != "c128", rscale)
    assert got.shape == ref.shape
    assert _op_rel(got, ref) <= (OP_RTOL32 if layout == "f32" else OP_RTOL)


@pytest.mark.parametrize("layout", ["c128", "f64"])
@pytest.mark.parametrize("dim", [2, 3])
def test_table_level_to_order_mask(dim, layout):
    """Each operator's rows and columns past its level's order are 0,
    the rest is the reference's."""
    ts, rs, levels = _inputs(dim, "auto")
    p = ORDERS[dim]
    level_orders = np.array([p, p, p, p - 1, p - 2, p - 3])
    got = TABLES[dim](ts, rs, levels, p, DTYPES[layout], "cpu",
                      level_orders=level_orders)
    got = got.transpose(1, 2).numpy()
    ref = _reference(dim, layout != "c128", "auto")
    orders = m2l_ops.coeff_orders(dim, p)
    if layout != "c128":
        orders = np.tile(orders, 2)
    keep = orders[None, :] <= level_orders[levels][:, None]
    keep = keep[:, :, None] & keep[:, None, :]
    assert (got[~keep] == 0).all()
    assert _op_rel(got, np.where(keep, ref, 0)) <= OP_RTOL


def _bits(t):
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


@pytest.fixture(scope="module")
def travs():
    rng = np.random.default_rng(12)
    p3 = rng.random((3, 700))
    p2 = rng.random((2, 1500))
    p2[:, :500] = 0.45 + 0.1 * p2[:, :500]
    return {d: build_traversal(build_tree(p, max_particles_in_box=15,
                                          device="cpu"))
            for d, p in ((3, p3), (2, p2))}


@pytest.mark.parametrize("opts", ["plain", "rscale", "level_to_order"])
@pytest.mark.parametrize("layout", sorted(DTYPES))
@pytest.mark.parametrize("dim", [2, 3])
def test_wrangler_table_equals_per_level_path(travs, dim, layout, opts):
    p = ORDERS[dim]
    kw = {"rscale": "auto"} if opts != "plain" else {}
    if opts == "level_to_order":
        kw["level_to_order"] = lambda lev: max(1, p - lev)
    else:
        kw["order"] = p
    w = make_laplace_wrangler(travs[dim], pairs=layout != "c128",
                              dtype=DTYPES[layout], **kw)
    used = w._m2l_plan.used
    assert len(used) > 0 and len({lev for lev, _ in used}) > 1
    old = ExpansionWranglerBase._m2l_table(
        w, used, _offsets(dim, 3, min_inf_norm=1))
    assert torch.equal(_bits(w._m2l_opsT), _bits(old))
    plain = (m2l_ops.m2l_table_2d_plain if dim == 2
             else m2l_ops.m2l_table_3d_plain)
    again = plain(*w._m2l_table_args, w.order, w.dtype, "cpu",
                  w.level_orders)
    assert torch.equal(_bits(again), _bits(old))


def test_table_refuses():
    ts, rs, levels = _inputs(3, None)
    with pytest.raises(TypeError):
        m2l_ops.m2l_table_3d(ts, rs, levels, 2, torch.complex64, "cpu")
    with pytest.raises(ValueError):
        m2l_ops.m2l_table_3d(ts[:, :2], rs, levels, 2, torch.float64, "cpu")
    with pytest.raises(ValueError):
        m2l_ops.m2l_table_2d(ts[:, :2], rs[:-1], levels, 2, torch.float64,
                             "cpu")
    empty = m2l_ops.m2l_table_3d(np.zeros((0, 3)), [], [], 2, torch.float32,
                                 "cpu")
    assert empty.shape == (0, 18, 18)
