"""The whole boxtree_torch slice: points -> tree -> traversal -> FMM.

- The counting FMM (Config C) on the port's own tree and traversal: every
  potential equals the number of sources, exactly.
- The 3D Laplace FMM (real pairs, ``rscale="auto"``) against boxtree_tpu's
  ``drive_fmm`` on the same points: rel l-inf <= 1e-11 in float64 (the same
  math summed in another order) and <= 1e-5 in float32 (float32
  arithmetic is ~6e-7 per operation).
- Order 10 in float64 against the direct sum: rel l-inf < 1e-5 (the
  Config-D bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxtree_tpu
from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import (
    ConstantOneExpansionWrangler,
    Laplace3DExpansionWrangler,
    make_laplace_wrangler,
)
from boxtree_torch.traversal import build_traversal
from boxtree_tpu.fmm import drive_fmm as jax_drive_fmm
from boxtree_tpu.models.laplace import (
    make_laplace_wrangler as jax_make_laplace_wrangler,
)
from boxtree_tpu.traversal import build_traversal as jax_build_traversal
from boxtree_tpu.utils.particles import make_surface_particle_array
from torch_threads import one_torch_thread  # noqa: F401

N = 3000


def _rel_linf(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() \
        / np.abs(ref).max()


def _points(kind, dims=3, n=N):
    rng = np.random.default_rng(17)
    if kind == "surface":
        return make_surface_particle_array(n, dims, np.float64, seed=11)
    if kind == "uniform":
        return rng.random((dims, n))
    return np.concatenate([rng.random((dims, n // 2)),
                           rng.random((dims, n - n // 2)) * 0.05 + 0.4],
                          axis=1)


@pytest.mark.parametrize("kind,dims", [
    ("uniform", 3), ("surface", 3), ("clustered", 3), ("surface", 2)])
def test_counting_fmm_exact(kind, dims):
    pts = _points(kind, dims)
    trav = build_traversal(build_tree(pts, max_particles_in_box=20,
                                         device="cpu"))
    w = ConstantOneExpansionWrangler(None, trav)
    pot = drive_fmm(w, [torch.ones(pts.shape[1], dtype=torch.float64)])
    assert torch.equal(pot, torch.full_like(pot, pts.shape[1]))


def test_counting_fmm_separate_targets():
    rng = np.random.default_rng(2)
    sources = _points("surface")
    targets = rng.random((3, 1000))
    trav = build_traversal(build_tree(sources, targets=targets,
                                      max_particles_in_box=20, device="cpu"))
    w = ConstantOneExpansionWrangler(None, trav)
    pot = drive_fmm(w, [torch.ones(N, dtype=torch.float64)])
    assert pot.shape == (1000,)
    assert torch.equal(pot, torch.full_like(pot, N))


@pytest.fixture(scope="module")
def charges():
    return np.random.default_rng(1).standard_normal(N)


@pytest.fixture(scope="module")
def f64_slice():
    pts = _points("surface")
    jtrav = jax_build_traversal(
        boxtree_tpu.build_tree(pts, max_particles_in_box=30))
    trav = build_traversal(build_tree(pts, max_particles_in_box=30,
                                      device="cpu"))
    return pts, jtrav, trav


@pytest.mark.parametrize("order", [5, 8])
def test_laplace_slice_f64_matches_reference(f64_slice, charges, order):
    _, jtrav, trav = f64_slice
    jw = jax_make_laplace_wrangler(jtrav, order=order, pairs=True,
                                   rscale="auto", dtype=np.float64)
    ref = jax_drive_fmm(jw, [jnp.asarray(charges)])
    w = make_laplace_wrangler(trav, order=order, pairs=True, rscale="auto",
                              dtype=np.float64)
    got = drive_fmm(w, [torch.from_numpy(charges)])
    assert got.dtype == torch.float64 and got.shape == (N,)
    assert _rel_linf(got.numpy(), ref) <= 1e-11


def test_laplace_slice_f32_matches_reference(charges):
    pts = _points("surface").astype(np.float32)
    q = charges.astype(np.float32)
    jtrav = jax_build_traversal(
        boxtree_tpu.build_tree(pts, max_particles_in_box=30))
    jw = jax_make_laplace_wrangler(jtrav, order=6, pairs=True,
                                   rscale="auto", dtype=np.float32)
    ref = jax_drive_fmm(jw, [jnp.asarray(q)])
    trav = build_traversal(build_tree(pts, max_particles_in_box=30,
                                      device="cpu"))
    w = make_laplace_wrangler(trav, order=6, pairs=True, rscale="auto",
                              dtype=torch.float32)
    got = drive_fmm(w, [torch.from_numpy(q)])
    assert got.dtype == torch.float32
    assert _rel_linf(got.numpy(), ref) <= 1e-5


def test_laplace_order10_against_direct_sum(f64_slice, charges):
    pts, _, trav = f64_slice
    w = make_laplace_wrangler(trav, order=10, pairs=True, rscale="auto",
                              dtype=np.float64)
    got = drive_fmm(w, [torch.from_numpy(charges)]).numpy()
    d = pts[:, :, None] - pts[:, None, :]
    r = np.sqrt((d * d).sum(0))
    np.fill_diagonal(r, np.inf)
    ref = (charges[None, :] / r).sum(1)
    assert _rel_linf(got, ref) < 1e-5


@pytest.mark.parametrize("kwargs", [
    dict(order=4, pairs=False),
    dict(level_to_order=lambda lev: 4),
    dict(order=4, dipole_vec=np.zeros((3, 10))),
])
def test_unported_wrangler_options_raise(f64_slice, kwargs):
    """Options that raised before the 3D wrangler took them, now as the
    reference has them: ``pairs=False`` gives the complex wrangler,
    ``level_to_order`` is accepted, and a ``dipole_vec`` of the wrong
    shape raises ValueError."""
    trav = f64_slice[2]
    if "dipole_vec" in kwargs:
        with pytest.raises(ValueError, match="dipole_vec"):
            make_laplace_wrangler(trav, **kwargs)
        return
    w = make_laplace_wrangler(trav, **kwargs)
    assert type(w) is Laplace3DExpansionWrangler
    assert w.dtype == torch.complex128 and w.order == 4
    assert (w.level_orders is None) == ("order" in kwargs)
