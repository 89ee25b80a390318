"""The CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips without one.  The file imports neither JAX nor boxtree_tpu, so it
also runs where only PyTorch is installed::

    python -m pytest --noconftest -p no:randomly -q -m cuda \
        tests/test_torch_cuda.py

K1 must be bit-exact; K2-K4 agree with their twins to rel l-inf 1e-5 in
float32 (rsqrt and another summation order) and 1e-12 in float64.
"""

import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import (
    ConstantOneExpansionWrangler,
    make_laplace_wrangler,
)
from boxtree_torch.ops import kernels, laplace3d, morton
from boxtree_torch.traversal import build_traversal

pytestmark = pytest.mark.cuda

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _sphere(n, seed=11):
    x = np.random.default_rng(seed).standard_normal((3, n))
    return x / np.sqrt((x * x).sum(0))


def _rel(got, ref):
    ref = ref.double()
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def setup(request, device):
    dt = request.param
    n = 20000
    pts = torch.as_tensor(_sphere(n), dtype=dt, device=device)
    q = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                        dtype=dt, device=device)
    tree = build_tree(pts, max_particles_in_box=30)
    trav = build_traversal(tree)
    w = make_laplace_wrangler(trav, order=6, pairs=True, rscale="auto",
                              dtype=dt)
    return dt, tree, trav, w, w.reorder_sources(q), pts, q


def test_morton_encode_bit_exact(setup):
    dt, tree = setup[:2]
    coords = tree.sources
    lo = torch.amin(coords, dim=1)
    extent = torch.max(torch.amax(coords, dim=1) - lo) * 1.0001
    for iota_bits in (None, 15):
        got = morton.encode_points(coords, lo, extent, 16, iota_bits)
        ref = morton.encode_points_plain(coords, lo, extent, 16, iota_bits)
        assert torch.equal(got, ref)


def test_p2p_kernel(setup):
    dt, tree, trav, w, q = setup[:5]
    args = (w._targets, w._sources, q, tree.box_target_starts,
            tree.box_target_counts_nonchild, tree.box_source_starts,
            tree.box_source_counts_nonchild, trav.target_boxes,
            trav.neighbor_source_boxes_starts,
            trav.neighbor_source_boxes_lists)
    assert _rel(laplace3d.p2p_laplace3d(*args),
                laplace3d.p2p_laplace3d_plain(*args)) <= RTOL[dt]


def test_m2p_kernel(setup):
    dt, tree, trav, w, q = setup[:5]
    mp = w.coarsen_multipoles(None, None, w.form_multipoles(None, None,
                                                            [q]))
    args = (w._targets, tree.box_target_starts,
            tree.box_target_counts_nonchild, *w._l3_csr, mp, w.centers,
            w.box_scale, w.order)
    assert w._l3_csr[0].numel() > 0
    assert _rel(laplace3d.m2p_laplace3d(*args),
                laplace3d.m2p_laplace3d_plain(*args)) <= RTOL[dt]


def test_p2l_kernel(setup):
    dt, tree, trav, w, q = setup[:5]
    args = (w._sources, q, tree.box_source_starts,
            tree.box_source_counts_nonchild, *w._l4_csr, w.centers,
            w.box_scale, w.order)
    assert w._l4_csr[0].numel() > 0
    got = laplace3d.p2l_laplace3d(*args, w.local_expansion_zeros())
    ref = laplace3d.p2l_laplace3d_plain(*args, w.local_expansion_zeros())
    assert _rel(got, ref) <= RTOL[dt]


def test_fmm_on_card_matches_cpu(setup):
    dt, tree, trav, w, _, pts, q = setup
    if dt != torch.float64:
        pytest.skip("compared in float64")
    kernels.reset_launch_counts()
    got = drive_fmm(w, [q])
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("p2p_laplace3d", "m2p_laplace3d",
                                       "p2l_laplace3d"))
    trav_cpu = build_traversal(build_tree(pts.cpu(),
                                          max_particles_in_box=30))
    w_cpu = make_laplace_wrangler(trav_cpu, order=6, pairs=True,
                                  rscale="auto", dtype=torch.float64)
    ref = drive_fmm(w_cpu, [q.cpu()])
    assert _rel(got.cpu(), ref) <= 1e-11


def test_counting_fmm_on_card(device):
    pts = torch.as_tensor(np.random.default_rng(17).random(
        (3, 100000), dtype=np.float32), device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    pot = drive_fmm(ConstantOneExpansionWrangler(None, trav),
                    [torch.ones(100000, dtype=torch.float64, device=device)])
    assert torch.equal(pot, torch.full_like(pot, 100000))
