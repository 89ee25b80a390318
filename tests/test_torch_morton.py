"""boxtree_torch.ops.morton against boxtree_tpu.ops.morton: bit-exact.

The same numpy inputs go through both packages; Morton keys, packed sort
keys (and their sorted order) and decoded cells must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxtree_torch.ops import morton as tmorton
from boxtree_tpu.ops import morton as jmorton
from torch_threads import one_torch_thread  # noqa: F401


def _coords(dims, dtype, n=5000, seed=7):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((dims, n)).astype(dtype)
    pts[:, :50] = pts[:, 50:100]            # coincident points
    return pts


def _bbox(pts):
    """Bounding box and root extent as boxtree_tpu's _phase_a makes them."""
    c = jnp.asarray(pts)
    lo = jnp.min(c, axis=1)
    extent = jnp.max(jnp.max(c, axis=1) - lo) * (1 + 1e-4)
    return np.array(lo), np.array(extent)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("packed", [False, True])
def test_encode_points_bit_exact(dims, dtype, packed):
    pts = _coords(dims, dtype)
    lo, extent = _bbox(pts)
    n = pts.shape[1]
    iota_bits = max(1, int(n - 1).bit_length())
    depth = (63 - iota_bits) // dims
    ref = np.asarray(jmorton.encode_points(jnp.asarray(pts), jnp.asarray(lo),
                                           jnp.asarray(extent), depth))
    if packed:
        ref = (ref << np.int64(iota_bits)) | np.arange(n, dtype=np.int64)
    got = tmorton.encode_points(torch.from_numpy(pts), torch.from_numpy(lo),
                                torch.from_numpy(extent), depth,
                                iota_bits if packed else None)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    if packed:
        np.testing.assert_array_equal(torch.sort(got).values.numpy(),
                                      np.sort(ref))


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_cells_from_coords_bit_exact(dims):
    pts = _coords(dims, np.float32, n=2000, seed=dims)
    lo, extent = _bbox(pts)
    ref = np.asarray(jmorton.cells_from_coords(
        jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(extent), 12))
    got = tmorton.cells_from_coords(torch.from_numpy(pts),
                                    torch.from_numpy(lo),
                                    torch.from_numpy(extent), 12)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_interleave_deinterleave(dims):
    rng = np.random.default_rng(dims)
    depth = 62 // dims
    cells = rng.integers(0, 1 << depth, size=(dims, 3000), dtype=np.int64)
    ref = np.asarray(jmorton.interleave(jnp.asarray(cells)))
    got = tmorton.interleave(torch.from_numpy(cells))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tmorton.deinterleave(got, dims)
    np.testing.assert_array_equal(back.numpy(), cells)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmorton.deinterleave(jnp.asarray(ref),
                                                      dims)))
