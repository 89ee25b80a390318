"""boxtree_torch.traversal.build_traversal against boxtree_tpu's, field by
field, on the port's own tree.

Both packages build the tree and the traversal from the same numpy points
(the trees agree exactly, tests/test_torch_tree.py).  The port keeps the
reference's order within every CSR row (ascending box ids), so every list,
start and level-start array must be identical, including every field of
the per-source-level List-3 ``BuiltList``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import boxtree_tpu
from boxtree_torch import build_tree
from boxtree_torch.traversal import FMMTraversalInfo, build_traversal
from boxtree_torch.utils.bridge import to_numpy
from boxtree_tpu.traversal import build_traversal as jax_build_traversal
from boxtree_tpu.utils.particles import make_surface_particle_array
from torch_threads import one_torch_thread  # noqa: F401

CONFIGS = {
    "surface_f64": (make_surface_particle_array(3000, 3, np.float64, 11),
                    30),
    "clustered_f32": (np.concatenate(
        [np.random.default_rng(4).random((3, 2500)),
         np.random.default_rng(5).random((3, 1500)) * 0.1 + 0.3],
        axis=1).astype(np.float32), 20),
}
FIELDS = [f.name for f in dataclasses.fields(FMMTraversalInfo)
          if f.name not in ("tree", "from_sep_smaller_by_level")]
BUILT_LIST_FIELDS = ["count", "starts", "lists", "num_nonempty_lists",
                     "nonempty_indices"]


@pytest.fixture(scope="module")
def traversals():
    out = {}
    for name, (pts, nmax) in CONFIGS.items():
        ref = jax_build_traversal(
            boxtree_tpu.build_tree(pts, max_particles_in_box=nmax))
        got = build_traversal(build_tree(torch.from_numpy(pts),
                                         max_particles_in_box=nmax))
        out[name] = (ref, got)
    return out


def _assert_same(val, ref):
    if ref is None or isinstance(ref, (int, np.integer)):
        assert val == ref
        return
    ref = np.asarray(ref)
    assert val.dtype == ref.dtype and val.shape == ref.shape
    np.testing.assert_array_equal(val, ref)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_traversal_field(traversals, config, field):
    ref, got = traversals[config]
    val = to_numpy(getattr(got, field))
    if field == "target_boxes_sep_smaller_by_source_level":
        assert len(val) == len(getattr(ref, field))
        for v, r in zip(val, getattr(ref, field)):
            _assert_same(v, r)
    else:
        _assert_same(val, getattr(ref, field))


@pytest.mark.parametrize("field", BUILT_LIST_FIELDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_list3_by_level(traversals, config, field):
    ref, got = traversals[config]
    assert len(got.from_sep_smaller_by_level) == len(
        ref.from_sep_smaller_by_level)
    for g, r in zip(got.from_sep_smaller_by_level,
                    ref.from_sep_smaller_by_level):
        _assert_same(to_numpy(getattr(g, field)), getattr(r, field))


def test_lists_3_and_4_populated(traversals):
    _, got = traversals["surface_f64"]
    assert sum(bl.count for bl in got.from_sep_smaller_by_level) > 0
    assert got.from_sep_bigger_lists.shape[0] > 0


@pytest.mark.parametrize("kwargs", [
    dict(well_sep_is_n_away=2),
    dict(source_boxes_mask=np.ones(1, bool)),
])
def test_unported_options_raise(kwargs):
    tree = build_tree(np.random.default_rng(0).random((3, 200)),
                      max_particles_in_box=10, device="cpu")
    with pytest.raises(NotImplementedError):
        build_traversal(tree, **kwargs)
