"""boxtree_torch.traversal.build_traversal against boxtree_tpu's, field by
field, on the port's own tree, and the plain twins of K24-K27 against the
matching JAX table and traversal fields.

Both packages build the tree and the traversal from the same numpy points
(the trees agree exactly, tests/test_torch_tree.py).  The port keeps the
reference's order within every CSR row (ascending box ids), so every list,
start and level-start array must be identical, including every field of
the per-source-level List-3 ``BuiltList``.  Two 3D configs and one
shallow 2D one (6 levels), so that both branches of every twin are held
to JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

import boxtree_tpu
from boxtree_torch import build_tree
from boxtree_torch.ops import traversal as tops
from boxtree_torch.traversal import FMMTraversalInfo, build_traversal
from boxtree_torch.traversal.build import list_inputs
from boxtree_torch.utils.bridge import to_numpy
from boxtree_tpu.traversal import build_traversal as jax_build_traversal
from boxtree_tpu.traversal.neighbors import (
    build_neighbor_table as jax_build_neighbor_table,
)
from boxtree_tpu.utils.particles import make_surface_particle_array
from torch_threads import one_torch_thread  # noqa: F401

def _clustered_2d(n=2000, seed=7):
    """2,000 points in the unit square, a quarter of them in [0.3,
    0.55]^2: 6 levels at 25 a box, Lists 3 and 4 populated."""
    rng = np.random.default_rng(seed)
    pts = rng.random((2, n))
    pts[:, :n // 4] = 0.25 * rng.random((2, n // 4)) + 0.3
    return pts


CONFIGS = {
    "surface_f64": (make_surface_particle_array(3000, 3, np.float64, 11),
                    30),
    "clustered_f32": (np.concatenate(
        [np.random.default_rng(4).random((3, 2500)),
         np.random.default_rng(5).random((3, 1500)) * 0.1 + 0.3],
        axis=1).astype(np.float32), 20),
    "clustered_2d_f64": (_clustered_2d(), 25),
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


def _ref_list3_keys(ref):
    """The reference's List-3 keys ``(target_box << 32) | w`` of each
    source level, from its compressed ``BuiltList``s."""
    out = []
    for bl, tb in zip(ref.from_sep_smaller_by_level,
                      ref.target_boxes_sep_smaller_by_source_level):
        rows = np.repeat(np.asarray(tb).astype(np.int64),
                         np.diff(np.asarray(bl.starts)))
        out.append((rows << 32) | np.asarray(bl.lists).astype(np.int64))
    return out


@pytest.mark.parametrize("twin", ["neighbor_table", "row_lists_sl_l2",
                                  "lists_43", "list1"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_twin_against_jax(traversals, config, twin):
    """The plain twin of each of K24-K27 (what the wrappers run on CPU
    tensors) against JAX's table and the matching traversal fields."""
    ref, got = traversals[config]
    (targs, tkw), inp = list_inputs(got.tree)
    if twin == "neighbor_table":
        rt = ref.tree
        tgt_mask = np.zeros(rt.nboxes, bool)
        tgt_mask[np.asarray(ref.target_boxes)] = True
        want = jax_build_neighbor_table(
            rt.box_morton_prefixes, rt.box_parent_ids, rt.box_child_ids,
            rt.box_flags, tgt_mask, dimensions=rt.dimensions,
            lsb=tuple(int(x) for x in rt.level_start_box_nrs))
        _assert_same(to_numpy(tops.neighbor_table(*targs, **tkw)), want)
        assert torch.equal(tops.neighbor_table(*targs, **tkw), inp.ntable)
    elif twin == "row_lists_sl_l2":
        fields = ["same_level_non_well_sep_boxes_starts",
                  "same_level_non_well_sep_boxes_lists",
                  "from_sep_siblings_starts", "from_sep_siblings_lists"]
        for val, field in zip(tops.row_lists_sl_l2(inp), fields):
            _assert_same(to_numpy(val), getattr(ref, field))
    elif twin == "lists_43":
        l4_starts, l4_lists, l3 = tops.lists_43(inp)
        _assert_same(to_numpy(l4_starts), ref.from_sep_bigger_starts)
        _assert_same(to_numpy(l4_lists), ref.from_sep_bigger_lists)
        want = _ref_list3_keys(ref)
        assert len(l3) == len(want)
        for keys, w in zip(l3, want):
            _assert_same(to_numpy(keys), w)
    else:
        starts, lists = tops.list1(inp)
        _assert_same(to_numpy(starts), ref.neighbor_source_boxes_starts)
        _assert_same(to_numpy(lists), ref.neighbor_source_boxes_lists)
