"""boxtree_torch exports the public names of boxtree_tpu, package by
package, less an explicit list of names not ported yet; and the API-parity
wrappers ``TreeBuilder`` and ``FMMTraversalBuilder`` behave as the
reference's (same outputs, same argument checks).

A later slice that ports a name takes it off ``NOT_PORTED``.
"""

import importlib

import numpy as np
import pytest
import torch

from boxtree_torch import TreeBuilder, build_tree
from boxtree_torch.traversal import (
    FMMTraversalBuilder,
    build_traversal,
    merge_close_lists,
)
from boxtree_torch.tree import TreeBuilder as TreeBuilderOfTree
from boxtree_tpu.traversal import (
    FMMTraversalBuilder as JaxFMMTraversalBuilder,
)
from torch_threads import one_torch_thread  # noqa: F401

#: per subpackage, the reference's public names the port lacks
NOT_PORTED = {
    "": {"coarsen_tree_of_boxes", "make_tree_of_boxes_root",
         "refine_and_coarsen_tree_of_boxes", "refine_tree_of_boxes",
         "uniformly_refine_tree_of_boxes"},
    ".tree": set(),
    ".traversal": set(),
    ".fmm": {"jit_drive_fmm", "staged_drive_fmm"},
    ".models": set(),
    ".geometry": set(),
    ".parallel": set(),
    ".cost": set(),
}
#: per subpackage, names the port exports that the reference's ``__all__``
#: does not list: ``boxtree_tpu.tree`` declares none, its names are the
#: top level's
PORT_ONLY = {
    ".tree": {"MaxLevelsExceeded", "Tree", "TreeBuilder", "TreeOfBoxes",
              "box_flags_enum", "build_tree"},
}


@pytest.mark.parametrize("sub", sorted(NOT_PORTED))
def test_all_matches_reference(sub):
    port = importlib.import_module(f"boxtree_torch{sub}")
    ref = importlib.import_module(f"boxtree_tpu{sub}")
    port_all = set(port.__all__)
    ref_all = set(getattr(ref, "__all__", ()))
    assert ref_all - port_all == NOT_PORTED[sub]
    assert port_all - ref_all == PORT_ONLY.get(sub, set())
    for name in port_all:
        assert getattr(port, name) is not None


def _points(n=400, seed=3):
    return np.random.default_rng(seed).random((2, n))


def test_tree_builder():
    assert TreeBuilder is TreeBuilderOfTree
    pts = _points()
    a = TreeBuilder()(pts, max_particles_in_box=10, device="cpu")
    # a leading array-context-like argument is dropped
    b = TreeBuilder(object())(object(), pts, max_particles_in_box=10,
                              device="cpu")
    ref = build_tree(pts, max_particles_in_box=10, device="cpu")
    for t in (a, b):
        assert t.nboxes == ref.nboxes
        assert torch.equal(t.box_source_starts, ref.box_source_starts)
    assert TreeBuilder.ROOT_EXTENT_STRETCH_FACTOR == 1e-4


def test_traversal_builder_and_merge():
    tree = build_tree(_points(), max_particles_in_box=10, device="cpu")
    ref = build_traversal(tree)
    for trav in (FMMTraversalBuilder()(tree),
                 FMMTraversalBuilder(None, 1, "precise_linf")(None, tree),
                 FMMTraversalBuilder(1)(tree)):
        assert torch.equal(trav.from_sep_siblings_lists,
                           ref.from_sep_siblings_lists)
        assert torch.equal(trav.neighbor_source_boxes_lists,
                           ref.neighbor_source_boxes_lists)


def test_merge_close_lists_export():
    """The exported function merges as the traversal's own method does."""
    rng = np.random.default_rng(4)
    tree = build_tree(_points(), targets=rng.random((2, 100)),
                      target_radii=rng.uniform(0.01, 0.05, 100),
                      stick_out_factor=0.25, max_particles_in_box=10,
                      device="cpu")
    trav = build_traversal(tree)
    assert trav.from_sep_close_smaller_lists is not None
    merged, ref = merge_close_lists(trav), trav.merge_close_lists()
    assert merged.from_sep_close_smaller_lists is None
    assert torch.equal(merged.neighbor_source_boxes_starts,
                       ref.neighbor_source_boxes_starts)
    assert torch.equal(merged.neighbor_source_boxes_lists,
                       ref.neighbor_source_boxes_lists)


@pytest.mark.parametrize("args,kwargs,exc", [
    ((), dict(well_sep_is_n_away=0), TypeError),
    ((), dict(well_sep_is_n_away=1.0), TypeError),
    ((), dict(from_sep_smaller_crit="l3"), ValueError),
    ((1, 1, "static_l2"), {}, TypeError),
])
def test_traversal_builder_checks(args, kwargs, exc):
    """The port's and the reference's wrapper refuse alike."""
    for cls in (FMMTraversalBuilder, JaxFMMTraversalBuilder):
        with pytest.raises(exc):
            cls(*args, **kwargs)


def test_traversal_builder_positional_form():
    """``(well_sep_is_n_away, from_sep_smaller_crit)`` without an array
    context, as the reference reads it."""
    for cls in (FMMTraversalBuilder, JaxFMMTraversalBuilder):
        b = cls(1, "static_l2")
        assert (b.well_sep_is_n_away, b.from_sep_smaller_crit) == (
            1, "static_l2")


def test_traversal_builder_n_away_two_not_ported():
    tree = build_tree(_points(), max_particles_in_box=10, device="cpu")
    with pytest.raises(NotImplementedError):
        FMMTraversalBuilder(2)(tree)
