"""boxtree_torch.build_tree against boxtree_tpu.build_tree, field by field.

Each configuration is built once per module by both packages from the same
numpy points.  Integer fields and particle coordinates (a permutation of
the input) must be identical.  Box centres are ``bbox_min + (cell + 0.5) *
size`` in the coordinate dtype, the same operations in the same order;
XLA may contract the multiply-add into an FMA, so they may differ by one
rounding: they are held to 1 ulp.  ``root_extent`` must be identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import boxtree_tpu
from boxtree_torch import MaxLevelsExceeded, Tree, build_tree
from boxtree_torch.utils.bridge import to_numpy
from boxtree_tpu.utils.particles import make_surface_particle_array
from torch_threads import one_torch_thread  # noqa: F401


def _deep_points():
    """Random points in the unit cube (corners included, so the root box
    is known) plus one pair that shares its level-18 cell but not its
    level-19 cell: deeper than the shallow first try (18 levels at this
    n), so the build retries at the full depth 20."""
    rng = np.random.default_rng(3)
    pts = rng.random((3, 200))
    pts[:, 2], pts[:, 3] = 0.0, 1.0
    cell = (1.0 + 1e-4) / 2 ** 18
    x0 = ((1 << 17) + 5 + 0.3) * cell
    pts[:, 0] = (x0, 0.5, 0.5)
    pts[:, 1] = (x0 + 0.4 * cell, 0.5, 0.5)
    return pts


def _configs():
    rng = np.random.default_rng(17)
    return {
        "3d_surface_f64": dict(
            particles=make_surface_particle_array(3000, 3, np.float64, 11),
            max_particles_in_box=30),
        "3d_uniform_f32": dict(
            particles=rng.random((3, 4000), dtype=np.float32),
            max_particles_in_box=30),
        "2d_surface_f64": dict(
            particles=make_surface_particle_array(2000, 2, np.float64, 5),
            max_particles_in_box=20),
        "3d_targets_f64": dict(
            particles=make_surface_particle_array(1500, 3, np.float64, 1),
            targets=rng.random((3, 1000)), max_particles_in_box=25),
        "3d_deep_f64": dict(particles=_deep_points(),
                            max_particles_in_box=1),
        # the non-adaptive kind, refine weights (zeros among them) and a
        # given bbox (tests/test_tree.py:159-176)
        "1d_nonadaptive_f64": dict(
            particles=rng.random((1, 2000)), kind="non-adaptive",
            max_particles_in_box=30),
        "2d_nonadaptive_f64": dict(
            particles=make_surface_particle_array(3000, 2, np.float64, 7),
            kind="non-adaptive", max_particles_in_box=30),
        "3d_nonadaptive_f32": dict(
            particles=rng.random((3, 4000), dtype=np.float32),
            kind="non-adaptive", max_particles_in_box=30),
        "2d_weights_f64": dict(
            particles=make_surface_particle_array(3000, 2, np.float64, 9),
            refine_weights=rng.integers(0, 10, 3000).astype(np.int32),
            max_leaf_refine_weight=100),
        "3d_weights_f64": dict(
            particles=rng.standard_normal((3, 3000)),
            refine_weights=rng.integers(0, 10, 3000).astype(np.int32),
            max_leaf_refine_weight=120),
        "3d_nonadaptive_weights_f64": dict(
            particles=rng.random((3, 2500)), kind="non-adaptive",
            refine_weights=rng.integers(0, 10, 2500).astype(np.int32),
            max_leaf_refine_weight=150),
        "2d_nonadaptive_targets_f64": dict(
            particles=make_surface_particle_array(1500, 2, np.float64, 2),
            targets=rng.random((2, 1000)), kind="non-adaptive",
            max_particles_in_box=25),
        "3d_bbox_f32": dict(
            particles=rng.random((3, 3000), dtype=np.float32),
            bbox=np.array([[-0.25, 1.25]] * 3), max_particles_in_box=30),
        "2d_bbox_f64": dict(
            particles=rng.random((2, 3000)) * 0.5 + 0.2,
            bbox=np.array([[0.0, 2.0], [-0.5, 1.5]]),
            max_particles_in_box=20),
    }


CONFIGS = _configs()
FIELDS = [f.name for f in dataclasses.fields(Tree)]


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, kw in CONFIGS.items():
        ref = boxtree_tpu.build_tree(**kw)
        got = build_tree(torch.from_numpy(kw["particles"]),
                         **{k: (torch.from_numpy(v) if k == "targets" else v)
                            for k, v in kw.items() if k != "particles"})
        out[name] = (ref, to_numpy(got))
    return out


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tree_field(trees, config, field):
    ref_tree, got = trees[config]
    ref, val = getattr(ref_tree, field), got[field]
    if field.endswith("_dtype"):
        assert val == np.dtype(ref)
    elif field == "level_start_box_nrs":
        assert tuple(val) == tuple(ref)
    elif ref is None or isinstance(ref, (bool, int, float, str)):
        assert val == ref
    else:
        ref = np.asarray(ref)
        assert val.dtype == ref.dtype and val.shape == ref.shape
        if field == "box_centers":
            ulp = np.spacing(np.abs(ref).max())
            assert np.abs(val - ref).max() <= ulp
        else:
            np.testing.assert_array_equal(val, ref)


def test_retry_reached_full_depth(trees):
    ref_tree, got = trees["3d_deep_f64"]
    assert got["max_depth"] == ref_tree.max_depth == 20


def test_coincident_points_raise():
    pts = torch.zeros((3, 40), dtype=torch.float64)
    pts[:, 20:] = 1.0
    with pytest.raises(MaxLevelsExceeded):
        build_tree(pts, max_particles_in_box=10)


@pytest.mark.parametrize("kwargs", [
    # both refinement rules at once (boxtree_tpu/tree/build.py:652-656)
    dict(refine_weights=np.ones(100, np.int32), max_leaf_refine_weight=10,
         raises=ValueError),
    dict(kind="adaptive-level-restricted", source_radii=np.full(100, 0.01),
         targets=np.zeros((3, 5)), raises=NotImplementedError),
    dict(kind="non-adaptive", source_radii=np.full(100, 0.01),
         targets=np.zeros((3, 5)), raises=NotImplementedError),
    # int64 weights (:664-665)
    dict(max_particles_in_box=None, refine_weights=np.ones(100, np.int64),
         max_leaf_refine_weight=10, raises=TypeError),
    # a non-square and a mis-shaped bbox (:573-579)
    dict(bbox=np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 2.0]]),
         raises=ValueError),
])
def test_unported_options_raise(kwargs):
    """The options the reference refuses raise its exception types (the
    non-adaptive kind, refine weights and a given bbox are ported; extents
    with another kind are refused by both)."""
    kwargs = dict(kwargs)
    raises = kwargs.pop("raises")
    pts = np.random.default_rng(0).random((3, 100))
    with pytest.raises(raises):
        boxtree_tpu.build_tree(pts, **{"max_particles_in_box": 10,
                                       **kwargs})
    with pytest.raises(raises):
        build_tree(pts, **{"max_particles_in_box": 10, "device": "cpu",
                           **kwargs})


@pytest.mark.parametrize("kwargs", [
    dict(max_particles_in_box=None, refine_weights=[1] * 100,
         max_leaf_refine_weight=10),
    dict(max_particles_in_box=None, refine_weights=np.ones(99, np.int32),
         max_leaf_refine_weight=10),
    dict(max_particles_in_box=None, refine_weights=np.ones(100, np.int32)),
    dict(max_particles_in_box=None),
    dict(bbox=np.array([[0.0, 1.0]] * 2)),
])
def test_option_refusals_match_reference(kwargs):
    """Python-int weights (int64), one weight short, weights without their
    maximum, no refinement rule, a bbox of the wrong dimension: the port
    raises what the reference raises."""
    pts = np.random.default_rng(0).random((3, 100))
    with pytest.raises(Exception) as ref:
        boxtree_tpu.build_tree(pts, **{"max_particles_in_box": 10,
                                       **kwargs})
    with pytest.raises(ref.type):
        build_tree(pts, **{"max_particles_in_box": 10, "device": "cpu",
                           **kwargs})


# {{{ where the tree lives

def test_numpy_input_without_cuda_raises(monkeypatch):
    """A numpy input goes to the CUDA device unless the caller names one;
    without a CUDA device that raises and says how to build on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).random((3, 100))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_tree(pts, max_particles_in_box=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_tree(list(pts), max_particles_in_box=10)


@pytest.mark.parametrize("form", ["numpy, device='cpu'", "cpu tensor",
                                  "list of cpu tensors"])
def test_cpu_inputs_build_on_cpu(monkeypatch, form):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).random((3, 100))
    if form == "cpu tensor":
        tree = build_tree(torch.from_numpy(pts), max_particles_in_box=10)
    elif form == "list of cpu tensors":
        tree = build_tree(list(torch.from_numpy(pts)),
                          max_particles_in_box=10)
    else:
        tree = build_tree(pts, max_particles_in_box=10, device="cpu")
    assert tree.sources.device.type == "cpu"
    assert tree.box_centers.device.type == "cpu"
    ref = build_tree(torch.from_numpy(pts), max_particles_in_box=10)
    assert torch.equal(tree.user_source_ids, ref.user_source_ids)

# }}}
