"""The FMM cost model of boxtree_torch (``boxtree_torch.cost.model``)
against boxtree_tpu's, on the CPU.

Both of the port's flavours (``FMMCostModel`` on the traversal's device,
``PythonFMMCostModel`` on the host) against both of the reference's, on
one 2D and one 3D traversal: ``cost_per_box`` and ``cost_per_stage``
within 1e-12 relative (each box and each stage held to its own value),
with the PDE-aware and the Taylor translation models, per-level orders,
calibration parameters and an op-counting translation model; the
calibration fit against the reference's; and, on the port alone,
``tests/test_cost_model.py``'s exact operation counts.
"""

import functools

import numpy as np
import pytest
import torch

from boxtree_torch import build_tree
from boxtree_torch.cost.model import (
    FMM_STAGES,
    FMMCostModel,
    PythonFMMCostModel,
    make_pde_aware_translation_cost_model,
    make_taylor_translation_cost_model,
)
from boxtree_torch.traversal import build_traversal
from boxtree_tpu.cost import model as jax_model
from test_torch_helmholtz3d import _jax_traversal
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12


@functools.lru_cache(maxsize=None)
def _travs(dim):
    pts = np.random.default_rng(dim).standard_normal((dim, 3000))
    trav = build_traversal(build_tree(pts, max_particles_in_box=30,
                                      device="cpu"))
    return trav, _jax_traversal(trav)


@functools.lru_cache(maxsize=None)
def _jax_device_model(dim, factory_name, orders_name, calibrated):
    """The reference's device flavour, its per-box and per-stage costs
    (each new shape compiles once)."""
    trav, jtrav = _travs(dim)
    model = jax_model.FMMCostModel(JAX_FACTORIES[factory_name])
    orders, c = _orders(trav, orders_name), _params(calibrated)
    return (np.asarray(model.cost_per_box(jtrav, orders, c)),
            model.cost_per_stage(jtrav, orders, c))


class OpCountingTranslationCostModel:
    """A cost of 1 for every operation (the reference's oracle model,
    ``tests/test_cost_model.py:93-117``)."""

    def __init__(self, dim, nlevels):
        pass

    def with_orders(self, level_to_order):
        return self

    @staticmethod
    def p2l(level):
        return 1

    l2p = p2l
    p2m = p2l
    m2p = p2l

    @staticmethod
    def m2m(src_level, tgt_level):
        return 1

    l2l = m2m
    m2l = m2m


FACTORIES = {"pde": make_pde_aware_translation_cost_model,
             "taylor": make_taylor_translation_cost_model,
             "ops": OpCountingTranslationCostModel}
JAX_FACTORIES = {"pde": jax_model.make_pde_aware_translation_cost_model,
                 "taylor": jax_model.make_taylor_translation_cost_model,
                 "ops": OpCountingTranslationCostModel}


def _orders(trav, name):
    nlevels = trav.tree.nlevels
    if name == "const":
        return {lev: 3 for lev in range(nlevels)}
    return {lev: max(2, 8 - lev) for lev in range(nlevels)}


def _params(calibrated):
    if not calibrated:
        return None
    return {f"c_{s}": 0.5 + 0.25 * i for i, s in enumerate(
        ("p2m", "m2m", "p2p", "m2l", "m2p", "p2l", "l2l", "l2p"))}


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return bool((np.abs(got - ref) <= RTOL * np.abs(ref)).all())


CASES = [("pde", "const", False), ("pde", "by_level", True),
         ("taylor", "by_level", False), ("ops", "const", False)]


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
@pytest.mark.parametrize("port_model", [FMMCostModel, PythonFMMCostModel],
                         ids=["device", "python"])
@pytest.mark.parametrize("dim", [2, 3])
def test_against_reference(dim, port_model, case):
    """cost_per_box and cost_per_stage against the reference's Python
    flavour, and the device flavour also against the reference's device
    flavour on the first two cases (the others would repeat its
    compiles).  An op-counting model returns one number for all of a
    stage's translations, which the Python flavours' stage sums count
    once: their per-stage costs are held to each other only."""
    factory_name, orders_name, calibrated = case
    trav, jtrav = _travs(dim)
    orders, c = _orders(trav, orders_name), _params(calibrated)
    model = port_model(FACTORIES[factory_name])
    per_box = model.cost_per_box(trav, orders, c)
    per_stage = model.cost_per_stage(trav, orders, c)
    assert per_box.dtype == torch.float64
    assert set(per_stage) == set(FMM_STAGES)

    jpy = jax_model.PythonFMMCostModel(JAX_FACTORIES[factory_name])
    refs = [(jpy.cost_per_box(jtrav, orders, c),
             jpy.cost_per_stage(jtrav, orders, c))]
    if port_model is FMMCostModel and case in CASES[:2]:
        refs.append(_jax_device_model(dim, factory_name, orders_name,
                                      calibrated))
    same_sums = factory_name != "ops" or port_model is PythonFMMCostModel
    for ref_box, ref_stage in refs:
        assert _close(per_box.numpy(), ref_box)
        if same_sums:
            for k in FMM_STAGES:
                assert _close(per_stage[k], ref_stage[k]), k


@pytest.mark.parametrize("dim", [2, 3])
def test_aggregate_and_flavours(dim):
    trav, _ = _travs(dim)
    orders = _orders(trav, "by_level")
    dev, host = FMMCostModel(), PythonFMMCostModel()
    per_box = dev.cost_per_box(trav, orders)
    assert _close(per_box.numpy(), host.cost_per_box(trav, orders).numpy())
    total = sum(dev.cost_per_stage(trav, orders).values())
    assert abs(dev.aggregate_over_boxes(per_box) - total) <= RTOL * total
    assert abs(host.aggregate_over_boxes(per_box) - total) <= RTOL * total


def test_op_counts():
    """Unit calibration and order 0: every stage an exact operation count
    (``tests/test_cost_model.py:22-56``)."""
    trav, _ = _travs(2)
    tree = trav.tree
    model = FMMCostModel(
        lambda dim, nl: make_taylor_translation_cost_model(0, nl))
    orders = {lev: 0 for lev in range(tree.nlevels)}
    costs = model.cost_per_stage(trav, orders)
    tgt_cnt = tree.box_target_counts_nonchild.numpy()
    src_cnt = tree.box_source_counts_nonchild.numpy()
    assert costs["form_multipoles"] == tree.nsources
    assert costs["eval_locals"] == tree.ntargets
    starts = trav.neighbor_source_boxes_starts.numpy()
    lists = trav.neighbor_source_boxes_lists.numpy()
    expected = sum(int(tgt_cnt[b]) * int(src_cnt[lists[starts[i]:starts[
        i + 1]]].sum()) for i, b in enumerate(trav.target_boxes.numpy()))
    assert costs["eval_direct"] == expected
    assert costs["multipole_to_local"] == trav.from_sep_siblings_lists.shape[0]
    totp = trav.target_or_target_parent_boxes.numpy()
    assert costs["refine_locals"] == (tree.box_levels.numpy()[totp] > 0).sum()
    per_box = model.cost_per_box(trav, orders)
    assert float(per_box.sum()) == sum(costs.values())


def test_calibration_against_reference():
    trav, _ = _travs(2)
    orders = _orders(trav, "const")
    model = FMMCostModel()
    counts = model.cost_per_stage(trav, orders)
    timings = [{k: 2.5 * v for k, v in counts.items()}, {
        k: 3.0 * v for k, v in counts.items()}]
    params = model.estimate_calibration_params([counts, counts], timings)
    ref = jax_model.PythonFMMCostModel().estimate_calibration_params(
        [counts, counts], timings)
    assert params == ref
    for v in params.values():
        assert abs(v - 2.75) <= 1e-12 * 2.75
    calibrated = model.cost_per_stage(trav, orders, params)
    for k in counts:
        assert abs(calibrated[k] - 2.75 * counts[k]) <= RTOL * calibrated[k]


def test_translation_model_formulas():
    """The translation formulas on ints and on level tensors."""
    pde = make_pde_aware_translation_cost_model(3, 4).with_orders(
        {0: 1, 1: 2, 2: 3, 3: 4})
    ref = jax_model.make_pde_aware_translation_cost_model(3, 4).with_orders(
        {0: 1, 1: 2, 2: 3, 3: 4})
    lev = torch.tensor([0, 1, 2, 3])
    for name in ("p2m", "l2p", "m2p", "p2l"):
        assert np.array_equal(getattr(pde, name)(lev).numpy(),
                              getattr(ref, name)(lev.numpy()))
        assert getattr(pde, name)(2) == getattr(ref, name)(2)
    for name in ("m2m", "l2l", "m2l"):
        got = getattr(pde, name)(lev, lev.flip(0)).numpy()
        assert _close(got, getattr(ref, name)(lev.numpy(),
                                              lev.flip(0).numpy()))
    assert pde.p2p() == ref.p2p() and pde.p2qbxl() == ref.p2qbxl()
