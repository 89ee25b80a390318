#!/usr/bin/env python3
"""Smoke run of boxtree_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``boxtree_torch/csrc``, holds each kernel
against its plain PyTorch twin on the card, runs the counting FMM and the
3D Laplace FMM (order 8, real pairs, ``rscale="auto"``, float32) at 1e6
uniform points -- the main path of ``bench.py`` -- and checks the result
against an exact count and a float64 direct sum.  Each phase prints one
JSON line; then come the card's name and power limit as ``nvidia-smi``
reports them, the per-kernel summary and, last, the ``{"ok": true, ...}``
line.  Any failed phase raises, and the script exits non-zero.  Without a
CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

REPLACES = {
    "morton_encode": "boxtree_tpu/ops/morton.py:123",
    "p2p_laplace3d": "boxtree_tpu/models/expansion_base.py:1258",
    "m2p_laplace3d": "boxtree_tpu/models/expansion_base.py:1440",
    "p2l_laplace3d": "boxtree_tpu/models/expansion_base.py:1629",
}
SOURCES = {
    "morton_encode": "boxtree_torch/csrc/morton.cu",
    "p2p_laplace3d": "boxtree_torch/csrc/p2p.cu",
    "m2p_laplace3d": "boxtree_torch/csrc/m2p.cu",
    "p2l_laplace3d": "boxtree_torch/csrc/p2l.cu",
}
#: rel l-inf tolerance of K2-K4 against their twins: float32 sums in
#: another order, with rsqrt/FMA rounding (a few ulp each)
KERNEL_RTOL = 1e-5
#: rel l-inf bound of the order-8 float32 FMM against the float64 direct
#: sum: truncation is 3e-5 to 6e-5, a TF32/bf16 slip shows as ~7e-3
FMM_RTOL = 1e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def median_ms(fn, device, reps=5):
    times = []
    for _ in range(reps):
        _, dt = timed(fn, device)
        times.append(dt * 1e3)
    return sorted(times)[len(times) // 2]


def rel_linf(got, ref):
    import torch
    ref = ref.to(torch.float64)
    err = (got.to(torch.float64) - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-300)


# {{{ the kernels against their twins

def kernel_inputs(tree, trav, wrangler, q_tree):
    """Each kernel's wrapper, plain twin and arguments at the shapes the
    FMM gives them."""
    import torch

    from boxtree_torch import config
    from boxtree_torch.ops import laplace3d, morton

    coords = tree.sources
    n = coords.shape[1]
    iota_bits = max(1, int(n - 1).bit_length())
    depth = max(min(config.max_morton_depth(3), (63 - iota_bits) // 3), 1)
    lo = torch.amin(coords, dim=1)
    extent = (torch.max(torch.amax(coords, dim=1) - lo)
              * (1 + config.ROOT_EXTENT_STRETCH_FACTOR))
    w = wrangler
    mpoles = w.coarsen_multipoles(None, None, w.form_multipoles(
        None, None, [q_tree]))
    l3_rows, l3_starts, l3_lists = w._l3_csr
    l4_rows, l4_starts, l4_lists = w._l4_csr
    return {
        "morton_encode": (
            morton.encode_points, morton.encode_points_plain,
            (coords, lo, extent, depth, iota_bits)),
        "p2p_laplace3d": (
            laplace3d.p2p_laplace3d, laplace3d.p2p_laplace3d_plain,
            (w._targets, w._sources, q_tree, tree.box_target_starts,
             tree.box_target_counts_nonchild, tree.box_source_starts,
             tree.box_source_counts_nonchild, trav.target_boxes,
             trav.neighbor_source_boxes_starts,
             trav.neighbor_source_boxes_lists)),
        "m2p_laplace3d": (
            laplace3d.m2p_laplace3d, laplace3d.m2p_laplace3d_plain,
            (w._targets, tree.box_target_starts,
             tree.box_target_counts_nonchild, l3_rows, l3_starts, l3_lists,
             mpoles, w.centers, w.box_scale, w.order)),
        "p2l_laplace3d": (
            lambda *a: laplace3d.p2l_laplace3d(
                *a, w.local_expansion_zeros()),
            lambda *a: laplace3d.p2l_laplace3d_plain(
                *a, w.local_expansion_zeros()),
            (w._sources, q_tree, tree.box_source_starts,
             tree.box_source_counts_nonchild, l4_rows, l4_starts, l4_lists,
             w.centers, w.box_scale, w.order)),
    }


def check_kernels(inputs, device):
    """Run every kernel and its twin on the same inputs; raise on a
    mismatch.  Returns ``{name: {max_abs_err, rel_err, ms, plain_ms}}``."""
    import torch

    results = {}
    for name, (kernel, plain, args) in inputs.items():
        got, _ = timed(lambda: kernel(*args), device)
        ref, _ = timed(lambda: plain(*args), device)
        if name == "morton_encode":
            exact = torch.equal(got, ref)
            err = rel = float((got != ref).sum().item())
            if not exact:
                raise AssertionError(f"{name}: {int(err)} keys differ")
        else:
            err, rel = rel_linf(got, ref)
            if not rel <= KERNEL_RTOL:
                raise AssertionError(
                    f"{name}: rel l-inf {rel:.3e} > {KERNEL_RTOL}")
        ms = median_ms(lambda: kernel(*args), device)
        plain_ms = median_ms(lambda: plain(*args), device)
        results[name] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                             plain_ms=plain_ms)
    return results

# }}}


def direct_sum_f64(sources, charges, targets, chunk=1 << 16):
    """sum_s q_s / |t - s| over all sources, r = 0 skipped, in float64."""
    import torch
    src = sources.to(torch.float64)
    q = charges.to(torch.float64)
    tgt = targets.to(torch.float64)
    out = torch.zeros(tgt.shape[1], dtype=torch.float64, device=tgt.device)
    for c0 in range(0, src.shape[1], chunk):
        d = tgt[:, :, None] - src[:, None, c0:c0 + chunk]
        r2 = (d * d).sum(0)
        g = torch.where(r2 > 0, torch.rsqrt(torch.where(r2 > 0, r2, 1.0)),
                        0.0)
        out += g @ q[c0:c0 + chunk]
    return out


def run(device, n_kernels=200_000, n_main=1_000_000, order=8, nsample=2000):
    """All phases on *device*; returns the final per-kernel summary."""
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import (
        ConstantOneExpansionWrangler,
        make_laplace_wrangler,
    )
    from boxtree_torch.ops import kernels
    from boxtree_torch.traversal import build_traversal

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line() if device.type == "cuda" else "cpu"

    # {{{ build

    if device.type == "cuda":
        t0 = time.perf_counter()
        lib = kernels.build()
        emit({"phase": "build", "card": card,
              "seconds": time.perf_counter() - t0,
              "nvcc_seconds": lib.build_seconds,
              "library": str(lib.path.relative_to(lib.path.parents[3])),
              "ptxas": _ptxas_summary(lib.build_log)})

    # }}}

    # {{{ kernels vs twins on a surface tree (Lists 3 and 4 populated)

    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, n_kernels))
    pts = torch.as_tensor((x / np.sqrt((x * x).sum(0))).astype(np.float32),
                          device=device)
    q = torch.as_tensor(rng.standard_normal(n_kernels).astype(np.float32),
                        device=device)
    tree = build_tree(pts, max_particles_in_box=30)
    trav = build_traversal(tree)
    wr = make_laplace_wrangler(trav, order=order, pairs=True,
                               rscale="auto", dtype=torch.float32)
    res = check_kernels(kernel_inputs(tree, trav, wr, wr.reorder_sources(q)),
                        device)
    emit({"phase": "kernels", "card": card, "points": n_kernels,
          "distribution": "sphere surface", "order": order,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "tolerance": {"morton_encode": "bit-exact",
                        "others_rel_linf": KERNEL_RTOL},
          "kernels": res})
    del tree, trav, wr

    # }}}

    # {{{ counting FMM at the main-path size (bench.py:106-107)

    rng = np.random.default_rng(17)
    pts_np = rng.random((3, n_main), dtype=np.float32)
    q_np = rng.standard_normal(n_main).astype(np.float32)
    pts = torch.as_tensor(pts_np, device=device)
    q = torch.as_tensor(q_np, device=device)

    tree, t_tree = timed(lambda: build_tree(pts, max_particles_in_box=30),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    w1 = ConstantOneExpansionWrangler(None, trav)
    pot, t_fmm = timed(lambda: drive_fmm(
        w1, [torch.ones(n_main, dtype=torch.float64, device=device)]),
        device)
    nbad = int((pot != n_main).sum())
    emit({"phase": "counting_fmm", "card": card, "points": n_main,
          "nboxes": tree.nboxes, "nlevels": tree.nlevels,
          "build_s": t_tree, "traversal_s": t_trav, "fmm_s": t_fmm,
          "exact": nbad == 0})
    if nbad:
        raise AssertionError(f"counting FMM: {nbad} potentials != {n_main}")
    del tree, trav, w1, pot

    # }}}

    # {{{ the main path: Laplace FMM at 1e6, every kernel counted

    kernels.reset_launch_counts()
    sync(device)
    t_start = time.perf_counter()
    tree, t_tree = timed(lambda: build_tree(pts, max_particles_in_box=30),
                         device)
    trav, t_trav = timed(lambda: build_traversal(tree), device)
    wr, t_setup = timed(lambda: make_laplace_wrangler(
        trav, order=order, pairs=True, rscale="auto", dtype=torch.float32),
        device)
    pot, t_fmm = timed(lambda: drive_fmm(wr, [q]), device)
    t_total = time.perf_counter() - t_start
    launches = kernels.launch_counts()

    stages = {}
    _, t_fmm_warm = timed(lambda: drive_fmm(wr, [q], timing_data=stages),
                          device)

    sample = torch.as_tensor(np.random.default_rng(5).choice(
        n_main, nsample, replace=False), device=device)
    ref = direct_sum_f64(pts, q, pts[:, sample])
    abs_err, rel = rel_linf(pot[sample], ref)
    finite = bool(torch.isfinite(pot).all())
    emit({"phase": "laplace_fmm", "card": card, "points": n_main,
          "order": order, "dtype": "float32", "nboxes": tree.nboxes,
          "nlevels": tree.nlevels, "build_s": t_tree,
          "traversal_s": t_trav, "wrangler_setup_s": t_setup,
          "fmm_s": t_fmm, "fmm_warm_s": t_fmm_warm, "total_s": t_total,
          "stage_s": stages,
          "list_edges": {
              "l1": int(trav.neighbor_source_boxes_lists.shape[0]),
              "l2": int(trav.from_sep_siblings_lists.shape[0]),
              "l3": sum(bl.count for bl in trav.from_sep_smaller_by_level),
              "l4": int(trav.from_sep_bigger_lists.shape[0])},
          "sampled_targets": nsample, "rel_linf_vs_f64_direct": rel,
          "abs_linf": abs_err, "finite": finite,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)})
    if not finite or tuple(pot.shape) != (n_main,):
        raise AssertionError("Laplace FMM: non-finite or misshapen output")
    if not rel <= FMM_RTOL:
        raise AssertionError(f"Laplace FMM: rel l-inf {rel:.3e} > "
                             f"{FMM_RTOL}")

    emit({"phase": "launches", "card": card, "launches": launches})
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    # }}}

    # the kernels against their twins at the main path's own shapes
    res = check_kernels(kernel_inputs(tree, trav, wr, wr.reorder_sources(q)),
                        device)
    emit({"phase": "kernels_main_path", "card": card, "points": n_main,
          "kernels": res})
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, r in res.items()]}
    return card, summary


def _ptxas_summary(log):
    """Registers / spills per kernel from ``nvcc -Xptxas -v``."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and "Used" in line and "registers" in line:
            out[entry] = line.split(":", 1)[-1].strip()
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    card, summary = run(device)
    print(card, flush=True)
    emit(summary)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
