"""Where the time of boxtree_torch's FMMs goes on the card.

One ``torch.profiler`` trace of ``drive_fmm`` on each of six paths of
``chip_smoke.py``, after one warm-up call each:

- the main path: 1e6 uniform float32 points in the unit cube (seed 17),
  30 a box, the real-pair wrangler at order 8 with ``rscale="auto"``;
- the double layer: 1e6 sources on the unit sphere (seed 15) with their
  outward normals as dipoles and real weights, 2e5 targets in [-1, 1]^3,
  the complex128 wrangler at order 12 with ``rscale="auto"``;
- the 3D Helmholtz path: 1e6 uniform points (seed 17), complex charges,
  k = 2, order 12, complex128, ``rscale="auto"``;
- the 2D Helmholtz path: 1e6 points of the unit square, 4/15 of them in
  [0.4, 0.5]^2 (seed 23), k = 3, order 16, ``rscale="auto"``;
- the 2D Laplace path: 1e6 points of the unit square, 24 % of them in
  [0.45, 0.55]^2 (seed 20), real charges, the complex128 wrangler at order
  20 with ``rscale="auto"``, 20 a box;
- the 2D double layer: 1e6 sources on the five-armed starfish (seed 22)
  with their normals as dipoles and real weights, 2e5 targets in [-1.5,
  1.5]^2, the complex128 wrangler at order 20, ``rscale="auto"``, 20 a
  box;

and one more of the double layer's dipole P2M through its plain twin, the
``torch.func.jvp`` of the single-layer P2M that the path ran before K29.
Each FMM stage runs inside a ``record_function`` range, and every device
kernel or copy is charged to the stage whose host range holds the CUDA
runtime call that launched it.

Prints one JSON line per trace: the wall time of the traced call, the
device's busy time (the union of its kernel and copy intervals) and idle
share (one less busy over wall), the device time by stage and by kernel
(the largest), the time the host spent blocked in synchronising CUDA calls
and the number of device-to-host copies (the host reads), and the number
of device events.  The Chrome traces go to ``--out`` (``build/fmm_traces``
by default), and the numbers are read from them.

Run from the root of a checkout, on a machine with a CUDA card::

    PYTHONPATH=. python3 scripts/torch_fmm_profile.py --out build/fmm_traces

``--only helmholtz3d_fmm,helmholtz2d_fmm`` takes those traces alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.fmm.drive import FMM_STAGES
from boxtree_torch.models import (
    make_helmholtz_wrangler,
    make_laplace_wrangler,
)
from boxtree_torch.ops import laplace3d
from boxtree_torch.traversal import build_traversal

#: CUDA runtime calls in which the host waits for the device
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaMemcpy", "cudaMemcpyAsync")
#: prefix of the stage ranges
STAGE = "fmm_stage:"


class _StagedWrangler:
    """Forwards to a wrangler, each FMM stage inside a profiler range (no
    synchronisation, unlike ``drive_fmm``'s ``timing_data``)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in FMM_STAGES:
            return attr

        def staged(*args, **kwargs):
            with record_function(STAGE + name):
                return attr(*args, **kwargs)
        return staged


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def traced(fn, path):
    """Wall seconds of one traced, synchronised call after one warm-up
    call; the Chrome trace goes to *path*."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return wall


def _stage_at(ranges, t):
    """The stage whose host range holds time *t*."""
    for start, end, name in ranges:
        if start <= t <= end:
            return name
    return "outside the stages"


def split(trace, wall):
    """The numbers of one Chrome trace (see the module's docstring).  Each
    device event is charged to the stage whose host range holds its
    launch, the CUDA runtime call with the same correlation id (the
    package's kernels are launched through ctypes, with no PyTorch op
    around them); ``device_span_ms_by_stage`` is each stage's span on the
    device, from the profiler's device-side ranges."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat", "").startswith("cuda_")
                 and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"][len(STAGE):])
              for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(STAGE)]
    copies, dtoh, by_name, by_stage = 0.0, 0, {}, {}
    for e in dev:
        t = launch_at.get(e.get("args", {}).get("correlation"))
        stage = "unlinked" if t is None else _stage_at(ranges, t)
        by_stage[stage] = by_stage.get(stage, 0.0) + e["dur"]
        if e["cat"] != "kernel":
            copies += e["dur"]
            dtoh += "DtoH" in e["name"]
            continue
        n, t = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, t + e["dur"])
    spans = {e["name"][len(STAGE):]: e["dur"] / 1e3 for e in events
             if e.get("cat") == "gpu_user_annotation"
             and e["name"].startswith(STAGE)}
    blocked = sum(e["dur"] for e in events
                  if e.get("cat") == "cuda_runtime"
                  and e["name"] in BLOCKING_CALLS)
    busy = union_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": wall * 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / 1e3 / (wall * 1e3),
            "kernels_ms": sum(t for _, t in by_name.values()) / 1e3,
            "copies_ms": copies / 1e3,
            "device_ms_by_stage": {k: v / 1e3 for k, v in sorted(
                by_stage.items(), key=lambda kv: -kv[1])},
            "device_span_ms_by_stage": spans,
            "device_to_host_copies": dtoh,
            "host_blocked_ms": blocked / 1e3,
            "device_events": len(dev),
            "top_kernels": [{"name": k[:120], "calls": n, "ms": t / 1e3}
                            for k, (n, t) in top]}


def sphere_points(n, seed):
    """*n* points on the unit sphere: normalised standard normals (the
    generator of ``chip_smoke.py``'s Config B and double layer)."""
    x = np.random.default_rng(seed).standard_normal((3, n))
    return x / np.sqrt((x * x).sum(0))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--points", type=int, default=1_000_000)
    parser.add_argument("--sources", type=int, default=1_000_000)
    parser.add_argument("--targets", type=int, default=200_000)
    parser.add_argument("--out", default="build/fmm_traces",
                        help="directory of the Chrome traces")
    parser.add_argument("--only", default="",
                        help="comma-separated traces to take (default: "
                        "all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def main_path():
        rng = np.random.default_rng(17)
        pts = torch.as_tensor(rng.random((3, args.points), dtype=np.float32),
                              device=device)
        q = torch.as_tensor(
            rng.standard_normal(args.points).astype(np.float32),
            device=device)
        trav = build_traversal(build_tree(pts, max_particles_in_box=30))
        w = make_laplace_wrangler(trav, order=8, pairs=True, rscale="auto",
                                  dtype=torch.float32)
        return (dict(points=args.points, order=8, dtype="float32",
                     nboxes=trav.tree.nboxes),
                lambda: drive_fmm(_StagedWrangler(w), [q]))

    def double_layer(jvp_twin):
        src = torch.as_tensor(sphere_points(args.sources, 15), device=device)
        rng = np.random.default_rng(16)
        tgt = torch.as_tensor(rng.random((3, args.targets)) * 2 - 1,
                              device=device)
        w_dl = torch.as_tensor(rng.standard_normal(args.sources),
                               device=device)
        trav = build_traversal(build_tree(src, targets=tgt,
                                          max_particles_in_box=30))
        w = make_laplace_wrangler(trav, order=12, pairs=False,
                                  rscale="auto", dipole_vec=src)
        tree = trav.tree
        if not jvp_twin:
            return (dict(sources=args.sources, targets=args.targets,
                         order=12, dtype="complex128", nboxes=tree.nboxes),
                    lambda: drive_fmm(_StagedWrangler(w), [w_dl]))
        jvp_args = (w._sources, w.reorder_sources(w_dl), w.dipole_vec,
                    tree.box_source_starts, tree.box_source_counts_nonchild,
                    w._source_rows, w.centers, w.box_scale, w.order)
        return (dict(sources=args.sources, order=12, dtype="complex128"),
                lambda: laplace3d.p2m_laplace3d_dipole_plain(*jvp_args))

    def helmholtz(dim):
        # chip_smoke.py's run_helmholtz / run_helmholtz2d paths
        if dim == 3:
            rng = np.random.default_rng(17)
            pts = rng.random((3, args.points))
            q = rng.standard_normal(args.points) \
                + 1j * rng.standard_normal(args.points)
            k, order = 2.0, 12
        else:
            from chip_smoke import clustered_square_points
            pts, q = clustered_square_points(args.points, 23)
            k, order = 3.0, 16
        pts = torch.as_tensor(pts, device=device)
        q = torch.as_tensor(q, device=device)
        trav = build_traversal(build_tree(pts, max_particles_in_box=30))
        w = make_helmholtz_wrangler(trav, k, order, rscale="auto",
                                    pairs=False)
        return (dict(points=args.points, k=k, order=order,
                     dtype="complex128", nboxes=trav.tree.nboxes),
                lambda: drive_fmm(_StagedWrangler(w), [q]))

    def laplace2d(dipoles):
        # chip_smoke.py's run_laplace2d / run_laplace2d_dipole paths
        import chip_smoke
        if dipoles:
            src, nrm, tgt, q = chip_smoke.laplace2d_dipole_points(
                args.sources, args.targets, 22)
            kw = dict(dipole_vec=torch.as_tensor(nrm, device=device))
            about = dict(sources=args.sources, targets=args.targets)
        else:
            src, q = chip_smoke.laplace2d_points(args.points, 20)
            tgt, kw, about = None, {}, dict(points=args.points)
        tree = build_tree(
            torch.as_tensor(src, device=device),
            targets=None if tgt is None else torch.as_tensor(tgt,
                                                             device=device),
            max_particles_in_box=20)
        trav = build_traversal(tree)
        w = make_laplace_wrangler(trav, 20, pairs=False, rscale="auto", **kw)
        q = torch.as_tensor(q, device=device)
        return (dict(**about, order=20, dtype="complex128",
                     nboxes=tree.nboxes),
                lambda: drive_fmm(_StagedWrangler(w), [q]))

    builders = {
        "main_path_fmm": main_path,
        "double_layer_fmm": lambda: double_layer(False),
        "double_layer_p2m_jvp_twin": lambda: double_layer(True),
        "helmholtz3d_fmm": lambda: helmholtz(3),
        "helmholtz2d_fmm": lambda: helmholtz(2),
        "laplace2d_fmm": lambda: laplace2d(False),
        "laplace2d_dipole_fmm": lambda: laplace2d(True),
    }
    only = args.only.split(",") if args.only else list(builders)
    runs = {label: builders[label]() for label in only}
    os.makedirs(args.out, exist_ok=True)
    for label, (about, fn) in runs.items():
        path = os.path.join(args.out, f"{label}.json")
        wall = traced(fn, path)
        with open(path) as f:
            numbers = split(json.load(f), wall)
        print(json.dumps({"trace": label, "card": card, **about,
                          **numbers}), flush=True)


if __name__ == "__main__":
    main()
