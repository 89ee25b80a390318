"""Where the time of boxtree_torch's traversal goes on the card.

One ``torch.profiler`` trace of ``build_traversal`` on the tree of
``chip_smoke.py``'s main path (uniform float32 points in the unit cube,
seed 17, 30 a box), first with the K24-K27 kernels and then with their
plain twins on the card (``_plain=True``, the traversal before the
kernels), each after one warm-up call; the two traversals must be equal,
field by field.  Prints one JSON line for each: the wall time of the
traced call, the device time of the traversal kernels (K24-K27, and K14 /
K15 where the targets have extents), of the other kernels (PyTorch's own:
sorts, scans, gathers) and of memory copies and sets, the time the host
spent blocked in synchronising CUDA calls (the host reads), the number of
device-to-host copies, the device's idle share (one less the union of the
device intervals over the wall time) and the device kernels that took the
most time.  ``--out DIR`` also writes each Chrome trace there.

Run from the root of a checkout, on a machine with a CUDA card::

    PYTHONPATH=. python3 scripts/torch_traversal_profile.py \\
        --points 1000000 --out build/traversal_traces
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

#: device kernels of the traversal written for this package
KERNEL_NAMES = ("neighbor_table_kernel", "row_lists_sl_l2_kernel",
                "lists_43_kernel", "list1_kernel", "list4_ext_kernel",
                "list3_ext_kernel")
#: CUDA runtime calls in which the host waits for the device
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaMemcpy", "cudaMemcpyAsync")


def same_traversal(a, b):
    """Every tensor of two traversals equal, BuiltLists included."""
    for f in dataclasses.fields(a):
        if f.name == "tree":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "from_sep_smaller_by_level":
            for p, q in zip(x, y, strict=True):
                if p.count != q.count or not all(
                        torch.equal(getattr(p, k), getattr(q, k))
                        for k in ("starts", "lists", "nonempty_indices")):
                    return False
        elif f.name == "target_boxes_sep_smaller_by_source_level":
            if not all(torch.equal(p, q) for p, q in zip(x, y, strict=True)):
                return False
        elif isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def traced(fn):
    """``(result, profiler, wall_s)`` of one traced, synchronised call
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, prof, wall


def split(prof, wall, names=KERNEL_NAMES, label="traversal"):
    """The numbers of one trace (see the module's docstring); the device
    time of the kernels *names* goes under ``<label>_kernels_ms``."""
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours, other, copies, by_name = 0.0, 0.0, 0.0, {}
    dtoh = 0
    for e in dev:
        dur = e.time_range.end - e.time_range.start
        name = e.name
        if name.startswith(("Memcpy", "Memset")):
            copies += dur
            dtoh += "DtoH" in name
            continue
        if any(k in name for k in names):
            ours += dur
            name = next(k for k in names if k in name)
        else:
            other += dur
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + dur)
    blocked = sum(e.time_range.end - e.time_range.start
                  for e in prof.events()
                  if e.device_type == DeviceType.CPU
                  and e.name in BLOCKING_CALLS)
    busy = union_us([(e.time_range.start, e.time_range.end) for e in dev])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall * 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / 1e3 / (wall * 1e3),
            f"{label}_kernels_ms": ours / 1e3,
            "other_kernels_ms": other / 1e3,
            "copies_ms": copies / 1e3,
            "device_to_host_copies": dtoh,
            "host_blocked_ms": blocked / 1e3,
            "device_events": len(dev),
            "top_kernels": [{"name": k[:120], "calls": n, "ms": t / 1e3}
                            for k, (n, t) in top]}


def main():
    from boxtree_torch import build_tree
    from boxtree_torch.traversal import build_traversal

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--points", type=int, default=1_000_000)
    parser.add_argument("--seed", type=int, default=17)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    pts = torch.as_tensor(np.random.default_rng(args.seed).random(
        (3, args.points), dtype=np.float32), device=device)
    tree = build_tree(pts, max_particles_in_box=30)
    results = {}
    for label, plain in (("kernels", False), ("plain", True)):
        trav, prof, wall = traced(
            lambda plain=plain: build_traversal(tree, _plain=plain))
        results[label] = trav
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.out, f"traversal_{label}.json"))
        print(json.dumps({"traversal": label, "card": card,
                          "points": args.points, "nboxes": tree.nboxes,
                          "nlevels": tree.nlevels,
                          **split(prof, wall)}), flush=True)
    if not same_traversal(results["kernels"], results["plain"]):
        raise SystemExit("the kernels' traversal != the twins'")
    print(json.dumps({"equal": True}))


if __name__ == "__main__":
    main()
