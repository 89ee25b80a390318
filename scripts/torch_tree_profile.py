"""Where the time of boxtree_torch's tree build goes on the card.

One ``torch.profiler`` trace of ``build_tree`` on each of three paths of
``chip_smoke.py``, after one warm-up call: the main path (1e6 uniform
float32 points in the unit cube, seed 17, 30 a box), Config B (1e6 float64
points on the unit sphere, seed 15, level-restricted, 30 a box) and the 2D
double layer (1e6 sources on the starfish and 2e5 targets, seed 22, 20 a
box).  Prints one JSON line a path: the wall time of the traced call, the
device's busy time (the union of its intervals) and idle share, the
device time of the tree build's own kernels (K1, K5, K12, K13 and
K43-K46), of PyTorch's kernels (sorts, scans, gathers) and of copies, the
number of device-to-host copies (the host reads), the time the host spent
blocked in synchronising CUDA calls, and the kernels that took the most
time.  ``--package DIR`` imports ``boxtree_torch`` from the checkout at
DIR instead (a parent commit unpacked there), so that two versions are
traced in one call; ``--out DIR`` also writes each Chrome trace there.

Run from the root of a checkout, on a machine with a CUDA card::

    PYTHONPATH=. python3 scripts/torch_tree_profile.py --label change
    PYTHONPATH=. python3 scripts/torch_tree_profile.py --label parent \\
        --package build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: device kernels of the tree build written for this package
TREE_KERNEL_NAMES = (
    "morton_encode_kernel", "stick_levels_kernel", "box_extents_own_kernel",
    "box_extents_up_kernel", "restrict_marks_kernel",
    "restrict_apply_kernel", "leaf_walk_kernel", "extent_count_kernel",
    "level_max_kernel", "level_used_kernel", "fill_leaf_kernel",
    "level_boxes_kernel", "level_counts_kernel", "sweep_flag_kernel",
    "sweep_raise_kernel")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="change")
    parser.add_argument("--package", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import numpy as np
    import torch

    import chip_smoke
    from scripts.torch_traversal_profile import split, traced

    if args.package:
        # boxtree_torch from there; the inputs and the trace's split stay
        # this checkout's
        sys.path.insert(0, os.path.abspath(args.package))
    from boxtree_torch import build_tree

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    n = 1_000_000
    main_pts = torch.as_tensor(np.random.default_rng(17).random(
        (3, n), dtype=np.float32), device=device)
    sphere = torch.as_tensor(chip_smoke.sphere_points(n, 15), device=device)
    src, _, tgt, _ = (torch.as_tensor(a, device=device) for a in
                      chip_smoke.laplace2d_dipole_points(n, 200_000, 22))
    paths = {
        "main path": lambda: build_tree(main_pts, max_particles_in_box=30),
        "Config B": lambda: build_tree(
            sphere, kind="adaptive-level-restricted",
            max_particles_in_box=30),
        "2D double layer": lambda: build_tree(src, targets=tgt,
                                              max_particles_in_box=20),
    }
    for path, fn in paths.items():
        tree, prof, wall = traced(fn)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                args.out, f"tree_{args.label}_{path.replace(' ', '_')}.json"))
        print(json.dumps({"build": path, "label": args.label,
                          "package": os.path.dirname(os.path.dirname(
                              sys.modules["boxtree_torch"].__file__)),
                          "card": card, "nboxes": tree.nboxes,
                          "nlevels": tree.nlevels,
                          **split(prof, wall, TREE_KERNEL_NAMES, "tree")}),
              flush=True)


if __name__ == "__main__":
    main()
