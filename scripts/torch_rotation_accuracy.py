"""Accuracy of boxtree_torch's rotation M2L against its dense M2L.

The configuration of ``chip_smoke.py``'s main path, scaled down: uniform
float32 points in the unit cube (``rng.random``, one seed a run), standard
normal float32 charges, 30 points a box, order 8, ``rscale="auto"``.  For
each seed it prints one JSON line: the rel l-inf of the float32 pairs FMM
with ``m2l_mode="rotation"`` against the float32 pairs FMM with the dense
M2L on the same traversal (every target), and of each against a float64
direct sum at sampled targets.

Run from the root of a checkout, on the CPU or the card::

    python3 scripts/torch_rotation_accuracy.py --points 100000 \\
        --seeds 17 18 19 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import make_laplace_wrangler
from boxtree_torch.traversal import build_traversal


def direct_sum(pts, q, targets, chunk=4096):
    out = []
    for i in range(0, targets.shape[1], chunk):
        d = targets[:, i:i + chunk, None] - pts[:, None, :]
        r = np.sqrt((d * d).sum(0))
        out.append(np.where(r > 0, 1 / np.where(r > 0, r, 1), 0) @ q)
    return np.concatenate(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--order", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs="+", default=[17])
    ap.add_argument("--sample", type=int, default=2000)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        pts = rng.random((3, args.points), dtype=np.float32)
        q = rng.standard_normal(args.points).astype(np.float32)
        t0 = time.perf_counter()
        trav = build_traversal(build_tree(torch.as_tensor(pts, device=dev),
                                          max_particles_in_box=30))
        qt = torch.as_tensor(q, device=dev)
        pots = {}
        for mode in ("dense", "rotation"):
            w = make_laplace_wrangler(trav, args.order, pairs=True,
                                      rscale="auto", dtype=torch.float32,
                                      m2l_mode=mode)
            pots[mode] = drive_fmm(w, [qt]).double().cpu().numpy()
        sample = np.random.default_rng(5).choice(args.points, args.sample,
                                                 replace=False)
        ref = direct_sum(pts.astype(np.float64), q.astype(np.float64),
                         pts[:, sample].astype(np.float64))

        def rel(a, b):
            return float(np.abs(a - b).max() / np.abs(b).max())

        print(json.dumps({
            "seed": seed, "points": args.points, "order": args.order,
            "device": str(dev),
            "m2l_edges": int(trav.from_sep_siblings_lists.shape[0]),
            "rotation_vs_dense_f32": rel(pots["rotation"], pots["dense"]),
            "rotation_vs_f64_direct": rel(pots["rotation"][sample], ref),
            "dense_vs_f64_direct": rel(pots["dense"][sample], ref),
            "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
