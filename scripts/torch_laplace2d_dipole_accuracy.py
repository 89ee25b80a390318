"""Accuracy of boxtree_torch's 2D Laplace double-layer FMM at a given size.

The configuration of ``chip_smoke.py``'s ``laplace2d_dipole_fmm`` phase,
scaled down (its generator, ``chip_smoke.laplace2d_dipole_points``):
sources on the five-armed starfish ``r(theta) = 1 + 0.25 cos 5 theta`` at
uniform random angles with their unit outward normals as dipoles,
standard-normal weights, uniform targets in [-1.5, 1.5]^2, 20 particles a
box, order 20, ``rscale="auto"``.  Prints, as one JSON line, the rel
l-inf of the real potentials against a float64 direct sum of ``w d . (s -
t) / |t - s|^2`` over every target, for the complex128, float64 pairs and
float32 pairs wranglers, at each seed given.

Run from the root of a checkout, on the CPU or the card::

    PYTHONPATH=. python3 scripts/torch_laplace2d_dipole_accuracy.py \\
        --sources 30000 --targets 6000 --seeds 7 8 9 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from boxtree_torch import build_tree
from boxtree_torch.fmm import drive_fmm
from boxtree_torch.models import make_laplace_wrangler
from boxtree_torch.traversal import build_traversal
from chip_smoke import direct_sum_dipole2d, laplace2d_dipole_points

RUNS = {"complex128": dict(pairs=False),
        "float64_pairs": dict(pairs=True, dtype=torch.float64),
        "float32_pairs": dict(pairs=True, dtype=torch.float32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sources", type=int, default=30000)
    ap.add_argument("--targets", type=int, default=6000)
    ap.add_argument("--order", type=int, default=20)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    out = {"sources": args.sources, "targets": args.targets,
           "order": args.order, "device": str(dev), "seeds": {}}
    for seed in args.seeds:
        src, nrm, tgt, w = (torch.as_tensor(a, device=dev)
                            for a in laplace2d_dipole_points(
                                args.sources, args.targets, seed))
        trav = build_traversal(build_tree(src, targets=tgt,
                                          max_particles_in_box=20))
        ref = direct_sum_dipole2d(src, nrm, w, tgt)
        res = out["seeds"][seed] = {"nlevels": trav.tree.nlevels}
        for name, kw in RUNS.items():
            t0 = time.perf_counter()
            wr = make_laplace_wrangler(trav, args.order, rscale="auto",
                                       dipole_vec=nrm, **kw)
            pot = drive_fmm(wr, [w]).real.to(torch.float64)
            res[name] = dict(
                rel_linf=((pot - ref).abs().max() / ref.abs().max()).item(),
                seconds=time.perf_counter() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
