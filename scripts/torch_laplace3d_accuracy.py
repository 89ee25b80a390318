"""Accuracy of boxtree_torch's 3D Laplace double-layer FMM at a given size.

The configuration of ``chip_smoke.py``'s ``laplace3d_fmm`` phase, scaled
down: sources on the unit sphere (normalised standard normals, seed 15)
with their outward normals as dipoles, standard-normal weights, uniform
targets in [-1, 1]^3, 30 particles a box, ``rscale="auto"``.  Prints, as
one JSON line, the rel l-inf of the real potentials against a float64
direct sum over every target: the complex wrangler at a fixed order, the
float64 pairs at the same order, and the pairs with ``level_to_order =
order - min(level, 4)`` (the form of ``tests/test_stability.py:124``).

Run from the root of a checkout, on the CPU or the card::

    python3 scripts/torch_laplace3d_accuracy.py --sources 30000 \\
        --targets 6000 --order 12 --device cpu
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


def points(nsources, ntargets, seed=15):
    x = np.random.default_rng(seed).standard_normal((3, nsources))
    src = x / np.sqrt((x * x).sum(0))
    rng = np.random.default_rng(seed + 1)
    return src, rng.random((3, ntargets)) * 2 - 1, \
        rng.standard_normal(nsources)


def direct_dipole(tgt, src, w, dip, chunk=1 << 12):
    """``sum_s w_s d_s . (t - s) / |t - s|^3`` in float64."""
    out = torch.zeros(tgt.shape[1], dtype=torch.float64, device=tgt.device)
    for c0 in range(0, src.shape[1], chunk):
        d = tgt[:, :, None] - src[:, None, c0:c0 + chunk]
        r2 = (d * d).sum(0)
        g = (dip[:, None, c0:c0 + chunk] * d).sum(0) * r2 ** -1.5
        out += g @ w[c0:c0 + chunk]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sources", type=int, default=30000)
    ap.add_argument("--targets", type=int, default=6000)
    ap.add_argument("--order", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    src_np, tgt_np, w_np = points(args.sources, args.targets)
    src, tgt, w = (torch.as_tensor(a, device=dev)
                   for a in (src_np, tgt_np, w_np))
    trav = build_traversal(build_tree(src, targets=tgt,
                                      max_particles_in_box=30))
    ref = direct_dipole(tgt, src, w, src)
    p = args.order
    runs = {"complex128": dict(order=p, pairs=False),
            "float64_pairs": dict(order=p, pairs=True),
            "float64_pairs_level_to_order": dict(
                level_to_order=lambda lev: p - min(lev, 4), pairs=True)}
    out = {"sources": args.sources, "targets": args.targets, "order": p,
           "nlevels": trav.tree.nlevels, "device": str(dev)}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        wr = make_laplace_wrangler(trav, dipole_vec=src, rscale="auto",
                                   **kw)
        pot = drive_fmm(wr, [w]).real
        out[name] = dict(
            rel_linf=((pot - ref).abs().max() / ref.abs().max()).item(),
            seconds=time.perf_counter() - t0)
        if wr.level_orders is not None:
            out[name]["level_orders"] = [int(x) for x in wr.level_orders]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
