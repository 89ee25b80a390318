#!/usr/bin/env python3
"""Time the 3D and 2D Helmholtz FMM paths of ``chip_smoke.py`` stage by
stage on one NVIDIA GPU, for comparing two checkouts in one call.

Run from the root of a checkout (it imports that checkout's
``boxtree_torch`` and ``chip_smoke.py``)::

    python3 scripts/torch_helmholtz_stages.py --label change

Builds the paths of ``chip_smoke.py``'s ``run_helmholtz`` (1e6 uniform
points, k = 2, order 12) and ``run_helmholtz2d`` (1e6 clustered points, k =
3, order 16), both complex128 with ``rscale="auto"``, and prints one JSON
line per path: the median of 5 synchronised calls of ``drive_fmm``, of
its P2M (``form_multipoles``) and L2P (``eval_locals``) stages, and, in
2D, of the M2P (K17) and P2L (K18) wrappers at the path's inputs; with the
card's name and power limit.  It calls only entry points that every
checkout since the 2D Helmholtz port has, so a parent checkout runs it
too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())


def median_ms(fn, reps=5):
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def path_times(dim, device):
    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.fmm import drive_fmm
    from boxtree_torch.models import make_helmholtz_wrangler
    from boxtree_torch.traversal import build_traversal
    from chip_smoke import clustered_square_points, fmm_locals

    n = 1_000_000
    if dim == 3:
        rng = np.random.default_rng(17)
        pts = rng.random((3, n))
        q = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        k, order = 2.0, 12
    else:
        pts, q = clustered_square_points(n, 23)
        k, order = 3.0, 16
    pts = torch.as_tensor(pts, device=device)
    q = torch.as_tensor(q, device=device)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))
    w = make_helmholtz_wrangler(trav, k, order, rscale="auto", pairs=False)
    tq = w.reorder_sources(q)
    loc = fmm_locals(w, tq)
    drive_fmm(w, [q])
    out = {"dim": dim, "points": n, "k": k, "order": order,
           "nboxes": trav.tree.nboxes,
           "fmm_ms": median_ms(lambda: drive_fmm(w, [q])),
           "p2m_ms": median_ms(lambda: w.form_multipoles(None, None, [tq])),
           "l2p_ms": median_ms(lambda: w.eval_locals(None, None, loc))}
    if dim == 2:
        from boxtree_torch.ops import helmholtz2d
        tree = trav.tree
        mp = w.coarsen_multipoles(None, None, w.form_multipoles(
            None, None, [tq]))
        m2p = (w._targets, tree.box_target_starts,
               tree.box_target_counts_nonchild, *w._l3_csr, mp, w.centers,
               w.box_scale, w.k, w.order, w._nstart)
        p2l = (w._sources, tq, tree.box_source_starts,
               tree.box_source_counts_nonchild, *w._l4_csr, w.centers,
               w.box_scale, w.k, w.order, w._nstart)
        out["m2p_k17_ms"] = median_ms(
            lambda: helmholtz2d.m2p_helmholtz2d(*m2p))
        out["p2l_k18_ms"] = median_ms(
            lambda: helmholtz2d.p2l_helmholtz2d(
                *p2l, w.local_expansion_zeros()))
    return out


def main():
    import subprocess

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_helmholtz_stages: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    for dim in (3, 2):
        print(json.dumps({"label": args.label, "card": card,
                          **path_times(dim, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
