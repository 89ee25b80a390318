"""Times the translation kernels K35-K37 (M2L, M2M, L2L) of boxtree_torch
on the card at the shapes of ``chip_smoke.py``'s paths, beside their twins'
agreement and the library yardstick of M2L (the reference's gathered block
form on cuBLAS, ``chip_smoke.m2l_library``).

Paths (``--only`` picks some, comma-separated):

- ``main``: 1e6 uniform float32 points (seed 17), 30 a box, the real-pair
  wrangler at order 8 with ``rscale="auto"``;
- ``double_layer``: 1e6 sources on the unit sphere (seed 15) with their
  normals as dipoles, 2e5 targets in [-1, 1]^3, order 12, complex128 and
  float64 pairs;
- ``helmholtz3d``: 1e6 uniform points (seed 17), k = 2, order 12,
  complex128.

Prints one JSON line per (path, entry point): each kernel's median of 5
synchronised calls of its stage, the M2L library's median of 5, and each
kernel's rel l-inf against its twin per coefficient column.  Run from the
root of a checkout, on a machine with a CUDA card::

    PYTHONPATH=. python3 scripts/torch_translate_bench.py
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import chip_smoke as cs
from boxtree_torch import build_tree
from boxtree_torch.models import make_helmholtz_wrangler, make_laplace_wrangler
from boxtree_torch.ops import translate
from boxtree_torch.traversal import build_traversal


def bench(label, key, w, q, device, card):
    trav, plan = w.traversal, w._m2l_plan
    q_tree = w.reorder_sources(q)
    mp = w.form_multipoles(None, None, [q_tree])
    mp_up = w.coarsen_multipoles(None, None, mp)
    loc = w.form_locals(None, trav.target_or_target_parent_boxes,
                        trav.from_sep_bigger_starts,
                        trav.from_sep_bigger_lists, [q_tree],
                        translate.m2l_translate(mp_up, plan))
    out = {"path": label, "entry_point": key, "card": card,
           "nlevels": w.tree.nlevels, "ncoeff": w.ncoeff}
    fns = {"m2l_translate": (lambda: translate.m2l_translate(mp_up, plan),
                             lambda: translate.m2l_translate_plain(mp_up,
                                                                   plan)),
           "m2m_translate": (lambda: w.coarsen_multipoles(None, None, mp),
                             lambda: cs.m2m_twin_stage(w, mp)),
           "l2l_translate": (lambda: w.refine_locals(None, None, loc),
                             lambda: cs.l2l_twin_stage(w, loc))}
    work = cs.translation_work(w)
    for name, (kern, twin) in fns.items():
        _, rel = cs.translation_rel(kern(), twin())
        ms = cs.median_ms(kern, device)
        bound_ms = cs.translation_bound(work[name])[0]
        out[name] = {"ms": ms, "rel_vs_twin": rel, "bound_ms": bound_ms}
    lib_plan = cs.m2l_library_plan(w)
    out["m2l_library_ms"] = cs.median_ms(
        lambda: cs.m2l_library(mp_up, lib_plan), device)
    del lib_plan
    print(json.dumps(out), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", default="main,double_layer,helmholtz3d")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = cs.card_line()
    only = set(args.only.split(","))
    if "main" in only:
        rng = np.random.default_rng(17)
        pts = torch.as_tensor(rng.random((3, 1_000_000), dtype=np.float32),
                              device=device)
        q = torch.as_tensor(rng.standard_normal(1_000_000)
                            .astype(np.float32), device=device)
        trav = build_traversal(build_tree(pts, max_particles_in_box=30))
        w = make_laplace_wrangler(trav, order=8, pairs=True, rscale="auto",
                                  dtype=torch.float32)
        bench("main path", "f32", w, q, device, card)
        del trav, w
    if "double_layer" in only:
        src_np, tgt_np, w_np = cs.laplace3d_points(1_000_000, 200_000, 15)
        src = torch.as_tensor(src_np, device=device)
        trav = build_traversal(build_tree(
            src, targets=torch.as_tensor(tgt_np, device=device),
            max_particles_in_box=30))
        q = torch.as_tensor(w_np, device=device)
        for key, kw in (("c128", dict(pairs=False)),
                        ("f64", dict(pairs=True))):
            w = make_laplace_wrangler(trav, 12, rscale="auto",
                                      dipole_vec=src, **kw)
            bench("double layer", key, w, q, device, card)
            del w
        del trav
    if "helmholtz3d" in only:
        rng = np.random.default_rng(17)
        pts = torch.as_tensor(rng.random((3, 1_000_000)), device=device)
        q = torch.as_tensor(rng.standard_normal(1_000_000)
                            + 1j * rng.standard_normal(1_000_000),
                            device=device)
        trav = build_traversal(build_tree(pts, max_particles_in_box=30))
        w = make_helmholtz_wrangler(trav, 2.0, 12, pairs=False,
                                    rscale="auto")
        bench("helmholtz3d", "c128", w, q, device, card)


if __name__ == "__main__":
    main()
