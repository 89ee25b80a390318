"""Where the Laplace wrangler's setup time goes, on the main path.

Builds ``chip_smoke.py``'s main-path tree and traversal (1e6 uniform
float32 points, seed 17, 30 a box), then times ``make_laplace_wrangler(
trav, 8, pairs=True, rscale="auto", dtype=float32)`` (synchronised, the
median of ``--reps``) and splits it by wrapping the setup's parts, each
synchronised before and after: the M2L table (the per-level
``_m2l_matrices`` calls of a checkout before the table kernels, or the
one ``_m2l_table`` call after), the M2L parent-block plan around it
(``_build_m2l_parent_plan`` less the table), the M2M and L2L operators
(``_m2m_matrices`` / ``_l2l_matrices``), and the rest.  Prints one JSON
line with ``--label``.

Run from the root of a checkout on the card (``--device cpu`` for a
rehearsal at a small ``--points``); ``--package DIR`` imports
``boxtree_torch`` from a checkout unpacked in DIR instead (for an A/B in
one call: parent, change, change, parent)::

    PYTHONPATH=. python3 scripts/torch_setup_split.py --label change
    python3 scripts/torch_setup_split.py --package build/parent \\
        --label parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="change")
    ap.add_argument("--package", default=None)
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.package:
        sys.path.insert(0, args.package)

    import numpy as np
    import torch

    from boxtree_torch import build_tree
    from boxtree_torch.models import expansion_base, laplace
    from boxtree_torch.models import make_laplace_wrangler
    from boxtree_torch.traversal import build_traversal

    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(17)
    pts = torch.as_tensor(rng.random((3, args.points), dtype=np.float32),
                          device=dev)
    trav = build_traversal(build_tree(pts, max_particles_in_box=30))

    parts = {}

    def wrap(cls, name, key):
        fn = getattr(cls, name, None)
        if fn is None:
            return

        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
            return out
        setattr(cls, name, timed)

    cls = laplace.Laplace3DPairsExpansionWrangler
    has_table = "_m2l_table" in cls.__dict__ or any(
        "_m2l_table" in c.__dict__ for c in cls.__mro__[1:3])
    wrap(cls, "_m2l_table" if has_table else "_m2l_matrices", "m2l_table")
    wrap(expansion_base.ExpansionWranglerBase, "_build_m2l_parent_plan",
         "m2l_plan_with_table")
    wrap(cls, "_m2m_matrices", "m2m_operators")
    wrap(cls, "_l2l_matrices", "l2l_operators")

    def setup():
        return make_laplace_wrangler(trav, 8, pairs=True, rscale="auto",
                                     dtype=torch.float32)

    setup()                                   # the kernels' build, warm-up
    runs = []
    for _ in range(args.reps):
        parts.clear()
        sync()
        t0 = time.perf_counter()
        setup()
        sync()
        total = time.perf_counter() - t0
        split = dict(parts)
        split["m2l_plan"] = (split.pop("m2l_plan_with_table", 0.0)
                             - split.get("m2l_table", 0.0))
        split["rest"] = total - sum(split.values())
        runs.append(dict(total=total, **split))
    runs.sort(key=lambda r: r["total"])
    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip() if dev.type == "cuda" else "cpu")
    print(json.dumps({"label": args.label, "card": card,
                      "points": args.points, "nboxes": trav.tree.nboxes,
                      "table_by": "_m2l_table" if has_table
                      else "_m2l_matrices per level",
                      "median": runs[len(runs) // 2], "runs": runs}),
          flush=True)


if __name__ == "__main__":
    main()
