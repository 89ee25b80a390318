"""boxtree_torch stands alone: importing every one of its modules imports
neither JAX nor boxtree_tpu.

The check runs in a fresh interpreter, since this test process has both
loaded already (``tests/conftest.py``).
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import boxtree_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    boxtree_torch.__path__, "boxtree_torch."))
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "boxtree_tpu"))}))
"""


def test_no_jax_and_no_boxtree_tpu():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "boxtree_torch.geometry.area_query" in out["modules"]
    assert "boxtree_torch.tree.level_restrict" in out["modules"]
    assert "boxtree_torch.ops.extents" in out["modules"]
    assert "boxtree_torch.ops.close_lists" in out["modules"]
    assert "boxtree_torch.ops.cylinder_bessel" in out["modules"]
    assert "boxtree_torch.ops.helmholtz2d" in out["modules"]
    assert "boxtree_torch.models.helmholtz" in out["modules"]
    assert "boxtree_torch.ops.laplace2d" in out["modules"]
    assert "boxtree_torch.models.laplace" in out["modules"]
    assert "boxtree_torch.parallel.distributed" in out["modules"]
    assert "boxtree_torch.parallel.mesh" in out["modules"]
    assert "boxtree_torch.cost.model" in out["modules"]
    assert "boxtree_torch.parallel.shard_sort" in out["modules"]
    assert "boxtree_torch.parallel.shard_build" in out["modules"]
    assert "boxtree_torch.ops.shard" in out["modules"]
    assert out["loaded"] == []
