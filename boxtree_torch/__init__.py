"""boxtree_torch: the PyTorch and CUDA port of :mod:`boxtree_tpu`.

The same main path as the JAX package, on an NVIDIA GPU or on the CPU:
adaptive quad- and octrees from particles (:func:`build_tree`), FMM
interaction lists (:func:`boxtree_torch.traversal.build_traversal`), and
the FMM driver (:func:`boxtree_torch.fmm.drive_fmm`) over the counting,
Laplace and Helmholtz expansion wranglers (:mod:`boxtree_torch.models`).
Subpackages and public names mirror :mod:`boxtree_tpu`
(``tests/test_torch_public_names.py`` lists the names not ported yet); the
hand-written CUDA kernels live in ``csrc/`` and are built at first use
(:mod:`boxtree_torch.ops.kernels`).
"""

from boxtree_torch import config  # noqa: F401  (turns TF32 off)
from boxtree_torch.tree.build import (
    MaxLevelsExceeded,
    TreeBuilder,
    build_tree,
)
from boxtree_torch.tree.containers import Tree, TreeOfBoxes, box_flags_enum

__all__ = [
    "MaxLevelsExceeded",
    "Tree",
    "TreeBuilder",
    "TreeOfBoxes",
    "box_flags_enum",
    "build_tree",
]
