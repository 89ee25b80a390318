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
