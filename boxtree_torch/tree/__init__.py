from boxtree_torch.tree.build import MaxLevelsExceeded, build_tree
from boxtree_torch.tree.containers import Tree, TreeOfBoxes, box_flags_enum

__all__ = [
    "MaxLevelsExceeded",
    "Tree",
    "TreeOfBoxes",
    "box_flags_enum",
    "build_tree",
]
