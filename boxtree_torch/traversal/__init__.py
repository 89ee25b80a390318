from boxtree_torch.traversal.build import (
    FMMTraversalBuilder,
    build_traversal,
    merge_close_lists,
)
from boxtree_torch.traversal.containers import BuiltList, FMMTraversalInfo

__all__ = [
    "BuiltList",
    "FMMTraversalBuilder",
    "FMMTraversalInfo",
    "build_traversal",
    "merge_close_lists",
]
