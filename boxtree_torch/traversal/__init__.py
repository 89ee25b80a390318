from boxtree_torch.traversal.build import build_traversal
from boxtree_torch.traversal.containers import BuiltList, FMMTraversalInfo

__all__ = [
    "BuiltList",
    "FMMTraversalInfo",
    "build_traversal",
]
