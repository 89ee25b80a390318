"""The distributed FMM (:mod:`boxtree_torch.parallel.distributed`) and its
tree partition (:mod:`boxtree_torch.parallel.partition`), the public names
of :mod:`boxtree_tpu.parallel`; the ranks are the slots of a
:class:`boxtree_torch.parallel.mesh.Mesh`."""

from boxtree_torch.parallel.distributed import DistributedFMMRunner
from boxtree_torch.parallel.partition import (
    BoxMasks,
    dfs_box_order,
    get_box_masks,
    partition_work,
)

__all__ = [
    "BoxMasks",
    "DistributedFMMRunner",
    "dfs_box_order",
    "get_box_masks",
    "partition_work",
]
