from boxtree_torch.fmm.drive import (
    ExpansionWranglerInterface,
    TreeIndependentDataForWrangler,
    drive_fmm,
)

__all__ = [
    "ExpansionWranglerInterface",
    "TreeIndependentDataForWrangler",
    "drive_fmm",
]
