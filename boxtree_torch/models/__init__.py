from boxtree_torch.models.constant_one import (
    ConstantOneExpansionWrangler,
    ConstantOneTreeIndependentDataForWrangler,
)
from boxtree_torch.models.laplace import (
    Laplace3DPairsExpansionWrangler,
    LaplaceTreeIndependentDataForWrangler,
    make_laplace_wrangler,
)

__all__ = [
    "ConstantOneExpansionWrangler",
    "ConstantOneTreeIndependentDataForWrangler",
    "Laplace3DPairsExpansionWrangler",
    "LaplaceTreeIndependentDataForWrangler",
    "make_laplace_wrangler",
]
