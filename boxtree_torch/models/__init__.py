from boxtree_torch.models.constant_one import (
    ConstantOneExpansionWrangler,
    ConstantOneTreeIndependentDataForWrangler,
)
from boxtree_torch.models.helmholtz import (
    Helmholtz2DExpansionWrangler,
    Helmholtz2DPairsExpansionWrangler,
    HelmholtzTreeIndependentDataForWrangler,
)
from boxtree_torch.models.helmholtz3d import (
    Helmholtz3DExpansionWrangler,
    Helmholtz3DPairsExpansionWrangler,
    Helmholtz3DTreeIndependentDataForWrangler,
    make_helmholtz_wrangler,
)
from boxtree_torch.models.laplace import (
    Laplace2DExpansionWrangler,
    Laplace2DPairsExpansionWrangler,
    Laplace3DExpansionWrangler,
    Laplace3DPairsExpansionWrangler,
    LaplaceTreeIndependentDataForWrangler,
    make_laplace_wrangler,
)

__all__ = [
    "ConstantOneExpansionWrangler",
    "ConstantOneTreeIndependentDataForWrangler",
    "Helmholtz2DExpansionWrangler",
    "Helmholtz2DPairsExpansionWrangler",
    "Helmholtz3DExpansionWrangler",
    "Helmholtz3DPairsExpansionWrangler",
    "Helmholtz3DTreeIndependentDataForWrangler",
    "HelmholtzTreeIndependentDataForWrangler",
    "Laplace2DExpansionWrangler",
    "Laplace2DPairsExpansionWrangler",
    "Laplace3DExpansionWrangler",
    "Laplace3DPairsExpansionWrangler",
    "LaplaceTreeIndependentDataForWrangler",
    "make_helmholtz_wrangler",
    "make_laplace_wrangler",
]
