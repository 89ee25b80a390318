"""The FMM cost model (:mod:`boxtree_torch.cost.model`); as in
:mod:`boxtree_tpu.cost`, the package itself exports no names."""

__all__: list = []
