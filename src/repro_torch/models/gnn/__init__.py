"""The GNN family (the port of the JAX package's ``models/gnn/``):
GraphSAGE, DimeNet, EquiformerV2 and GraphCast as ``nn.Module``s, each
with ``apply`` and ``loss_fn`` over a ``GraphBatch`` (GraphCast: a
``GraphCastBatch``), the shared substrate in ``common`` and the numpy
neighbour sampler in ``sampler``. Message passing is plain torch (a
gather and ``index_add``), as the JAX package keeps it outside Pallas."""
