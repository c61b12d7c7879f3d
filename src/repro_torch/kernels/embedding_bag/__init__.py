"""EmbeddingBag (weighted sum over bags of table rows): the CUDA kernel
``csrc/embedding_bag.cu`` (K6), its wrapper, its plain torch version, and
the entry ``ops.embedding_bag_padded`` that ``models/recsys/embedding.py``
calls."""
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ops import embedding_bag_padded
from repro_torch.kernels.embedding_bag.ref import embedding_bag_plain

__all__ = ["embedding_bag", "embedding_bag_padded", "embedding_bag_plain"]
