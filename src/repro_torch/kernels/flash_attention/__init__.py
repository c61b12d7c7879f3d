"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu``
(K5), its wrapper, its plain torch version, and the model-layout entry
``ops.attention``."""
from repro_torch.kernels.flash_attention.flash_attention import (
    attention_plain,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import attention

__all__ = ["attention", "attention_plain", "flash_attention"]
