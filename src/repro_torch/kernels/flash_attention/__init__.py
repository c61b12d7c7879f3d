"""Flash attention forward, K5: its two CUDA kernels
(``csrc/flash_attention_tc.cu`` for bfloat16 on the tensor cores,
``csrc/flash_attention.cu`` for float32), their wrapper, the plain torch
version, and the model-layout entry ``ops.attention``."""
from repro_torch.kernels.flash_attention.flash_attention import (
    attention_plain,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import attention

__all__ = ["attention", "attention_plain", "flash_attention"]
