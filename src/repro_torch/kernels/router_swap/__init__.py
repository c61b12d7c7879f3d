"""Swap-gain search of the AWPM MoE router: the CUDA kernel
``csrc/router_swap.cu`` (K4), its wrapper, its plain torch version, and
the entry points under the JAX package's names that ``models/moe.py``
calls."""
from repro_torch.kernels.router_swap.ops import (
    router_swap_padded,
    router_swap_padded_batched,
)
from repro_torch.kernels.router_swap.ref import (
    router_swap_plain,
    router_swap_plain_batched,
)
from repro_torch.kernels.router_swap.router_swap import router_swap

__all__ = ["router_swap", "router_swap_padded", "router_swap_padded_batched",
           "router_swap_plain", "router_swap_plain_batched"]
