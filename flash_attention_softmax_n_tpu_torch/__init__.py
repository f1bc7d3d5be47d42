"""flash-attention-softmax-n in PyTorch for an NVIDIA H100.

The port of the JAX package ``flash_attention_softmax_n_tpu`` (which stays
the reference): softmax-N primitives, the fused flash-attention forward as a
hand-written CUDA kernel, the int8 decoder and its continuous-batching
serving engine. Kernels run on CUDA tensors; CPU tensors take each
kernel's plain PyTorch version. Public API::

    from flash_attention_softmax_n_tpu_torch import (
        softmax_n, slow_attention_n, flash_attention_n,
    )
"""

from flash_attention_softmax_n_tpu_torch.ops.flash_attention import flash_attention_n
from flash_attention_softmax_n_tpu_torch.ops.functional import slow_attention_n, softmax_n

# the reference library's flag for its optional Triton kernel; the port's
# kernels are CUDA C++
TRITON_INSTALLED = False

__version__ = "0.1.0"

__all__ = ["softmax_n", "slow_attention_n", "flash_attention_n",
           "TRITON_INSTALLED"]
