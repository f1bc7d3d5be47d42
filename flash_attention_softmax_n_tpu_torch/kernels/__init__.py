"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions."""
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    flash_attention_n_fused,
)

__all__ = ["flash_attention_n_fused"]
