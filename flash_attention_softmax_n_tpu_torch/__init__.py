"""flash-attention-softmax-n in PyTorch for an NVIDIA H100.

The port of the JAX package ``flash_attention_softmax_n_tpu`` (which stays
the reference): softmax-N primitives, the fused flash-attention forward as a
hand-written CUDA kernel, the int8 decoder and its continuous-batching
serving engine, training on one card or over a ``torch.distributed`` mesh
(tensor, data and sequence parallelism with ring attention, ZeRO-1:
``parallel``), checkpoints in the JAX package's format
(``utils.checkpoint``), BERT and XLNet with the HF converters and
softmax-N surgery (``surgery``), and activation and weight statistics,
perplexity and the outlier gates (``analysis``, ``quant.gates``). Kernels run on CUDA tensors; CPU tensors take each
kernel's plain PyTorch version. Public API::

    from flash_attention_softmax_n_tpu_torch import (
        softmax_n, slow_attention_n, flash_attention_n,
        flash_attention_n_triton, PALLAS_INSTALLED, TRITON_INSTALLED,
    )
"""

import functools as _functools
import warnings as _warnings

from flash_attention_softmax_n_tpu_torch.ops.flash_attention import flash_attention_n
from flash_attention_softmax_n_tpu_torch.ops.functional import slow_attention_n, softmax_n

# The JAX package's flag that its fused kernel route exists: True here too,
# meaning that flash_attention_n(implementation="pallas") reaches the fused
# kernels (K1 forward, K5/K6 backward, CUDA C++ on the card). No Pallas is
# involved; the name is kept so that callers of the JAX package run as they
# are.
PALLAS_INSTALLED = True
# the reference library's flag for its optional Triton kernel; the port's
# kernels are CUDA C++
TRITON_INSTALLED = False


@_functools.wraps(flash_attention_n)
def flash_attention_n_triton(*args, **kwargs):
    """Migration alias for the reference library's Triton entry point, as in
    the JAX package: warns, then calls ``flash_attention_n`` on the fused
    route (``implementation="pallas"`` unless the caller names another)."""
    _warnings.warn(
        "flash_attention_n_triton is the reference API's name; it routes to "
        "the fused kernels (implementation='pallas'). Call flash_attention_n "
        "directly.", stacklevel=2)
    kwargs.setdefault("implementation", "pallas")
    return flash_attention_n(*args, **kwargs)


__version__ = "0.1.0"

__all__ = ["softmax_n", "slow_attention_n", "flash_attention_n",
           "flash_attention_n_triton", "PALLAS_INSTALLED", "TRITON_INSTALLED"]
