"""int8 lm_head matmul fused with the greedy argmax: kernel K2.

Counterpart of ``quantized_matmul_argmax``
(``flash_attention_softmax_n_tpu/kernels/quant_matmul.py``). On a CUDA
tensor the hand-written kernel (``csrc/qmm_argmax.cu``) runs and the
(M, vocab) logits never reach device memory; on a CPU tensor the plain
version ``quantized_matmul_argmax_reference`` runs. Both accumulate in f32
and apply the per-column scale after accumulation, so near-ties can pick
another token than an argmax over bf16-rounded logits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build

__all__ = ["quantized_matmul_argmax", "quantized_matmul_argmax_reference"]


def quantized_matmul_argmax_reference(x2: torch.Tensor, w_values: torch.Tensor,
                                      w_scales: torch.Tensor
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 on x (M, K): (first argmax (M,) int32, max (M,) f32)."""
    w = w_values.to(x2.dtype).float()
    logits = (x2.float() @ w) * w_scales.reshape(1, -1).float()
    val, idx = torch.max(logits, dim=-1)
    return idx.to(torch.int32), val


def _qmm_argmax_cuda(x2, w_values, w_scales):
    m, n = x2.shape[0], w_values.shape[1]
    ops = _build.ops()
    dev = x2.device
    tiles = ops.qmm_tiles(n)
    part_val = torch.empty((m, tiles), dtype=torch.float32, device=dev)
    part_idx = torch.empty((m, tiles), dtype=torch.int32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    val = torch.empty((m,), dtype=torch.float32, device=dev)
    ops.qmm_argmax(x2.contiguous(), w_values.contiguous(),
                   w_scales.reshape(-1).float().contiguous(), idx, val,
                   part_val, part_idx)
    _build.LAUNCHES["qmm_argmax"] += 1
    return idx, val


def quantized_matmul_argmax(x: torch.Tensor, w_values: torch.Tensor,
                            w_scales: torch.Tensor, *,
                            return_max: bool = False):
    """argmax_N(x (..., M, K) @ dequant(w) (K, N)) -> (..., M) int32.

    ``return_max=True`` also returns the winning logits (..., M) f32.
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    if w_values.shape[0] != k:
        raise ValueError(f"contraction mismatch: x K={k}, w K={w_values.shape[0]}")
    x2 = x.reshape(-1, k)
    if x2.is_cuda:
        idx, val = _qmm_argmax_cuda(x2, w_values, w_scales)
    elif x2.device.type == "cpu":
        idx, val = quantized_matmul_argmax_reference(x2, w_values, w_scales)
    else:
        raise ValueError(f"quantized_matmul_argmax runs on CUDA or CPU "
                         f"tensors, not {x2.device}")
    idx, val = idx.reshape(lead), val.reshape(lead)
    return (idx, val) if return_max else idx
