"""Quantized int8 or fp8 (e4m3) KV cache with per-token-per-head scales.

Counterpart of ``flash_attention_softmax_n_tpu/quant/kv_cache.py``. The
dequantization rides the attention math: scores are scaled by the k scale
after the QK product and the v scale folds into the probabilities.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.ops.functional import softmax_n
from flash_attention_softmax_n_tpu_torch.quant.qtensor import (
    FP8,
    FP8_MAX,
    INT8_MAX,
    QTensor,
)

__all__ = [
    "init_quantized_kv_cache",
    "quantize_kv",
    "update_quantized_cache",
    "cached_attention_quantized",
]

NEG_INF = -1e30


_MODES = {"int8": (torch.int8, 8), "fp8": (FP8, -8)}


def init_quantized_kv_cache(n_layers: int, batch: int, n_kv_heads: int,
                            max_len: int, head_dim: int, mode: str = "int8",
                            device=None) -> Dict:
    """Cache dict with QTensor k/v: int8 or fp8 values (``mode``) and f32
    scale planes, on the card unless ``device`` says otherwise."""
    if mode not in _MODES:
        raise ValueError(f"unknown KV quantization mode {mode!r}")
    dt, bits = _MODES[mode]
    device = resolve_device(device)
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    sshape = (n_layers, batch, n_kv_heads, max_len, 1)

    def qt():
        return QTensor(torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device),
                       bits=bits)

    return {"k": qt(), "v": qt(),
            "length": torch.zeros((), dtype=torch.int32, device=device)}


def quantize_kv(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric quantization along head_dim (last axis): int8
    (``bits=8``) or fp8 e4m3 (``bits=-8``).

    x (..., S, head_dim) -> (values, scales (..., S, 1) f32).
    """
    if bits not in (8, -8):
        raise ValueError(f"KV quantization takes bits 8 or -8, got {bits}")
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scales = absmax / (INT8_MAX if bits == 8 else FP8_MAX)
    safe = torch.where(scales == 0, 1.0, scales)
    if bits == -8:
        return (xf / safe).to(FP8), scales
    values = torch.clamp(torch.round(xf / safe), -128, 127).to(torch.int8)
    return values, scales


def update_quantized_cache(cache_kv: QTensor, new: torch.Tensor,
                           pos: int) -> QTensor:
    """Quantize ``new`` (B, KVH, L, hd) and write it at position ``pos``,
    in place; returns the same QTensor."""
    values, scales = quantize_kv(new, cache_kv.bits)
    length = new.shape[2]
    cache_kv.values[:, :, pos:pos + length] = values
    cache_kv.scales[:, :, pos:pos + length] = scales
    return cache_kv


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, kvh, l, hd = x.shape
    return x[:, :, None].expand(b, kvh, n_rep, l, hd).reshape(b, kvh * n_rep,
                                                              l, hd)


def cached_attention_quantized(q: torch.Tensor, k_cache: QTensor,
                               v_cache: QTensor, length: int, *,
                               softmax_n_param: float, scale: float,
                               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Single-step attention over a quantized cache with softmax-N.

    q (B, H, Lq, hd); cache values (B, KVH, S, hd) + scales (B, KVH, S, 1).
    Valid keys are [0, length). Products run on ``compute_dtype`` operands
    with float32 accumulation.
    """
    n_rep = q.shape[1] // k_cache.values.shape[1]
    kv = _repeat_kv(k_cache.values, n_rep)
    ks = _repeat_kv(k_cache.scales, n_rep)
    vv = _repeat_kv(v_cache.values, n_rep)
    vs = _repeat_kv(v_cache.scales, n_rep)

    scores = torch.einsum("bhle,bhse->bhls", q.to(compute_dtype).float(),
                          kv.to(compute_dtype).float())
    scores = scores * ks.transpose(-1, -2) * scale
    s = kv.shape[2]
    valid = torch.arange(s, device=q.device)[None, None, None, :] < length
    scores = torch.where(valid, scores, NEG_INF)
    probs = softmax_n(scores, n=softmax_n_param, axis=-1)
    probs = probs * vs.transpose(-1, -2)
    ctx = torch.einsum("bhls,bhsv->bhlv", probs.to(compute_dtype).float(),
                       vv.to(compute_dtype).float())
    return ctx.to(compute_dtype)
