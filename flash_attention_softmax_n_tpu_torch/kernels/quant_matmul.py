"""Quantized matmuls: the dequant matmul K7 and the greedy lm_head K2.

Counterparts of ``quantized_matmul`` and ``quantized_matmul_argmax``
(``flash_attention_softmax_n_tpu/kernels/quant_matmul.py``). On a CUDA
tensor the hand-written kernels run (``csrc/qmm.cu``, ``csrc/qmm_argmax.cu``);
on a CPU tensor their plain versions ``*_reference`` do. Both accumulate in
f32 (int32 under W8A8) and apply the per-column scale after accumulation,
which is not the plain route's ``x @ dequantize(w)`` (that rounds w * s to
x's type first); K2's argmax can therefore pick another token at a near-tie
than an argmax over bf16-rounded logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build
from flash_attention_softmax_n_tpu_torch.quant.qtensor import (
    INT4_GROUP,
    INT8_MAX,
    unpack_int4,
)

__all__ = ["quantized_matmul", "quantized_matmul_reference",
           "quantize_rows", "quantized_matmul_argmax",
           "quantized_matmul_argmax_reference"]


def _route(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {x.device}")
    return False


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """W8A8's activation quantization, as JAX does it outside its kernel:
    x (M, K) -> (int8 (M, K), per-row scales absmax / 127 (M, 1) f32)."""
    xf = x2.float()
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    x_scales = torch.where(absmax == 0, 1.0, absmax / INT8_MAX)
    xq = torch.clamp(torch.round(xf / x_scales), -128, 127).to(torch.int8)
    return xq, x_scales


def quantized_matmul_reference(x2: torch.Tensor, x_scales: Optional[torch.Tensor],
                               w_values: torch.Tensor, w_scales: torch.Tensor, *,
                               bits: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K7 on x (M, K): bf16/f32 x, or int8 x with its row
    scales (M, 1) (W8A8); int8 w (K, N) or int4 w packed (K/2, N)."""
    w = unpack_int4(w_values, 0) if bits == 4 else w_values
    s = w_scales.reshape(1, -1).float()
    if x2.dtype == torch.int8:
        # the int32 sums, exact in f64 (|sum| < 2^53), then rounded to f32
        acc = (x2.double() @ w.double()).float()
        out = acc * s * x_scales.reshape(-1, 1).float()
    else:
        out = (x2.float() @ w.float()) * s
    return out.to(out_dtype)


def _qmm_cuda(x2, x_scales, w_values, w_scales, bits, out_dtype):
    m, k = x2.shape
    n = w_values.shape[1]
    ops = _build.ops()
    splits = ops.qmm_splits(m, k, n)
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    part = torch.empty((splits, m, n) if splits > 1 else (0,),
                       dtype=torch.float32, device=x2.device)
    xs = None if x_scales is None else x_scales.reshape(-1).contiguous()
    ops.qmm(x2.contiguous(), xs, w_values.contiguous(),
            w_scales.reshape(-1).float().contiguous(), out, part, bits)
    _build.LAUNCHES["qmm"] += 1
    return out


def quantized_matmul(x: torch.Tensor, w_values: torch.Tensor,
                     w_scales: torch.Tensor, *, bits: int = 8,
                     act_quant: bool = False,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., K) @ dequant(w) (K, N) -> (..., N) in ``out_dtype`` (x's
    type by default).

    ``w_values``: int8 (K, N), or int4 packed (K/2, N) along K
    (``quantize(w, bits=4, axis=0)``; needs K % 256 == 0). ``w_scales``:
    (1, N) or (N,). ``act_quant`` (W8A8): x is quantized per row
    (``quantize_rows``) and the products run int8 x int8 with int32
    accumulation; the epilogue multiplies by the column scale, then the
    row scale.
    """
    if bits not in (8, 4):
        raise ValueError(f"quantized_matmul takes bits 8 or 4, got {bits}")
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    kw = w_values.shape[0] * (2 if bits == 4 else 1)
    if kw != k:
        raise ValueError(f"contraction mismatch: x K={k}, w K={kw}")
    if bits == 4 and k % INT4_GROUP:
        raise ValueError("int4 fused matmul requires K % 256 == 0 "
                         "(grouped nibble packing)")
    n = w_values.shape[1]
    x2 = x.reshape(-1, k)
    x_scales = None
    if act_quant:
        x2, x_scales = quantize_rows(x2)
    if _route(x2, "quantized_matmul"):
        out = _qmm_cuda(x2, x_scales, w_values, w_scales, bits, out_dtype)
    else:
        out = quantized_matmul_reference(x2, x_scales, w_values, w_scales,
                                         bits=bits, out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], n)


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
    if _route(x2, "quantized_matmul_argmax"):
        idx, val = _qmm_argmax_cuda(x2, w_values, w_scales)
    else:
        idx, val = quantized_matmul_argmax_reference(x2, w_values, w_scales)
    idx, val = idx.reshape(lead), val.reshape(lead)
    return (idx, val) if return_max else idx
