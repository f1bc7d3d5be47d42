"""Single-token softmax-N attention over a per-slot-length KV cache (int8,
fp8 e4m3 or dense).

Counterpart of ``decode_attention_n``
(``flash_attention_softmax_n_tpu/kernels/decode_attention.py``): unnormalized
(acc, m, l) statistics over the cache, then the epilogue (torch ops) that
merges the tail window and the current token's self-term and adds ``+n``
exactly once. Two routes compute the statistics, as in JAX:

  * ``implementation="pallas"`` (the default): kernel K8
    (``csrc/decode_attn.cu``) on a CUDA tensor, which reads only the
    positions below each slot's length in splits whose length
    ``decode_attn_plan`` chooses per call, or its plain version
    ``decode_attn_stats_reference`` on a CPU tensor. It rounds q to q's own
    type and walks 256-position tiles with a running maximum, as the Pallas
    kernel does; ``int8_compute`` quantizes q per row and the probabilities
    per row per tile, and both products run on integers.
  * ``implementation="xla"``: plain tensor ops over the whole padded cache,
    q rounded to bf16 unless the cache is f32.

Products take bf16 (or f32) operands with f32 accumulation: fp8 values
round to bf16 exactly, and the probabilities round to bf16 before PV unless
the cache is f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import math

import numpy as np
import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build

__all__ = ["decode_attention_n", "decode_attn_stats_reference", "decode_attn_plan",
           "decode_attn_products"]

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
TILE = 256  # positions per tile of the Pallas kernel, and K8's longest split
SPLITS = (256, 128, 64, 32)  # K8's split lengths, longest first
# the split where no length of SPLITS fits its rows in _KV_SMEM (a wide head
# dim: bf16 rows at hd 512 take 66 KB at 32 positions): one mma tile
WIDE_SPLIT = 16
_SMS = 132  # the H100's streaming multiprocessors
_KV_SMEM = 48 * 1024  # shared bytes a split's k and v rows may take: 4 CTAs an SM
FMA, MMA = 0, 1  # K8's products: f32 FMAs, or mma.sync in bf16


def decode_attn_plan(batch: int, kvh: int, s_len: int, hd: int, kv_elem: int,
                     int8_compute: bool) -> int:
    """K8's split length (positions per CTA) for a (B, KVH, S, hd) cache of
    ``kv_elem``-byte values: the longest of ``SPLITS`` whose grid over
    (split, KV head, slot) holds at least one CTA per SM when every slot
    is full and whose k and v rows (each padded to 16 bytes, plus one
    16-byte chunk) fit 48 KB of shared memory, else the shortest that
    fits. The 48 KB keep four CTAs on an SM: a bf16 cache at hd 64 and
    B64 S512 took 0.0283 ms at 256-position splits (72 KB of rows, two
    CTAs an SM) and 0.0176 at 128 on an NVIDIA H100 80GB HBM3
    (``utils/bench_decode_attn.py``). A longer target costs where slots
    are short against the window: the fused loop's chunk (B64, a 256-row
    window, slots of 64-80 rows) ran K8 35% longer at 64-position splits
    (four CTAs per SM) than at 256. Under int8 compute it is the Pallas
    kernel's 256-position tile: p is requantized per row over each tile, so
    another length computes another function. Where no length of
    ``SPLITS`` fits its rows in the 48 KB (bf16 above hd 376, int8 above
    hd 752), ``WIDE_SPLIT`` positions, whose layout fits a block up to about
    hd 1,200 at f32 and 1,800 at bf16 (G 16).
    """
    if int8_compute:
        return TILE
    row = -(-hd * kv_elem // 16) * 16 + 16
    fits = [sp for sp in SPLITS if 2 * sp * row <= _KV_SMEM]
    for sp in fits:
        if batch * kvh * math.ceil(s_len / sp) >= _SMS:
            return sp
    return fits[-1] if fits else WIDE_SPLIT


def decode_attn_products(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                         hd: int) -> int:
    """K8's products: ``MMA`` (mma.sync m16n8k16, bf16 operands, f32
    accumulators) for bf16 q over a bf16, int8 or fp8 cache with hd a
    multiple of 16, whose values widen to bf16 exactly; ``FMA`` (f32 FMAs)
    otherwise: f32 q or an f32 cache keeps f32 products, and int8
    compute's integer products are exact in f32.
    """
    mma = (q_dtype == torch.bfloat16 and hd % 16 == 0
           and kv_dtype in (torch.bfloat16, torch.int8, torch.float8_e4m3fn))
    return MMA if mma else FMA


def _operand(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """x rounded to the compute dtype, held in f32 for f32 accumulation."""
    return x.float() if x.dtype == torch.int8 else x.to(cd).float()


def _decode_attn_stats_xla(
    q: torch.Tensor,
    k_values: torch.Tensor,
    v_values: torch.Tensor,
    lengths: torch.Tensor,
    k_scales: Optional[torch.Tensor],
    v_scales: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(acc, m, l) over the cache; q (B, KVH, G, hd) f32, pre-scaled."""
    quantized = k_scales is not None
    cd = torch.bfloat16 if k_values.dtype != torch.float32 else torch.float32
    s = torch.einsum("bkge,bkse->bkgs", _operand(q, cd), _operand(k_values, cd))
    if quantized:
        s = s * k_scales.transpose(-1, -2)
    s_len = k_values.shape[2]
    valid = (torch.arange(s_len, device=q.device)[None, None, None, :]
             < lengths[:, None, None, None])
    s = torch.where(valid, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid, p, 0.0)  # rows with length 0: exp(0) = 1 -> mask
    l = torch.sum(p, dim=-1)
    if quantized:
        p = p * v_scales.transpose(-1, -2)
    acc = torch.einsum("bkgs,bksd->bkgd", _operand(p, cd), _operand(v_values, cd))
    return acc, m, l


def decode_attn_stats_reference(
    q: torch.Tensor,
    q_scales: Optional[torch.Tensor],
    k_values: torch.Tensor,
    v_values: torch.Tensor,
    lengths: torch.Tensor,
    k_scales: Optional[torch.Tensor],
    v_scales: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K8: (acc (B, KVH, G, hd), m, l (B, KVH, G)) f32.

    q (B, KVH, G, hd) pre-scaled in its compute type (bf16 or f32), or int8
    with per-row scales ``q_scales`` (B, KVH, G, 1) under int8 compute.
    Walks the cache in tiles of min(256, S rounded up to 128) positions with
    a running maximum, as the Pallas kernel does. Rows of length 0 come
    back as (acc 0, m NEG_INF, l 0).
    """
    batch, kvh, group, hd = q.shape
    s_len = k_values.shape[2]
    quantized = k_scales is not None
    int8c = q.dtype == torch.int8
    cd = torch.float32 if v_values.dtype == torch.float32 else torch.bfloat16
    block = min(TILE, -(-s_len // 128) * 128)
    lens = lengths.long()
    m = torch.full((batch, kvh, group), NEG_INF, device=q.device)
    l = torch.zeros((batch, kvh, group), device=q.device)
    acc = torch.zeros((batch, kvh, group, hd), device=q.device)
    for s0 in range(0, s_len, block):
        live = (s0 < lens)[:, None, None]  # the tile holds a valid position
        kt = k_values[:, :, s0:s0 + block]
        if int8c:
            # int32 sums, exact in f64, then rounded to f32
            s = (q.double() @ kt.double().transpose(-1, -2)).float() * q_scales
        else:
            s = q.float() @ kt.to(q.dtype).float().transpose(-1, -2)
        if quantized:
            s = s * k_scales[:, :, s0:s0 + block].transpose(-1, -2)
        pos = s0 + torch.arange(kt.shape[2], device=q.device)
        s = torch.where(pos < lens[:, None, None, None], s, NEG_INF)
        m_next = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next[..., None])
        l_next = l * alpha + torch.sum(p, dim=-1)
        if quantized:
            p = p * v_scales[:, :, s0:s0 + block].transpose(-1, -2)
        vt = v_values[:, :, s0:s0 + block]
        if int8c:
            r_max = torch.amax(p, dim=-1, keepdim=True)
            r_scale = torch.where(r_max == 0.0, 1.0, r_max / 127.0)
            r_int = torch.clamp(torch.round(p / r_scale), -128, 127)
            pv = (r_int.double() @ vt.double()).float() * r_scale
        else:
            pv = p.to(cd).float() @ vt.to(cd).float()
        m = torch.where(live, m_next, m)
        l = torch.where(live, l_next, l)
        acc = torch.where(live[..., None], acc * alpha[..., None] + pv, acc)
    return acc, m, l


def _decode_attn_cuda(qv, q_scales, k_values, v_values, lengths, k_scales,
                      v_scales):
    batch, kvh, group, hd = qv.shape
    s_len = k_values.shape[2]
    dev = qv.device
    ops = _build.ops()
    split = decode_attn_plan(batch, kvh, s_len, hd, k_values.element_size(),
                             qv.dtype == torch.int8)
    splits = math.ceil(s_len / split)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    acc, m, l = f32(batch, kvh, group, hd), f32(batch, kvh, group), f32(batch, kvh, group)
    ops.decode_attn(
        qv.contiguous(),
        None if q_scales is None else q_scales.reshape(batch, kvh, group).contiguous(),
        k_values, v_values, k_scales, v_scales,
        lengths.to(torch.int32).contiguous(), acc, m, l,
        f32(batch, kvh, splits, group, hd), f32(batch, kvh, splits, group),
        f32(batch, kvh, splits, group), split,
        decode_attn_products(qv.dtype, k_values.dtype, hd))
    _build.LAUNCHES["decode_attn"] += 1
    return acc, m, l


def _decode_attn_stats(q, k_values, v_values, lengths, k_scales, v_scales, *,
                       int8_compute: bool, in_dtype: torch.dtype):
    """The ``"pallas"`` route's statistics; q (B, KVH, G, hd) f32,
    pre-scaled. q is rounded to ``in_dtype``, or quantized per row under
    ``int8_compute``, outside the kernel, as JAX does."""
    if int8_compute:
        q_absmax = torch.amax(torch.abs(q), dim=-1, keepdim=True)
        q_scales = torch.where(q_absmax == 0, 1.0, q_absmax / 127.0)
        qv = torch.clamp(torch.round(q / q_scales), -128, 127).to(torch.int8)
    else:
        qv, q_scales = q.to(in_dtype), None
    args = (qv, q_scales, k_values, v_values, lengths, k_scales, v_scales)
    if qv.is_cuda:
        return _decode_attn_cuda(*args)
    if qv.device.type != "cpu":
        raise ValueError(f"decode_attention_n runs on CUDA or CPU tensors, "
                         f"not {qv.device}")
    return decode_attn_stats_reference(*args)


def decode_attention_n(
    q: torch.Tensor,
    k_values: torch.Tensor,
    v_values: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    softmax_n_param: float = 0.0,
    scale: Optional[float] = None,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    k_tail: Optional[torch.Tensor] = None,
    v_tail: Optional[torch.Tensor] = None,
    tail_lengths: Optional[torch.Tensor] = None,
    int8_compute: bool = False,
    implementation: str = "pallas",
) -> torch.Tensor:
    """Single-token softmax-N attention over a padded (quantized) KV cache.

    q (B, H, hd); k/v_values (B, KVH, S, hd) int8, fp8 or dense; k/v_scales
    (B, KVH, S, 1) f32 when quantized; lengths (B,) valid keys per slot.
    ``k_new``/``v_new`` (B, KVH, hd): the current token, attended as one
    extra key. ``k_tail``/``v_tail`` (B, KVH, W, hd) with ``tail_lengths``
    (B,): the fused loop's recent-token window. ``int8_compute`` (off by
    default; int8 caches only): integer QK and PV on the ``"pallas"``
    route. Returns (B, H, hd) in q's dtype.
    """
    if implementation not in ("xla", "pallas"):
        raise ValueError(f"unknown decode attention implementation "
                         f"{implementation!r}; expected 'xla' or 'pallas'")
    batch, heads, hd = q.shape
    kvh = k_values.shape[1]
    group = heads // kvh
    if scale is None:
        scale = hd ** -0.5
    if int8_compute and (k_scales is None or k_values.dtype != torch.int8):
        raise ValueError("int8_compute requires an int8-quantized cache")

    qg = q.reshape(batch, kvh, group, hd).float() * scale
    if implementation == "xla":
        acc, m, l = _decode_attn_stats_xla(qg, k_values, v_values, lengths,
                                           k_scales, v_scales)
    else:
        acc, m, l = _decode_attn_stats(
            qg, k_values, v_values, lengths, k_scales, v_scales,
            int8_compute=int8_compute, in_dtype=q.dtype)

    if k_tail is not None:
        # row j of the tail is position lengths[b] - tail_lengths[b] + j;
        # rows j < tail_lengths[b] are valid
        w = k_tail.shape[2]
        cd_t = (torch.float32 if k_tail.dtype == torch.float32
                else torch.bfloat16)
        s_t = torch.einsum("bkge,bkwe->bkgw", _operand(qg, cd_t),
                           _operand(k_tail, cd_t))
        valid_t = (torch.arange(w, device=q.device)[None, None, None, :]
                   < tail_lengths[:, None, None, None])
        s_t = torch.where(valid_t, s_t, NEG_INF)
        m_t = torch.amax(s_t, dim=-1)
        p_t = torch.where(valid_t, torch.exp(s_t - m_t[..., None]), 0.0)
        l_t = torch.sum(p_t, dim=-1)
        acc_t = torch.einsum("bkgw,bkwe->bkge", _operand(p_t, cd_t),
                             _operand(v_tail, cd_t))
        m_next = torch.maximum(m, m_t)
        a1 = torch.where(l > 0, torch.exp(m - m_next), 0.0)
        a2 = torch.where(l_t > 0, torch.exp(m_t - m_next), 0.0)
        acc = acc * a1[..., None] + acc_t * a2[..., None]
        l = l * a1 + l_t * a2
        m = m_next

    if k_new is not None:
        s_self = torch.einsum("bkge,bke->bkg", qg, k_new.float())
        m_next = torch.maximum(m, s_self)
        alpha = torch.exp(m - m_next)
        p_self = torch.exp(s_self - m_next)
        acc = acc * alpha[..., None] + p_self[..., None] * v_new[:, :, None, :].float()
        l = l * alpha + p_self
        m = m_next

    n = float(softmax_n_param)
    if n > 0.0:
        # the phantom key scores 0: n * exp(0 - m)
        l = l + n * torch.exp(torch.clamp(-m, min=NEG_INF))
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe[..., None]
    return out.reshape(batch, heads, hd).to(q.dtype)
