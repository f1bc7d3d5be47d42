"""Single-token softmax-N attention over a per-slot-length (int8) KV cache.

Counterpart of ``decode_attention_n``
(``flash_attention_softmax_n_tpu/kernels/decode_attention.py``) on its
``implementation="xla"`` route, which the serving path takes: unnormalized
(acc, m, l) statistics over the cache as plain tensor ops, then the
epilogue that merges the tail window and the current token's self-term and
adds ``+n`` exactly once. Products take bf16 (or f32) operands with f32
accumulation. The Pallas decode kernel (``implementation="pallas"``) is
still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["decode_attention_n"]

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


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
    implementation: str = "xla",
) -> torch.Tensor:
    """Single-token softmax-N attention over a padded (quantized) KV cache.

    q (B, H, hd); k/v_values (B, KVH, S, hd) int8 or dense; k/v_scales
    (B, KVH, S, 1) f32 when quantized; lengths (B,) valid keys per slot.
    ``k_new``/``v_new`` (B, KVH, hd): the current token, attended as one
    extra key. ``k_tail``/``v_tail`` (B, KVH, W, hd) with ``tail_lengths``
    (B,): the fused loop's recent-token window. Returns (B, H, hd) in q's
    dtype.
    """
    if implementation == "pallas":
        raise NotImplementedError(
            "the Pallas decode-attention kernel is not ported yet; use "
            "implementation='xla' (see ROADMAP.md)")
    if implementation != "xla":
        raise ValueError(f"unknown decode attention implementation "
                         f"{implementation!r}")
    batch, heads, hd = q.shape
    kvh = k_values.shape[1]
    group = heads // kvh
    if scale is None:
        scale = hd ** -0.5

    qg = q.reshape(batch, kvh, group, hd).float() * scale
    acc, m, l = _decode_attn_stats_xla(qg, k_values, v_values, lengths,
                                       k_scales, v_scales)

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
