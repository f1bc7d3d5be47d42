"""XLNet's two-stream relative attention core with softmax-N.

Counterpart of ``flash_attention_softmax_n_tpu/ops/relative_attention.py``:
HF's ``XLNetRelativeAttention.rel_attn_core`` with ``softmax_n`` over the
key axis in place of the softmax.

* content score   ac = (q + r_w_bias) . k
* position score  bd = rel_shift((q + r_r_bias) . k_pos)
* segment score   ef = (q + r_s_bias) . seg_embed, gathered by seg_mat
* score = (ac + bd + ef) * scale, minus a large fill where masked: 65500
  for an fp16 mask, 1e30 otherwise.

The layout is XLNet's, sequence first: q/k/v are (seq, batch, n_head,
d_head).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flash_attention_softmax_n_tpu_torch.models.layers import dropout
from flash_attention_softmax_n_tpu_torch.ops.functional import softmax_n

__all__ = ["rel_shift_bnij", "xlnet_rel_attn_core_n", "XLNetAttentionConfig"]


@dataclasses.dataclass(frozen=True)
class XLNetAttentionConfig:
    """XLNet relative attention's config (a surgery target); ``model_type``
    is HF's, so that string-keyed registry lookups resolve."""

    n_head: int = 12
    d_head: int = 64
    softmax_n: float = 0.0
    model_type: str = "xlnet"


def rel_shift_bnij(x: torch.Tensor, klen: int) -> torch.Tensor:
    """The relative shift: (b, n, i, j) position scores, each row i moved
    to line up with relative distance i - j, cut to ``klen`` columns."""
    b, n, i, j = x.shape
    x = x.reshape(b, n, j, i)[:, :, 1:, :]
    return x.reshape(b, n, i, j - 1)[:, :, :, :klen]


def xlnet_rel_attn_core_n(
    q_head: torch.Tensor,
    k_head_h: torch.Tensor,
    v_head_h: torch.Tensor,
    k_head_r: torch.Tensor,
    *,
    r_w_bias: torch.Tensor,
    r_r_bias: torch.Tensor,
    r_s_bias: Optional[torch.Tensor] = None,
    seg_embed: Optional[torch.Tensor] = None,
    seg_mat: Optional[torch.Tensor] = None,
    attn_mask: Optional[torch.Tensor] = None,
    head_mask: Optional[torch.Tensor] = None,
    scale: float,
    softmax_n_param: float = 0.0,
    dropout_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_probs: bool = False,
):
    """softmax-N relative attention, sequence first.

    q_head (qlen, bsz, n_head, d_head); k_head_h and v_head_h (klen, ...);
    k_head_r (rlen, ...); seg_mat (qlen, klen, bsz, 2); attn_mask (qlen,
    klen, bsz, 1 or n_head), 1 = masked. Returns (qlen, bsz, n_head,
    d_head), and with ``return_probs`` also the probabilities in HF's (i,
    j, b, n) layout, after dropout (``dropout_p``, drawn from
    ``generator``) and ``head_mask``.
    """
    if softmax_n_param < 0:
        raise ValueError(
            f"softmax_n_param must be >= 0, got {softmax_n_param}")

    ac = torch.einsum("ibnd,jbnd->bnij", q_head + r_w_bias, k_head_h)
    bd = torch.einsum("ibnd,jbnd->bnij", q_head + r_r_bias, k_head_r)
    bd = rel_shift_bnij(bd, klen=ac.shape[3])
    if seg_mat is None:
        ef = 0.0
    else:
        ef = torch.einsum("ibnd,snd->ibns", q_head + r_s_bias, seg_embed)
        ef = torch.einsum("ijbs,ibns->bnij", seg_mat, ef)

    attn_score = (ac + bd + ef) * scale
    if attn_mask is not None:
        fill = 65500.0 if attn_mask.dtype == torch.float16 else 1e30
        attn_score = attn_score - fill * torch.einsum(
            "ijbn->bnij", attn_mask.to(attn_score.dtype))

    attn_prob = softmax_n(attn_score, n=softmax_n_param, axis=3)
    if dropout_p > 0.0:
        if generator is None:
            raise ValueError("dropout_p > 0 requires generator")
        attn_prob = dropout(attn_prob, dropout_p, generator)
    if head_mask is not None:
        attn_prob = attn_prob * torch.einsum("ijbn->bnij", head_mask)

    attn_vec = torch.einsum("bnij,jbnd->ibnd", attn_prob.to(v_head_h.dtype),
                            v_head_h)
    if return_probs:
        return attn_vec, torch.einsum("bnij->ijbn", attn_prob)
    return attn_vec
