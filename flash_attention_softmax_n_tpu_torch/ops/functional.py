"""Softmax-N primitives and the unfused reference attention, in PyTorch.

Counterpart of ``flash_attention_softmax_n_tpu/ops/functional.py``::

    softmax_n(x_i) = exp(x_i) / (n + sum_j exp(x_j))

Softmax-N is not shift-invariant for n != 0, so after subtracting the
(detached) row max the denominator carries a compensating
``n * exp(-shift)`` term.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["softmax_n", "slow_attention_n"]


def softmax_n(
    x: torch.Tensor,
    n: Optional[float] = None,
    axis: int = -1,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Numerically-stable softmax with ``+n`` in the denominator along ``axis``.

    ``n=None`` means 0 (standard softmax); ``dtype`` casts the output. The
    max-shift is detached, so gradients flow through numerator and
    denominator only.
    """
    if n is None:
        n = 0.0
    shift = torch.amax(x, dim=axis, keepdim=True).detach()
    if n:
        # the phantom key scores 0: clamping the shift at 0 keeps
        # exp(-shift) <= 1, so the n-term cannot overflow when every real
        # score is below -88.7
        shift = torch.clamp(shift, min=0.0)
    numerator = torch.exp(x - shift)
    denominator = torch.sum(numerator, dim=axis, keepdim=True)
    if n:
        # only for n > 0: at n == 0, 0 * exp(-shift) is 0 * inf = NaN once
        # the row max is below -88.7, and softmax-0 is shift-invariant
        denominator = denominator + n * torch.exp(-shift)
    out = numerator / denominator
    return out if dtype is None else out.to(dtype)


def slow_attention_n(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    scale: Optional[float] = None,
    softmax_n_param: Optional[float] = None,
    softmax_dtype: Optional[torch.dtype] = None,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Unfused scaled-dot-product attention with softmax-N (the oracle).

    query ``(N, ..., L, E)``, key ``(N, ..., S, E)``, value ``(N, ..., S, Ev)``.
    ``attn_mask`` is boolean (True = attend) or an additive float bias;
    ``is_causal`` is the rectangular mask ``tril(diagonal=S-L)`` and excludes
    ``attn_mask``. Dropout draws from ``generator`` when ``train`` and
    ``dropout_p > 0``.
    """
    if softmax_n_param is None:
        softmax_n_param = 0.0
    if softmax_dtype is None:
        softmax_dtype = query.dtype

    L, S = query.shape[-2], key.shape[-2]
    E = query.shape[-1]
    scale_factor = (1.0 / math.sqrt(E)) if scale is None else scale

    attn_bias = torch.zeros((L, S), dtype=query.dtype, device=query.device)
    if is_causal:
        if attn_mask is not None:
            raise ValueError("attn_mask and is_causal are mutually exclusive")
        causal = torch.ones((L, S), dtype=torch.bool,
                            device=query.device).tril(diagonal=S - L)
        attn_bias = attn_bias.masked_fill(~causal, float("-inf"))

    attn_weight = (torch.einsum("...le,...se->...ls", query, key)
                   * torch.tensor(scale_factor, dtype=query.dtype))
    attn_weight = attn_weight + attn_bias
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            attn_weight = attn_weight.masked_fill(~attn_mask, float("-inf"))
        else:
            attn_weight = attn_weight + attn_mask

    attn_weight = softmax_n(attn_weight, n=softmax_n_param, axis=-1,
                            dtype=softmax_dtype)

    if dropout_p > 0.0 and train:
        if generator is None:
            raise ValueError("dropout_p > 0 with train=True requires generator")
        keep = torch.rand(attn_weight.shape, generator=generator,
                          device=attn_weight.device) < (1.0 - dropout_p)
        attn_weight = torch.where(keep, attn_weight / (1.0 - dropout_p),
                                  0.0).to(attn_weight.dtype)

    return torch.einsum("...ls,...sv->...lv", attn_weight,
                        value.to(attn_weight.dtype))
