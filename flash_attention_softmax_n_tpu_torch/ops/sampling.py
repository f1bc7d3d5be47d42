"""Token sampling: per-slot temperature, top-k and top-p (nucleus).

Counterpart of ``flash_attention_softmax_n_tpu/ops/sampling.py``. Per-slot
settings are (B,) tensors, so a mixed batch is one call; rows at
temperature 0 take the argmax. Random numbers come from an explicit
``torch.Generator`` (they differ from ``jax.random``'s).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample_tokens", "categorical"]


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(
    logits: torch.Tensor,
    generator: torch.Generator,
    temps: torch.Tensor,
    top_k: Optional[torch.Tensor] = None,
    top_p: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample one token per row of ``logits`` (B, V) -> (B,) int32.

    temps (B,): 0 selects greedy argmax for that row; top_k (B,) int, <= 0
    disables k-truncation; top_p (B,) float, >= 1 disables nucleus
    truncation. Top-k applies first, then top-p on the k-truncated
    distribution (HF ``top_k_top_p_filtering`` order).
    """
    v = logits.shape[-1]
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = temps.float()
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]

    if top_k is None and top_p is None:
        sampled = categorical(scaled, generator).to(torch.int32)
        return torch.where(temps > 0, sampled, greedy_tok)

    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, sort_idx)
    pos = torch.arange(v, device=logits.device)[None, :]

    keep = torch.ones(scaled.shape, dtype=torch.bool, device=logits.device)
    if top_k is not None:
        k = torch.where(top_k <= 0, v, top_k)[:, None]
        keep &= pos < k
    if top_p is not None:
        after_k = torch.where(keep, sorted_logits, float("-inf"))
        probs = torch.softmax(after_k, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix whose mass reaches p
        keep &= (cum - probs) < top_p.float()[:, None]
    keep[:, 0] = True

    masked = torch.where(keep, sorted_logits, float("-inf"))
    choice = categorical(masked, generator)
    sampled = torch.gather(sort_idx, -1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temps > 0, sampled, greedy_tok)
