"""Perplexity: the quantization-quality instrument.

Counterpart of ``flash_attention_softmax_n_tpu/analysis/evaluate.py``: the
summed next-token negative log-likelihood of a (B, L) batch, corpus
perplexity over batches, and ``delta_perplexity`` of a quantized parameter
dict against its dense one on the same tokens. The model runs as
configured (``cfg.softmax_n``, ``cfg.attn_implementation``,
``cfg.int8_mm_impl``), so on the card it runs K1 and, on the ``"pallas"``
route, K7. Everything runs under ``torch.inference_mode()``, the
log-softmax in float32; each batch's sums stay on the device until the
corpus is done.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch

from flash_attention_softmax_n_tpu_torch.models.decoder import (
    DecoderConfig,
    decoder_forward,
)

__all__ = ["token_nll", "perplexity", "delta_perplexity"]


def _tokens(params: Dict, t) -> torch.Tensor:
    return torch.as_tensor(t, device=params["embed"].device).long()


@torch.inference_mode()
def token_nll(params: Dict, cfg: DecoderConfig, tokens,
              mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed next-token NLL over a (B, L) batch: (total f32, count int32).

    ``mask`` (B, L) bool marks valid tokens; position i predicts token
    i + 1, so the last position never counts.
    """
    tokens = _tokens(params, tokens)
    logits = decoder_forward(params, cfg, tokens).float()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:]
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if mask is None:
        valid = torch.ones_like(targets, dtype=torch.bool)
    else:
        mask = torch.as_tensor(mask, device=tokens.device).bool()
        valid = mask[:, :-1] & mask[:, 1:]
    nll = torch.where(valid, nll, 0.0)
    return torch.sum(nll), torch.sum(valid, dtype=torch.int32)


def perplexity(params: Dict, cfg: DecoderConfig, token_batches,
               mask_batches=None) -> float:
    """Corpus perplexity over an iterable of (B, L) token batches."""
    if mask_batches is None:
        mask_batches = itertools.repeat(None)
    sums = [token_nll(params, cfg, tokens, mask)
            for tokens, mask in zip(token_batches, mask_batches)]
    if not sums:
        raise ValueError("no valid tokens to evaluate")
    # one copy to the host; each batch's f32 sum is added in f64, as the
    # JAX package adds them into a Python float
    nlls, counts = torch.stack([torch.stack([s.double(), n.double()])
                                for s, n in sums]).cpu().unbind(1)
    total, count = sum(nlls.tolist()), int(sum(counts.tolist()))
    if count == 0:
        raise ValueError("no valid tokens to evaluate")
    return float(torch.exp(torch.tensor(total / count, dtype=torch.float32)))


def delta_perplexity(dense_params: Dict, quant_params: Dict,
                     cfg: DecoderConfig, token_batches) -> Dict[str, float]:
    """Perplexity of a quantized parameter dict against its dense one on
    the same tokens: {'ppl_dense', 'ppl_quant', 'delta', 'relative'}."""
    batches = list(token_batches)
    ppl_dense = perplexity(dense_params, cfg, batches)
    ppl_quant = perplexity(quant_params, cfg, batches)
    return {
        "ppl_dense": ppl_dense,
        "ppl_quant": ppl_quant,
        "delta": ppl_quant - ppl_dense,
        "relative": (ppl_quant - ppl_dense) / ppl_dense,
    }
