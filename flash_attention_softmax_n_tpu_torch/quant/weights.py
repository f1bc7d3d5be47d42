"""Weight-only int8 / int4 / fp8 quantization of decoder and BERT parameter
dictionaries, and the fusion of the q/k/v and gate/up projections.

Counterpart of ``flash_attention_softmax_n_tpu/quant/weights.py``: stacked
(n_layers, K, N) matmul weights get per-output-channel (..., 1, N) scales;
embeddings stay full precision.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor, quantize

__all__ = ["DECODER_MATMUL_WEIGHTS", "BERT_MATMUL_WEIGHTS",
           "fuse_decoder_projections", "quantize_decoder_weights",
           "quantize_bert_weights"]

DECODER_MATMUL_WEIGHTS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "wqkv", "w_gu",
)

# the cross-attention projections exist only under add_cross_attention
BERT_MATMUL_WEIGHTS = (
    "q_w", "k_w", "v_w", "attn_out_w", "inter_w", "out_w",
    "cross_q_w", "cross_k_w", "cross_v_w", "cross_out_w",
)


def fuse_decoder_projections(params: Dict) -> Dict:
    """Concatenate wq/wk/wv into ``wqkv`` and w_gate/w_up into ``w_gu``
    along the output axis (before quantization: per-output-channel scales
    are unaffected). ``models.decoder._layer`` splits the fused outputs.
    Fewer, wider matmuls per layer: 4 instead of 7."""
    layers = dict(params["layers"])
    layers["wqkv"] = torch.cat(
        [layers.pop("wq"), layers.pop("wk"), layers.pop("wv")], dim=-1)
    layers["w_gu"] = torch.cat(
        [layers.pop("w_gate"), layers.pop("w_up")], dim=-1)
    return dict(params, layers=layers)


def _quantize_leaf(w, bits: int) -> QTensor:
    return quantize(w, bits=bits, axis=-2)


def quantize_decoder_weights(params: Dict, bits: int = 8,
                             include: Optional[Iterable[str]] = None,
                             quantize_lm_head: bool = True) -> Dict:
    """Quantize decoder matmul weights to ``bits`` (8; 4 packed along the
    contraction axis; -8 for fp8 e4m3); ``include``: a subset of names."""
    names = set(include) if include is not None else set(DECODER_MATMUL_WEIGHTS)
    out = {
        "embed": params["embed"],
        "layers": {
            k: (_quantize_leaf(v, bits) if k in names else v)
            for k, v in params["layers"].items()
        },
        "final_norm": params["final_norm"],
    }
    if "lm_head" in params:
        out["lm_head"] = (_quantize_leaf(params["lm_head"], bits)
                          if quantize_lm_head else params["lm_head"])
    return out


def quantize_bert_weights(params: Dict, bits: int = 8,
                          include: Optional[Iterable[str]] = None) -> Dict:
    """Quantize the stacked BERT layer matmul weights to ``bits``
    (``include``: a subset of ``BERT_MATMUL_WEIGHTS``); embeddings and the
    pooler stay as they are."""
    names = set(include) if include is not None else set(BERT_MATMUL_WEIGHTS)
    out = dict(params)
    out["layers"] = {
        k: (_quantize_leaf(v, bits) if k in names else v)
        for k, v in params["layers"].items()
    }
    return out
