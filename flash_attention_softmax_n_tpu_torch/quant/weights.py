"""Weight-only int8 / int4 quantization of decoder parameter dictionaries.

Counterpart of ``quantize_decoder_weights`` in
``flash_attention_softmax_n_tpu/quant/weights.py``: stacked (n_layers, K, N)
matmul weights get per-output-channel (..., 1, N) scales; embeddings stay
full precision.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor, quantize

__all__ = ["DECODER_MATMUL_WEIGHTS", "quantize_decoder_weights"]

DECODER_MATMUL_WEIGHTS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "wqkv", "w_gu",
)


def _quantize_leaf(w, bits: int) -> QTensor:
    return quantize(w, bits=bits, axis=-2)


def quantize_decoder_weights(params: Dict, bits: int = 8,
                             include: Optional[Iterable[str]] = None,
                             quantize_lm_head: bool = True) -> Dict:
    """Quantize decoder matmul weights to ``bits`` (8, or 4 packed along
    the contraction axis); ``include``: a subset of names."""
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
