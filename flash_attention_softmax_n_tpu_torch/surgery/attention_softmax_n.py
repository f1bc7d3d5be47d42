"""Apply softmax-N surgery to (config, params).

Counterpart of ``flash_attention_softmax_n_tpu/surgery/attention_softmax_n.py``.
The port's models read ``softmax_n`` from their config, so surgery is a
rewrite of (config, params) dispatched through the policy registry:
idempotent, and kept wherever the config is kept. ``from_pretrained_hf``
is the one-call migration: an HF model (or a stand-in with ``.config`` and
``.state_dict()``) in, softmax-N (config, params) on the device out.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Tuple

import torch

from flash_attention_softmax_n_tpu_torch.models.bert import BertConfig
from flash_attention_softmax_n_tpu_torch.models.decoder import DecoderConfig
from flash_attention_softmax_n_tpu_torch.models.xlnet import XLNetConfig
from flash_attention_softmax_n_tpu_torch.ops.relative_attention import (
    XLNetAttentionConfig,
)
from flash_attention_softmax_n_tpu_torch.surgery import convert
from flash_attention_softmax_n_tpu_torch.surgery.registry import policy_registry

log = logging.getLogger(__name__)

__all__ = [
    "apply_attention_softmax_n",
    "AttentionSoftmaxN",
    "from_pretrained_hf",
]


@policy_registry.register(BertConfig, "bert", "roberta")
def bert_attention_converter(config, params, softmax_n_param: float):
    """BERT/RoBERTa: every attention softmax becomes softmax-N."""
    return dataclasses.replace(config, softmax_n=softmax_n_param), params


@policy_registry.register(DecoderConfig, "llama", "mistral", "gpt")
def decoder_attention_converter(config, params, softmax_n_param: float):
    """Llama/GPT-style decoders: attention softmax-N."""
    return dataclasses.replace(config, softmax_n=softmax_n_param), params


@policy_registry.register(XLNetAttentionConfig, XLNetConfig, "xlnet")
def xlnet_attention_converter(config, params, softmax_n_param: float):
    """XLNet relative attention (the core's config and the whole model's):
    softmax-N in rel_attn_core."""
    return dataclasses.replace(config, softmax_n=softmax_n_param), params


def apply_attention_softmax_n(
    model: Tuple[object, Dict],
    softmax_n_param: Optional[float] = None,
) -> Tuple[object, Dict]:
    """Rewrite (config, params) so that every attention uses softmax-N.
    An architecture that is not registered is returned as it is, with a
    warning that lists the registered ones."""
    if softmax_n_param is None:
        raise ValueError("softmax_n_param is required")
    if softmax_n_param < 0:
        raise ValueError(f"softmax_n_param must be >= 0, got {softmax_n_param}")

    config, params = model
    fn = policy_registry.lookup(config)
    if fn is None:
        log.warning(
            "No softmax-N rewrite applied: architecture %r is not registered. "
            "Supported: %s", type(config).__name__,
            sorted(str(k) for k in policy_registry))
        return config, params
    new_config, new_params = fn(config, params, float(softmax_n_param))
    log.info("Applied softmax-N (n=%s) surgery to %s", softmax_n_param,
             type(config).__name__)
    return new_config, new_params


@dataclasses.dataclass
class AttentionSoftmaxN:
    """Algorithm-object form for a trainer: fires once at the 'init' event
    and rewrites the state's (config, params). The rewrite is idempotent, so
    applying it again when a checkpoint loads is safe."""

    softmax_n_param: float = 0.0

    def required_on_load(self) -> bool:
        return True

    def match(self, event: str, state) -> bool:
        return event == "init"

    def apply(self, event: str, state, logger=None) -> None:
        state.config, state.params = apply_attention_softmax_n(
            (state.config, state.params), self.softmax_n_param)


def from_pretrained_hf(hf_model, softmax_n_param: float = 0.0, dtype=None,
                       device=None) -> Tuple[object, Dict]:
    """An HF model's (config, params) under softmax-N surgery, on ``device``
    (the card when it is None).

    The architecture comes from ``hf_model.config.model_type`` (bert,
    roberta, llama, mistral, xlnet); ``dtype`` defaults to float32, bf16
    for the decoders.
    """
    model_type = getattr(hf_model.config, "model_type", None)
    if model_type in ("bert", "roberta"):
        cfg = convert.bert_config_from_hf(hf_model.config,
                                          dtype=dtype or torch.float32)
        params = convert.bert_params_from_hf(hf_model, cfg, device=device)
    elif model_type in ("llama", "mistral"):
        cfg = convert.llama_config_from_hf(hf_model.config,
                                           dtype=dtype or torch.bfloat16)
        params = convert.llama_params_from_hf(hf_model, cfg, device=device)
    elif model_type == "xlnet":
        cfg = convert.xlnet_config_from_hf(hf_model.config,
                                           dtype=dtype or torch.float32)
        params = convert.xlnet_params_from_hf(hf_model, cfg, device=device)
    else:
        raise ValueError(
            f"unsupported HF model_type {model_type!r}; supported: bert, "
            f"roberta, llama, mistral, xlnet")
    return apply_attention_softmax_n((cfg, params), softmax_n_param)
