"""HF checkpoints -> the port's parameter dicts (the surgery substrate).

Counterpart of ``flash_attention_softmax_n_tpu/surgery/convert.py``: maps
the state dicts of HF BERT/RoBERTa encoders, Llama-style decoders and XLNet
into the port's stacked-layer parameter dicts, after which
``apply_attention_softmax_n`` sets softmax-N in the config. Each converter
takes an HF model (anything with ``state_dict()``) or a state dict of
tensors, and puts its parameters on ``device`` (the card when it is None).
Configs are read by attribute only, so any object with HF's attribute
names serves; nothing here imports ``transformers``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.models.bert import RELATIVE, BertConfig
from flash_attention_softmax_n_tpu_torch.models.decoder import DecoderConfig
from flash_attention_softmax_n_tpu_torch.models.xlnet import XLNetConfig

__all__ = [
    "bert_config_from_hf",
    "bert_params_from_hf",
    "llama_config_from_hf",
    "llama_params_from_hf",
    "xlnet_config_from_hf",
    "xlnet_params_from_hf",
]


def _state_dict(model_or_sd) -> Dict[str, Any]:
    if hasattr(model_or_sd, "state_dict"):
        return model_or_sd.state_dict()
    return dict(model_or_sd)


def _strip_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):] if k.startswith(prefix) else k: v
                for k, v in sd.items()}
    return sd


class _Reader:
    """Reads a state dict's tensors as float32 on ``device`` (as the JAX
    package reads them into float32 numpy), then casts to ``dtype``."""

    def __init__(self, sd, n_layers: int, dtype, device):
        self.sd, self.n_layers, self.dtype = sd, n_layers, dtype
        self.dev = resolve_device(device)

    def f32(self, name: str) -> torch.Tensor:
        return torch.as_tensor(self.sd[name]).detach().to(self.dev, torch.float32)

    def get(self, name: str, transpose: bool = False) -> torch.Tensor:
        a = self.f32(name)
        return (a.T if transpose else a).contiguous().to(self.dtype)

    def stack(self, fmt: str, transpose: bool = False) -> torch.Tensor:
        arrs = [self.f32(fmt.format(i=i)) for i in range(self.n_layers)]
        return torch.stack([a.T if transpose else a for a in arrs]).to(self.dtype)


# ----------------------------------------------------------------------------
# BERT / RoBERTa
# ----------------------------------------------------------------------------


def bert_config_from_hf(hf_config, softmax_n: float = 0.0,
                        dtype=torch.float32) -> BertConfig:
    return BertConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        d_ff=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        softmax_n=softmax_n,
        dtype=dtype,
        is_decoder=getattr(hf_config, "is_decoder", False),
        add_cross_attention=getattr(hf_config, "add_cross_attention", False),
        attn_dropout=getattr(hf_config, "attention_probs_dropout_prob", 0.0),
        hidden_dropout=getattr(hf_config, "hidden_dropout_prob", 0.0),
        position_embedding_type=getattr(hf_config, "position_embedding_type",
                                        "absolute"),
    )


def bert_params_from_hf(model_or_sd, cfg: BertConfig, *, device=None) -> Dict:
    """HF BertModel/RobertaModel state dict -> stacked-layer parameters;
    Linear weights (out, in) are transposed to (in, out)."""
    sd = _strip_prefix(_strip_prefix(_state_dict(model_or_sd), "bert."),
                       "roberta.")
    r = _Reader(sd, cfg.n_layers, cfg.dtype, device)
    p = "encoder.layer.{i}."

    def dense(prefix: str, hf: str) -> Dict[str, torch.Tensor]:
        return {prefix + "_w": r.stack(p + hf + ".weight", transpose=True),
                prefix + "_b": r.stack(p + hf + ".bias")}

    def norm(prefix: str, hf: str) -> Dict[str, torch.Tensor]:
        return {prefix + "_ln_scale": r.stack(p + hf + ".LayerNorm.weight"),
                prefix + "_ln_bias": r.stack(p + hf + ".LayerNorm.bias")}

    layers = {
        **dense("q", "attention.self.query"),
        **dense("k", "attention.self.key"),
        **dense("v", "attention.self.value"),
        **dense("attn_out", "attention.output.dense"),
        **norm("attn", "attention.output"),
        **dense("inter", "intermediate.dense"),
        **dense("out", "output.dense"),
        **norm("out", "output"),
    }
    if cfg.position_embedding_type in RELATIVE:
        layers["distance_emb"] = r.stack(
            p + "attention.self.distance_embedding.weight")
    if cfg.add_cross_attention:
        layers.update({
            **dense("cross_q", "crossattention.self.query"),
            **dense("cross_k", "crossattention.self.key"),
            **dense("cross_v", "crossattention.self.value"),
            **dense("cross_out", "crossattention.output.dense"),
            **norm("cross", "crossattention.output"),
        })
    return {
        "embeddings": {
            "word": r.get("embeddings.word_embeddings.weight"),
            "position": r.get("embeddings.position_embeddings.weight"),
            "token_type": r.get("embeddings.token_type_embeddings.weight"),
            "ln_scale": r.get("embeddings.LayerNorm.weight"),
            "ln_bias": r.get("embeddings.LayerNorm.bias"),
        },
        "layers": layers,
        "pooler": {"w": r.get("pooler.dense.weight", transpose=True),
                   "b": r.get("pooler.dense.bias")},
    }


# ----------------------------------------------------------------------------
# Llama
# ----------------------------------------------------------------------------


def llama_config_from_hf(hf_config, softmax_n: float = 0.0,
                         dtype=torch.bfloat16) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=hf_config.rms_norm_eps,
        softmax_n=softmax_n,
        dtype=dtype,
    )


def llama_params_from_hf(model_or_sd, cfg: DecoderConfig, *, device=None) -> Dict:
    """HF LlamaForCausalLM state dict -> the port's decoder parameters; a
    model without ``lm_head.weight`` ties it to the embedding."""
    sd = _strip_prefix(_state_dict(model_or_sd), "model.")
    r = _Reader(sd, cfg.n_layers, cfg.dtype, device)
    embed = r.get("embed_tokens.weight")
    lm_head = (r.get("lm_head.weight", transpose=True) if "lm_head.weight" in sd
               else embed.T.contiguous())
    p = "layers.{i}."
    return {
        "embed": embed,
        "layers": {
            "attn_norm": r.stack(p + "input_layernorm.weight"),
            "wq": r.stack(p + "self_attn.q_proj.weight", transpose=True),
            "wk": r.stack(p + "self_attn.k_proj.weight", transpose=True),
            "wv": r.stack(p + "self_attn.v_proj.weight", transpose=True),
            "wo": r.stack(p + "self_attn.o_proj.weight", transpose=True),
            "mlp_norm": r.stack(p + "post_attention_layernorm.weight"),
            "w_gate": r.stack(p + "mlp.gate_proj.weight", transpose=True),
            "w_up": r.stack(p + "mlp.up_proj.weight", transpose=True),
            "w_down": r.stack(p + "mlp.down_proj.weight", transpose=True),
        },
        "final_norm": r.get("norm.weight"),
        "lm_head": lm_head,
    }


# ----------------------------------------------------------------------------
# XLNet
# ----------------------------------------------------------------------------


def xlnet_config_from_hf(hf_config, softmax_n: float = 0.0,
                         dtype=torch.float32) -> XLNetConfig:
    return XLNetConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.d_model,
        n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head,
        d_head=hf_config.d_head,
        d_inner=hf_config.d_inner,
        ff_activation=hf_config.ff_activation,
        attn_type=hf_config.attn_type,
        bi_data=hf_config.bi_data,
        clamp_len=hf_config.clamp_len,
        same_length=hf_config.same_length,
        mem_len=hf_config.mem_len,
        reuse_len=hf_config.reuse_len,
        layer_norm_eps=hf_config.layer_norm_eps,
        softmax_n=softmax_n,
        dtype=dtype,
        dropout=getattr(hf_config, "dropout", 0.0),
    )


def xlnet_params_from_hf(model_or_sd, cfg: XLNetConfig, *, device=None) -> Dict:
    """HF XLNetModel/XLNetLMHeadModel state dict -> stacked-layer
    parameters. XLNet's projections are already (d_model, n_head, d_head)
    tensors; only the feed-forward Linears are transposed."""
    sd = _strip_prefix(_state_dict(model_or_sd), "transformer.")
    r = _Reader(sd, cfg.n_layers, cfg.dtype, device)
    p = "layer.{i}."
    layers = {name: r.stack(p + "rel_attn." + name)
              for name in ("q", "k", "v", "o", "r", "r_w_bias", "r_r_bias",
                           "r_s_bias", "seg_embed")}
    layers.update({
        "attn_ln_scale": r.stack(p + "rel_attn.layer_norm.weight"),
        "attn_ln_bias": r.stack(p + "rel_attn.layer_norm.bias"),
        "ff1_w": r.stack(p + "ff.layer_1.weight", transpose=True),
        "ff1_b": r.stack(p + "ff.layer_1.bias"),
        "ff2_w": r.stack(p + "ff.layer_2.weight", transpose=True),
        "ff2_b": r.stack(p + "ff.layer_2.bias"),
        "ff_ln_scale": r.stack(p + "ff.layer_norm.weight"),
        "ff_ln_bias": r.stack(p + "ff.layer_norm.bias"),
    })
    return {
        "word_embedding": r.get("word_embedding.weight"),
        "mask_emb": r.get("mask_emb"),
        "layers": layers,
    }
