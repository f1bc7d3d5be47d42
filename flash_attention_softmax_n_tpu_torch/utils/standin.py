"""Stand-ins for HF models, built offline from a config and a seed.

The surgery converters (``surgery.from_pretrained_hf``) read an HF model's
``config`` by attribute and its tensors through ``state_dict()``, nothing
else. A ``StandIn`` gives them both without ``transformers`` and without a
download: the config's attributes under HF's names, and a state dict under
HF's tensor names drawn from a ``torch.Generator`` (N(0, 0.02) weights, as
HF initializes them; zero biases, norm scales of one).

  * ``bert_state_dict``: ``BertModel``'s tensors;
  * ``xlnet_state_dict``: ``XLNetModel``'s;
  * ``llama_state_dict``: ``LlamaForCausalLM``'s;
  * ``standin(config, generator, device)``: the stand-in of ``config``'s
    ``model_type`` (bert, xlnet or llama).
"""

from __future__ import annotations

import types
from typing import Dict

import torch

from flash_attention_softmax_n_tpu_torch._device import resolve_device

__all__ = ["StandIn", "bert_state_dict", "xlnet_state_dict", "llama_state_dict",
           "standin"]

INIT_STD = 0.02


class StandIn:
    """An HF model's stand-in: ``.config`` with HF's attribute names and
    ``.state_dict()``."""

    def __init__(self, config: Dict, sd: Dict[str, torch.Tensor]):
        self.config = types.SimpleNamespace(**config)
        self._sd = sd

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self._sd


def _draws(generator, device):
    def w(*shape):
        return torch.randn(shape, generator=generator, device=device) * INIT_STD

    def z(*shape):
        return torch.zeros(shape, device=device)

    def one(*shape):
        return torch.ones(shape, device=device)

    return w, z, one


def bert_state_dict(c: Dict, generator: torch.Generator, device=None):
    """HF BertModel-named tensors: N(0, 0.02) weights, zero biases,
    LayerNorm ones and zeros."""
    d, f = c["hidden_size"], c["intermediate_size"]
    w, z, one = _draws(generator, resolve_device(device))
    sd = {"embeddings.word_embeddings.weight": w(c["vocab_size"], d),
          "embeddings.position_embeddings.weight": w(c["max_position_embeddings"], d),
          "embeddings.token_type_embeddings.weight": w(c["type_vocab_size"], d),
          "embeddings.LayerNorm.weight": one(d),
          "embeddings.LayerNorm.bias": z(d),
          "pooler.dense.weight": w(d, d), "pooler.dense.bias": z(d)}
    for i in range(c["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (d, d), "attention.self.key": (d, d),
                             "attention.self.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (f, d), "output.dense": (d, f)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = w(o, n), z(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = one(d), z(d)
    return sd


def xlnet_state_dict(c: Dict, generator: torch.Generator, device=None):
    """HF XLNetModel-named tensors, as ``bert_state_dict``."""
    d, nh, dh, f = c["d_model"], c["n_head"], c["d_head"], c["d_inner"]
    w, z, one = _draws(generator, resolve_device(device))
    sd = {"word_embedding.weight": w(c["vocab_size"], d), "mask_emb": w(1, 1, d)}
    for i in range(c["n_layer"]):
        p = f"layer.{i}."
        for name in "qkvor":
            sd[p + "rel_attn." + name] = w(d, nh, dh)
        for name in ("r_w_bias", "r_r_bias", "r_s_bias"):
            sd[p + "rel_attn." + name] = w(nh, dh)
        sd[p + "rel_attn.seg_embed"] = w(2, nh, dh)
        for name in ("rel_attn.layer_norm", "ff.layer_norm"):
            sd[p + name + ".weight"] = one(d)
            sd[p + name + ".bias"] = z(d)
        sd[p + "ff.layer_1.weight"], sd[p + "ff.layer_1.bias"] = w(f, d), z(f)
        sd[p + "ff.layer_2.weight"], sd[p + "ff.layer_2.bias"] = w(d, f), z(d)
    return sd


def llama_state_dict(c: Dict, generator: torch.Generator, device=None):
    """HF LlamaForCausalLM-named tensors: N(0, 0.02) projections,
    embedding and lm_head, RMSNorm scales of one."""
    d, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hd = d // c["num_attention_heads"]
    kvd = c.get("num_key_value_heads", c["num_attention_heads"]) * hd
    w, _, one = _draws(generator, resolve_device(device))
    sd = {"model.embed_tokens.weight": w(v, d)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (d, d)), ("self_attn.k_proj", (kvd, d)),
                            ("self_attn.v_proj", (kvd, d)), ("self_attn.o_proj", (d, d)),
                            ("mlp.gate_proj", (f, d)), ("mlp.up_proj", (f, d)),
                            ("mlp.down_proj", (d, f))):
            sd[p + name + ".weight"] = w(*shape)
        sd[p + "input_layernorm.weight"] = one(d)
        sd[p + "post_attention_layernorm.weight"] = one(d)
    sd["model.norm.weight"] = one(d)
    sd["lm_head.weight"] = w(v, d)
    return sd


_STATE_DICTS = {"bert": bert_state_dict, "xlnet": xlnet_state_dict,
                "llama": llama_state_dict}


def standin(config: Dict, generator: torch.Generator, device=None) -> StandIn:
    """The stand-in of an HF config (a dict of its attributes, with
    ``model_type`` bert, xlnet or llama) with tensors from ``generator``."""
    make = _STATE_DICTS.get(config.get("model_type"))
    if make is None:
        raise ValueError(f"no stand-in for model_type {config.get('model_type')!r}; "
                         f"have {sorted(_STATE_DICTS)}")
    return StandIn(config, make(config, generator, device))
