"""BERT-family encoder (and decoder) with softmax-N attention.

Counterpart of ``flash_attention_softmax_n_tpu/models/bert.py``: the
attention of HF ``BertSelfAttention`` with ``softmax_n`` in place of the
softmax, from ``cfg.softmax_n``, over layer weights stacked on axis 0 (the
JAX ``lax.scan`` over layers is a Python loop here). At softmax_n = 0 it
computes what HF ``BertModel`` does on converted weights
(``surgery.convert.bert_params_from_hf``).

Matmuls go through the decoder's ``_mm``, so quantized weights route as in
JAX: int8 to ``x @ dequantize(w)``, grouped int4 with K % 256 == 0 to the
dequant matmul K7 (its f32 mode for an f32 model), fp8 inline. Attention
materializes its (B, H, L, S) scores in float32, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.models.decoder import _mm, layer_views
from flash_attention_softmax_n_tpu_torch.models.layers import (
    dropout,
    gelu,
    layer_norm,
)
from flash_attention_softmax_n_tpu_torch.ops.functional import softmax_n

__all__ = ["BertConfig", "init_bert_params", "init_bert_kv_cache",
           "bert_forward"]

RELATIVE = ("relative_key", "relative_key_query")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    softmax_n: float = 0.0
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.float32
    # decoder mode: causal self-attention, and a cross-attention block per
    # layer under add_cross_attention
    is_decoder: bool = False
    add_cross_attention: bool = False
    # HF attention_probs_dropout_prob and hidden_dropout_prob, active only
    # under bert_forward(train=True)
    attn_dropout: float = 0.0
    hidden_dropout: float = 0.0
    # 'absolute' | 'relative_key' | 'relative_key_query' (HF BERT): the
    # relative modes add a learned per-layer distance embedding's scores
    position_embedding_type: str = "absolute"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_bert_params(cfg: BertConfig,
                     generator: Union[int, torch.Generator] = 0, *,
                     device=None) -> Dict:
    """Random-init parameter dict: N(0, 0.02) weights, LayerNorm ones and
    zeros, zero biases, layer weights stacked on axis 0.

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed for
    one. The numbers differ from ``jax.random``'s; tests carry JAX's
    parameters across with ``params_from_jax`` instead.
    """
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.n_layers

    def w(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02
                ).to(cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {
        "q_w": w(nl, d, d), "q_b": zeros(nl, d),
        "k_w": w(nl, d, d), "k_b": zeros(nl, d),
        "v_w": w(nl, d, d), "v_b": zeros(nl, d),
        "attn_out_w": w(nl, d, d), "attn_out_b": zeros(nl, d),
        "attn_ln_scale": ones(nl, d), "attn_ln_bias": zeros(nl, d),
        "inter_w": w(nl, d, f), "inter_b": zeros(nl, f),
        "out_w": w(nl, f, d), "out_b": zeros(nl, d),
        "out_ln_scale": ones(nl, d), "out_ln_bias": zeros(nl, d),
    }
    if cfg.position_embedding_type in RELATIVE:
        # HF BertSelfAttention.distance_embedding, one a layer
        layers["distance_emb"] = w(nl, 2 * cfg.max_position_embeddings - 1,
                                   cfg.head_dim)
    if cfg.add_cross_attention:
        for p in ("cross_q", "cross_k", "cross_v", "cross_out"):
            layers[p + "_w"] = w(nl, d, d)
            layers[p + "_b"] = zeros(nl, d)
        layers["cross_ln_scale"] = ones(nl, d)
        layers["cross_ln_bias"] = zeros(nl, d)
    return {
        "embeddings": {
            "word": w(cfg.vocab_size, d),
            "position": w(cfg.max_position_embeddings, d),
            "token_type": w(cfg.type_vocab_size, d),
            "ln_scale": ones(d),
            "ln_bias": zeros(d),
        },
        "layers": layers,
        "pooler": {"w": w(d, d), "b": zeros(d)},
    }


def init_bert_kv_cache(cfg: BertConfig, batch: int,
                       max_len: Optional[int] = None, *, device=None) -> Dict:
    """Preallocated self-attention KV cache for decoder-mode BERT:
    (n_layers, B, H, S, hd) tensors, written in place by ``bert_forward``,
    and ``length``, a host int."""
    dev = resolve_device(device)
    s = max_len or cfg.max_position_embeddings
    shape = (cfg.n_layers, batch, cfg.n_heads, s, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "length": 0}


def _heads(x: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.reshape(b, l, nh, hd).transpose(1, 2)


def _attend(cfg: BertConfig, q, k, v, bias, *, rel_scores=None,
            head_mask=None, dp: float = 0.0, generator=None):
    """(B,H,L,hd) x (B,H,S,hd) softmax-N attention -> ((B, L, D), probs),
    in HF's order: (scores + relative) / sqrt(hd), + mask, softmax_n,
    dropout, head_mask. The probabilities returned are those after dropout
    and head_mask, as HF's output_attentions gives them."""
    b, nh, l, hd = q.shape
    scores = torch.einsum("bhle,bhse->bhls", q.float(), k.float())
    if rel_scores is not None:
        scores = scores + rel_scores
    scores = scores * hd ** -0.5
    if bias is not None:
        scores = scores + bias
    probs = softmax_n(scores, n=cfg.softmax_n, axis=-1)
    if dp > 0.0:
        probs = dropout(probs, dp, generator)
    if head_mask is not None:
        probs = probs * head_mask
    ctx = torch.einsum("bhls,bhsv->bhlv", probs.to(v.dtype), v)
    return ctx.transpose(1, 2).reshape(b, l, nh * hd), probs


def _relative_scores(cfg: BertConfig, q, k, distance_emb, q_positions):
    """HF relative_key(-query) scores, added before the 1/sqrt(hd) scale;
    ``q_positions`` are the queries' absolute positions (past + arange(L)
    under a cache)."""
    s = k.shape[2]
    idx = (q_positions[:, None] - torch.arange(s, device=q.device)[None, :]
           + cfg.max_position_embeddings - 1)
    emb = distance_emb[idx].to(q.dtype).float()  # (L, S, hd)
    scores = torch.einsum("bhld,lrd->bhlr", q.float(), emb)
    if cfg.position_embedding_type == "relative_key_query":
        scores = scores + torch.einsum("bhrd,lrd->bhlr", k.float(), emb)
    return scores


def bert_forward(
    params: Dict,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    *,
    encoder_hidden_states: Optional[torch.Tensor] = None,
    encoder_attention_mask: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
    collect_taps: bool = False,
    head_mask: Optional[torch.Tensor] = None,
    output_attentions: bool = False,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Any:
    """HF-BertModel-compatible forward (encoder and decoder modes).

    input_ids (B, L); attention_mask (B, L), 1 = attend, becomes HF's
    additive ``(1 - mask) * finfo(float32).min`` over the keys. Returns
    {'last_hidden_state' (B, L, D), 'pooler_output' (B, D)}.

    * ``cfg.is_decoder``: causal self-attention; ``encoder_hidden_states``
      (B, S_enc, D) with ``encoder_attention_mask`` (B, S_enc): a
      cross-attention block in each layer (``cfg.add_cross_attention``).
    * ``cache`` (``init_bert_kv_cache``): the L new tokens' keys and values
      are written in place at ``cache['length']`` and self-attention spans
      the cached prefix; sequences are dense and left-aligned, so
      ``attention_mask`` must be None. The result gains 'cache' (the same
      dict, its length advanced).
    * ``train=True`` activates ``cfg.attn_dropout`` (attention
      probabilities) and ``cfg.hidden_dropout`` (embeddings and each dense
      output before its residual), drawn from ``generator``.
    * ``head_mask`` (n_layers, H) or (H,): a per-head gate after dropout,
      also on cross-attention.
    * ``output_attentions``: the result gains 'attentions' (n_layers, B, H,
      L, S), and 'cross_attentions' under cross-attention.
    * ``collect_taps``: returns (result, taps), taps
      'encoder.layer.{i}.attention.output' -> (B, L, D), each layer's
      attention output projection.
    """
    b, l = input_ids.shape
    emb = params["embeddings"]
    dev = emb["word"].device
    input_ids = input_ids.to(dev)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    token_type_ids = token_type_ids.to(dev)
    if cache is not None and attention_mask is not None:
        raise ValueError(
            "cached decoding tracks validity via cache['length']; pass "
            "dense left-aligned sequences with attention_mask=None")
    attn_dp = cfg.attn_dropout if train else 0.0
    hidden_dp = cfg.hidden_dropout if train else 0.0
    if (attn_dp > 0.0 or hidden_dp > 0.0) and generator is None:
        raise ValueError("train=True with dropout > 0 requires generator")
    if head_mask is not None:
        head_mask = torch.as_tensor(head_mask, device=dev)
        if head_mask.ndim == 1:  # (H,) shared across layers
            head_mask = head_mask[None].expand(cfg.n_layers, cfg.n_heads)
        head_mask = head_mask.reshape(cfg.n_layers, 1, cfg.n_heads, 1, 1)

    def hidden_drop(x):
        return dropout(x, hidden_dp, generator) if hidden_dp > 0.0 else x

    past = cache["length"] if cache is not None else 0
    positions = past + torch.arange(l, device=dev)
    x = emb["word"][input_ids] + emb["token_type"][token_type_ids]
    if cfg.position_embedding_type == "absolute":
        # relative modes score distance inside attention instead
        x = x + emb["position"][positions][None]
    x = hidden_drop(layer_norm(x, emb["ln_scale"], emb["ln_bias"],
                               cfg.layer_norm_eps))

    neg = torch.finfo(torch.float32).min
    nh, hd = cfg.n_heads, cfg.head_dim

    # the self-attention bias over the key axis
    if cache is not None:
        key_pos = torch.arange(cache["k"].shape[3], device=dev)
        valid = key_pos[None, :] < past + l
        if cfg.is_decoder:
            valid = valid & (key_pos[None, :] <= positions[:, None])
        bias = torch.where(valid, 0.0, neg)[None, None]
    else:
        bias = None
        if cfg.is_decoder:
            causal = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
            bias = torch.where(causal, 0.0, neg)[None, None]
        if attention_mask is not None:
            pad = (1.0 - torch.as_tensor(attention_mask, device=dev)
                   .float()[:, None, None, :]) * neg
            bias = pad if bias is None else bias + pad

    cross_bias = None
    if encoder_hidden_states is not None:
        encoder_hidden_states = encoder_hidden_states.to(dev)
        if encoder_attention_mask is not None:
            cross_bias = (1.0 - torch.as_tensor(encoder_attention_mask, device=dev)
                          .float()[:, None, None, :]) * neg

    taps, probs_all, cross_all = [], [], []
    for i, lp in enumerate(layer_views(params["layers"])):
        hm = head_mask[i] if head_mask is not None else None
        q = _heads(_mm(x, lp["q_w"]) + lp["q_b"], nh, hd)
        k = _heads(_mm(x, lp["k_w"]) + lp["k_b"], nh, hd)
        v = _heads(_mm(x, lp["v_w"]) + lp["v_b"], nh, hd)
        if cache is not None:
            cache["k"][i, :, :, past:past + l] = k.to(cache["k"].dtype)
            cache["v"][i, :, :, past:past + l] = v.to(cache["v"].dtype)
            k, v = cache["k"][i], cache["v"][i]
        rel = (_relative_scores(cfg, q, k, lp["distance_emb"], positions)
               if cfg.position_embedding_type in RELATIVE else None)
        ctx, probs = _attend(cfg, q, k, v, bias, rel_scores=rel, head_mask=hm,
                             dp=attn_dp, generator=generator)
        attn_out = hidden_drop(_mm(ctx, lp["attn_out_w"]) + lp["attn_out_b"])
        x = layer_norm(attn_out + x, lp["attn_ln_scale"], lp["attn_ln_bias"],
                       cfg.layer_norm_eps)
        if encoder_hidden_states is not None:
            cq = _heads(_mm(x, lp["cross_q_w"]) + lp["cross_q_b"], nh, hd)
            ck = _heads(_mm(encoder_hidden_states, lp["cross_k_w"])
                        + lp["cross_k_b"], nh, hd)
            cv = _heads(_mm(encoder_hidden_states, lp["cross_v_w"])
                        + lp["cross_v_b"], nh, hd)
            cctx, cprobs = _attend(cfg, cq, ck, cv, cross_bias, head_mask=hm,
                                   dp=attn_dp, generator=generator)
            cross_all.append(cprobs)
            cross_out = hidden_drop(_mm(cctx, lp["cross_out_w"])
                                    + lp["cross_out_b"])
            x = layer_norm(cross_out + x, lp["cross_ln_scale"],
                           lp["cross_ln_bias"], cfg.layer_norm_eps)
        inter = gelu(_mm(x, lp["inter_w"]) + lp["inter_b"])
        out = hidden_drop(_mm(inter, lp["out_w"]) + lp["out_b"])
        x = layer_norm(out + x, lp["out_ln_scale"], lp["out_ln_bias"],
                       cfg.layer_norm_eps)
        if collect_taps:
            taps.append(attn_out)
        if output_attentions:
            probs_all.append(probs)

    pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"] + params["pooler"]["b"])
    result = {"last_hidden_state": x, "pooler_output": pooled}
    if cache is not None:
        cache["length"] = past + l
        result["cache"] = cache
    if output_attentions:
        result["attentions"] = torch.stack(probs_all)
        if encoder_hidden_states is not None:
            result["cross_attentions"] = torch.stack(cross_all)
    if collect_taps:
        return result, {f"encoder.layer.{i}.attention.output": t
                        for i, t in enumerate(taps)}
    return result
