"""XLNet with softmax-N two-stream relative attention.

Counterpart of ``flash_attention_softmax_n_tpu/models/xlnet.py``: HF
``XLNetModel``'s forward (eval and train) over layer weights stacked on axis
0, with the attention core of ``ops/relative_attention.py``, so that at
softmax_n = 0 it computes what HF does on converted weights
(``surgery.convert.xlnet_params_from_hf``):

* relative positional encoding (``attn_type`` bi or uni, ``bi_data``,
  ``clamp_len``, ``same_length``);
* segment attention (token_type_ids -> one-hot seg_mat; memory rows are
  segment 0);
* attention_mask XOR input_mask, and perm_mask, merged into the data mask;
  the content stream may attend to its own position, the query stream not;
* two-stream attention under target_mapping (the query stream starts from
  ``mask_emb``);
* mems, the Transformer-XL recurrence cache, with mem_len and reuse_len.

It runs sequence first inside, XLNet's own layout; the API is batch first
as HF's is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.models.decoder import layer_views
from flash_attention_softmax_n_tpu_torch.models.layers import (
    dropout,
    gelu,
    layer_norm,
)
from flash_attention_softmax_n_tpu_torch.ops.relative_attention import (
    xlnet_rel_attn_core_n,
)

__all__ = ["XLNetConfig", "init_xlnet_params", "xlnet_forward"]


@dataclasses.dataclass(frozen=True)
class XLNetConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_head: int = 64
    d_inner: int = 4096
    ff_activation: str = "gelu"
    attn_type: str = "bi"  # 'bi' (XLNet) or 'uni' (Transformer-XL style)
    bi_data: bool = False
    clamp_len: int = -1
    same_length: bool = False
    mem_len: Optional[int] = None
    reuse_len: Optional[int] = None
    softmax_n: float = 0.0
    layer_norm_eps: float = 1e-12
    dtype: Any = torch.float32
    model_type: str = "xlnet"
    # HF XLNetConfig.dropout: one rate at every dropout site (embeddings,
    # positional encoding, attention probabilities, the attention output
    # and both feed-forward layers), active only under train=True
    dropout: float = 0.0


def init_xlnet_params(cfg: XLNetConfig,
                      generator: Union[int, torch.Generator] = 0, *,
                      device=None) -> Dict:
    """Random-init parameter dict: N(0, 0.02) weights, LayerNorm ones and
    zeros, layer weights stacked on axis 0; the projections keep HF's
    (d_model, n_head, d_head) layout. ``generator`` is a ``torch.Generator``
    on ``device`` or an int seed for one."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    d, nh, dh, f, nl = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_inner,
                        cfg.n_layers)

    def w(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02
                ).to(cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "word_embedding": w(cfg.vocab_size, d),
        "mask_emb": w(1, 1, d),
        "layers": {
            "q": w(nl, d, nh, dh), "k": w(nl, d, nh, dh),
            "v": w(nl, d, nh, dh), "o": w(nl, d, nh, dh),
            "r": w(nl, d, nh, dh),
            "r_w_bias": w(nl, nh, dh), "r_r_bias": w(nl, nh, dh),
            "r_s_bias": w(nl, nh, dh), "seg_embed": w(nl, 2, nh, dh),
            "attn_ln_scale": ones(nl, d), "attn_ln_bias": zeros(nl, d),
            "ff1_w": w(nl, d, f), "ff1_b": zeros(nl, f),
            "ff2_w": w(nl, f, d), "ff2_b": zeros(nl, d),
            "ff_ln_scale": ones(nl, d), "ff_ln_bias": zeros(nl, d),
        },
    }


def _activation(cfg: XLNetConfig):
    if cfg.ff_activation == "gelu":
        return gelu
    if cfg.ff_activation == "relu":
        return torch.relu
    raise ValueError(f"unsupported ff_activation {cfg.ff_activation!r}")


def _positional_embedding(pos_seq, inv_freq, bsz: int) -> torch.Tensor:
    """(len(pos_seq), bsz, d_model) sinusoidal table (HF's layout)."""
    sinusoid = torch.einsum("i,d->id", pos_seq, inv_freq)
    pos_emb = torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1)
    return pos_emb[:, None, :].expand(pos_emb.shape[0], bsz, pos_emb.shape[1])


def _relative_positional_encoding(cfg: XLNetConfig, qlen: int, klen: int,
                                  bsz: int, device) -> torch.Tensor:
    """HF XLNetModel.relative_positional_encoding (before its dropout)."""
    freq_seq = torch.arange(0, cfg.d_model, 2.0, dtype=torch.float32,
                            device=device)
    inv_freq = 1.0 / torch.pow(10000.0, freq_seq / cfg.d_model)

    if cfg.attn_type == "bi":
        beg, end = klen, -qlen
    elif cfg.attn_type == "uni":
        beg, end = klen, -1
    else:
        raise ValueError(f"unknown attn_type {cfg.attn_type!r}")

    def seq(a, b, step):
        s = torch.arange(a, b, step, dtype=torch.float32, device=device)
        if cfg.clamp_len > 0:
            s = torch.clamp(s, -cfg.clamp_len, cfg.clamp_len)
        return s

    if cfg.bi_data:
        if bsz % 2 != 0:
            raise ValueError("bi_data requires an even batch size")
        return torch.cat(
            [_positional_embedding(seq(beg, end, -1.0), inv_freq, bsz // 2),
             _positional_embedding(seq(-beg, -end, 1.0), inv_freq, bsz // 2)],
            dim=1)
    return _positional_embedding(seq(beg, end, -1.0), inv_freq, bsz)


def _create_causal_mask(cfg: XLNetConfig, qlen: int, mlen: int,
                        device) -> torch.Tensor:
    """(qlen, qlen + mlen) float mask, 1 = masked (HF create_mask)."""
    mask = torch.ones((qlen, qlen + mlen), dtype=torch.float32,
                      device=device).triu(mlen + 1)
    if cfg.same_length:
        mask_lo = torch.ones((qlen, qlen), dtype=torch.float32,
                             device=device).tril(-1)
        mask[:, :qlen] += mask_lo
    return mask


def xlnet_forward(
    params: Dict,
    cfg: XLNetConfig,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    input_mask: Optional[torch.Tensor] = None,
    perm_mask: Optional[torch.Tensor] = None,
    target_mapping: Optional[torch.Tensor] = None,
    mems: Optional[torch.Tensor] = None,
    use_mems: bool = False,
    collect_taps: bool = False,
    head_mask: Optional[torch.Tensor] = None,
    output_attentions: bool = False,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Any:
    """HF-XLNetModel-compatible forward (batch first).

    input_ids (B, L); attention_mask (B, L), 1 = attend, XOR input_mask
    (B, L), 1 = masked; perm_mask (B, L, L), 1 = i may not attend to j;
    target_mapping (B, P, L), one-hot rows of the positions to predict (the
    query stream runs); mems (n_layers, mlen, B, d_model).

    Returns {'last_hidden_state': (B, L or P, D), 'mems': (n_layers, mlen',
    B, D) under ``use_mems``, else None}; mems are each layer's input,
    detached, as HF's ``cache_mem`` keeps them.

    * ``head_mask`` (n_layers, H) or (H,): a per-head gate after softmax;
    * ``output_attentions``: the result gains 'attentions' (n_layers, B, H,
      L, S), after dropout and head_mask, and under target_mapping
      'g_attentions' too;
    * ``train=True``: ``cfg.dropout`` at every HF dropout site, drawn from
      ``generator``;
    * ``collect_taps``: returns (result, taps), taps
      'layer.{i}.rel_attn.output' -> (B, L, D), the content stream after
      the attention output projection, residual and LayerNorm.
    """
    if attention_mask is not None and input_mask is not None:
        raise ValueError("use only one of input_mask and attention_mask")
    dp = cfg.dropout if train else 0.0
    if dp > 0.0 and generator is None:
        raise ValueError("train=True with cfg.dropout > 0 requires generator")
    dev = params["word_embedding"].device
    if head_mask is not None:
        head_mask = torch.as_tensor(head_mask, dtype=torch.float32, device=dev)
        if head_mask.ndim == 1:  # (H,) shared across layers
            head_mask = head_mask[None].expand(cfg.n_layers, cfg.n_heads)
        # per layer (1, 1, 1, H), against the probabilities' (i, j, b, n)
        head_mask = head_mask.reshape(cfg.n_layers, 1, 1, 1, cfg.n_heads)

    def drop(x):
        return dropout(x, dp, generator) if dp > 0.0 else x

    def seq_first(t, *perm):
        return None if t is None else torch.as_tensor(t, device=dev).permute(*perm)

    # batch first -> sequence first
    input_ids = seq_first(input_ids, 1, 0)
    qlen, bsz = input_ids.shape
    token_type_ids = seq_first(token_type_ids, 1, 0)
    if attention_mask is not None:
        input_mask = 1.0 - seq_first(attention_mask, 1, 0).float()
    elif input_mask is not None:
        input_mask = seq_first(input_mask, 1, 0).float()
    perm_mask = seq_first(perm_mask, 1, 2, 0)
    perm_mask = None if perm_mask is None else perm_mask.float()
    target_mapping = seq_first(target_mapping, 1, 2, 0)
    target_mapping = None if target_mapping is None else target_mapping.float()

    mlen = mems.shape[1] if mems is not None else 0

    # the attention masks, 1 = masked
    if cfg.attn_type == "uni":
        attn_mask = _create_causal_mask(cfg, qlen, mlen, dev)[:, :, None, None]
    elif cfg.attn_type == "bi":
        attn_mask = None
    else:
        raise ValueError(f"unsupported attn_type {cfg.attn_type!r}")

    if input_mask is not None and perm_mask is not None:
        data_mask = input_mask[None] + perm_mask
    elif input_mask is not None:
        data_mask = input_mask[None]
    else:
        data_mask = perm_mask

    if data_mask is not None:
        if mlen > 0:  # every memory row may be attended to
            mems_mask = torch.zeros((data_mask.shape[0], mlen, bsz),
                                    dtype=data_mask.dtype, device=dev)
            data_mask = torch.cat([mems_mask, data_mask], dim=1)
        add = data_mask[:, :, :, None]
        attn_mask = add if attn_mask is None else attn_mask + add

    non_tgt_mask = None
    if attn_mask is not None:
        attn_mask = (attn_mask > 0).float()
        # the content stream may attend to its own position, the query
        # stream may not: HF's non_tgt_mask against attn_mask
        non_tgt = -torch.eye(qlen, dtype=torch.float32, device=dev)
        if mlen > 0:
            non_tgt = torch.cat([torch.zeros((qlen, mlen), dtype=torch.float32,
                                             device=dev), non_tgt], dim=-1)
        non_tgt_mask = ((attn_mask + non_tgt[:, :, None, None]) > 0).float()

    # the two streams
    output_h = drop(params["word_embedding"][input_ids].to(cfg.dtype))
    output_g = None
    if target_mapping is not None:
        output_g = drop(params["mask_emb"].expand(
            target_mapping.shape[0], bsz, cfg.d_model).to(cfg.dtype))

    # the segment matrix
    seg_mat = None
    if token_type_ids is not None:
        cat_ids = token_type_ids
        if mlen > 0:  # memory rows are segment 0
            cat_ids = torch.cat([torch.zeros((mlen, bsz), dtype=token_type_ids.dtype,
                                             device=dev), token_type_ids], dim=0)
        seg = (token_type_ids[:, None] != cat_ids[None, :]).long()
        seg_mat = F.one_hot(seg, 2).float()

    pos_emb = drop(_relative_positional_encoding(cfg, qlen, mlen + qlen, bsz, dev)
                   .to(cfg.dtype))
    scale = 1.0 / (cfg.d_head ** 0.5)
    act = _activation(cfg)

    def cache_mem(curr_out, prev_mem):
        # HF XLNetModel.cache_mem: optionally cut to reuse_len, then keep
        # the last mem_len rows of [prev_mem; curr_out]
        if cfg.reuse_len is not None and cfg.reuse_len > 0:
            curr_out = curr_out[:cfg.reuse_len]
        cat = curr_out if prev_mem is None else torch.cat([prev_mem, curr_out], 0)
        if cfg.mem_len is not None and cfg.mem_len > 0:
            cat = cat[-cfg.mem_len:]
        return cat.detach()

    def post_attention(h, attn_vec, lp):
        # HF XLNetRelativeAttention.post_attention: dropout before residual
        attn_out = drop(torch.einsum("ibnd,hnd->ibh", attn_vec, lp["o"]))
        return layer_norm(attn_out + h, lp["attn_ln_scale"], lp["attn_ln_bias"],
                          cfg.layer_norm_eps)

    def ff(x, lp):
        # HF XLNetFeedForward: dropout after each layer
        out = drop(act(torch.einsum("ibh,hf->ibf", x, lp["ff1_w"]) + lp["ff1_b"]))
        out = drop(torch.einsum("ibf,fh->ibh", out, lp["ff2_w"]) + lp["ff2_b"])
        return layer_norm(out + x, lp["ff_ln_scale"], lp["ff_ln_bias"],
                          cfg.layer_norm_eps)

    new_mems, taps, probs_h, probs_g = [], [], [], []
    for i, lp in enumerate(layer_views(params["layers"])):
        mem = mems[i].to(dev, cfg.dtype) if mems is not None else None
        hm = head_mask[i] if head_mask is not None else None
        if use_mems:
            new_mems.append(cache_mem(output_h, mem))
        cat = torch.cat([mem, output_h], 0) if mlen > 0 else output_h
        k_head_h = torch.einsum("ibh,hnd->ibnd", cat, lp["k"])
        v_head_h = torch.einsum("ibh,hnd->ibnd", cat, lp["v"])
        k_head_r = torch.einsum("ibh,hnd->ibnd", pos_emb, lp["r"])

        def core(q_head, mask):
            out = xlnet_rel_attn_core_n(
                q_head, k_head_h, v_head_h, k_head_r,
                r_w_bias=lp["r_w_bias"], r_r_bias=lp["r_r_bias"],
                r_s_bias=lp["r_s_bias"], seg_embed=lp["seg_embed"],
                seg_mat=seg_mat, attn_mask=mask, scale=scale,
                softmax_n_param=cfg.softmax_n, head_mask=hm,
                dropout_p=dp, generator=generator,
                return_probs=output_attentions)
            return out if output_attentions else (out, None)

        q_head_h = torch.einsum("ibh,hnd->ibnd", output_h, lp["q"])
        attn_vec_h, p_h = core(q_head_h, non_tgt_mask)
        h_attn = post_attention(output_h, attn_vec_h, lp)
        output_h = ff(h_attn, lp)

        p_g = None
        if output_g is not None:
            q_head_g = torch.einsum("ibh,hnd->ibnd", output_g, lp["q"])
            if target_mapping is not None:
                q_head_g = torch.einsum("mbnd,mlb->lbnd", q_head_g,
                                        target_mapping)
                attn_vec_g, p_g = core(q_head_g, attn_mask)
                attn_vec_g = torch.einsum("lbnd,mlb->mbnd", attn_vec_g,
                                          target_mapping)
            else:
                attn_vec_g, p_g = core(q_head_g, attn_mask)
            output_g = ff(post_attention(output_g, attn_vec_g, lp), lp)
        if collect_taps:
            taps.append(h_attn.transpose(0, 1))
        probs_h.append(p_h)
        probs_g.append(p_g)

    output = output_g if output_g is not None else output_h
    result = {
        "last_hidden_state": output.transpose(0, 1),
        "mems": torch.stack(new_mems) if use_mems else None,
    }
    if output_attentions:
        # the core gives (i, j, b, n); HF's layout is (b, n, i, j)
        result["attentions"] = torch.stack(probs_h).permute(0, 3, 4, 1, 2)
        if output_g is not None:
            result["g_attentions"] = torch.stack(probs_g).permute(0, 3, 4, 1, 2)
    if collect_taps:
        return result, {f"layer.{i}.rel_attn.output": t
                        for i, t in enumerate(taps)}
    return result
