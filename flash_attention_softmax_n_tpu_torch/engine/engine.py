"""Continuous-batching inference engine for softmax-N decoders.

Counterpart of the serving core of
``flash_attention_softmax_n_tpu/engine/engine.py``:

  * a fixed pool of ``max_batch`` slots sharing one preallocated KV cache
    (dense, int8 or fp8), with per-slot lengths on the device;
  * admission by batched prefill of same-bucket prompts (kernel K1);
    prompts longer than ``prefill_chunk`` prefill chunk by chunk, each
    chunk attending the rows already cached (``engine_prefill_chunk``);
    registered prefixes (``register_prefix``) are prefilled once into a
    store whose rows a matching prompt copies into its slot, prefilling
    only its suffix;
  * decode either one step at a time (``engine_decode``: the new rows go
    into the cache by kernel K3) or in fused chunks of ``num_steps`` steps
    (``engine_decode_loop``): the steps stay on the device, new rows go to
    a bf16 ring by kernel K4 (K3 into the cache below 8 steps), greedy
    tokens come from the lm_head kernel K2, and one flush per chunk moves
    the ring into the cache. The host syncs once per chunk;
  * piggybacked prefill: short queued prompts ride a chunk's decode steps
    in slices, their rows in the same matmul operand as the decode rows;
  * on CUDA each greedy chunk replays a CUDA graph of its loop variant
    (``InferenceEngine.prewarm``);
  * ``cfg.int8_mm_impl="pallas"`` takes the int8 matmuls to kernel K7 and
    the decode MLP to K9 (models/decoder.py), and
    ``cfg.decode_attn_impl="pallas"`` the decode attention to K8, which
    reads only each slot's valid cache rows;
  * tensor/data-parallel serving over a mesh (``mesh=``, see
    ``parallel/serving.py``): one process per rank, each holding its
    slots' cache rows over ``"data"`` and its KV heads and weight shards
    over ``"model"``; the host scheduler runs alike on every rank.

The request queue and slot bookkeeping are host-side Python. JAX's
functional updates become in-place writes into the engine's tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.kernels import _build
from flash_attention_softmax_n_tpu_torch.kernels.cache_update import (
    cache_append,
    tail_append,
)
from flash_attention_softmax_n_tpu_torch.kernels.decode_attention import (
    decode_attention_n,
)
from flash_attention_softmax_n_tpu_torch.kernels.quant_matmul import (
    quantized_matmul_argmax,
)
from flash_attention_softmax_n_tpu_torch.models.decoder import (
    DecoderConfig,
    _layer,
    _mm,
    _repeat_kv,
    _TensorParallel,
    layer_views,
)
from flash_attention_softmax_n_tpu_torch.models.layers import (
    apply_rope,
    rms_norm,
    rope_frequencies,
)
from flash_attention_softmax_n_tpu_torch.ops.flash_attention import (
    flash_attention_n,
)
from flash_attention_softmax_n_tpu_torch.ops.functional import softmax_n
from flash_attention_softmax_n_tpu_torch.ops.sampling import sample_tokens
from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
)
from flash_attention_softmax_n_tpu_torch.parallel.sharding import (
    decoder_param_specs,
    gather_from_axis,
    shard_pytree,
)
from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
    init_quantized_kv_cache,
    quantize_kv,
)
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor, as_bytes

__all__ = ["Request", "InferenceEngine", "engine_prefill",
           "engine_prefill_batch", "engine_prefill_chunk", "engine_decode",
           "engine_decode_loop"]


@dataclasses.dataclass
class Request:
    """One generation request (host-side)."""

    request_id: int
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 = greedy
    eos_token: Optional[int] = None
    top_k: int = 0       # <= 0 = no k-truncation
    top_p: float = 1.0   # >= 1 = no nucleus truncation
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, buckets=(32, 64, 96, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def _attention_over_slots(cfg: DecoderConfig, q, k_cache, v_cache, lengths,
                          k_new=None, v_new=None, k_tail=None, v_tail=None,
                          tail_lengths=None):
    """q (B, H, hd) attention over a per-slot-length cache, plus the current
    token's k/v rows (B, KVH, hd) as one extra key each and, in the fused
    loop, the tail window."""
    kwargs = dict(
        softmax_n_param=cfg.softmax_n, scale=cfg.head_dim ** -0.5,
        k_new=k_new, v_new=v_new, k_tail=k_tail, v_tail=v_tail,
        tail_lengths=tail_lengths, implementation=cfg.decode_attn_impl)
    if isinstance(k_cache, QTensor):
        return decode_attention_n(
            q, k_cache.values, v_cache.values, lengths,
            k_scales=k_cache.scales, v_scales=v_cache.scales, **kwargs)
    return decode_attention_n(q, k_cache, v_cache, lengths, **kwargs)


def _layer_cache(cache_kv, i: int):
    if isinstance(cache_kv, QTensor):
        return QTensor(cache_kv.values[i], cache_kv.scales[i], bits=cache_kv.bits)
    return cache_kv[i]


def engine_prefill_batch(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                         true_lens: torch.Tensor, slots: torch.Tensor,
                         cache: Dict, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Prefill ``nb`` slots with (nb, Lb) right-padded prompts in one pass.

    Duplicate slot entries are idempotent. Returns (last-true-token logits
    (nb, V), cache), the cache written in place. The ``offset=0`` case of
    ``engine_prefill_chunk``.
    """
    return engine_prefill_chunk(params, cfg, tokens, true_lens, slots,
                                cache, offset=0, mesh=mesh)


def _prefix_rows(cache_kv, i: int, slots: torch.Tensor, offset: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Layer ``i``'s cached rows [0, offset) of each slot, (nb, KVH, offset,
    hd); a quantized cache dequantizes as JAX does: values to f32, times the
    scales, cast to ``dtype``."""
    if isinstance(cache_kv, QTensor):
        vals = cache_kv.values[i, slots, :, :offset].float()
        return (vals * cache_kv.scales[i, slots, :, :offset]).to(dtype)
    return cache_kv[i, slots, :, :offset]


def _write_rows(cache_kv, i: int, slots: torch.Tensor, offset: int,
                rows: torch.Tensor) -> None:
    """Write (nb, KVH, C, hd) rows into layer ``i`` at columns [offset,
    offset + C) of each slot, in place, quantizing for int8 and fp8 caches
    (whose values move as bytes)."""
    c = rows.shape[2]
    if isinstance(cache_kv, QTensor):
        values, scales = quantize_kv(rows, cache_kv.bits)
        as_bytes(cache_kv.values)[i, slots, :, offset:offset + c] = \
            as_bytes(values)
        cache_kv.scales[i, slots, :, offset:offset + c] = scales
    else:
        cache_kv[i, slots, :, offset:offset + c] = rows.to(cache_kv.dtype)


def engine_prefill_chunk(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                         true_lens: torch.Tensor, slots: torch.Tensor,
                         cache: Dict, *, offset: int, mesh=None
                         ) -> Tuple[torch.Tensor, Dict]:
    """Continuation prefill: write a (nb, C) chunk at column ``offset``.

    Each chunk attends the slots' cached rows [0, offset) plus itself
    (causal within the chunk, positions and RoPE from ``offset``), so a
    long prompt admits as ceil(len / C) bounded passes. Each layer gathers
    its own prefix rows, dequantized for int8 and fp8 caches, so no copy of
    every layer's prefix is held. The chunk's rows are written in place at
    columns [offset, offset + C) and the slots' lengths set to
    min(true_len, offset + C). Returns (logits (nb, V) at each row's last
    true token within this chunk, meaningful on its final chunk; cache).

    ``mesh``: ``params`` and ``cache`` are this rank's shards
    (``parallel/serving.py``) and the rows are prompts whose slots the rank
    owns, ``slots`` indexing its local cache. The weights run tensor
    parallel over ``"model"`` and K1 on the rank's heads; the logits come
    back whole.
    """
    nb, c = tokens.shape
    dev = tokens.device
    tp = _TensorParallel(cfg, params, mesh)
    x = tp.embedding(params["embed"][tokens].to(cfg.dtype))
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                                device=dev)
    positions = offset + torch.arange(c, device=dev)
    reps = cfg.n_heads // cfg.n_kv_heads

    # prefix keys are always valid (a chunk is only dispatched while
    # true_len > offset); chunk key j is valid iff offset + j < true_len
    # and, causally, j <= query row i
    key_pos = torch.arange(offset + c, device=dev)
    valid = key_pos[None, None, :] < true_lens[:, None, None]  # (nb,1,S)
    causal = key_pos[None, :] <= positions[:, None]  # (C,S)
    mask = (valid & causal[None])[:, None]  # (nb,1,C,S)
    impl = "xla" if cfg.attn_implementation == "xla" else "auto"

    layers = layer_views(params["layers"])
    for i in range(cfg.n_layers):
        def attn(q, k, v, i=i):
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            kf, vf = k, v
            if offset > 0:
                kf = torch.cat([_prefix_rows(cache["k"], i, slots, offset,
                                             cfg.dtype).to(k.dtype), k], dim=2)
                vf = torch.cat([_prefix_rows(cache["v"], i, slots, offset,
                                             cfg.dtype).to(v.dtype), v], dim=2)
            _write_rows(cache["k"], i, slots, offset, k)
            _write_rows(cache["v"], i, slots, offset, v)
            ctx = flash_attention_n(
                q, _repeat_kv(kf, reps), _repeat_kv(vf, reps),
                softmax_n_param=cfg.softmax_n, attn_mask=mask,
                implementation=impl, mesh=mesh, batch_axis=None,
                head_axis="model")
            return ctx, None

        x, _, _ = _layer(cfg, x, layers[i], attn, tp)

    cache["lengths"][slots] = torch.clamp(true_lens, max=offset + c).to(
        cache["lengths"].dtype)
    last = torch.clamp(true_lens - offset - 1, 0, c - 1).long()
    x_last = x[torch.arange(nb, device=dev), last][:, None]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    logits = tp.logits(x_last, params["lm_head"], cfg).float()
    return logits[:, 0], cache


def engine_prefill(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                   true_len: torch.Tensor, slot: torch.Tensor,
                   cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Prefill one slot with a (1, Lb) right-padded prompt; returns
    (last-token logits (V,), cache)."""
    logits, cache = engine_prefill_batch(params, cfg, tokens,
                                         true_len.reshape(1),
                                         slot.reshape(1), cache)
    return logits[0], cache


def _greedy_fusable(params: Dict, cfg: DecoderConfig, mesh=None,
                    batch: Optional[int] = None) -> bool:
    """Can greedy sampling ride the lm_head kernel (int8 unpacked lm_head)?

    Under ``mesh`` also JAX's divisibility: the whole vocabulary over
    ``"model"`` and the whole ``batch`` over ``"data"`` (global sizes: a
    rank's shard of the lm_head divides by construction)."""
    lm = params["lm_head"]
    ok = (isinstance(lm, QTensor) and lm.bits == 8
          and lm.packed_axis is None and cfg.act_bits != 8)
    if ok and mesh is not None:
        ok = (cfg.vocab_size % axis_size(mesh, "model") == 0
              and (batch is None or batch % axis_size(mesh, "data") == 0))
    return ok


def _merge_shard_argmax(vals: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """The global greedy token from each vocab shard's (max logit, global
    index), stacked on dim 0 in shard order: the largest value and, on a
    tie, the lowest global index, as an argmax over the whole vocabulary
    takes it (within a shard K2 already keeps the lowest index)."""
    best = vals.amax(dim=0, keepdim=True)
    lowest = torch.iinfo(idxs.dtype).max
    return torch.where(vals == best, idxs, lowest).amin(dim=0)


def _sharded_lm_head_argmax(x: torch.Tensor, lm: QTensor, mesh) -> torch.Tensor:
    """Greedy tokens under tensor parallelism: K2 over this rank's vocab
    columns with ``return_max``, its index offset by the shard's first
    global column, one all-gather of (value, index) over ``"model"`` and
    ``_merge_shard_argmax``. x (B, 1, D) -> (B, 1) int32 global ids. One
    rank on ``"model"`` holds the whole vocabulary: K2 alone."""
    tp = axis_size(mesh, "model")
    if tp == 1:
        return quantized_matmul_argmax(x, lm.values, lm.scales)
    idx, val = quantized_matmul_argmax(x, lm.values, lm.scales, return_max=True)
    gidx = idx.long() + axis_index(mesh, "model") * lm.values.shape[1]
    # f64 holds both the f32 value and any index exactly: one gather
    pair = torch.stack([val.double(), gidx.double()])
    parts = [torch.empty_like(pair) for _ in range(tp)]
    dist.all_gather(parts, pair, group=mesh.get_group("model"))
    both = torch.stack(parts)  # (tp, 2, B, 1)
    return _merge_shard_argmax(both[:, 0], both[:, 1].to(torch.int32))


def _decode_step(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                 cache: Dict, active: torch.Tensor, *, mesh=None,
                 tail: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 tail_index: Optional[int] = None,
                 tail_lengths: Optional[torch.Tensor] = None,
                 greedy: bool = False,
                 prefill: Optional[Dict] = None):
    """One decode step for all slots: tokens (B,) -> (logits (B, V) or greedy
    tokens (B,), cache, tail).

    Each layer attends the unmodified cache plus the current token's k/v as
    an explicit extra key. The new rows of all layers are written once per
    step: into the cache at each slot's length (K3), or in ``tail`` mode
    into the ring at the shared ``tail_index`` (K4), the cache untouched
    until the loop's flush. Lengths advance only for active slots, in a new
    tensor bound to ``cache["lengths"]`` (the caller's dict is a copy).
    ``greedy``: take the tokens from the lm_head kernel K2; the caller
    checks ``_greedy_fusable`` first.

    ``mesh``: this rank's shards and slots (``parallel/serving.py``): the
    layers run tensor parallel over ``"model"`` on the rank's heads, K3/K4
    write its own slots' rows of its own KV heads with no communication,
    and greedy tokens merge over the vocab shards
    (``_sharded_lm_head_argmax``). No piggybacked ``prefill`` under a mesh.

    ``prefill`` (the piggybacked prompts of the fused loop): {tokens (G, CS),
    offset (int), true_lens (G,), ring_k/ring_v (NL, G, KVH, cap, hd)}. The
    prompt rows and the decode rows flatten into one (1, B + G*CS, d)
    operand, so norms, projections and the MLP run once over both; decode
    rows attend the cache as above, prompt rows their ring ([0, offset)
    rows of earlier steps) plus this chunk, causally. The chunk's k/v rows
    go into the ring at ``offset``. The first output is then (decode tokens
    (B,), each prompt's greedy token at its last true row in this chunk
    (G,)), both from one lm_head call over B + G rows.
    """
    bsz = tokens.shape[0]
    tp = _TensorParallel(cfg, params, mesh)
    x = tp.embedding(params["embed"][tokens][:, None].to(cfg.dtype))
    dev = x.device
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                                device=dev)
    lengths = cache["lengths"]
    positions = lengths[:, None].long()
    # in tail mode the cache holds only the pre-loop prefix
    lengths_main = lengths if tail is None else lengths - tail_lengths
    if prefill is not None:
        g, cs = prefill["tokens"].shape
        off = prefill["offset"]
        reps = cfg.n_heads // cfg.n_kv_heads
        x_p = params["embed"][prefill["tokens"]].to(cfg.dtype)  # (G, CS, d)
        x = torch.cat([x.reshape(1, bsz, -1), x_p.reshape(1, g * cs, -1)],
                      dim=1)
        pos_p = off + torch.arange(cs, device=dev)
        pos_m = torch.cat([positions[:, 0], pos_p.repeat(g)])[None]
        cap = prefill["ring_k"].shape[3]
        # prompt-row mask over [ring (cap) | chunk (CS)], shared by the
        # layers: ring row r is valid iff r < offset and r < true_len; chunk
        # key j iff off + j < true_len and, causally, j <= the query's row
        tl = prefill["true_lens"][:, None, None]  # (G, 1, 1)
        ring_pos = torch.arange(cap, device=dev)
        ring_ok = (ring_pos < off) & (ring_pos < tl)  # (G, 1, cap)
        kpos = pos_p[None, :]
        chunk_ok = (kpos <= pos_p[:, None]) & (kpos < tl)  # (G, CS, CS)
        p_mask = torch.cat([ring_ok.expand(g, cs, cap), chunk_ok],
                           dim=-1)[:, None]  # (G, 1, CS, cap + CS)
    k_rows, v_rows, kp_rows, vp_rows = [], [], [], []
    layers = layer_views(params["layers"])
    for i in range(cfg.n_layers):
        kc, vc = _layer_cache(cache["k"], i), _layer_cache(cache["v"], i)
        kt, vt = (tail[0][i], tail[1][i]) if tail is not None else (None, None)

        def attn(q, k, v, kc=kc, vc=vc, kt=kt, vt=vt):
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            ctx = _attention_over_slots(
                cfg, q[:, :, 0], kc, vc, lengths_main,
                k_new=k[:, :, 0], v_new=v[:, :, 0],
                k_tail=kt, v_tail=vt, tail_lengths=tail_lengths)
            return ctx[:, :, None, :].to(x.dtype), (k[:, :, 0], v[:, :, 0])

        def attn_mixed(q, k, v, kc=kc, vc=vc, kt=kt, vt=vt, i=i):
            # q (1, H, M, hd), k/v (1, KVH, M, hd): one rope over the row
            # axis, then the decode rows and the prompt rows part
            nh = q.shape[1]
            q = apply_rope(q, cos, sin, pos_m)
            k = apply_rope(k, cos, sin, pos_m)
            qd, kd, vd = (t[0, :, :bsz].transpose(0, 1) for t in (q, k, v))
            ctx_d = _attention_over_slots(
                cfg, qd, kc, vc, lengths_main, k_new=kd, v_new=vd,
                k_tail=kt, v_tail=vt, tail_lengths=tail_lengths)
            qp = q[0, :, bsz:].reshape(nh, g, cs, -1).transpose(0, 1)
            kp, vp = (t[0, :, bsz:].reshape(cfg.n_kv_heads, g, cs, -1)
                      .transpose(0, 1) for t in (k, v))
            rk, rv = prefill["ring_k"][i], prefill["ring_v"][i]
            keys = _repeat_kv(torch.cat([rk, kp.to(rk.dtype)], dim=2), reps)
            vals = _repeat_kv(torch.cat([rv, vp.to(rv.dtype)], dim=2), reps)
            s = torch.einsum("ghqe,ghse->ghqs", qp.float(), keys.float())
            s = torch.where(p_mask, s * cfg.head_dim ** -0.5, -1e30)
            pw = softmax_n(s, n=cfg.softmax_n, axis=-1)
            ctx_p = torch.einsum("ghqs,ghse->ghqe", pw, vals.float())
            ctx_m = torch.cat(
                [ctx_d.transpose(0, 1).float(),
                 ctx_p.transpose(0, 1).reshape(nh, g * cs, -1)], dim=1)[None]
            return ctx_m.to(x.dtype), ((kd, vd), (kp, vp))

        if prefill is None:
            x, _, (kr, vr) = _layer(cfg, x, layers[i], attn, tp)
        else:
            x, _, ((kr, vr), (kpr, vpr)) = _layer(cfg, x, layers[i],
                                                  attn_mixed)
            kp_rows.append(kpr)
            vp_rows.append(vpr)
        k_rows.append(kr)
        v_rows.append(vr)
    k_rows = torch.stack(k_rows)  # (NL, B, KVH, hd)
    v_rows = torch.stack(v_rows)
    if prefill is not None:
        # the chunk's prompt rows into the ring at its offset, one copy each
        for ring, rows in ((prefill["ring_k"], kp_rows),
                           (prefill["ring_v"], vp_rows)):
            ring[:, :, :, off:off + cs] = torch.stack(rows).to(ring.dtype)

    if tail is not None:
        tail = tail_append(tail[0], tail[1], k_rows.to(tail[0].dtype),
                           v_rows.to(tail[1].dtype), tail_index)
    else:
        kq = cache["k"]
        s_len = (kq.values if isinstance(kq, QTensor) else kq).shape[3]
        write_pos = torch.clamp(lengths, max=s_len - 1).to(torch.int32)
        if isinstance(kq, QTensor):
            vq = cache["v"]
            kv_, ks_ = quantize_kv(k_rows, kq.bits)
            vv_, vs_ = quantize_kv(v_rows, vq.bits)
            cache_append((kq.values, kq.scales, vq.values, vq.scales),
                         (kv_, ks_, vv_, vs_), write_pos)
        else:
            cache_append((cache["k"], cache["v"]),
                         (k_rows.to(cache["k"].dtype),
                          v_rows.to(cache["v"].dtype)), write_pos)

    cache["lengths"] = torch.where(active, lengths + 1, lengths)

    if prefill is not None:
        # the decode rows and each prompt's last true row of this chunk
        # (meaningful on its final chunk; the loop keeps that one) through
        # one final norm and one lm_head call
        last = torch.clamp(prefill["true_lens"] - off - 1, 0, cs - 1).long()
        xg = x[0, bsz:].reshape(g, cs, -1)[torch.arange(g, device=dev), last]
        xx = rms_norm(torch.cat([x[0, :bsz], xg])[:, None],
                      params["final_norm"], cfg.norm_eps)
        if _greedy_fusable(params, cfg):
            lm = params["lm_head"]
            tok = quantized_matmul_argmax(xx, lm.values, lm.scales)[:, 0]
        else:
            logits = _mm(xx, params["lm_head"], cfg.act_bits,
                         cfg.int8_mm_impl).float()
            tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        return (tok[:bsz], tok[bsz:]), cache, tail

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if greedy:
        lm = params["lm_head"]
        if mesh is not None:
            tok = _sharded_lm_head_argmax(x, lm, mesh)
        else:
            tok = quantized_matmul_argmax(x, lm.values, lm.scales)
        return tok[:, 0], cache, tail
    logits = tp.logits(x, params["lm_head"], cfg).float()
    return logits[:, 0], cache, tail


def engine_decode(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                  cache: Dict, active: torch.Tensor,
                  mesh=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step for all slots: tokens (B,) -> (logits (B, V), cache),
    the new rows written into the cache in place (K3) and the new lengths
    copied into ``cache["lengths"]``. ``mesh``: this rank's slots and
    shards, the logits whole (see ``_decode_step``)."""
    logits, step_cache, _ = _decode_step(params, cfg, tokens, dict(cache),
                                         active, mesh=mesh)
    cache["lengths"].copy_(step_cache["lengths"])
    return logits, cache


def engine_decode_loop(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                       cache: Dict, active: torch.Tensor, *, num_steps: int,
                       eos_token: Optional[int] = None,
                       temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       temps: Optional[torch.Tensor] = None,
                       top_k: Optional[torch.Tensor] = None,
                       top_p: Optional[torch.Tensor] = None,
                       mesh=None,
                       attn_len: Optional[int] = None,
                       p_tokens: Optional[torch.Tensor] = None,
                       p_slots: Optional[torch.Tensor] = None,
                       p_true_lens: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, ...]:
    """``num_steps`` decode steps that stay on the device (no host sync).

    Returns ``(tokens_out (B, num_steps), cache, active)``. Greedy, or
    per-slot sampling when ``temps`` (with ``top_k``/``top_p`` and a
    ``generator``) is given, or whole-batch sampling at a scalar
    ``temperature > 0`` (with a ``generator``; ``temps`` takes precedence,
    as in JAX). ``eos_token``: a slot that emits it turns
    inactive (a new ``active`` is returned); slots that hit it keep
    emitting their last token. Everything the loop changes is written in
    place: cache rows, and the final lengths copied into
    ``cache["lengths"]``; so a CUDA graph of the loop reads and writes the
    caller's tensors.

    At ``num_steps >= 8`` (tail mode) new k/v rows go to a bf16 ring at the
    step index shared by all slots (K4); attention covers cache prefix +
    ring + current token; one flush per call moves the ring into the cache
    (quantizing it for int8 and fp8 caches). Requires ``lengths +
    round_up(num_steps, 8) <= max_len`` for every active slot. ``attn_len``
    (tail mode): the attention reads only the first ``attn_len`` cache rows
    (exact while ``attn_len >= max(active lengths)``). Shorter chunks write
    each step's rows into the cache (K3), as ``engine_decode`` does.

    Piggybacked admission (``p_tokens (G, cap)`` right-padded prompts,
    ``p_slots (G,)``, ``p_true_lens (G,)``; tail mode, greedy, ``cap %
    num_steps == 0``): each step prefills a cap/num_steps-token chunk of
    every prompt through the decode step's matmuls (``_decode_step``'s
    ``prefill``). The prompt rows collect in a ring flushed into the cache
    after the tail flush, so the piggybacked slots must be inactive in
    ``active``; their lengths are then set to their prompts'. Returns
    ``(tokens, cache, active, first_tokens (G,))``, each prompt's greedy
    first token.

    ``mesh``: ``tokens``, ``active`` and ``cache`` are this rank's slots
    and shards (``parallel/serving.py``); every rank of the mesh runs the
    loop together. No piggybacked admission under a mesh (JAX's rule).
    """
    if temperature > 0.0 and temps is None:
        temps = torch.full(tokens.shape, float(temperature), device=tokens.device)
    if temps is not None and generator is None:
        raise ValueError("temperature sampling requires generator")
    if p_tokens is not None and mesh is not None:
        raise ValueError("piggybacked prefill requires tail mode, greedy "
                         "decode, and no mesh")

    kc = cache["k"].values if isinstance(cache["k"], QTensor) else cache["k"]
    nl, bsz, kvh, s_len, hd = kc.shape
    use_tail = num_steps >= 8
    base = cache["lengths"]  # entry lengths, until the final copy below
    step_cache = dict(cache)
    tail = None
    if use_tail:
        w = -(-num_steps // 8) * 8
        tail = tuple(torch.zeros((nl, bsz, kvh, w, hd), dtype=cfg.dtype,
                                 device=kc.device) for _ in range(2))
        if attn_len is not None and attn_len < s_len:
            def _window(c):
                if isinstance(c, QTensor):
                    return QTensor(c.values[:, :, :, :attn_len],
                                   c.scales[:, :, :, :attn_len], bits=c.bits)
                return c[:, :, :, :attn_len]

            step_cache["k"] = _window(cache["k"])
            step_cache["v"] = _window(cache["v"])

    dp = axis_size(mesh, "data") if mesh is not None else 1
    greedy = temps is None and _greedy_fusable(params, cfg, mesh, bsz * dp)
    piggy = p_tokens is not None
    if piggy:
        if not use_tail or temps is not None:
            raise ValueError("piggybacked prefill requires tail mode "
                             "(num_steps >= 8) and greedy decode")
        g, cap = p_tokens.shape
        if cap % num_steps:
            raise ValueError(f"piggyback cap {cap} must divide into "
                             f"{num_steps} steps")
        cs = cap // num_steps
        ring = tuple(torch.zeros((nl, g, kvh, cap, hd), dtype=cfg.dtype,
                                 device=kc.device) for _ in range(2))
        # each prompt's final chunk: the step whose chunk holds its last row
        p_final = torch.clamp(p_true_lens - 1, min=0) // cs
        first = torch.zeros((g,), dtype=torch.int32, device=kc.device)

    tok = tokens
    outs = []
    for i in range(num_steps):
        if piggy:
            pf = {"tokens": p_tokens[:, i * cs:(i + 1) * cs], "offset": i * cs,
                  "true_lens": p_true_lens, "ring_k": ring[0],
                  "ring_v": ring[1]}
            (nxt, p_tok), step_cache, tail = _decode_step(
                params, cfg, tok, step_cache, active, tail=tail,
                tail_index=i, tail_lengths=step_cache["lengths"] - base,
                prefill=pf)
            first = torch.where(p_final == i, p_tok, first)
        else:
            out, step_cache, tail = _decode_step(
                params, cfg, tok, step_cache, active, mesh=mesh, tail=tail,
                tail_index=i if use_tail else None,
                tail_lengths=(step_cache["lengths"] - base if use_tail
                              else None), greedy=greedy)
            if greedy:
                nxt = out  # argmax fused into the lm_head kernel
            elif temps is not None:
                nxt = sample_tokens(out, generator, temps, top_k, top_p)
            else:
                nxt = torch.argmax(out, dim=-1).to(torch.int32)
        tok = torch.where(active, nxt, tok)
        if eos_token is not None:
            active = active & (tok != eos_token)
        outs.append(tok)

    if use_tail:
        _flush_tail(cfg, cache["k"], cache["v"], tail[0], tail[1], base)
    cache["lengths"].copy_(step_cache["lengths"])
    toks = torch.stack(outs, dim=1)
    if piggy:
        # prompt rows after the tail flush: the piggybacked slots' garbage
        # tail rows must lose
        _flush_prefill_ring(cache["k"], cache["v"], ring[0], ring[1], p_slots)
        cache["lengths"].scatter_(
            0, p_slots.long(),
            torch.clamp(p_true_lens, max=s_len).to(cache["lengths"].dtype))
        return toks, cache, active, first
    return toks, cache, active


def _flush_prefill_ring(k_cache, v_cache, ring_k, ring_v, p_slots):
    """Write piggybacked prompt rows (NL, G, KVH, cap, hd) into the cache at
    rows [0, cap) of each prompt's slot, in place, quantizing for int8 and
    fp8 caches (whose values move as bytes).

    Padding prompts repeat a real one, so duplicate slots write identical
    rows. Rows past a prompt's true length are garbage at positions its
    slot's length excludes, as in the tail flush."""
    cap = ring_k.shape[3]
    slots = p_slots.long()

    def write(dst, rows):
        as_bytes(dst)[:, slots, :, :cap] = as_bytes(rows.to(dst.dtype))

    for cache_kv, ring in ((k_cache, ring_k), (v_cache, ring_v)):
        if isinstance(cache_kv, QTensor):
            rq, rs = quantize_kv(ring, cache_kv.bits)
            write(cache_kv.values, rq)
            write(cache_kv.scales, rs)
        else:
            write(cache_kv, ring)
    return k_cache, v_cache


def _flush_tail(cfg: DecoderConfig, k_cache, v_cache, k_tail, v_tail, base):
    """Write the loop's ring (NL, B, KVH, W, hd) into the cache at each
    slot's row ``base[b]``, in place, quantizing for int8 and fp8 caches
    (whose values move as bytes).

    Rows past a slot's advanced length are garbage but land at positions
    the slot's length excludes. If a window would run past the cache end
    (a broken admission contract), it is shifted back to fit and only its
    first rows are written, so earlier rows are never overwritten.
    """
    bsz, w = k_tail.shape[1], k_tail.shape[3]
    dev = k_tail.device
    s_len = (k_cache.values if isinstance(k_cache, QTensor) else k_cache).shape[3]
    ar = torch.arange(w, device=dev)
    base = base.long()
    start = torch.clamp(base, max=s_len - w)
    shift = base - start  # 0 when the contract holds
    dest = start[:, None] + ar  # (B, W) cache rows
    src = torch.clamp(ar[None, :] - shift[:, None], min=0)  # (B, W) ring rows
    keep_new = (ar[None, :] >= shift[:, None])[..., None, None, None]
    bidx = torch.arange(bsz, device=dev)[:, None].expand(bsz, w)

    def write(dst, rows):
        # dst (NL, B, KVH, S, D) and rows (NL, B, KVH, W, D) viewed slot-major
        dst, rows = as_bytes(dst), as_bytes(rows)
        dv = dst.permute(1, 3, 0, 2, 4)
        new = rows.permute(1, 3, 0, 2, 4)[bidx, src].to(dst.dtype)
        dv[bidx, dest] = torch.where(keep_new, new, dv[bidx, dest])

    for cache_kv, t in ((k_cache, k_tail), (v_cache, v_tail)):
        if isinstance(cache_kv, QTensor):
            tq, ts = quantize_kv(t, cache_kv.bits)
            write(cache_kv.values, tq)
            write(cache_kv.scales, ts)
        else:
            write(cache_kv, t)
    return k_cache, v_cache


@dataclasses.dataclass
class _LoopGraph:
    """One captured greedy loop variant: its CUDA graph, the output tensors
    that each replay overwrites, and the kernel launches one replay makes
    (``_build.LAUNCHES`` is a host counter that a replay does not bump)."""

    graph: "torch.cuda.CUDAGraph"
    outputs: Tuple[torch.Tensor, ...]
    launches: Dict[str, int]


def capture_loop(run: Callable[[], Tuple[torch.Tensor, ...]],
                 pool=None) -> _LoopGraph:
    """Capture ``run()`` (a greedy loop over tensors that stay in place) as
    a CUDA graph in memory pool ``pool``. ``run`` must have run eagerly
    before (first-use work cannot be captured); capture executes nothing,
    and the launch counts its wrappers made are taken back and kept for the
    replays."""
    before = dict(_build.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        outputs = run()
    launches = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()}
    _build.LAUNCHES.update(before)
    return _LoopGraph(graph, outputs, launches)


def warm_on_side_stream(runs: List[Callable[[], object]],
                        device: torch.device) -> None:
    """Run each of ``runs`` once eagerly on a side stream that the current
    stream then waits for, so that the kernels' first-use work (the
    library's build and load, kernel attributes, the tensor-map entry point,
    cuBLAS's handle and workspace) happens before ``capture_loop``."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for run in runs:
            run()
    current.wait_stream(side)


def replay_loop(captured: _LoopGraph) -> Tuple[torch.Tensor, ...]:
    """Replay a captured loop, add the launches its capture recorded to
    ``_build.LAUNCHES`` and return its outputs (overwritten by each
    replay)."""
    captured.graph.replay()
    for k, n in captured.launches.items():
        _build.LAUNCHES[k] += n
    return captured.outputs


class InferenceEngine:
    """Slot-based continuous-batching engine.

    Usage::

        eng = InferenceEngine(cfg, params, max_batch=8, max_len=2048,
                              kv_quantization='int8')
        eng.prewarm(loop_steps=64)    # optional: capture the greedy loops
        rid = eng.submit([1, 2, 3], max_new_tokens=32)
        finished = eng.run_until_done(loop_steps=64)

    On CUDA every greedy fused chunk replays a CUDA graph of its loop
    variant (chunk length, attention window, piggyback payload or not),
    captured by ``prewarm`` or at the variant's first dispatch, which runs
    eagerly. The graphs read and write the engine's own tensors: the cache,
    its lengths, and input buffers the host fills before each chunk. Chunks
    with sampling rows and the step path run eagerly; on the CPU every
    chunk does.

    Over a mesh (``mesh=``) every rank constructs the engine with the same
    whole ``params`` and gets the same ``submit`` calls; it keeps only its
    shards (``parallel/serving.py``): the weights over ``"model"``, its
    slots' cache rows, lengths, next tokens and active flags over
    ``"data"`` (rank ``d`` owns slots ``[d * B/dp, (d + 1) * B/dp)``) and
    its KV heads. The host scheduler runs alike on every rank on the
    global view: after each chunk, step and admission round one all-gather
    over ``"data"`` brings every slot's tokens to every rank. An admission
    group's rows prefill on the data rank that owns their slots (no rows
    move between ranks). Piggybacked prefill is off under a mesh, as in
    JAX, and the chunk planner takes the fixed ``_SCHED_OVERHEAD_STEPS``:
    measured times differ between ranks, and the plans must not.
    """

    # admission group width: requests prefilled per batched dispatch
    _ADMIT_G = 16
    # scheduling overhead of a chunk boundary in decode-step units, until
    # measured boundary/step times replace it
    _SCHED_OVERHEAD_STEPS = 4
    # piggybacked prefill: prompts of up to _PIGGY_CAP tokens ride a decode
    # chunk in cap/num_steps-token slices, at most _PIGGY_G a chunk (one
    # payload shape per loop variant)
    _PIGGY_CAP = 128
    _PIGGY_G = 8

    def __init__(self, cfg: DecoderConfig, params: Dict, *,
                 max_batch: int = 8, max_len: Optional[int] = None,
                 kv_quantization: Optional[str] = None,
                 pad_token: int = 0, mesh=None,
                 prefill_chunk: int = 256,
                 piggyback_prefill: bool = True,
                 device=None):
        """``params`` must live on ``device`` (None: the card).
        ``piggyback_prefill``: queued greedy prompts of up to _PIGGY_CAP
        tokens prefill inside the fused decode chunks. ``prefill_chunk``:
        prompts longer than this admit through chunked prefill
        (``engine_prefill_chunk``), one bounded pass per chunk.

        ``mesh``: a ``make_mesh`` mesh with ``'data'`` and ``'model'`` axes
        (``max_batch`` divisible by the first, ``n_kv_heads`` by the
        second); the engine then serves tensor/data-parallel on the mesh's
        device (the card under NCCL, the CPU under gloo): ``device``, if
        given, must agree, and ``params`` are the whole tensors there."""
        if mesh is not None:
            from flash_attention_softmax_n_tpu_torch.parallel.serving import (
                check_serving_mesh,
            )
            if device is not None and (torch.device(device).type
                                       != mesh.device_type):
                raise ValueError(f"the mesh is on {mesh.device_type}, the "
                                 f"engine asked for {device}")
            check_serving_mesh(mesh, params, max_batch, cfg.n_kv_heads)
            device = mesh.device_type
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.mesh = mesh
        # this rank's slots [_lo, _hi) and KV heads (all of them unmeshed)
        self._dp, tp, data_index = 1, 1, 0
        if mesh is not None:
            self._dp, tp = axis_size(mesh, "data"), axis_size(mesh, "model")
            data_index = axis_index(mesh, "data")
            params = shard_pytree(params, decoder_param_specs(params), mesh)
        local_batch = max_batch // self._dp
        self._lo = data_index * local_batch
        self._hi = self._lo + local_batch
        kv_heads = cfg.n_kv_heads // tp
        self.params = params
        self.max_batch = max_batch
        self.piggyback_prefill = piggyback_prefill
        self.max_len = max_len or cfg.max_seq_len
        self.pad_token = pad_token
        self._CHUNK = prefill_chunk
        self._id_gen = itertools.count()
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._slot_budget = [0] * max_batch
        self._next_host = np.zeros((max_batch,), np.int32)
        # host mirror of cache['lengths'] for scheduling, exact for live
        # slots, so chunk planning never waits on the device
        self._lengths_host = np.zeros((max_batch,), np.int64)
        # the fused loop's inputs: persistent buffers that the host fills
        # with copy_, so a captured loop reads them at every replay
        self._next_token = torch.zeros((local_batch,), dtype=torch.int32,
                                       device=self.device)
        self._active = torch.zeros((local_batch,), dtype=torch.bool,
                                   device=self.device)
        g, cap = self._PIGGY_G, self._PIGGY_CAP
        self._p_tokens = torch.zeros((g, cap), dtype=torch.int32,
                                     device=self.device)
        self._p_slots = torch.zeros((g,), dtype=torch.int32, device=self.device)
        self._p_true_lens = torch.zeros((g,), dtype=torch.int32,
                                        device=self.device)
        # slots whose prompts prefill inside the in-flight chunk (slot ->
        # Request); not in self.slots until their first token is back, so
        # chunk planning and the active mask skip them and admission cannot
        # take them
        self._pending_prefill: Dict[int, Request] = {}
        # captured greedy loops by (chunk, attn_len, piggy), all in one
        # memory pool (see _capture)
        self._graphs: Dict[Tuple[int, int, bool], _LoopGraph] = {}
        self._graph_pool = None
        # one stream a data rank: the ranks of a 'model' group sample the
        # same rows from the same logits and must draw alike
        self._generator = torch.Generator(device=self.device).manual_seed(
            data_index)
        self.phase_times: Dict[str, float] = {}
        self.phase_counts: Dict[str, int] = {}
        self.chunk_log: List[Tuple[int, float]] = []
        self.counters: Dict[str, int] = {}
        # the prefix cache: registered prefixes' KV rows live in stores of
        # their own; a hit copies a store's rows into its slot and prefills
        # only the suffix (register_prefix, _match_prefix)
        self._kv_quantization = kv_quantization
        self._prefixes: List[Dict] = []
        self._prefix_inserts: Dict[Tuple[int, int], object] = {}
        self._prefill_chunks: Dict[int, object] = {}

        # this rank's shard of the cache (kv_cache_specs' layout) is
        # allocated as such, never as the whole cache
        if kv_quantization is not None:
            self.cache = init_quantized_kv_cache(
                cfg.n_layers, local_batch, kv_heads, self.max_len,
                cfg.head_dim, mode=kv_quantization, device=self.device)
        else:
            shape = (cfg.n_layers, local_batch, kv_heads, self.max_len,
                     cfg.head_dim)
            self.cache = {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device)}
        # written in place only (never re-bound): a captured loop reads it
        self.cache["lengths"] = torch.zeros((local_batch,), dtype=torch.int32,
                                            device=self.device)
        self.cache.pop("length", None)

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 64,
               temperature: float = 0.0,
               eos_token: Optional[int] = None,
               top_k: int = 0, top_p: float = 1.0) -> int:
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds engine max_len")
        if temperature == 0.0 and (top_k > 0 or top_p < 1.0):
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature=0 is "
                "greedy argmax and ignores truncation)")
        req = Request(next(self._id_gen), list(prompt), max_new_tokens,
                      temperature, eos_token, top_k=top_k, top_p=top_p)
        self.queue.append(req)
        return req.request_id

    def prewarm(self, loop_steps: int = 64,
                attn_lens: Optional[List[int]] = None) -> int:
        """Capture every greedy fused-loop variant this engine can dispatch
        at ``loop_steps`` (``_loop_variants``) as a CUDA graph, so that no
        chunk of the traffic after it pays a capture. Returns the number of
        variants. ``attn_lens``: only these attention windows (each rounded
        up to a multiple of 256, capped at max_len); default all.

        Each variant first runs once eagerly on a side stream, so that the
        kernels' first-use work (the library's build and load, kernel
        attributes, the tensor-map entry point, cuBLAS's handle and
        workspace) happens outside capture; then the cache (values, scales,
        lengths) and the next tokens are restored bit for bit and every
        variant is captured, which executes nothing. Greedy variants only:
        chunks with sampling rows, and the step path, run eagerly. On the
        CPU nothing is captured and the count is returned.
        """
        variants = self._loop_variants(loop_steps, attn_lens)
        cold = [v for v in variants if v not in self._graphs]
        if self.device.type != "cuda" or not cold:
            return len(variants)
        saved = [t.clone() for t in self._state_tensors()]
        warm_on_side_stream([functools.partial(self._loop, key) for key in cold],
                            self.device)
        for t, s in zip(self._state_tensors(), saved):
            t.copy_(s)
        del saved
        for key in cold:
            self._capture(key)
        return len(variants)

    def step(self) -> List[Request]:
        """Admit queued requests into free slots, run one decode step.

        Returns requests that finished during this step.
        """
        finished = self._admit()
        active_slots = [i for i, r in enumerate(self.slots) if r is not None]
        if not active_slots:
            return finished

        active = self._active_mask()
        logits, self.cache = engine_decode(self.params, self.cfg,
                                           self._next_token, self.cache, active,
                                           mesh=self.mesh)
        next_host = self._gather_slots(self._sample(
            logits, self.slots[self._lo:self._hi])).cpu().numpy()
        for i in active_slots:
            self._lengths_host[i] += 1
            req = self.slots[i]
            tok = int(next_host[i])
            req.output.append(tok)
            self._slot_budget[i] -= 1
            if (self._slot_budget[i] <= 0
                    or (req.eos_token is not None and tok == req.eos_token)):
                req.done = True
                finished.append(req)
                self.slots[i] = None
            else:
                self._next_host[i] = tok
        self._load_next_tokens()
        return finished

    def run_until_done(self, max_steps: int = 100_000,
                       loop_steps: Optional[int] = None) -> List[Request]:
        """Drive all queued requests to completion.

        ``loop_steps``: decode in fused chunks of up to that many steps
        between scheduling points (tail mode from 8 steps); falls back to
        single steps only when a slot is too close to ``max_len`` for a
        chunk. With ``piggyback_prefill``, queued prompts that fit prefill
        inside the chunk (``_take_piggyback``) before classic admission
        fills the remaining slots. ``max_steps`` bounds decode-step work (a
        chunk counts its full length, an admission-only iteration one).
        """
        done = []
        steps_left = max_steps
        tic = time.perf_counter

        def _t(phase, t0):
            dt = tic() - t0
            self.phase_times[phase] = self.phase_times.get(phase, 0.0) + dt
            self.phase_counts[phase] = self.phase_counts.get(phase, 0) + 1
            return tic()

        while steps_left > 0:
            if loop_steps is not None:
                t0 = it0 = tic()
                piggy = None
                if any(s is not None for s in self.slots):
                    # piggybacked prompts are taken before classic
                    # admission, which then fills the slots that remain
                    piggy = self._take_piggyback(
                        self._fused_chunk_len(loop_steps))
                pending = self._admit_async()
                t0 = _t("admit_dispatch", t0)
                if not any(s is not None for s in self.slots):
                    done.extend(self._finalize_admission(pending))
                    _t("admit_sync", t0)
                    if not self.queue:
                        break
                    steps_left -= 1
                    continue
                chunk = self._fused_chunk_len(loop_steps)
                t0 = _t("chunk_plan", t0)
                if piggy is not None and not self._piggy_fits(chunk):
                    # admission changed the plan to a chunk the payload
                    # cannot split into: the prompts go back untouched
                    self._undo_piggyback(piggy)
                    piggy = None
                if chunk:
                    handle = self._dispatch_chunk(chunk, piggy)
                    t0 = _t("chunk_dispatch", t0)
                    done.extend(self._finalize_admission(pending))
                    t0 = _t("admit_sync", t0)
                    boundary_s = t0 - it0
                    done.extend(self._finalize_chunk(handle))
                    t_end = _t("chunk_sync", t0)
                    self.chunk_log.append((chunk, t_end - it0))
                    self._update_sched_ewma(boundary_s, (t_end - t0) / chunk)
                    steps_left -= chunk
                    continue
                done.extend(self._finalize_admission(pending))
                _t("admit_sync", t0)
            done.extend(self.step())
            steps_left -= 1
            if not self.queue and all(s is None for s in self.slots):
                break
        return done

    def profile_report(self, reset: bool = True) -> Dict[str, Dict]:
        """Per-phase host wall-clock of the fused serving loop since the last
        reset: {phase: {'total_s', 'count', 'mean_ms'}}. Phases:
        admit_dispatch (scheduling + prefill enqueue), chunk_plan,
        chunk_dispatch (decode-chunk enqueue), admit_sync (first-token sync
        of the round's prefills), chunk_sync (the chunk's token sync +
        bookkeeping)."""
        rep = {k: {"total_s": v, "count": self.phase_counts.get(k, 0),
                   "mean_ms": v / max(self.phase_counts.get(k, 1), 1) * 1e3}
               for k, v in sorted(self.phase_times.items())}
        if reset:
            self.phase_times = {}
            self.phase_counts = {}
            self.chunk_log = []
        return rep

    def counters_report(self, reset: bool = True) -> Dict[str, float]:
        """Scheduling counters since the last reset, plus prefill_pad_waste
        (share of prefill rows x tokens that is padding) and chunk_util
        (kept tokens over dispatched chunk capacity)."""
        rep: Dict[str, float] = dict(self.counters)
        if rep.get("prefill_tokens"):
            rep["prefill_pad_waste"] = round(
                1.0 - rep.get("prefill_real_tokens", 0)
                / rep["prefill_tokens"], 4)
        if rep.get("chunk_capacity_tokens"):
            rep["chunk_util"] = round(
                rep.get("chunk_kept_tokens", 0)
                / rep["chunk_capacity_tokens"], 4)
            rep["chunk_live_util"] = round(
                rep.get("chunk_kept_tokens", 0)
                / max(rep.get("chunk_live_tokens", 1), 1), 4)
        if reset:
            self.counters = {}
        return rep

    # -- fused-loop serving internals ----------------------------------------

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _gather_slots(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of a tensor over this rank's slots: an
        all-gather over ``"data"`` (a collective: every rank calls it)."""
        if self._dp == 1:
            return t
        return gather_from_axis(t.contiguous(), self.mesh, "data", 0)

    def _load_next_tokens(self) -> None:
        """This rank's slots of the host's next tokens into ``_next_token``."""
        self._next_token.copy_(torch.from_numpy(
            self._next_host[self._lo:self._hi]))

    def _active_mask(self) -> torch.Tensor:
        self._active.copy_(torch.from_numpy(
            np.array([r is not None for r in self.slots[self._lo:self._hi]])))
        return self._active

    def _update_sched_ewma(self, boundary_s: float, step_s: float) -> None:
        a = 0.3
        prev_b = getattr(self, "_ewma_boundary_s", None)
        prev_s = getattr(self, "_ewma_step_s", None)
        self._ewma_boundary_s = (boundary_s if prev_b is None
                                 else (1 - a) * prev_b + a * boundary_s)
        self._ewma_step_s = (step_s if prev_s is None
                             else (1 - a) * prev_s + a * step_s)

    @property
    def _sched_overhead_steps(self) -> int:
        if self.mesh is not None:
            return self._SCHED_OVERHEAD_STEPS
        b = getattr(self, "_ewma_boundary_s", None)
        s = getattr(self, "_ewma_step_s", None)
        if b and s:
            return max(1, min(24, round(b / s)))
        return self._SCHED_OVERHEAD_STEPS

    def _chunk_steps(self, loop_steps: int) -> int:
        """Adaptive chunk length: the power-of-two c <= loop_steps (or
        loop_steps itself) maximizing sum_i min(rem_i, c) / (c + overhead)
        over the live slots' remaining budgets; 0 if every budget is spent."""
        rem = [self._slot_budget[i] for i, r in enumerate(self.slots)
               if r is not None]
        if not rem:
            return loop_steps
        if not any(rem):
            return 0
        best_c, best_rate = loop_steps, -1.0
        cands = []
        c = 8
        while c <= loop_steps:
            cands.append(c)
            c *= 2
        if loop_steps >= 8 and loop_steps not in cands:
            cands.append(loop_steps)
        overhead = self._sched_overhead_steps
        for c in cands:
            rate = sum(min(r, c) for r in rem) / (c + overhead)
            if rate > best_rate:
                best_rate, best_c = rate, c
        return best_c

    def _fused_chunk_len(self, loop_steps: int) -> int:
        """The adaptive chunk, halved until the fullest active slot's
        max_len headroom holds its ring (rounded up to 8 rows); 0 when no
        fused chunk fits."""
        chunk = self._chunk_steps(loop_steps)
        if not chunk:
            return 0
        amax = max((int(self._lengths_host[i])
                    for i, r in enumerate(self.slots) if r is not None),
                   default=0)
        headroom = self.max_len - amax
        while chunk:
            if -(-chunk // 8) * 8 <= headroom:
                return chunk
            if chunk <= 8:
                return 0
            chunk //= 2
        return 0

    def _piggy_fits(self, chunk: int) -> bool:
        """Can a piggyback payload ride a ``chunk``-step chunk? Tail mode
        (JAX's loop raises on a payload below 8 steps, which its scheduler
        can reach at loop_steps 1, 2 or 4), the cap split evenly, and the
        prompts' rows within max_len. Never under a mesh (JAX's rule)."""
        cap = self._PIGGY_CAP
        return (self.piggyback_prefill and self.mesh is None and 8 <= chunk <= cap
                and cap % chunk == 0 and cap <= self.max_len)

    def _take_piggyback(self, chunk: int) -> Optional[Dict]:
        """Reserve up to _PIGGY_G queued prompts to prefill inside the next
        chunk. Only a FIFO prefix of the queue goes, so ordering stays that
        of classic admission: the first request that is not greedy, is
        empty or is longer than _PIGGY_CAP stops the scan. Needs an
        all-greedy slot pool (the mixed step takes argmaxes only)."""
        if not self._piggy_fits(chunk) or not self.queue:
            return None
        if self._sampling_arrays(self.slots) is not None:
            return None
        free = [i for i in range(self.max_batch)
                if self.slots[i] is None and i not in self._pending_prefill]
        take: List[Request] = []
        for req in self.queue:
            if len(take) >= min(self._PIGGY_G, len(free)):
                break
            if (req.temperature != 0.0 or not req.prompt
                    or len(req.prompt) > self._PIGGY_CAP):
                break
            take.append(req)
        if not take:
            return None
        ids = {id(r) for r in take}
        self.queue = deque(r for r in self.queue if id(r) not in ids)
        slots = free[:len(take)]
        for i, req in zip(slots, take):
            self._pending_prefill[i] = req
        pads = self._PIGGY_G - len(take)
        toks = np.zeros((self._PIGGY_G, self._PIGGY_CAP), np.int32)
        lens = np.zeros((self._PIGGY_G,), np.int32)
        for gi, req in enumerate(take + [take[-1]] * pads):
            toks[gi, :len(req.prompt)] = req.prompt
            lens[gi] = len(req.prompt)
        c = self.counters
        c["piggyback_prompts"] = c.get("piggyback_prompts", 0) + len(take)
        c["piggyback_tokens"] = (c.get("piggyback_tokens", 0)
                                 + sum(len(r.prompt) for r in take))
        return {"reqs": take, "slots": slots, "p_tokens": toks,
                "p_slots": np.array(slots + [slots[-1]] * pads, np.int32),
                "p_true_lens": lens}

    def _undo_piggyback(self, piggy: Dict) -> None:
        for req in reversed(piggy["reqs"]):
            self.queue.appendleft(req)
        for i in piggy["slots"]:
            self._pending_prefill.pop(i, None)
        c = self.counters
        c["piggyback_prompts"] -= len(piggy["reqs"])
        c["piggyback_tokens"] -= sum(len(r.prompt) for r in piggy["reqs"])

    def _load_piggyback(self, piggy: Dict) -> None:
        """Copy a payload from ``_take_piggyback`` into the loop's buffers."""
        for buf, name in ((self._p_tokens, "p_tokens"),
                          (self._p_slots, "p_slots"),
                          (self._p_true_lens, "p_true_lens")):
            buf.copy_(torch.from_numpy(piggy[name]))

    def _loop_variants(self, loop_steps: int,
                       attn_lens: Optional[List[int]] = None
                       ) -> List[Tuple[int, int, bool]]:
        """Every greedy loop variant (chunk, attn_len, piggy) that
        ``run_until_done(loop_steps)`` can dispatch, as JAX's ``prewarm``
        enumerates them: ``_chunk_steps``' candidates closed under
        ``_fused_chunk_len``'s halving, times the attention windows (256s
        up to max_len, or ``attn_lens``'), with a piggyback variant where
        ``_piggy_fits``."""
        cands = {loop_steps} if loop_steps >= 8 else set()
        c = 8
        while c <= loop_steps:
            cands.add(c)
            c *= 2
        chunks, stack = set(), list(cands)
        while stack:
            c = stack.pop()
            if c not in chunks:
                chunks.add(c)
                if c > 8:
                    stack.append(c // 2)
        if attn_lens is not None:
            lens = sorted({min(self.max_len, -(-int(al) // 256) * 256)
                           for al in attn_lens})
        else:
            lens = sorted({min(self.max_len, 256 * i)
                           for i in range(1, -(-self.max_len // 256) + 1)})
        out = []
        for chunk in sorted(chunks):
            for al in lens:
                out.append((chunk, al, False))
                if self._piggy_fits(chunk):
                    out.append((chunk, al, True))
        return out

    def _state_tensors(self) -> List[torch.Tensor]:
        """The device state a loop changes or reads as input: the cache's
        values, scales and lengths, and the next tokens."""
        out = []
        for kv in (self.cache["k"], self.cache["v"]):
            out += [kv.values, kv.scales] if isinstance(kv, QTensor) else [kv]
        return out + [self.cache["lengths"], self._next_token]

    def _loop(self, key: Tuple[int, int, bool]) -> Tuple[torch.Tensor, ...]:
        """Run one greedy loop variant eagerly on the engine's tensors."""
        chunk, attn_len, piggy = key
        p_kw = {}
        if piggy:
            p_kw = {"p_tokens": self._p_tokens, "p_slots": self._p_slots,
                    "p_true_lens": self._p_true_lens}
        return engine_decode_loop(
            self.params, self.cfg, self._next_token, self.cache, self._active,
            num_steps=chunk, mesh=self.mesh, attn_len=attn_len, **p_kw)

    def _capture(self, key: Tuple[int, int, bool]) -> None:
        """Capture one greedy loop variant as a CUDA graph (``capture_loop``;
        the variant must have run eagerly before).

        All of an engine's graphs share one memory pool: a replay may
        overwrite another graph's outputs, but only one chunk is in flight
        and ``_finalize_chunk`` copies its outputs to the host before the
        next dispatch, so no live output is overwritten."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        self._graphs[key] = capture_loop(lambda: self._loop(key),
                                         self._graph_pool)

    def _greedy_loop(self, key: Tuple[int, int, bool]
                     ) -> Tuple[torch.Tensor, ...]:
        """Replay the variant's graph; a variant not yet captured runs
        eagerly and, on CUDA, is captured for its next dispatch."""
        captured = self._graphs.get(key)
        if captured is None:
            out = self._loop(key)
            if self.device.type == "cuda":
                self._capture(key)
            return out
        return replay_loop(captured)

    def _dispatch_chunk(self, loop_steps: int, piggy: Optional[Dict] = None):
        """Enqueue one fused decode chunk; returns the bookkeeping handle
        (device tokens, the slots active at entry, the piggyback payload and
        its first tokens). No sync."""
        entry_active = [i for i, r in enumerate(self.slots) if r is not None]
        amax = max((int(self._lengths_host[i]) for i in entry_active),
                   default=0)
        # attention window: the loop attends cache rows up to the entry
        # lengths of active slots, bucketed to 256s
        attn_len = min(self.max_len, -(-max(amax, 1) // 256) * 256)
        self._active_mask()
        sample_kw = self._sampling_arrays(self.slots)
        first_toks = None
        if sample_kw is not None:
            # decided over every slot, as JAX does; this rank's rows
            sample_kw = {k: v[self._lo:self._hi] for k, v in sample_kw.items()}
            toks, self.cache, _ = engine_decode_loop(
                self.params, self.cfg, self._next_token, self.cache,
                self._active, num_steps=loop_steps, mesh=self.mesh,
                attn_len=attn_len, generator=self._generator, **sample_kw)
        else:
            if piggy is not None:
                self._load_piggyback(piggy)
            out = self._greedy_loop((loop_steps, attn_len, piggy is not None))
            toks = out[0]
            if piggy is not None:
                first_toks = out[3]
        for i in entry_active:
            self._lengths_host[i] += loop_steps
        c = self.counters
        c["chunks"] = c.get("chunks", 0) + 1
        c["chunk_capacity_tokens"] = (c.get("chunk_capacity_tokens", 0)
                                      + loop_steps * self.max_batch)
        c["chunk_live_tokens"] = (c.get("chunk_live_tokens", 0)
                                  + loop_steps * len(entry_active))
        return toks, entry_active, piggy, first_toks

    def _finalize_chunk(self, handle) -> List[Request]:
        """Sync on a chunk's tokens and do the bookkeeping. Slots freed
        since dispatch are skipped; tokens past a budget or EOS are
        discarded. Copies the outputs to the host before anything else is
        dispatched: a captured loop's next replay overwrites them."""
        toks, entry_active, piggy, first_toks = handle
        toks_host = self._gather_slots(toks).cpu().numpy()
        finished = []
        if piggy is not None:
            # the piggybacked prompts' prefill finished inside the chunk:
            # first-token bookkeeping as in _finalize_admission
            first_host = first_toks.cpu().numpy()
            for g, (i, req) in enumerate(zip(piggy["slots"], piggy["reqs"])):
                tok = int(first_host[g])
                req.output.append(tok)
                del self._pending_prefill[i]
                if (req.max_new_tokens <= 1
                        or (req.eos_token is not None
                            and tok == req.eos_token)):
                    req.done = True
                    finished.append(req)
                else:
                    self.slots[i] = req
                    self._slot_budget[i] = req.max_new_tokens - 1
                    self._lengths_host[i] = len(req.prompt)
                    self._next_host[i] = tok
        for i in entry_active:
            req = self.slots[i]
            if req is None:
                continue
            emitted = [int(t) for t in toks_host[i]]
            take = min(self._slot_budget[i], len(emitted))
            if req.eos_token is not None and req.eos_token in emitted[:take]:
                take = emitted.index(req.eos_token) + 1
            req.output.extend(emitted[:take])
            self.counters["chunk_kept_tokens"] = (
                self.counters.get("chunk_kept_tokens", 0) + take)
            self._slot_budget[i] -= take
            # a slot truncated mid-chunk is always freed, and re-admission
            # prefills it from scratch
            if (self._slot_budget[i] <= 0
                    or (req.eos_token is not None
                        and req.output[-1] == req.eos_token)):
                req.done = True
                finished.append(req)
                self.slots[i] = None
                self._slot_budget[i] = 0
            else:
                self._next_host[i] = req.output[-1]
        self._load_next_tokens()
        return finished

    # -- admission ------------------------------------------------------------

    def _admit(self) -> List[Request]:
        """Synchronous admission (the per-step path)."""
        return self._finalize_admission(self._admit_async())

    def _admit_async(self) -> List[List[Tuple[int, Request]]]:
        """Admit queued requests into free slots through three lanes:

          * bucket: same-bucket prompts prefill together in one pass;
          * chunked: prompts longer than ``prefill_chunk`` (whose
            chunk-padded length fits max_len), grouped by chunk count,
            prefill chunk by chunk (``engine_prefill_chunk``);
          * prefix: prompts that start with a registered prefix get its
            stored rows copied into their slots, then prefill only the
            suffix chunks.

        The lane holding the oldest queued request runs first, so that
        sustained short traffic cannot starve a long prompt. A group is
        padded to the smallest power of two in [2, _ADMIT_G] that holds it
        by repeating its last request (duplicate slot writes are
        idempotent). Enqueue only: the first tokens go into ``_next_token``
        on the device and the host bookkeeping waits for
        ``_finalize_admission``."""
        free = [i for i in range(self.max_batch)
                if self.slots[i] is None and i not in self._pending_prefill]
        if not (free and self.queue):
            return []
        by_bucket: Dict[int, deque] = {}
        order: List[int] = []
        long_reqs: List[Request] = []
        by_prefix: Dict[Tuple[int, int, int], deque] = {}
        cc = self._CHUNK
        for req in self.queue:
            n_chunks = -(-len(req.prompt) // cc)
            if self._prefixes:
                m = self._match_prefix(req.prompt)
                if m is not None and n_chunks * cc <= self.max_len:
                    p, reuse = m
                    by_prefix.setdefault((p["id"], reuse, n_chunks),
                                         deque()).append(req)
                    continue
            if len(req.prompt) > cc and n_chunks * cc <= self.max_len:
                long_reqs.append(req)
                continue
            # clamp so a near-max_len prompt cannot pad past the cache
            bkt = min(_bucket(len(req.prompt)), self.max_len)
            if bkt not in by_bucket:
                by_bucket[bkt] = deque()
                order.append(bkt)
            by_bucket[bkt].append(req)
        admitted: set = set()
        nb = min(self._ADMIT_G, self.max_batch)
        if self.mesh is not None:
            # JAX's meshed widths: a multiple of the 'data' axis (which
            # max_batch is, so rounding up stays <= max_batch)
            nb = min(self.max_batch, -(-nb // self._dp) * self._dp)
        pending: List[List[Tuple[int, Request]]] = []

        def take_group(dq):
            group: List[Tuple[int, Request]] = []
            while free and dq and len(group) < nb:
                req = dq.popleft()
                admitted.add(id(req))
                group.append((free.pop(0), req))
            return group

        def padded_tokens(padded_group, width):
            tokens = np.full((len(padded_group), width), self.pad_token,
                             np.int64)
            for j, (_, r) in enumerate(padded_group):
                tokens[j, :len(r.prompt)] = r.prompt
            return tokens

        def prefill_chunks(padded_group, true_lens, slots, first, n_chunks):
            tokens = padded_tokens(padded_group, n_chunks * cc)
            logits = None
            for ci in range(first, n_chunks):
                logits, self.cache = self._prefill_chunk(ci * cc)(
                    params=self.params,
                    tokens=self._to_device(tokens[:, ci * cc:(ci + 1) * cc]),
                    true_lens=true_lens, slots=slots, cache=self.cache)
            return logits

        def run_bucket_lane():
            while free and any(by_bucket.values()):
                bucket = next(b for b in order if by_bucket[b])
                group = take_group(by_bucket[bucket])

                def prefill(padded_group, true_lens, slots, bucket=bucket):
                    logits, self.cache = engine_prefill_batch(
                        self.params, self.cfg,
                        self._to_device(padded_tokens(padded_group, bucket)),
                        true_lens, slots, self.cache, mesh=self.mesh)
                    return logits

                pending.append(self._admit_group(group, nb, prefill, bucket))

        def run_chunked_lane():
            # requests with the same chunk count share each chunk's pass
            by_chunks: Dict[int, deque] = {}
            for req in long_reqs:
                by_chunks.setdefault(-(-len(req.prompt) // cc),
                                     deque()).append(req)
            for n_chunks in sorted(by_chunks):
                dq = by_chunks[n_chunks]
                while free and dq:
                    group = take_group(dq)

                    def prefill(padded_group, true_lens, slots,
                                n_chunks=n_chunks):
                        return prefill_chunks(padded_group, true_lens, slots,
                                              0, n_chunks)

                    pending.append(self._admit_group(group, nb, prefill,
                                                     n_chunks * cc))

        def run_prefix_lane():
            for pkey in sorted(by_prefix):
                pid, reuse, n_chunks = pkey
                store = next(p["store"] for p in self._prefixes
                             if p["id"] == pid)
                dq = by_prefix[pkey]
                while free and dq:
                    group = take_group(dq)

                    def prefill(padded_group, true_lens, slots,
                                n_chunks=n_chunks, reuse=reuse, store=store):
                        self.cache = self._prefix_insert(
                            reuse, len(padded_group))(
                            cache=self.cache, store=store, slots=slots)
                        logits = prefill_chunks(padded_group, true_lens,
                                                slots, reuse // cc, n_chunks)
                        c = self.counters
                        c["prefix_hits"] = c.get("prefix_hits", 0) + len(group)
                        c["prefix_reused_tokens"] = (
                            c.get("prefix_reused_tokens", 0)
                            + reuse * len(group))
                        # the reused rows were never prefilled
                        c["prefill_real_tokens"] = (
                            c.get("prefill_real_tokens", 0)
                            - reuse * len(group))
                        return logits

                    pending.append(self._admit_group(
                        group, nb, prefill, n_chunks * cc - reuse))

        # anti-starvation: the lane of the oldest queued request runs first
        lanes = [run_bucket_lane, run_prefix_lane, run_chunked_lane]
        head = self.queue[0]
        if long_reqs and head is long_reqs[0]:
            lanes = [run_chunked_lane, run_prefix_lane, run_bucket_lane]
        elif any(head is r for dq in by_prefix.values() for r in dq):
            lanes = [run_prefix_lane, run_bucket_lane, run_chunked_lane]
        for lane in lanes:
            lane()
        if admitted:
            self.queue = deque(r for r in self.queue if id(r) not in admitted)
        return pending

    def _admit_group(self, group, nb: int, prefill_fn, padded_len: int
                     ) -> List[Tuple[int, Request]]:
        """The lanes' shared tail: pad the group to the smallest power of
        two in [2, nb] that holds it, count it, run the lane's
        ``prefill_fn(padded_group, true_lens, slots) -> logits``, sample,
        push the real rows' first tokens into ``_next_token`` on the device
        (``_finalize_admission`` reads them there) and take the slots.
        Returns the group.

        Under a mesh the width is also rounded up to a multiple of the
        ``'data'`` axis (JAX's), and each rank prefills only the padded rows
        whose slots it owns, ``slots`` indexing its local cache, so no row's
        K/V crosses ranks; a rank that owns none runs nothing."""
        nb_g = 2
        while nb_g < len(group):
            nb_g *= 2
        if self.mesh is not None:
            nb_g = -(-nb_g // self._dp) * self._dp
        nb = min(nb, nb_g)
        c = self.counters
        c["prefill_groups"] = c.get("prefill_groups", 0) + 1
        c["prefill_rows"] = c.get("prefill_rows", 0) + nb
        c["prefill_real_rows"] = c.get("prefill_real_rows", 0) + len(group)
        c["prefill_tokens"] = c.get("prefill_tokens", 0) + nb * padded_len
        c["prefill_real_tokens"] = (c.get("prefill_real_tokens", 0)
                                    + sum(len(r.prompt) for _, r in group))
        padded = group + [group[-1]] * (nb - len(group))
        # the padded rows whose slots this rank owns (all of them unmeshed)
        mine = [j for j, (i, _) in enumerate(padded) if self._lo <= i < self._hi]
        if mine:
            rows = [padded[j] for j in mine]
            true_lens = self._to_device(np.array(
                [len(r.prompt) for _, r in rows], np.int32))
            slots = self._to_device(np.array([i - self._lo for i, _ in rows],
                                             np.int64))
            logits = prefill_fn(rows, true_lens, slots)
            first = self._sample(logits, [r for _, r in rows])
            real = torch.tensor([k for k, j in enumerate(mine) if j < len(group)],
                                device=self.device)
            self._next_token[slots[real]] = first[real]
        for i, req in group:
            self.slots[i] = req
            self._lengths_host[i] = len(req.prompt)
            self._slot_budget[i] = req.max_new_tokens - 1
        return group

    # -- prefix cache ---------------------------------------------------------

    def register_prefix(self, tokens: List[int]) -> int:
        """Prefill a shared prompt prefix once into a KV store of its own.

        Only whole prefill chunks are stored (floor(len / prefill_chunk)
        chunks), so a hit's suffix prefill starts at a chunk boundary. The
        store is quantized as the main cache is, through the same chunked
        prefill, so a hit equals having prefilled those rows in place.
        Prompts match the longest registered prefix. Returns its id.

        Under a mesh every rank prefills the prefix alike into a store of
        its own KV heads (JAX's store: replicated over ``"data"``, heads
        over ``"model"``), from which it inserts only its own slots' rows.
        """
        cc = self._CHUNK
        rows = (len(tokens) // cc) * cc
        if rows < cc:
            raise ValueError(
                f"prefix must be >= prefill_chunk={cc} tokens to be worth "
                f"caching (got {len(tokens)})")
        if rows > self.max_len:
            raise ValueError("prefix longer than engine max_len")
        cfg = self.cfg
        kv_heads = (self.cache["k"].values if self._kv_quantization is not None
                    else self.cache["k"]).shape[2]
        if self._kv_quantization is not None:
            scratch = init_quantized_kv_cache(
                cfg.n_layers, 1, kv_heads, rows, cfg.head_dim,
                mode=self._kv_quantization, device=self.device)
        else:
            shape = (cfg.n_layers, 1, kv_heads, rows, cfg.head_dim)
            scratch = {"k": torch.zeros(shape, dtype=cfg.dtype,
                                        device=self.device),
                       "v": torch.zeros(shape, dtype=cfg.dtype,
                                        device=self.device)}
        scratch["lengths"] = torch.zeros((1,), dtype=torch.int32,
                                         device=self.device)
        scratch.pop("length", None)
        true_lens = self._to_device(np.array([rows], np.int32))
        slots = self._to_device(np.array([0], np.int64))
        for ci in range(rows // cc):
            toks = np.array([tokens[ci * cc:(ci + 1) * cc]], np.int64)
            _, scratch = self._prefill_chunk(ci * cc)(
                params=self.params, tokens=self._to_device(toks),
                true_lens=true_lens, slots=slots, cache=scratch)
        store = {}
        for name in ("k", "v"):
            kv = scratch[name]
            store[name] = (QTensor(kv.values[:, 0], kv.scales[:, 0],
                                   bits=kv.bits)
                           if isinstance(kv, QTensor) else kv[:, 0])
        pid = len(self._prefixes)
        self._prefixes.append({"id": pid, "tokens": tuple(tokens[:rows]),
                               "rows": rows, "store": store})
        self._prefixes.sort(key=lambda p: -p["rows"])  # longest first
        return pid

    def _match_prefix(self, prompt: List[int]):
        """(prefix entry, reused rows) for the longest registered prefix of
        ``prompt``, or None. The reuse is whole chunks strictly inside the
        prompt: at least one suffix token must remain to give the first
        token's logits."""
        cc = self._CHUNK
        cap = ((len(prompt) - 1) // cc) * cc
        for p in self._prefixes:
            reuse = min(p["rows"], cap)
            if reuse >= cc and tuple(prompt[:reuse]) == p["tokens"][:reuse]:
                return p, reuse
        return None

    def _prefix_insert(self, rows: int, width: int):
        """(cache, store, slots) -> cache: write the store's first ``rows``
        rows into ``width`` slots, in place (values and scales, or dense
        rows; fp8 values move as bytes)."""
        key = (rows, width)
        if key not in self._prefix_inserts:
            def insert(cache, store, slots):
                def wr(dst, src):
                    as_bytes(dst)[:, slots, :, :rows] = \
                        as_bytes(src)[:, None, :, :rows]

                for name in ("k", "v"):
                    ckv, skv = cache[name], store[name]
                    if isinstance(ckv, QTensor):
                        wr(ckv.values, skv.values)
                        wr(ckv.scales, skv.scales)
                    else:
                        wr(ckv, skv)
                return cache

            self._prefix_inserts[key] = insert
        return self._prefix_inserts[key]

    def _prefill_chunk(self, offset: int):
        """The chunked prefill at column ``offset``, called with keywords
        (params, tokens, true_lens, slots, cache)."""
        if offset not in self._prefill_chunks:
            self._prefill_chunks[offset] = functools.partial(
                engine_prefill_chunk, cfg=self.cfg, offset=offset,
                mesh=self.mesh)
        return self._prefill_chunks[offset]

    def _finalize_admission(self, pending) -> List[Request]:
        """One sync for the whole admission round, then bookkeeping:
        first-token append, EOS / 1-token finishes, next-token mirror."""
        finished: List[Request] = []
        if not pending:
            return finished
        # each first token sits at its slot, on the rank that owns it
        first = self._gather_slots(self._next_token).cpu().numpy()
        for group in pending:
            for i, req in group:
                tok = int(first[i])
                req.output.append(tok)
                if (req.max_new_tokens <= 1
                        or (req.eos_token is not None
                            and tok == req.eos_token)):
                    req.done = True
                    finished.append(req)
                    self.slots[i] = None
                    self._slot_budget[i] = 0
                else:
                    self._next_host[i] = tok
        return finished

    def _sampling_arrays(self, rows: List[Optional[Request]]) -> Optional[Dict]:
        """Per-row sampling settings as (B,) device tensors, or None if every
        row is greedy; top_k/top_p only when some sampling row truncates."""
        temps = [r.temperature if r is not None else 0.0 for r in rows]
        if not any(t > 0 for t in temps):
            return None
        kw = {"temps": self._to_device(np.array(temps, np.float32))}
        if any(r is not None and r.temperature > 0
               and (r.top_k > 0 or r.top_p < 1.0) for r in rows):
            kw["top_k"] = self._to_device(np.array(
                [r.top_k if r is not None else 0 for r in rows], np.int64))
            kw["top_p"] = self._to_device(np.array(
                [r.top_p if r is not None else 1.0 for r in rows], np.float32))
        return kw

    def _sample(self, logits: torch.Tensor,
                reqs: List[Optional[Request]]) -> torch.Tensor:
        """Greedy at temperature 0, else per-row temperature/top-k/top-p.
        ``reqs`` holds one Request (or None = greedy) per logits row."""
        kw = self._sampling_arrays(reqs[:logits.shape[0]])
        if kw is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_tokens(logits, self._generator, kw["temps"],
                             kw.get("top_k"), kw.get("top_p"))
