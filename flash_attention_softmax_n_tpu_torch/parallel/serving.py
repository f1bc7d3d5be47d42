"""Tensor/data-parallel serving: the sharded continuous-batching decode.

Counterpart of ``flash_attention_softmax_n_tpu/parallel/serving.py``. The
layout is JAX's: weights Megatron-sharded over the ``"model"`` axis (the
rules of ``parallel/sharding.py``), slots and their KV cache rows and
lengths over ``"data"``, KV heads over ``"model"``. The design is one
process per rank instead of one controller: every rank holds its local
shards as plain tensors and runs the decode on them; the tensor-parallel
collectives are the decoder's explicit ones (``models/decoder.py``
``_TensorParallel``), the cache writes K3/K4 touch only the rank's own
slots and heads, and greedy tokens come from K2 over the rank's vocab
shard with a cross-shard merge (``engine._sharded_lm_head_argmax``). Rank
``d`` on ``"data"`` owns the global slots ``[d * B/dp, (d + 1) * B/dp)``.

Use ``shard_engine_state(params, cache, mesh)`` for this rank's shards and
``make_sharded_decode(cfg, mesh, num_steps=...)`` for the fused loop over
them; ``InferenceEngine(..., mesh=mesh)`` serves on the same layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from flash_attention_softmax_n_tpu_torch.models.decoder import DecoderConfig
from flash_attention_softmax_n_tpu_torch.parallel.mesh import axis_size
from flash_attention_softmax_n_tpu_torch.parallel.sharding import (
    decoder_param_specs,
    kv_cache_specs,
    shard_pytree,
)
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor

__all__ = ["shard_engine_state", "make_sharded_decode", "check_serving_mesh"]


def _check_mesh(mesh) -> None:
    names = tuple(mesh.mesh_dim_names or ())
    missing = {"data", "model"} - set(names)
    if missing:
        raise ValueError(
            f"serving mesh needs axes 'data' (slots) and 'model' (TP); "
            f"missing {sorted(missing)}. Got axes {list(names)} — "
            f"use make_mesh({{'data': dp, 'model': tp}}).")


def check_serving_mesh(mesh, params: Dict, max_batch: int,
                       n_kv_heads: int) -> None:
    """JAX's checks of a serving layout: the axes, ``max_batch`` over
    ``'data'``, ``n_kv_heads`` over ``'model'``, and no fused projections."""
    _check_mesh(mesh)
    dp, tp = axis_size(mesh, "data"), axis_size(mesh, "model")
    if max_batch % dp != 0:
        raise ValueError(
            f"max_batch={max_batch} must be divisible by the 'data' "
            f"axis size {dp} (slots are data-sharded)")
    if n_kv_heads % tp != 0:
        raise ValueError(
            f"n_kv_heads={n_kv_heads} must be divisible by the 'model' "
            f"axis size {tp} (KV heads are tensor-sharded)")
    if "wqkv" in params.get("layers", {}):
        raise ValueError(
            "fused projections (wqkv/w_gu) cannot be tensor-sharded: the "
            "Megatron column split would cut across q/k/v boundaries. "
            "Quantize without fuse_decoder_projections for TP serving.")


def shard_engine_state(params: Dict, cache: Dict, mesh) -> Tuple[Dict, Dict]:
    """This rank's shards of the whole ``params`` (TP over ``'model'``) and
    KV ``cache`` (slots over ``'data'``, KV heads over ``'model'``), on the
    mesh's device. Every rank passes the same whole tensors."""
    kv = cache.get("k")
    if kv is not None:
        shape = kv.values.shape if isinstance(kv, QTensor) else kv.shape
        check_serving_mesh(mesh, params, shape[1], shape[2])
    else:
        check_serving_mesh(mesh, params, 1, 1)
    params = shard_pytree(params, decoder_param_specs(params), mesh)
    cache = shard_pytree(cache, kv_cache_specs(cache), mesh)
    return params, cache


def _clone_cache(cache: Dict) -> Dict:
    out = {}
    for name, t in cache.items():
        if isinstance(t, QTensor):
            out[name] = QTensor(t.values.clone(), t.scales.clone(), bits=t.bits,
                                packed_axis=t.packed_axis)
        elif isinstance(t, torch.Tensor):
            out[name] = t.clone()
        else:
            out[name] = t
    return out


def make_sharded_decode(cfg: DecoderConfig, mesh, *, num_steps: int = 1,
                        eos_token: Optional[int] = None,
                        temperature: float = 0.0,
                        per_slot_sampling: bool = False,
                        donate: bool = True):
    """The fused decode loop over this rank's slots.

    Returns ``loop(params, tokens, cache, active) -> (tokens_out (B/dp,
    num_steps), cache, active)`` over this rank's shards from
    ``shard_engine_state`` and its slots' ``tokens`` and ``active`` (B/dp,).
    Every rank of the mesh calls it together (the tensor-parallel
    collectives run over ``'model'``). ``temperature > 0`` samples every
    slot at that temperature; then, and with ``per_slot_sampling=True``,
    the loop takes a ``torch.Generator`` (each rank's own; the ranks of one
    ``'model'`` group must seed theirs alike): ``loop(params, tokens, cache,
    active, generator[, temps, top_k, top_p])`` with (B/dp,) settings.
    ``donate=False`` runs on a copy of the cache (JAX's donation is the
    port's in-place default).
    """
    from flash_attention_softmax_n_tpu_torch.engine.engine import (
        engine_decode_loop,
    )
    _check_mesh(mesh)

    def run(params, tokens, cache, active, **kw):
        if not donate:
            cache = _clone_cache(cache)
        return engine_decode_loop(params, cfg, tokens, cache, active,
                                  num_steps=num_steps, eos_token=eos_token,
                                  mesh=mesh, **kw)

    if per_slot_sampling:
        def loop(params, tokens, cache, active, generator, temps,
                 top_k=None, top_p=None):
            return run(params, tokens, cache, active, generator=generator,
                       temps=temps, top_k=top_k, top_p=top_p)
    elif temperature > 0.0:
        def loop(params, tokens, cache, active, generator):
            return run(params, tokens, cache, active, generator=generator,
                       temperature=temperature)
    else:
        def loop(params, tokens, cache, active):
            return run(params, tokens, cache, active)
    return loop
