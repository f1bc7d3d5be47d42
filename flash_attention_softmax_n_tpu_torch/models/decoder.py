"""Llama-style decoder with softmax-N attention.

Counterpart of ``flash_attention_softmax_n_tpu/models/decoder.py``. Layer
weights are stacked on axis 0 as in the JAX parameter tree; the JAX
``lax.scan`` over layers is a Python loop here. ``decoder_forward`` and
prefill run causal ``flash_attention_n`` (kernel K1 on the card, with K5/K6
as its backward when training); decode attends a KV cache with the ``+n``
term in every step's denominator. Under a mesh ``decoder_forward`` runs
on one rank's explicit shards (``parallel/sharding.py``): Megatron tensor
parallelism over ``"model"`` (``tp_mesh``, or the weights' own shapes under
``sp_mesh``) and ring attention over a sequence axis (``sp_mesh``).
Quantized weights route as in JAX
(``_mm``): int8 to ``x @ dequantize(w)`` on the ``"xla"`` route and to the
dequant matmul K7 on the ``"pallas"`` route, int4 and W8A8 to K7, fp8 to
``x @ dequantize(w)`` on either route, and the decode SwiGLU block to the
fused MLP K9 where JAX fuses it (``_mlp_fusable``). KV caches are dense,
int8 or fp8.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    dropout_multiplier,
)
from flash_attention_softmax_n_tpu_torch.kernels.fused_mlp import (
    fused_mlp_matmul,
    mlp_fusion_eligible,
)
from flash_attention_softmax_n_tpu_torch.kernels.quant_matmul import (
    quantized_matmul,
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
from flash_attention_softmax_n_tpu_torch.quant.qtensor import (
    QTensor,
    dequantize,
)

__all__ = ["DecoderConfig", "init_decoder_params", "decoder_forward",
           "prefill", "decode_step", "greedy_generate", "init_kv_cache"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 5632
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    softmax_n: float = 1.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # 'auto'/'pallas': the fused forward (K1); 'xla': unfused tensor ops
    attn_implementation: str = "auto"
    # recompute each layer in the backward instead of storing its
    # activations (torch.utils.checkpoint; JAX's jax.checkpoint)
    remat: bool = False
    # attention-probability dropout, active only under
    # decoder_forward(train=True); the in-kernel hash on the fused route
    attn_dropout: float = 0.0
    # 8: quantize the activations of quantized matmuls per row (W8A8 on
    # the dequant matmul K7)
    act_bits: Any = None
    # int8 matmuls: "xla" x @ dequantize(w); "pallas" the dequant matmul
    # K7, and the decode MLP on the fused kernel K9 (int4 and W8A8 take K7
    # on either route)
    int8_mm_impl: str = "xla"
    # engine decode attention: "xla" plain ops over the padded cache;
    # "pallas" the kernel K8, which reads only each slot's valid rows
    decode_attn_impl: str = "xla"

    def __post_init__(self):
        if self.act_bits not in (None, 8):
            raise ValueError(f"act_bits must be None or 8, got {self.act_bits}")
        for name in ("int8_mm_impl", "decode_attn_impl"):
            if getattr(self, name) not in ("xla", "pallas"):
                raise ValueError(f"{name} must be 'xla' or 'pallas', got "
                                 f"{getattr(self, name)!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_decoder_params(cfg: DecoderConfig,
                        generator: Union[int, torch.Generator] = 0, *,
                        device=None) -> Dict:
    """Random-init parameter dict (layer weights stacked on axis 0).

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed for
    one. The numbers differ from ``jax.random``'s; tests carry JAX's
    parameters across with ``params_from_jax`` instead.
    """
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    d, hd = cfg.d_model, cfg.head_dim
    nl, h, kvh, f = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": dense((cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": ones((nl, d)),
            "wq": dense((nl, d, h * hd), d),
            "wk": dense((nl, d, kvh * hd), d),
            "wv": dense((nl, d, kvh * hd), d),
            "wo": dense((nl, h * hd, d), h * hd),
            "mlp_norm": ones((nl, d)),
            "w_gate": dense((nl, d, f), d),
            "w_up": dense((nl, d, f), d),
            "w_down": dense((nl, f, d), f),
        },
        "final_norm": ones((d,)),
        "lm_head": dense((d, cfg.vocab_size), d),
    }


def _mm(x: torch.Tensor, w, act_bits=None,
        int8_mm_impl: str = "xla") -> torch.Tensor:
    """x @ w for a dense weight; for a QTensor, as JAX's ``_mm`` routes it:
    fp8, and int4 with K % 256, dequantize inline, int8 without
    ``act_bits`` on the ``"xla"`` route is ``x @ dequantize(w, x.dtype)``
    (f32 scale multiply, then one cast), and everything else goes to the
    dequant matmul K7 (``act_bits=8``: W8A8)."""
    if isinstance(w, QTensor):
        k = w.logical_shape[-2]
        if w.bits == -8 or (w.bits == 4 and k % 256):
            return x @ dequantize(w, x.dtype)
        if (w.bits == 8 and act_bits != 8 and w.packed_axis is None
                and int8_mm_impl == "xla"):
            return x @ dequantize(w, x.dtype)
        return quantized_matmul(x, w.values, w.scales, bits=w.bits,
                                act_quant=act_bits == 8)
    return x @ w


def _mlp_fusable(h: torch.Tensor, lp: Dict, act_bits,
                 int8_mm_impl: str = "xla", d_ff: Optional[int] = None) -> bool:
    """Does JAX route this SwiGLU block to the fused MLP kernel? int8
    unpacked gate/up/down on the ``"pallas"`` route, one token per row
    (L == 1), no activation quantization, and a shape that
    ``mlp_fusion_eligible`` takes. ``d_ff``: the whole model's, when the
    weights are a tensor-parallel shard of it (JAX decides on the global
    shapes)."""
    ws = [lp.get("w_gate"), lp.get("w_up"), lp.get("w_down")]
    if int8_mm_impl != "pallas":
        return False
    if act_bits is not None or h.shape[-2] != 1 or not all(
            isinstance(w, QTensor) and w.bits == 8 and w.packed_axis is None
            for w in ws):
        return False
    m_total = math.prod(h.shape[:-1])
    k, f = ws[0].values.shape
    return (tuple(ws[1].values.shape) == (k, f)
            and tuple(ws[2].values.shape) == (f, k)
            and mlp_fusion_eligible(m_total, k, d_ff or f, 8))


def layer_views(layers: Dict) -> List[Dict]:
    """Every layer's views of the stacked layer weights.

    Taken at once with ``torch.unbind``, so the backward stacks the layers'
    gradients once; a ``select`` per layer would instead add a zero-filled
    gradient of the whole stack for every layer.
    """
    cols = {}
    for k, v in layers.items():
        if isinstance(v, QTensor):
            cols[k] = [QTensor(a, s, bits=v.bits, packed_axis=v.packed_axis)
                       for a, s in zip(torch.unbind(v.values),
                                       torch.unbind(v.scales))]
        else:
            cols[k] = torch.unbind(v)
    n_layers = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n_layers)]


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.reshape(b, l, n_heads, -1).transpose(1, 2)  # (B, H, L, hd)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, kvh, l, hd = x.shape
    return x[:, :, None].expand(b, kvh, n_rep, l, hd).reshape(b, kvh * n_rep,
                                                              l, hd)


def _cols(w) -> int:
    return (w.logical_shape if isinstance(w, QTensor) else w.shape)[-1]


class _TensorParallel:
    """How this rank's weights split the decoder over ``mesh``'s
    ``"model"`` axis, read from their local shapes: any mix of sharded and
    replicated leaves (``_fit_spec`` replicates what does not divide).
    Megatron's pairing: a replicated activation enters column-parallel
    products through ``copy_to_axis`` (all-reduce backward) and leaves
    row-parallel ones through ``reduce_from_axis`` (all-reduce forward).
    Without a mesh every method is the identity."""

    def __init__(self, cfg: DecoderConfig, params: Dict, mesh=None):
        layers, hd = params["layers"], cfg.head_dim
        self.mesh = mesh
        self.q_sharded = self.kv_sharded = self.mlp_sharded = False
        self.embed_sharded = self.vocab_sharded = False
        self.kv_index, self.reps = None, cfg.n_heads // cfg.n_kv_heads
        if mesh is None:
            return
        # imported here: the parallel package imports this module
        from flash_attention_softmax_n_tpu_torch.parallel import sharding
        from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
            axis_index,
            axis_size,
        )
        self._sharding = sharding
        if "wqkv" in layers or "w_gu" in layers:
            if axis_size(mesh, "model") > 1:
                raise ValueError(
                    "fused projections (wqkv/w_gu) cannot be tensor-sharded: "
                    "the Megatron column split would cut across q/k/v "
                    "boundaries. Quantize without fuse_decoder_projections "
                    "for TP.")
            return
        hq, hkv = _cols(layers["wq"]), _cols(layers["wk"])
        if hq % hd or hkv % hd:
            raise ValueError(
                f"a tensor-parallel shard of wq/wk ({hq}/{hkv} columns) "
                f"splits a head of {hd}: pad the heads to a multiple of the "
                "'model' axis")
        hq, hkv = hq // hd, hkv // hd
        tp = axis_index(mesh, "model")
        self.q_sharded = hq < cfg.n_heads
        self.kv_sharded = hkv < cfg.n_kv_heads
        self.mlp_sharded = _cols(layers["w_gate"]) < cfg.d_ff
        self.embed_sharded = _cols(params["embed"]) < cfg.d_model
        self.vocab_sharded = _cols(params["lm_head"]) < cfg.vocab_size
        # the kv heads this rank's query heads read, as indices into its
        # local k/v (all kv heads once gathered when q is replicated)
        rep = cfg.n_heads // cfg.n_kv_heads
        q0 = tp * hq if self.q_sharded else 0
        kv0 = tp * hkv if self.kv_sharded and self.q_sharded else 0
        need = [(q0 + i) // rep - kv0 for i in range(hq)]
        local = hkv if self.q_sharded or not self.kv_sharded else cfg.n_kv_heads
        if min(need) < 0 or max(need) >= local:
            raise ValueError(
                "a tensor-parallel shard's query heads read kv heads of "
                f"another shard ({cfg.n_heads} q, {cfg.n_kv_heads} kv heads): "
                "shard wk/wv like wq or replicate them")
        uniq = sorted(set(need))
        grouped = [u for u in uniq for _ in range(hq // len(uniq))]
        if need == grouped:
            self.reps = hq // len(uniq)
            self.kv_index = None if uniq == list(range(local)) else uniq
        else:
            self.reps, self.kv_index = 1, need

    def _enter(self, h, sharded):
        return self._sharding.copy_to_axis(h, self.mesh, "model") if sharded else h

    def _leave(self, y, sharded):
        return (self._sharding.reduce_from_axis(y, self.mesh, "model")
                if sharded else y)

    def _gather(self, x, dim):
        return self._sharding.gather_from_axis(x, self.mesh, "model", dim)

    def attn_in(self, h, lp):
        """(h, wk, wv) for the q/k/v products. A replicated wk/wv read by
        sharded query heads takes the all-reduce backward too: each rank
        differentiates only its heads' share of it."""
        h = self._enter(h, self.q_sharded or self.kv_sharded)
        wk, wv = lp["wk"], lp["wv"]
        if self.q_sharded and not self.kv_sharded:
            wk, wv = self._enter(wk, True), self._enter(wv, True)
        return h, wk, wv

    def kv_heads(self, k):
        """This rank's query heads' kv heads, unrepeated: gathered when
        only the kv projection is sharded, then selected."""
        if self.kv_sharded and not self.q_sharded:
            k = self._gather(k, 1)
        return k if self.kv_index is None else k[:, self.kv_index]

    def attn_out(self, y):
        return self._leave(y, self.q_sharded)

    def mlp_in(self, h):
        return self._enter(h, self.mlp_sharded)

    def mlp_out(self, y):
        return self._leave(y, self.mlp_sharded)

    def embedding(self, x):
        return self._gather(x, -1) if self.embed_sharded else x

    def logits(self, x, lm_head, cfg: DecoderConfig):
        """lm_head's logits, all-gathered along vocab when it is sharded
        (before the f32 log-softmax; a vocab-parallel loss is later work)."""
        x = self._enter(x, self.vocab_sharded)
        y = _mm(x, lm_head, cfg.act_bits, cfg.int8_mm_impl)
        return self._gather(y, -1) if self.vocab_sharded else y


def _layer(cfg: DecoderConfig, x, lp, attn_fn, tp: "_TensorParallel" = None):
    """One transformer block. ``attn_fn(q, k, v) -> (ctx, extras)``.

    Fused projections (``wqkv`` for wq/wk/wv, ``w_gu`` for w_gate/w_up) are
    split here. ``tp`` places the block's collectives when the weights are
    a rank's tensor-parallel shards; q/k/v carry as many heads as the local
    projections give.
    """
    ab, mi = cfg.act_bits, cfg.int8_mm_impl

    def mm(a, w):
        return _mm(a, w, ab, mi)

    def heads(y):
        return _split_heads(y, y.shape[-1] // cfg.head_dim)

    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    if "wqkv" in lp:
        qd = cfg.n_heads * cfg.head_dim
        kvd = cfg.n_kv_heads * cfg.head_dim
        qkv = mm(h, lp["wqkv"])
        q = _split_heads(qkv[..., :qd], cfg.n_heads)
        k = _split_heads(qkv[..., qd:qd + kvd], cfg.n_kv_heads)
        v = _split_heads(qkv[..., qd + kvd:], cfg.n_kv_heads)
    else:
        wk, wv = lp["wk"], lp["wv"]
        if tp is not None:
            h, wk, wv = tp.attn_in(h, lp)
        q, k, v = heads(mm(h, lp["wq"])), heads(mm(h, wk)), heads(mm(h, wv))
    ctx, extras = attn_fn(q, k, v)
    attn_out = mm(_merge_heads(ctx), lp["wo"])
    if tp is not None:
        attn_out = tp.attn_out(attn_out)
    x = x + attn_out
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if "w_gu" in lp:
        gate, up = torch.chunk(mm(h, lp["w_gu"]), 2, dim=-1)
        mlp = mm(F.silu(gate) * up, lp["w_down"])
    elif _mlp_fusable(h, lp, ab, mi, cfg.d_ff if tp is not None
                      and tp.mlp_sharded else None):
        # on a shard of d_ff: K9 over the rank's slice, then the
        # row-parallel sum
        wg, wu, wd = lp["w_gate"], lp["w_up"], lp["w_down"]
        if tp is not None:
            h = tp.mlp_in(h)
        mlp = fused_mlp_matmul(h, wg.values, wg.scales, wu.values, wu.scales,
                               wd.values, wd.scales)
        if tp is not None:
            mlp = tp.mlp_out(mlp)
    else:
        if tp is not None:
            h = tp.mlp_in(h)
        mlp = mm(F.silu(mm(h, lp["w_gate"])) * mm(h, lp["w_up"]),
                 lp["w_down"])
        if tp is not None:
            mlp = tp.mlp_out(mlp)
    x = x + mlp
    return x, attn_out, extras


def _rope(cfg: DecoderConfig, device):
    return rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta,
                            device=device)


def decoder_forward(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                    *, collect_taps: bool = False, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    output_attentions: bool = False, sp_mesh=None,
                    sp_axis: str = "sp", tp_mesh=None,
                    data_axes: Sequence[str] = ("data",)) -> Any:
    """Full-sequence causal forward: tokens (B, L) -> logits (B, L, V) f32.

    ``collect_taps=True`` also returns the taps for the analysis collector:
    'layers.{i}.attention.output' -> (B, L, D), each layer's attention
    output projection. ``output_attentions=True`` takes the materializing
    path instead of ``flash_attention_n`` (f32 scores, causal -inf,
    softmax-N, dropout under ``train``) and also returns the probabilities,
    (n_layers, B, H, L, L). The return is ``logits[, taps][, probs]``.

    ``train=True`` activates ``cfg.attn_dropout``, which then needs
    ``generator``: one int32 seed per layer is drawn from it, and both
    paths drop with K1's hash mask of that seed. ``cfg.remat`` recomputes
    each layer in the backward (``torch.utils.checkpoint``).

    Meshes (every rank of the mesh calls this on its own shards):
    ``params`` are this rank's slices (``parallel.shard_pytree``) and
    ``tokens`` its rows of the batch, split over ``data_axes``. Weights
    sharded over ``"model"`` run Megatron tensor parallelism (the logits
    come back whole). ``tp_mesh``: attention runs ``flash_attention_n`` on
    the local (batch, head) slab, its dropout mask bit-identical to one
    device's. ``sp_mesh``: ``tokens`` are also this rank's sequence shard
    over ``sp_axis``, RoPE takes global positions, and attention runs as
    ``ring_attention_n`` with GQA K/V unrepeated; dropout and
    ``output_attentions`` raise there (the ring never forms the
    probabilities), and ``output_attentions`` raises under ``tp_mesh`` too.
    """
    b, l = tokens.shape
    dp = cfg.attn_dropout if train else 0.0
    if dp > 0.0 and generator is None:
        raise ValueError("train=True with cfg.attn_dropout > 0 requires "
                         "generator")
    if dp > 0.0 and sp_mesh is not None:
        raise NotImplementedError(
            "ring (sequence-parallel) attention has no dropout path; "
            "train with tp_mesh or dp-only sharding instead")
    if output_attentions and (sp_mesh is not None or tp_mesh is not None):
        raise NotImplementedError(
            "output_attentions materializes (B, H, L, L) probabilities; "
            "the sharded paths never form them — run without a mesh")
    mesh = sp_mesh if sp_mesh is not None else tp_mesh
    tp = _TensorParallel(cfg, params, mesh)
    x = tp.embedding(params["embed"][tokens].to(cfg.dtype))
    cos, sin = _rope(cfg, x.device)
    positions = torch.arange(l, device=x.device)
    if sp_mesh is not None:
        from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
            axis_index,
        )
        from flash_attention_softmax_n_tpu_torch.parallel.ring_attention import (  # noqa: E501
            ring_attention_n,
        )
        positions = positions + axis_index(sp_mesh, sp_axis) * l
    # every layer's seed is drawn before any layer runs: checkpoint replays
    # the default generators in the recompute but not a caller's, so a seed
    # drawn inside a checkpointed layer would give the recompute another mask
    seeds = [None] * cfg.n_layers
    if dp > 0.0:
        seeds = torch.randint(0, 2 ** 31 - 1, (cfg.n_layers,),
                              generator=generator, device=generator.device,
                              dtype=torch.int32).to(x.device)

    def materialized(q, k, v, seed):
        scores = torch.einsum("bhle,bhse->bhls", q.float(), k.float())
        scores = scores * cfg.head_dim ** -0.5
        causal = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        probs = softmax_n(scores, n=cfg.softmax_n, axis=-1)
        if dp > 0.0:
            probs = probs * dropout_multiplier(seed, probs.shape, dp,
                                               probs.device)
        ctx = torch.einsum("bhls,bhsv->bhlv", probs.to(q.dtype), v)
        return ctx, probs

    def block(x, lp, seed):
        def attn(q, k, v):
            q = apply_rope(q, cos, sin, positions)
            k, v = tp.kv_heads(apply_rope(k, cos, sin, positions)), tp.kv_heads(v)
            if sp_mesh is not None:
                # GQA kv stays unrepeated: the ring rotates the small heads
                ctx = ring_attention_n(
                    q, k, v, mesh=sp_mesh, axis_name=sp_axis,
                    softmax_n_param=cfg.softmax_n, is_causal=True,
                    implementation=cfg.attn_implementation)
                return ctx, None
            k, v = _repeat_kv(k, tp.reps), _repeat_kv(v, tp.reps)
            if output_attentions:
                return materialized(q, k, v, seed)
            ctx = flash_attention_n(
                q, k, v, softmax_n_param=cfg.softmax_n, is_causal=True,
                dropout_p=dp, train=train, dropout_seed=seed,
                implementation=cfg.attn_implementation, mesh=tp_mesh,
                batch_axis=tuple(data_axes),
                head_axis="model" if tp.q_sharded else None)
            return ctx, None

        x, attn_out, probs = _layer(cfg, x, lp, attn, tp)
        return x, attn_out if collect_taps else None, probs

    taps, probs = [], []
    for lp, seed in zip(layer_views(params["layers"]), seeds):
        if cfg.remat:
            x, tap, p = checkpoint(block, x, lp, seed, use_reentrant=False)
        else:
            x, tap, p = block(x, lp, seed)
        taps.append(tap)
        probs.append(p)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = tp.logits(x, params["lm_head"], cfg).float()
    out = (logits,)
    if collect_taps:
        out += ({f"layers.{i}.attention.output": t
                 for i, t in enumerate(taps)},)
    if output_attentions:
        out += (torch.stack(probs),)
    return out[0] if len(out) == 1 else out


# ----------------------------------------------------------------------------
# KV-cache inference
# ----------------------------------------------------------------------------


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: Optional[int] = None,
                  dtype: Optional[Any] = None,
                  quantization: Optional[str] = None, *, device=None) -> Dict:
    """Preallocated KV cache (n_layers, B, KVH, S, hd); ``quantization``
    None (dense), 'int8' or 'fp8'. ``length`` is a host int."""
    dev = resolve_device(device)
    s = max_len or cfg.max_seq_len
    if quantization is not None:
        from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
            init_quantized_kv_cache,
        )
        cache = init_quantized_kv_cache(cfg.n_layers, batch, cfg.n_kv_heads,
                                        s, cfg.head_dim, mode=quantization,
                                        device=dev)
        cache["length"] = 0
        return cache
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, s, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "length": 0}


def _is_quantized_cache(cache: Dict) -> bool:
    return isinstance(cache["k"], QTensor)


def prefill(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
            cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt (B, L), fill the cache in place, return the
    last-token logits (B, V) and the cache."""
    b, l = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    cos, sin = _rope(cfg, x.device)
    positions = torch.arange(l, device=x.device)
    reps = cfg.n_heads // cfg.n_kv_heads
    quantized = _is_quantized_cache(cache)
    layers = layer_views(params["layers"])

    for i in range(cfg.n_layers):
        def attn(q, k, v, i=i):
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            if quantized:
                from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
                    quantize_kv,
                )
                for name, new in (("k", k), ("v", v)):
                    values, scales = quantize_kv(new, cache[name].bits)
                    cache[name].values[i, :, :, :l] = values
                    cache[name].scales[i, :, :, :l] = scales
            else:
                cache["k"][i, :, :, :l] = k.to(cache["k"].dtype)
                cache["v"][i, :, :, :l] = v.to(cache["v"].dtype)
            ctx = flash_attention_n(
                q, _repeat_kv(k, reps), _repeat_kv(v, reps),
                softmax_n_param=cfg.softmax_n, is_causal=True,
                implementation=cfg.attn_implementation)
            return ctx, None

        x, _, _ = _layer(cfg, x, layers[i], attn)
    cache["length"] = l

    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = _mm(x, params["lm_head"], cfg.act_bits,
                 cfg.int8_mm_impl).float()
    return logits[:, 0], cache


def _cached_attention(cfg: DecoderConfig, q, k_cache, v_cache, length):
    """Single-step attention over the dense cache; valid keys [0, length)."""
    reps = cfg.n_heads // cfg.n_kv_heads
    kf = _repeat_kv(k_cache, reps)
    vf = _repeat_kv(v_cache, reps)
    scores = torch.einsum("bhle,bhse->bhls", q.float(), kf.float())
    scores = scores * (cfg.head_dim ** -0.5)
    s = kf.shape[2]
    valid = torch.arange(s, device=q.device)[None, None, None, :] < length
    scores = torch.where(valid, scores, NEG_INF)
    probs = softmax_n(scores, n=cfg.softmax_n, axis=-1)
    return torch.einsum("bhls,bhsv->bhlv", probs.to(vf.dtype), vf)


def decode_step(params: Dict, cfg: DecoderConfig, token: torch.Tensor,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One greedy-decode step: token (B,) -> (logits (B, V), cache), the
    cache written in place at position ``cache['length']``."""
    b = token.shape[0]
    x = params["embed"][token][:, None].to(cfg.dtype)  # (B, 1, D)
    cos, sin = _rope(cfg, x.device)
    pos = int(cache["length"])
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    quantized = _is_quantized_cache(cache)
    layers = layer_views(params["layers"])

    for i in range(cfg.n_layers):
        def attn(q, k, v, i=i):
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            if quantized:
                from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
                    cached_attention_quantized,
                    update_quantized_cache,
                )
                kc, vc = (QTensor(cache[n].values[i], cache[n].scales[i],
                                  bits=cache[n].bits) for n in ("k", "v"))
                update_quantized_cache(kc, k, pos)
                update_quantized_cache(vc, v, pos)
                ctx = cached_attention_quantized(
                    q, kc, vc, pos + 1, softmax_n_param=cfg.softmax_n,
                    scale=cfg.head_dim ** -0.5, compute_dtype=cfg.dtype)
            else:
                kc, vc = cache["k"][i], cache["v"][i]
                kc[:, :, pos] = k[:, :, 0].to(kc.dtype)
                vc[:, :, pos] = v[:, :, 0].to(vc.dtype)
                ctx = _cached_attention(cfg, q, kc, vc, pos + 1)
            return ctx.to(x.dtype), None

        x, _, _ = _layer(cfg, x, layers[i], attn)
    cache["length"] = pos + 1

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm(x, params["lm_head"], cfg.act_bits,
                 cfg.int8_mm_impl).float()
    return logits[:, 0], cache


def greedy_generate(params: Dict, cfg: DecoderConfig, prompt,
                    max_new_tokens: int,
                    kv_quantization: Optional[str] = None, *,
                    device=None) -> torch.Tensor:
    """Greedy decoding: prompt (B, L) -> generated tokens (B, max_new_tokens)
    int32. ``kv_quantization``: None, 'int8' or 'fp8'."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, l = prompt.shape
    cache = init_kv_cache(cfg, b, max_len=l + max_new_tokens,
                          quantization=kv_quantization, device=dev)
    logits, cache = prefill(params, cfg, prompt, cache)
    token = torch.argmax(logits, dim=-1)
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, cfg, token, cache)
        token = torch.argmax(logits, dim=-1)
        out.append(token)
    return torch.stack(out, dim=1).to(torch.int32)
