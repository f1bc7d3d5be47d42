"""Decode tokens/s of 7B-class decoders on one card, after
``scripts/bench_7b.py``.

``BASELINE.json``'s metric is "tokens/sec/chip at 7B (softmax1 + INT8
KV-cache)". This script serves the two geometries of the JAX script
(``CONFIGS``) at their published widths and full depth:

  * Llama-7B: 32 layers, d 4096, 32 heads over 32 KV heads (MHA), head dim
    128, d_ff 11008, vocab 32000; batches 48, then 32;
  * Llama-3-8B: 32 layers, d 4096, 32 heads over 8 KV heads (GQA), head dim
    128, d_ff 14336, vocab 128256; batches 96, then 64.

The weights are random from a seed. ``init_7b_int8`` builds them leaf by
leaf and quantizes each layer of a leaf as soon as it exists, so the card
never holds the bf16 tree (the largest transient is one bf16 leaf, 2.9 GB
for Llama-7B's w_gate). ``init_7b_int8_synth`` draws the int8 (or packed
int4) values directly, with constant per-output-channel scales: decode
time does not depend on the values.

``bench_decode`` is ``bench.py``'s: admit every slot in groups of 8
prompts of 128 tokens (``engine_prefill_batch``), run the fused greedy
loop (``engine_decode_loop``) twice to warm up, then two timed windows of
``decode_steps`` steps at bench.py's attention-window buckets, eagerly and
replayed as a CUDA graph (the way ``InferenceEngine`` replays its loops).
tokens/s is batch x steps over a window's seconds. For each (config,
batch) the script prints one JSON line: both rates, the admission rate,
the peak device memory and the pre-flight estimate, with the card's name
and power limit. As in the JAX script, the first batch of a config that
fits the card is its number; a batch that runs out of memory is recorded
and the next one tried; the script exits 1 if no batch of a config fits.

Usage (the card; a few minutes)::

    python flash_attention_softmax_n_tpu_torch/utils/bench_7b.py
    # synthesized weights, the all-kernel route (K7, K8, K9), grouped int4
    # weights with an fp8 KV cache, results also written to a file
    python flash_attention_softmax_n_tpu_torch/utils/bench_7b.py --synth \\
        --route pallas --quant int4-fp8 --out results/bench_7b.json

Without a card it raises. On the CPU ``bench_decode`` runs the kernels'
plain versions at a small geometry passed from Python (host-timed, no
graph).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
from pathlib import Path

import torch

if __name__ == "__main__":  # run as a file: import the port beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.engine.engine import (
    capture_loop,
    engine_decode_loop,
    engine_prefill_batch,
    replay_loop,
    warm_on_side_stream,
)
from flash_attention_softmax_n_tpu_torch.models.decoder import DecoderConfig
from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
    init_quantized_kv_cache,
)
from flash_attention_softmax_n_tpu_torch.quant.qtensor import (
    INT4_MAX,
    INT8_MAX,
    QTensor,
    quantize,
)
from flash_attention_softmax_n_tpu_torch.utils.profiling import (
    card_description,
    check_decode_hbm_fit,
    pytree_bytes,
)

__all__ = ["CONFIGS", "QUANT", "init_7b_int8", "init_7b_int8_synth",
           "bench_decode", "main"]

# (label, config, batches to try in order): scripts/bench_7b.py's two
CONFIGS = (
    # Llama-(1/2)-7B: MHA, the KV bytes of four times GQA-8's
    ("7B-MHA (Llama-7B: 32L d4096 H32 KV32 hd128 ff11008 v32000)",
     DecoderConfig(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=32, d_ff=11008, max_seq_len=2048,
                   softmax_n=1.0, dtype=torch.bfloat16),
     (48, 32)),
    # Llama-3-8B: GQA-8 and a wide vocabulary
    ("8B-GQA (Llama-3-8B: 32L d4096 H32 KV8 hd128 ff14336 v128256)",
     DecoderConfig(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, max_seq_len=2048,
                   softmax_n=1.0, dtype=torch.bfloat16),
     (96, 64)),
)

# --quant: (weight bits, KV cache); int4-fp8 is BASELINE.json's fifth
# config, grouped int4 weights with an fp8 e4m3 cache
QUANT = {"int8": (8, "int8"), "int4-fp8": (4, "fp8")}


# the matmul weights of a layer: (name, fan-in, output columns)
def _matmuls(cfg: DecoderConfig):
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    return (("wq", d, h * hd), ("wk", d, kvh * hd), ("wv", d, kvh * hd),
            ("wo", h * hd, d), ("w_gate", d, f), ("w_up", d, f),
            ("w_down", f, d))


def _tree(cfg: DecoderConfig, dev, gen, leaf):
    """The decoder's parameter tree, as ``init_decoder_params`` lays it out,
    with each matmul weight made by ``leaf(shape, fan_in)`` in turn: the
    bf16 embedding (a gather), ones for the norms."""
    d, nl = cfg.d_model, cfg.n_layers

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * fan_in ** -0.5).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {"attn_norm": ones((nl, d))}
    for name, fan_in, cols in _matmuls(cfg):
        if name == "w_gate":
            layers["mlp_norm"] = ones((nl, d))
        layers[name] = leaf((nl, fan_in, cols), fan_in)
    return {"embed": dense((cfg.vocab_size, d), d), "layers": layers,
            "final_norm": ones((d,)),
            "lm_head": leaf((d, cfg.vocab_size), d)}


def init_7b_int8(cfg: DecoderConfig, generator: torch.Generator,
                 device=None, bits: int = 8):
    """``init_decoder_params``' tree with every matmul weight drawn as
    N(0, 1/fan_in) in ``cfg.dtype`` and quantized (``bits`` 8, or 4 packed
    along the contraction axis) per output channel (``axis=-2``) as soon as
    it exists, one layer of a leaf at a time, its bf16 leaf freed before
    the next leaf is drawn. The quantized values and scales are those of
    ``quantize`` over the whole leaf."""
    dev = resolve_device(device)

    def qdense(shape, fan_in):
        w = torch.empty(shape, dtype=cfg.dtype, device=dev)
        layers = w.view(-1, *shape[-2:])
        for w_i in layers:
            w_i.copy_(torch.randn(shape[-2:], generator=generator, device=dev,
                                  dtype=torch.float32) * fan_in ** -0.5)
        q = None
        for i, w_i in enumerate(layers):
            q_i = quantize(w_i, bits=bits, axis=-2)
            if q is None:
                q = QTensor(q_i.values.new_empty(shape[:-2] + q_i.values.shape),
                            q_i.scales.new_empty(shape[:-2] + q_i.scales.shape),
                            bits=q_i.bits, packed_axis=q_i.packed_axis)
            q.values.view(-1, *q_i.values.shape)[i] = q_i.values
            q.scales.view(-1, *q_i.scales.shape)[i] = q_i.scales
        return q

    return _tree(cfg, dev, generator, qdense)


def init_7b_int8_synth(cfg: DecoderConfig, generator: torch.Generator,
                       device=None, bits: int = 8):
    """Timing-equivalent weights drawn directly in their stored form:
    uniform int8 values in [-127, 127] (``bits`` 4: uniform bytes, so each
    packed nibble is uniform in [-8, 7]) with constant per-output-channel
    scales of ``4.5 * fan_in ** -0.5 / qmax`` (the absmax of N(0, 1/fan_in)
    over a long axis is about 4.5 sigma). Never holds a bf16 leaf."""
    dev = resolve_device(device)
    qmax = INT4_MAX if bits == 4 else INT8_MAX

    def synth(shape, fan_in):
        if bits == 4:
            packed = shape[:-2] + (shape[-2] // 2, shape[-1])
            values = torch.randint(-128, 128, packed, generator=generator,
                                   device=dev, dtype=torch.int8)
        else:
            values = torch.randint(-127, 128, shape, generator=generator,
                                   device=dev, dtype=torch.int8)
        scales = torch.full(shape[:-2] + (1, shape[-1]),
                            4.5 * fan_in ** -0.5 / qmax, dtype=torch.float32,
                            device=dev)
        return QTensor(values, scales, bits=bits,
                       packed_axis=-2 if bits == 4 else None)

    return _tree(cfg, dev, generator, synth)


# requests a batched admission prefills (bench.py, the JAX engine's group)
ADMIT_GROUP = 8


def _bucket(n: int, max_len: int) -> int:
    """bench.py's attention window: n rounded up to 256s, at most max_len"""
    return min(max_len, -(-max(n, 1) // 256) * 256)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _budget_bytes(dev: torch.device):
    """The device's memory: the card's, or the host's for the CPU."""
    if dev.type == "cuda":
        return None  # check_decode_hbm_fit reads the card's
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def bench_decode(cfg: DecoderConfig, params, *, kv_quantization, batch: int,
                 prompt_len: int = 128, decode_steps: int = 32,
                 max_len: int = 512) -> dict:
    """Decode tokens/s with every slot active (bench.py's ``bench_decode``)
    over an int8 or fp8 (``kv_quantization``) KV cache.

    Pre-flight: ``check_decode_hbm_fit`` on the parameters' bytes. Then
    ``batch`` slots are admitted in groups of ``ADMIT_GROUP`` random prompts of
    ``prompt_len`` tokens through ``engine_prefill_batch`` (the first group
    unmeasured), and ``engine_decode_loop`` runs ``decode_steps`` greedy
    steps twice to warm up and twice timed, at bench.py's attention windows
    (``prompt_len + (2 + i) * decode_steps`` rounded up to 256s). On the
    card the timed windows run eagerly and then, from the same lengths and
    tokens, as a CUDA graph of the loop (the engine's own
    ``warm_on_side_stream``, ``capture_loop`` and ``replay_loop``, as
    ``InferenceEngine.prewarm`` and ``_greedy_loop`` use them; a replay adds
    the launches its capture made to ``_build.LAUNCHES``). Returns the rates (``tokens_per_s``: the graph's on
    the card, the eager loop's on the CPU), the seconds of each window, the
    admission rate, the active slots at the end, the estimate and, on the
    card, the peak memory allocated since the call began (the weights
    included)."""
    dev = params["embed"].device
    est = check_decode_hbm_fit(cfg, batch, max_len, kv_quantization,
                               pytree_bytes(params), _budget_bytes(dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cache = init_quantized_kv_cache(cfg.n_layers, batch, cfg.n_kv_heads,
                                    max_len, cfg.head_dim, mode=kv_quantization,
                                    device=dev)
    cache["lengths"] = torch.zeros((batch,), dtype=torch.int32, device=dev)

    gen = torch.Generator(device=dev).manual_seed(1)

    def admit(slot0):
        tokens = torch.randint(0, cfg.vocab_size, (ADMIT_GROUP, prompt_len),
                               generator=gen, device=dev)
        logits, _ = engine_prefill_batch(
            params, cfg, tokens,
            torch.full((ADMIT_GROUP,), prompt_len, dtype=torch.int32, device=dev),
            torch.arange(slot0, slot0 + ADMIT_GROUP, device=dev), cache)
        return logits

    admit(0)
    _sync(dev)
    t0 = time.perf_counter()
    for slot0 in range(ADMIT_GROUP, batch, ADMIT_GROUP):
        admit(slot0)
    _sync(dev)
    admit_s = time.perf_counter() - t0
    admitted = (batch - ADMIT_GROUP) * prompt_len

    tok = torch.full((batch,), 17, dtype=torch.int32, device=dev)
    active = torch.ones((batch,), dtype=torch.bool, device=dev)
    n_timed = 2
    timed = [_bucket(prompt_len + (2 + i) * decode_steps, max_len)
             for i in range(n_timed)]

    def loop(attn_len):
        return engine_decode_loop(params, cfg, tok, cache, active,
                                  num_steps=decode_steps, attn_len=attn_len)

    def window(run, attn_len):
        toks = run(attn_len)[0]
        tok.copy_(toks[:, -1])

    t0 = time.perf_counter()
    window(loop, timed[0])
    window(loop, timed[-1])
    _sync(dev)
    warm_s = time.perf_counter() - t0
    start = (cache["lengths"].clone(), tok.clone())

    def timed_windows(run):
        cache["lengths"].copy_(start[0])
        tok.copy_(start[1])
        _sync(dev)
        t0 = time.perf_counter()
        for attn_len in timed:
            window(run, attn_len)
        _sync(dev)
        return (time.perf_counter() - t0) / n_timed

    eager_s = timed_windows(loop)
    graph_s = capture_s = None
    if dev.type == "cuda":
        # as InferenceEngine.prewarm: one eager run of each window on a side
        # stream, then captures (which execute nothing) in one memory pool;
        # the rows the side-stream runs wrote past ``start``'s lengths are
        # rewritten by the timed windows
        t0 = time.perf_counter()
        lens = sorted(set(timed))
        warm_on_side_stream([functools.partial(loop, al) for al in lens], dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = {al: capture_loop(functools.partial(loop, al), pool) for al in lens}
        capture_s = time.perf_counter() - t0
        graph_s = timed_windows(lambda attn_len: replay_loop(graphs[attn_len]))
    steps = batch * decode_steps
    return {
        "batch": batch, "prompt_len": prompt_len, "decode_steps": decode_steps,
        "max_len": max_len, "kv": kv_quantization,
        "attn_lens": timed,
        "tokens_per_s": steps / (graph_s if graph_s else eager_s),
        "graph_tokens_per_s": steps / graph_s if graph_s else None,
        "eager_tokens_per_s": steps / eager_s,
        "graph_window_s": graph_s, "eager_window_s": eager_s,
        "capture_s": capture_s, "warmup_s": warm_s,
        "admission_tokens_per_s": admitted / admit_s if admitted else None,
        "active_slots": int(active.sum()),
        "lengths": sorted(set(cache["lengths"].tolist())),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "preflight": est,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--synth", action="store_true",
                    help="weights drawn directly in int8/int4 "
                         "(init_7b_int8_synth), not quantized from N(0, 1/fan_in)")
    ap.add_argument("--route", default="default", choices=["default", "pallas"],
                    help="pallas: int8_mm_impl and decode_attn_impl 'pallas' "
                         "(kernels K7, K8, K9)")
    ap.add_argument("--quant", default="int8", choices=sorted(QUANT))
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    dev = resolve_device()
    bits, kv = QUANT[args.quant]
    init = init_7b_int8_synth if args.synth else init_7b_int8
    card = card_description(dev)
    lines, failed = [], []
    for label, cfg, batches in CONFIGS:
        if args.route == "pallas":
            cfg = dataclasses.replace(cfg, int8_mm_impl="pallas",
                                      decode_attn_impl="pallas")
        _sync(dev)
        t0 = time.perf_counter()
        params = init(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                      bits=bits)
        _sync(dev)
        head = {"config": label, "route": args.route, "quant": args.quant,
                "init": init.__name__, "init_s": time.perf_counter() - t0,
                "card": card}
        fits = False
        for batch in batches:
            try:
                res = bench_decode(cfg, params, kv_quantization=kv, batch=batch)
            except torch.cuda.OutOfMemoryError as e:
                line = {**head, "batch": batch, "error": str(e).splitlines()[0]}
            else:
                line = {**head, **res}
            print(json.dumps(line), flush=True)
            lines.append(line)
            if "error" not in line:
                fits = True
                break  # the first batch that fits is the config's number
        if not fits:
            failed.append(label)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    if failed:
        print(f"bench_7b: no batch of {', '.join(failed)} fit the device",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
