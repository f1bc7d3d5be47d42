#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check what comes out.

Run from the root of a checkout, on a machine with one card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, in order, each printing one JSON line:

1. device: requires a CUDA card (exits 1 otherwise, printing no result);
2. build: compiles ``flash_attention_softmax_n_tpu_torch/csrc/``: each
   ``*.cu`` kernel source with its own nvcc for sm_90a and the PyTorch
   operator bindings with the host C++ compiler, all started together;
3. kernels: runs K1 flash_fwd, K2 qmm_argmax, K3 cache_append and K4
   tail_append on the card at serving shapes and holds each against its
   plain PyTorch version on the same card tensors;
4. serving: the TinyLlama-1.1B shape (random weights from a seed, int8
   weights, int8 KV) serves 96 requests through the fused decode loop and 4
   through the step path, counting each kernel's launches on those runs, and
   checks the tokens against ``greedy_generate`` and a teacher-forced
   ``decoder_forward``;
5. profile: one 16-step fused chunk of 64 requests under ``torch.profiler``
   gives the device's busy time, its idle share and the kernels that fill
   it.

Then it prints the kernels' JSON line (times, launches, bounds), the card's
name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero. The
port is imported from the checkout; nothing of JAX is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# NVIDIA H100 SXM data sheet (dense): bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
TIMED_RUNS = 25

ROOT = Path(__file__).resolve().parent
TPU_PKG = "flash_attention_softmax_n_tpu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(bytes_moved: float, flops: float = 0.0):
    t_bytes = bytes_moved / PEAK_HBM_BYTES
    t_ops = flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` single calls, each timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def device_ms(torch, fn, kernel: str, runs: int = TIMED_RUNS):
    """Mean device time per call of the kernels whose name holds ``kernel``
    over ``runs`` calls under ``torch.profiler``: the kernel alone, without
    the wrapper's host dispatch that CUDA events also count. None if the
    profiler saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA and kernel in e.name)
    return total_us / 1e3 / runs if total_us else None


# ----------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------------


def check_flash(torch, pkg, gen, *, B, H, L, S, D, masked):
    fa = pkg["flash_attention"]
    ops_fa = pkg["ops_flash_attention"]
    dev = "cuda"
    q, k, v = (torch.randn((B, H, n, D), generator=gen, device=dev).to(torch.bfloat16)
               for n in (L, S, S))
    n_param, scale = 1.0, D ** -0.5
    kpos = torch.arange(S, device=dev)
    causal = kpos[None, :] <= torch.arange(L, device=dev)[:, None] + (S - L)
    if masked:
        # the engine's admission mask: right-padded prompts, causal inside
        true_lens = torch.randint(16, S + 1, (B,), generator=gen, device=dev)
        visible = (kpos[None, None, :] < true_lens[:, None, None]) & causal[None]
        bias = ops_fa._mask_to_bias(visible[:, None])  # (B,1,L,S) f32
        is_causal = False
    else:
        visible = causal[None].expand(B, L, S)
        bias, is_causal = None, True

    def kernel():
        return fa.flash_fwd(q, k, v, bias, n=n_param, scale=scale, is_causal=is_causal)

    def plain():
        return fa.flash_fwd_reference(q, k, v, bias, n=n_param, scale=scale,
                                      is_causal=is_causal)

    o, lse = kernel()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    # o is bf16: the two sum in different orders, so o may round one bf16
    # ulp apart (at most 2^-7 of |o|); 2e-3 covers p rounding to bf16 on
    # the other side of a tie before PV
    diff = (o.float() - o_ref.float()).abs()
    err_o = float(diff.max())
    tol_o = "2e-3 + 2^-7 |o_plain|"
    excess_o = float((diff - 2.0 ** -7 * o_ref.float().abs()).max())
    err_lse = float((lse - lse_ref).abs().max())
    tol_lse = 1e-3
    name = f"flash_fwd B{B} H{H} L{L} S{S} d{D} {'mask' if masked else 'causal'}"
    require(excess_o <= 2e-3 and err_lse <= tol_lse,
            f"{name}: max |o - plain| - 2^-7 |o_plain| is {excess_o} (tol 2e-3), "
            f"max |lse - plain| {err_lse} (tol {tol_lse})")

    # the library yardstick: SDPA over K/V with one zero row prepended (the
    # reference library's trick for integer n = 1), under the same mask
    zrow = torch.zeros((B, H, 1, D), dtype=q.dtype, device=dev)
    k1, v1 = torch.cat([zrow, k], 2), torch.cat([zrow, v], 2)
    mask1 = torch.cat([torch.ones((B, L, 1), dtype=torch.bool, device=dev), visible],
                      -1)[:, None]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k1, v1, attn_mask=mask1, scale=scale)

    pairs = float(visible.sum()) * H
    bytes_moved = (q.numel() + k.numel() + v.numel() + o.numel()) * 2 + lse.numel() * 4
    if bias is not None:
        bytes_moved += bias.numel() * 4
    b_ms, b_by = bound_ms(bytes_moved, 4.0 * pairs * D)
    return {"name": name, "route": "cuda",
            "source": "flash_attention_softmax_n_tpu_torch/csrc/flash_fwd.cu",
            "replaces": f"{TPU_PKG}/kernels/flash_attention.py:345 _fwd_single_kernel, "
                        ":279 _fwd_kernel, :501 _fwd_pipeline_kernel",
            "counter": "flash_fwd",
            "max_abs_err": err_o, "max_abs_err_lse": err_lse, "tolerance": tol_o,
            "ms": time_ms(torch, kernel),
            "device_ms": device_ms(torch, kernel, "flash_fwd_kernel"),
            "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(torch, library)}


def check_qmm(torch, pkg, gen, *, M, K, N):
    qm = pkg["quant_matmul"]
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), generator=gen, device=dev).to(torch.int8)
    s = (torch.rand((1, N), generator=gen, device=dev) + 0.5) / (127.0 * K ** 0.5)

    def kernel():
        return qm.quantized_matmul_argmax(x, w, s, return_max=True)

    def plain():
        return qm.quantized_matmul_argmax_reference(x, w, s)

    idx, val = kernel()
    idx_ref, val_ref = plain()
    logits = (x.float() @ w.float()) * s
    top2 = torch.topk(logits, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    torch.cuda.synchronize()
    decided = gap > 1e-3
    idx_ok = bool(torch.equal(idx[decided], idx_ref[decided]))
    rel = float(((val - val_ref).abs() / val_ref.abs().clamp(min=1e-6)).max())
    err = float((val - val_ref).abs().max())
    require(idx_ok and rel <= 1e-3,
            f"qmm_argmax: indices equal where the top-2 gap > 1e-3: {idx_ok}; "
            f"max relative error of the max {rel} (tol 1e-3)")
    b_ms, b_by = bound_ms(x.numel() * 2 + w.numel() + N * 4 + M * 8, 2.0 * M * K * N)
    return {"name": f"qmm_argmax M{M} K{K} N{N}", "route": "cuda",
            "source": "flash_attention_softmax_n_tpu_torch/csrc/qmm_argmax.cu",
            "replaces": f"{TPU_PKG}/kernels/quant_matmul.py:117 _qmm_argmax_kernel",
            "counter": "qmm_argmax",
            "max_abs_err": err, "max_rel_err": rel, "tolerance": 1e-3,
            "undecided_rows": int((~decided).sum()),
            "ms": time_ms(torch, kernel), "device_ms": device_ms(torch, kernel, "qmm_"),
            "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_cache_append(torch, pkg, gen, *, NL, B, KVH, S, D):
    cu = pkg["cache_update"]
    dev = "cuda"

    def qcache():
        return (torch.randint(-128, 128, (NL, B, KVH, S, D), generator=gen,
                              device=dev).to(torch.int8),
                torch.rand((NL, B, KVH, S, 1), generator=gen, device=dev))

    kv, ks = qcache()
    vv, vs = qcache()
    caches = (kv, ks, vv, vs)
    news = tuple(c[:, :, :, 0].clone().random_(-128, 128, generator=gen)
                 if c.dtype == torch.int8 else torch.rand(c.shape[:3] + (1,),
                                                          generator=gen, device=dev)
                 for c in caches)
    pos = torch.randint(0, S, (B,), generator=gen, device=dev).to(torch.int32)
    got = tuple(c.clone() for c in caches)
    want = tuple(c.clone() for c in caches)
    cu.cache_append(got, news, pos)
    cu.cache_append_reference(want, news, pos)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    require(exact, "cache_append: kernel result is not bit-exact with the plain version")
    rows_bytes = sum(nw.numel() * nw.element_size() for nw in news)
    b_ms, b_by = bound_ms(2 * rows_bytes + B * 4)
    return {"name": f"cache_append NL{NL} B{B} KVH{KVH} S{S} D{D} int8+scales",
            "route": "cuda",
            "source": "flash_attention_softmax_n_tpu_torch/csrc/cache_update.cu",
            "replaces": f"{TPU_PKG}/kernels/cache_update.py:92 _kernel",
            "counter": "cache_append",
            "max_abs_err": 0.0, "tolerance": "bit-exact",
            "ms": time_ms(torch, lambda: cu.cache_append(got, news, pos)),
            "device_ms": device_ms(torch, lambda: cu.cache_append(got, news, pos),
                                   "write_rows_kernel"),
            "plain_ms": time_ms(torch, lambda: cu.cache_append_reference(want, news, pos)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_tail_append(torch, pkg, gen, *, NL, B, KVH, W, D):
    cu = pkg["cache_update"]
    dev = "cuda"
    shape = (NL, B, KVH, W, D)
    kt, vt = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    kn, vn = (torch.randn(shape[:3] + (D,), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    index = 37
    got = (kt.clone(), vt.clone())
    want = (kt.clone(), vt.clone())
    cu.tail_append(*got, kn, vn, index)
    cu.tail_append_reference(*want, kn, vn, index)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "tail_append: kernel result is not bit-exact with the plain version")
    b_ms, b_by = bound_ms(2 * 2 * kn.numel() * 2)
    return {"name": f"tail_append NL{NL} B{B} KVH{KVH} W{W} D{D} bf16", "route": "cuda",
            "source": "flash_attention_softmax_n_tpu_torch/csrc/cache_update.cu",
            "replaces": f"{TPU_PKG}/kernels/cache_update.py:40 _tail_kernel",
            "counter": "tail_append",
            "max_abs_err": 0.0, "tolerance": "bit-exact",
            "ms": time_ms(torch, lambda: cu.tail_append(*got, kn, vn, index)),
            "device_ms": device_ms(torch, lambda: cu.tail_append(*got, kn, vn, index),
                                   "write_rows_kernel"),
            "plain_ms": time_ms(torch, lambda: cu.tail_append_reference(*want, kn, vn,
                                                                        index)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# ----------------------------------------------------------------------------
# phase 4: serving at the TinyLlama-1.1B shape
# ----------------------------------------------------------------------------


def lcp(a, b) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def teacher_forced(torch, pkg, cfg, params, req):
    """Score the request's tokens under a full-sequence ``decoder_forward``
    of prompt + output (dense bf16 attention, no cache): returns (how many
    emitted tokens are that forward's argmax, the largest gap between its
    best logit and the emitted token's logit)."""
    seq = torch.tensor([req.prompt + req.output[:-1]], device="cuda")
    logits = pkg["decoder"].decoder_forward(params, cfg, seq)[0]
    p = len(req.prompt)
    rows = logits[p - 1:p - 1 + len(req.output)]
    out = torch.tensor(req.output, device="cuda")
    chosen = rows[torch.arange(len(req.output), device="cuda"), out]
    best = rows.max(dim=-1)
    return (int((best.indices == out).sum()),
            float((best.values - chosen).max()))


def profile_chunk(torch, eng_mod, cfg, params):
    """Where a fused chunk's time goes: 64 requests (64-token prompts) are
    admitted and decoded in one 16-step chunk, once unprofiled for the wall
    time and once under ``torch.profiler`` for the device's busy time and
    the kernels that fill it. Busy time is the sum of kernel and copy times
    (one stream, so they do not overlap); the idle share is against the
    unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        eng = eng_mod.InferenceEngine(cfg, params, max_batch=64, max_len=512,
                                      kv_quantization="int8", piggyback_prefill=False)
        rng = np.random.RandomState(1)
        for _ in range(64):
            eng.submit(rng.randint(0, cfg.vocab_size, size=64).tolist(), max_new_tokens=17)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_until_done(loop_steps=64)
        torch.cuda.synchronize()
        require(len(done) == 64 and eng.counters_report()["chunks"] == 1,
                "the profiled run did not serve its 64 requests in one chunk")
        return time.perf_counter() - t0

    wall = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_profiled = run()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    # the port's own kernels, by device time alone (CUDA events around a
    # wrapper also count its host dispatch)
    ours = {}
    for name, (ms, calls) in by_name.items():
        for kernel in ("flash_fwd_kernel", "qmm_tile_kernel", "qmm_reduce_kernel",
                       "write_rows_kernel"):
            if kernel in name:
                prev_ms, prev_calls = ours.get(kernel, (0.0, 0))
                ours[kernel] = (prev_ms + ms, prev_calls + calls)
    emit({"phase": "profile", "requests": 64, "steps": 16, "wall_s": wall,
          "wall_s_profiled": wall_profiled,
          "device_busy_s": busy_ms / 1e3 if busy_ms else None,
          "idle_share": 1.0 - busy_ms / 1e3 / wall if busy_ms else None,
          "device_ops": sum(c for _, c in by_name.values()),
          "port_kernels": {k: {"calls": c, "ms_per_call": ms / c}
                           for k, (ms, c) in sorted(ours.items())},
          "top": [{"name": name[:90], "ms": ms, "calls": calls}
                  for name, (ms, calls) in top]})


def serve(torch, pkg):
    dec, eng_mod, build = pkg["decoder"], pkg["engine"], pkg["build"]
    # TinyLlama-1.1B shape (bench.py build_model): vocab 32000, d 2048,
    # 22 layers, 32 query / 4 KV heads, d_ff 5632
    cfg = dec.DecoderConfig(vocab_size=32000, d_model=2048, n_layers=22, n_heads=32,
                            n_kv_heads=4, d_ff=5632, max_seq_len=2048, softmax_n=1.0,
                            dtype=torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = pkg["weights"].quantize_decoder_weights(
        dec.init_decoder_params(cfg, gen, device="cuda"), bits=8)
    torch.cuda.synchronize()
    emit({"phase": "weights", "seconds": time.perf_counter() - t0,
          "config": "TinyLlama-1.1B shape, random N(0, 1/fan_in) from seed 0, int8 "
                    "per-output-channel"})

    # fused loop: 96 requests, prompts 16-127 tokens, budgets 16-63 (bench.py)
    eng = eng_mod.InferenceEngine(cfg, params, max_batch=64, max_len=512,
                                  kv_quantization="int8", piggyback_prefill=False)
    rng = np.random.RandomState(0)
    reqs = {}
    for _ in range(96):
        plen, budget = int(rng.randint(16, 128)), int(rng.randint(16, 64))
        prompt = rng.randint(0, cfg.vocab_size, size=plen).tolist()
        reqs[eng.submit(prompt, max_new_tokens=budget)] = budget
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_done(loop_steps=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused_launches = dict(build.LAUNCHES)
    n_tok = sum(len(r.output) for r in done)
    require(len(done) == 96, f"fused loop finished {len(done)} of 96 requests")
    require(all(len(r.output) == reqs[r.request_id] for r in done),
            "a fused-loop request did not emit exactly its budget")
    require(all(0 <= t < cfg.vocab_size for r in done for t in r.output),
            "a fused-loop token is outside the vocabulary")
    emit({"phase": "serve_fused", "requests": len(done), "tokens": n_tok,
          "wall_s": wall, "tokens_per_s": n_tok / wall, "launches": fused_launches,
          "profile": eng.profile_report(), "counters": eng.counters_report()})

    # step path: 4 requests decoded one step at a time (K3 writes the cache)
    step_eng = eng_mod.InferenceEngine(cfg, params, max_batch=4, max_len=512,
                                       kv_quantization="int8", piggyback_prefill=False)
    first4 = sorted(done, key=lambda r: r.request_id)[:4]
    for r in first4:
        step_eng.submit(r.prompt, max_new_tokens=len(r.output))
    build.reset_launches()
    t0 = time.perf_counter()
    step_done = sorted(step_eng.run_until_done(), key=lambda r: r.request_id)
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t0
    step_launches = dict(build.LAUNCHES)
    require(len(step_done) == 4 and all(
        len(a.output) == len(b.output) for a, b in zip(step_done, first4)),
        "step path did not finish its 4 requests with their budgets")
    emit({"phase": "serve_step", "requests": 4,
          "tokens": sum(len(r.output) for r in step_done), "wall_s": step_wall,
          "launches": step_launches})

    # agreement with greedy_generate (int8 KV) on the same weights: the
    # share of tokens before the first disagreement. Logits are rounded to
    # bf16 and the two paths round at different places, so a near-tie can
    # flip and every later token then differs; the mean is held to >= 0.1
    # (a broken decode path leaves only the shared first token, ~0.03).
    agree = []
    for r in step_done:
        ref = dec.greedy_generate(params, cfg, [r.prompt], len(r.output),
                                  kv_quantization="int8")[0].tolist()
        agree.append(lcp(r.output, ref) / len(r.output))
    mean_agree = float(np.mean(agree))
    # teacher-forced check, which does not cascade: each emitted token
    # should be the argmax of a full-sequence forward on its own prefix,
    # up to near-ties (held to >= 0.8 of the tokens), and never more than
    # 0.5 below that forward's best logit (a wrong token sits ~4 below)
    checked = step_done + sorted(done, key=lambda r: r.request_id)[:8]
    scored = [teacher_forced(torch, pkg, cfg, params, r) for r in checked]
    n_checked = sum(len(r.output) for r in checked)
    tf_agree = sum(s[0] for s in scored) / n_checked
    deficit = max(s[1] for s in scored)
    emit({"phase": "agreement", "greedy_generate_prefix_share": agree,
          "mean": mean_agree, "threshold": 0.1,
          "teacher_forced_argmax_share": tf_agree, "argmax_threshold": 0.8,
          "teacher_forced_max_deficit": deficit, "deficit_threshold": 0.5,
          "tokens_teacher_forced": n_checked})
    require(mean_agree >= 0.1, f"greedy_generate agreement {mean_agree} < 0.1")
    require(tf_agree >= 0.8, f"teacher-forced argmax share {tf_agree} < 0.8")
    require(deficit <= 0.5, f"teacher-forced logit deficit {deficit} > 0.5")
    # the main path is both runs: the fused loop (K1, K2, K4) and the step
    # path near max_len (K1, K3); every kernel must have run in them
    launches = {k: fused_launches[k] + step_launches[k] for k in fused_launches}
    for name, count in launches.items():
        require(count > 0, f"the serving runs never launched {name}")
    profile_chunk(torch, eng_mod, cfg, params)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from flash_attention_softmax_n_tpu_torch.engine import engine
        from flash_attention_softmax_n_tpu_torch.kernels import (
            _build,
            cache_update,
            flash_attention,
            quant_matmul,
        )
        from flash_attention_softmax_n_tpu_torch.models import decoder
        from flash_attention_softmax_n_tpu_torch.ops import (
            flash_attention as ops_flash_attention,
        )
        from flash_attention_softmax_n_tpu_torch.quant import weights
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    pkg = {"build": _build, "flash_attention": flash_attention,
           "ops_flash_attention": ops_flash_attention, "quant_matmul": quant_matmul,
           "cache_update": cache_update, "decoder": decoder, "engine": engine,
           "weights": weights}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.ops()
    ptxas = (lib_path.parent / lib_path.name.replace("libfasn_", "ptxas_")
             .replace(".so", ".log"))
    # steps: each compile's and the link's wall seconds, all compiles at once
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name,
          "steps": dict(_build.BUILD_SECONDS)})
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(line.strip(), file=sys.stderr)

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [
        check_flash(torch, pkg, gen, B=16, H=32, L=128, S=128, D=64, masked=True),
        check_flash(torch, pkg, gen, B=2, H=32, L=2048, S=2048, D=64, masked=False),
        # M = 64: the fused loop's batch below; M = 256: a fuller batch
        check_qmm(torch, pkg, gen, M=64, K=2048, N=32000),
        check_qmm(torch, pkg, gen, M=256, K=2048, N=32000),
        # B = 4 and 64: the step path's and the fused loop's pools below
        check_cache_append(torch, pkg, gen, NL=22, B=4, KVH=4, S=512, D=64),
        check_cache_append(torch, pkg, gen, NL=22, B=256, KVH=4, S=512, D=64),
        check_tail_append(torch, pkg, gen, NL=22, B=64, KVH=4, W=64, D=64),
        check_tail_append(torch, pkg, gen, NL=22, B=256, KVH=4, W=64, D=64),
    ]
    for kd in kernels:
        emit({"phase": "kernel", **{k: kd[k] for k in ("name", "max_abs_err", "tolerance", "ms",
                                                       "device_ms", "plain_ms", "library_ms")}})

    launches = serve(torch, pkg)
    for kd in kernels:
        kd["launches"] = launches[kd.pop("counter")]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
