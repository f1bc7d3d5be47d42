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
3. kernels: runs K1 flash_fwd (B16 H32 L=S=128 under the engine's
   admission mask, B2 H32 L=S=2048 causal, and B16 H32 L256 S512 under the
   mask of a chunk at offset 256, as ``serve_prefix`` launches it), K2 qmm_argmax (M64, M72 and M256; each line
   prints its plan, W's achieved GB/s, and, for information, cuBLAS's device time for the GEMM
   and max over W dequantized to bf16), K3 cache_append and K4
   tail_append (at utils/bench_cache_update.py's lines and seeds; each
   line prints its tensors' vector widths, GB/s, host ms and, for
   information, the device time of one PyTorch call a tensor), K7 qmm
   (int8, W8A8 and int4, at decode M64, at the mixed steps' M80 and M192
   and at the admission groups' M1024 and M2048; each line prints its plan and
   producer, and the library call's own device time), K8 decode_attn
   (int8, fp8 and bf16 caches, at utils/bench_decode_attn.py's lines and
   seeds; each line prints its split length and product design), K9
   fused_mlp (M64 and M256; both phases' plans, TFLOP/s and, for
   information, cuBLAS's device time over the weights dequantized to bf16)
   and K10 prefill_phase (its
   four modes, B2 H32 L2048 hd64) on the card at their paths' shapes and
   holds each against its plain PyTorch version on the same card tensors
   (K2 and K7-K10 also run twice and must be bit-equal); K1 at B4 H32
   L=S=512 causal (the analysis phase's forward); K7's f32 mode (the
   f32 FMA kernel ``qmm_f32_kernel``; each line prints its plan: tile,
   ring stages, splits, loader, and its shared-memory bytes) with grouped
   int4 weights at BERT-base's shapes over B8 x L512 (M4096: K768 N768,
   K768 N3072, K3072 N768; the surgery phase's int4 BERT) and with int8
   weights (on no path) at M64 and M1024, K2048 N2048, and at the ragged
   M300 K776 N200 (the cp.async loader), each against ``torch.matmul`` in
   f32; K1 and K10 lines give
   TFLOP/s too;
4. train kernels: K1 with ALiBi and dropout, K5 flash_bwd_dq and K6
   flash_bwd_dkv against their plain versions (B2 H4 L200 S264 with bias,
   ALiBi and dropout, f32 and bf16, n 0 and 1, bf16 at d64 and d128, so
   both chunk shapes of the bf16 wgmma kernels run; then the training shape
   B2 H32 L=S=2048 d64 bf16 causal with dropout, timed: each kernel's
   TFLOP/s, and the backward pair with delta against SDPA's backward by
   device time), each run twice and required bit-equal, K1 with ALiBi and
   dropout held at the training shape, and the three kernels' dropout masks
   (each in f32 and bf16) required bit-equal to the plain hash; a bf16
   forward's o is held, K1 and its plain version each, against a float64
   evaluation of the same function (``fwd_float64``, ``o_excess``);
   gradients are held element by element and as a whole (``BWD_NORM_TOL``);
5. serving: the TinyLlama-1.1B shape (random weights from a seed, int8
   weights, int8 KV) serves 96 requests through 64 slots of the fused
   decode loop, on an engine built as bench.py builds it (the default
   piggybacked prefill, then ``prewarm(loop_steps=64, attn_lens=[256])``
   capturing each greedy loop variant as a CUDA graph: its count, seconds
   and graph pool bytes printed), so queued prompts prefill inside the
   chunks (``piggyback_prompts`` must be > 0), and 4 through the step
   path, counting each kernel's launches on those runs (a replay counts
   the launches its capture made), and checks the tokens against
   ``greedy_generate`` and a teacher-forced ``decoder_forward`` (the
   queued requests, piggybacked ones among them, included); then
6. profile: one 16-step fused chunk of 64 requests, run eagerly (capture
   off) and replayed as a graph, each three times unprofiled and each time
   at once under ``torch.profiler``, gives the device's busy time, its idle
   share against the unprofiled wall just before (``idle_share_paired``,
   median and spread) and the kernels that fill it (the replay must show
   the route's decode kernels), and against an admission-only run of the
   same requests the decode step's own busy time and device ops; on the
   default route also the device time of one step's weight
   dequantization. Phases 5-6 run twice: ``serve`` on the default routes (K1-K4, and
   K7-K9 must not launch) and ``serve_pallas`` with
   ``int8_mm_impl="pallas", decode_attn_impl="pallas"`` (K1-K4 and K7-K9
   must all launch); then 12 requests through 8 slots each with int4
   weights and with ``act_bits=8`` go through the fused loop on the same
   routes at 2 of the 22 layers (K7's int4 and W8A8 modes), held to the
   teacher-forced gate, and ``serve_fp8`` puts 12 requests through the
   fused loop and 2 through the step path with fp8 e4m3 weights and an fp8
   KV cache (K8's fp8 mode, K1, K3, K4), each prewarmed and piggybacked as
   in 5, and profiles its chunk as in 6; then
5a. serve_prefix: bench.py's prefix pair on the default route: 64
   requests, every even one behind a 256-token prefix (272-383 tokens),
   through 64 slots of an engine prewarmed with ``attn_lens=[256, 512]``,
   twice: prefix cache off (chunked prefill at offsets 0 and 256), then on
   after ``register_prefix`` (32 hits, each a copy of the stored rows and
   one chunk at offset 256); each run's tokens/s, counters, phases and
   launches, one admission round's device busy time off and on, the share
   of equal outputs (printed, not gated); held to budgets, the
   teacher-forced gate, the counts of hits and reused tokens, a store
   bit-equal to a cold 1-slot chunked prefill of the same tokens, and the
   replay checks of 6a (a 16-step chunk for the 64-step one, windows of
   512 rows) over slots holding the inserted rows; then
6a. graph_parity: on the default route, the all-kernel route and fp8, a
   plain 64-step chunk, a piggybacked 8-step chunk and a plain 6-step
   chunk each replay their graph bit-equal to the eager loop from the same
   state (tokens, first tokens, the cache's value, scale and length bytes,
   launch counts), and ``prewarm`` leaves that state bit-equal;
6b. prefill_phases: one run of the prefill-phase profile
   (``python -m flash_attention_softmax_n_tpu_torch.utils.profile_prefill_phases``)
   at B2 H32 L2048 hd64: K10's four modes and K1 without and with the
   causal mask, each timed, its lines printed;
7. train_agreement: the TinyLlama-1.1B width at 2 layers in f32: every
   parameter gradient of ``causal_lm_loss`` through the fused route (K1,
   K5, K6) against the same through plain tensor ops (``"xla"``), relative
   L2 error at most 1e-3;
8. train: the full TinyLlama-1.1B shape (22 layers, bf16, n = 1, attention
   dropout 0.1, remat) takes 4 AdamW steps on one B2 x L2048 batch through
   ``make_train_step``, counting the kernels' launches; the losses must be
   finite and fall, the gradients finite and not all zero; then three
   pairs of an unprofiled step and a step under ``torch.profiler`` give
   the step's paired idle share;
9. analysis: the TinyLlama-1.1B shape (22 layers, bf16, n 1, the serving
   phases' weights from seed 0): ``register_activation_hooks`` over
   ``decoder_forward(collect_taps=True)`` on four B4 x L512 batches (22
   taps of 16 samples, finite, K1 22 times a forward), ``delta_perplexity``
   of int8 weights on the default route and on ``int8_mm_impl="pallas"``
   (K7 155 times a forward; perplexities finite and above 1, |relative|
   below 0.05), ``output_attentions`` at B1 L512 (logits within relative L2
   5e-2 of the K1 path's, null mass in [0, 1] and above 0), and
   ``compute_weight_statistics`` and ``gate_report`` of activations and
   weights (dense and int8 trees);
10. surgery: BERT-base and XLNet-base (the published configs' widths) from
   stand-in HF models (seeded HF-named state dicts, the configs'
   attributes) through ``from_pretrained_hf(softmax_n_param=1.0)`` on the
   card, f32: BERT-base at B8 x L512 with padded lengths 128-512 (12 taps
   over two batches into ``gate_report``; int8 weights within 0.05 of
   dense; int4 weights, K7's f32 mode 72 times a forward, within 1e-3 of
   the same tree dequantized; ``output_attentions`` at B2, padded keys at
   probability 0, null mass above 0); XLNet-base over two B4 x L256
   segments with mems (finite, mems (12, 256, 4, 768)), its taps into
   ``gate_report`` and ``summarize_attention`` of ``output_attentions``;
11. ring: TinyLlama-1.1B's attention width (H32, KVH4, d64), bf16, n = 1,
   causal, B1 x L8192 as p = 4 sequence shards of 2048: all four ranks'
   ring schedules in one process through ``parallel.ring_attention``'s
   per-rank step functions (K1 at n = 0 with its lse on the 10 visiting
   blocks that are not skipped, K5/K6 against the global lse, GQA K/V
   unrepeated), held against single-device K1 (o against a float64
   evaluation, lse within 1e-3) and K5/K6 (dq, dk, dv by ``norm_err``);
   then K1 on a full and a causal block and K5/K6 on a full block, each
   against its plain version, timed beside its bound and SDPA over the
   whole ring with one zero key;
12. train_mesh: a one-rank NCCL group (``initialize_distributed``) and
   ``make_mesh({"data": 1, "model": 1, "sp": 1})``; ``make_train_step``
   at the full TinyLlama-1.1B shape (22 layers, bf16, remat), 4 steps on
   ``sp_axis="sp"`` at B1 x L4096 and 4 on the tensor-parallel path with
   ``zero1=True`` at B2 x L2048: losses finite and falling, the first
   within 1e-3 relative of the unmeshed step's; tokens/s, walls, peak
   memory; then, in the same group,
13. checkpoint: the TinyLlama-1.1B params, dense bf16 and int8, saved and
   loaded (the reloaded logits bit-equal), and a train checkpoint of the
   ZeRO-1 mesh run (2 layers, B1 x L512) saved at step 2 and resumed: the
   losses of the uninterrupted run; then, in the same group,
14. serve_mesh: ``InferenceEngine(mesh=make_mesh({"data": 1, "model": 1}))``
   at the full TinyLlama-1.1B shape (22 layers, the serve phase's int8
   weights, int8 KV, 64 slots, max_len 512): ``serve_fused``'s 96 requests
   after ``prewarm`` and 4 through the step path, on the default and the
   all-kernel routes, every token equal to an unmeshed engine's with the
   same chunk plan and no piggybacking (a mesh turns it off); one 256-token
   prefix registered on a 1-slot meshed engine, its 8 hits equal to cold
   prefill; K1-K4 and K7-K9 must launch. Its kernel lines (phase 3) are at
   the per-rank shapes of {"data": 2, "model": 4}: K2 on four vocab shards
   of N32000 (M32 K2048 N8000), merged and held equal to K2 over the whole
   vocabulary; K1 B16 H8 L=S=128 under the engine's mask; K3 NL22 B32 KVH1
   S512 int8 + scales; K4 NL22 B32 KVH1 W64 bf16; K8 B32 KVH1 G8 S512 int8;
   K7 at M32 (K2048 N512, N64, N1408; K512 N2048; K1408 N2048); K9 M32
   K2048 F1408;
15. serve_7b: Llama-7B at its published widths and full 32 layers (head
   dim 128, 32 heads over 32 KV heads, d_ff 11008, vocab 32000), int8
   weights on the card: ``utils/bench_7b.bench_decode`` at B48 (weights
   synthesized in int8, as bench.py's 7B point) on the default and the
   all-kernel routes, tokens/s eagerly and replayed as a CUDA graph with
   the card's name and power limit (one run, no claim); then, with weights
   quantized from N(0, 1/fan_in) leaf by leaf (``init_7b_int8``), 24
   requests through 16 slots of a prewarmed engine on the all-kernel route
   and 2 through its step path, and 8 + 2 with grouped int4 weights and an
   fp8 KV cache, each held to budgets and the teacher-forced gate; K1-K4
   and K7-K9 must launch. Its kernel lines (phase 3) are at the shapes the
   path launches: K1 B8 H32 L=S=128 d128 under the engine's mask; K2 M48
   K4096 N32000 and Llama-3-8B's M96 N128256; K3 NL32 B48 KVH32 S512 D128
   int8 + scales; K4 NL32 B48 KVH32 W64 D128 bf16; K7 int8 at M48 K4096
   N4096 and M1024 (K4096 N4096, N11008; K11008 N4096), int4 at M48 over
   the same three; K8 B48 KVH32 G1 S512 d128 over int8 and fp8 caches; K9
   M48 K4096 F11008 and Llama-3-8B's F14336. Every line there and in
   phase 3 is also run twice and required bit-equal.

Then it prints the kernels' JSON line (times, launches on the serving,
training, analysis, surgery, ring, serve_mesh or serve_7b run, each kernel's launches on
the analysis, surgery, train_mesh, serve_mesh and serve_7b runs, bounds), the card's name and power limit from
nvidia-smi, and last ``{"ok": true, "device": {...}}``. Any failed check
exits non-zero. The port is imported from the checkout; nothing of JAX is
imported.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

TIMED_RUNS = 25
# the card's published peaks (utils.profiling.H100), set by main() once the
# port is imported
CHIP = None
# K8's serving lines (utils/bench_decode_attn.LINES), set by main() too
K8_LINES = ()

ROOT = Path(__file__).resolve().parent
TPU_PKG = "flash_attention_softmax_n_tpu"
CSRC = "flash_attention_softmax_n_tpu_torch/csrc"
# K1's, K5's, K6's and K10's kernels as torch.profiler names them: bf16
# inputs take the TMA + wgmma kernel, f32 the scalar one
FLASH_FWD_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")
FLASH_DQ_KERNELS = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_kernel")
FLASH_DKV_KERNELS = ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_kernel")
MINI_KERNELS = ("prefill_phase_wgmma_kernel", "prefill_phase_kernel")
# K3's and K4's one kernel
ROW_WRITE_KERNELS = ("append_rows_kernel",)
# f32 outside the tensor cores, H100 SXM (NVIDIA's data sheet, 700 W)
F32_FLOPS = 67e12


T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    # where the run's time goes, on stderr
    print(f"chip_smoke: {time.perf_counter() - T0:8.1f} s {obj.get('phase', '')}",
          file=sys.stderr, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(bytes_moved: float, flops: float = 0.0, peak_flops=None):
    """(least ms for the bytes and the operations, which bounds it); bf16
    operations unless ``peak_flops`` names another peak"""
    t_bytes = bytes_moved / CHIP.hbm_bw
    t_ops = flops / (peak_flops or CHIP.bf16_flops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tflops(ops: float, ms):
    """TFLOP/s of ``ops`` operations done in ``ms`` (None if not timed)"""
    return ops / (ms * 1e-3) / 1e12 if ms else None


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


def device_ms(torch, fn, kernel, runs: int = TIMED_RUNS):
    """Mean device time per call of the kernels whose name holds ``kernel``
    (a substring, a tuple of them, or None for every kernel, as for a
    library call) over ``runs`` calls under ``torch.profiler``: the kernels
    alone, without the host dispatch that CUDA events also count. None if
    the profiler saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    return device_ms_of(torch, [(fn, kernel)], runs)[0]


def device_ms_of(torch, pairs, runs: int = TIMED_RUNS):
    """``device_ms`` of several (fn, kernel) pairs in one profiler session
    (each session costs seconds of host time): each fn runs ``runs`` times
    in turn, and its device time is read from the events under its own
    ``record_function`` range."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    for fn, _ in pairs:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, (fn, _) in enumerate(pairs):
            with record_function(f"device_ms_{i}"):
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith("device_ms_")}
    out = []
    for i, (_, kernel) in enumerate(pairs):
        names = (kernel,) if isinstance(kernel, str) else kernel
        span = ranges[f"device_ms_{i}"]
        total_us = sum(e.time_range.elapsed_us() for e in events
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                       and span.start <= e.time_range.start <= span.end
                       and (names is None or any(k in e.name for k in names)))
        out.append(total_us / 1e3 / runs if total_us else None)
    return out


# ----------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------------


def check_flash(torch, pkg, gen, *, B, H, L, S, D, masked, true_lens=None):
    """K1 against its plain version at (B, H, L, S, D) bf16, causal
    (``masked`` False) or under the engine's admission mask as a (B, 1, L,
    S) bias with the causal flag off: key j is visible iff j < true_len and
    j <= (S - L) + i, true lengths drawn from the range ``true_lens`` (lo,
    hi], by default (15, S]. S > L is a chunk at offset S - L."""
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
        lo, hi = true_lens or (15, S)
        true_lens = torch.randint(lo + 1, hi + 1, (B,), generator=gen, device=dev)
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
    same = repeat_equal(torch, kernel, (o, lse))
    name = f"flash_fwd B{B} H{H} L{L} S{S} d{D} {'mask' if masked else 'causal'}"
    require(excess_o <= 2e-3 and err_lse <= tol_lse and same,
            f"{name}: max |o - plain| - 2^-7 |o_plain| is {excess_o} (tol 2e-3), "
            f"max |lse - plain| {err_lse} (tol {tol_lse}), repeat bit-equal {same}")

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
    dev_ms = device_ms(torch, kernel, FLASH_FWD_KERNELS)
    return {"name": name, "route": "cuda",
            "source": "flash_attention_softmax_n_tpu_torch/csrc/flash_fwd.cu",
            "replaces": f"{TPU_PKG}/kernels/flash_attention.py:345 _fwd_single_kernel, "
                        ":279 _fwd_kernel, :501 _fwd_pipeline_kernel",
            "counter": "flash_fwd",
            "max_abs_err": err_o, "max_abs_err_lse": err_lse, "tolerance": tol_o,
            "repeat_bit_equal": same,
            "ms": time_ms(torch, kernel), "device_ms": dev_ms,
            "tflops": tflops(4.0 * pairs * D, dev_ms), "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(torch, library)}


# K2's kernels as torch.profiler names them: bf16 x's tensor-core kernel,
# f32 x's scalar kernel, and the merge of both
QMM_ARGMAX_KERNELS = ("qmm_argmax_wgmma_kernel", "qmm_argmax_scalar_kernel",
                      "qmm_argmax_merge_kernel")


def check_qmm(torch, pkg, gen, *, M, K, N):
    """K2 at a serving shape (bf16 x, int8 W): held against its plain
    version and required bit-equal over two calls. Prints the plan, W's
    achieved GB/s (its bytes over the device time) and, for information,
    cuBLAS's device time for
    ``torch.max((x @ W_bf16) * s, -1)`` with W dequantized to bf16
    beforehand, from the same profiler session."""
    qm = pkg["quant_matmul"]
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), generator=gen, device=dev).to(torch.int8)
    s = (torch.rand((1, N), generator=gen, device=dev) + 0.5) / (127.0 * K ** 0.5)
    plan = qm.qmm_argmax_plan(M, K, N, x.dtype)

    def kernel():
        return qm.quantized_matmul_argmax(x, w, s, return_max=True)

    def plain():
        return qm.quantized_matmul_argmax_reference(x, w, s)

    w_bf16 = w.to(torch.bfloat16)

    def cublas():
        return torch.max((x @ w_bf16) * s, dim=-1)

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
    same = repeat_equal(torch, kernel, (idx, val))
    require(idx_ok and rel <= 1e-3 and same,
            f"qmm_argmax: indices equal where the top-2 gap > 1e-3: {idx_ok}; "
            f"max relative error of the max {rel} (tol 1e-3); repeat bit-equal {same}")
    b_ms, b_by = bound_ms(x.numel() * 2 + w.numel() + N * 4 + M * 8, 2.0 * M * K * N)
    k_dev, cublas_dev = device_ms_of(torch, [(kernel, QMM_ARGMAX_KERNELS), (cublas, None)])
    line = {"name": f"qmm_argmax M{M} K{K} N{N}", "route": "cuda",
            "source": f"{CSRC}/qmm_argmax.cu",
            "replaces": f"{TPU_PKG}/kernels/quant_matmul.py:117 _qmm_argmax_kernel",
            "counter": "qmm_argmax",
            "max_abs_err": err, "max_rel_err": rel, "tolerance": 1e-3,
            "undecided_rows": int((~decided).sum()), "repeat_bit_equal": same,
            "plan": plan._asdict(), "producer": plan.producer,
            "ms": time_ms(torch, kernel), "device_ms": k_dev,
            "w_gbps": w.numel() / (k_dev * 1e-3) / 1e9 if k_dev else None,
            "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "none: no one PyTorch call computes it (a GEMM and a max)",
            "cublas_device_ms": cublas_dev,
            "cublas": "torch.max((x @ W) * s, -1) over W dequantized to bf16"}
    return line


def check_row_writes(torch, pkg, line):
    """K3 or K4 at one of utils/bench_cache_update.py's lines (its inputs
    and seeds): bit-exact with the plain version, each tensor's vector
    width, the achieved GB/s, host ms (CUDA events less device time) and,
    for information, the device time of the PyTorch calls that compute the
    same writes one tensor at a time, from the same profiler session."""
    cu, bench = pkg["cache_update"], pkg["bench_cache_update"]
    caches, news, where = bench.line_inputs(line)
    want = tuple(c.clone() for c in caches)
    kernel, _, torch_calls = bench.line_calls(cu, line, caches, news, where)
    _, plain, _ = bench.line_calls(cu, line, want, news, where)
    kernel()
    plain()
    torch.cuda.synchronize()
    name = bench.line_name(line)
    require(all(torch.equal(a, b) for a, b in zip(caches, want)),
            f"{name}: kernel result is not bit-exact with the plain version")
    # the same writes again leave the same bytes
    kernel()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(caches, want))
    require(same, f"{name}: a repeated call changed the result")
    moved = bench.line_bytes(news, where)
    b_ms, b_by = bound_ms(moved)
    k_dev, lib_dev = device_ms_of(torch, [(kernel, ROW_WRITE_KERNELS), (torch_calls, None)])
    ms = time_ms(torch, kernel)
    ops = pkg["build"].ops()
    k3 = line[0] == "cache_append"
    return {"name": name, "route": "cuda", "source": f"{CSRC}/cache_update.cu",
            "replaces": f"{TPU_PKG}/kernels/cache_update.py:"
                        + ("92 _kernel" if k3 else "40 _tail_kernel"),
            "counter": line[0],
            "max_abs_err": 0.0, "tolerance": "bit-exact", "repeat_bit_equal": same,
            "vector_bytes": [ops.cache_vector_bytes(c, nw) for c, nw in zip(caches, news)],
            "ms": ms, "device_ms": k_dev, "host_ms": ms - k_dev if k_dev else None,
            "gbps": moved / (k_dev * 1e-3) / 1e9 if k_dev else None,
            "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "none: no one PyTorch call writes every tensor",
            "torch_calls_device_ms": lib_dev,
            "torch_calls": ("index_put_ with (b, positions), one a tensor" if k3
                            else "select(3, index).copy_, one a tensor")}


def repeat_equal(torch, fn, first) -> bool:
    again = fn()
    torch.cuda.synchronize()
    pairs = zip(first, again) if isinstance(first, tuple) else [(first, again)]
    return all(torch.equal(a, b) for a, b in pairs)


# K7's kernels as torch.profiler names them: the tensor-core kernel, the f32
# mode's FMA kernel and the split-K sum
QMM_KERNELS = ("qmm_wgmma_kernel", "qmm_f32_kernel", "qmm_splitk_sum_kernel")


def check_dequant_mm(torch, pkg, gen, *, M, K, N, mode="int8"):
    """K7 at one serving shape: ``mode`` int8, w8a8 (int8 activations) or
    int4 (grouped, packed along K). Prints the plan (tiles, ring, splits,
    producer) and, beside ``library_ms``, the library call's own device
    time ``library_device_ms``."""
    qm, qt = pkg["quant_matmul"], pkg["qtensor"]
    dev, dt = "cuda", torch.bfloat16
    bits = 4 if mode == "int4" else 8
    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
    wq = qt.quantize(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5,
                     bits=bits, axis=0)
    xk, xs = qm.quantize_rows(x) if mode == "w8a8" else (x, None)
    plan = qm.qmm_plan(M, K, N, qm.qmm_mode(xk.dtype, bits))

    def kernel():
        return qm._qmm_cuda(xk, xs, wq.values, wq.scales, bits, dt)

    def plain():
        return qm.quantized_matmul_reference(xk, xs, wq.values, wq.scales, bits=bits,
                                             out_dtype=dt)

    w_bf16 = qt.dequantize(wq, dt)

    def library():
        return x @ w_bf16

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    same = repeat_equal(torch, kernel, out)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    # one bf16 ulp of the plain output (the two round f32 sums taken in
    # another order); W8A8 sums integers and must match exactly
    excess = float((diff - 2.0 ** -7 * ref.float().abs()).max())
    ok = err == 0.0 if mode == "w8a8" else excess <= 1e-5 * float(ref.float().abs().max())
    name = f"qmm {mode} M{M} K{K} N{N} bf16"
    require(ok and same, f"{name}: max |out - plain| {err} (beyond one bf16 ulp: {excess}); "
                         f"repeat bit-equal {same}")
    bytes_moved = (xk.numel() * xk.element_size() + wq.values.numel() + N * 4 + M * N * 2
                   + (M * 4 if xs is not None else 0))
    b_ms, b_by = bound_ms(bytes_moved, 2.0 * M * K * N,
                          CHIP.int8_ops if mode == "w8a8" else CHIP.bf16_flops)
    k_dev, lib_dev = device_ms_of(torch, [(kernel, QMM_KERNELS), (library, None)])
    return {"name": name, "route": "cuda", "source": f"{CSRC}/qmm.cu",
            "replaces": f"{TPU_PKG}/kernels/quant_matmul.py:65 _qmm_kernel",
            "counter": "qmm", "max_abs_err": err,
            "tolerance": "bit-exact" if mode == "w8a8" else "one bf16 ulp + 1e-5 max|out|",
            "repeat_bit_equal": same, "producer": plan.producer, "plan": plan._asdict(),
            "ms": time_ms(torch, kernel), "device_ms": k_dev,
            "plain_ms": time_ms(torch, plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, library), "library_device_ms": lib_dev,
            "library": "torch.matmul over the weights dequantized to bf16"}


def check_dequant_f32(torch, pkg, gen, *, M, K, N, bits=8):
    """K7 with f32 activations (int8 or grouped int4 weights, f32 out): the
    f32 FMA kernel ``qmm_f32_kernel`` (and its split-K sum), bound by f32
    operations at 67 TFLOP/s, against ``torch.matmul`` in f32 (TF32 off)
    over the weights dequantized to f32. Prints the plan (tile, ring
    stages, splits, loader) and the kernel's shared-memory bytes a CTA,
    and requires the kernel's ring to be as deep as the plan says."""
    qm, qt = pkg["quant_matmul"], pkg["qtensor"]
    plan = qm.qmm_plan(M, K, N, "f32")
    stages, smem = pkg["build"].ops().qmm_f32_layout(plan.bm)
    require(stages == plan.stages, f"qmm f32 M{M} K{K} N{N}: the kernel's ring has {stages} "
                                   f"stages, the plan {plan.stages}")
    dev, dt = "cuda", torch.float32
    x = torch.randn((M, K), generator=gen, device=dev)
    wq = qt.quantize(torch.randn((K, N), generator=gen, device=dev) * K ** -0.5, bits=bits,
                     axis=0)

    def kernel():
        return qm._qmm_cuda(x, None, wq.values, wq.scales, bits, dt)

    def plain():
        return qm.quantized_matmul_reference(x, None, wq.values, wq.scales, bits=bits,
                                             out_dtype=dt)

    w_f32 = qt.dequantize(wq, dt)

    def library():
        return x @ w_f32

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    same = repeat_equal(torch, kernel, out)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    name = f"qmm f32{' int4' if bits == 4 else ''} M{M} K{K} N{N} f32"
    require(err <= 1e-5 * scale and same,
            f"{name}: max |out - plain| {err} > 1e-5 * {scale}, or repeat bit-equal {same}")
    b_ms, b_by = bound_ms(x.numel() * 4 + wq.values.numel() + N * 4 + M * N * 4,
                          2.0 * M * K * N, F32_FLOPS)
    k_dev, lib_dev = device_ms_of(torch, [(kernel, QMM_KERNELS), (library, None)])
    return {"name": name, "route": "cuda", "source": f"{CSRC}/qmm.cu",
            "replaces": f"{TPU_PKG}/kernels/quant_matmul.py:65 _qmm_kernel",
            "counter": "qmm", "max_abs_err": err, "tolerance": "1e-5 max|out|",
            "repeat_bit_equal": same, "plan": plan._asdict(), "producer": plan.producer,
            "smem_bytes": smem, "ms": time_ms(torch, kernel), "device_ms": k_dev,
            "tflops": tflops(2.0 * M * K * N, k_dev), "plain_ms": time_ms(torch, plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(torch, library),
            "library_device_ms": lib_dev,
            "library": "torch.matmul in f32 (TF32 off) over the weights dequantized to f32"}


# K9's kernels as torch.profiler names them: bf16 x's gate/up phase (and
# its split sum, which forms h), its down phase (K7's kernel under K9's
# name) and that phase's split sum; f32 x's scalar kernel and its sum
FUSED_MLP_KERNELS = ("fused_mlp_gateup_kernel", "fused_mlp_swiglu_sum_kernel",
                     "fused_mlp_down_kernel", "fused_mlp_down_sum_kernel", "fused_mlp_kernel",
                     "fused_mlp_sum_kernel")


def check_fused_mlp(torch, pkg, gen, *, M, K, F):
    """K9 at a decode shape (bf16 x, int8 gate/up/down). Prints the plan of
    both phases and, beside ``library: none``, the device time of cuBLAS
    over the same weights dequantized to bf16 (three ``torch.matmul`` and a
    silu), from the same profiler session."""
    fm, qt = pkg["fused_mlp"], pkg["qtensor"]
    dev, dt = "cuda", torch.bfloat16
    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
    ws = [qt.quantize(torch.randn(shape, generator=gen, device=dev) * shape[0] ** -0.5,
                      bits=8, axis=0) for shape in ((K, F), (K, F), (F, K))]
    args = (x, ws[0].values, ws[0].scales, ws[1].values, ws[1].scales, ws[2].values,
            ws[2].scales)
    plan = fm.fused_mlp_plan(M, K, F, dt)

    def kernel():
        return fm._fused_mlp_cuda(*args)

    def plain():
        return fm.fused_mlp_reference(*args)

    wg_b, wu_b, wd_b = (qt.dequantize(w, dt) for w in ws)
    silu = torch.nn.functional.silu

    def cublas():
        return (silu(x @ wg_b) * (x @ wu_b)) @ wd_b

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    same = repeat_equal(torch, kernel, out)
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    err_norm = norm_err(out, ref)
    norm_tol = BWD_NORM_TOL["bf16"]
    name = f"fused_mlp M{M} K{K} F{F} bf16"
    # h rounds to bf16 before the down product, on either side of a tie
    require(err <= 2e-2 * scale and err_norm <= norm_tol and same,
            f"{name}: max |out - plain| {err} > 2e-2 * {scale}, or norm-wise {err_norm} > "
            f"{norm_tol}, or repeat bit-equal {same}")
    b_ms, b_by = bound_ms(M * K * 2 * 2 + 3 * K * F + (2 * F + K) * 4, 6.0 * M * K * F)
    k_dev, cublas_dev = device_ms_of(torch, [(kernel, FUSED_MLP_KERNELS), (cublas, None)])
    return {"name": name, "route": "cuda", "source": f"{CSRC}/fused_mlp.cu",
            "replaces": f"{TPU_PKG}/kernels/fused_mlp.py:44 _mlp_kernel",
            "counter": "fused_mlp", "max_abs_err": err, "norm_err": err_norm,
            "tolerance": "2e-2 max|out|; norm-wise 1e-2 max(1, ||plain||)",
            "repeat_bit_equal": same,
            "plan": {"kernel": plan.kernel, "gate_up": plan.gate_up._asdict(),
                     "down": plan.down._asdict()},
            "ms": time_ms(torch, kernel), "device_ms": k_dev,
            "tflops": tflops(6.0 * M * K * F, k_dev),
            "plain_ms": time_ms(torch, plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library": "none: no one PyTorch call computes it (three GEMMs and a silu)",
            "cublas_device_ms": cublas_dev,
            "cublas": "three torch.matmul and a silu over the weights dequantized to bf16"}


# K8's kernels as torch.profiler names them: the split kernel and the merge
DECODE_ATTN_KERNELS = ("decode_attn_split_kernel", "decode_attn_merge_kernel")


def check_decode_attn(torch, pkg, line):
    """K8 at one of its serving lines (``bench_decode_attn.LINES``): bf16 q
    over an int8 or fp8 (with scales) or a bf16 cache view of one layer,
    lengths drawn from 0..S by the line's own seed, as the K8 benchmark
    draws them. Prints the plan's split length, products and the CTAs of
    its grid."""
    da, kv = pkg["decode_attention"], pkg["kv_cache"]
    dev = "cuda"
    B, KVH, G, S, D, cache, _ = line
    q, k, v, ks, vs, lengths, full = pkg["bench_decode_attn"].line_inputs(kv, line)

    def kernel():
        return da._decode_attn_cuda(q, None, k, v, lengths, ks, vs)

    def plain():
        return da.decode_attn_stats_reference(q, None, k, v, lengths, ks, vs)

    (acc, m, l), (acc_r, m_r, l_r) = kernel(), plain()
    torch.cuda.synchronize()
    same = repeat_equal(torch, kernel, (acc, m, l))
    live = lengths > 0
    out, out_r = acc[live] / l[live][..., None], acc_r[live] / l_r[live][..., None]
    err = float((out - out_r).abs().max())
    err_m = float((m[live] - m_r[live]).abs().max())
    err_l = float(((l[live] - l_r[live]).abs() / l_r[live]).max())
    empty_ok = bool((acc[~live] == 0).all() and (l[~live] == 0).all())
    name = f"decode_attn B{B} KVH{KVH} G{G} S{S} d{D} {cache} cache, bf16 q"
    # p rounds to bf16 against a split's own maximum in the kernel and the
    # running one in the plain version
    require(err <= 2e-2 and err_m <= 1e-3 and err_l <= 1e-3 and empty_ok and same,
            f"{name}: out {err} (tol 2e-2), m {err_m}, l rel {err_l} (tol 1e-3), empty slots "
            f"zero {empty_ok}, repeat bit-equal {same}")

    # the library yardstick: SDPA over a bf16 cache with a length mask
    kb, vb = (t.to(torch.bfloat16) for t in full)
    kb, vb = kb[1], vb[1]
    qh = q.reshape(B, KVH * G, 1, D)
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None].long())[:, None, None, :]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kb, vb, attn_mask=mask, scale=1.0, enable_gqa=True)

    split = da.decode_attn_plan(B, KVH, S, D, k.element_size(), False)
    products = da.decode_attn_products(q.dtype, k.dtype, D)
    total = float(lengths.sum())
    elem = k.element_size()
    bytes_moved = (q.numel() * 2 + total * KVH * (2 * D * elem + (8 if ks is not None else 0))
                   + B * KVH * G * (D + 2) * 4 + B * 4)
    b_ms, b_by = bound_ms(bytes_moved, 4.0 * G * D * KVH * total)
    return {"name": name, "route": "cuda", "source": f"{CSRC}/decode_attn.cu",
            "replaces": f"{TPU_PKG}/kernels/decode_attention.py:60 _kernel",
            "counter": "decode_attn", "max_abs_err": err, "max_abs_err_m": err_m,
            "max_rel_err_l": err_l, "tolerance": "out 2e-2, m and l 1e-3",
            "repeat_bit_equal": same, "positions": int(total),
            "plan": {"split": split, "ctas": B * KVH * -(-S // split),
                     "products": "mma" if products == da.MMA else "fma"},
            "ms": time_ms(torch, kernel),
            "device_ms": device_ms(torch, kernel, DECODE_ATTN_KERNELS),
            "plain_ms": time_ms(torch, plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, library),
            "library": "scaled_dot_product_attention(enable_gqa=True), bf16 cache, length mask"}


def check_mini(torch, pkg, gen, *, mode, B, H, L, D):
    """K10 in one mode at the prefill-phase profile's shape: bf16 q, k, v
    of 0.3·N(0, 1), as the profile draws them."""
    pp = pkg["prefill_phases"]
    q, k, v = ((0.3 * torch.randn((B, H, L, D), generator=gen, device="cuda"))
               .to(torch.bfloat16) for _ in range(3))

    def kernel():
        return pp._mini_cuda(mode, q, k, v)

    def plain():
        return pp.mini_reference(mode, q, k, v)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    same = repeat_equal(torch, kernel, out)
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    # o is bf16 and the two sum in different orders, so o may round one
    # bf16 ulp apart (2^-7 |o|); p rounds to bf16 from f32 values that may
    # differ in their last bits (l summed in another order), so a rare p
    # rounds the other way: one per row, 2^-7 max|p| max|v|
    excess = float((diff - pp.mini_tolerance(mode, q, k, v, ref)).max())
    name = f"prefill_phase {mode} B{B} H{H} L{L} d{D} bf16"
    require(excess <= 0 and same,
            f"{name}: max |o - plain| - tolerance is {excess} (> 0 fails); "
            f"repeat bit-equal {same}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = {"softmax": (lambda: sdpa(q, k, v, scale=1.0),
                           "scaled_dot_product_attention(scale=1.0)"),
               "mask_softmax": (lambda: sdpa(q, k, v, is_causal=True, scale=1.0),
                                "scaled_dot_product_attention(is_causal=True, scale=1.0)"),
               "dots_only": (lambda: torch.matmul(torch.matmul(q, k.transpose(-1, -2)), v),
                             "two torch.matmul calls, bf16 scores"),
               "exp_only": (None, "none: no one PyTorch call computes exp(q k^T) v")}[mode]
    # mask_softmax needs only the causal half of the score square
    pairs = B * H * (L * (L + 1) / 2 if mode == "mask_softmax" else L * L)
    b_ms, b_by = bound_ms(4 * B * H * L * D * 2, 4.0 * D * pairs)
    dev_ms = device_ms(torch, kernel, MINI_KERNELS)
    return {"name": name, "route": "cuda", "source": f"{CSRC}/prefill_phases.cu",
            "replaces": "scripts/profile_prefill_phases.py:45 _mini_kernel",
            "counter": f"mini_{mode}", "max_abs_err": err, "max_excess_over_tol": excess,
            "tolerance": "2^-7 (|o_plain| + row max |p| * head max |v|), mini_tolerance",
            "repeat_bit_equal": same,
            "ms": time_ms(torch, kernel), "device_ms": dev_ms,
            "tflops": tflops(4.0 * D * pairs, dev_ms),
            "plain_ms": time_ms(torch, plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, library[0]) if library[0] else None,
            "library": library[1]}


# ----------------------------------------------------------------------------
# phase 4: the training kernels (K1 with ALiBi and dropout, K5, K6)
# ----------------------------------------------------------------------------

FLASH_PY = f"{TPU_PKG}/kernels/flash_attention.py"
# K5's and K6's gradients against their plain version: each element within
# 2e-2 (bf16) or 1e-4 (f32) of max(1, max |plain|), and the whole within
# these shares of max(1, ||plain||). On an H100 the checks below read at
# most 2.8e-3 in bf16 (dv: the kernel rounds the dropped p to bf16, the
# plain version keeps f32; dq and dk 1.7e-4) and 3.1e-7 in f32; a copy of
# K5 that skipped one 64-key chunk for query rows from 1024 on read 8.3e-2
# on dq at the training shape
BWD_NORM_TOL = {"bf16": 1e-2, "f32": 1e-5}


def attn_inputs(torch, gen, dtype, *, B, H, L, S, D, bias_shape=None, alibi=False, rate=0.0):
    q, k, v, do = (torch.randn((B, H, m, D), generator=gen, device="cuda").to(dtype)
                   for m in (L, S, S, L))
    ex = {"bias": None, "slopes": None, "seed": None, "dropout_rate": rate}
    if bias_shape is not None:
        ex["bias"] = 0.5 * torch.randn((*bias_shape, L, S), generator=gen, device="cuda")
    if alibi:
        ex["slopes"] = torch.tensor([2.0 ** -(i % 8 + 1) for i in range(H)], device="cuda")
    if rate > 0:
        ex["seed"] = torch.tensor([-123457], dtype=torch.int32, device="cuda")
    return q, k, v, do, ex


def run_fwd(fa, plain, q, k, v, ex, *, n, causal):
    fwd = fa.flash_fwd_reference if plain else fa.flash_fwd
    return fwd(q, k, v, ex["bias"], n=n, scale=q.shape[-1] ** -0.5, is_causal=causal,
               slopes=ex["slopes"], seed=ex["seed"], dropout_rate=ex["dropout_rate"])


def run_bwd(fa, plain, q, k, v, do, o, lse, ex, *, causal):
    """(dq, dk, dv, dbias, dslopes) through K5/K6 or their plain version"""
    bwd = fa.flash_bwd_reference if plain else fa.flash_bwd
    return bwd(q, k, v, ex["bias"], ex["slopes"], ex["seed"], o, lse, do,
               scale=q.shape[-1] ** -0.5, is_causal=causal, dropout_rate=ex["dropout_rate"])


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)"""
    return float((got.float() - want.float()).abs().max()) / max(
        1.0, float(want.float().abs().max()))


def norm_err(got, want) -> float:
    """||got - want|| over max(1, ||want||): a gradient wrong only where it
    is small beside max |want| (far tiles of a long causal row) still moves
    it; a gradient that is zero (one key and n = 0) is held absolutely"""
    return float((got.float() - want.float()).norm()) / max(1.0, float(want.float().norm()))


def fwd_float64(torch, fa, q, k, v, ex, *, n, causal, heads=4):
    """K1's function evaluated in float64 on the card: the same q (scaled in
    its dtype, as the kernels scale it), k, v, bias, ALiBi slopes and
    dropout keep-mask (the hash of the seed and the coordinates, with the
    kernels' f32 multiplier), p unrounded. Returns (o, o_abs), o_abs the
    same with |v|, which bounds what rounding p can move. ``heads`` at a
    time bound the (B, heads, L, S) float64 scores."""
    B, H, L, D = q.shape
    S = k.shape[2]
    dev = q.device
    qs = (q * torch.tensor(D ** -0.5, dtype=q.dtype)).double()
    rate = ex["dropout_rate"]
    mult = float(np.float32(1.0 / (1.0 - rate)))
    qpos = torch.arange(L, device=dev)[:, None] + (S - L)
    kpos = torch.arange(S, device=dev)[None, :]
    outs, abss = [], []
    for h0 in range(0, H, heads):
        hs = slice(h0, min(H, h0 + heads))
        s = qs[:, hs] @ k[:, hs].double().transpose(-1, -2)
        if ex["bias"] is not None:
            bias = ex["bias"]
            s = s + (bias[:, hs] if bias.shape[1] != 1 else bias).double()
        if ex["slopes"] is not None:
            s = s - ex["slopes"][hs].double()[:, None, None] * (qpos - kpos).abs().double()
        if causal:
            s = s.masked_fill(kpos > qpos, float("-inf"))
        m = s.amax(-1, keepdim=True)
        if n > 0:
            m = m.clamp(min=0.0)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True) + n * torch.exp(-m)
        if rate > 0:
            ar = lambda *r: torch.arange(*r, device=dev)  # noqa: E731
            keep = fa.dropout_keep(ex["seed"].reshape(()), ar(B)[:, None, None, None],
                                   ar(hs.start, hs.stop)[None, :, None, None],
                                   ar(L)[None, None, :, None], ar(S)[None, None, None, :],
                                   rate)
            p = p * torch.where(keep, mult, 0.0).double()
        outs.append((p @ v[:, hs].double()) / l)
        abss.append((p @ v[:, hs].double().abs()) / l)
        del s, p
    return torch.cat(outs, 1), torch.cat(abss, 1)


def o_excess(got, o64, o_abs64, p_roundings: int = 1) -> float:
    """max of |o - o64| - allowance, o64 and o_abs64 from ``fwd_float64``.

    The allowance, per element: 2^-8 |o64| + (p_roundings 2^-8 + 2^-11)
    o_abs64. A bf16 o rounds to nearest, off by at most half an ulp, 2^-8
    of |o| (2^-8 of the value at the bottom of its binade); each dropped p
    is rounded to bf16 before PV (the kernel against its running maximum,
    the plain version against the final one), off by up to 2^-8 of p, which
    moves o by at most 2^-8 sum_j p_j |v_j| / l = 2^-8 o_abs. The ring
    rounds once more: each block's o_b is bf16 before the fold
    (``p_roundings=2``). 2^-11 o_abs covers the f32 arithmetic: scores,
    ALiBi distances, exp and sums over at most 8192 keys (S 2^-24 of the
    sum of |terms|), and the product of the two bf16 errors (2^-16)."""
    tol = 2.0 ** -8 * o64.abs() + (p_roundings * 2.0 ** -8 + 2.0 ** -11) * o_abs64
    return float(((got.double() - o64).abs() - tol).max())


def check_attention(torch, fa, gen, dtype, *, n, causal, shape, **extras):
    """K1, K5 and K6 against their plain versions on one input, each run
    twice; both backward versions take the plain forward's o and lse, so
    each kernel is held alone. Returns the inputs and the errors."""
    B, H, L, S, D = shape
    q, k, v, do, ex = attn_inputs(torch, gen, dtype, B=B, H=H, L=L, S=S, D=D, **extras)
    o, lse = run_fwd(fa, False, q, k, v, ex, n=n, causal=causal)
    o_ref, lse_ref = run_fwd(fa, True, q, k, v, ex, n=n, causal=causal)
    o64, o_abs64 = fwd_float64(torch, fa, q, k, v, ex, n=n, causal=causal)
    got = run_bwd(fa, False, q, k, v, do, o_ref, lse_ref, ex, causal=causal)
    want = run_bwd(fa, True, q, k, v, do, o_ref, lse_ref, ex, causal=causal)
    again = (*run_fwd(fa, False, q, k, v, ex, n=n, causal=causal),
             *run_bwd(fa, False, q, k, v, do, o_ref, lse_ref, ex, causal=causal))
    torch.cuda.synchronize()
    first = (o, lse, *got)
    repeat_equal = all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(first, again))
    errs = {"o": float((o.float() - o_ref.float()).abs().max()),
            "o_excess": o_excess(o, o64, o_abs64),
            "o_excess_plain": o_excess(o_ref, o64, o_abs64),
            "lse": float((lse - lse_ref).abs().max())}
    del o64, o_abs64
    norm, plain_max = {}, {}
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dslopes"), got, want):
        require((g is None) == (w is None), f"{name}: kernel and plain disagree on presence")
        if g is not None:
            errs[name] = rel_err(g, w)
            norm[name] = norm_err(g, w)
            plain_max[name] = float(w.float().abs().max())
    f32 = dtype == torch.float32
    gtol = 1e-4 if f32 else 2e-2
    ntol = BWD_NORM_TOL["f32" if f32 else "bf16"]
    o_ok = (errs["o"] <= 2e-5 if f32
            else errs["o_excess"] <= 0.0 and errs["o_excess_plain"] <= 0.0)
    name = (f"B{B} H{H} L{L} S{S} d{D} {'f32' if f32 else 'bf16'} n{n:g} "
            f"{'causal' if causal else 'full'} {sorted(k for k, v in extras.items() if v)}")
    require(o_ok and errs["lse"] <= 1e-3, f"K1 {name}: o/lse off the plain version: {errs}")
    grad_errs = {k_: e for k_, e in errs.items()
                 if k_ not in ("o", "o_excess", "o_excess_plain", "lse")}
    errs["norm"], errs["plain_max"] = norm, plain_max
    require(max(grad_errs.values()) <= gtol,
            f"K5/K6 {name}: gradients off the plain version (tol {gtol} of max(1, |plain|)): "
            f"{grad_errs}, max |plain| {plain_max}")
    require(max(norm.values()) <= ntol,
            f"K5/K6 {name}: gradients off the plain version (tol {ntol} of max(1, ||plain||)): "
            f"{norm}, max |plain| {plain_max}")
    require(repeat_equal, f"{name}: two calls of the kernels are not bit-equal")
    return (q, k, v, do, ex, o_ref, lse_ref), errs, name


def check_dropout_masks(torch, fa):
    """q = k = 0 makes p uniform (1/S), so the kept entries show directly:
    K1's o with v = I, K5's dbias (= ds = dropped p times dp = 1, against o
    = 0 and lse = log S) and K6's dv with dout = I are nonzero exactly where
    the plain hash keeps; each in f32 and in bf16 (the wgmma kernels)."""
    B, H, N, rate = 2, 4, 128, 0.3
    z = torch.zeros((B, H, N, N), device="cuda")
    eye = torch.eye(N, device="cuda").expand(B, H, N, N).contiguous()
    e0 = torch.zeros_like(z)
    e0[..., 0] = 1.0
    seed = torch.tensor([-99], dtype=torch.int32, device="cuda")
    keep = fa.dropout_multiplier(seed, (B, H, N, N), rate, "cuda") > 0
    lse = torch.full((B, H, N), float(np.log(N)), device="cuda")
    o, _ = fa.flash_fwd(z, z, eye, None, n=0.0, scale=1.0, is_causal=False, seed=seed,
                        dropout_rate=rate)
    zb, eyeb = z.to(torch.bfloat16), eye.to(torch.bfloat16)
    o_bf16, _ = fa.flash_fwd(zb, zb, eyeb, None, n=0.0, scale=1.0, is_causal=False, seed=seed,
                             dropout_rate=rate)
    dbias = fa.flash_bwd(z, z, e0, torch.zeros((1, 1, N, N), device="cuda"), None, seed, z,
                         lse, e0, scale=1.0, is_causal=False, dropout_rate=rate)[3]
    dv = fa.flash_bwd(z, z, z, None, None, seed, z, lse, eye, scale=1.0, is_causal=False,
                      dropout_rate=rate)[2]
    e0b = e0.to(torch.bfloat16)
    dbias_bf16 = fa.flash_bwd(zb, zb, e0b, torch.zeros((1, 1, N, N), device="cuda"), None, seed,
                              zb, lse, e0b, scale=1.0, is_causal=False, dropout_rate=rate)[3]
    dv_bf16 = fa.flash_bwd(zb, zb, zb, None, None, seed, zb, lse, eyeb, scale=1.0,
                           is_causal=False, dropout_rate=rate)[2]
    torch.cuda.synchronize()
    equal = {"flash_fwd": bool(torch.equal(o != 0, keep)),
             "flash_fwd_bf16": bool(torch.equal(o_bf16 != 0, keep)),
             "flash_bwd_dq": bool(torch.equal(dbias != 0, keep)),
             "flash_bwd_dq_bf16": bool(torch.equal(dbias_bf16 != 0, keep)),
             "flash_bwd_dkv": bool(torch.equal(dv.transpose(-1, -2) != 0, keep)),
             "flash_bwd_dkv_bf16": bool(torch.equal(dv_bf16.transpose(-1, -2) != 0, keep))}
    emit({"phase": "dropout_masks", "shape": [B, H, N, N], "rate": rate,
          "kept_share": float(keep.float().mean()), "bit_equal": equal})
    require(all(equal.values()), f"a kernel's dropout mask differs from the plain hash: {equal}")


def train_kernel_lines(torch, pkg, gen):
    """The three kernels at the training shape (B2 H32 L=S=2048 d64 bf16
    causal, n = 1, dropout 0.1, as every layer of the train phase runs
    them): errors, and times against their bounds, plain versions and
    scaled_dot_product_attention with one zero key/value row prepended."""
    fa, ops = pkg["flash_attention"], pkg["build"].ops()
    B, H, L, D, n, rate = 2, 32, 2048, 64, 1.0, 0.1
    (q, k, v, do, ex, o, lse), errs, name = check_attention(
        torch, fa, gen, torch.bfloat16, n=n, causal=True, shape=(B, H, L, L, D), rate=rate)
    emit({"phase": "kernel_check", "name": name, "errors": errs, "repeat_bit_equal": True})
    scale = D ** -0.5
    pairs = B * H * L * (L + 1) / 2  # causal (query, key) pairs
    bhld, bhl = B * H * L * D, B * H * L

    # the operators alone, with the arguments the wrappers give them
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    thresh, mult = min(int(round(rate * 2 ** 31)), 2 ** 31 - 1), float(np.float32(1 / (1 - rate)))
    delta = torch.sum(do.float() * o.float(), dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def k5():
        ops.flash_bwd_dq(q, k, v, None, None, ex["seed"], do, lse, delta, dq, None, None,
                         scale_q, scale, True, thresh, mult)

    def k6():
        ops.flash_bwd_dkv(q, k, v, None, None, ex["seed"], do, lse, delta, dk, dv, scale_q,
                          True, thresh, mult)

    def k1():
        return run_fwd(fa, False, q, k, v, ex, n=n, causal=True)

    slopes = torch.tensor([2.0 ** -(i % 8 + 1) for i in range(H)], device="cuda")
    # K1 with ALiBi and dropout on the same inputs, against its plain version
    ex_alibi = {**ex, "slopes": slopes}
    o_a, lse_a = run_fwd(fa, False, q, k, v, ex_alibi, n=n, causal=True)
    o_a_ref, lse_a_ref = run_fwd(fa, True, q, k, v, ex_alibi, n=n, causal=True)
    o64, o_abs64 = fwd_float64(torch, fa, q, k, v, ex_alibi, n=n, causal=True)
    torch.cuda.synchronize()
    errs_a = {"o": float((o_a.float() - o_a_ref.float()).abs().max()),
              "o_excess": o_excess(o_a, o64, o_abs64),
              "o_excess_plain": o_excess(o_a_ref, o64, o_abs64),
              "lse": float((lse_a - lse_a_ref).abs().max())}
    del o_a_ref, o64, o_abs64
    emit({"phase": "kernel_check", "name": f"K1 {name} +alibi", "errors": errs_a})
    require(errs_a["o_excess"] <= 0.0 and errs_a["o_excess_plain"] <= 0.0
            and errs_a["lse"] <= 1e-3,
            f"K1 {name} +alibi: o/lse off the float64 evaluation or the plain "
            f"version: {errs_a}")

    def k1_alibi():
        return run_fwd(fa, False, q, k, v, {**ex, "slopes": slopes}, n=n, causal=True)

    def plain_fwd():
        return run_fwd(fa, True, q, k, v, ex, n=n, causal=True)

    def plain_bwd():
        return run_bwd(fa, True, q, k, v, do, o, lse, ex, causal=True)

    def wrapper_bwd():
        return run_bwd(fa, False, q, k, v, do, o, lse, ex, causal=True)

    # the library yardstick: SDPA over K/V with one zero row prepended (n = 1)
    # under the same causal mask and dropout rate; backward timed alone
    zrow = torch.zeros((B, H, 1, D), dtype=q.dtype, device="cuda")
    causal = torch.ones((L, L), dtype=torch.bool, device="cuda").tril()
    mask1 = torch.cat([torch.ones((L, 1), dtype=torch.bool, device="cuda"), causal], -1)
    ql, kl, vl = (t.detach().clone().requires_grad_(True)
                  for t in (q, torch.cat([zrow, k], 2), torch.cat([zrow, v], 2)))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask1, dropout_p=rate, scale=scale)

    out_l = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(out_l, (ql, kl, vl), do, retain_graph=True)

    plain_bwd_ms, library_bwd_ms = time_ms(torch, plain_bwd), time_ms(torch, sdpa_bwd)
    # one profiler session: K5 and K6 alone, the wrapper's every kernel
    # (delta's torch ops, K5, K6), SDPA's backward's every kernel
    k5_dev, k6_dev, pair_dev, library_bwd_dev = device_ms_of(
        torch, [(wrapper_bwd, FLASH_DQ_KERNELS), (wrapper_bwd, FLASH_DKV_KERNELS),
                (wrapper_bwd, None), (sdpa_bwd, None)])
    common = {"route": "cuda", "tolerance": "o: 2^-8 |o64| + (2^-8 + 2^-11) (p|v|)64 of a "
                                            "float64 evaluation, K1 and plain each; grads: "
                                            "2e-2 of max(1, |plain|) and "
                                            f"{BWD_NORM_TOL['bf16']} of max(1, ||plain||); repeat "
                                            "calls bit-equal", "path": "train"}
    b1, by1 = bound_ms(4 * bhld * 2 + bhl * 4, 4.0 * D * pairs)
    k1_dev = device_ms(torch, k1, FLASH_FWD_KERNELS)
    b5, by5 = bound_ms(5 * bhld * 2 + 2 * bhl * 4, 6.0 * D * pairs)
    b6, by6 = bound_ms(6 * bhld * 2 + 2 * bhl * 4, 8.0 * D * pairs)
    shape = f"B{B} H{H} L{L} S{L} d{D} bf16 causal n1 dropout {rate}"
    lines = [
        {**common, "name": f"flash_fwd +dropout {shape}", "counter": "flash_fwd",
         "source": f"{CSRC}/flash_fwd.cu",
         "replaces": f"{FLASH_PY}:345 _fwd_single_kernel, :279 _fwd_kernel, "
                     ":501 _fwd_pipeline_kernel (ALiBi and dropout)",
         "max_abs_err": errs["o"], "max_abs_err_lse": errs["lse"], "ms": time_ms(torch, k1),
         "ms_with_alibi": time_ms(torch, k1_alibi),
         "device_ms": k1_dev, "tflops": tflops(4.0 * D * pairs, k1_dev),
         "plain_ms": time_ms(torch, plain_fwd), "bound_ms": b1, "bound_by": by1,
         "library_ms": time_ms(torch, sdpa)},
        {**common, "name": f"flash_bwd_dq {shape}", "counter": "flash_bwd_dq",
         "source": f"{CSRC}/flash_bwd_dq.cu", "replaces": f"{FLASH_PY}:685 _bwd_dq_kernel",
         "max_abs_err": errs["dq"], "ms": time_ms(torch, k5),
         "device_ms": k5_dev, "tflops": tflops(6.0 * D * pairs, k5_dev),
         "plain_ms": plain_bwd_ms, "bound_ms": b5, "bound_by": by5,
         "library_ms": library_bwd_ms},
        {**common, "name": f"flash_bwd_dkv {shape}", "counter": "flash_bwd_dkv",
         "source": f"{CSRC}/flash_bwd_dkv.cu", "replaces": f"{FLASH_PY}:777 _bwd_dkv_kernel",
         "max_abs_err": max(errs["dk"], errs["dv"]), "ms": time_ms(torch, k6),
         "device_ms": k6_dev, "tflops": tflops(8.0 * D * pairs, k6_dev),
         "plain_ms": plain_bwd_ms, "bound_ms": b6, "bound_by": by6,
         "library_ms": library_bwd_ms},
    ]
    # the pair as the training step runs it (flash_bwd: delta, K5, K6)
    # against SDPA's backward, both by device time and by CUDA events. Its
    # bound counts what dq, dk and dv need, 10·d a pair (S, dP, dV, dK, dQ
    # once each), not the 14·d the two kernels do: each recomputes S and dP
    b56, by56 = bound_ms(8 * bhld * 2 + bhl * 4, 10.0 * D * pairs)
    emit({"phase": "kernel_pair", "name": f"flash_bwd (delta + K5 + K6) {shape}",
          "ms": time_ms(torch, wrapper_bwd), "device_ms": pair_dev,
          "tflops": tflops(10.0 * D * pairs, pair_dev), "bound_ms": b56, "bound_by": by56,
          "library_ms": library_bwd_ms, "library_device_ms": library_bwd_dev,
          "vs_library_device": pair_dev / library_bwd_dev if pair_dev and library_bwd_dev
          else None})
    for line in lines:
        emit({"phase": "kernel", **{k_: line.get(k_) for k_ in (
            "name", "max_abs_err", "tolerance", "ms", "ms_with_alibi", "device_ms", "tflops",
            "plain_ms", "bound_ms", "library_ms")}})
    emit({"phase": "kernel_note", "note": "flash_bwd plain_ms and library_ms cover dq, dk "
          "and dv together (one plain backward, one SDPA backward); max_abs_err of the "
          "backward lines is relative to max(1, |plain|); the kernel_check lines give "
          "each gradient's error against max(1, ||plain||) (norm) and max |plain|"})
    return lines


def train_kernels(torch, pkg, gen):
    fa = pkg["flash_attention"]
    # bf16 at d128 too: K5's and K6's wgmma kernels cut their tiles into
    # other chunks there (K6: 32 query rows)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 64), (torch.bfloat16, 128)):
        for n in (0.0, 1.0):
            _, errs, name = check_attention(
                torch, fa, gen, dtype, n=n, causal=True, shape=(2, 4, 200, 264, d),
                bias_shape=(1, 4), alibi=True, rate=0.25)
            emit({"phase": "kernel_check", "name": name, "errors": errs,
                  "repeat_bit_equal": True})
    check_dropout_masks(torch, fa)
    return train_kernel_lines(torch, pkg, gen)


# ----------------------------------------------------------------------------
# phase 5: serving at the TinyLlama-1.1B shape
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


SERVE_KERNELS = ("flash_fwd", "qmm_argmax", "cache_append", "tail_append")
PALLAS_KERNELS = ("qmm", "decode_attn", "fused_mlp")
# the port's kernels as torch.profiler names them (substrings)
PROFILED_KERNELS = (*FLASH_FWD_KERNELS, *QMM_ARGMAX_KERNELS,
                    *ROW_WRITE_KERNELS, *QMM_KERNELS, *DECODE_ATTN_KERNELS,
                    *FUSED_MLP_KERNELS)


# pairs for the paired idle share: an unprofiled run's synchronised wall,
# then at once an identical profiled run's device busy time
IDLE_PAIRS = 3
# The profiler adds a little device time of its own (the traced launches
# run slightly longer), so a run that leaves the card almost never idle can
# read a paired share just below 0; below -0.05 the pair is not one run's.
IDLE_FLOOR = -0.05
# a pair whose profiled busy time is further than this share from the
# median pair's is flagged: torch.profiler once read a whole training step
# on an H100 at half of every kernel's time, calls complete
BUSY_SPREAD = 0.1


def device_by_name(prof):
    """{kernel or copy name: (device ms, calls)} of a profiled window.
    Busy time is their sum (one stream, so they do not overlap); annotation
    ranges on the device timeline (such as ``Optimizer.step``) enclose
    kernels already counted and are left out."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    return by_name


def paired_idle_share(phase, pairs):
    """{median, min, max, values, busy_outliers} of 1 - busy_profiled /
    wall_unprofiled over (unprofiled wall s, profiled busy ms) pairs, each
    required in [IDLE_FLOOR, 1]. ``busy_outliers`` are the pairs whose busy
    time is more than BUSY_SPREAD from the median pair's: they stay in the
    values and are named on stderr, so a bad profiler window shows."""
    values = [1.0 - busy_ms / 1e3 / wall for wall, busy_ms in pairs]
    require(all(IDLE_FLOOR <= v <= 1.0 for v in values),
            f"{phase}: a paired idle share {values} is outside [{IDLE_FLOOR}, 1]")
    busy = [busy_ms for _, busy_ms in pairs]
    mid = float(np.median(busy))
    outliers = [i for i, b in enumerate(busy) if abs(b - mid) > BUSY_SPREAD * mid]
    if outliers:
        print(f"chip_smoke: {phase}: profiled busy ms {busy}: pairs {outliers} are more than "
              f"{BUSY_SPREAD:.0%} from the median", file=sys.stderr)
    return {"median": float(np.median(values)), "min": min(values), "max": max(values),
            "values": values, "busy_outliers": outliers}


def eager_engine(eng_mod):
    """The engine with capture turned off: every chunk runs eagerly, as
    before the loops were captured (the profile's comparison)."""

    class EagerEngine(eng_mod.InferenceEngine):
        def _capture(self, key):
            pass

    return EagerEngine


def prewarm_line(torch, eng, phase, attn_lens=(256,)):
    """``eng.prewarm`` as bench.py calls it: prints the variant count, the
    seconds and the bytes of the graphs' memory pool."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = eng.prewarm(loop_steps=64, attn_lens=list(attn_lens))
    torch.cuda.synchronize()
    line = {"phase": f"{phase}_prewarm", "variants": n,
            "seconds": time.perf_counter() - t0, "graphs": len(eng._graphs),
            "pool_bytes": graph_pool_bytes(torch, eng)}
    emit(line)
    require(n > 0 and len(eng._graphs) == n, f"{phase}: prewarm captured {len(eng._graphs)} "
            f"of {n} variants")
    return line


def graph_pool_bytes(torch, eng):
    """Bytes of the segments in the engine's graph memory pool
    (``torch.cuda.memory_snapshot``)."""
    pool = eng._graph_pool
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if pool is not None and tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def dequant_step_ms(torch, pkg, params, cfg):
    """Device ms of the default route's per-step weight dequantization: every
    int8 layer weight that ``_mm`` dequantizes (``x @ dequantize(w)``),
    once, as one decode step does."""
    dec, qtensor = pkg["decoder"], pkg["qtensor"]
    weights = [w for lp in dec.layer_views(params["layers"]) for w in lp.values()
               if isinstance(w, qtensor.QTensor)]

    def all_weights():
        for w in weights:
            qtensor.dequantize(w, cfg.dtype)

    return device_ms(torch, all_weights, None, runs=3)


def profile_chunk(torch, pkg, cfg, params, phase="profile", kv="int8"):
    """Where a fused chunk's time goes, eagerly and replayed as a CUDA graph:
    64 requests (64-token prompts) are admitted in 4 groups and decoded in
    one 16-step chunk. For each loop (the engine with capture off; the
    engine prewarmed), IDLE_PAIRS runs unprofiled for the wall time, each
    followed at once by the same run under ``torch.profiler`` for the
    device's busy time (the pair with the median busy time also for the
    kernels that fill it, ``breakdown_pair``). ``idle_share_paired`` is 1 -
    busy over the unprofiled wall just before, its median and spread;
    ``idle_share_profiled`` (against the profiled run's own wall, required
    in [0, 1]) and ``idle_share`` (the breakdown pair's) are kept as earlier
    runs reported them. A last run admits the same requests with a budget
    of one token (the same four prefill groups, no decode step), so that
    the 16 steps' own busy time and device ops are the difference. Each
    engine serves the requests once first, unmeasured: the graph engine's
    16-step variant runs eagerly then and is captured for the measured
    runs. The graph's breakdown must show the route's decode kernels (K2
    where the lm_head is int8, K4; K7, K8 and K9 on the all-kernel route)
    inside the replay."""
    from torch.profiler import ProfilerActivity, profile

    eng_mod = pkg["engine"]

    def make(cls):
        return cls(cfg, params, max_batch=64, max_len=512, kv_quantization=kv)

    def run(eng, budget):
        rng = np.random.RandomState(1)
        for _ in range(64):
            eng.submit(rng.randint(0, cfg.vocab_size, size=64).tolist(), max_new_tokens=budget)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run_until_done(loop_steps=64)
        torch.cuda.synchronize()
        require(len(done) == 64 and eng.counters_report().get("chunks", 0) == int(budget > 1),
                f"the profiled run (budget {budget}) did not serve its 64 requests in "
                f"{int(budget > 1)} chunk")
        return time.perf_counter() - t0

    def profiled(eng, budget):
        """(wall s, {kernel name: (device ms, calls)}) of one run; the
        device's activity only (the host's ops, about 4 events a kernel,
        cost seconds to collect and are not read)"""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall_profiled = run(eng, budget)
        return wall_profiled, device_by_name(prof)

    def port_kernels(by_name):
        """the port's own kernels, by device time alone (CUDA events around
        a wrapper also count its host dispatch)"""
        ours = {}
        for name, (ms, calls) in by_name.items():
            for kernel in PROFILED_KERNELS:
                if kernel in name:
                    prev_ms, prev_calls = ours.get(kernel, (0.0, 0))
                    ours[kernel] = (prev_ms + ms, prev_calls + calls)
        return {k: {"calls": c, "ms": ms, "ms_per_call": ms / c}
                for k, (ms, c) in sorted(ours.items())}

    eager, graph = make(eager_engine(eng_mod)), make(eng_mod.InferenceEngine)
    run(eager, 17)
    run(graph, 17)
    require(list(graph._graphs) == [(16, 256, False)],
            f"{phase}: the warm-up run captured {list(graph._graphs)}")
    _, by_name_admit = profiled(eager, 1)
    busy_admit_ms = sum(ms for ms, _ in by_name_admit.values())
    ops_admit = sum(c for _, c in by_name_admit.values())
    lines = {}
    for loop, eng in (("eager", eager), ("graph", graph)):
        runs = []
        for _ in range(IDLE_PAIRS):
            wall_unprofiled = run(eng, 17)
            runs.append((wall_unprofiled, *profiled(eng, 17)))
        # the breakdown from the pair with the median busy time, as
        # profile_step takes it: a profiler window can drop or stretch events
        busy_of = [sum(ms for ms, _ in names.values()) for _, _, names in runs]
        median_run = sorted(range(IDLE_PAIRS), key=busy_of.__getitem__)[IDLE_PAIRS // 2]
        wall, wall_profiled, by_name = runs[median_run]
        busy_ms = sum(ms for ms, _ in by_name.values())
        ops = sum(c for _, c in by_name.values())
        idle_profiled = 1.0 - busy_ms / 1e3 / wall_profiled
        paired = paired_idle_share(f"{phase}_{loop}",
                                   [(w, sum(ms for ms, _ in names.values()))
                                    for w, _, names in runs])
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        line = {"phase": phase if loop == "eager" else f"{phase}_graph", "loop": loop,
                "requests": 64, "steps": 16, "breakdown_pair": median_run,
                "wall_s": wall,
                "wall_s_profiled": wall_profiled,
                "device_busy_s": busy_ms / 1e3 if busy_ms else None,
                "idle_share_paired": paired,
                "idle_share_profiled": idle_profiled,
                "idle_share": 1.0 - busy_ms / 1e3 / wall if busy_ms else None,
                "pairs": [{"wall_s": w, "wall_s_profiled": wp,
                           "device_busy_s": sum(ms for ms, _ in names.values()) / 1e3}
                          for w, wp, names in runs],
                "device_ops": ops,
                "device_ops_per_step": (ops - ops_admit) / 16,
                "device_busy_admission_s": busy_admit_ms / 1e3,
                "decode_step_busy_ms": (busy_ms - busy_admit_ms) / 16,
                "port_kernels": port_kernels(by_name),
                "port_kernels_admission": port_kernels(by_name_admit),
                "top": [{"name": name[:90], "ms": ms, "calls": calls}
                        for name, (ms, calls) in top]}
        require(busy_ms > 0 and 0.0 <= idle_profiled <= 1.0,
                f"{phase}_{loop}: idle share {idle_profiled} against the profiled wall "
                f"{wall_profiled} s is outside [0, 1] (device busy {busy_ms} ms)")
        lines[loop] = line
    pallas = cfg.int8_mm_impl == "pallas" and cfg.decode_attn_impl == "pallas"
    if not pallas and kv == "int8":
        # the default route dequantizes every int8 layer weight each step
        dq = dequant_step_ms(torch, pkg, params, cfg)
        for line in lines.values():
            line["dequant_ms_per_step"] = dq
            line["dequant_share_of_decode_busy"] = dq / line["decode_step_busy_ms"]
    for line in lines.values():
        emit(line)
    # the replayed chunk ran the route's decode kernels: the graph run's
    # calls less the admission run's
    seen = lines["graph"]["port_kernels"]
    admit = lines["graph"]["port_kernels_admission"]
    decode_kernels = [ROW_WRITE_KERNELS]
    if kv == "int8":  # the int8 lm_head: K2; fp8 weights take no K2, K7, K9
        decode_kernels.append(QMM_ARGMAX_KERNELS)
        if pallas:
            decode_kernels += [QMM_KERNELS, FUSED_MLP_KERNELS]
    if pallas:
        decode_kernels.append(DECODE_ATTN_KERNELS)
    for names in decode_kernels:
        calls = sum(seen.get(k, {}).get("calls", 0) - admit.get(k, {}).get("calls", 0)
                    for k in names)
        require(calls > 0, f"{phase}_graph: the profiler saw no {names[0]} in the replayed chunk")


def serve_requests(rng, cfg, n):
    """n requests: prompts of 16-127 tokens, budgets 16-63 (bench.py)"""
    out = []
    for _ in range(n):
        plen, budget = int(rng.randint(16, 128)), int(rng.randint(16, 64))
        out.append((rng.randint(0, cfg.vocab_size, size=plen).tolist(), budget))
    return out


def check_served(done, budgets, cfg, what):
    require(all(len(r.output) == budgets[r.request_id] for r in done),
            f"{what}: a request did not emit exactly its budget")
    require(all(0 <= t < cfg.vocab_size for r in done for t in r.output),
            f"{what}: a token is outside the vocabulary")


def teacher_forced_gate(torch, pkg, cfg, params, reqs, phase, extra=None):
    """Each emitted token should be the argmax of a full-sequence forward on
    its own prefix, up to near-ties (held to >= 0.8 of the tokens), and never
    more than 0.5 below that forward's best logit (a wrong token sits ~4
    below)."""
    scored = [teacher_forced(torch, pkg, cfg, params, r) for r in reqs]
    n_checked = sum(len(r.output) for r in reqs)
    tf_agree = sum(s[0] for s in scored) / n_checked
    deficit = max(s[1] for s in scored)
    emit({"phase": phase, **(extra or {}),
          "teacher_forced_argmax_share": tf_agree, "argmax_threshold": 0.8,
          "teacher_forced_max_deficit": deficit, "deficit_threshold": 0.5,
          "tokens_teacher_forced": n_checked})
    require(tf_agree >= 0.8, f"{phase}: teacher-forced argmax share {tf_agree} < 0.8")
    require(deficit <= 0.5, f"{phase}: teacher-forced logit deficit {deficit} > 0.5")


def serve_fused(torch, pkg, cfg, params, phase, *, slots, requests, kv, seed):
    """bench.py's engine (bench.py:528-536: the default piggyback_prefill,
    prewarm(loop_steps=64, attn_lens=[256])) serves ``requests`` through
    ``slots`` slots, so the queued ones can be piggybacked; returns (the
    requests done in id order, the kernels' launches on the run). Requires
    every budget met and some prompt piggybacked."""
    eng_mod, build = pkg["engine"], pkg["build"]
    eng = eng_mod.InferenceEngine(cfg, params, max_batch=slots, max_len=512,
                                  kv_quantization=kv)
    prewarm = prewarm_line(torch, eng, phase)
    budgets = {}
    for prompt, budget in serve_requests(np.random.RandomState(seed), cfg, requests):
        budgets[eng.submit(prompt, max_new_tokens=budget)] = budget
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    done = sorted(eng.run_until_done(loop_steps=64), key=lambda r: r.request_id)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    n_tok = sum(len(r.output) for r in done)
    counters = eng.counters_report()
    require(len(done) == requests, f"{phase}: finished {len(done)} of {requests} requests")
    check_served(done, budgets, cfg, phase)
    emit({"phase": phase, "requests": len(done), "kv": kv, "tokens": n_tok,
          "wall_s": wall, "tokens_per_s": n_tok / wall, "launches": launches,
          "prewarm_s": prewarm["seconds"], "profile": eng.profile_report(),
          "counters": counters})
    require(counters.get("piggyback_prompts", 0) > 0,
            f"{phase}: no prompt was piggybacked (the phase lost its subject)")
    return done, launches


def serve_route(torch, pkg, cfg, params, prefix=""):
    """96 requests through the fused loop and 4 step by step on one route,
    with every gate; returns the kernels' launches on the two runs."""
    dec, eng_mod, build = pkg["decoder"], pkg["engine"], pkg["build"]
    phase = (prefix + "_") if prefix else ""
    # fused loop: 96 requests through 64 slots (bench.py)
    done, fused_launches = serve_fused(torch, pkg, cfg, params, f"{phase or 'serve_'}fused",
                                       slots=64, requests=96, kv="int8", seed=0)

    # step path: 4 requests decoded one step at a time (K3 writes the cache)
    step_eng = eng_mod.InferenceEngine(cfg, params, max_batch=4, max_len=512,
                                       kv_quantization="int8")
    first4 = done[:4]
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
    emit({"phase": f"{phase or 'serve_'}step", "requests": 4,
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
    # teacher-forced check, which does not cascade: the step path, the first
    # 8 of the classic admission, and every request that queued behind the
    # first 64 (the piggybacked ones among them, whose first token came from
    # the mixed step)
    teacher_forced_gate(torch, pkg, cfg, params, step_done + done[:8] + done[64:],
                        f"{phase}agreement",
                        {"greedy_generate_prefix_share": agree, "mean": mean_agree,
                         "threshold": 0.1})
    require(mean_agree >= 0.1, f"{phase}greedy_generate agreement {mean_agree} < 0.1")
    # the main path is both runs: the fused loop (K1, K2, K4) and the step
    # path (K1, K3), with K7-K9 on the pallas routes
    launches = {k: fused_launches[k] + step_launches[k] for k in fused_launches}
    pallas = cfg.int8_mm_impl == "pallas" and cfg.decode_attn_impl == "pallas"
    for name in SERVE_KERNELS + (PALLAS_KERNELS if pallas else ()):
        require(launches[name] > 0, f"the {prefix or 'serve'} runs never launched {name}")
    if not pallas:
        for name in PALLAS_KERNELS:
            require(launches[name] == 0, f"the default routes launched {name}")
    profile_chunk(torch, pkg, cfg, params, f"{phase}profile")
    return launches


def serve_mode(torch, pkg, cfg, params, mode, *, kv="int8", step_requests=0,
               launched=("flash_fwd", "qmm", "decode_attn", "tail_append"), idle=()):
    """12 requests through 8 slots of the fused loop (and the first
    ``step_requests`` of them again through the step path) with int4, W8A8
    or fp8 weights and a ``kv`` cache, on the pallas routes, held to
    budgets, vocabulary and the teacher-forced gate; every kernel in
    ``launched`` must launch on the runs and none in ``idle``. Returns the
    kernels' launches on the runs."""
    eng_mod, build = pkg["engine"], pkg["build"]
    done, launches = serve_fused(torch, pkg, cfg, params, f"serve_{mode}",
                                 slots=8, requests=12, kv=kv, seed=2)
    checked = list(done)
    if step_requests:
        # the step path: K3 writes each step's rows into the cache
        step_eng = eng_mod.InferenceEngine(cfg, params, max_batch=step_requests, max_len=512,
                                           kv_quantization=kv)
        for r in done[:step_requests]:
            step_eng.submit(r.prompt, max_new_tokens=len(r.output))
        build.reset_launches()
        t0 = time.perf_counter()
        step_done = sorted(step_eng.run_until_done(), key=lambda r: r.request_id)
        torch.cuda.synchronize()
        step_wall = time.perf_counter() - t0
        step_launches = dict(build.LAUNCHES)
        require(len(step_done) == step_requests and all(
            len(a.output) == len(b.output) for a, b in zip(step_done, done)),
            f"serve_{mode} step path did not finish its requests with their budgets")
        emit({"phase": f"serve_{mode}_step", "requests": step_requests,
              "tokens": sum(len(r.output) for r in step_done), "wall_s": step_wall,
              "launches": step_launches})
        launches = {k: launches[k] + step_launches[k] for k in launches}
        checked += step_done
    teacher_forced_gate(torch, pkg, cfg, params, checked, f"serve_{mode}_agreement")
    for name in launched:
        require(launches[name] > 0, f"serve_{mode} never launched {name}")
    for name in idle:
        require(launches[name] == 0, f"serve_{mode} launched {name}")
    if mode == "fp8":
        profile_chunk(torch, pkg, cfg, params, "serve_fp8_profile", kv=kv)
    return launches


def shallow(cfg, params, n_layers):
    """The first ``n_layers`` layers of ``params``, at the same widths."""
    from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor

    def cut(w):
        if isinstance(w, QTensor):
            return QTensor(w.values[:n_layers], w.scales[:n_layers], bits=w.bits,
                           packed_axis=w.packed_axis)
        return w[:n_layers]

    return (dataclasses.replace(cfg, n_layers=n_layers),
            dict(params, layers={k: cut(w) for k, w in params["layers"].items()}))


def graph_parity(torch, pkg, cfg, params, route, kv):
    """A captured loop replays bit-equal to the eager loop: 56 requests are
    admitted into the 64 slots and 8 more queue; then ``replay_parity``."""
    eng = pkg["engine"].InferenceEngine(cfg, params, max_batch=64, max_len=512,
                                        kv_quantization=kv)
    reqs = serve_requests(np.random.RandomState(3), cfg, 64)
    for prompt, budget in reqs[:56]:
        eng.submit(prompt, max_new_tokens=budget)
    eng._finalize_admission(eng._admit_async())
    for prompt, budget in reqs[56:]:
        eng.submit(prompt, max_new_tokens=budget)
    eng._active_mask()
    replay_parity(torch, pkg, eng, route, kv)


def replay_parity(torch, pkg, eng, route, kv, attn_len=256, chunk=64, extra=None):
    """On an engine with live slots and 8 short prompts queued: a plain
    ``chunk``-step chunk, a piggybacked 8-step chunk (the 8 queued prompts) and a
    plain 6-step chunk (no ring: K3 writes the cache each step) over the
    first ``attn_len`` cache rows each run eagerly from the engine's state,
    the state is put back, the variant is captured and replayed: tokens,
    first tokens and the cache's value, scale and length bytes must be
    equal, and the replay must count the eager run's launches. First,
    ``prewarm`` must leave that state bit-equal."""
    qtensor, build = pkg["qtensor"], pkg["build"]

    def state():
        return [qtensor.as_bytes(t).clone() for t in eng._state_tensors()]

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    start = state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = eng.prewarm(loop_steps=8, attn_lens=[attn_len])
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    prewarm_equal = equal(state(), start)
    del start
    chunks = []
    for key in ((chunk, attn_len, False), (8, attn_len, True), (6, attn_len, False)):
        if key[2]:
            piggy = eng._take_piggyback(key[0])
            require(piggy is not None and len(piggy["reqs"]) == 8,
                    f"graph_parity {route}/{kv}: the 8 queued prompts were not piggybacked")
            eng._load_piggyback(piggy)
        start = state()
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_out = [t.clone() for t in eng._loop(key)[::3]]  # tokens (and first tokens)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        eager_launches = {k: v - before[k] for k, v in build.LAUNCHES.items()}
        eager_state = state()
        for t, s in zip(eng._state_tensors(), start):
            qtensor.as_bytes(t).copy_(s)
        del start
        t0 = time.perf_counter()
        eng._capture(key)
        capture_s = time.perf_counter() - t0
        before = dict(build.LAUNCHES)
        replay_out = eng._greedy_loop(key)[::3]
        torch.cuda.synchronize()
        replay_launches = {k: v - before[k] for k, v in build.LAUNCHES.items()}
        chunks.append({"chunk": key[0], "attn_len": key[1], "piggy": key[2],
                       "eager_s": eager_s, "capture_s": capture_s,
                       "tokens_equal": equal(replay_out, eager_out),
                       "state_equal": equal(state(), eager_state),
                       "launches_equal": replay_launches == eager_launches,
                       "launches": {k: v for k, v in replay_launches.items() if v}})
        if key[2]:
            eng._undo_piggyback(piggy)
        del eager_state
    emit({"phase": "graph_parity", "route": route, "kv": kv, **(extra or {}),
          "prewarm_variants": n, "prewarm_s": prewarm_s, "prewarm_state_equal": prewarm_equal,
          "pool_bytes": graph_pool_bytes(torch, eng), "chunks": chunks})
    require(prewarm_equal, f"graph_parity {route}/{kv}: prewarm changed the engine's state")
    for c in chunks:
        require(c["tokens_equal"] and c["state_equal"] and c["launches_equal"],
                f"graph_parity {route}/{kv}: chunk {c['chunk']} (piggy {c['piggy']}) "
                f"replayed unlike the eager loop: {c}")


# bench.py's prefix pair (bench.py:636-693): a 256-token prefix drawn from
# RandomState(99) (:553-554, :653-654) on every even-numbered request
PREFIX_LEN = 256
PREFIX_SEED = 99


def admission_busy(torch, pkg, cfg, params, reqs, prefix):
    """(device busy ms, synchronised wall s) of one admission round of
    ``reqs`` into a fresh 64-slot engine (``prefix`` registered unless
    None): every request admitted in one ``_admit_async`` and its sync."""
    from torch.profiler import ProfilerActivity, profile

    eng = pkg["engine"].InferenceEngine(cfg, params, max_batch=64, max_len=512,
                                        kv_quantization="int8")
    if prefix is not None:
        eng.register_prefix(prefix)
    for prompt, budget in reqs:
        eng.submit(prompt, max_new_tokens=budget)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._finalize_admission(eng._admit_async())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    require(not eng.queue, "serve_prefix: the admission round left requests queued")
    return sum(ms for ms, _ in device_by_name(prof).values()), wall


def serve_prefix(torch, pkg, cfg, params):
    """bench.py's prefix pair on the default route (int8 weights and KV):
    64 requests (prompts 16-127, budgets 16-63; every even one behind a
    256-token prefix, so 272-383 tokens) through 64 slots of a prewarmed
    engine (``prewarm(loop_steps=64, attn_lens=[256, 512])``, bench.py's
    two windows), twice on the same engine: prefix cache off (the 32
    prefixed prompts take the chunked lane, chunks at offsets 0 and 256),
    then on after ``register_prefix`` (32 hits, each a copy of 256 stored
    rows and one chunk at offset 256). Held to every budget, the
    teacher-forced gate (every prefixed request of both runs and the first
    8 others of each), K1 launching in both runs, the store bit-equal to
    the rows a cold 1-slot engine writes for the same tokens through its
    chunked lane, and the loop's replays bit-equal over the inserted rows.
    Prints each run's tokens/s, counters, phases and launches, one
    admission round's device busy time off and on, and the share of
    requests whose outputs are equal in both runs. Returns the launches of
    both runs."""
    eng_mod, build, qtensor = pkg["engine"], pkg["build"], pkg["qtensor"]
    eng = eng_mod.InferenceEngine(cfg, params, max_batch=64, max_len=512,
                                  kv_quantization="int8")
    prewarm = prewarm_line(torch, eng, "serve_prefix", attn_lens=(256, 512))
    prefix = np.random.RandomState(PREFIX_SEED).randint(
        0, cfg.vocab_size, size=PREFIX_LEN).tolist()
    reqs = [(prefix + p if j % 2 == 0 else p, b)
            for j, (p, b) in enumerate(serve_requests(np.random.RandomState(4), cfg, 64))]
    prefixed = [j for j in range(64) if j % 2 == 0]
    others = [j for j in range(64) if j % 2][:8]

    def run(cache):
        budgets, ids = {}, []
        for prompt, budget in reqs:
            rid = eng.submit(prompt, max_new_tokens=budget)
            budgets[rid] = budget
            ids.append(rid)
        eng.counters_report()
        eng.profile_report()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        done = {r.request_id: r for r in eng.run_until_done(loop_steps=64)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        counters = eng.counters_report()
        done = [done[i] for i in ids]
        n_tok = sum(len(r.output) for r in done)
        check_served(done, budgets, cfg, f"serve_prefix_{cache}")
        emit({"phase": "serve_prefix", "cache": cache, "requests": len(done),
              "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
              "prefill_chunk_offsets": sorted(eng._prefill_chunks),
              "counters": {k: counters.get(k, 0) for k in (
                  "prefix_hits", "prefix_reused_tokens", "prefill_groups", "prefill_tokens",
                  "prefill_real_tokens", "piggyback_prompts", "chunks")},
              "profile": eng.profile_report(),
              "launches": {k: v for k, v in launches.items() if v}})
        require(launches["flash_fwd"] > 0, f"serve_prefix_{cache}: K1 never launched")
        return done, launches, counters

    off, off_launches, off_counters = run("off")
    require(PREFIX_LEN in eng._prefill_chunks,
            "serve_prefix_off: no chunk ran at offset 256 (the chunked lane lost its subject)")
    require(off_counters.get("prefix_hits", 0) == 0, "serve_prefix_off: a prefix hit "
            "with no prefix registered")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.register_prefix(prefix)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    on, on_launches, on_counters = run("on")
    require(on_counters.get("prefix_hits", 0) == 32
            and on_counters.get("prefix_reused_tokens", 0) == 32 * PREFIX_LEN,
            f"serve_prefix_on: {on_counters.get('prefix_hits')} hits reusing "
            f"{on_counters.get('prefix_reused_tokens')} tokens, not 32 and {32 * PREFIX_LEN}")
    teacher_forced_gate(torch, pkg, cfg, params,
                        [off[j] for j in prefixed + others] + [on[j] for j in prefixed + others],
                        "serve_prefix_agreement")

    # the store against a cold 1-slot engine's chunked lane over the same
    # tokens (one more token makes the prompt long enough for the lane)
    store = eng._prefixes[0]["store"]
    cold = eng_mod.InferenceEngine(cfg, params, max_batch=1, max_len=512,
                                   kv_quantization="int8")
    cold.submit(prefix + [1], max_new_tokens=1)
    cold.run_until_done()
    store_equal = {}
    for name in ("k", "v"):
        ref = cold.cache[name]
        store_equal[name] = (
            torch.equal(qtensor.as_bytes(store[name].values),
                        qtensor.as_bytes(ref.values[:, 0, :, :PREFIX_LEN]))
            and torch.equal(store[name].scales, ref.scales[:, 0, :, :PREFIX_LEN]))
    del cold

    # one admission round of the same requests, off and on, alternated
    admit = {"off": [], "on": []}
    for _ in range(IDLE_PAIRS):
        for cache in ("off", "on"):
            admit[cache].append(admission_busy(torch, pkg, cfg, params, reqs,
                                               prefix if cache == "on" else None))
    same = sum(a.output == b.output for a, b in zip(off, on))
    emit({"phase": "serve_prefix_summary", "prefix_tokens": PREFIX_LEN,
          "prewarm_s": prewarm["seconds"], "register_prefix_s": register_s,
          "store_bit_equal_to_cold_prefill": store_equal,
          "outputs_equal_share": same / len(off),
          "prefixed_outputs_equal_share": sum(off[j].output == on[j].output
                                              for j in prefixed) / len(prefixed),
          "admission_busy_ms": {c: [b for b, _ in v] for c, v in admit.items()},
          "admission_wall_s": {c: [w for _, w in v] for c, v in admit.items()},
          "admission_busy_ms_median": {c: float(np.median([b for b, _ in v]))
                                       for c, v in admit.items()}})
    require(all(store_equal.values()), f"serve_prefix: the store differs from a cold "
            f"1-slot chunked prefill of the same tokens: {store_equal}")

    # the captured loops over live slots whose rows came from the store: 56
    # requests admitted (28 hits), the 8 short ones of the stream queued
    for prompt, budget in reqs[:56]:
        eng.submit(prompt, max_new_tokens=budget)
    eng._finalize_admission(eng._admit_async())
    for j in range(57, 64, 2):
        eng.submit(*reqs[j])
    for prompt, budget in serve_requests(np.random.RandomState(5), cfg, 4):
        eng.submit(prompt, max_new_tokens=budget)
    eng._active_mask()
    hits = eng.counters_report().get("prefix_hits", 0)
    require(hits == 28, f"serve_prefix: {hits} of the 28 admitted prefixed requests hit")
    replay_parity(torch, pkg, eng, "default", "int8", attn_len=512, chunk=16,
                  extra={"prefix_hits": hits})
    launches = {k: off_launches[k] + on_launches[k] for k in off_launches}
    for name in ("flash_fwd", "qmm_argmax", "tail_append"):
        require(launches[name] > 0, f"serve_prefix never launched {name}")
    for name in PALLAS_KERNELS:
        require(launches[name] == 0, f"serve_prefix launched {name}")
    return launches


INT4_W8A8_LAYERS = 2


def serve(torch, pkg):
    """Both serving routes at the TinyLlama-1.1B shape, then int4 and W8A8,
    fp8, and the graphs' parity on three routes; returns each path's
    launches."""
    dec, weights = pkg["decoder"], pkg["weights"]
    # TinyLlama-1.1B shape (bench.py build_model): vocab 32000, d 2048,
    # 22 layers, 32 query / 4 KV heads, d_ff 5632
    cfg = dec.DecoderConfig(vocab_size=32000, d_model=2048, n_layers=22, n_heads=32,
                            n_kv_heads=4, d_ff=5632, max_seq_len=2048, softmax_n=1.0,
                            dtype=torch.bfloat16)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense = dec.init_decoder_params(cfg, gen, device="cuda")
    params = weights.quantize_decoder_weights(dense, bits=8)
    params4 = weights.quantize_decoder_weights(dense, bits=4)
    params_fp8 = weights.quantize_decoder_weights(dense, bits=-8)
    del dense
    torch.cuda.synchronize()
    emit({"phase": "weights", "seconds": time.perf_counter() - t0,
          "config": "TinyLlama-1.1B shape, random N(0, 1/fan_in) from seed 0, int8 "
                    "per-output-channel (grouped int4 for serve_int4, fp8 e4m3 for "
                    "serve_fp8)"})
    pallas = dataclasses.replace(cfg, int8_mm_impl="pallas", decode_attn_impl="pallas")
    launches = {"serve": serve_route(torch, pkg, cfg, params),
                "serve_pallas": serve_route(torch, pkg, pallas, params, "serve_pallas"),
                # K7's int4 and W8A8 modes at 2 of the 22 layers: each
                # engine's prewarm replays the whole model 480 steps
                "serve_int4": serve_mode(torch, pkg, *shallow(pallas, params4, INT4_W8A8_LAYERS),
                                         "int4"),
                "serve_w8a8": serve_mode(torch, pkg,
                                         *shallow(dataclasses.replace(pallas, act_bits=8),
                                                  params, INT4_W8A8_LAYERS), "w8a8"),
                # fp8 weights dequantize inline, as in JAX: K2, K7 and K9 stay idle
                "serve_fp8": serve_mode(torch, pkg, pallas, params_fp8, "fp8", kv="fp8",
                                        step_requests=2,
                                        launched=("flash_fwd", "decode_attn", "tail_append",
                                                  "cache_append"),
                                        idle=("qmm", "qmm_argmax", "fused_mlp")),
                "serve_prefix": serve_prefix(torch, pkg, cfg, params)}
    graph_parity(torch, pkg, cfg, params, "default", "int8")
    graph_parity(torch, pkg, pallas, params, "pallas", "int8")
    graph_parity(torch, pkg, pallas, params_fp8, "pallas", "fp8")
    return launches


# ----------------------------------------------------------------------------
# phase 6b: the prefill-phase profile
# ----------------------------------------------------------------------------


def prefill_phases(torch, pkg):
    """One run of the prefill-phase profile entry point at its headline
    shape; returns the kernels' launches on the run."""
    build = pkg["build"]
    torch.cuda.synchronize()
    build.reset_launches()
    lines = pkg["profile_prefill_phases"].run((2, 32, 2048, 64), iters=10)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for line in lines:
        emit({"phase": "prefill_phases", **line})
    for line in lines[1:]:
        require(np.isfinite(line["ms"]) and line["ms"] > 0,
                f"prefill_phases: {line['name']} has no time")
    for mode in pkg["prefill_phases"].MODES:
        require(launches[f"mini_{mode}"] > 0, f"prefill_phases never launched K10 {mode}")
    require(launches["flash_fwd"] > 0, "prefill_phases never launched K1")
    return launches


# ----------------------------------------------------------------------------
# phases 7-8: training at the TinyLlama-1.1B width
# ----------------------------------------------------------------------------

TINYLLAMA = dict(vocab_size=32000, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
                 max_seq_len=2048, softmax_n=1.0)
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def train_agreement(torch, pkg):
    """Every parameter gradient of causal_lm_loss at the TinyLlama-1.1B width
    (2 layers, f32, B2 L1024, no dropout) through the fused route (K1, K5,
    K6) against the same through plain tensor ops: relative L2 error at most
    1e-3, the f32-on-GPU tolerance of BASELINE.md."""
    dec, tr, build = pkg["decoder"], pkg["train"], pkg["build"]
    kw = dict(TINYLLAMA, n_layers=2, dtype=torch.float32)
    params = dec.init_decoder_params(dec.DecoderConfig(**kw), 1, device="cuda")
    named = leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    tokens = torch.from_numpy(
        np.random.RandomState(1).randint(0, kw["vocab_size"], size=(2, 1024))).cuda()
    grads, losses, launches = {}, {}, {}
    for impl in ("pallas", "xla"):
        cfg = dec.DecoderConfig(**kw, attn_implementation=impl)
        build.reset_launches()
        loss = tr.causal_lm_loss(params, cfg, tokens)
        grads[impl] = torch.autograd.grad(loss, [p for _, p in named])
        torch.cuda.synchronize()
        launches[impl] = {k: build.LAUNCHES[k] for k in TRAIN_KERNELS}
        losses[impl] = loss.item()
    errs = {path: float(torch.linalg.vector_norm((a - b).float())
                        / torch.linalg.vector_norm(b.float()))
            for (path, _), a, b in zip(named, grads["pallas"], grads["xla"])}
    worst = max(errs.values())
    emit({"phase": "train_agreement", "config": "TinyLlama-1.1B width, 2 layers, f32, B2 L1024",
          "card": pkg["nvidia_smi"],
          "loss": losses, "rel_l2_err": errs, "max_rel_l2_err": worst, "tolerance": 1e-3,
          "launches": launches})
    require(worst <= 1e-3, f"fused-route gradients differ from plain ops: {worst} > 1e-3")
    require(all(launches["pallas"][k] > 0 for k in TRAIN_KERNELS),
            f"the fused route did not launch every training kernel: {launches['pallas']}")
    require(all(v == 0 for v in launches["xla"].values()), "the xla route launched a kernel")


def profile_step(torch, step_fn, wall_s):
    """Training steps under torch.profiler: IDLE_PAIRS times an unprofiled
    step's synchronised wall, then at once a profiled step's device busy
    time (kernel and copy times on one stream, annotation ranges left out);
    ``idle_share_paired`` is 1 - busy over the wall just before, its median
    and spread. The profiled step with the median busy time also gives the
    kernels that fill it, ``idle_share_profiled`` (against its own wall,
    required in [0, 1]) and, as earlier runs reported it, ``idle_share``
    against ``wall_s`` (the median unprofiled step of the training run).
    A pair whose busy time is far from the others is flagged in
    ``idle_share_paired["busy_outliers"]`` (see BUSY_SPREAD)."""
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    runs = []
    for _ in range(IDLE_PAIRS):
        wall_unprofiled = timed()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_profiled = timed()
        runs.append((wall_unprofiled, wall_profiled, device_by_name(prof)))
    busy = [sum(ms for ms, _ in names.values()) for _, _, names in runs]
    median_run = sorted(range(IDLE_PAIRS), key=busy.__getitem__)[IDLE_PAIRS // 2]
    _, wall_profiled, by_name = runs[median_run]
    busy_ms = busy[median_run]
    paired = paired_idle_share("train_profile",
                               [(w, sum(ms for ms, _ in names.values()))
                                for w, _, names in runs])
    ours = {}
    for name, (ms, calls) in by_name.items():
        for kernel in (*FLASH_FWD_KERNELS, *FLASH_DQ_KERNELS, *FLASH_DKV_KERNELS):
            if kernel in name:
                prev_ms, prev_calls = ours.get(kernel, (0.0, 0))
                ours[kernel] = (prev_ms + ms, prev_calls + calls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    idle_profiled = 1.0 - busy_ms / 1e3 / wall_profiled
    emit({"phase": "train_profile", "breakdown_pair": median_run,
          "wall_s_profiled": wall_profiled,
          "wall_s_unprofiled": wall_s,
          "device_busy_s": busy_ms / 1e3 if busy_ms else None,
          "idle_share_paired": paired,
          "idle_share_profiled": idle_profiled,
          "idle_share": 1.0 - busy_ms / 1e3 / wall_s if busy_ms else None,
          "pairs": [{"wall_s": w, "wall_s_profiled": wp,
                     "device_busy_s": sum(ms for ms, _ in names.values()) / 1e3}
                    for w, wp, names in runs],
          "device_ops": sum(c for _, c in by_name.values()),
          "port_kernels": {k: {"calls": c, "ms": ms, "ms_per_call": ms / c}
                           for k, (ms, c) in sorted(ours.items())},
          "top": [{"name": name[:90], "ms": ms, "calls": calls}
                  for name, (ms, calls) in top]})
    require(busy_ms > 0 and 0.0 <= idle_profiled <= 1.0,
            f"train_profile: idle share {idle_profiled} against the profiled wall "
            f"{wall_profiled} s is outside [0, 1] (device busy {busy_ms} ms)")


def train(torch, pkg):
    """4 AdamW steps (lr 3e-4) at the full TinyLlama-1.1B shape: 22 layers,
    bf16, n = 1, attention dropout 0.1, remat, one B2 x L2048 batch from
    numpy.random.RandomState(0), random weights from seed 0."""
    dec, tr, build = pkg["decoder"], pkg["train"], pkg["build"]
    cfg = dec.DecoderConfig(**TINYLLAMA, n_layers=22, dtype=torch.bfloat16, attn_dropout=0.1,
                            remat=True)
    init, step = tr.make_train_step(cfg, learning_rate=3e-4)
    params, opt = init(dec.init_decoder_params(cfg, 0, device="cuda"))
    b, l = 2, 2048
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, size=(b, l))).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, walls = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, generator=gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = {k: build.LAUNCHES[k] for k in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    grad_ok = {path: bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().max()) > 0
               for path, p in leaves(params)}
    emit({"phase": "train", "config": "TinyLlama-1.1B shape, 22 layers, bf16, n 1, "
                                      "attn_dropout 0.1, remat, AdamW lr 3e-4, B2 L2048",
          "card": pkg["nvidia_smi"],
          "losses": losses, "step_wall_s": walls,
          "tokens_per_s": [b * l / w for w in walls], "max_memory_allocated": peak,
          "launches": launches,
          "launches_expected": {"flash_fwd": 44 * 4, "flash_bwd_dq": 22 * 4,
                                "flash_bwd_dkv": 22 * 4},
          "grads_finite_nonzero": all(grad_ok.values())})
    require(all(np.isfinite(losses)), f"a training loss is not finite: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall over 4 steps: {losses}")
    require(all(grad_ok.values()),
            f"gradients not finite or all zero: {[k for k, v in grad_ok.items() if not v]}")
    for name, count in launches.items():
        require(count > 0, f"the training run never launched {name}")
    profile_step(torch, lambda: step(params, opt, tokens, generator=gen),
                 float(np.median(walls[1:])))
    return launches


# ----------------------------------------------------------------------------
# phase 9: analysis at the TinyLlama-1.1B shape
# ----------------------------------------------------------------------------

ANALYSIS_BATCHES = 4


class Since:
    """Each call: the launches of every kernel since the last call."""

    def __init__(self, build):
        self.build, self.last = build, dict(build.LAUNCHES)

    def __call__(self):
        now = dict(self.build.LAUNCHES)
        out = {k: now[k] - self.last[k] for k in now}
        self.last = now
        return out


def finite_stats(d) -> bool:
    return all(np.isfinite(v) for entry in d.values() for k, v in entry.items()
               if k != "n_samples")


def gate_counts(report):
    """how many taps or weights pass at each bit width"""
    return {k: sum(e[k] for e in report.values()) for k in ("int8_ok", "int4_ok", "fp8_ok")}


def analysis(torch, pkg):
    """The analysis path at the TinyLlama-1.1B shape (22 layers, bf16, n 1,
    the serving phases' weights from seed 0): the decoder's taps streamed
    through ``register_activation_hooks`` over four B4 x L512 batches,
    ``delta_perplexity`` of int8 weights on the default and the all-kernel
    routes, ``output_attentions`` against the K1 path, and weight statistics
    and gate reports; returns the kernels' launches on the path."""
    dec, weights, build, an = pkg["decoder"], pkg["weights"], pkg["build"], pkg["analysis"]
    gates = pkg["gates"]
    cfg = dec.DecoderConfig(**TINYLLAMA, n_layers=22, dtype=torch.bfloat16)
    dense = dec.init_decoder_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                    device="cuda")
    int8 = weights.quantize_decoder_weights(dense, bits=8)
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(4, 512))).cuda()
               for _ in range(ANALYSIS_BATCHES)]
    names = [f"layers.{i}.attention.output" for i in range(cfg.n_layers)]
    torch.cuda.synchronize()
    build.reset_launches()
    since = Since(build)

    # taps, streamed: K1 22 times a forward
    def apply_fn(tokens):
        return dec.decoder_forward(dense, cfg, tokens, collect_taps=True)

    hooked, stats = an.register_activation_hooks(apply_fn, names)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for tokens in batches:
            _, stats = hooked(stats, tokens)
    act = an.activation_stats_to_dict(stats)
    taps_s = time.perf_counter() - t0
    taps_launches = since()
    act_report = gates.gate_report(act)
    emit({"phase": "analysis_taps", "config": "TinyLlama-1.1B shape, 22 layers, bf16, n 1",
          "batches": ANALYSIS_BATCHES, "batch": [4, 512], "seconds": taps_s,
          "taps": len(act), "n_samples": sorted({e["n_samples"] for e in act.values()}),
          "kurtosis_max": max(e["kurtosis"] for e in act.values()),
          "kurtosis_min": min(e["kurtosis"] for e in act.values()),
          "gate_pass": gate_counts(act_report), "launches": taps_launches})
    require(len(act) == cfg.n_layers and all(e["n_samples"] == 4 * ANALYSIS_BATCHES
                                             for e in act.values()),
            f"analysis: {len(act)} taps, n_samples {[e['n_samples'] for e in act.values()]}")
    require(finite_stats(act), "analysis: a tap's statistic is not finite")
    require(taps_launches["flash_fwd"] == cfg.n_layers * ANALYSIS_BATCHES,
            f"analysis: K1 launched {taps_launches['flash_fwd']} times over "
            f"{ANALYSIS_BATCHES} forwards of {cfg.n_layers} layers")

    # delta perplexity of int8 weights, on the default and all-kernel routes
    pallas = dataclasses.replace(cfg, int8_mm_impl="pallas")
    for route, rcfg in (("default", cfg), ("pallas", pallas)):
        t0 = time.perf_counter()
        out = an.delta_perplexity(dense, int8, rcfg, batches)
        seconds = time.perf_counter() - t0
        route_launches = since()
        emit({"phase": "analysis_perplexity", "route": route, **out, "seconds": seconds,
              "tokens": ANALYSIS_BATCHES * 4 * 512, "launches": route_launches})
        require(all(np.isfinite(out[k]) and out[k] > 1.0 for k in ("ppl_dense", "ppl_quant")),
                f"analysis_perplexity {route}: perplexities {out}")
        require(abs(out["relative"]) < 0.05,
                f"analysis_perplexity {route}: |relative| {abs(out['relative'])} >= 0.05")
        # two passes (dense, int8) of every batch; K7 on the pallas route
        # only: 7 matmuls a layer and the lm_head for each int8 forward
        require(route_launches["flash_fwd"] == 2 * cfg.n_layers * ANALYSIS_BATCHES,
                f"analysis_perplexity {route}: K1 launched {route_launches['flash_fwd']} times")
        want_qmm = (7 * cfg.n_layers + 1) * ANALYSIS_BATCHES if route == "pallas" else 0
        require(route_launches["qmm"] == want_qmm,
                f"analysis_perplexity {route}: K7 launched {route_launches['qmm']} times, "
                f"not {want_qmm}")

    # output_attentions at B1 L512 against the K1 path's logits
    tokens = batches[0][:1]
    with torch.inference_mode():
        logits, probs = dec.decoder_forward(dense, cfg, tokens, output_attentions=True)
        materialized_k1 = since()["flash_fwd"]
        k1 = dec.decoder_forward(dense, cfg, tokens)
    rel = float(torch.linalg.vector_norm(logits - k1) / torch.linalg.vector_norm(k1))
    summary = an.summarize_attention(probs)
    null_mean, null_max = summary["null_mass_mean"], summary["null_mass_max"]
    null_min = float(an.null_attention_mass(probs).min())
    emit({"phase": "analysis_attentions", "shape": list(probs.shape),
          "logits_rel_l2_vs_k1": rel, "tolerance": 5e-2,
          "null_mass_mean": float(null_mean.mean()), "null_mass_max": float(null_max.max()),
          "null_mass_min": null_min, "entropy_mean": float(summary["entropy_mean"].mean()),
          "k1_launches_materialized": materialized_k1})
    require(rel < 5e-2, f"analysis_attentions: logits relative L2 {rel} vs K1's >= 5e-2")
    require(null_min >= -1e-6 and float(null_max.max()) <= 1.0 + 1e-6,
            f"analysis_attentions: null mass outside [0, 1]: min {null_min}, "
            f"max {float(null_max.max())}")
    require(float(null_max.max()) > 0.0, "analysis_attentions: no null mass at n = 1")
    require(materialized_k1 == 0, "analysis_attentions: output_attentions launched K1")
    del probs

    # weight statistics and the gates
    t0 = time.perf_counter()
    w_dense = an.compute_weight_statistics(dense)
    w_int8 = an.compute_weight_statistics(int8)
    emit({"phase": "analysis_weights", "seconds": time.perf_counter() - t0,
          "dense_leaves": len(w_dense), "int8_leaves": len(w_int8),
          "activation_gate": gate_counts(act_report), "activation_taps": len(act_report),
          "weight_gate": gate_counts(gates.gate_report(w_dense, target="weights")),
          "weight_gate_int8_tree": gate_counts(gates.gate_report(w_int8, target="weights")),
          "weight_leaves": len(w_dense)})
    require(finite_stats({k: v for k, v in w_dense.items() if "norm" not in k}),
            "analysis_weights: a dense weight statistic is not finite")
    require("layers/wq/0" in w_int8 and "layers/wq/1" in w_int8,
            f"analysis_weights: QTensor leaves are not named <path>/0 and <path>/1: "
            f"{sorted(w_int8)[:6]}")
    del dense, int8
    torch.cuda.synchronize()
    return dict(build.LAUNCHES)


# ----------------------------------------------------------------------------
# phase 10: surgery at BERT-base and XLNet-base widths
# ----------------------------------------------------------------------------

# HF google-bert/bert-base-uncased config.json
BERT_BASE = dict(model_type="bert", vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, layer_norm_eps=1e-12, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, position_embedding_type="absolute",
                 is_decoder=False, add_cross_attention=False)
# HF xlnet/xlnet-base-cased config.json; mem_len 256 is this run's setting
XLNET_BASE = dict(model_type="xlnet", vocab_size=32000, d_model=768, n_layer=12, n_head=12,
                  d_head=64, d_inner=3072, ff_activation="gelu", attn_type="bi",
                  bi_data=False, clamp_len=-1, same_length=False, mem_len=256,
                  reuse_len=None, layer_norm_eps=1e-12, dropout=0.1)


def rel_max_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def surgery_bert(torch, pkg):
    bert, an, gates, qt = pkg["bert"], pkg["analysis"], pkg["gates"], pkg["qtensor"]
    build, weights = pkg["build"], pkg["weights"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    cfg, params = pkg["surgery"].from_pretrained_hf(
        pkg["standin"].standin(BERT_BASE, gen, "cuda"), softmax_n_param=1.0)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    require(cfg.softmax_n == 1.0 and cfg.dtype == torch.float32
            and params["layers"]["q_w"].is_cuda, f"surgery_bert: {cfg}")
    rng = np.random.RandomState(0)
    B, L = 8, 512

    def batch():
        ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(B, L))).cuda()
        lens = torch.from_numpy(rng.randint(128, L + 1, size=(B,))).cuda()
        mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None]).long()
        return ids, mask

    names = [f"encoder.layer.{i}.attention.output" for i in range(cfg.n_layers)]

    def apply_fn(ids, mask):
        return bert.bert_forward(params, cfg, ids, mask, collect_taps=True)

    hooked, stats = an.register_activation_hooks(apply_fn, names)
    batches = [batch() for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for ids, mask in batches:
            out, stats = hooked(stats, ids, mask)
    act = an.activation_stats_to_dict(stats)
    taps_s = time.perf_counter() - t0
    report = gates.gate_report(act)
    ids, mask = batches[0]
    with torch.inference_mode():
        dense = bert.bert_forward(params, cfg, ids, mask)["last_hidden_state"]
        int8 = bert.bert_forward(weights.quantize_bert_weights(params, bits=8), cfg, ids,
                                 mask)["last_hidden_state"]
        p4 = weights.quantize_bert_weights(params, bits=4)
        deq = dict(p4, layers={k: qt.dequantize(v) if isinstance(v, qt.QTensor) else v
                               for k, v in p4["layers"].items()})
        torch.cuda.synchronize()
        since = Since(build)
        t0 = time.perf_counter()
        int4 = bert.bert_forward(p4, cfg, ids, mask)["last_hidden_state"]
        torch.cuda.synchronize()
        int4_s = time.perf_counter() - t0
        int4_launches = since()
        t0 = time.perf_counter()
        int4_deq = bert.bert_forward(deq, cfg, ids, mask)["last_hidden_state"]
        torch.cuda.synchronize()
        deq_s = time.perf_counter() - t0
    require(sum(since().values()) == 0, "surgery_bert: the dequantized tree launched a kernel")
    err8, err4 = rel_max_err(int8, dense), rel_max_err(int4, int4_deq)
    emit({"phase": "surgery_bert", "config": "google-bert/bert-base-uncased widths, random "
          "N(0, 0.02) from seed 0, softmax-1 surgery, f32", "convert_s": convert_s,
          "batch": [B, L], "padded_lengths": [int(m.sum()) for m in mask],
          "taps": len(act), "taps_s": taps_s,
          "n_samples": sorted({e["n_samples"] for e in act.values()}),
          "gate_pass": gate_counts(report), "taps_gated": len(report),
          "int8_rel_max_err_vs_dense": err8, "int8_tolerance": 0.05,
          "int4_rel_max_err_vs_dequantized": err4, "int4_tolerance": 1e-3,
          "int4_forward_s": int4_s, "dequantized_forward_s": deq_s,
          "int4_launches": int4_launches, "card": pkg["nvidia_smi"]})
    require(len(act) == cfg.n_layers and finite_stats(act)
            and all(e["n_samples"] == 2 * B for e in act.values()),
            f"surgery_bert: taps {len(act)}, finite {finite_stats(act)}")
    require(bool(torch.isfinite(dense).all()), "surgery_bert: dense output not finite")
    require(err8 < 0.05, f"surgery_bert: int8 relative max error {err8} >= 0.05")
    require(int4_launches["qmm"] == 6 * cfg.n_layers,
            f"surgery_bert: int4 forward launched K7 {int4_launches['qmm']} times, not "
            f"{6 * cfg.n_layers}")
    require(err4 < 1e-3, f"surgery_bert: int4 against its dequantized tree {err4} >= 1e-3")

    # output_attentions at B2 L512: padded keys get probability 0
    with torch.inference_mode():
        out = bert.bert_forward(params, cfg, ids[:2], mask[:2], output_attentions=True)
    probs = out["attentions"]  # (n_layers, B, H, L, S)
    pad = mask[:2] == 0
    pad_mass = float((probs * pad[None, :, None, None, :]).amax())
    summary = an.summarize_attention(probs)
    emit({"phase": "surgery_bert_attentions", "shape": list(probs.shape),
          "padded_key_prob_max": pad_mass, "padded_keys": int(pad.sum()),
          "null_mass_mean": float(summary["null_mass_mean"].mean()),
          "null_mass_max": float(summary["null_mass_max"].max())})
    require(pad_mass == 0.0, f"surgery_bert: a padded key has probability {pad_mass}")
    require(float(summary["null_mass_max"].max()) > 0.0, "surgery_bert: no null mass at n = 1")


def surgery_xlnet(torch, pkg):
    xlnet, an, gates = pkg["xlnet"], pkg["analysis"], pkg["gates"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    cfg, params = pkg["surgery"].from_pretrained_hf(
        pkg["standin"].standin(XLNET_BASE, gen, "cuda"), softmax_n_param=1.0)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    require(cfg.softmax_n == 1.0 and cfg.mem_len == 256, f"surgery_xlnet: {cfg}")
    rng = np.random.RandomState(1)
    B, L = 4, 256
    segs = [torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(B, L))).cuda()
            for _ in range(2)]
    names = [f"layer.{i}.rel_attn.output" for i in range(cfg.n_layers)]
    mems = None

    def apply_fn(ids, mems):
        out, taps = xlnet.xlnet_forward(params, cfg, ids, mems=mems, use_mems=True,
                                        collect_taps=True)
        return out, taps

    hooked, stats = an.register_activation_hooks(apply_fn, names, names)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        outs = []
        for ids in segs:
            out, stats = hooked(stats, ids, mems)
            mems = out["mems"]
            outs.append(out["last_hidden_state"])
        attn = xlnet.xlnet_forward(params, cfg, segs[1], mems=mems, output_attentions=True)
    act = an.activation_stats_to_dict(stats)
    seconds = time.perf_counter() - t0
    summary = an.summarize_attention(attn["attentions"])
    emit({"phase": "surgery_xlnet", "config": "xlnet/xlnet-base-cased widths, random "
          "N(0, 0.02) from seed 1, softmax-1 surgery, f32, mem_len 256",
          "convert_s": convert_s, "segments": 2, "batch": [B, L], "seconds": seconds,
          "mems_shape": list(mems.shape), "taps": len(act),
          "gate_pass": gate_counts(gates.gate_report(act)),
          "attentions_shape": list(attn["attentions"].shape),
          "null_mass_mean": float(summary["null_mass_mean"].mean()),
          "null_mass_max": float(summary["null_mass_max"].max())})
    require(all(bool(torch.isfinite(o).all()) for o in outs)
            and bool(torch.isfinite(mems).all()), "surgery_xlnet: outputs not finite")
    require(tuple(mems.shape) == (cfg.n_layers, 256, B, cfg.d_model),
            f"surgery_xlnet: mems of shape {tuple(mems.shape)}")
    require(len(act) == cfg.n_layers and finite_stats(act)
            and all(e["n_samples"] == 2 * B for e in act.values()),
            f"surgery_xlnet: taps {len(act)}, finite {finite_stats(act)}")
    require(float(summary["null_mass_max"].max()) > 0.0, "surgery_xlnet: no null mass at n = 1")


def surgery(torch, pkg):
    """BERT-base and XLNet-base through ``from_pretrained_hf`` from stand-in
    HF models on the card; returns the kernels' launches on the path (K7's
    f32 int4 mode on BERT's int4 forward)."""
    build = pkg["build"]
    torch.cuda.synchronize()
    build.reset_launches()
    surgery_bert(torch, pkg)
    surgery_xlnet(torch, pkg)
    torch.cuda.synchronize()
    return dict(build.LAUNCHES)


# ----------------------------------------------------------------------------
# phase 11: ring attention over p = 4 sequence shards in one process
# ----------------------------------------------------------------------------

RING = dict(B=1, H=32, KVH=4, L=8192, D=64, P=4, n=1.0)
RING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def ring_schedule(torch, ra, qs, ks, vs, dos, *, n, scale, backward=True):
    """Every rank's ring schedule, block by block, through the package's
    per-rank step functions (what ``ring_attention_n`` runs on each rank,
    with the rotation replaced by indexing the owner's shard): (outs, lses)
    per query shard, then (dq, dk, dv) per shard, the accumulators summed
    into their block's owner as the rotating ones arrive there."""
    p = len(qs)
    outs, lses = [], []
    for my in range(p):
        state = ra.ring_init(qs[my], vs[my])
        for t in range(p):
            owner = (my - t) % p
            state = ra.ring_fold(state, ra.ring_block_forward(
                qs[my], ks[owner], vs[owner], mode=ra.block_mode(True, p, my, t),
                scale=scale, implementation="pallas"))
        o, lse = ra.ring_finish(state, n, qs[my].dtype)
        outs.append(o)
        lses.append(lse)
    if not backward:
        return outs, lses, None
    dq = [torch.zeros_like(x, dtype=torch.float32) for x in qs]
    dk = [torch.zeros_like(x, dtype=torch.float32) for x in ks]
    dv = [torch.zeros_like(x, dtype=torch.float32) for x in vs]
    for my in range(p):
        delta = torch.sum(dos[my].float() * outs[my].float(), dim=-1)
        for t in range(p):
            owner = (my - t) % p
            g = ra.ring_block_backward(qs[my], ks[owner], vs[owner], outs[my], dos[my],
                                       lses[my], delta, mode=ra.block_mode(True, p, my, t),
                                       scale=scale, implementation="pallas")
            if g is not None:
                dq[my] += g[0]
                dk[owner] += g[1]
                dv[owner] += g[2]
    return outs, lses, (dq, dk, dv)


def ring_block_lines(torch, pkg, q, blocks, do, out, lse, *, launches, library):
    """K1 at n = 0 with its lse on a visiting block, full and causal
    (``blocks``: mode -> (k, v) repeated to q's heads), and K5/K6 against
    the ring's global lse on the full block: each against its plain version
    on the same block, timed beside its bound, the plain version and the
    library's whole-ring call."""
    fa, ops = pkg["flash_attention"], pkg["build"].ops()
    # the operators alone take contiguous tensors; a shard is a view
    q, do = q.contiguous(), do.contiguous()
    B, H, Lb, D = q.shape
    scale = D ** -0.5
    bhld, bhl = B * H * Lb * D, B * H * Lb
    ex = {"bias": None, "slopes": None, "seed": None, "dropout_rate": 0.0}
    lines = []
    for causal in (False, True):
        kr, vr = blocks["causal" if causal else "full"]
        pairs = B * H * (Lb * (Lb + 1) / 2 if causal else Lb * Lb)
        o, lse_b = run_fwd(fa, False, q, kr, vr, ex, n=0.0, causal=causal)
        o_ref, lse_ref = run_fwd(fa, True, q, kr, vr, ex, n=0.0, causal=causal)
        o64, o_abs64 = fwd_float64(torch, fa, q, kr, vr, ex, n=0.0, causal=causal)
        errs = {"o": float((o.float() - o_ref.float()).abs().max()),
                "o_excess": o_excess(o, o64, o_abs64),
                "o_excess_plain": o_excess(o_ref, o64, o_abs64),
                "lse": float((lse_b - lse_ref).abs().max())}
        del o64, o_abs64
        name = f"flash_fwd ring block B{B} H{H} L{Lb} S{Lb} d{D} bf16 n0 " \
               f"{'causal' if causal else 'full'} +lse"
        require(errs["o_excess"] <= 0.0 and errs["o_excess_plain"] <= 0.0
                and errs["lse"] <= 1e-3, f"K1 {name}: off the float64 evaluation or the "
                                         f"plain version: {errs}")

        def k1(causal=causal, kr=kr, vr=vr):
            return run_fwd(fa, False, q, kr, vr, ex, n=0.0, causal=causal)

        def plain(causal=causal, kr=kr, vr=vr):
            return run_fwd(fa, True, q, kr, vr, ex, n=0.0, causal=causal)

        b_ms, b_by = bound_ms(4 * bhld * 2 + bhl * 4, 4.0 * D * pairs)
        dev_ms = device_ms(torch, k1, FLASH_FWD_KERNELS)
        lines.append({"name": name, "route": "cuda", "source": f"{CSRC}/flash_fwd.cu",
                      "replaces": f"{FLASH_PY}:345 _fwd_single_kernel, :279 _fwd_kernel, "
                                  ":501 _fwd_pipeline_kernel (n = 0, lse out)",
                      "counter": "flash_fwd", "path": "ring", "errors": errs,
                      "max_abs_err": errs["o"], "max_abs_err_lse": errs["lse"],
                      "tolerance": "o: 2^-8 |o64| + (2^-8 + 2^-11) (p|v|)64 of a float64 "
                                   "evaluation, K1 and plain each; lse 1e-3",
                      "ms": time_ms(torch, k1), "device_ms": dev_ms,
                      "tflops": tflops(4.0 * D * pairs, dev_ms), "plain_ms": time_ms(torch, plain),
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": library["fwd"],
                      "library": "SDPA forward over the whole ring (L8192, one zero key)",
                      "launches_per_ring": launches["fwd"]})

    # K5/K6 on the full block against the ring's global lse and out
    kr, vr = blocks["full"]
    pairs = B * H * Lb * Lb
    delta = torch.sum(do.float() * out.float(), dim=-1)
    got = fa.flash_bwd(q, kr, vr, None, None, None, out, lse, do, scale=scale,
                       is_causal=False, delta=delta)[:3]
    want = fa.flash_bwd_reference(q, kr, vr, None, None, None, out, lse, do, scale=scale,
                                  is_causal=False, delta=delta)[:3]
    torch.cuda.synchronize()
    norm = {k_: norm_err(g, w) for k_, g, w in zip(("dq", "dk", "dv"), got, want)}
    rel = {k_: rel_err(g, w) for k_, g, w in zip(("dq", "dk", "dv"), got, want)}
    name = f"B{B} H{H} L{Lb} S{Lb} d{D} bf16 full, global lse"
    require(max(rel.values()) <= 2e-2 and max(norm.values()) <= BWD_NORM_TOL["bf16"],
            f"K5/K6 ring block {name}: off the plain version: rel {rel}, norm {norm}")
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(kr), torch.empty_like(vr)

    def k5():
        ops.flash_bwd_dq(q, kr, vr, None, None, None, do, lse, delta, dq, None, None,
                         scale_q, scale, False, 0, 1.0)

    def k6():
        ops.flash_bwd_dkv(q, kr, vr, None, None, None, do, lse, delta, dk, dv, scale_q,
                          False, 0, 1.0)

    def block_grads():
        return fa.flash_attention_block_grads(q, kr, vr, out, lse, do, scale=scale,
                                              delta=delta)

    def plain_bwd():
        return fa.flash_bwd_reference(q, kr, vr, None, None, None, out, lse, do,
                                      scale=scale, is_causal=False, delta=delta)

    k5_dev, k6_dev = device_ms_of(torch, [(block_grads, FLASH_DQ_KERNELS),
                                          (block_grads, FLASH_DKV_KERNELS)])
    plain_ms = time_ms(torch, plain_bwd)
    common = {"route": "cuda", "path": "ring", "plain_ms": plain_ms,
              "library_ms": library["bwd"],
              "library": "SDPA backward over the whole ring (L8192, one zero key)",
              "tolerance": f"2e-2 of max(1, |plain|) and {BWD_NORM_TOL['bf16']} of "
                           "max(1, ||plain||)", "norm_err": norm,
              "launches_per_ring": launches["bwd"]}
    b5, by5 = bound_ms(5 * bhld * 2 + 2 * bhl * 4, 6.0 * D * pairs)
    b6, by6 = bound_ms(6 * bhld * 2 + 2 * bhl * 4, 8.0 * D * pairs)
    lines.append({**common, "name": f"flash_bwd_dq ring block {name}",
                  "counter": "flash_bwd_dq", "source": f"{CSRC}/flash_bwd_dq.cu",
                  "replaces": f"{FLASH_PY}:685 _bwd_dq_kernel (block grads, global lse)",
                  "max_abs_err": rel["dq"], "ms": time_ms(torch, k5), "device_ms": k5_dev,
                  "tflops": tflops(6.0 * D * pairs, k5_dev), "bound_ms": b5, "bound_by": by5})
    lines.append({**common, "name": f"flash_bwd_dkv ring block {name}",
                  "counter": "flash_bwd_dkv", "source": f"{CSRC}/flash_bwd_dkv.cu",
                  "replaces": f"{FLASH_PY}:777 _bwd_dkv_kernel (block grads, global lse)",
                  "max_abs_err": max(rel["dk"], rel["dv"]), "ms": time_ms(torch, k6),
                  "device_ms": k6_dev, "tflops": tflops(8.0 * D * pairs, k6_dev),
                  "bound_ms": b6, "bound_by": by6})
    return lines


def ring(torch, pkg):
    """TinyLlama-1.1B's attention width (H32, KVH4, d64), bf16, n = 1,
    causal, B1 x L8192 as p = 4 shards of 2048: every rank's schedule in
    one process through the package's per-rank step functions, held
    against single-device K1 (o within the float64 model with the ring's
    second rounding, lse within 1e-3) and K5/K6 (dq, dk, dv by norm_err
    within BWD_NORM_TOL); then the three kernels at a ring block's shape.
    Returns (launches of one ring forward and backward, kernel lines)."""
    ra, fa, build = pkg["ring_attention"], pkg["flash_attention"], pkg["build"]
    B, H, KVH, L, D, P, n = (RING[k] for k in ("B", "H", "KVH", "L", "D", "P", "n"))
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, do = (torch.randn((B, H, L, D), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((B, KVH, L, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    scale = D ** -0.5
    shard = lambda x: list(x.chunk(P, dim=2))  # noqa: E731
    qs, ks, vs, dos = shard(q), shard(k), shard(v), shard(do)
    torch.cuda.synchronize()
    build.reset_launches()
    outs, lses, _ = ring_schedule(torch, ra, qs, ks, vs, dos, n=n, scale=scale,
                                  backward=False)
    torch.cuda.synchronize()
    fwd_launches = {k_: build.LAUNCHES[k_] for k_ in RING_KERNELS}
    build.reset_launches()
    outs, lses, (dq, dk, dv) = ring_schedule(torch, ra, qs, ks, vs, dos, n=n, scale=scale)
    torch.cuda.synchronize()
    launches = {k_: build.LAUNCHES[k_] for k_ in RING_KERNELS}
    bwd_launches = {k_: launches[k_] - fwd_launches[k_] for k_ in RING_KERNELS}
    modes = [ra.block_mode(True, P, my, t) for my in range(P) for t in range(P)]
    by_mode = {"full": modes.count(0), "causal": modes.count(1), "skipped": modes.count(2)}
    require(fwd_launches["flash_fwd"] == by_mode["full"] + by_mode["causal"]
            and bwd_launches["flash_bwd_dq"] == bwd_launches["flash_bwd_dkv"]
            == by_mode["full"] + by_mode["causal"],
            f"ring: launches {fwd_launches} / {bwd_launches} against blocks {by_mode}")

    rep = H // KVH
    kr, vr = (x.repeat_interleave(rep, dim=1) for x in (k, v))
    o_ring, lse_ring = torch.cat(outs, 2), torch.cat(lses, 2)
    o1, lse1 = fa.flash_fwd(q, kr, vr, None, n=n, scale=scale, is_causal=True)
    ex = {"bias": None, "slopes": None, "seed": None, "dropout_rate": 0.0}
    o64, o_abs64 = fwd_float64(torch, fa, q, kr, vr, ex, n=n, causal=True, heads=2)
    g1 = fa.flash_bwd(q, kr, vr, None, None, None, o1, lse1, do, scale=scale,
                      is_causal=True)[:3]
    group = lambda g: g.float().reshape(B, KVH, rep, L, D).sum(2)  # noqa: E731
    want = {"dq": g1[0].float(), "dk": group(g1[1]), "dv": group(g1[2])}
    got = {"dq": torch.cat(dq, 2), "dk": torch.cat(dk, 2), "dv": torch.cat(dv, 2)}
    torch.cuda.synchronize()
    errs = {"o_excess_ring": o_excess(o_ring, o64, o_abs64, p_roundings=2),
            "o_excess_single": o_excess(o1, o64, o_abs64),
            "o_vs_single": float((o_ring.float() - o1.float()).abs().max()),
            "lse_vs_single": float((lse_ring - lse1).abs().max()),
            "norm_err": {k_: norm_err(got[k_], want[k_]) for k_ in got}}
    del o64, o_abs64

    # the library yardstick for the whole ring: SDPA with one zero key
    # prepended (n = 1) over L8192, causal, GQA repeated; backward alone
    zrow = torch.zeros((B, H, 1, D), dtype=q.dtype, device="cuda")
    mask1 = torch.cat([torch.ones((L, 1), dtype=torch.bool, device="cuda"),
                       torch.ones((L, L), dtype=torch.bool, device="cuda").tril()], -1)
    ql, kl, vl = (t.detach().clone().requires_grad_(True)
                  for t in (q, torch.cat([zrow, kr], 2), torch.cat([zrow, vr], 2)))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask1,
                                                                scale=scale)

    out_l = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(out_l, (ql, kl, vl), do, retain_graph=True)

    library = {"fwd": time_ms(torch, sdpa, runs=10), "bwd": time_ms(torch, sdpa_bwd, runs=10)}
    del out_l, ql, kl, vl

    def ring_fwd():
        return ring_schedule(torch, ra, qs, ks, vs, dos, n=n, scale=scale, backward=False)

    def ring_fwd_bwd():
        return ring_schedule(torch, ra, qs, ks, vs, dos, n=n, scale=scale)

    ring_fwd_ms = time_ms(torch, ring_fwd, runs=10)
    ring_all_ms = time_ms(torch, ring_fwd_bwd, runs=10)
    emit({"phase": "ring", "config": "TinyLlama-1.1B attention width H32 KVH4 d64, bf16, "
                                     "n 1, causal, B1 x L8192 as p = 4 shards of 2048",
          "card": pkg["nvidia_smi"], "errors": errs,
          "tolerance": {"o_excess_ring": "<= 0: 2^-8 |o64| + (2 2^-8 + 2^-11) (p|v|)64",
                        "o_excess_single": "<= 0: 2^-8 |o64| + (2^-8 + 2^-11) (p|v|)64",
                        "lse_vs_single": 1e-3, "norm_err": BWD_NORM_TOL["bf16"]},
          "blocks": by_mode, "launches_forward": fwd_launches,
          "launches_backward": bwd_launches,
          "ring_forward_ms": ring_fwd_ms, "ring_forward_backward_ms": ring_all_ms,
          "library_forward_ms": library["fwd"], "library_backward_ms": library["bwd"]})
    require(errs["o_excess_ring"] <= 0.0 and errs["o_excess_single"] <= 0.0
            and errs["lse_vs_single"] <= 1e-3
            and max(errs["norm_err"].values()) <= BWD_NORM_TOL["bf16"],
            f"ring: off single-device K1/K5/K6 or the float64 evaluation: {errs}")

    # the kernels at a visiting block's shape: rank 1 against block 0
    # (full) and its own block 1 (causal), with rank 1's global out and lse
    blocks = {mode: (ks[b].repeat_interleave(rep, dim=1), vs[b].repeat_interleave(rep, dim=1))
              for mode, b in (("full", 0), ("causal", 1))}
    lines = ring_block_lines(torch, pkg, qs[1], blocks, dos[1], outs[1], lses[1],
                             launches={"fwd": fwd_launches["flash_fwd"],
                                       "bwd": bwd_launches["flash_bwd_dq"]}, library=library)
    for line in lines:
        emit({"phase": "kernel", **{k_: line.get(k_) for k_ in (
            "name", "max_abs_err", "tolerance", "ms", "device_ms", "tflops", "plain_ms",
            "bound_ms", "library_ms", "launches_per_ring")}})
    return launches, lines


# ----------------------------------------------------------------------------
# phases 12-13: training over a mesh on a one-rank NCCL group, checkpoints
# ----------------------------------------------------------------------------


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def mesh_steps(torch, pkg, cfg, params, tokens, mesh, steps=4, **kw):
    """``steps`` AdamW steps of ``make_train_step(cfg, mesh, **kw)`` and the
    unmeshed step's first loss on the same params and tokens."""
    tr, build = pkg["train"], pkg["build"]
    init, step = tr.make_train_step(cfg, learning_rate=3e-4)
    p, o = init(clone_tree(params))
    _, _, ref = step(p, o, tokens)
    ref = ref.item()
    del p, o
    init, step = tr.make_train_step(cfg, mesh, learning_rate=3e-4, **kw)
    p, o = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        p, o, loss = step(p, o, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = {k_: build.LAUNCHES[k_] for k_ in TRAIN_KERNELS}
    b, l = tokens.shape
    out = {"losses": losses, "unmeshed_first_loss": ref,
           "first_loss_rel_diff": abs(losses[0] - ref) / abs(ref), "step_wall_s": walls,
           "tokens_per_s": [b * l / w for w in walls],
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches}
    del p, o
    return out


def train_mesh(torch, pkg):
    """``make_train_step`` over a mesh at the full TinyLlama-1.1B shape (22
    layers, bf16, n = 1, remat), on a one-rank NCCL group (the machine has
    one card; NCCL takes no two ranks on one device): ``initialize_
    distributed`` then ``make_mesh({"data": 1, "model": 1, "sp": 1})``;
    4 steps with ``sp_axis="sp"`` (the ring, p = 1) at B1 x L4096, then 4
    with the tensor-parallel path and ``zero1=True`` at B2 x L2048. Losses
    finite and falling, the first within 1e-3 relative of the unmeshed
    step's on the same params and tokens. The checkpoint phase runs inside
    the same group; the group is destroyed at the end, failed or not."""
    import torch.distributed as dist

    dec, mesh_mod = pkg["decoder"], pkg["mesh"]
    mesh_mod.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = mesh_mod.make_mesh({"data": 1, "model": 1, "sp": 1})
        launches = {k_: 0 for k_ in TRAIN_KERNELS}
        runs = {}
        for name, (b, l), kw in (("sp", (1, 4096), {"sp_axis": "sp"}),
                                 ("tp_zero1", (2, 2048), {"zero1": True})):
            cfg = dec.DecoderConfig(**{**TINYLLAMA, "max_seq_len": l}, n_layers=22,
                                    dtype=torch.bfloat16, remat=True)
            params = dec.init_decoder_params(cfg, 0, device="cuda")
            tokens = torch.from_numpy(
                np.random.RandomState(3).randint(0, cfg.vocab_size, size=(b, l))).cuda()
            runs[name] = mesh_steps(torch, pkg, cfg, params, tokens, mesh, **kw)
            del params
            for k_ in TRAIN_KERNELS:
                launches[k_] += runs[name]["launches"][k_]
        emit({"phase": "train_mesh", "config": "TinyLlama-1.1B shape, 22 layers, bf16, n 1, "
                                               "remat, AdamW lr 3e-4; sp: B1 L4096 on "
                                               "sp_axis='sp'; tp_zero1: B2 L2048, zero1",
              "card": pkg["nvidia_smi"], "backend": dist.get_backend(),
              "world_size": dist.get_world_size(), "mesh": dict(zip(mesh.mesh_dim_names,
                                                                    mesh.mesh.shape)),
              **{name: run for name, run in runs.items()}, "tolerance": 1e-3})
        for name, run in runs.items():
            losses = run["losses"]
            require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                    f"train_mesh {name}: losses not finite or not falling: {losses}")
            require(run["first_loss_rel_diff"] <= 1e-3,
                    f"train_mesh {name}: first loss {losses[0]} against the unmeshed "
                    f"{run['unmeshed_first_loss']}")
            for k_, count in run["launches"].items():
                require(count > 0, f"train_mesh {name} never launched {k_}")
        checkpoint(torch, pkg, mesh)
        mesh_launches = serve_mesh(torch, pkg)
    finally:
        dist.destroy_process_group()
    return launches, mesh_launches


def checkpoint(torch, pkg, mesh):
    """Save and load the TinyLlama-1.1B params (22 layers), dense bf16 and
    int8, through ``utils.checkpoint``: the reloaded forward's logits
    bit-equal (B1 L256). Then a train checkpoint: at the TinyLlama width
    with the depth cut to 2 layers, bf16, B1 x L512 on the mesh with
    ZeRO-1, 4 steps straight against 2, a save (the shards gathered), a
    load (sharded again) and 2 more: the same losses."""
    import tempfile

    dec, ck, weights = pkg["decoder"], pkg["checkpoint"], pkg["weights"]
    cfg = dec.DecoderConfig(**TINYLLAMA, n_layers=22, dtype=torch.bfloat16)
    params = dec.init_decoder_params(cfg, 0, device="cuda")
    tokens = torch.from_numpy(
        np.random.RandomState(4).randint(0, cfg.vocab_size, size=(1, 256))).cuda()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, tree in (("dense_bf16", params),
                           ("int8", weights.quantize_decoder_weights(params, bits=8))):
            with torch.no_grad():
                want = dec.decoder_forward(tree, cfg, tokens)
            t0 = time.perf_counter()
            ck.save_checkpoint(f"{tmp}/{name}", cfg, tree, metadata={"surgery": {
                "softmax_n": cfg.softmax_n}})
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cfg2, back, meta = ck.load_checkpoint(f"{tmp}/{name}")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            with torch.no_grad():
                got = dec.decoder_forward(back, cfg2, tokens)
            size = sum(f.stat().st_size for f in Path(tmp, name).iterdir())
            out[name] = {"bit_equal": bool(torch.equal(got, want)), "same_config": cfg2 == cfg,
                         "softmax_n": meta["surgery"]["softmax_n"], "save_s": save_s,
                         "load_s": load_s, "bytes": size}
            del back, got, want
        del params

        tr = pkg["train"]
        small = dec.DecoderConfig(**{**TINYLLAMA, "max_seq_len": 512}, n_layers=2,
                                  dtype=torch.bfloat16)
        toks = torch.from_numpy(
            np.random.RandomState(5).randint(0, small.vocab_size, size=(1, 512))).cuda()

        def adamw(leaves):
            return torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=1e-4)

        init, step = tr.make_train_step(small, mesh, optimizer=adamw, zero1=True)

        def run(n_steps, p, o):
            losses = []
            for _ in range(n_steps):
                p, o, loss = step(p, o, toks)
                losses.append(loss.item())
            return p, o, losses

        start = dec.init_decoder_params(small, 1, device="cuda")
        _, _, straight = run(4, *init(clone_tree(start)))
        p, o, first = run(2, *init(start))
        ck.save_train_checkpoint(f"{tmp}/train", small, p, o, step=2, mesh=mesh)
        cfg3, p, o, step_r, _ = ck.load_train_checkpoint(f"{tmp}/train", adamw, mesh=mesh,
                                                         zero1=True)
        _, _, resumed = run(2, p, o)
    resumed = first + resumed
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
    emit({"phase": "checkpoint", "card": pkg["nvidia_smi"],
          "config": "TinyLlama-1.1B shape, 22 layers, bf16 and int8; train resume at 2 "
                    "layers, bf16, B1 L512, ZeRO-1 on the one-rank mesh", **out,
          "train_resume": {"straight": straight, "resumed": resumed, "max_rel_diff": rel,
                           "step": step_r, "same_config": cfg3 == small}, "tolerance": 1e-6})
    for name, res in out.items():
        require(res["bit_equal"] and res["same_config"],
                f"checkpoint {name}: the reloaded forward or config differs: {res}")
    require(step_r == 2 and rel <= 1e-6,
            f"checkpoint: resumed losses {resumed} against {straight}")


# ----------------------------------------------------------------------------
# phase 14: serving over a mesh, in the one-rank NCCL group of train_mesh
# ----------------------------------------------------------------------------

# the per-rank shapes of {"data": 2, "model": 4} at TinyLlama-1.1B's widths:
# what each of 8 cards launches (64 slots / 2 = 32 a rank, 32 query and 4 KV
# heads / 4, 32000 vocab columns / 4, d_ff 5632 / 4)
MESH_DP, MESH_TP = 2, 4
MESH_KERNELS = ("flash_fwd", "qmm_argmax", "cache_append", "tail_append", "qmm",
                "decode_attn", "fused_mlp")


def check_qmm_vocab_shards(torch, pkg, gen, *, M, K, N, P):
    """K2 on each of ``P`` vocab shards of one (K, N) lm_head, in one
    process, as the ranks of a ``"model"`` axis run it: each shard held
    against its plain version as ``check_qmm`` holds it, and the engine's
    merge (``engine._merge_shard_argmax`` over each shard's (max, index +
    its first column)) required equal to K2 over all N columns on the same
    rows (K is never split, so a column's value does not depend on its
    shard, and a tie takes the lowest global column in both). Shard 0 is
    timed, with its bound, plan and cuBLAS's GEMM + max beside it."""
    qm, eng = pkg["quant_matmul"], pkg["engine"]
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), generator=gen, device=dev).to(torch.int8)
    s = (torch.rand((1, N), generator=gen, device=dev) + 0.5) / (127.0 * K ** 0.5)
    part = N // P
    shards = [(w[:, r * part:(r + 1) * part].contiguous(),
               s[:, r * part:(r + 1) * part].contiguous()) for r in range(P)]
    vals, idxs, idx_ok, rel, err, undecided = [], [], True, 0.0, 0.0, 0
    for r, (wr, sr) in enumerate(shards):
        idx, val = qm.quantized_matmul_argmax(x, wr, sr, return_max=True)
        idx_ref, val_ref = qm.quantized_matmul_argmax_reference(x, wr, sr)
        top2 = torch.topk((x.float() @ wr.float()) * sr, 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 1e-3
        idx_ok &= bool(torch.equal(idx[decided], idx_ref[decided]))
        rel = max(rel, float(((val - val_ref).abs() / val_ref.abs().clamp(min=1e-6)).max()))
        err = max(err, float((val - val_ref).abs().max()))
        undecided += int((~decided).sum())
        vals.append(val.double())
        idxs.append(idx + r * part)
    merged = eng._merge_shard_argmax(torch.stack(vals), torch.stack(idxs).to(torch.int32))
    whole = qm.quantized_matmul_argmax(x, w, s)
    merge_equal = bool(torch.equal(merged, whole))
    w0, s0 = shards[0]

    def kernel():
        return qm.quantized_matmul_argmax(x, w0, s0, return_max=True)

    def plain():
        return qm.quantized_matmul_argmax_reference(x, w0, s0)

    w0_bf16 = w0.to(torch.bfloat16)

    def cublas():
        return torch.max((x @ w0_bf16) * s0, dim=-1)

    same = repeat_equal(torch, kernel, kernel())
    name = f"qmm_argmax M{M} K{K} N{part} (vocab shard of N{N} over {P})"
    require(idx_ok and rel <= 1e-3 and same and merge_equal,
            f"{name}: indices equal where the top-2 gap > 1e-3: {idx_ok}; max relative "
            f"error of the max {rel} (tol 1e-3); repeat bit-equal {same}; merged tokens "
            f"equal K2 over N{N}: {merge_equal}")
    plan = qm.qmm_argmax_plan(M, K, part, x.dtype)
    b_ms, b_by = bound_ms(x.numel() * 2 + w0.numel() + part * 4 + M * 8, 2.0 * M * K * part)
    k_dev, cublas_dev = device_ms_of(torch, [(kernel, QMM_ARGMAX_KERNELS), (cublas, None)])
    return {"name": name, "route": "cuda", "source": f"{CSRC}/qmm_argmax.cu",
            "replaces": f"{TPU_PKG}/kernels/quant_matmul.py:117 _qmm_argmax_kernel",
            "counter": "qmm_argmax", "max_abs_err": err, "max_rel_err": rel,
            "tolerance": 1e-3, "undecided_rows": undecided, "repeat_bit_equal": same,
            "merge_equal_whole_vocab": merge_equal, "plan": plan._asdict(),
            "producer": plan.producer, "ms": time_ms(torch, kernel), "device_ms": k_dev,
            "w_gbps": w0.numel() / (k_dev * 1e-3) / 1e9 if k_dev else None,
            "plain_ms": time_ms(torch, plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library": "none: no one PyTorch call computes it (a GEMM and a max)",
            "cublas_device_ms": cublas_dev,
            "cublas": "torch.max((x @ W) * s, -1) over W dequantized to bf16"}


def mesh_kernel_lines(torch, pkg):
    """Every kernel of the meshed serving path at the per-rank shapes of
    {"data": 2, "model": 4} at TinyLlama-1.1B's widths, each against its
    plain version, from a generator of its own (seed 15): K2 on four
    vocab shards with the merge, K1 over an admission group on a rank's
    heads, K3/K4 on its 32 slots and one KV head, K8 over its 8 query
    heads of that KV head, K7 on the column shards (wq, wk/wv, gate/up) and
    row shards (wo, w_down), K9 on a quarter of d_ff."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    b = 64 // MESH_DP
    h, kvh, f, d = 32 // MESH_TP, 4 // MESH_TP, 5632 // MESH_TP, 2048
    lines = [
        check_qmm_vocab_shards(torch, pkg, gen, M=b, K=d, N=32000, P=MESH_TP),
        check_flash(torch, pkg, gen, B=16, H=h, L=128, S=128, D=64, masked=True),
        check_row_writes(torch, pkg, ("cache_append", 22, b, kvh, 512, 64, 906)),
        check_row_writes(torch, pkg, ("tail_append", 22, b, kvh, 64, 64, 907)),
        check_decode_attn(torch, pkg, (b, kvh, h // kvh, 512, 64, "int8", 806)),
        *(check_dequant_mm(torch, pkg, gen, M=b, K=k, N=n)
          for k, n in ((d, h * 64), (d, kvh * 64), (d, f), (h * 64, d), (f, d))),
        check_fused_mlp(torch, pkg, gen, M=b, K=d, F=f),
    ]
    for kd in lines:
        kd["path"] = "serve_mesh"
    return lines


def fixed_plan_engine(eng_mod, eager=False):
    """The engine (capture off if ``eager``) planning chunks with the fixed
    ``_SCHED_OVERHEAD_STEPS``, as a meshed engine does, instead of its
    measured times: the unmeshed reference then plans the meshed run's
    chunks, and the two compute the same function."""
    base = eager_engine(eng_mod) if eager else eng_mod.InferenceEngine

    class FixedPlanEngine(base):
        _sched_overhead_steps = eng_mod.InferenceEngine._SCHED_OVERHEAD_STEPS

    return FixedPlanEngine


def serve_mesh_route(torch, pkg, cfg, params, mesh, route):
    """``serve_fused``'s 96 requests (seed 0) through 64 slots of a meshed
    engine after ``prewarm(loop_steps=64, attn_lens=[256])``, then the first
    4 through its step path (K3), against the same on an unmeshed engine
    (eager, the meshed run's chunk plan, no piggybacking, which a mesh
    turns off): on one rank the ops are the same, so every token must be
    equal. Returns the meshed runs' launches."""
    eng_mod, build = pkg["engine"], pkg["build"]
    reqs = serve_requests(np.random.RandomState(0), cfg, 96)

    def run(eng, step=False):
        ids = [eng.submit(p, max_new_tokens=n) for p, n in (reqs[:4] if step else reqs)]
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        done = {r.request_id: r for r in eng.run_until_done(
            loop_steps=None if step else 64)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(len(done) == len(ids), f"serve_mesh_{route}: finished {len(done)} of "
                f"{len(ids)} requests")
        return [done[i].output for i in ids], wall, dict(build.LAUNCHES)

    ref_eng = fixed_plan_engine(eng_mod, eager=True)(
        cfg, params, max_batch=64, max_len=512, kv_quantization="int8",
        piggyback_prefill=False)
    ref, _, _ = run(ref_eng)
    ref_step, _, _ = run(ref_eng, step=True)
    del ref_eng
    eng = eng_mod.InferenceEngine(cfg, params, max_batch=64, max_len=512,
                                  kv_quantization="int8", mesh=mesh)
    prewarm = prewarm_line(torch, eng, f"serve_mesh_{route}")
    out, wall, launches = run(eng)
    counters = eng.counters_report()
    out_step, step_wall, step_launches = run(eng, step=True)
    n_tok = sum(len(o) for o in out)
    emit({"phase": f"serve_mesh_{route}", "card": pkg["nvidia_smi"],
          "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
          "config": f"TinyLlama-1.1B shape, 22 layers, int8 weights and KV, {route} route",
          "requests": len(out), "tokens": n_tok, "wall_s": wall,
          "tokens_per_s": n_tok / wall, "prewarm_s": prewarm["seconds"],
          "variants": prewarm["variants"], "step_requests": 4, "step_wall_s": step_wall,
          "equal_to_unmeshed": sum(a == b for a, b in zip(out, ref)),
          "step_equal_to_unmeshed": sum(a == b for a, b in zip(out_step, ref_step)),
          "counters": counters, "launches": launches, "step_launches": step_launches})
    require(all(len(o) == n for o, (_, n) in zip(out, reqs)),
            f"serve_mesh_{route}: a request did not emit exactly its budget")
    require(out == ref and out_step == ref_step,
            f"serve_mesh_{route}: the meshed tokens differ from the unmeshed engine's")
    require(counters.get("piggyback_prompts", 0) == 0,
            f"serve_mesh_{route}: a prompt was piggybacked under a mesh")
    return {k: launches[k] + step_launches[k] for k in launches}


def serve_mesh_prefix(torch, pkg, cfg, params, mesh):
    """One 256-token prefix (bench.py's, seed 99) on a 1-slot meshed engine:
    8 requests behind it (prompts 272-383 tokens, budgets 16-63) served
    cold (the chunked lane: chunks at offsets 0 and 256), then again after
    ``register_prefix`` (8 hits: the stored rows copied in, one chunk at
    offset 256). One slot keeps every admission at one row, the store's
    own prefill shape, so the hits must give the cold tokens exactly.
    Returns both runs' launches."""
    eng_mod, build = pkg["engine"], pkg["build"]
    eng = eng_mod.InferenceEngine(cfg, params, max_batch=1, max_len=512,
                                  kv_quantization="int8", mesh=mesh)
    prefix = np.random.RandomState(PREFIX_SEED).randint(
        0, cfg.vocab_size, size=PREFIX_LEN).tolist()
    reqs = [(prefix + p, n) for p, n in serve_requests(np.random.RandomState(6), cfg, 8)]

    def run():
        ids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        eng.counters_report()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        done = {r.request_id: r for r in eng.run_until_done(loop_steps=64)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return ([done[i].output for i in ids], wall, dict(build.LAUNCHES),
                eng.counters_report())

    cold, cold_wall, cold_launches, _ = run()
    eng.register_prefix(prefix)
    warm, warm_wall, warm_launches, counters = run()
    emit({"phase": "serve_mesh_prefix", "prefix_tokens": PREFIX_LEN, "requests": 8,
          "cold_wall_s": cold_wall, "warm_wall_s": warm_wall,
          "equal": sum(a == b for a, b in zip(cold, warm)),
          "counters": {k: counters.get(k, 0) for k in (
              "prefix_hits", "prefix_reused_tokens", "prefill_groups", "chunks")}})
    require(counters.get("prefix_hits", 0) == 8
            and counters.get("prefix_reused_tokens", 0) == 8 * PREFIX_LEN,
            f"serve_mesh_prefix: {counters.get('prefix_hits')} hits reusing "
            f"{counters.get('prefix_reused_tokens')} tokens, not 8 and {8 * PREFIX_LEN}")
    require(cold == warm, "serve_mesh_prefix: the prefix hits' tokens differ from cold "
                          "prefill's")
    return {k: cold_launches[k] + warm_launches[k] for k in cold_launches}


def serve_mesh(torch, pkg):
    """``InferenceEngine(mesh=make_mesh({"data": 1, "model": 1}))`` on the
    one-rank NCCL group at the TinyLlama-1.1B shape (22 layers, bf16, the
    serve phase's int8 weights from seed 0, int8 KV, 64 slots, max_len
    512): the default route and the all-kernel route
    (``serve_mesh_route``), then the prefix cache (``serve_mesh_prefix``).
    Every kernel of the path must launch. Returns the meshed runs'
    launches."""
    dec, weights = pkg["decoder"], pkg["weights"]
    mesh = pkg["mesh"].make_mesh({"data": 1, "model": 1})
    cfg = dec.DecoderConfig(**TINYLLAMA, n_layers=22, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense = dec.init_decoder_params(cfg, gen, device="cuda")
    params = weights.quantize_decoder_weights(dense, bits=8)
    del dense
    pallas = dataclasses.replace(cfg, int8_mm_impl="pallas", decode_attn_impl="pallas")
    runs = [serve_mesh_route(torch, pkg, cfg, params, mesh, "default"),
            serve_mesh_route(torch, pkg, pallas, params, mesh, "pallas"),
            serve_mesh_prefix(torch, pkg, cfg, params, mesh)]
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    for name in MESH_KERNELS:
        require(launches[name] > 0, f"serve_mesh never launched {name}")
    return launches


# ----------------------------------------------------------------------------
# phase 15: serve_7b, Llama-7B's geometry at full depth
# ----------------------------------------------------------------------------

SEVEN_B_KERNELS = SERVE_KERNELS + PALLAS_KERNELS


def llama_configs(pkg):
    """(Llama-7B, its first batch; Llama-3-8B, its first batch) of
    utils/bench_7b.CONFIGS (scripts/bench_7b.py:122-138): Llama-7B's 32
    heads over 32 KV heads (G = 1) at head dim 128, Llama-3-8B's 8 KV
    heads, d_ff 14336 and vocabulary of 128256"""
    (_, c7, b7), (_, c8, b8) = pkg["bench_7b"].CONFIGS
    return c7, b7[0], c8, b8[0]


def serve_7b_kernel_lines(torch, pkg):
    """Every kernel of serve_7b's path at the shapes it launches, each
    against its plain version and bit-equal on repeat, from a generator of
    its own (seed 17): K1 over one admission group of bench_decode (B8 H32
    L=S=128 d128 under the engine's mask); K2 over Llama-7B's vocabulary at
    B48 and Llama-3-8B's at B96; K3 on the B48 int8 cache (NL32 KVH32 S512
    D128 with scales) and K4 on a 64-step ring of it; K7 at decode M48 over
    the projections (the engine fuses no projection: wq, wk, wv and wo are
    each K4096 N4096), at the admission group's M1024 (K4096 N4096 and
    N11008, K11008 N4096), and with int4 weights at M48 (the int4 route
    takes the MLP to K7 too); K8 at B48 KVH32 G1 S512 d128 over int8 and
    fp8 caches; K9 at M48 K4096 F11008 and Llama-3-8B's F14336."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    c7, b, c8, b8 = llama_configs(pkg)
    d, f, nl, kvh = c7.d_model, c7.d_ff, c7.n_layers, c7.n_kv_heads
    shapes = ((d, d), (d, f), (f, d))
    lines = [
        check_flash(torch, pkg, gen, B=8, H=c7.n_heads, L=128, S=128, D=c7.head_dim,
                    masked=True),
        check_qmm(torch, pkg, gen, M=b, K=d, N=c7.vocab_size),
        check_qmm(torch, pkg, gen, M=b8, K=d, N=c8.vocab_size),
        check_row_writes(torch, pkg, ("cache_append", nl, b, kvh, 512, 128, 911)),
        check_row_writes(torch, pkg, ("tail_append", nl, b, kvh, 64, 128, 912)),
        check_dequant_mm(torch, pkg, gen, M=b, K=d, N=d),
        *(check_dequant_mm(torch, pkg, gen, M=1024, K=k, N=n) for k, n in shapes),
        *(check_dequant_mm(torch, pkg, gen, M=b, K=k, N=n, mode="int4") for k, n in shapes),
        check_decode_attn(torch, pkg, (b, kvh, 1, 512, 128, "int8", 813)),
        check_decode_attn(torch, pkg, (b, kvh, 1, 512, 128, "fp8", 814)),
        check_fused_mlp(torch, pkg, gen, M=b, K=d, F=f),
        check_fused_mlp(torch, pkg, gen, M=b, K=d, F=c8.d_ff),
    ]
    for kd in lines:
        kd["path"] = "serve_7b"
    return lines


def serve_7b_step(torch, pkg, cfg, params, done, kv, phase):
    """The first 2 of ``done`` again through a 2-slot engine's step path
    (K3 writes each step's rows into the cache); returns (the requests, the
    kernels' launches on the run)."""
    build = pkg["build"]
    eng = pkg["engine"].InferenceEngine(cfg, params, max_batch=2, max_len=512,
                                        kv_quantization=kv)
    for r in done[:2]:
        eng.submit(r.prompt, max_new_tokens=len(r.output))
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    step_done = sorted(eng.run_until_done(), key=lambda r: r.request_id)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    emit({"phase": f"{phase}_step", "requests": 2,
          "tokens": sum(len(r.output) for r in step_done),
          "wall_s": time.perf_counter() - t0, "launches": launches})
    require(len(step_done) == 2 and all(
        len(a.output) == len(b.output) for a, b in zip(step_done, done)),
        f"{phase}: the step path did not finish its requests with their budgets")
    return step_done, launches


def serve_7b(torch, pkg):
    """Llama-7B at its published widths and full 32 layers, with int8
    weights synthesized from seed 0 (``bench_7b.init_7b_int8_synth``, as
    bench.py's 7B point builds them), on the card:

    (a) ``bench_7b.bench_decode`` at B48 (prompts of 128 tokens, 32-step
        windows, max_len 512, int8 KV) on the default route and on the
        all-kernel route: tokens/s eagerly and replayed as a CUDA graph,
        admission tokens/s, peak memory and the pre-flight estimate (one
        run each, no claim); every slot must stay active and reach its
        length;
    (b) 24 requests (prompts 16-127, budgets 16-63) through 16 slots of an
        engine built as bench.py builds it (piggybacked prefill, then
        ``prewarm(loop_steps=64, attn_lens=[256])``) on the all-kernel
        route, and 2 of them again through the step path, held to their
        budgets and the teacher-forced gate;
    (c) 8 requests through 8 slots with grouped int4 weights (synthesized,
        seed 1) and an fp8 KV cache on the all-kernel route, chunks run
        eagerly (no capture), under the same gate, and 2 through the step
        path (K8's fp8 mode at G1 d128).

    Every kernel of the serving path (K1-K4, K7-K9) must launch. Returns
    the launches of the serving runs of (a)-(c): the counts are set to 0
    just before each run and read just after it, so the teacher-forced
    gates' reference forwards and the engines' prewarm are not counted."""
    b7, build = pkg["bench_7b"], pkg["build"]
    cfg, batch, _, _ = llama_configs(pkg)
    pallas = dataclasses.replace(cfg, int8_mm_impl="pallas", decode_attn_impl="pallas")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = b7.init_7b_int8_synth(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    emit({"phase": "serve_7b_weights", "init": "init_7b_int8_synth",
          "seconds": time.perf_counter() - t0,
          "bytes": pkg["profiling"].pytree_bytes(params),
          "config": "Llama-7B: 32 layers, d 4096, 32 heads over 32 KV heads, head dim 128, "
                    "d_ff 11008, vocab 32000; int8 values uniform in [-127, 127] with "
                    "per-output-channel scales 4.5 fan_in^-0.5 / 127 from seed 0"})
    torch.cuda.synchronize()
    build.reset_launches()
    runs = []
    for route, c in (("default", cfg), ("pallas", pallas)):
        res = b7.bench_decode(c, params, kv_quantization="int8", batch=batch)
        emit({"phase": "serve_7b_throughput", "route": route, "card": pkg["nvidia_smi"],
              **res})
        steps = 4 * res["decode_steps"]
        require(res["active_slots"] == batch
                and res["lengths"] == [res["prompt_len"] + steps],
                f"serve_7b_throughput {route}: active slots {res['active_slots']}, "
                f"lengths {res['lengths']}")
        require(res["graph_tokens_per_s"] > 0 and res["eager_tokens_per_s"] > 0,
                f"serve_7b_throughput {route}: no rate")
    torch.cuda.synchronize()
    runs.append(dict(build.LAUNCHES))
    emit({"phase": "serve_7b_throughput", "launches": runs[-1]})

    del params
    torch.cuda.empty_cache()

    # the gates read values: weights quantized from N(0, 1/fan_in), as every
    # other serving phase's (the synthesized ones spread 2.6 times wider)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = b7.init_7b_int8(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    emit({"phase": "serve_7b_weights", "init": "init_7b_int8",
          "seconds": time.perf_counter() - t0,
          "peak_bytes": torch.cuda.max_memory_allocated()})
    done, launches = serve_fused(torch, pkg, pallas, params, "serve_7b_fused", slots=16,
                                 requests=24, kv="int8", seed=7)
    step_done, step_launches = serve_7b_step(torch, pkg, pallas, params, done, "int8",
                                             "serve_7b")
    runs += [launches, step_launches]
    teacher_forced_gate(torch, pkg, pallas, params, done + step_done, "serve_7b_agreement",
                        {"peak_bytes": torch.cuda.max_memory_allocated()})
    del params
    torch.cuda.empty_cache()

    params4 = b7.init_7b_int8(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda",
                              bits=4)
    eng = eager_engine(pkg["engine"])(pallas, params4, max_batch=8, max_len=512,
                                      kv_quantization="fp8")
    budgets = {}
    for prompt, budget in serve_requests(np.random.RandomState(8), cfg, 8):
        budgets[eng.submit(prompt, max_new_tokens=budget)] = budget
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    done4 = sorted(eng.run_until_done(loop_steps=64), key=lambda r: r.request_id)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs.append(dict(build.LAUNCHES))
    require(len(done4) == 8, f"serve_7b_int4_fp8: finished {len(done4)} of 8 requests")
    check_served(done4, budgets, cfg, "serve_7b_int4_fp8")
    n_tok = sum(len(r.output) for r in done4)
    emit({"phase": "serve_7b_int4_fp8", "requests": 8, "kv": "fp8", "tokens": n_tok,
          "wall_s": wall, "tokens_per_s": n_tok / wall, "launches": runs[-1],
          "counters": eng.counters_report()})
    del eng
    step4, step_launches = serve_7b_step(torch, pkg, pallas, params4, done4, "fp8",
                                         "serve_7b_int4_fp8")
    runs.append(step_launches)
    teacher_forced_gate(torch, pkg, pallas, params4, done4 + step4,
                        "serve_7b_int4_fp8_agreement")
    launches = {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}
    del params4
    torch.cuda.empty_cache()
    emit({"phase": "serve_7b", "launches": launches})
    for name in SEVEN_B_KERNELS:
        require(launches[name] > 0, f"serve_7b never launched {name}")
    return launches


def load_port():
    """The port's modules that the phases use, by short name, imported from
    the checkout beside this script; None if the port is not there."""
    sys.path.insert(0, str(ROOT))
    try:
        from flash_attention_softmax_n_tpu_torch import analysis as analysis_mod
        from flash_attention_softmax_n_tpu_torch import surgery as surgery_mod
        from flash_attention_softmax_n_tpu_torch.engine import engine
        from flash_attention_softmax_n_tpu_torch.kernels import (
            _build,
            cache_update,
            decode_attention,
            flash_attention,
            fused_mlp,
            prefill_phases as prefill_phases_mod,
            quant_matmul,
        )
        from flash_attention_softmax_n_tpu_torch.models import bert, decoder, xlnet
        from flash_attention_softmax_n_tpu_torch.ops import (
            flash_attention as ops_flash_attention,
        )
        from flash_attention_softmax_n_tpu_torch.parallel import mesh as mesh_mod
        from flash_attention_softmax_n_tpu_torch.parallel import ring_attention
        from flash_attention_softmax_n_tpu_torch.parallel import train as train_mod
        from flash_attention_softmax_n_tpu_torch.quant import gates, kv_cache, qtensor, weights
        from flash_attention_softmax_n_tpu_torch.utils import (
            bench_7b,
            bench_cache_update,
            bench_decode_attn,
            checkpoint as checkpoint_mod,
            profile_prefill_phases,
            profiling,
            standin,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return None
    return {"build": _build, "flash_attention": flash_attention,
            "ops_flash_attention": ops_flash_attention, "quant_matmul": quant_matmul,
            "cache_update": cache_update, "decode_attention": decode_attention,
            "fused_mlp": fused_mlp, "decoder": decoder, "engine": engine,
            "weights": weights, "qtensor": qtensor, "kv_cache": kv_cache, "train": train_mod,
            "prefill_phases": prefill_phases_mod,
            "profile_prefill_phases": profile_prefill_phases,
            "bench_decode_attn": bench_decode_attn, "bench_cache_update": bench_cache_update,
            "bench_7b": bench_7b, "profiling": profiling, "standin": standin,
            "analysis": analysis_mod, "surgery": surgery_mod, "gates": gates, "bert": bert,
            "xlnet": xlnet, "ring_attention": ring_attention, "mesh": mesh_mod,
            "checkpoint": checkpoint_mod}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    pkg = load_port()
    if pkg is None:
        return 1
    _build, profiling = pkg["build"], pkg["profiling"]
    bench_cache_update, prefill_phases_mod = pkg["bench_cache_update"], pkg["prefill_phases"]
    global CHIP, K8_LINES
    K8_LINES = pkg["bench_decode_attn"].LINES
    CHIP = profiling.H100
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = profiling.card_description(torch.device("cuda", 0))
    pkg["nvidia_smi"] = smi
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
        # M = 64: the fused loop's batch below; M = 72: its mixed steps (64
        # decode rows and 8 piggybacked prompts' last rows); M = 256: a
        # fuller batch
        check_qmm(torch, pkg, gen, M=64, K=2048, N=32000),
        check_qmm(torch, pkg, gen, M=72, K=2048, N=32000),
        check_qmm(torch, pkg, gen, M=256, K=2048, N=32000),
        # K3 at B4 (the step path's pool below) and B256, K4 at B64 (the
        # fused loop's batch) and B256
        *(check_row_writes(torch, pkg, line) for line in bench_cache_update.LINES),
    ]
    for kd in kernels:
        kd["path"] = "serve"
    # K1 as serve_prefix's chunks at offset 256 launch it: 16 prompts of
    # 257-512 tokens, 256 queries over 512 keys under the engine's mask
    kd = check_flash(torch, pkg, gen, B=16, H=32, L=256, S=512, D=64, masked=True,
                     true_lens=(256, 512))
    kd["path"] = "serve_prefix"
    kernels.append(kd)
    # K7-K9 at the pallas route's shapes: M = 64 the fused loop's batch
    # (N 2048 wq/wo, 256 wk/wv, 5632 w_gate/w_up), M = 1024 the profiled
    # chunk's admission group (16 x 64; K5632 N2048 is w_down), M = 2048 a
    # full admission group (16 x 128); K8 at B64 with int8 (the route's) and
    # bf16 caches
    pallas_lines = [
        check_dequant_mm(torch, pkg, gen, M=64, K=2048, N=2048),
        check_dequant_mm(torch, pkg, gen, M=64, K=2048, N=256),
        check_dequant_mm(torch, pkg, gen, M=64, K=2048, N=5632),
        *(check_dequant_mm(torch, pkg, gen, M=1024, K=2048, N=n) for n in (256, 2048, 5632)),
        check_dequant_mm(torch, pkg, gen, M=1024, K=5632, N=2048),
        check_dequant_mm(torch, pkg, gen, M=2048, K=2048, N=5632),
        check_dequant_mm(torch, pkg, gen, M=2048, K=5632, N=2048),
        # the mixed steps' operand, 64 decode rows and 8 prompts' slices of
        # 128 / chunk rows: M = 80 in a 64-step chunk, 192 in an 8-step one
        check_dequant_mm(torch, pkg, gen, M=80, K=2048, N=5632),
        check_dequant_mm(torch, pkg, gen, M=192, K=2048, N=5632),
        check_decode_attn(torch, pkg, K8_LINES[0]),  # B64 S512 int8
        check_decode_attn(torch, pkg, K8_LINES[1]),  # B64 S512 bf16
        check_fused_mlp(torch, pkg, gen, M=64, K=2048, F=5632),
        check_fused_mlp(torch, pkg, gen, M=256, K=2048, F=5632),
    ]
    for kd in pallas_lines:
        kd["path"] = "serve_pallas"
    # int4 and W8A8 at decode (M64: N5632 gate/up, K5632 N2048 down; those
    # routes do not fuse the MLP) and at the admission group (M1024)
    for mode in ("w8a8", "int4"):
        for M, K, N in ((64, 2048, 5632), (64, 5632, 2048), (1024, 2048, 5632)):
            kd = check_dequant_mm(torch, pkg, gen, M=M, K=K, N=N, mode=mode)
            kd["path"] = f"serve_{mode}"
            pallas_lines.append(kd)
    # K8's fp8 mode at serve_fp8's shapes: the fused loop's 8 slots over its
    # 256-row window (prompts and budgets stay under 256 tokens), the step
    # path's 2 slots over the whole 512-row cache
    for line in K8_LINES[3:]:  # fp8 at B8 S256, B2 S512
        kd = check_decode_attn(torch, pkg, line)
        kd["path"] = "serve_fp8"
        pallas_lines.append(kd)
    # K10 at the prefill-phase profile's shape
    for mode in prefill_phases_mod.MODES:
        kd = check_mini(torch, pkg, gen, mode=mode, B=2, H=32, L=2048, D=64)
        kd["path"] = "prefill_phases"
        pallas_lines.append(kd)
    kernels += pallas_lines
    # K8's fp8 mode beside its int8 and bf16 lines at B64, held all the
    # same; no path runs fp8 at B64, so it stays out of the kernels line
    fp8_b64 = check_decode_attn(torch, pkg, K8_LINES[2])
    # the analysis and surgery paths' lines draw from a generator of their
    # own, so that every other line keeps the inputs it had before them
    gen_analysis = torch.Generator(device="cuda").manual_seed(13)
    # K1 at the analysis phase's shape: the TinyLlama-1.1B decoder's
    # forward over B4 x L512 batches, causal
    kd = check_flash(torch, pkg, gen_analysis, B=4, H=32, L=512, S=512, D=64, masked=False)
    kd["path"] = "analysis"
    kernels.append(kd)
    # K7's f32 mode (the f32 FMA kernel) with grouped int4 weights at
    # BERT-base's three matmul shapes over the surgery phase's B8 x L512
    for K, N in ((768, 768), (768, 3072), (3072, 768)):
        kd = check_dequant_f32(torch, pkg, gen_analysis, M=4096, K=K, N=N, bits=4)
        kd["path"] = "surgery"
        kernels.append(kd)
    # K7's f32 mode with int8 weights: no path gives it (an f32 BERT's int8
    # weights dequantize inline), so these lines stay out of the kernels line;
    # M300 K776 N200 takes the cp.async loader (W's rows off 16 bytes)
    f32_lines = [check_dequant_f32(torch, pkg, gen, M=M, K=2048, N=2048) for M in (64, 1024)]
    f32_lines.append(check_dequant_f32(torch, pkg, gen, M=300, K=776, N=200))
    # serve_mesh's kernels at the per-rank shapes of {"data": 2, "model": 4}
    mesh_lines = mesh_kernel_lines(torch, pkg)
    kernels += mesh_lines
    # serve_7b's kernels at Llama-7B's shapes (and Llama-3-8B's where they differ)
    kernels += serve_7b_kernel_lines(torch, pkg)
    for kd in kernels + [fp8_b64] + f32_lines:
        emit({"phase": "kernel", **{k: kd[k] for k in ("name", "max_abs_err", "tolerance", "ms",
                                                       "device_ms", "tflops", "plain_ms",
                                                       "bound_ms", "bound_by", "library_ms",
                                                       "library_device_ms", "cublas_device_ms",
                                                       "w_gbps", "producer", "plan",
                                                       "smem_bytes",
                                                       "host_ms", "gbps", "vector_bytes",
                                                       "torch_calls_device_ms",
                                                       "repeat_bit_equal")
                                       if k in kd}})
    kernels += train_kernels(torch, pkg, gen)

    # each main path's launches: counts set to 0 just before it, read after
    launches = serve(torch, pkg)
    launches["prefill_phases"] = prefill_phases(torch, pkg)
    train_agreement(torch, pkg)
    launches["train"] = train(torch, pkg)
    launches["analysis"] = analysis(torch, pkg)
    launches["surgery"] = surgery(torch, pkg)
    launches["ring"], ring_lines = ring(torch, pkg)
    kernels += ring_lines
    launches["train_mesh"], launches["serve_mesh"] = train_mesh(torch, pkg)
    launches["serve_7b"] = serve_7b(torch, pkg)
    for kd in kernels:
        counter = kd.pop("counter")
        kd["launches"] = launches[kd.pop("path")][counter]
        kd["launches_analysis"] = launches["analysis"][counter]
        kd["launches_surgery"] = launches["surgery"][counter]
        kd["launches_train_mesh"] = launches["train_mesh"].get(counter, 0)
        kd["launches_serve_mesh"] = launches["serve_mesh"][counter]
        kd["launches_serve_7b"] = launches["serve_7b"][counter]
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
