"""Time kernels K3 (cache_append) and K4 (tail_append, both
``csrc/cache_update.cu``) on the card at their serving lines, beside the
per-tensor PyTorch calls that compute the same writes.

The lines are ``chip_smoke.py``'s (``LINES``): K3 with int8 k and v values
and their f32 scale planes at NL22 KVH4 S512 D64, B4 (the step path's pool)
and B256; K4 with bf16 k and v at NL22 KVH4 W64 D64, B64 (the fused loop's
batch) and B256. Each line draws its inputs from its own seed
(``line_inputs``). For each line the script prints one JSON line: the
wrapper's time by CUDA events (``ms``, median of ``--runs`` single calls,
host dispatch included), the kernel's device time (``device_ms``, mean of
``--runs`` calls under ``torch.profiler``), ``host_ms`` = ``ms`` -
``device_ms``; the host clock's time of one call, which only queues the
launch (``call_us`` for the wrapper, ``op_call_us`` for the operator
called with the same tensors, medians of 200 calls), the achieved GB/s (new rows read and written once, over
``device_ms``), each tensor's vector width in bytes where the checkout
reports it, and the device time of the PyTorch calls that compute the
same writes, one a tensor (``torch_calls_device_ms``: ``index_put_`` with
(b, positions) for K3, ``select(3, index).copy_`` for K4); and whether the
kernel's result is bit-exact with the plain version. The first line names
the card and its power limit, and gives the host clock's time of an
operator call that takes no tensor (``torch.ops.fasn.qmm_stage_k``), the
floor of any ``torch.ops`` call.

Usage (on the machine with the card)::

    python flash_attention_softmax_n_tpu_torch/utils/bench_cache_update.py
    # another checkout's K3 and K4 at the same inputs, for example the
    # parent commit unpacked by `git archive` into a git-ignored directory
    python flash_attention_softmax_n_tpu_torch/utils/bench_cache_update.py --root tmp_parent
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

__all__ = ["LINES", "line_name", "line_inputs", "line_calls", "line_bytes", "main"]

# (kernel, NL, B, KVH, S or W, D, seed)
LINES = (
    ("cache_append", 22, 4, 4, 512, 64, 901),
    ("cache_append", 22, 256, 4, 512, 64, 902),
    ("tail_append", 22, 64, 4, 64, 64, 903),
    ("tail_append", 22, 256, 4, 64, 64, 904),
)
# the ring index of K4's lines
TAIL_INDEX = 37


def line_name(line) -> str:
    kernel, NL, B, KVH, S, D, _ = line
    if kernel == "cache_append":
        return f"cache_append NL{NL} B{B} KVH{KVH} S{S} D{D} int8+scales"
    return f"tail_append NL{NL} B{B} KVH{KVH} W{S} D{D} bf16"


def line_inputs(line, device="cuda"):
    """(caches, news, positions or the ring index) of one line: K3's int8 k
    and v caches with (..., 1) f32 scale planes, random new rows and
    positions in [0, S); K4's bf16 k and v rings and new rows."""
    kernel, NL, B, KVH, S, D, seed = line
    gen = torch.Generator(device=device).manual_seed(seed)
    if kernel == "tail_append":
        caches = tuple(torch.randn((NL, B, KVH, S, D), generator=gen, device=device)
                       .to(torch.bfloat16) for _ in range(2))
        news = tuple(torch.randn((NL, B, KVH, D), generator=gen, device=device)
                     .to(torch.bfloat16) for _ in range(2))
        return caches, news, TAIL_INDEX
    caches, news = [], []
    for _ in range(2):
        caches.append(torch.randint(-128, 128, (NL, B, KVH, S, D), generator=gen,
                                    device=device).to(torch.int8))
        caches.append(torch.rand((NL, B, KVH, S, 1), generator=gen, device=device))
        news.append(torch.randint(-128, 128, (NL, B, KVH, D), generator=gen,
                                  device=device).to(torch.int8))
        news.append(torch.rand((NL, B, KVH, 1), generator=gen, device=device))
    pos = torch.randint(0, S, (B,), generator=gen, device=device).to(torch.int32)
    return tuple(caches), tuple(news), pos


def line_calls(cu, line, caches, news, where):
    """(kernel, plain, torch_calls) of one line on these caches: the
    wrapper, its plain version and the per-tensor PyTorch calls, each
    writing in place."""
    if line[0] == "tail_append":
        def torch_calls():
            for c, nw in zip(caches, news):
                c.select(3, where).copy_(nw)

        return (lambda: cu.tail_append(*caches, *news, where),
                lambda: cu.tail_append_reference(*caches, *news, where), torch_calls)
    b = torch.arange(where.shape[0], device=where.device)
    pos = where.long()
    # (NL, B, KVH, D) rows as (B, NL, KVH, D), the order of c[:, b, :, pos]
    rows = [nw.permute(1, 0, 2, 3) for nw in news]

    def torch_calls():
        for c, r in zip(caches, rows):
            torch.ops.aten.index_put_(c, [None, b, None, pos], r)

    return (lambda: cu.cache_append(caches, news, where),
            lambda: cu.cache_append_reference(caches, news, where), torch_calls)


def line_bytes(news, positions) -> int:
    """bytes the writes must move: every new row read once and written
    once, and K3's positions read once"""
    rows = sum(nw.numel() * nw.element_size() for nw in news)
    return 2 * rows + (positions.numel() * 4 if torch.is_tensor(positions) else 0)


def _events_ms(fn, runs):
    """median of ``runs`` single calls, each timed with CUDA events"""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)[runs // 2]


def _host_us(fn, runs=200):
    """median host-clock us of one call; the calls queue their launches and
    the device keeps up, so this is the host's own work"""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    return sorted(times)[runs // 2] / 1e3


def _device_ms(fns, runs):
    """mean device ms per call of every kernel each fn launches, under
    ``torch.profiler``, one fn after another in one session"""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, fn in enumerate(fns):
            with record_function(f"bench_{i}"):
                for _ in range(runs):
                    fn()
                torch.cuda.synchronize()
    events = prof.events()
    spans = {e.name: e.time_range for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith("bench_")}
    out = []
    for i in range(len(fns)):
        span = spans[f"bench_{i}"]
        us = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                 and span.start <= e.time_range.start <= span.end)
        out.append(us / 1e3 / runs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="import the port from this directory (default: this checkout)")
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_cache_update: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    from flash_attention_softmax_n_tpu_torch.kernels import _build
    from flash_attention_softmax_n_tpu_torch.kernels import cache_update as cu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    ops = _build.ops()
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
                      "root": str(root),
                      "torch_ops_floor_us": _host_us(lambda: ops.qmm_stage_k(1))}), flush=True)
    for line in LINES:
        caches, news, where = line_inputs(line)
        want = tuple(c.clone() for c in caches)
        kernel, _, torch_calls = line_calls(cu, line, caches, news, where)
        _, plain, _ = line_calls(cu, line, want, news, where)
        kernel()
        plain()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(caches, want))
        if line[0] == "tail_append":
            def op():
                ops.tail_append(*caches, *news, where)
        else:
            def op():
                ops.cache_append(caches, news, where)
        dev, lib = _device_ms([kernel, torch_calls], args.runs)
        ms = _events_ms(kernel, args.runs)
        gbytes = line_bytes(news, where) / 1e9
        vec = ([ops.cache_vector_bytes(c, nw) for c, nw in zip(caches, news)]
               if hasattr(ops, "cache_vector_bytes") else None)
        print(json.dumps({"root": root.name, "line": line_name(line), "bit_exact": exact,
                          "ms": ms, "device_ms": dev,
                          "host_ms": ms - dev, "call_us": _host_us(kernel),
                          "op_call_us": _host_us(op), "gbps": gbytes / (dev * 1e-3),
                          "vector_bytes": vec, "torch_calls_device_ms": lib}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
