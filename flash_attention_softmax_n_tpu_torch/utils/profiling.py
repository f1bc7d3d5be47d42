"""Profiling and roofline helpers for the port on an NVIDIA card.

Counterpart of ``flash_attention_softmax_n_tpu/utils/profiling.py``:

  * ``ChipSpec`` and ``H100``, the card's published peaks, and
    ``card_description``, the card's name and power limit;
  * ``trace(path)``: a ``torch.profiler`` window written as a Chrome trace;
  * ``measure(fn, *args)``: mean seconds per call, timed with CUDA events
    when the call returns CUDA tensors, with the host clock otherwise (a
    host time, never a device time);
  * ``pytree_bytes``, ``estimate_decode_hbm_bytes`` and
    ``check_decode_hbm_fit``: resident-memory arithmetic for a decode
    engine (the JAX package's estimate; the budget defaults to the card's
    memory, where the JAX package fenced a TPU compiler fault with a fixed
    12.5 GB);
  * ``attention_roofline``: the least time one attention forward could
    take on a chip.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Callable, Optional

import torch

from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor

__all__ = ["ChipSpec", "H100", "card_description", "trace", "measure",
           "pytree_bytes", "estimate_decode_hbm_bytes",
           "check_decode_hbm_fit", "attention_roofline"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_flops: float  # peak dense bf16 FLOP/s
    int8_ops: float    # peak dense int8 OP/s
    hbm_bw: float      # device-memory bytes/s
    # peak dense TF32 FLOP/s (K5's and K6's split-TF32 f32 kernels take three
    # TF32 operations for each f32 one); None where the chip has no TF32
    tf32_flops: Optional[float] = None


# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
H100 = ChipSpec("H100 SXM", 989e12, 1979e12, 3.35e12, 495e12)


def card_description(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (a card
    may be set below its full power and then runs slower), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


@contextlib.contextmanager
def trace(path: str):
    """Profile the enclosed work (CPU, and the card when there is one) and
    write a Chrome trace to ``path`` (open in Perfetto or chrome://tracing).
    Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def measure(fn: Callable, *args, iters: int = 10, **kwargs) -> float:
    """Mean seconds per call of ``fn(*args, **kwargs)`` after one warm-up
    call: CUDA events around the ``iters`` calls when the result is a CUDA
    tensor, else the host clock."""
    out = fn(*args, **kwargs)
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return (time.perf_counter() - t0) / iters


def pytree_bytes(tree) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples, a QTensor
    counting its values and scales."""
    if isinstance(tree, QTensor):
        return pytree_bytes((tree.values, tree.scales))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(pytree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_bytes(v) for v in tree)
    return 0


def estimate_decode_hbm_bytes(cfg, batch: int, max_len: int,
                              kv_quantization, params_bytes: int) -> dict:
    """Resident device memory of a continuous-batching decode engine:
    weights, the KV cache (k and v, one f32 scale per token and head when
    quantized) and a workspace term for the largest transients (prefill
    logits of an admission group of 8 x 128 tokens, layer activations,
    attention statistics). Meant to be roughly right with a margin, not
    exact."""
    kv_bytes_per = {None: 2, "int8": 1, "fp8": 1}.get(kv_quantization, 1)
    scale_bytes = 0 if kv_quantization is None else 4
    kv = (cfg.n_layers * batch * cfg.n_kv_heads * max_len
          * (cfg.head_dim * kv_bytes_per + scale_bytes) * 2)
    workspace = (batch * cfg.d_model * 4 * 8
                 + 8 * min(128, max_len) * cfg.vocab_size * 4
                 + batch * cfg.n_heads * max_len * 4)
    total = params_bytes + kv + workspace
    return {"params": params_bytes, "kv_cache": kv,
            "workspace": workspace, "total": total}


def check_decode_hbm_fit(cfg, batch: int, max_len: int, kv_quantization,
                         params_bytes: int,
                         budget_bytes: Optional[int] = None) -> dict:
    """Raise when a decode configuration cannot fit the card's memory;
    return the estimate when it fits. ``budget_bytes`` defaults to the
    current card's memory."""
    if budget_bytes is None:
        budget_bytes = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    est = estimate_decode_hbm_bytes(cfg, batch, max_len, kv_quantization,
                                    params_bytes)
    if est["total"] > budget_bytes:
        gb = 2 ** 30
        raise RuntimeError(
            f"decode config will not fit device memory: params "
            f"{est['params'] / gb:.1f} GB + KV cache "
            f"{est['kv_cache'] / gb:.1f} GB (batch={batch}, "
            f"max_len={max_len}, kv={kv_quantization or 'dense'}) + "
            f"workspace {est['workspace'] / gb:.1f} GB = "
            f"{est['total'] / gb:.1f} GB > budget {budget_bytes / gb:.1f} GB. "
            f"Reduce batch or max_len, or quantize the KV cache.")
    return est


def attention_roofline(batch: int, heads: int, q_len: int, kv_len: int,
                       head_dim: int, *, causal: bool = False,
                       dtype_bytes: int = 2, chip: ChipSpec = H100) -> dict:
    """Least time of one flash-attention forward on ``chip``: flops (4·d
    per (query, key) pair, half the square when causal), bytes (q, k, v and
    o once), each over its peak, and the larger of the two.
    ``percent_of_sol(measured_s)`` is that time over a measured one, in
    percent."""
    frac = 0.5 if causal and q_len == kv_len else 1.0
    flops = 4 * batch * heads * q_len * kv_len * head_dim * frac
    bytes_accessed = dtype_bytes * batch * heads * (
        2 * q_len * head_dim + 2 * kv_len * head_dim)
    t_compute = flops / chip.bf16_flops
    t_memory = bytes_accessed / chip.hbm_bw
    sol = max(t_compute, t_memory)
    return {
        "flops": flops,
        "bytes": bytes_accessed,
        "t_compute": t_compute,
        "t_memory": t_memory,
        "sol_time": sol,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "percent_of_sol": lambda measured: 100.0 * sol / measured,
    }
