"""Time kernel K8 (decode attention statistics, ``csrc/decode_attn.cu``) on
the card at its serving lines, by split length and product design.

The lines are ``chip_smoke.py``'s five K8 lines (``LINES``): B64 S512 with
int8, bf16 and fp8 caches, and fp8 at B8 S256 and B2 S512, bf16 q, KVH 4,
G 8, hd 64. Each line draws its inputs from its own seed
(``line_inputs``), so that the smoke's line and this script's see the same
slot lengths. For each line the script prints one JSON line for the
planned call (``_decode_attn_cuda``: the plan's split length and products)
and, with ``--sweep``, one for every split length and product design the
kernel takes (``FMA``: f32 FMAs; ``MMA``: mma.sync in bf16). Each gives the
device ms of the split kernel and of the merge (mean of ``--runs`` calls
under ``torch.profiler``) and the largest error of acc / l against the
plain version. The first line names the card and its power limit.

Usage (on the machine with the card)::

    python flash_attention_softmax_n_tpu_torch/utils/bench_decode_attn.py --sweep
    # another checkout's K8 at the same inputs, for example the parent
    # commit unpacked by `git archive` into a git-ignored directory
    python flash_attention_softmax_n_tpu_torch/utils/bench_decode_attn.py --root tmp_parent

``--root`` imports the port from that directory; a checkout whose K8 has
no product designs gives the planned line only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

__all__ = ["LINES", "line_inputs", "main"]

# (B, KVH, G, S, hd, cache, seed)
LINES = (
    (64, 4, 8, 512, 64, "int8", 801),
    (64, 4, 8, 512, 64, "bf16", 802),
    (64, 4, 8, 512, 64, "fp8", 803),
    (8, 4, 8, 256, 64, "fp8", 804),
    (2, 4, 8, 512, 64, "fp8", 805),
)
KERNELS = ("decode_attn_split_kernel", "decode_attn_merge_kernel")


def line_inputs(kv_cache, line, device="cuda"):
    """(q, k, v, k_scales, v_scales, lengths, full caches) of one line: a
    one-layer view (layer 1 of 2) of an int8 or fp8 (with scales) or bf16
    cache, bf16 q scaled by hd^-0.5, lengths drawn from 0..S with slot 0
    empty and slot 1 full."""
    B, KVH, G, S, D, cache, seed = line
    gen = torch.Generator(device=device).manual_seed(seed)
    full = [torch.randn((2, B, KVH, S, D), generator=gen, device=device) for _ in range(2)]
    if cache in ("int8", "fp8"):
        (kq, ksf), (vq, vsf) = (kv_cache.quantize_kv(t, 8 if cache == "int8" else -8)
                                for t in full)
        k, v, ks, vs = kq[1], vq[1], ksf[1], vsf[1]
    else:
        k, v = (t.to(torch.bfloat16)[1] for t in full)
        ks = vs = None
    q = (torch.randn((B, KVH, G, D), generator=gen, device=device) * D ** -0.5).to(torch.bfloat16)
    lengths = torch.randint(0, S + 1, (B,), generator=gen, device=device).to(torch.int32)
    lengths[0] = 0
    lengths[1] = S
    return q, k, v, ks, vs, lengths, full


def _kernel_ms(fn, runs):
    """device ms per call of each of K8's two kernels under torch.profiler"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in KERNELS:
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name)
        out[name] = us / 1e3 / runs
    return out


def _err(got, want, lengths):
    live = lengths > 0
    acc, _, l = got
    acc_r, _, l_r = want
    return float((acc[live] / l[live][..., None]
                  - acc_r[live] / l_r[live][..., None]).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="import the port from this directory (default: this checkout)")
    ap.add_argument("--sweep", action="store_true",
                    help="also every split length and product design the kernel takes")
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_decode_attn: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    from flash_attention_softmax_n_tpu_torch.kernels import _build
    from flash_attention_softmax_n_tpu_torch.kernels import decode_attention as da
    from flash_attention_softmax_n_tpu_torch.quant import kv_cache

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
                      "root": str(root)}), flush=True)
    ops = _build.ops()
    designs = hasattr(da, "decode_attn_products")
    for line in LINES:
        B, KVH, G, S, D, cache, _ = line
        q, k, v, ks, vs, lengths, _ = line_inputs(kv_cache, line)
        want = da.decode_attn_stats_reference(q, None, k, v, lengths, ks, vs)
        head = {"root": root.name, "line": f"B{B} S{S} {cache}",
                "positions": int(lengths.sum())}
        planned = {}
        if hasattr(da, "decode_attn_plan"):
            planned["split"] = da.decode_attn_plan(B, KVH, S, D, k.element_size(), False)
        if designs:
            planned["products"] = da.decode_attn_products(q.dtype, k.dtype, D)

        def plan_call():
            return da._decode_attn_cuda(q, None, k, v, lengths, ks, vs)

        ms = _kernel_ms(plan_call, args.runs)
        print(json.dumps({**head, "call": "plan", **planned, "device_ms": sum(ms.values()),
                          "split_ms": ms[KERNELS[0]], "merge_ms": ms[KERNELS[1]],
                          "max_abs_err": _err(plan_call(), want, lengths)}), flush=True)
        if not (designs and args.sweep):
            continue
        for products in (da.FMA, da.MMA):
            for sp in da.SPLITS:
                n = -(-S // sp)
                outs = [torch.empty(s, device="cuda") for s in (
                    (B, KVH, G, D), (B, KVH, G), (B, KVH, G), (B, KVH, n, G, D),
                    (B, KVH, n, G), (B, KVH, n, G))]

                def call():
                    ops.decode_attn(q, None, k, v, ks, vs, lengths, *outs, sp, products)
                    return outs[:3]

                first = [t.clone() for t in call()]
                same = all(torch.equal(a, b) for a, b in zip(first, call()))
                ms = _kernel_ms(call, args.runs)
                print(json.dumps({**head, "call": "sweep", "split": sp,
                                  "products": "mma" if products == da.MMA else "fma",
                                  "device_ms": sum(ms.values()), "split_ms": ms[KERNELS[0]],
                                  "merge_ms": ms[KERNELS[1]], "repeat_bit_equal": same,
                                  "max_abs_err": _err(first, want, lengths)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
