"""Where does prefill attention time go? Times attention stripped down phase
by phase on the card.

Counterpart of ``scripts/profile_prefill_phases.py``. At one shape (B2 H32
L2048 hd64 bf16 unless ``--shape`` says otherwise) it times the four modes
of kernel K10 (``kernels/prefill_phases.py``: ``dots_only`` QK^T -> PV,
``exp_only`` with exp(s), ``softmax`` with the row max and sum,
``mask_softmax`` with the causal mask too) and the real forward K1
(``flash_attention_n``, n = 1) without and with the causal mask. Each phase
prints one JSON line: ms per call (mean of ``--iters`` calls, CUDA events),
TFLOP/s over the full score rectangle (4·B·H·L²·hd operations) and the share
of ``attention_roofline``'s least time that the call reaches. The first
line names the card and its power limit.

Usage::

    python -m flash_attention_softmax_n_tpu_torch.utils.profile_prefill_phases
    python -m flash_attention_softmax_n_tpu_torch.utils.profile_prefill_phases \\
        --shape 2,32,2048,128

``--device cpu`` runs the plain versions at a small shape to check the
script; its times are host times, not device times.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Dict, List, Optional, Sequence

import torch

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.kernels.prefill_phases import MODES, mini
from flash_attention_softmax_n_tpu_torch.ops.flash_attention import flash_attention_n
from flash_attention_softmax_n_tpu_torch.utils.profiling import (
    H100,
    attention_roofline,
    card_description,
    measure,
)

__all__ = ["PHASES", "run", "main"]

PHASES = MODES + ("full_nomask", "full_causal")
CAUSAL = ("mask_softmax", "full_causal")


def _phase_fn(name: str):
    if name in MODES:
        return functools.partial(mini, name)
    return functools.partial(flash_attention_n, softmax_n_param=1.0,
                             is_causal=name == "full_causal")


def run(shape: Sequence[int] = (2, 32, 2048, 64), *, device=None,
        iters: int = 10) -> List[Dict]:
    """Time each phase at ``shape`` (B, H, L, hd), bf16 inputs 0.3·N(0, 1)
    from seed 0; returns the JSON lines, the card's first."""
    dev = resolve_device(device)
    b, h, l, hd = (int(x) for x in shape)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = ((0.3 * torch.randn((b, h, l, hd), generator=gen, device=dev))
               .to(torch.bfloat16) for _ in range(3))
    rect = 4.0 * b * h * l * l * hd
    lines = [{"hw": card_description(dev), "device": str(dev),
              "timer": "cuda events" if dev.type == "cuda" else "host clock",
              "shape": f"B{b} H{h} L{l} hd{hd} bf16", "rect_gflop": rect / 1e9,
              "iters": iters}]
    with torch.inference_mode():
        for name in PHASES:
            secs = measure(_phase_fn(name), q, k, v, iters=iters)
            roof = attention_roofline(b, h, l, l, hd, causal=name in CAUSAL,
                                      chip=H100)
            lines.append({"name": name, "ms": secs * 1e3,
                          "tf_s": rect / secs / 1e12,
                          "roofline_ms": roof["sol_time"] * 1e3,
                          "roofline_share": roof["sol_time"] / secs})
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="2,32,2048,64",
                    help="B,H,L,hd (default 2,32,2048,64)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the card unless told otherwise ('cpu': plain versions)")
    args = ap.parse_args(argv)
    shape = [int(x) for x in args.shape.split(",")]
    if len(shape) != 4:
        ap.error("--shape takes four integers B,H,L,hd")
    for line in run(shape, device=args.device, iters=args.iters):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
