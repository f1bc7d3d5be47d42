"""K1's lines on the card, for one or more checkouts side by side.

``--roots`` times the f32 attention lines of ``chip_smoke.py``'s
``head_dims`` phase, K1, K5 and K6 at B2 H8 L=S=1024 causal, n 1, at D 256,
384 and 512 (``chip_smoke.train_kernel_lines``, 10 calls a time), for each
root in turn, each in a process of its own that builds that root's kernels
and imports that root's ``chip_smoke``: this checkout, or another unpacked
by ``git archive`` into a ``tmp_*`` directory, so that two versions compare
inside one call (parent, change, change, parent)::

    python flash_attention_softmax_n_tpu_torch/utils/flash_lines.py --roots tmp_parent . . tmp_parent

``--seeds N`` reads ``chip_smoke.check_flash``'s bf16 K1 margins at its
d300 and d640 lines (B32 H16 L=S=512 causal, n 1) over the inputs of N
seeds: for each, the kernel's and the plain version's ``o_excess`` against
the float64 evaluation (``chip_smoke.fwd_float64``) and their mutual max
|o - plain| - 2^-7 |o_plain|, which ``check_flash`` holds to 2e-3.

Each result is one JSON line on stdout, with the card's name and power
limit; ``--out`` appends them to a file too. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
F32_DIMS = (256, 384, 512)
# check_flash's shape of the head_dims K1 lines, and the bf16 head dims read
SEED_SHAPE = dict(B=32, H=16, L=512)
SEED_DIMS = (300, 640)


def _smoke(root: Path):
    """root's chip_smoke, set up as its main() sets it up, and its port"""
    import torch

    sys.path.insert(0, str(root))
    import chip_smoke

    pkg = chip_smoke.load_port()
    chip_smoke.K8_LINES = pkg["bench_decode_attn"].LINES
    chip_smoke.CHIP = pkg["profiling"].H100
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg["build"].build()
    pkg["build"].ops()
    return chip_smoke, pkg


def _card(pkg) -> str:
    import torch

    return pkg["profiling"].card_description(torch.device("cuda", 0))


def time_root(root: Path):
    """the f32 lines of one root, as JSON-ready dicts"""
    import torch

    chip_smoke, pkg = _smoke(root)
    gen = torch.Generator(device="cuda").manual_seed(256)
    out = []
    for d in F32_DIMS:
        lines = chip_smoke.train_kernel_lines(torch, pkg, gen, B=2, H=8, L=1024, D=d, rate=0.0,
                                              path="head_dims", runs=10, dtype=torch.float32)
        for line in lines:
            out.append({"root": str(root), "d": d, "card": _card(pkg), **{
                k: line.get(k) for k in ("name", "source", "launched", "ms", "device_ms",
                                         "tflops", "bound_ms", "bound_ms_f32_fma",
                                         "plain_ms", "library_ms", "library_device_ms",
                                         "max_abs_err")}})
    return out


def seed_margins(seeds: int):
    """check_flash's bf16 K1 margins over ``seeds`` seeds' inputs"""
    import torch

    chip_smoke, pkg = _smoke(HERE)
    fa = pkg["flash_attention"]
    B, H, L = SEED_SHAPE["B"], SEED_SHAPE["H"], SEED_SHAPE["L"]
    ex = {"bias": None, "slopes": None, "seed": None, "dropout_rate": 0.0}
    out = []
    for d in SEED_DIMS:
        for seed in range(seeds):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v = (torch.randn((B, H, L, d), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            kw = dict(n=1.0, scale=d ** -0.5, is_causal=True)
            o, _ = fa.flash_fwd(q, k, v, None, **kw)
            o_ref, _ = fa.flash_fwd_reference(q, k, v, None, **kw)
            o64, o_abs64 = chip_smoke.fwd_float64(torch, fa, q, k, v, ex, n=1.0, causal=True)
            mutual = float(((o.float() - o_ref.float()).abs()
                            - 2.0 ** -7 * o_ref.float().abs()).max())
            out.append({"d": d, "seed": seed, "card": _card(pkg),
                        "o_excess_kernel": chip_smoke.o_excess(o, o64, o_abs64),
                        "o_excess_plain": chip_smoke.o_excess(o_ref, o64, o_abs64),
                        "mutual_excess": mutual})
            del o64, o_abs64
    return out


def _emit(rows, out):
    for row in rows:
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="*", default=[], help="checkouts to time, in turn")
    ap.add_argument("--seeds", type=int, default=0, help="seeds of the bf16 margins")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="append the JSON lines here too")
    args = ap.parse_args(argv)
    if args.one is not None:
        _emit(time_root(Path(args.one).resolve()), args.out)
        return 0
    for root in args.roots:
        # a process a root: each imports its own package under one name
        cmd = [sys.executable, __file__, "--one", root] + (["--out", args.out] if args.out
                                                           else [])
        if subprocess.run(cmd).returncode != 0:
            print(f"flash_lines: {root} failed", file=sys.stderr)
            return 1
    if args.seeds:
        _emit(seed_margins(args.seeds), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
