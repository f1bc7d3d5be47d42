"""Serve a softmax-1 decoder with the port's quantized continuous-batching
engine.

The PyTorch port's counterpart of ``examples/serve.py``: INT8 weight-only +
INT8 (or fp8) KV cache, slot admission, fused multi-step decode. On the
card it serves the TinyLlama-1.1B shape in bf16 (greedy chunks replay CUDA
graphs); ``--cpu`` serves a 2-layer f32 model through the kernels' plain
versions::

    python examples/torch_serve.py          # the card
    python examples/torch_serve.py --cpu    # the plain versions, on the CPU

Without a card and without ``--cpu`` it raises: nothing falls back to the
CPU by itself.
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--quant", default="int8", choices=["none", "int8", "fp8"])
    ap.add_argument("--loop-steps", type=int, default=16,
                    help="fused decode chunk between scheduling points; "
                         "0 = per-step decoding")
    args = ap.parse_args(argv)

    from flash_attention_softmax_n_tpu_torch._device import resolve_device
    from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
    from flash_attention_softmax_n_tpu_torch.models import (
        DecoderConfig,
        init_decoder_params,
    )
    from flash_attention_softmax_n_tpu_torch.quant import quantize_decoder_weights

    dev = resolve_device("cpu" if args.cpu else None)
    card = dev.type == "cuda"
    cfg = DecoderConfig(
        vocab_size=32000, d_model=2048 if card else 256,
        n_layers=22 if card else 2, n_heads=32 if card else 8,
        n_kv_heads=4, d_ff=5632 if card else 512,
        max_seq_len=2048 if card else 128,
        softmax_n=1.0, dtype=torch.bfloat16 if card else torch.float32,
    )
    print(f"init {cfg.n_layers}-layer softmax-{cfg.softmax_n:g} decoder on {dev}")
    params = init_decoder_params(cfg, 0, device=dev)
    if args.quant != "none":
        params = quantize_decoder_weights(params, bits=8)

    eng = InferenceEngine(
        cfg, params, max_batch=args.batch, max_len=cfg.max_seq_len,
        kv_quantization=None if args.quant == "none" else args.quant, device=dev)

    gen = torch.Generator().manual_seed(1)
    for _ in range(args.batch * 2):  # oversubscribe: exercises re-admission
        n = int(torch.randint(4, 48, (), generator=gen))
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
        eng.submit(prompt, max_new_tokens=32)

    t0 = time.perf_counter()
    finished = eng.run_until_done(loop_steps=args.loop_steps or None)
    if card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in finished)
    print(f"served {len(finished)} requests, {total} tokens "
          f"in {dt:.2f}s -> {total / dt:.0f} tok/s")
    for r in finished[:3]:
        print(f"  req {r.request_id}: {r.output[:8]}...")
    return finished


if __name__ == "__main__":
    main()
