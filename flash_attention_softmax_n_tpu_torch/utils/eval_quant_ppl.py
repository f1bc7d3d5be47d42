"""Quantization quality on a trained checkpoint, after
``scripts/eval_quant_ppl.py``.

With no network there is no public checkpoint, so the script trains its
own:

  1. corpus: every ``.py`` and ``.md`` file of the repo, byte-level (vocab
     256), sorted, joined by blank lines; the last 5% held out;
  2. a small softmax-1 Llama-style decoder (d_model 192, 3 layers, 6 heads
     over 2 KV heads of head dim 32, SwiGLU d_ff 512, RoPE; f32,
     ``attn_implementation="xla"``) trained for ``--steps`` AdamW steps
     (optax's ``adamw(warmup_cosine_decay_schedule(0, 3e-3, warmup,
     steps), weight_decay=0.01)``, ``train_quant_study.OptaxAdamW``) on B16
     x L192 windows;
  3. held-out perplexity: dense f32, int8 weights and grouped int4 weights
     (the full forward; on the card the int4 ``w_down``, K = 512, takes
     K7's f32 mode, the other int4 weights dequantize inline as JAX's
     ``_mm`` routes them), and int8 weights with an int8 KV cache through
     the cached decode path (teacher-forced ``decode_step``), against the
     same loop with a dense cache;
  4. the result to ``artifacts/torch_quant_ppl.json``.

Usage (the card by default; without one it raises unless given ``--cpu``)::

    python -m flash_attention_softmax_n_tpu_torch.utils.eval_quant_ppl [--steps 700] [--seed 0]
    python -m flash_attention_softmax_n_tpu_torch.utils.eval_quant_ppl --cpu --steps 20 --out /tmp/q.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

if __name__ == "__main__":  # run as a file: import the port beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.models.decoder import (
    DecoderConfig,
    init_decoder_params,
)
from flash_attention_softmax_n_tpu_torch.parallel.train import init_train_state
from flash_attention_softmax_n_tpu_torch.quant.weights import (
    quantize_decoder_weights,
)
from flash_attention_softmax_n_tpu_torch.utils.profiling import (
    card_description,
)
from flash_attention_softmax_n_tpu_torch.utils.train_quant_study import (
    REPO,
    OptaxAdamW,
    cached_decode_ppl,
    detached,
    held_out_windows,
    quantized_perplexities,
    sample_batch,
    train_step,
)

__all__ = ["SEQ", "BATCH", "load_corpus", "batches", "eval_batches",
           "ppl_config", "train", "score", "main"]

SEQ = 192
BATCH = 16


def load_corpus(root: Optional[Path] = None) -> np.ndarray:
    """Every ``.py`` then every ``.md`` file under ``root`` (the repo),
    sorted, outside ``.git`` and ``results``, joined by blank lines, as
    int32 bytes."""
    root = REPO if root is None else Path(root)
    parts = []
    for pat in ("**/*.py", "**/*.md"):
        for f in sorted(root.glob(pat)):
            if ".git" in f.parts or "results" in f.parts:
                continue
            try:
                parts.append(f.read_bytes())
            except OSError:
                pass
    return np.frombuffer(b"\n\n".join(parts), np.uint8).astype(np.int32)


def batches(data: np.ndarray, rng: np.random.RandomState,
            n: int) -> Iterator[np.ndarray]:
    """``n`` training batches of B16 x L192 windows at offsets from ``rng``."""
    for _ in range(n):
        yield sample_batch(rng, data, BATCH, SEQ)


def eval_batches(data: np.ndarray, n: int) -> List[np.ndarray]:
    """``n`` batches of disjoint windows over the held-out tail."""
    return held_out_windows(data, n, SEQ, BATCH)


def ppl_config() -> DecoderConfig:
    return DecoderConfig(vocab_size=256, d_model=192, n_layers=3, n_heads=6,
                         n_kv_heads=2, d_ff=512, max_seq_len=SEQ,
                         softmax_n=1.0, dtype=torch.float32,
                         attn_implementation="xla")


def train(params: Dict, cfg: DecoderConfig, data: np.ndarray, steps: int,
          seed: int):
    """``steps`` AdamW steps in place from ``params`` (f32, requiring no
    gradient yet); returns (params, optimizer, losses as floats)."""
    warmup = min(50, max(1, steps // 10))
    params, opt = init_train_state(params, lambda leaves: OptaxAdamW(
        leaves, lr=3e-3, warmup=warmup, steps=steps, weight_decay=0.01,
        clip_norm=None))
    dev = params["embed"].device
    rng = np.random.RandomState(seed)
    losses, t0 = [], time.time()
    for i, toks in enumerate(batches(data, rng, steps)):
        loss = train_step(params, opt, cfg, torch.from_numpy(toks).to(dev),
                          cast=lambda p: p)
        losses.append(loss)
        if i % 100 == 0 or i == steps - 1:
            print(f"step {i:5d} loss {float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    return params, opt, [float(x) for x in losses]


def score(params: Dict, cfg: DecoderConfig, ev: List[np.ndarray],
          dec_ev: List[np.ndarray]) -> Dict[str, float]:
    """Dense, int8-W and int4-W perplexity over ``ev``; cached decode,
    dense against int8 W + int8 KV, over ``dec_ev``."""
    params = detached(params)
    q = quantized_perplexities(params, cfg, ev, w8a8=False)
    out = {"ppl_dense_f32": q["ppl_dense"]}
    for bits in (8, 4):
        out[f"ppl_int{bits}_w"] = q[f"ppl_int{bits}_w"]
        out[f"delta_int{bits}_w"] = q[f"delta_int{bits}_w"]
    qp8 = quantize_decoder_weights(params, bits=8)
    dense = cached_decode_ppl(params, cfg, dec_ev, None)
    quant = cached_decode_ppl(qp8, cfg, dec_ev, "int8")
    out["ppl_decode_dense"] = dense
    out["ppl_decode_int8w_int8kv"] = quant
    out["delta_int8w_int8kv"] = quant - dense
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-eval-batches", type=int, default=1)
    ap.add_argument("--out", default=None,
                    help="default artifacts/torch_quant_ppl.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device("cpu") if args.cpu else resolve_device()

    data = load_corpus()
    split = int(len(data) * 0.95)
    train_data, held = data[:split], data[split:]
    print(f"corpus: {len(data)} bytes ({split} train / {len(held)} eval)",
          file=sys.stderr, flush=True)
    cfg = ppl_config()
    t0 = time.time()
    params, _, losses = train(init_decoder_params(cfg, args.seed, device=dev),
                              cfg, train_data, args.steps, args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.time() - t0
    ev = eval_batches(held, 4)
    results = {"config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                          "softmax_n": cfg.softmax_n, "seq": SEQ,
                          "train_steps": args.steps,
                          "corpus_bytes": int(len(data)),
                          "backend": dev.type, "card": card_description(dev)},
               "train_seconds": train_s, "loss_first": losses[0],
               "loss_last": losses[-1],
               **score(params, cfg, ev, ev[:args.decode_eval_batches])}
    for bits in (8, 4):
        print(f"int{bits} weight-only: ppl {results[f'ppl_int{bits}_w']:.4f} "
              f"(D {results[f'delta_int{bits}_w']:+.4f})", file=sys.stderr)
    print(f"decode path: dense {results['ppl_decode_dense']:.4f} vs "
          f"int8W+int8KV {results['ppl_decode_int8w_int8kv']:.4f} "
          f"(D {results['delta_int8w_int8kv']:+.4f})", file=sys.stderr)
    out = Path(args.out) if args.out else REPO / "artifacts" / "torch_quant_ppl.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
