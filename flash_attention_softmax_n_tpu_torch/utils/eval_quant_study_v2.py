"""The quantization study's second evaluation, on held-out corpora that do
not saturate, after ``scripts/eval_quant_study_v2.py``.

The tail of the training walk is near-duplicate of what the model trained
on, so its perplexity sits at an entropy floor where quantization deltas
tell nothing apart. This script scores both study checkpoints (n = 0 and
n = 1) on three corpora of ``EVAL_MB`` MiB each:

  tail       the last 2% of the 64 MiB training corpus (the first
             evaluation's held-out set);
  unseen_py  the same walk's ``.py``/``.md`` files past the 64 MiB cut-off:
             the same distribution, never trained on, each file dropped when
             its content hash (sha1) matches a training file or an earlier
             file of this set;
  cpp        PyTorch's installed C++ headers
             (``torch.utils.cpp_extension.include_paths()``), a language the
             byte model never saw.

For each corpus: ppl/byte and bits/byte of dense, int8-W, int4-W and W8A8
(int8 weights and per-row int8 activations, K7's W8A8 mode), and cached
decode (dense against int8 W + int8 KV) over 2 of the 8 B32 x L512 batches.
As in the JAX script the model runs with the checkpoint's own config, the
f32 one that training saves: bf16-rounded weights in f32 compute (JAX
promotes the bf16 weights to f32 in each product; the port widens them to
f32 first, ``as_compute``, which gives the same values). So on the card K1
takes its f32 kernel and int4 and W8A8 take K7's f32-x and W8A8 modes.

Checkpoints are read from ``--ckpt-root``/n0 and /n1 (default
``results/torch_quant_study``, the port's trainer's); the JAX package's
(``results/quant_study``) load the same way. Results go to
``artifacts/torch_quant_study_v2.json``, rewritten after every (checkpoint,
corpus) cell, and a rerun skips the cells it holds.

Usage (the card by default; without one it raises unless given ``--cpu``)::

    python -m flash_attention_softmax_n_tpu_torch.utils.eval_quant_study_v2
    python -m flash_attention_softmax_n_tpu_torch.utils.eval_quant_study_v2 --ckpt-root results/quant_study
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

if __name__ == "__main__":  # run as a file: import the port beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.quant.weights import (
    quantize_decoder_weights,
)
from flash_attention_softmax_n_tpu_torch.utils.checkpoint import load_checkpoint
from flash_attention_softmax_n_tpu_torch.utils.profiling import (
    card_description,
)
from flash_attention_softmax_n_tpu_torch.utils.train_quant_study import (
    ARTIFACTS,
    RESULTS,
    as_compute,
    cached_decode_ppl,
    cast_bf16,
    corpus_record,
    held_out_windows,
    iter_corpus_files,
    quantized_perplexities,
    take_corpus,
)

__all__ = ["TRAIN_MB", "EVAL_MB", "SEQ", "BATCH", "cpp_roots",
           "build_corpora", "batches", "bits", "score_checkpoint", "main"]

TRAIN_MB = 64      # the training runs' corpus
EVAL_MB = 6        # each evaluation corpus
SEQ, BATCH = 512, 32
HEADER_SUFFIXES = (".h", ".hpp", ".cuh", ".hh")


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def cpp_roots() -> List[str]:
    """PyTorch's installed include directories, without those inside
    another (so no header is read twice)."""
    from torch.utils.cpp_extension import include_paths

    paths = [Path(p).resolve() for p in include_paths()]
    return [str(p) for p in paths
            if not any(q != p and q in p.parents for q in paths)]


def _bytes_of(parts: List[bytes], budget: int) -> np.ndarray:
    return np.frombuffer(b"\n\n".join(parts)[:budget], np.uint8).astype(np.int32)


def build_corpora(*, dirs: Optional[Sequence[str]] = None,
                  cpp_dirs: Optional[Sequence[str]] = None,
                  train_mb: int = TRAIN_MB, eval_mb: int = EVAL_MB):
    """({"tail", "unseen_py", "cpp"} int32 byte arrays, their records).

    ``tail`` is the last 2% of the ``train_mb`` training corpus; ``unseen_py``
    continues the training walk (over ``dirs``) where the budget stopped
    it, dropping files whose sha1 matches a training file or an earlier
    kept one; ``cpp`` is the sorted headers under ``cpp_dirs`` (default
    ``cpp_roots()``) of 256 bytes or more."""
    budget = train_mb * 1024 * 1024
    seen = set()
    total = 0
    stream = iter_corpus_files(dirs)
    for _, b in stream:
        seen.add(hashlib.sha1(b).hexdigest())
        total += len(b)
        if total >= budget:
            break
    data, _ = take_corpus(train_mb, dirs)
    tail = data[int(len(data) * 0.98):]

    ev_budget = eval_mb * 1024 * 1024
    parts, got, dropped = [], 0, 0
    for _, b in stream:  # continues where the training walk stopped
        hx = hashlib.sha1(b).hexdigest()
        if hx in seen:
            dropped += 1
            continue
        seen.add(hx)
        parts.append(b)
        got += len(b)
        if got >= ev_budget:
            break
    unseen = _bytes_of(parts, ev_budget)
    records = {"tail": {"bytes": int(len(tail))},
               "unseen_py": {**corpus_record(b"\n\n".join(parts)[:ev_budget],
                                             len(parts)),
                             "duplicates_dropped": dropped}}

    cparts, cgot = [], 0
    for root in cpp_roots() if cpp_dirs is None else cpp_dirs:
        for f in sorted(Path(root).glob("**/*")):
            if f.suffix not in HEADER_SUFFIXES:
                continue
            try:
                b = f.read_bytes()
            except OSError:
                continue
            if len(b) < 256:
                continue
            cparts.append(b)
            cgot += len(b)
            if cgot >= ev_budget:
                break
        if cgot >= ev_budget:
            break
    cpp = _bytes_of(cparts, ev_budget)
    records["cpp"] = corpus_record(b"\n\n".join(cparts)[:ev_budget],
                                   len(cparts))
    return {"tail": tail, "unseen_py": unseen, "cpp": cpp}, records


def batches(arr: np.ndarray, n_batches: int) -> List[np.ndarray]:
    return held_out_windows(arr, n_batches, SEQ, BATCH)


def bits(ppl: float) -> float:
    """bits per byte of a per-byte perplexity"""
    return round(math.log2(ppl), 4)


def score_checkpoint(cfg, params, ev: List[np.ndarray],
                     dec_ev: List[np.ndarray]) -> Dict[str, float]:
    """One (checkpoint, corpus) cell: dense, int8-W, int4-W and W8A8 ppl
    and bits per byte over ``ev``, cached decode dense against int8 W +
    int8 KV over ``dec_ev``. ``params`` are the checkpoint's (f32); they
    are rounded to bf16, quantized from there, and run in ``cfg.dtype``."""
    p_bf = cast_bf16(params)
    q = quantized_perplexities(p_bf, cfg, ev)
    row = {}
    for label in ("dense", "int8_w", "int4_w", "w8a8"):
        row[f"ppl_{label}"] = q[f"ppl_{label}"]
        row[f"bpb_{label}"] = bits(q[f"ppl_{label}"])
        if label != "dense":
            row[f"delta_{label}"] = q[f"delta_{label}"]
    qp8 = quantize_decoder_weights(p_bf, bits=8)
    dd = cached_decode_ppl(as_compute(p_bf, cfg.dtype), cfg, dec_ev, None)
    dq = cached_decode_ppl(as_compute(qp8, cfg.dtype), cfg, dec_ev, "int8")
    row["ppl_decode_dense"] = dd
    row["ppl_decode_int8w_int8kv"] = dq
    row["delta_int8w_int8kv"] = dq - dd
    return row


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt-root", default=None,
                    help="holds n0/ and n1/ (default results/torch_quant_study)")
    ap.add_argument("--out", default=None,
                    help="default artifacts/torch_quant_study_v2.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device("cpu") if args.cpu else resolve_device()
    root = Path(args.ckpt_root) if args.ckpt_root else RESULTS
    path = Path(args.out) if args.out else ARTIFACTS / "torch_quant_study_v2.json"

    corpora, records = build_corpora()
    _log(f"corpora: {json.dumps(records)}")
    out = {"eval_mb": EVAL_MB, "seq": SEQ, "batch": BATCH,
           "backend": dev.type, "card": card_description(dev),
           "corpora": records}
    if path.exists():
        try:
            out.update(json.loads(path.read_text()))
            _log(f"resuming over {path}")
        except ValueError:
            pass

    for ntag in ("n0", "n1"):
        ckpt = root / ntag
        if not (ckpt / "params.npz").exists():
            _log(f"SKIP {ntag}: no checkpoint at {ckpt}")
            continue
        cfg, params, meta = load_checkpoint(ckpt, device=dev)
        step = meta.get("train_step", 0)
        _log(f"{ntag}: step-{step} checkpoint (softmax_n={cfg.softmax_n})")
        res = out.get(ntag, {})
        res["train_steps"] = int(step)
        res["checkpoint"] = str(ckpt)
        for cname, arr in corpora.items():
            if res.get(cname, {}).get("delta_w8a8") is not None:
                _log(f"{ntag}/{cname}: already scored, skipping")
                continue
            t0 = time.time()
            ev = batches(arr, 8)
            row = score_checkpoint(cfg, params, ev, ev[:2])
            row["seconds"] = time.time() - t0
            res[cname] = row
            out[ntag] = res
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(out, indent=2))
            _log(f"{ntag}/{cname}: dense {row['ppl_dense']:.4f} ppl/byte "
                 f"({row['bpb_dense']:.3f} bpb), int8W D{row['delta_int8_w']:+.5f}, "
                 f"int4W D{row['delta_int4_w']:+.5f}, W8A8 D{row['delta_w8a8']:+.5f}, "
                 f"decode int8W+KV D{row['delta_int8w_int8kv']:+.5f} "
                 f"[{row['seconds']:.0f}s]")
        out[ntag] = res
        del params
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    _log(f"wrote {path}")
    print(json.dumps({k: v for k, v in out.items() if k in ("n0", "n1")})[:2000],
          flush=True)
    return out


if __name__ == "__main__":
    main()
