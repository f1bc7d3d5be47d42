"""The softmax-N quantization study on one card, after
``scripts/train_quant_study.py``.

Trains the serving architecture, a byte-level Llama-style decoder (d_model
1024, 16 layers, 16 query heads over 4 KV heads of head dim 64, SwiGLU
d_ff 2816, RoPE: 181M parameters), on a code corpus read from this
machine's own Python installation, then measures the reference library's
claim (softmax-N suppresses activation outliers, so the model quantizes
better):

  * held-out perplexity: dense bf16, int8 weights and grouped int4 weights
    (the full forward; int4 takes K7), and, through the cached decode path,
    dense against int8 weights with an int8 KV cache;
  * each layer's attention-output kurtosis through the analysis taps
    (``analysis.hooks``) into ``quant.gates``' bit-width gates;
  * each weight's statistics, and the gate over the matmul weights.

Mixed precision as in the JAX script: f32 master weights, cast to bf16
inside the loss (the cast's gradient comes back in f32), ``remat``. The
optimizer is optax's ``chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps, 0.1 lr),
weight_decay=0.01))`` written out in PyTorch (``OptaxAdamW``). On the card
a step runs K1 forward and K5/K6 backward at B32 x L512 (GQA K/V repeated
to 16 heads).

The corpus is the ``.py`` and then ``.md`` files, sorted, of 256 bytes or
more, under ``sysconfig``'s ``purelib`` and ``stdlib`` and then the repo,
joined by blank lines and cut at ``--corpus-mb`` (the JAX script's walk of
its machine's same places). The last 2% is held out. Each result records
the corpus's bytes, file count and sha256, so runs can be shown to share it.

Checkpoints hold the parameters in the JAX package's format
(``utils/checkpoint``) and the optimizer state in the port's, every
``--ckpt-every`` steps under ``results/torch_quant_study/n{N}/``;
``--resume`` continues a run, ``--stop-step`` stops at an absolute step
(the schedule still spans ``--steps``), ``--deadline-s`` after so many
seconds. The result goes to ``artifacts/torch_quant_study_n{N}.json``.

Usage (the card by default; without one it raises unless given ``--cpu``)::

    python -m flash_attention_softmax_n_tpu_torch.utils.train_quant_study --softmax-n 1
    python -m flash_attention_softmax_n_tpu_torch.utils.train_quant_study --softmax-n 0
    # the plain versions on the CPU at a small size
    python -m flash_attention_softmax_n_tpu_torch.utils.train_quant_study --cpu \\
        --d-model 64 --layers 2 --heads 4 --kv-heads 2 --d-ff 128 --seq 32 \\
        --batch 4 --steps 3 --corpus-mb 1 --out /tmp/n1.json --ckpt-dir /tmp/n1
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import sys
import sysconfig
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

if __name__ == "__main__":  # run as a file: import the port beside it
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.analysis.evaluate import perplexity
from flash_attention_softmax_n_tpu_torch.analysis.hooks import (
    activation_stats_to_dict,
    compute_weight_statistics,
    init_activation_stats,
    update_activation_stats,
)
from flash_attention_softmax_n_tpu_torch.models.decoder import (
    DecoderConfig,
    decode_step,
    decoder_forward,
    init_decoder_params,
    init_kv_cache,
)
from flash_attention_softmax_n_tpu_torch.parallel.train import (
    causal_lm_loss,
    init_train_state,
)
from flash_attention_softmax_n_tpu_torch.quant.gates import gate_report
from flash_attention_softmax_n_tpu_torch.quant.weights import (
    quantize_decoder_weights,
)
from flash_attention_softmax_n_tpu_torch.utils.checkpoint import (
    load_train_checkpoint,
    save_train_checkpoint,
)
from flash_attention_softmax_n_tpu_torch.utils.profiling import (
    card_description,
)

__all__ = ["corpus_dirs", "iter_corpus_files", "take_corpus", "load_corpus",
           "held_out_windows", "sample_batch", "detached", "cast_bf16",
           "as_compute",
           "warmup_cosine_decay", "OptaxAdamW", "train_step",
           "cached_decode_ppl", "quantized_perplexities", "evaluate",
           "study_config", "main"]

REPO = Path(__file__).resolve().parents[2]
RESULTS = REPO / "results" / "torch_quant_study"
ARTIFACTS = REPO / "artifacts"


# ----------------------------------------------------------------------------
# corpus
# ----------------------------------------------------------------------------


def corpus_dirs() -> List[str]:
    """The installation's pure-Python packages, its standard library, then
    the repo: the places the JAX script names by their paths on its
    machine."""
    paths = sysconfig.get_paths()
    return [paths["purelib"], paths["stdlib"], str(REPO)]


def iter_corpus_files(dirs: Optional[Sequence[str]] = None
                      ) -> Iterator[Tuple[Path, bytes]]:
    """(path, bytes) of the corpus's files in order: under each of
    ``dirs`` (default ``corpus_dirs()``), the sorted ``.py`` files, then
    the sorted ``.md`` files, of 256 bytes or more, outside ``.git`` and
    ``results``; unreadable files are skipped. The v2 eval continues this
    walk past the training budget."""
    for root in corpus_dirs() if dirs is None else dirs:
        rootp = Path(root)
        if not rootp.exists():
            continue
        for pat in ("**/*.py", "**/*.md"):
            for f in sorted(rootp.glob(pat)):
                if ".git" in f.parts or "results" in f.parts:
                    continue
                try:
                    b = f.read_bytes()
                except OSError:
                    continue
                if len(b) < 256:
                    continue
                yield f, b


def corpus_record(raw: bytes, files: int) -> Dict:
    return {"bytes": len(raw), "files": files,
            "sha256": hashlib.sha256(raw).hexdigest()}


def take_corpus(max_mb: int, dirs: Optional[Sequence[str]] = None
                ) -> Tuple[np.ndarray, Dict]:
    """(the corpus as int32 bytes, its record): the file stream until it
    reaches ``max_mb`` MiB, joined by blank lines and cut there. The record
    holds the corpus's bytes, its file count and its sha256."""
    parts, total = [], 0
    budget = max_mb * 1024 * 1024
    for _, b in iter_corpus_files(dirs):
        parts.append(b)
        total += len(b)
        if total >= budget:
            break
    raw = b"\n\n".join(parts)[:budget]
    return (np.frombuffer(raw, np.uint8).astype(np.int32),
            corpus_record(raw, len(parts)))


def load_corpus(max_mb: int, dirs: Optional[Sequence[str]] = None
                ) -> np.ndarray:
    """The JAX script's ``load_corpus``: ``take_corpus``'s array."""
    return take_corpus(max_mb, dirs)[0]


def held_out_windows(arr: np.ndarray, n_batches: int, seq: int,
                     batch: int) -> List[np.ndarray]:
    """``n_batches`` (batch, seq) batches of disjoint windows at a fixed
    stride over ``arr``, as both JAX scripts cut their held-out sets."""
    stride = (len(arr) - seq - 1) // (n_batches * batch)
    return [np.stack([arr[(b * batch + j) * stride:][:seq]
                      for j in range(batch)]) for b in range(n_batches)]


def sample_batch(rng: np.random.RandomState, train: np.ndarray, batch: int,
                 seq: int) -> np.ndarray:
    """(batch, seq) training windows at offsets drawn from ``rng``."""
    idx = rng.randint(0, len(train) - seq - 1, size=batch)
    return np.stack([train[j:j + seq] for j in idx])


# ----------------------------------------------------------------------------
# precision
# ----------------------------------------------------------------------------


def _map_dense(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_dense(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def detached(params):
    """The tree with every tensor leaf detached from autograd."""
    return _map_dense(params, lambda a: a.detach())


def cast_bf16(params):
    """Every f32 tensor leaf in bf16 (differentiable: the gradient comes
    back to the f32 leaf in f32); other leaves, QTensors among them, as
    they are."""
    return _map_dense(params, lambda a: a.to(torch.bfloat16)
                      if a.dtype == torch.float32 else a)


def as_compute(params, dtype):
    """Every dense floating leaf in ``dtype``. JAX multiplies f32
    activations by bf16 weights by promoting the weights; PyTorch's matmul
    refuses mixed operands, so the port widens them first (exactly: every
    bf16 value is an f32 value)."""
    return _map_dense(params, lambda a: a.to(dtype)
                      if a.is_floating_point() and a.dtype != dtype else a)


# ----------------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------------


def warmup_cosine_decay(count: int, peak: float, warmup: int,
                        decay_steps: int, end_value: float = 0.0,
                        init: float = 0.0) -> float:
    """optax's ``warmup_cosine_decay_schedule(init, peak, warmup,
    decay_steps, end_value)`` at ``count``, in f32 as optax evaluates it:
    linear from ``init`` to ``peak`` over ``warmup`` steps, then a cosine
    to ``end_value`` at ``decay_steps`` (warmup included), flat after."""
    f = np.float32
    if count < warmup:
        frac = f(1.0) - f(min(max(count, 0), warmup)) / f(warmup)
        return float((f(init) - f(peak)) * frac + f(peak))
    span = f(decay_steps - warmup)
    t = np.minimum(f(count - warmup), span)
    alpha = f(0.0 if peak == 0.0 else end_value / peak)
    cosine = f(0.5) * (f(1.0) + np.cos(f(math.pi) * t / span))
    return float(f(peak) * ((f(1.0) - alpha) * cosine + alpha))


class OptaxAdamW(torch.optim.Optimizer):
    """optax's ``chain(clip_by_global_norm(clip_norm),
    adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps, end_value),
    b1, b2, eps, weight_decay=weight_decay))``; ``clip_norm=None`` is
    ``optax.adamw`` alone.

    The numerics are optax's, where ``torch.optim.AdamW`` and
    ``clip_grad_norm_`` differ: the clip multiplies by ``clip_norm /
    norm`` where the global norm reaches it (``clip_grad_norm_`` divides by
    ``norm + 1e-6``); the learning rate is the schedule at the update count
    before it is incremented, so the first step of a warmup from 0 moves
    nothing; the update is ``-lr (m_hat / (sqrt(v_hat) + eps) + wd p)``,
    with every parameter decayed and no eps under the root. The state is
    per parameter (``step``, ``mu``, ``nu``), so ``utils.checkpoint``
    saves and restores it; all parameters share one group.
    """

    def __init__(self, params, *, lr: float, warmup: int, steps: int,
                 end_value: float = 0.0, weight_decay: float = 0.01,
                 clip_norm: Optional[float] = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        if steps <= warmup:
            raise ValueError(f"the cosine needs steps > warmup, got steps "
                             f"{steps}, warmup {warmup}")
        super().__init__(params, dict(
            lr=lr, warmup=warmup, steps=steps, end_value=end_value,
            weight_decay=weight_decay, clip_norm=clip_norm, b1=b1, b2=b2,
            eps=eps))
        if len(self.param_groups) != 1:
            raise ValueError("OptaxAdamW takes one parameter group")

    def lr_at(self, count: int) -> float:
        g = self.param_groups[0]
        return warmup_cosine_decay(count, g["lr"], g["warmup"], g["steps"],
                                   g["end_value"])

    @property
    def count(self) -> int:
        """Updates made so far (optax's count)."""
        p = self.param_groups[0]["params"][0]
        return int(self.state[p]["step"]) if self.state[p] else 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdamW takes no closure")
        g = self.param_groups[0]
        params = g["params"]
        if any(p.grad is None for p in params):
            raise ValueError("every parameter needs a gradient")
        grads = [p.grad for p in params]
        if g["clip_norm"] is not None:
            norm = torch.sqrt(sum(torch.sum(x.float() * x.float())
                                  for x in grads))
            keep = norm < g["clip_norm"]
            grads = [torch.where(keep, x, x / norm.to(x.dtype) * g["clip_norm"])
                     for x in grads]
        count = self.count
        lr = self.lr_at(count)
        b1, b2, t = g["b1"], g["b2"], count + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for p, grad in zip(params, grads):
            st = self.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=torch.float32)
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
            mu, nu = st["mu"], st["nu"]
            mu.mul_(b1).add_(grad, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + g["eps"])
            update.add_(p, alpha=g["weight_decay"])
            p.add_(update, alpha=-lr)
            st["step"] += 1.0
        return None


def train_step(params: Dict, opt: torch.optim.Optimizer, cfg: DecoderConfig,
               tokens: torch.Tensor,
               cast: Callable[[Dict], Dict] = cast_bf16) -> torch.Tensor:
    """One update in place: the causal-LM loss of ``cast(params)`` (bf16
    compute over the f32 masters by default), its backward into the
    parameters, then ``opt``. Returns the loss, a device scalar."""
    opt.zero_grad(set_to_none=True)
    loss = causal_lm_loss(cast(params), cfg, tokens)
    loss.backward()
    opt.step()
    return loss.detach()


# ----------------------------------------------------------------------------
# evaluation
# ----------------------------------------------------------------------------


def _device_tokens(params: Dict, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


@torch.inference_mode()
def cached_decode_ppl(params: Dict, cfg: DecoderConfig, token_batches,
                      quantization: Optional[str]) -> float:
    """Teacher-forced perplexity through the cached decode path: token t
    enters ``decode_step`` (its k/v appended to a dense, or
    ``quantization``'s, cache as the serving engine appends them) and its
    logits score token t + 1. JAX runs the loop as one ``lax.scan``; here
    it is a loop over ``decode_step``, each batch's f32 sum kept on the
    device until the batch ends."""
    total, count = 0.0, 0
    for tokens in token_batches:
        tokens = _device_tokens(params, tokens)
        b, seq = tokens.shape
        cache = init_kv_cache(cfg, b, max_len=seq, quantization=quantization,
                              device=tokens.device)
        nll = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for t in range(seq - 1):
            logits, cache = decode_step(params, cfg, tokens[:, t], cache)
            logp = torch.log_softmax(logits.float(), dim=-1)
            nll = nll - torch.gather(logp, -1, tokens[:, t + 1, None]).sum()
        total += float(nll)
        count += b * (seq - 1)
    return float(np.exp(total / count))


def quantized_perplexities(params: Dict, cfg: DecoderConfig, batches,
                           w8a8: bool = True) -> Dict[str, float]:
    """Perplexity of ``params`` dense, with int8 and grouped int4 weights
    quantized from them and, with ``w8a8``, int8 weights and int8
    activations (``act_bits=8``: K7's W8A8 mode): ``ppl_*`` and ``delta_*``
    against dense. Each tree's dense leaves run in ``cfg.dtype``
    (``as_compute``)."""
    row = {"ppl_dense": perplexity(as_compute(params, cfg.dtype), cfg,
                                   batches)}
    runs = [("int8_w", 8, cfg), ("int4_w", 4, cfg)]
    if w8a8:
        runs.append(("w8a8", 8, dataclasses.replace(cfg, act_bits=8)))
    for label, bits, rcfg in runs:
        qp = as_compute(quantize_decoder_weights(params, bits=bits), cfg.dtype)
        row[f"ppl_{label}"] = perplexity(qp, rcfg, batches)
        row[f"delta_{label}"] = row[f"ppl_{label}"] - row["ppl_dense"]
    return row


def evaluate(params: Dict, cfg: DecoderConfig, ev: List[np.ndarray],
             dec_ev: List[np.ndarray]) -> Dict:
    """The JAX script's evaluation of f32 master ``params``, rounded to
    bf16 and run in ``cfg.dtype`` (bf16 in the study): dense, int8-W and
    int4-W perplexity over ``ev``, cached decode dense against int8 W +
    int8 KV over ``dec_ev``, the taps' activation statistics and gate
    report, and the weights' statistics and matmul-weight gate report."""
    masters = detached(params)
    p_bf = cast_bf16(masters)
    dense_tree = as_compute(p_bf, cfg.dtype)
    results: Dict = {}
    q = quantized_perplexities(p_bf, cfg, ev, w8a8=False)
    results["ppl_dense_bf16"] = q["ppl_dense"]
    for bits in (8, 4):
        results[f"ppl_int{bits}_w"] = q[f"ppl_int{bits}_w"]
        results[f"delta_int{bits}_w"] = q[f"delta_int{bits}_w"]
    qp8 = as_compute(quantize_decoder_weights(p_bf, bits=8), cfg.dtype)
    dense = cached_decode_ppl(dense_tree, cfg, dec_ev, None)
    quant = cached_decode_ppl(qp8, cfg, dec_ev, "int8")
    results["ppl_decode_dense"] = dense
    results["ppl_decode_int8w_int8kv"] = quant
    results["delta_int8w_int8kv"] = quant - dense

    tap_names = [f"layers.{i}.attention.output" for i in range(cfg.n_layers)]
    stats = init_activation_stats(tap_names, device=p_bf["embed"].device)
    with torch.inference_mode():
        for tokens in ev:
            _, taps = decoder_forward(dense_tree, cfg,
                                      _device_tokens(p_bf, tokens),
                                      collect_taps=True)
            stats = update_activation_stats(stats, taps)
    act = activation_stats_to_dict(stats)
    results["activation_stats"] = act
    results["gate_report"] = gate_report(act, target="activations")
    kurts = [act[n]["kurtosis"] for n in tap_names]
    results["kurtosis_summary"] = {"max": max(kurts),
                                   "mean": sum(kurts) / len(kurts)}

    wstats = compute_weight_statistics(masters)
    results["weight_kurtosis_max"] = max(v["kurtosis"] for v in wstats.values())
    # only the matmul weights are gated: quantize_decoder_weights leaves
    # the norm gains and the embedding dense
    results["weight_gate_report"] = gate_report(
        {k: v for k, v in wstats.items()
         if "norm" not in k and "embed" not in k}, target="weights")
    results["weight_stats"] = {k: v for k, v in wstats.items()
                               if "layers" not in k or "/0/" in k}
    return results


# ----------------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------------


def study_config(*, d_model: int = 1024, layers: int = 16, heads: int = 16,
                 kv_heads: int = 4, d_ff: int = 2816, seq: int = 512,
                 softmax_n: float = 1.0) -> DecoderConfig:
    """The study's decoder (bf16 compute, remat; the defaults are the
    study's 181M model); its f32 twin is ``replace(cfg, dtype=float32)``."""
    return DecoderConfig(vocab_size=256, d_model=d_model, n_layers=layers,
                         n_heads=heads, n_kv_heads=kv_heads, d_ff=d_ff,
                         max_seq_len=seq, softmax_n=softmax_n,
                         dtype=torch.bfloat16, remat=True)


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _ntag(n: float) -> str:
    return f"n{n:g}".replace(".", "p")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--softmax-n", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=2816)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--corpus-mb", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate the checkpoint as it is")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="stop training (checkpoint, then evaluate) after "
                    "this many seconds; 0: no deadline")
    ap.add_argument("--stop-step", type=int, default=0,
                    help="stop training at this absolute step (the schedule "
                    "still spans --steps): trains the other n to the same "
                    "step")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default results/torch_quant_study/n{N}")
    ap.add_argument("--out", default=None,
                    help="default artifacts/torch_quant_study_n{N}.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    return ap


def main(argv=None) -> Dict:
    args = _parser().parse_args(argv)
    dev = torch.device("cpu") if args.cpu else resolve_device()
    ntag = _ntag(args.softmax_n)
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else RESULTS / ntag
    t_start = time.time()

    data, corpus = take_corpus(args.corpus_mb)
    split = int(len(data) * 0.98)
    train, held = data[:split], data[split:]
    _log(f"corpus: {corpus['bytes']} bytes from {corpus['files']} files "
         f"({split} train / {len(held)} eval), sha256 {corpus['sha256']}")

    cfg = study_config(d_model=args.d_model, layers=args.layers,
                       heads=args.heads, kv_heads=args.kv_heads,
                       d_ff=args.d_ff, seq=args.seq,
                       softmax_n=args.softmax_n)
    cfg_init = dataclasses.replace(cfg, dtype=torch.float32)
    warmup = min(500, max(1, args.steps // 10))

    def make_opt(leaves):
        return OptaxAdamW(leaves, lr=args.lr, warmup=warmup, steps=args.steps,
                          end_value=0.1 * args.lr, weight_decay=0.01,
                          clip_norm=1.0)

    step0 = 0
    if (args.resume or args.eval_only) and (ckpt_dir / "opt_state.json"
                                            ).exists():
        _, params, opt, step0, _ = load_train_checkpoint(ckpt_dir, make_opt,
                                                         device=dev)
        _log(f"resumed from step {step0}")
    else:
        params, opt = init_train_state(
            init_decoder_params(cfg_init, args.seed, device=dev), make_opt)
    n_params = sum(p.numel() for p in opt.param_groups[0]["params"])
    _log(f"model: {n_params / 1e6:.1f}M params, softmax_n={cfg.softmax_n}, "
         f"{card_description(dev)}")

    rng = np.random.RandomState(args.seed + step0)  # a fresh stream on resume
    tok_per_step = args.batch * args.seq
    steps_done, train_s = step0, 0.0
    if args.stop_step and step0 >= args.stop_step:
        _log(f"step0 {step0} >= stop-step {args.stop_step}: evaluating the "
             "checkpoint as it is")
    elif not args.eval_only:
        t0 = time.time()
        for i in range(step0, args.steps):
            toks = torch.from_numpy(sample_batch(rng, train, args.batch,
                                                 args.seq)).to(dev)
            loss = train_step(params, opt, cfg, toks)
            steps_done = i + 1
            if i % 100 == 0 or i == args.steps - 1:
                elapsed = time.time() - t0
                _log(f"step {i:6d} loss {float(loss):.4f} ({elapsed:.0f}s, "
                     f"{(i - step0 + 1) * tok_per_step / 1e6:.0f}M tok, "
                     f"{(i - step0 + 1) * tok_per_step / elapsed:.0f} tok/s)")
            hit_stop = bool(args.stop_step and i + 1 >= args.stop_step)
            hit_deadline = bool(args.deadline_s
                                and time.time() - t_start > args.deadline_s)
            if ((i + 1) % args.ckpt_every == 0 or i == args.steps - 1
                    or hit_stop or hit_deadline):
                save_train_checkpoint(ckpt_dir, cfg_init, params, opt,
                                      step=i + 1)
                _log(f"checkpointed at step {i + 1}")
            if hit_stop or hit_deadline:
                _log(("stop-step reached" if hit_stop else "deadline hit")
                     + ": evaluating the current weights")
                break
        if dev.type == "cuda":
            torch.cuda.synchronize()
        train_s = time.time() - t0

    ev = held_out_windows(held, 8, args.seq, args.batch)
    t0 = time.time()
    scores = evaluate(params, cfg, ev, ev[:2])
    results = {"config": {
        "d_model": cfg.d_model, "n_layers": cfg.n_layers,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "d_ff": cfg.d_ff, "softmax_n": cfg.softmax_n, "seq": args.seq,
        "batch": args.batch, "params_m": round(n_params / 1e6, 1),
        "train_steps": int(steps_done), "schedule_steps": args.steps,
        "train_tokens_m": round(steps_done * tok_per_step / 1e6, 1),
        "corpus": corpus, "backend": dev.type,
        "card": card_description(dev)},
        "train_seconds": train_s,
        "tokens_per_s": ((steps_done - step0) * tok_per_step / train_s
                         if steps_done > step0 else None),
        "eval_seconds": time.time() - t0, **scores}
    _log(f"dense bf16 ppl {scores['ppl_dense_bf16']:.4f}; int8-W "
         f"D {scores['delta_int8_w']:+.5f}, int4-W D "
         f"{scores['delta_int4_w']:+.5f}; decode int8 W + KV D "
         f"{scores['delta_int8w_int8kv']:+.5f}; kurtosis max "
         f"{scores['kurtosis_summary']['max']:.2f}")
    out = Path(args.out) if args.out else ARTIFACTS / f"torch_quant_study_{ntag}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(json.dumps({k: v for k, v in results.items()
                      if not isinstance(v, dict)}), flush=True)
    return results


if __name__ == "__main__":
    main()
