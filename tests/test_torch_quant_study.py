"""Port parity: the quantization study (``utils/train_quant_study.py``,
``utils/eval_quant_ppl.py``, ``utils/eval_quant_study_v2.py``) against
``scripts/train_quant_study.py``, ``scripts/eval_quant_ppl.py`` and
``scripts/eval_quant_study_v2.py`` and the JAX package.

At d_model 64, 2 layers, 4 query heads over 2 KV heads (head dim 16), seq
32, batch 4 (d_ff 256, so the int4 ``w_down`` takes K7's plain version as
JAX's takes its kernel): the corpus walk and its cut over a temporary
tree, the held-out windows, the v2 corpora's dedup and cut-off, three
training steps from JAX's weights (``convert.params_from_jax``) with the
clip, the warmup-cosine schedule and AdamW against optax (f32 within 1e-5
relative, bf16 compute within 5e-2), dense, int8-W and int4-W perplexity
and cached-decode perplexity with dense and int8 KV caches within 1e-4
(W8A8 within 1e-3, its operator bit-equal: see W8A8_RTOL), the taps'
kurtosis within 1e-3 with equal gate decisions, and a checkpoint written
by the JAX package scored by the port's v2 eval.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attention_softmax_n_tpu.analysis.evaluate import perplexity as j_perplexity
from flash_attention_softmax_n_tpu.kernels.quant_matmul import quantized_matmul as j_qmm
from flash_attention_softmax_n_tpu.analysis.hooks import (
    activation_stats_to_dict as j_stats_to_dict,
    compute_weight_statistics as j_weight_stats,
    init_activation_stats as j_init_stats,
    update_activation_stats as j_update_stats,
)
from flash_attention_softmax_n_tpu.models.decoder import (
    DecoderConfig as JConfig,
    decoder_forward as j_forward,
    init_decoder_params as j_init,
)
from flash_attention_softmax_n_tpu.quant import (
    quantize_decoder_weights as j_quantize,
)
from flash_attention_softmax_n_tpu.quant.gates import gate_report as j_gates
from flash_attention_softmax_n_tpu.utils.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.kernels.quant_matmul import (
    quantized_matmul as t_qmm,
)
from flash_attention_softmax_n_tpu_torch.models.decoder import DecoderConfig
from flash_attention_softmax_n_tpu_torch.utils import eval_quant_ppl as tppl
from flash_attention_softmax_n_tpu_torch.utils import eval_quant_study_v2 as tv2
from flash_attention_softmax_n_tpu_torch.utils import train_quant_study as tqs
from flash_attention_softmax_n_tpu_torch.utils.checkpoint import load_checkpoint
from scripts import eval_quant_ppl as j_ppl
from scripts import eval_quant_study_v2 as j_v2
from scripts import train_quant_study as j_tqs

torch.set_num_threads(2)
SMALL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=256, max_seq_len=32, softmax_n=1.0, remat=True)
SEQ, BATCH = 32, 4
PPL_RTOL = 1e-4
# W8A8 rounds each activation to one of 255 levels of its row's absmax, so
# the ~1e-7 relative differences between the two frameworks' f32 matmuls
# flip a few roundings by a whole level; the operator itself is bit-equal
# to JAX's on equal inputs (test_v2_scores_a_jax_checkpoint_as_jax_does),
# and the flips move these perplexities by 2e-4 to 4e-4
W8A8_RTOL = 1e-3


def _configs(dtype="f32", **kw):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return (JConfig(**{**SMALL, **kw}, dtype=jdt),
            DecoderConfig(**{**SMALL, **kw}, dtype=tdt))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(seed=0):
    """JAX's f32 master weights and the port's copy of them."""
    jcfg, _ = _configs()
    jp = j_init(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(_np(jp), device="cpu")


def _tokens(seed, n=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(BATCH, SEQ)).astype(np.int32)
            for _ in range(n)]


def _rel(a, b):
    return abs(a - b) / abs(b)


# ----------------------------------------------------------------------------
# corpora and windows
# ----------------------------------------------------------------------------


def _write_tree(root, files):
    for rel, payload in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(payload)


def _blob(seed, n):
    return np.random.RandomState(seed).randint(32, 127, size=n).astype(np.uint8).tobytes()


@pytest.fixture()
def corpus_tree(tmp_path):
    """Two roots (and a missing one) of .py/.md files: small files, .git and
    results dirs, a directory named like a .py file, nested packages; 1.5
    MiB in all, so a 1 MiB budget cuts inside the second root."""
    a, b = tmp_path / "a", tmp_path / "b"
    _write_tree(a, {"z.py": _blob(1, 300_000), "pkg/y.py": _blob(2, 300_000),
                    "pkg/tiny.py": b"x = 1\n", "pkg/notes.md": _blob(3, 5_000),
                    ".git/hooks/h.py": _blob(4, 9_000),
                    "results/r.py": _blob(5, 9_000), "b.py/inner.md": _blob(6, 700)})
    _write_tree(b, {"m.md": _blob(7, 400_000), "k/a.py": _blob(8, 300_000),
                    "k/b.py": _blob(9, 300_000)})
    (a / "dir.py").mkdir()
    return [str(a), str(tmp_path / "missing"), str(b)]


def test_corpus_walk_and_windows_match_the_jax_scripts(corpus_tree, monkeypatch):
    monkeypatch.setattr(j_tqs, "CORPUS_DIRS", corpus_tree)
    want = [(str(f), b) for f, b in j_tqs.iter_corpus_files()]
    got = [(str(f), b) for f, b in tqs.iter_corpus_files(corpus_tree)]
    assert got == want and len(got) == 7
    for mb in (1, 2):
        data, record = tqs.take_corpus(mb, corpus_tree)
        np.testing.assert_array_equal(data, j_tqs.load_corpus(mb))
        assert data.dtype == np.int32 and record["bytes"] == len(data)
    assert tqs.take_corpus(1, corpus_tree)[1]["files"] == 6
    # the defaults name this installation's places, then the repo
    import sysconfig
    assert tqs.corpus_dirs() == [sysconfig.get_paths()["purelib"],
                                 sysconfig.get_paths()["stdlib"], str(tqs.REPO)]

    # held-out windows: the study's (8 x B32 x L512, v2's `batches`) and
    # eval_quant_ppl's (4 x B16 x L192), and its training batches
    held = np.arange(400_000, dtype=np.int32) % 251
    for w, j in zip(tqs.held_out_windows(held, 8, 512, 32), j_v2.batches(held, 8)):
        np.testing.assert_array_equal(w, j)
    for w, j in zip(tppl.eval_batches(held, 4), j_ppl.eval_batches(held, 4)):
        np.testing.assert_array_equal(w, j)
    for w, j in zip(tppl.batches(held, np.random.RandomState(3), 5),
                    j_ppl.batches(held, np.random.RandomState(3), 5)):
        np.testing.assert_array_equal(w, j)
    # eval_quant_ppl's corpus: the repo's files
    np.testing.assert_array_equal(tppl.load_corpus(), j_ppl.load_corpus())


def test_v2_corpora_dedup_and_cutoff_match_the_jax_script(corpus_tree, tmp_path,
                                                          monkeypatch):
    # past the 1 MiB training cut: duplicates of training files (dropped),
    # a file twice (the second dropped), new files
    extra = tmp_path / "c"
    _write_tree(extra, {"d1.py": _blob(8, 300_000), "d2.py": _blob(1, 300_000),
                        "n1.py": _blob(11, 200_000), "n2.py": _blob(11, 200_000),
                        "n3.md": _blob(12, 900_000)})
    dirs = corpus_tree + [str(extra)]
    monkeypatch.setattr(j_tqs, "CORPUS_DIRS", dirs)
    monkeypatch.setattr(j_v2, "TRAIN_MB", 1)
    monkeypatch.setattr(j_v2, "EVAL_MB", 1)
    want = j_v2.build_corpora()
    got, records = tv2.build_corpora(dirs=dirs, train_mb=1, eval_mb=1)
    assert list(got) == list(want) == ["tail", "unseen_py", "cpp"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the walk stops in b/k/b.py; c's first two files repeat a training
    # file and n2 repeats n1
    assert records["unseen_py"]["duplicates_dropped"] == 3
    assert records["unseen_py"]["files"] == 3
    assert len(got["unseen_py"]) == 1024 * 1024 and len(got["cpp"]) == 1024 * 1024
    assert tv2.cpp_roots() == [str(j_v2.pathlib.Path(
        "/opt/venv/lib/python3.12/site-packages/torch/include").resolve())]


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------


def test_schedule_and_clip_match_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 6e-4, warmup_steps=50,
                                               decay_steps=500, end_value=6e-5)
    for count in (0, 1, 25, 49, 50, 51, 300, 499, 500, 501, 900):
        assert tqs.warmup_cosine_decay(count, 6e-4, 50, 500, 6e-5) == pytest.approx(
            float(sched(count)), rel=1e-6, abs=1e-12)
    assert tqs.warmup_cosine_decay(0, 6e-4, 50, 500) == 0.0
    # the global-norm clip divides by the norm itself (clip_grad_norm_
    # would divide by norm + 1e-6), and leaves a norm below 1 alone
    rng = np.random.RandomState(0)
    for scale in (0.01, 1.0):
        grads = [rng.randn(16, 8).astype(np.float32) * scale,
                 rng.randn(8).astype(np.float32) * scale]
        clip = optax.clip_by_global_norm(1.0)
        want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
        ps = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        opt = tqs.OptaxAdamW(ps, lr=1.0, warmup=1, steps=4, weight_decay=0.0)
        for p, g in zip(ps, grads):
            p.grad = torch.from_numpy(g)
        opt.step()  # count 0: lr 0, the moments take the clipped gradient
        for p, w in zip(ps, want):
            np.testing.assert_allclose(opt.state[p]["mu"].numpy() / 0.1,
                                       np.asarray(w), rtol=1e-6, atol=1e-9)
            assert torch.equal(p.detach(), torch.zeros_like(p))
        assert opt.count == 1


def _jax_steps(jp, jcfg, tokens, opt, cast, n):
    @jax.jit
    def step(params, opt_state, toks):
        def loss_fn(p):
            logits = j_forward(cast(p), jcfg, toks).astype(jnp.float32)
            logp = jax.nn.log_softmax(logits[:, :-1], -1)
            nll = -jnp.take_along_axis(logp, toks[:, 1:, None], -1)
            return jnp.mean(nll)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    state, losses = opt.init(jp), []
    for i in range(n):
        jp, state, loss = step(jp, state, jnp.asarray(tokens[i]))
        losses.append(float(loss))
    return jp, losses


# (compute type, clip, peak lr, end value, tolerance): the study's optimizer
# in f32 and in bf16 compute over f32 masters, and eval_quant_ppl's (no
# clip, lr 3e-3, cosine to 0)
TRAIN_CASES = {"study_f32": ("f32", 1.0, 6e-4, 6e-5, 1e-5),
               "study_bf16": ("bf16", 1.0, 6e-4, 6e-5, 5e-2),
               "ppl_f32": ("f32", None, 3e-3, 0.0, 1e-5)}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_training_steps_match_optax(case):
    dtype, clip, lr, end, tol = TRAIN_CASES[case]
    jcfg, tcfg = _configs(dtype)
    jp, tp = _weights()
    tokens = _tokens(1, 3)
    steps, warmup = 8, 1  # lr 0 at the first step, then the cosine
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                               decay_steps=steps, end_value=end)
    adamw = optax.adamw(sched, weight_decay=0.01)
    jopt = adamw if clip is None else optax.chain(optax.clip_by_global_norm(clip), adamw)
    bf16 = dtype == "bf16"
    jp, jlosses = _jax_steps(jp, jcfg, tokens, jopt,
                             j_tqs.cast_bf16 if bf16 else (lambda p: p), 3)

    from flash_attention_softmax_n_tpu_torch.parallel.train import init_train_state
    tp, topt = init_train_state(tp, lambda leaves: tqs.OptaxAdamW(
        leaves, lr=lr, warmup=warmup, steps=steps, end_value=end,
        weight_decay=0.01, clip_norm=clip))
    tlosses = [float(tqs.train_step(tp, topt, tcfg, torch.from_numpy(t).long(),
                                    cast=tqs.cast_bf16 if bf16 else (lambda p: p)))
               for t in tokens]
    np.testing.assert_allclose(tlosses, jlosses, rtol=tol)
    jflat = dict(jax.tree_util.tree_flatten_with_path(_np(jp))[0])
    for path, want in jflat.items():
        keys = [k.key for k in path]
        got = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        err = float(np.max(np.abs(got.detach().numpy() - want)))
        assert err <= tol * float(np.max(np.abs(want))), (case, keys, err)
    assert topt.count == 3


# ----------------------------------------------------------------------------
# evaluation
# ----------------------------------------------------------------------------


def _same_gates(got, want):
    """the same entries, kurtosis within 1e-3 and every decision equal"""
    assert sorted(got) == sorted(want)
    for name, entry in want.items():
        assert got[name]["kurtosis"] == pytest.approx(entry["kurtosis"], abs=1e-3)
        for gate in ("int8_ok", "int4_ok", "fp8_ok"):
            assert got[name][gate] == entry[gate], (name, gate)


def test_study_evaluation_matches_the_jax_script():
    """``evaluate`` (ppl, cached decode, taps, gates, weight statistics) in
    f32 compute over bf16-rounded weights, as JAX computes it: f32
    activations times bf16 weights promote to f32."""
    jcfg, tcfg = _configs()
    jp, tp = _weights(1)
    ev = _tokens(2, 2)
    got = tqs.evaluate(tp, tcfg, ev, ev[:1])

    p_bf = j_tqs.cast_bf16(jp)
    want = {"ppl_dense_bf16": j_perplexity(p_bf, jcfg, ev)}
    for bits in (8, 4):
        want[f"ppl_int{bits}_w"] = j_perplexity(j_quantize(p_bf, bits=bits), jcfg, ev)
    want["ppl_decode_dense"] = j_tqs.cached_decode_ppl(p_bf, jcfg, ev[:1], None)
    want["ppl_decode_int8w_int8kv"] = j_tqs.cached_decode_ppl(
        j_quantize(p_bf, bits=8), jcfg, ev[:1], "int8")
    for k, v in want.items():
        assert _rel(got[k], v) <= PPL_RTOL, (k, got[k], v)
    for bits in (8, 4):
        assert got[f"delta_int{bits}_w"] == pytest.approx(
            want[f"ppl_int{bits}_w"] - want["ppl_dense_bf16"],
            abs=2 * PPL_RTOL * want["ppl_dense_bf16"])

    names = [f"layers.{i}.attention.output" for i in range(jcfg.n_layers)]
    stats = j_init_stats(names)
    for t in ev:
        _, taps = j_forward(p_bf, jcfg, jnp.asarray(t), collect_taps=True)
        stats = j_update_stats(stats, taps)
    act = j_stats_to_dict(stats)
    for name in names:
        assert got["activation_stats"][name]["kurtosis"] == pytest.approx(
            act[name]["kurtosis"], abs=1e-3)
    _same_gates(got["gate_report"], j_gates(act, target="activations"))
    wstats = j_weight_stats(jp)
    assert got["weight_kurtosis_max"] == pytest.approx(
        max(v["kurtosis"] for v in wstats.values()), abs=1e-3)
    _same_gates(got["weight_gate_report"],
                j_gates({k: v for k, v in wstats.items()
                         if "norm" not in k and "embed" not in k}, target="weights"))
    assert sorted(got["weight_stats"]) == sorted(
        k for k in wstats if "layers" not in k or "/0/" in k)


def test_v2_scores_a_jax_checkpoint_as_jax_does(tmp_path):
    """A JAX ``save_checkpoint`` (the study saves its f32 config): the
    port's loader and ``score_checkpoint`` against the JAX script's row,
    dense, int8-W, int4-W, W8A8 and cached decode."""
    jcfg, _ = _configs()
    jp, _ = _weights(2)
    j_save_checkpoint(str(tmp_path / "n1"), jcfg, jp, metadata={"train_step": 7})
    cfg, params, meta = load_checkpoint(tmp_path / "n1", device="cpu")
    assert meta["train_step"] == 7 and cfg.dtype == torch.float32
    ev = _tokens(3, 2)
    got = tv2.score_checkpoint(cfg, params, ev, ev[:1])

    p_bf = j_tqs.cast_bf16(jp)
    qp8, qp4 = j_quantize(p_bf, bits=8), j_quantize(p_bf, bits=4)
    want = {"ppl_dense": j_perplexity(p_bf, jcfg, ev),
            "ppl_int8_w": j_perplexity(qp8, jcfg, ev),
            "ppl_int4_w": j_perplexity(qp4, jcfg, ev),
            "ppl_w8a8": j_perplexity(qp8, dataclasses.replace(jcfg, act_bits=8), ev),
            "ppl_decode_dense": j_tqs.cached_decode_ppl(p_bf, jcfg, ev[:1], None),
            "ppl_decode_int8w_int8kv": j_tqs.cached_decode_ppl(qp8, jcfg, ev[:1], "int8")}
    for k, v in want.items():
        assert _rel(got[k], v) <= W8A8_RTOL if k == "ppl_w8a8" else PPL_RTOL, (k, got[k], v)
    for label in ("dense", "int8_w", "int4_w", "w8a8"):
        assert got[f"bpb_{label}"] == j_v2.bits(got[f"ppl_{label}"])
    # the int4 run reached the quantized matmul (w_down: K = d_ff = 256)
    assert want["ppl_int4_w"] != want["ppl_int8_w"]
    # W8A8's operator on equal inputs: bit-equal to JAX's
    rng = np.random.RandomState(4)
    x = rng.randn(64, 256).astype(np.float32)
    qw = qp8["layers"]["w_down"]
    want_mm = np.asarray(j_qmm(jnp.asarray(x), qw.values[0], qw.scales[0], bits=8,
                               act_quant=True))
    got_mm = t_qmm(torch.from_numpy(x), torch.from_numpy(np.array(qw.values[0])),
                   torch.from_numpy(np.array(qw.scales[0])), bits=8, act_quant=True)
    np.testing.assert_array_equal(got_mm.numpy(), want_mm)


def test_trainer_checkpoints_resume_and_writes_its_result(corpus_tree, tmp_path,
                                                          monkeypatch):
    """``main`` on the CPU at the small size over a temporary corpus: stops
    at step 2, resumes to 4 from the checkpoint (optimizer count 4), and
    writes the result with the corpus record."""
    monkeypatch.setattr(tqs, "corpus_dirs", lambda: corpus_tree)
    args = ["--cpu", "--d-model", "64", "--layers", "2", "--heads", "4", "--kv-heads",
            "2", "--d-ff", "256", "--seq", "32", "--batch", "4", "--steps", "4",
            "--corpus-mb", "1", "--ckpt-dir", str(tmp_path / "n1"),
            "--out", str(tmp_path / "n1.json")]
    first = tqs.main(args + ["--stop-step", "2"])
    assert first["config"]["train_steps"] == 2
    again = tqs.main(args + ["--resume"])
    assert again["config"]["train_steps"] == 4
    assert again["config"]["corpus"] == first["config"]["corpus"]
    assert again["config"]["corpus"]["files"] == 6
    _, params, opt, step, _ = tqs.load_train_checkpoint(
        tmp_path / "n1", lambda leaves: tqs.OptaxAdamW(leaves, lr=6e-4, warmup=1, steps=4),
        device="cpu")
    assert step == 4 and opt.count == 4
    for key in ("ppl_dense_bf16", "delta_int8_w", "delta_int4_w", "delta_int8w_int8kv",
                "gate_report", "weight_gate_report", "kurtosis_summary"):
        assert key in again
    assert np.isfinite(again["ppl_dense_bf16"]) and again["ppl_dense_bf16"] > 1
