"""Port parity: the analysis package, the outlier gates and the decoder's
taps against the JAX package on the same seeded inputs.

Statistics are float32 reductions summed in another order on each side:
means, variances and attention statistics are held within 1e-6 (relative
and absolute). Skewness and kurtosis are ratios of three such sums, and
XLA's f32 sums on the CPU are themselves off by up to about 1e-6 (7e-7
against an f64 sum of 512 fourth powers; PyTorch's came within 2e-8), so
the ratios m3 / m2^1.5 and m4 / m2^2 (excess kurtosis plus 3) are held
within 5e-6 of their size. Perplexities and the decoder's
logits and taps are held as the decoder's parity tests hold logits, within
1e-5, with ``attn_implementation`` "xla" and "auto" (K1's plain version
against JAX's Pallas kernel in interpret mode).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu import analysis as ja
from flash_attention_softmax_n_tpu import models as jm
from flash_attention_softmax_n_tpu.ops.functional import softmax_n as j_softmax_n
from flash_attention_softmax_n_tpu.quant import gates as jg
from flash_attention_softmax_n_tpu.quant.qtensor import quantize as j_quantize
from flash_attention_softmax_n_tpu.quant.weights import (
    quantize_decoder_weights as j_quantize_weights,
)
from flash_attention_softmax_n_tpu_torch import analysis as ta
from flash_attention_softmax_n_tpu_torch import models as tm
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.quant import gates as tg

torch.set_num_threads(2)
STAT_TOL = dict(rtol=1e-6, atol=1e-6)
RATIO_TOL = dict(rtol=5e-6, atol=1e-6)
TOL = 1e-5


def _close_stat(name, got, want):
    shift = 3.0 if "kurtosis" in name else 0.0
    tol = RATIO_TOL if "kurtosis" in name or "skewness" in name else STAT_TOL
    np.testing.assert_allclose(np.asarray(got) + shift, np.asarray(want) + shift,
                               **tol)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "normal": (rng.standard_normal((4, 8, 16)) * 2.0 + 1.0).astype(np.float32),
        "lognormal": np.exp(rng.standard_normal((3, 64))).astype(np.float32),
        "uniform": rng.uniform(size=(2, 5, 7, 3)).astype(np.float32),
    }


SCALAR_STATS = ["variance", "std", "skewness", "kurtosis", "mean_batch_mean",
                "variance_batch_mean", "skewness_batch_mean",
                "kurtosis_batch_mean"]


@pytest.mark.parametrize("name", SCALAR_STATS)
@pytest.mark.parametrize("which", ["normal", "lognormal", "uniform"])
def test_statistics_match_jax(name, which):
    jx, tx = _both(_inputs()[which])
    _close_stat(name, float(getattr(ta, name)(tx)), float(getattr(ja, name)(jx)))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_central_and_standardized_moments_match_jax(k):
    jx, tx = _both(_inputs()["lognormal"])
    np.testing.assert_allclose(float(ta.central_moment(tx, k)),
                               float(ja.central_moment(jx, k)), **STAT_TOL)
    np.testing.assert_allclose(float(ta.standardized_moment(tx, k)),
                               float(ja.standardized_moment(jx, k)), **RATIO_TOL)


def _probs(n, shape=(2, 3, 4, 8)):
    s = np.random.RandomState(1).standard_normal(shape).astype(np.float32) * 3.0
    return np.asarray(j_softmax_n(jnp.asarray(s), n=n, axis=-1))


@pytest.mark.parametrize("n", [0.0, 1.0, 4.0])
def test_attention_statistics_match_jax(n):
    jp, tp = _both(_probs(n))
    np.testing.assert_allclose(ta.null_attention_mass(tp).numpy(),
                               np.asarray(ja.null_attention_mass(jp)), **STAT_TOL)
    np.testing.assert_allclose(ta.attention_entropy(tp).numpy(),
                               np.asarray(ja.attention_entropy(jp)), **STAT_TOL)
    for shape in [(2, 3, 4, 8), (2, 2, 3, 4, 8)]:
        jp, tp = _both(_probs(n, shape))
        got, want = ta.summarize_attention(tp), ja.summarize_attention(jp)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       **STAT_TOL)
    with pytest.raises(ValueError, match="attention"):
        ta.summarize_attention(torch.zeros((3, 4, 5)))


def _toy_apply(x):
    h = x * 2.0
    return h, {"layer0.attention.output": h, "layer0.mlp": h + 1.0}


NAMES = ["layer0.attention.output", "layer0.mlp"]


@pytest.mark.parametrize("layers_to_save", [None, ["layer0.mlp"], NAMES])
def test_selection_matches_jax(layers_to_save):
    _, js = ja.register_activation_hooks(_toy_apply, NAMES, layers_to_save)
    _, ts = ta.register_activation_hooks(_toy_apply, NAMES, layers_to_save,
                                         device="cpu")
    assert list(ts) == list(js)
    for entry in ts.values():
        assert entry["n_samples"].dtype == torch.int32 and entry["n_samples"].ndim == 0
        assert all(entry[k].dtype == torch.float32 for k in entry if k != "n_samples")


def test_unknown_layer_warns():
    with pytest.warns(UserWarning, match="nope"):
        ta.register_activation_hooks(_toy_apply, ["layer0.mlp"],
                                     layers_to_save=["nope"], device="cpu")


def test_streaming_update_matches_jax():
    rng = np.random.RandomState(2)
    batches = [(rng.standard_normal((b, 16)) * 3.0 + 0.5).astype(np.float32)
               for b in (4, 2, 6)]
    jh, js = ja.register_activation_hooks(_toy_apply, NAMES, NAMES)
    th, ts = ta.register_activation_hooks(_toy_apply, NAMES, NAMES, device="cpu")
    for b in batches:
        _, js = jh(js, jnp.asarray(b))
        _, ts = th(ts, torch.from_numpy(b))
    jd, td = ja.activation_stats_to_dict(js), ta.activation_stats_to_dict(ts)
    assert list(td) == list(jd)
    for name in jd:
        assert list(td[name]) == list(jd[name])
        assert td[name]["n_samples"] == jd[name]["n_samples"] == 12
        assert isinstance(td[name]["n_samples"], int)
        for k in ("kurtosis", "skewness", "variance", "mean"):
            assert isinstance(td[name][k], float)
            _close_stat(k, td[name][k], jd[name][k])


def test_streaming_weighted_average_and_unknown_tap():
    stats = ta.init_activation_stats(["t"], device="cpu")
    stats = ta.update_activation_stats(stats, {"t": torch.full((2, 4), 10.0)})
    stats = ta.update_activation_stats(stats, {"t": torch.full((6, 4), 2.0),
                                               "other": torch.ones(2, 2)})
    assert set(stats) == {"t"}
    d = ta.activation_stats_to_dict(stats)
    np.testing.assert_allclose(d["t"]["mean"], (2 * 10 + 6 * 2) / 8, atol=1e-6)
    assert d["t"]["n_samples"] == 8


def _weight_trees():
    k = jax.random.split(jax.random.PRNGKey(3), 3)
    jtree = {
        "embed": jax.random.normal(k[0], (32, 16)),
        "layers": {
            "wq": j_quantize(jax.random.normal(k[1], (2, 256, 32)), bits=8, axis=-2),
            "w4": j_quantize(jax.random.normal(k[2], (2, 256, 32)), bits=4, axis=-2),
            "norm": jnp.ones((2, 16)) * 1.5,
        },
    }
    return jtree, params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


def _f64_stats(a):
    a = np.asarray(a, np.float64)
    d = a - a.mean()
    m2, m3, m4 = (np.mean(d ** k) for k in (2, 3, 4))
    with np.errstate(invalid="ignore"):  # a constant leaf: 0 / 0
        return {"kurtosis": m4 / m2 ** 2 - 3.0, "skewness": m3 / m2 ** 1.5,
                "variance": m2, "mean": a.mean()}


def test_weight_statistics_names_and_values_match_jax():
    """Names and counts equal; values within RATIO_TOL of JAX's (XLA's f32
    sums over these 16384-element leaves are off by about 1e-6 themselves)
    and within 1e-6 of float64 statistics of the same leaves."""
    jtree, ttree = _weight_trees()
    want = ja.compute_weight_statistics(jtree)
    got = ta.compute_weight_statistics(ttree)
    assert list(got) == list(want)
    assert "layers/wq/0" in got and "layers/w4/1" in got
    leaves = dict(zip(want, jax.tree_util.tree_leaves(jtree)))
    for name in want:
        assert got[name]["n_weights"] == want[name]["n_weights"]
        exact = _f64_stats(leaves[name])
        for key in ("kurtosis", "skewness", "variance", "mean"):
            # a constant leaf has no finite standardized moments on either side
            if not np.isfinite(want[name][key]):
                assert np.isnan(got[name][key]) == np.isnan(want[name][key])
                continue
            shift = 3.0 if key == "kurtosis" else 0.0
            np.testing.assert_allclose(got[name][key] + shift, want[name][key] + shift,
                                       **RATIO_TOL)
            np.testing.assert_allclose(got[name][key] + shift, exact[key] + shift,
                                       **STAT_TOL)


def test_save_results_writes_the_same_bytes(tmp_path):
    jtree, ttree = _weight_trees()
    results = {"weights": ta.compute_weight_statistics(ttree),
               "activations": {"l0": {"n_samples": 12, "kurtosis": 0.25}}}
    jpath = ja.save_results(results, "model", directory=str(tmp_path / "jax"))
    tpath = ta.save_results(results, "model", directory=str(tmp_path / "torch"))
    assert tpath.name == "model.json"
    assert tpath.read_bytes() == jpath.read_bytes()
    assert ta.load_results("model", directory=str(tmp_path / "torch")) == json.loads(
        jpath.read_text())


def test_save_results_default_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = ta.save_results({"a": 1.5}, "m")
    assert path == tmp_path.joinpath("results", "m.json").relative_to(tmp_path)
    assert ta.load_results("m") == {"a": 1.5}


# ----------------------------------------------------------------------------
# the decoder's analysis paths: taps, output_attentions, perplexity
# ----------------------------------------------------------------------------

TINY_KW = dict(vocab_size=61, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=64, max_seq_len=32, softmax_n=1.0)


def _configs(impl="xla"):
    return (jm.DecoderConfig(**TINY_KW, dtype=jnp.float32, attn_implementation=impl),
            tm.DecoderConfig(**TINY_KW, dtype=torch.float32, attn_implementation=impl))


@pytest.fixture(scope="module")
def jparams():
    return jm.init_decoder_params(_configs()[0], jax.random.PRNGKey(0))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


TOKENS = np.random.RandomState(4).randint(0, 61, size=(2, 12)).astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_decoder_taps_match_jax(jparams, impl):
    jc, tc = _configs(impl)
    jl, jt = jm.decoder_forward(jparams, jc, jnp.asarray(TOKENS), collect_taps=True)
    tl, tt = tm.decoder_forward(_port(jparams), tc, torch.from_numpy(TOKENS).long(),
                                collect_taps=True)
    assert list(tt) == list(jt) == [f"layers.{i}.attention.output" for i in range(2)]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for name in jt:
        assert tuple(tt[name].shape) == (2, 12, 32)
        np.testing.assert_allclose(tt[name].numpy(), np.asarray(jt[name]),
                                   atol=TOL, rtol=0)
    # taps leave the forward as it was
    plain = tm.decoder_forward(_port(jparams), tc, torch.from_numpy(TOKENS).long())
    assert torch.equal(plain, tl)


@pytest.mark.parametrize("collect_taps", [False, True])
def test_decoder_output_attentions_match_jax(jparams, collect_taps):
    jc, tc = _configs()
    jout = jm.decoder_forward(jparams, jc, jnp.asarray(TOKENS),
                              collect_taps=collect_taps, output_attentions=True)
    tout = tm.decoder_forward(_port(jparams), tc, torch.from_numpy(TOKENS).long(),
                              collect_taps=collect_taps, output_attentions=True)
    assert len(tout) == len(jout) == (3 if collect_taps else 2)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=TOL, rtol=0)
    if collect_taps:
        assert list(tout[1]) == list(jout[1])
    probs = tout[-1]
    assert tuple(probs.shape) == (2, 2, 4, 12, 12)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jout[-1]), atol=1e-6, rtol=0)
    # the materializing path computes the K1 path's logits
    k1 = tm.decoder_forward(_port(jparams), _configs("auto")[1],
                            torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(tout[0].numpy(), k1.numpy(), atol=TOL, rtol=0)


def test_decoder_output_attentions_dropout_is_k1s_mask(jparams):
    """Under train, the materializing path drops with the hash mask that
    K1 draws from the same per-layer seed, so its logits are the fused
    route's."""
    import dataclasses
    _, tc = _configs("auto")
    tc = dataclasses.replace(tc, attn_dropout=0.3)
    tokens = torch.from_numpy(TOKENS).long()
    params = _port(jparams)

    def run(**kw):
        return tm.decoder_forward(params, tc, tokens, train=True,
                                  generator=torch.Generator().manual_seed(5), **kw)

    fused = run()
    logits, probs = run(output_attentions=True)
    np.testing.assert_allclose(logits.numpy(), fused.numpy(), atol=TOL, rtol=0)
    assert (probs == 0).any()
    with pytest.raises(ValueError, match="generator"):
        tm.decoder_forward(params, tc, tokens, train=True, output_attentions=True)


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_token_nll_and_perplexity_match_jax(jparams, impl):
    jc, tc = _configs(impl)
    tparams = _port(jparams)
    mask = np.arange(12)[None, :] < np.array([[12], [7]])
    jn, jc_ = ja.token_nll(jparams, jc, jnp.asarray(TOKENS), jnp.asarray(mask))
    tn, tc_ = ta.token_nll(tparams, tc, torch.from_numpy(TOKENS), torch.from_numpy(mask))
    assert int(tc_) == int(jc_) == 11 + 6
    assert tn.dtype == torch.float32 and tc_.dtype == torch.int32
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    batches = [TOKENS, TOKENS[::-1].copy()]
    np.testing.assert_allclose(ta.perplexity(tparams, tc, batches),
                               ja.perplexity(jparams, jc, batches), rtol=TOL)
    np.testing.assert_allclose(
        ta.perplexity(tparams, tc, batches, [mask, mask]),
        ja.perplexity(jparams, jc, batches, [jnp.asarray(mask)] * 2), rtol=TOL)


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_delta_perplexity_int8_matches_jax(jparams, impl):
    from flash_attention_softmax_n_tpu_torch.quant import quantize_decoder_weights
    jc, tc = _configs(impl)
    jq = j_quantize_weights(jparams, bits=8)
    want = ja.delta_perplexity(jparams, jq, jc, [TOKENS])
    # the port's own quantization of the carried weights gives JAX's tree
    got = ta.delta_perplexity(_port(jparams), quantize_decoder_weights(_port(jparams), 8),
                              tc, [TOKENS])
    assert list(got) == list(want)
    for key in ("ppl_dense", "ppl_quant"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL)
    assert got["ppl_dense"] > 1.0 and abs(got["relative"]) < 0.05
    np.testing.assert_allclose(got["delta"], got["ppl_quant"] - got["ppl_dense"])


def test_perplexity_of_a_uniform_model_is_the_vocabulary(jparams):
    _, tc = _configs()
    tparams = _port(jparams)
    tparams["lm_head"] = torch.zeros_like(tparams["lm_head"])
    ppl = ta.perplexity(tparams, tc, [TOKENS])
    assert abs(ppl - 61) / 61 < 1e-4
    with pytest.raises(ValueError, match="no valid tokens"):
        ta.perplexity(tparams, tc, [])


# ----------------------------------------------------------------------------
# quant/gates.py
# ----------------------------------------------------------------------------


def test_thresholds_match_jax():
    assert tg.KURTOSIS_THRESHOLDS == jg.KURTOSIS_THRESHOLDS


@pytest.mark.parametrize("target", ["activations", "weights"])
def test_gates_match_jax(target):
    stats = {f"t{i}": {"kurtosis": k} for i, k in
             enumerate([-1.0, 0.5, 1.0, 2.9, 3.0, 11.0, 12.5, 49.0, 149.0, 151.0])}
    for bits in (8, 4, -8):
        assert tg.outlier_gate(stats, bits, target) == jg.outlier_gate(stats, bits, target)
    assert tg.gate_report(stats, target) == jg.gate_report(stats, target)
    with pytest.raises(ValueError, match="bits"):
        tg.outlier_gate(stats, 2, target)
    with pytest.raises(ValueError, match="target"):
        tg.outlier_gate(stats, 8, "logits")


def test_decoder_taps_to_gate_report(jparams):
    """The workflow: stream the decoder's taps, then gate them, on both
    packages: the same verdicts."""
    jc, tc = _configs()
    names = [f"layers.{i}.attention.output" for i in range(2)]
    tparams = _port(jparams)

    def japply(t):
        return jm.decoder_forward(jparams, jc, t, collect_taps=True)

    def tapply(t):
        return tm.decoder_forward(tparams, tc, t, collect_taps=True)

    jh, js = ja.register_activation_hooks(japply, names)
    th, ts = ta.register_activation_hooks(tapply, names, device="cpu")
    for seed in range(2):
        toks = np.random.RandomState(10 + seed).randint(0, 61, (2, 12)).astype(np.int32)
        _, js = jh(js, jnp.asarray(toks))
        _, ts = th(ts, torch.from_numpy(toks).long())
    jd, td = ja.activation_stats_to_dict(js), ta.activation_stats_to_dict(ts)
    for name in names:
        assert td[name]["n_samples"] == 4
        for key in ("kurtosis", "skewness", "variance", "mean"):
            np.testing.assert_allclose(td[name][key], jd[name][key], rtol=1e-4, atol=1e-5)
    got, want = tg.gate_report(td), jg.gate_report(jd)
    assert {n: {k: v for k, v in e.items() if k != "kurtosis"} for n, e in got.items()} == \
        {n: {k: v for k, v in e.items() if k != "kurtosis"} for n, e in want.items()}


def test_exports_match_jax():
    from flash_attention_softmax_n_tpu import models as jmodels
    from flash_attention_softmax_n_tpu_torch import models as tmodels
    assert ta.__all__ == ja.__all__
    assert tmodels.__all__ == jmodels.__all__
    assert all(hasattr(ta, n) for n in ta.__all__)
    assert all(hasattr(tmodels, n) for n in tmodels.__all__)
