"""Port parity: fp8 e4m3 weights and KV caches, and the fused projections,
against the JAX package.

fp8 values are compared as their bytes (uint8 views) and must be equal:
both sides cast f32 to e4m3 with round-to-nearest-even, and the absmax
scales keep every value within +-448, where the two casts agree. Logits on
the f32 TINY config are held within 1e-5 (summation order), and greedy
and engine tokens must be equal.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu import models as jm
from flash_attention_softmax_n_tpu.engine import InferenceEngine as JEngine
from flash_attention_softmax_n_tpu.engine import engine as jeng
from flash_attention_softmax_n_tpu.kernels import cache_update as jcu
from flash_attention_softmax_n_tpu.quant import kv_cache as jkv
from flash_attention_softmax_n_tpu.quant import qtensor as jq
from flash_attention_softmax_n_tpu.quant.weights import (
    fuse_decoder_projections as j_fuse,
    quantize_decoder_weights as j_quantize_weights,
)
from flash_attention_softmax_n_tpu_torch import models as tm
from flash_attention_softmax_n_tpu_torch.convert import (
    params_from_jax,
    tensor_from_numpy,
)
from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
from flash_attention_softmax_n_tpu_torch.engine import engine as teng
from flash_attention_softmax_n_tpu_torch.kernels import cache_update as tcu
from flash_attention_softmax_n_tpu_torch.quant import kv_cache as tkv
from flash_attention_softmax_n_tpu_torch.quant import qtensor as tq
from flash_attention_softmax_n_tpu_torch.quant.weights import (
    fuse_decoder_projections as t_fuse,
    quantize_decoder_weights as t_quantize_weights,
)

torch.set_num_threads(2)
TOL = 1e-5
TINY_KW = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=64, max_seq_len=128, softmax_n=1.0)
TOKENS = np.random.RandomState(0).randint(0, 97, size=(2, 11)).astype(np.int32)
PROMPTS = [[1, 2, 3], [10, 20, 30, 40, 50, 60], [7], [80, 81], [5] * 40,
           [3, 14, 15, 92, 65]]
BUDGETS = [11, 4, 9, 1, 12, 7]


def _t(a):
    return tensor_from_numpy(a, "cpu")


def _u8(a):
    """fp8 values as their bytes (numpy uint8), from either side"""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _configs(**kw):
    return (jm.DecoderConfig(**TINY_KW, dtype=jnp.float32, **kw),
            tm.DecoderConfig(**TINY_KW, dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def jparams():
    return jm.init_decoder_params(_configs()[0], jax.random.PRNGKey(0))


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("axis", [-1, 0, -2])
def test_quantize_fp8_bytes_match_jax(axis):
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 40, 24) * np.exp(rng.randn(3, 40, 24))).astype(np.float32)
    x[0, :, 0] = 0.0
    x[1, 3, :] = np.linspace(-1e4, 1e4, 24)  # the slice's max maps to 448
    j = jq.quantize(jnp.asarray(x), bits=-8, axis=axis)
    t = tq.quantize(_t(x), bits=-8, axis=axis)
    np.testing.assert_array_equal(_u8(t.values), _u8(j.values))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))


def test_quantize_kv_fp8_bytes_match_jax():
    x = np.random.RandomState(2).randn(2, 3, 17, 32).astype(np.float32) * 3
    x[0, 0, 4] = 0.0
    jv, js = jkv.quantize_kv(jnp.asarray(x), -8)
    tv, ts = tkv.quantize_kv(_t(x), -8)
    np.testing.assert_array_equal(_u8(tv), _u8(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="bits"):
        tkv.quantize_kv(_t(x), 4)


def test_quantize_decoder_weights_fp8_bit_exact(jparams):
    want = _port(j_quantize_weights(jparams, -8))
    got = t_quantize_weights(_port(jparams), -8)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        g, w = got["layers"][name], want["layers"][name]
        assert g.bits == w.bits == -8
        assert torch.equal(g.values.view(torch.uint8), w.values.view(torch.uint8))
        assert torch.equal(g.scales, w.scales)
    assert torch.equal(got["lm_head"].values.view(torch.uint8),
                       want["lm_head"].values.view(torch.uint8))
    assert torch.equal(got["embed"], want["embed"])


def test_convert_carries_fp8_leaves_and_arrays():
    a = (np.random.RandomState(3).randn(4, 6) * 100).astype(ml_dtypes.float8_e4m3fn)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_u8(t), a.view(np.uint8))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    jqt = jq.quantize(jnp.asarray(np.random.RandomState(4).randn(2, 8, 5)
                                  .astype(np.float32)), bits=-8, axis=-2)
    tree = params_from_jax(jax.tree.map(np.asarray, {"layers": {"wq": jqt}}),
                           device="cpu")
    qt = tree["layers"]["wq"]
    assert isinstance(qt, tq.QTensor) and qt.bits == -8 and qt.packed_axis is None
    np.testing.assert_array_equal(_u8(qt.values), _u8(jqt.values))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(jqt.scales))


@pytest.mark.parametrize("bits", [None, 8, -8])
def test_fuse_decoder_projections_matches_jax(jparams, bits):
    jf = j_fuse(jparams)
    tf = t_fuse(_port(jparams))
    assert set(tf["layers"]) == set(jf["layers"])
    for name in ("wqkv", "w_gu"):
        assert torch.equal(tf["layers"][name], _t(np.asarray(jf["layers"][name])))
    assert "wq" not in tf["layers"] and "w_gate" not in tf["layers"]
    if bits is not None:
        jf, tf = j_quantize_weights(jf, bits), t_quantize_weights(tf, bits)
    jc, tc = _configs(attn_implementation="xla")
    want = np.asarray(jm.decoder_forward(jf, jc, jnp.asarray(TOKENS)))
    got = tm.decoder_forward(tf, tc, torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_fused_projections_compute_the_unfused_decoder(jparams):
    _, tc = _configs(attn_implementation="xla")
    tp = _port(jparams)
    tokens = torch.from_numpy(TOKENS).long()
    torch.testing.assert_close(tm.decoder_forward(t_fuse(tp), tc, tokens),
                               tm.decoder_forward(tp, tc, tokens), atol=TOL, rtol=0)


@pytest.mark.parametrize("fp8_weights", [False, True])
def test_prefill_and_decode_step_with_fp8_cache(jparams, fp8_weights):
    jc, tc = _configs()
    jp = j_quantize_weights(jparams, -8) if fp8_weights else jparams
    tp = _port(jp)
    jcache = jm.init_kv_cache(jc, 2, max_len=16, quantization="fp8")
    tcache = tm.init_kv_cache(tc, 2, max_len=16, quantization="fp8", device="cpu")
    jl, jcache = jm.prefill(jp, jc, jnp.asarray(TOKENS), jcache)
    tl, tcache = tm.prefill(tp, tc, torch.from_numpy(TOKENS).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    tok = np.array([5, 60], np.int32)
    for _ in range(3):
        jl, jcache = jm.decode_step(jp, jc, jnp.asarray(tok), jcache)
        tl, tcache = tm.decode_step(tp, tc, torch.from_numpy(tok).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for name in ("k", "v"):
        assert tcache[name].bits == -8
        np.testing.assert_array_equal(_u8(tcache[name].values),
                                      _u8(jcache[name].values))


def test_cached_attention_quantized_fp8_matches_jax():
    rng = np.random.RandomState(5)
    q = rng.randn(2, 4, 1, 16).astype(np.float32)
    kc, vc = (rng.randn(2, 2, 10, 16).astype(np.float32) for _ in range(2))
    jk, jv = (jq.QTensor(*jkv.quantize_kv(jnp.asarray(a), -8), bits=-8) for a in (kc, vc))
    tk, tv = (tq.QTensor(*tkv.quantize_kv(_t(a), -8), bits=-8) for a in (kc, vc))
    for cd_j, cd_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jkv.cached_attention_quantized(
            jnp.asarray(q), jk, jv, 7, softmax_n_param=1.0, scale=0.25,
            compute_dtype=cd_j)
        got = tkv.cached_attention_quantized(
            _t(q), tk, tv, 7, softmax_n_param=1.0, scale=0.25, compute_dtype=cd_t)
        want = np.asarray(want, np.float32)
        # bf16 outputs: one bf16 ulp of |out| apart at most
        tol = TOL if cd_t == torch.float32 else 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_cache_append_fp8_bytes_match_jax():
    rng = np.random.RandomState(6)
    nl, b, kvh, s, d = 2, 3, 2, 16, 8
    vals = (rng.randn(nl, b, kvh, s, d) * 50).astype(ml_dtypes.float8_e4m3fn)
    scls = rng.rand(nl, b, kvh, s, 1).astype(np.float32)
    new_v = (rng.randn(nl, b, kvh, d) * 50).astype(ml_dtypes.float8_e4m3fn)
    new_s = rng.rand(nl, b, kvh, 1).astype(np.float32)
    pos = np.array([0, 9, 15], np.int32)
    jv, js = jcu.cache_append((jnp.asarray(vals), jnp.asarray(scls)),
                              (jnp.asarray(new_v), jnp.asarray(new_s)),
                              jnp.asarray(pos))
    tv, ts = _t(vals), _t(scls)
    out = tcu.cache_append((tv, ts), (_t(new_v), _t(new_s)), _t(pos))
    assert out[0] is tv and tv.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_u8(tv), _u8(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("base", [[0, 30], [60, 3]])  # 60 + 8 > 64: the guard
def test_flush_tail_fp8_matches_jax(base):
    rng = np.random.RandomState(7)
    nl, b, kvh, s, w, hd = 2, 2, 2, 64, 8, 16
    k_tail, v_tail = (rng.randn(nl, b, kvh, w, hd).astype(np.float32) for _ in range(2))
    vals = (rng.randn(nl, b, kvh, s, hd) * 50).astype(ml_dtypes.float8_e4m3fn)
    scl = rng.rand(nl, b, kvh, s, 1).astype(np.float32)
    jc = [jq.QTensor(jnp.asarray(vals), jnp.asarray(scl), bits=-8) for _ in range(2)]
    tc = [tq.QTensor(_t(vals), _t(scl), bits=-8) for _ in range(2)]
    base = np.array(base, np.int32)
    jcfg, tcfg = _configs(attn_implementation="xla")
    jk, jv = jeng._flush_tail(jcfg, jc[0], jc[1], jnp.asarray(k_tail),
                              jnp.asarray(v_tail), jnp.asarray(base))
    teng._flush_tail(tcfg, tc[0], tc[1], torch.from_numpy(k_tail),
                     torch.from_numpy(v_tail), torch.from_numpy(base))
    for j, t in ((jk, tc[0]), (jv, tc[1])):
        np.testing.assert_array_equal(_u8(t.values), _u8(j.values))
        np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))


def _serve(engine, loop_steps):
    for p, n in zip(PROMPTS, BUDGETS):
        engine.submit(p, max_new_tokens=n)
    done = engine.run_until_done(loop_steps=loop_steps)
    return {r.request_id: r.output for r in done}


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("loop_steps", [None, 8])
def test_engine_fp8_tokens_match_jax(jparams, route, loop_steps):
    # fp8 weights and an fp8 KV cache; 6 requests through 4 slots, step by
    # step (K3 writes fp8 rows) and through the fused loop (K4's ring, the
    # flush quantizing it), decode attention on either route
    jc, tc = _configs(attn_implementation="xla", decode_attn_impl=route)
    jp = j_quantize_weights(jparams, -8)
    want = _serve(JEngine(jc, jp, max_batch=4, max_len=64, kv_quantization="fp8",
                          piggyback_prefill=False), loop_steps)
    eng = InferenceEngine(tc, _port(jp), max_batch=4, max_len=64,
                          kv_quantization="fp8", piggyback_prefill=False,
                          device="cpu")
    assert eng.cache["k"].values.dtype == torch.float8_e4m3fn
    got = _serve(eng, loop_steps)
    assert got == want
    assert [len(got[i]) for i in range(len(BUDGETS))] == BUDGETS
