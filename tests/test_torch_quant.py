"""Port parity: int8 quantization and the plain versions of kernels K2, K3
and K4 against the JAX package (Pallas kernels in interpret mode).

Quantization and the cache writes are held bit-exact (both sides divide in
f32 and round half to even); the argmax's indices must be equal wherever
the top-2 logit gap exceeds 1e-4, and its max logits agree within 1e-5
relative (f32 accumulation in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.kernels import cache_update as jcu
from flash_attention_softmax_n_tpu.kernels.quant_matmul import (
    quantized_matmul_argmax as j_qmm_argmax,
)
from flash_attention_softmax_n_tpu.models import (
    DecoderConfig as JConfig,
    init_decoder_params as j_init,
)
from flash_attention_softmax_n_tpu.quant import kv_cache as jkv
from flash_attention_softmax_n_tpu.quant import qtensor as jq
from flash_attention_softmax_n_tpu.quant.weights import (
    quantize_decoder_weights as j_quantize_weights,
)
from flash_attention_softmax_n_tpu_torch.convert import (
    params_from_jax,
    tensor_from_numpy,
)
from flash_attention_softmax_n_tpu_torch.kernels import cache_update as tcu
from flash_attention_softmax_n_tpu_torch.kernels.quant_matmul import (
    quantized_matmul_argmax as t_qmm_argmax,
)
from flash_attention_softmax_n_tpu_torch.quant import kv_cache as tkv
from flash_attention_softmax_n_tpu_torch.quant import qtensor as tq
from flash_attention_softmax_n_tpu_torch.quant.weights import (
    quantize_decoder_weights as t_quantize_weights,
)

torch.set_num_threads(2)


def _t(a):
    return tensor_from_numpy(a, "cpu")


@pytest.mark.parametrize("axis", [-1, 0, -2])
def test_quantize_bit_exact(axis):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 40, 24).astype(np.float32)
    x[0, :, 0] = 0.0  # an all-zero slice takes scale 0
    x[1, 5, :] = np.linspace(-2.5, 2.5, 24)  # values on .5 boundaries
    jqt = jq.quantize(jnp.asarray(x), bits=8, axis=axis)
    tqt = tq.quantize(_t(x), bits=8, axis=axis)
    np.testing.assert_array_equal(tqt.values.numpy(), np.asarray(jqt.values))
    np.testing.assert_array_equal(tqt.scales.numpy(), np.asarray(jqt.scales))
    np.testing.assert_array_equal(tq.dequantize(tqt).numpy(),
                                  np.asarray(jq.dequantize(jqt)))


def test_quantize_kv_bit_exact():
    x = np.random.RandomState(1).randn(2, 3, 17, 32).astype(np.float32) * 3
    jv, js = jkv.quantize_kv(jnp.asarray(x), 8)
    tv, ts = tkv.quantize_kv(_t(x), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_decoder_weights_bit_exact():
    cfg = JConfig(vocab_size=50, d_model=32, n_layers=2, n_heads=4,
                  n_kv_heads=2, d_ff=48, max_seq_len=16, dtype=jnp.float32)
    jp = j_init(cfg, jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree.map(np.asarray, j_quantize_weights(jp, 8)),
                           device="cpu")
    got = t_quantize_weights(params_from_jax(jax.tree.map(np.asarray, jp),
                                             device="cpu"), 8)
    for name in ("wq", "w_down"):
        assert got["layers"][name].scales.shape == (2, 1, want["layers"][
            name].values.shape[-1])
        assert torch.equal(got["layers"][name].values, want["layers"][name].values)
        assert torch.equal(got["layers"][name].scales, want["layers"][name].scales)
    assert torch.equal(got["lm_head"].values, want["lm_head"].values)
    assert torch.equal(got["embed"], want["embed"])


def _u8(a):
    """fp8 values as their bytes (numpy uint8), from either side"""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def test_int4_and_fp8_quantize_match_jax():
    # int4 quantizes (packed along the scale's axis) and fp8 gives JAX's
    # bytes; bit widths and cache modes outside those raise
    x = torch.ones(4, 8)
    q4 = tq.quantize(x, bits=4, axis=0)
    assert (q4.bits, q4.packed_axis, tuple(q4.values.shape)) == (4, -2, (2, 8))
    assert q4.logical_shape == (4, 8)
    assert torch.equal(tq.dequantize(q4), x)
    xf = np.random.RandomState(5).randn(6, 40).astype(np.float32) * 30
    xf[2] = 0.0  # a slice of zeros takes scale 0
    jq8 = jq.quantize(jnp.asarray(xf), bits=-8, axis=-1)
    tq8 = tq.quantize(_t(xf), bits=-8, axis=-1)
    assert (tq8.bits, tq8.values.dtype) == (-8, torch.float8_e4m3fn)
    np.testing.assert_array_equal(_u8(tq8.values), _u8(jq8.values))
    np.testing.assert_array_equal(tq8.scales.numpy(), np.asarray(jq8.scales))
    np.testing.assert_array_equal(tq.dequantize(tq8).numpy(),
                                  np.asarray(jq.dequantize(jq8)))
    jc = jkv.init_quantized_kv_cache(2, 3, 2, 8, 16, mode="fp8")
    tc = tkv.init_quantized_kv_cache(2, 3, 2, 8, 16, mode="fp8", device="cpu")
    for name in ("k", "v"):
        assert tc[name].bits == jc[name].bits == -8
        np.testing.assert_array_equal(_u8(tc[name].values), _u8(jc[name].values))
        np.testing.assert_array_equal(tc[name].scales.numpy(),
                                      np.asarray(jc[name].scales))
    assert tc["k"].values.data_ptr() != tc["v"].values.data_ptr()
    with pytest.raises(ValueError, match="bits"):
        tq.quantize(x, bits=2)
    with pytest.raises(ValueError, match="mode"):
        tkv.init_quantized_kv_cache(1, 1, 1, 4, 8, mode="int4", device="cpu")


@pytest.mark.parametrize("m", [1, 8, 13])
def test_qmm_argmax_matches_pallas(m):
    rng = np.random.RandomState(m)
    k, n = 256, 1000
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    s = (rng.rand(1, n).astype(np.float32) + 0.5) / 127.0
    j_idx, j_val = j_qmm_argmax(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                return_max=True)
    t_idx, t_val = t_qmm_argmax(_t(x), _t(w), _t(s), return_max=True)
    assert t_idx.dtype == torch.int32
    logits = (x.astype(np.float64) @ w.astype(np.float64)) * s
    top2 = np.sort(logits, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(t_idx.numpy()[decided],
                                  np.asarray(j_idx)[decided])
    np.testing.assert_allclose(t_val.numpy(), np.asarray(j_val), rtol=1e-5)


def test_qmm_argmax_first_index_wins_ties():
    x = torch.ones(2, 4)
    w = torch.zeros(4, 6, dtype=torch.int8)
    w[:, 2] = 1
    w[:, 4] = 1  # columns 2 and 4 tie
    idx = t_qmm_argmax(x, w, torch.ones(6))
    assert idx.tolist() == [2, 2]


@pytest.mark.parametrize("m", [1, 3])
def test_qmm_argmax_tie_across_tiles_matches_pallas(m):
    # equal maxima at columns 130 and 300 of N1000: different 128-column
    # tiles of the port's kernel and, at block_k 16384 (which caps JAX's
    # vocab block at 256 columns), different blocks of JAX's grid
    k, n = 256, 1000
    rng = np.random.RandomState(m)
    x = np.ones((m, k), np.float32)
    w = rng.randint(-3, 2, size=(k, n)).astype(np.int8)
    w[:, [130, 300]] = 1  # logit k; every other column sums to less
    s = np.ones((1, n), np.float32)
    j_idx, j_val = j_qmm_argmax(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                block_k=16384, return_max=True)
    t_idx, t_val = t_qmm_argmax(_t(x), _t(w), _t(s), return_max=True)
    assert np.asarray(j_idx).tolist() == t_idx.tolist() == [130] * m
    assert np.asarray(j_val).tolist() == t_val.tolist() == [float(k)] * m


# one int8 value plane with its scales; the engine's four-tensor call, k and
# v values (64-byte rows) with their scale planes (4-byte rows)
@pytest.mark.parametrize("planes,d", [(1, 8), (2, 64)])
def test_cache_append_bit_exact_and_in_place(planes, d):
    rng = np.random.RandomState(2)
    nl, b, kvh, s = 2, 3, 2, 16
    caches, news = [], []
    for _ in range(planes):
        caches += [rng.randint(-128, 128, size=(nl, b, kvh, s, d)).astype(np.int8),
                   rng.rand(nl, b, kvh, s, 1).astype(np.float32)]
        news += [rng.randint(-128, 128, size=(nl, b, kvh, d)).astype(np.int8),
                 rng.rand(nl, b, kvh, 1).astype(np.float32)]
    pos = np.array([0, 9, 15], np.int32)
    want = jcu.cache_append(tuple(map(jnp.asarray, caches)), tuple(map(jnp.asarray, news)),
                            jnp.asarray(pos))
    got = tuple(map(_t, caches))
    out = tcu.cache_append(got, tuple(map(_t, news)), _t(pos))
    assert len(out) == len(got) and all(o is g for o, g in zip(out, got))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# a ring index inside the ring, and at both of its ends (0 and W - 1)
@pytest.mark.parametrize("index", [5, 0, 7])
def test_tail_append_bit_exact_and_in_place(index):
    rng = np.random.RandomState(3)
    shape = (2, 3, 2, 8, 16)
    kt, vt = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(*shape[:3], 16).astype(np.float32) for _ in range(2))
    jk, jv = jcu.tail_append(jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(kn),
                             jnp.asarray(vn), jnp.asarray(index, jnp.int32))
    tk, tv = _t(kt), _t(vt)
    out = tcu.tail_append(tk, tv, _t(kn), _t(vn), index)
    assert out[0] is tk and out[1] is tv
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantized_cached_attention_matches_jax():
    # decode_step's int8 cache attention (greedy_generate with int8 KV)
    rng = np.random.RandomState(4)
    q = rng.randn(2, 4, 1, 16).astype(np.float32)
    kc = rng.randn(2, 2, 10, 16).astype(np.float32)
    vc = rng.randn(2, 2, 10, 16).astype(np.float32)
    jk, jv = (jq.QTensor(*jkv.quantize_kv(jnp.asarray(a), 8)) for a in (kc, vc))
    tk, tv = (tq.QTensor(*tkv.quantize_kv(_t(a), 8)) for a in (kc, vc))
    want = jkv.cached_attention_quantized(
        jnp.asarray(q), jk, jv, 7, softmax_n_param=1.0, scale=0.25,
        compute_dtype=jnp.float32)
    got = tkv.cached_attention_quantized(
        _t(q), tk, tv, 7, softmax_n_param=1.0, scale=0.25,
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
