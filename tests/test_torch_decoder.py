"""Port parity: the decoder on the f32 TINY config of tests/test_engine.py.

JAX's parameters cross over with ``params_from_jax``. Logits of
``decoder_forward``, ``prefill`` and ``decode_step`` are held within 1e-5
(f32 throughout; summation order differs), and ``greedy_generate`` tokens
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu import models as jm
from flash_attention_softmax_n_tpu.quant.weights import (
    quantize_decoder_weights as j_quantize_weights,
)
from flash_attention_softmax_n_tpu_torch import models as tm
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.quant.weights import (
    quantize_decoder_weights as t_quantize_weights,
)

torch.set_num_threads(2)
TOL = 1e-5
TINY_KW = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=64, max_seq_len=128, softmax_n=1.0)


def _configs(attn_implementation="xla"):
    return (jm.DecoderConfig(**TINY_KW, dtype=jnp.float32,
                             attn_implementation=attn_implementation),
            tm.DecoderConfig(**TINY_KW, dtype=torch.float32,
                             attn_implementation=attn_implementation))


@pytest.fixture(scope="module")
def jparams():
    return jm.init_decoder_params(_configs()[0], jax.random.PRNGKey(0))


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


TOKENS = np.random.RandomState(0).randint(0, 97, size=(2, 11)).astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("int8_weights", [False, True])
def test_decoder_forward_logits(jparams, impl, int8_weights):
    jc, tc = _configs(impl)
    jp = j_quantize_weights(jparams, 8) if int8_weights else jparams
    want = np.asarray(jm.decoder_forward(jp, jc, jnp.asarray(TOKENS)))
    got = tm.decoder_forward(_port(jp), tc, torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_prefill_and_decode_step_logits(jparams, quantization):
    jc, tc = _configs()
    tp = _port(jparams)
    jcache = jm.init_kv_cache(jc, 2, max_len=16, quantization=quantization)
    tcache = tm.init_kv_cache(tc, 2, max_len=16, quantization=quantization,
                              device="cpu")
    jl, jcache = jm.prefill(jparams, jc, jnp.asarray(TOKENS), jcache)
    tl, tcache = tm.prefill(tp, tc, torch.from_numpy(TOKENS).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    tok = np.array([5, 60], np.int32)
    for _ in range(3):
        jl, jcache = jm.decode_step(jparams, jc, jnp.asarray(tok), jcache)
        tl, tcache = tm.decode_step(tp, tc, torch.from_numpy(tok).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert tcache["length"] == int(jcache["length"])


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_greedy_generate_tokens(jparams, quantization):
    jc, tc = _configs()
    want = np.asarray(jm.greedy_generate(jparams, jc, jnp.asarray(TOKENS), 7,
                                         kv_quantization=quantization))
    got = tm.greedy_generate(_port(jparams), tc, TOKENS, 7,
                             kv_quantization=quantization, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_decoder_params_shapes_and_seed():
    _, tc = _configs()
    a = tm.init_decoder_params(tc, 3, device="cpu")
    b = tm.init_decoder_params(tc, torch.Generator().manual_seed(3),
                               device="cpu")
    ref = jm.init_decoder_params(_configs()[0], jax.random.PRNGKey(0))
    assert ({k: tuple(v.shape) for k, v in a["layers"].items()}
            == {k: v.shape for k, v in ref["layers"].items()})
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(a[name].shape) == ref[name].shape
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])


def test_fp8_weights_and_config_validation(jparams):
    # the all-kernel routes, W8A8 and fp8 weights run; unknown routes,
    # act_bits and bit widths raise. fp8 weights (dequantized inline, as
    # JAX does) give JAX's logits within TOL and, with an fp8 KV cache,
    # JAX's greedy tokens.
    cfg = tm.DecoderConfig(**TINY_KW, int8_mm_impl="pallas",
                           decode_attn_impl="pallas", act_bits=8)
    assert (cfg.int8_mm_impl, cfg.decode_attn_impl, cfg.act_bits) == (
        "pallas", "pallas", 8)
    for kw in (dict(int8_mm_impl="mosaic"), dict(decode_attn_impl="triton"),
               dict(act_bits=4)):
        with pytest.raises(ValueError):
            tm.DecoderConfig(**TINY_KW, **kw)
    params = tm.init_decoder_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="bits"):
        t_quantize_weights(params, 2)
    jc, tc = _configs()
    jp = j_quantize_weights(jparams, -8)
    tp = t_quantize_weights(_port(jparams), -8)
    assert tp["layers"]["wq"].values.dtype == torch.float8_e4m3fn
    want = np.asarray(jm.decoder_forward(jp, jc, jnp.asarray(TOKENS)))
    got = tm.decoder_forward(tp, tc, torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    want = np.asarray(jm.greedy_generate(jp, jc, jnp.asarray(TOKENS), 7,
                                         kv_quantization="fp8"))
    got = tm.greedy_generate(tp, tc, TOKENS, 7, kv_quantization="fp8",
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
