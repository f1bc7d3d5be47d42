"""Port parity on the all-kernel serving routes: the decoder and the engine
with ``int8_mm_impl="pallas"`` (the dequant matmul K7 and the fused MLP
K9), W8A8 (``act_bits=8``), grouped int4 weights and
``decode_attn_impl="pallas"`` (K8), against the JAX package with its
Pallas kernels in interpret mode.

The f32 config has d_model 128 and d_ff 256, the smallest at which JAX
routes the decode MLP to its fused kernel (``mlp_fusion_eligible`` needs
K % 128 == 0) and an int4 weight to its kernel (``w_down``, K = 256; the
K = 128 projections dequantize inline). Logits are held within 1e-4 (f32
sums in another order), tokens equal. W8A8 rounds the activations to int8
at every matmul, so an ulp of difference upstream (the two rms_norms
differ in the last place) can move one activation by one int8 step and a
logit by about 1e-2 downstream; the tokens below were checked to hit no
such step (the tokens of seed 0 hit one in ``decoder_forward``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu import models as jm
from flash_attention_softmax_n_tpu.engine import InferenceEngine as JEngine
from flash_attention_softmax_n_tpu.models import decoder as jdec
from flash_attention_softmax_n_tpu.quant.weights import (
    quantize_decoder_weights as j_quantize_weights,
)
from flash_attention_softmax_n_tpu_torch import models as tm
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
from flash_attention_softmax_n_tpu_torch.kernels import decode_attention as tda
from flash_attention_softmax_n_tpu_torch.models import decoder as tdec

torch.set_num_threads(2)
TOL = 1e-4
KW = dict(vocab_size=97, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=256, max_seq_len=128, softmax_n=1.0, attn_implementation="xla",
          int8_mm_impl="pallas", decode_attn_impl="pallas")
JCFG = jm.DecoderConfig(**KW, dtype=jnp.float32)
TCFG = tm.DecoderConfig(**KW, dtype=torch.float32)
# (weight bits, act_bits)
MODES = {"int8": (8, None), "w8a8": (8, 8), "int4": (4, None),
         "int4_w4a8": (4, 8)}
TOKENS = np.random.RandomState(1).randint(0, 97, size=(2, 11)).astype(np.int32)


@pytest.fixture(scope="module")
def jparams():
    return jm.init_decoder_params(JCFG, jax.random.PRNGKey(0))


def _setup(jparams, mode):
    bits, act_bits = MODES[mode]
    jp = j_quantize_weights(jparams, bits)
    return (jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
            dataclasses.replace(JCFG, act_bits=act_bits),
            dataclasses.replace(TCFG, act_bits=act_bits))


@pytest.fixture
def calls(monkeypatch):
    """Counts of the calls of K7, K9 and K8's route (plain versions here)."""
    seen = {"qmm": 0, "fused_mlp": 0, "decode_attn": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tdec, "quantized_matmul",
                        counting("qmm", tdec.quantized_matmul))
    monkeypatch.setattr(tdec, "fused_mlp_matmul",
                        counting("fused_mlp", tdec.fused_mlp_matmul))
    monkeypatch.setattr(tda, "_decode_attn_stats",
                        counting("decode_attn", tda._decode_attn_stats))
    return seen


def test_the_decode_mlp_takes_the_fused_kernel(jparams):
    jp, tp, jc, tc = _setup(jparams, "int8")
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    assert jdec._mlp_fusable(jnp.zeros((2, 1, 128)), jlp, None, "pallas")
    tlp = tdec.layer_views(tp["layers"])[0]
    assert tdec._mlp_fusable(torch.zeros(2, 1, 128), tlp, None, "pallas")
    assert not tdec._mlp_fusable(torch.zeros(2, 3, 128), tlp, None, "pallas")
    assert not tdec._mlp_fusable(torch.zeros(2, 1, 128), tlp, 8, "pallas")
    assert not tdec._mlp_fusable(torch.zeros(2, 1, 128), tlp, None, "xla")
    # int4 layers keep their packing when unbound
    t4 = tdec.layer_views(_setup(jparams, "int4")[1]["layers"])[0]
    assert t4["w_down"].packed_axis == -2 and t4["w_down"].logical_shape == (256, 128)


@pytest.mark.parametrize("mode", list(MODES))
def test_decoder_forward_logits(jparams, calls, mode):
    jp, tp, jc, tc = _setup(jparams, mode)
    want = np.asarray(jm.decoder_forward(jp, jc, jnp.asarray(TOKENS)))
    got = tm.decoder_forward(tp, tc, torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # per layer: int8 all 7 matmuls, int4 only w_down (K = 256); lm_head
    # (K = 128) on K7 for int8 only
    assert calls["qmm"] == (7 * 2 + 1 if MODES[mode][0] == 8 else 2)
    assert calls["fused_mlp"] == 0  # L = 11: prefill shape


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_and_decode_step_logits(jparams, calls, mode):
    jp, tp, jc, tc = _setup(jparams, mode)
    jcache = jm.init_kv_cache(jc, 2, max_len=16, quantization="int8")
    tcache = tm.init_kv_cache(tc, 2, max_len=16, quantization="int8",
                              device="cpu")
    jl, jcache = jm.prefill(jp, jc, jnp.asarray(TOKENS), jcache)
    tl, tcache = tm.prefill(tp, tc, torch.from_numpy(TOKENS).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    tok = np.array([5, 60], np.int32)
    for _ in range(3):
        jl, jcache = jm.decode_step(jp, jc, jnp.asarray(tok), jcache)
        tl, tcache = tm.decode_step(tp, tc, torch.from_numpy(tok).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    fused = MODES[mode] == (8, None)
    assert calls["fused_mlp"] == (3 * 2 if fused else 0)


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_generate_tokens(jparams, mode):
    jp, tp, jc, tc = _setup(jparams, mode)
    want = np.asarray(jm.greedy_generate(jp, jc, jnp.asarray(TOKENS), 6,
                                         kv_quantization="int8"))
    got = tm.greedy_generate(tp, tc, TOKENS, 6, kv_quantization="int8",
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


PROMPTS = [[1, 2, 3], [10, 20, 30, 40, 50, 60], [7], [80, 81], [5] * 40,
           [3, 14, 15, 92, 65]]


def _serve(engine, loop_steps, budgets):
    for p, n in zip(PROMPTS, budgets):
        engine.submit(p, max_new_tokens=n)
    done = engine.run_until_done(loop_steps=loop_steps)
    return {r.request_id: r.output for r in done}


@pytest.mark.parametrize("loop_steps", [None, 8])
def test_engine_tokens_match_jax(jparams, calls, loop_steps):
    jp, tp, jc, tc = _setup(jparams, "int8")
    budgets = [11, 4, 9, 1, 12, 7]
    want = _serve(JEngine(jc, jp, max_batch=4, max_len=64,
                          kv_quantization="int8", piggyback_prefill=False),
                  loop_steps, budgets)
    got = _serve(InferenceEngine(tc, tp, max_batch=4, max_len=64,
                                 kv_quantization="int8",
                                 piggyback_prefill=False, device="cpu"),
                 loop_steps, budgets)
    assert got == want
    assert [len(got[i]) for i in range(len(budgets))] == budgets
    assert calls["qmm"] > 0 and calls["fused_mlp"] > 0 and calls["decode_attn"] > 0
