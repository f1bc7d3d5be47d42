"""Port parity: the serving engine against the JAX engine.

On the f32 TINY config, JAX's parameters cross over with
``params_from_jax``; both engines serve the same requests, dense and int8
W+KV, step by step (``loop_steps=None``) and through the fused loop
(tail-mode chunks of 8 steps and more, shorter chunks writing the cache
each step), with and without piggybacked prefill, and must emit the same
tokens. ``prewarm`` enumerates JAX's loop variants (on the CPU it captures
nothing).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.engine import InferenceEngine as JEngine
from flash_attention_softmax_n_tpu.engine import engine as jeng
from flash_attention_softmax_n_tpu.models import (
    DecoderConfig as JConfig,
    init_decoder_params as j_init,
)
from flash_attention_softmax_n_tpu.quant.qtensor import QTensor as JQTensor
from flash_attention_softmax_n_tpu.quant.weights import (
    quantize_decoder_weights as j_quantize_weights,
)
from flash_attention_softmax_n_tpu_torch.convert import (
    params_from_jax,
    tensor_from_numpy,
)
from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
from flash_attention_softmax_n_tpu_torch.engine import engine as teng
from flash_attention_softmax_n_tpu_torch.models import DecoderConfig
from flash_attention_softmax_n_tpu_torch.ops.sampling import sample_tokens
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor

torch.set_num_threads(2)
TINY_KW = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=64, max_seq_len=128, softmax_n=1.0,
               attn_implementation="xla")
JTINY = JConfig(**TINY_KW, dtype=jnp.float32)
TTINY = DecoderConfig(**TINY_KW, dtype=torch.float32)
PROMPTS = [[1, 2, 3], [10, 20, 30, 40, 50, 60], [7], [80, 81], [5] * 40,
           [3, 14, 15, 92, 65]]


@pytest.fixture(scope="module")
def jparams():
    return j_init(JTINY, jax.random.PRNGKey(0))


def _serve(engine, loop_steps, budgets):
    for p, n in zip(PROMPTS, budgets):
        engine.submit(p, max_new_tokens=n)
    done = engine.run_until_done(loop_steps=loop_steps)
    return {r.request_id: r.output for r in done}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("loop_steps", [None, 8])
def test_engine_tokens_match_jax(jparams, int8, loop_steps):
    jp = j_quantize_weights(jparams, 8) if int8 else jparams
    kvq = "int8" if int8 else None
    budgets = [11, 4, 9, 1, 12, 7]
    # 6 requests through 4 slots: queueing, re-admission and mixed budgets
    want = _serve(JEngine(JTINY, jp, max_batch=4, max_len=64,
                          kv_quantization=kvq, piggyback_prefill=False),
                  loop_steps, budgets)
    got = _serve(InferenceEngine(TTINY, params_from_jax(
                     jax.tree.map(np.asarray, jp), device="cpu"),
                     max_batch=4, max_len=64, kv_quantization=kvq,
                     piggyback_prefill=False, device="cpu"),
                 loop_steps, budgets)
    assert got == want
    assert [len(got[i]) for i in range(len(budgets))] == budgets


def test_eos_and_counters(jparams):
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    eng = InferenceEngine(TTINY, tp, max_batch=2, max_len=64,
                          piggyback_prefill=False, device="cpu")
    full = _serve(eng, 8, [10])[0]
    eng.counters_report()
    eng.profile_report()
    # stop at the first token that did not appear before it
    stop = next(i for i in range(1, len(full)) if full[i] not in full[:i])
    eng.submit(PROMPTS[0], max_new_tokens=10, eos_token=full[stop])
    out = eng.run_until_done(loop_steps=8)[0].output
    assert out == full[:stop + 1]
    rep = eng.counters_report()
    assert rep["prefill_groups"] == 1 and 0 < rep["chunk_util"] <= 1
    assert "chunk_sync" in eng.profile_report()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("base", [[0, 30], [60, 3]])  # 60 + 8 > 64: the guard
def test_flush_tail_matches_jax(quantized, base):
    rng = np.random.RandomState(1)
    nl, b, kvh, s, w, hd = 2, 2, 2, 64, 8, 16
    k_tail = rng.randn(nl, b, kvh, w, hd).astype(np.float32)
    v_tail = rng.randn(nl, b, kvh, w, hd).astype(np.float32)
    if quantized:
        vals = rng.randint(-128, 128, size=(nl, b, kvh, s, hd)).astype(np.int8)
        scl = rng.rand(nl, b, kvh, s, 1).astype(np.float32)
        jc = [JQTensor(jnp.asarray(vals), jnp.asarray(scl)) for _ in range(2)]
        tc = [QTensor(tensor_from_numpy(vals, "cpu"), tensor_from_numpy(scl, "cpu"))
              for _ in range(2)]
    else:
        dense = rng.randn(nl, b, kvh, s, hd).astype(np.float32)
        jc = [jnp.asarray(dense)] * 2
        tc = [tensor_from_numpy(dense, "cpu") for _ in range(2)]
    base = np.array(base, np.int32)
    jk, jv = jeng._flush_tail(JTINY, jc[0], jc[1], jnp.asarray(k_tail),
                              jnp.asarray(v_tail), jnp.asarray(base))
    teng._flush_tail(TTINY, tc[0], tc[1], torch.from_numpy(k_tail),
                     torch.from_numpy(v_tail), torch.from_numpy(base))
    for j, t in ((jk, tc[0]), (jv, tc[1])):
        if quantized:
            np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
            np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_bucket_matches_jax():
    for n in (1, 32, 33, 95, 96, 97, 129, 600, 2048, 2049, 5000):
        assert teng._bucket(n) == jeng._bucket(n)


def test_sample_tokens_greedy_rows_and_top_k1():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0])
    top_k = torch.tensor([0, 1, 5, 1])
    out = sample_tokens(logits, gen, temps, top_k, torch.ones(4))
    assert torch.equal(out, torch.argmax(logits, -1).to(torch.int32))
    drawn = sample_tokens(logits, gen, torch.full((4,), 1.0))
    assert drawn.dtype == torch.int32 and ((drawn >= 0) & (drawn < 50)).all()


def test_unported_paths_raise(jparams):
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    # the piggyback default, prewarm and chunks under 8 steps are ported
    assert InferenceEngine(TTINY, tp, device="cpu").piggyback_prefill
    eng = InferenceEngine(TTINY, tp, max_batch=2, max_len=128,
                          prefill_chunk=16, device="cpu")
    assert eng.prewarm(loop_steps=8) == 2  # chunk 8, window 128, piggy
    assert not eng._graphs  # the CPU captures nothing
    eng.submit([1, 2, 3], max_new_tokens=6)
    done = eng.run_until_done(loop_steps=4)
    assert len(done[0].output) == 6 and eng.counters_report()["chunks"] == 2
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        eng.submit(list(range(40)), max_new_tokens=4)
    with pytest.raises(NotImplementedError, match="prefix cache"):
        eng.register_prefix([1] * 20)


@pytest.mark.parametrize("loop_steps", [4, 6, 8, 16])
def test_default_engine_matches_jax(jparams, loop_steps):
    # both engines on their defaults (piggyback_prefill=True, max_batch 8,
    # max_len 128); 4 and 6 are non-tail chunks (K3 writes the cache)
    budgets = [11, 4, 9, 1, 12, 7]
    want = _serve(JEngine(JTINY, jparams), loop_steps, budgets)
    got = _serve(InferenceEngine(TTINY, _port(jparams), device="cpu"),
                 loop_steps, budgets)
    assert got == want


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _churn(engine, n=14, loop_steps=8):
    """n random requests through 4 slots (prompts 1-59 tokens, some budgets
    of 1, EOS 5), as JAX's test_piggyback_parity_and_edges sends them"""
    rng = np.random.RandomState(3)
    for j in range(n):
        plen = int(rng.randint(1, 60))
        budget = 1 if j % 7 == 0 else int(rng.randint(2, 20))
        engine.submit(rng.randint(0, TINY_KW["vocab_size"], size=plen).tolist(),
                      max_new_tokens=budget, eos_token=5)
    done = engine.run_until_done(loop_steps=loop_steps)
    assert len(done) == n
    return {r.request_id: r.output for r in done}, engine.counters_report()


@pytest.mark.parametrize("int8", [False, True])
def test_piggyback_tokens_match_jax(jparams, int8):
    jp = j_quantize_weights(jparams, 8) if int8 else jparams
    kvq = "int8" if int8 else None
    want, jrep = _churn(JEngine(JTINY, jp, max_batch=4, max_len=128,
                                kv_quantization=kvq))
    got, rep = _churn(InferenceEngine(TTINY, _port(jp), max_batch=4,
                                      max_len=128, kv_quantization=kvq,
                                      device="cpu"))
    assert rep.get("piggyback_prompts", 0) > 0, "nothing was piggybacked"
    assert rep["piggyback_prompts"] == jrep["piggyback_prompts"]
    assert got == want


def test_piggyback_parity_and_edges(jparams):
    # piggybacked admission against classic admission on the port, across
    # mixed budgets, EOS on the first token and budget-1 requests
    tp = _port(jparams)
    with_piggy, rep = _churn(InferenceEngine(
        TTINY, tp, max_batch=4, max_len=128, device="cpu"), loop_steps=16)
    assert rep.get("piggyback_prompts", 0) > 0, "nothing was piggybacked"
    without, _ = _churn(InferenceEngine(
        TTINY, tp, max_batch=4, max_len=128, piggyback_prefill=False,
        device="cpu"), loop_steps=16)
    assert with_piggy == without


@pytest.mark.parametrize("loop_steps,count", [(16, 4), (48, 10)])
def test_prewarm_count_matches_jax(jparams, loop_steps, count):
    eng = InferenceEngine(TTINY, _port(jparams), max_batch=4, max_len=128,
                          device="cpu")
    jeng_ = JEngine(JTINY, jparams, max_batch=4, max_len=128)
    assert eng.prewarm(loop_steps=loop_steps) == count
    assert jeng_.prewarm(loop_steps=loop_steps) == count
    variants = eng._loop_variants(loop_steps)
    assert {(c, al) for c, al, _ in variants} == set(jeng_._loops)
    if loop_steps == 48:
        assert {c for c, _, _ in variants} == {6, 8, 12, 16, 24, 32, 48}


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_flush_prefill_ring_matches_jax(mode):
    rng = np.random.RandomState(5)
    nl, b, g, kvh, s, cap, hd = 2, 4, 3, 2, 64, 16, 8
    ring_k, ring_v = (rng.randn(nl, g, kvh, cap, hd).astype(np.float32)
                      for _ in range(2))
    # the last prompt pads the payload: a duplicate slot
    slots = np.array([2, 0, 0], np.int32)
    if mode is None:
        dense = rng.randn(nl, b, kvh, s, hd).astype(np.float32)
        jc = [jnp.asarray(dense)] * 2
        tc = [tensor_from_numpy(dense, "cpu") for _ in range(2)]
    else:
        vdt = np.int8 if mode == "int8" else ml_dtypes.float8_e4m3fn
        bits = 8 if mode == "int8" else -8
        vals = (rng.randn(nl, b, kvh, s, hd) * 50).astype(vdt)
        scl = rng.rand(nl, b, kvh, s, 1).astype(np.float32)
        jc = [JQTensor(jnp.asarray(vals), jnp.asarray(scl), bits=bits)
              for _ in range(2)]
        tc = [QTensor(tensor_from_numpy(vals, "cpu"),
                      tensor_from_numpy(scl, "cpu"), bits=bits)
              for _ in range(2)]
    jk, jv = jeng._flush_prefill_ring(jc[0], jc[1], jnp.asarray(ring_k),
                                      jnp.asarray(ring_v), jnp.asarray(slots))
    teng._flush_prefill_ring(tc[0], tc[1], torch.from_numpy(ring_k),
                             torch.from_numpy(ring_v), torch.from_numpy(slots))

    def u8(a):
        if isinstance(a, torch.Tensor):
            return a.view(torch.uint8).numpy()
        return np.asarray(a).view(np.uint8)

    for j, t in ((jk, tc[0]), (jv, tc[1])):
        if mode is None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_array_equal(u8(t.values), u8(j.values))
            np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
