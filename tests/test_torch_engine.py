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
from flash_attention_softmax_n_tpu.quant import kv_cache as jkv_mod
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
from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor
from flash_attention_softmax_n_tpu_torch.quant.qtensor import as_bytes as qt_bytes
from tests import torch_worlds

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


def test_unported_paths_raise(jparams, tmp_path):
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
    # chunked prefill and the prefix cache serve
    eng.submit(list(range(40)), max_new_tokens=4)
    assert len(eng.run_until_done(loop_steps=8)[0].output) == 4
    assert set(eng._prefill_chunks) == {0, 16, 32}
    assert eng.register_prefix([1] * 20) == 0
    eng.submit([1] * 20 + [2], max_new_tokens=3)
    assert len(eng.run_until_done(loop_steps=8)[0].output) == 3
    assert eng.counters_report()["prefix_hits"] == 1
    # meshes serve: a one-rank gloo mesh gives the unmeshed engine's tokens
    # (piggybacking is off under a mesh, so off in both), and a device
    # other than the mesh's raises
    budgets = [11, 4, 9, 1, 12, 7]
    want = _serve(InferenceEngine(TTINY, tp, max_batch=4, max_len=64,
                                  piggyback_prefill=False, device="cpu"),
                  8, budgets)
    with torch_worlds.one_rank_group(tmp_path):
        mesh = make_mesh({"data": 1, "model": 1})
        got = _serve(InferenceEngine(TTINY, tp, max_batch=4, max_len=64,
                                     mesh=mesh, device="cpu"), 8, budgets)
        with pytest.raises(ValueError, match="the mesh is on cpu"):
            InferenceEngine(TTINY, tp, mesh=mesh, device="cuda")
    assert got == want


_LOOP_PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9], [2, 7, 1]]
_LOOP_TOK0 = np.array([11, 12, 13, 14], np.int32)


def _loop_caches(jparams):
    """The four prompts prefilled into slots 0-3 of a JAX cache (4 x 64),
    and the same cache for the port"""
    shape = (JTINY.n_layers, 4, JTINY.n_kv_heads, 64, JTINY.head_dim)
    jc = {"k": jnp.zeros(shape, jnp.float32), "v": jnp.zeros(shape, jnp.float32),
          "lengths": jnp.zeros((4,), jnp.int32)}
    for slot, p in enumerate(_LOOP_PROMPTS):
        _, jc = jeng.engine_prefill(jparams, JTINY, jnp.asarray([p], jnp.int32),
                                    jnp.asarray(len(p), jnp.int32),
                                    jnp.asarray(slot, jnp.int32), jc)

    def port_cache():
        return {n: tensor_from_numpy(np.asarray(v), "cpu") for n, v in jc.items()}

    return jc, port_cache


def _port_loop(jparams, port_cache, steps, **kw):
    toks, _, _ = teng.engine_decode_loop(
        _port(jparams), TTINY, torch.from_numpy(_LOOP_TOK0), port_cache(),
        torch.ones(4, dtype=torch.bool), num_steps=steps, **kw)
    return toks


@pytest.mark.parametrize("steps", [4, 12])
def test_decode_loop_temperature_zero_matches_jax(jparams, steps):
    jc, port_cache = _loop_caches(jparams)
    want, _, _ = jeng.engine_decode_loop(jparams, JTINY, jnp.asarray(_LOOP_TOK0), jc,
                                         jnp.ones((4,), bool), num_steps=steps,
                                         temperature=0.0)
    got = _port_loop(jparams, port_cache, steps, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_loop_temperature_needs_a_generator(jparams):
    _, port_cache = _loop_caches(jparams)
    with pytest.raises(ValueError, match="requires generator"):
        _port_loop(jparams, port_cache, 4, temperature=0.7)


def test_decode_loop_temperature_samples_from_the_generator(jparams):
    _, port_cache = _loop_caches(jparams)
    draws = [_port_loop(jparams, port_cache, 12, temperature=0.7,
                        generator=torch.Generator().manual_seed(seed))
             for seed in (5, 5)]
    assert draws[0].dtype == torch.int32 and draws[0].shape == (4, 12)
    assert ((draws[0] >= 0) & (draws[0] < TTINY.vocab_size)).all()
    assert torch.equal(draws[0], draws[1])


def test_decode_loop_temps_take_precedence_over_temperature(jparams):
    # per-slot temps of 0 are greedy whatever the scalar temperature, in
    # both packages
    jc, port_cache = _loop_caches(jparams)
    want, _, _ = jeng.engine_decode_loop(jparams, JTINY, jnp.asarray(_LOOP_TOK0), jc,
                                         jnp.ones((4,), bool), num_steps=12,
                                         temperature=0.7, rng=jax.random.PRNGKey(0),
                                         temps=jnp.zeros((4,), jnp.float32))
    got = _port_loop(jparams, port_cache, 12, temperature=0.7,
                     generator=torch.Generator().manual_seed(0), temps=torch.zeros(4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


# ----------------------------------------------------------------------------
# chunked prefill past offset 0 and the prefix cache
# ----------------------------------------------------------------------------


def _cache_pair(mode, rng, *, nl=2, b=4, kvh=2, s=64, hd=8, filled=16):
    """The same cache on both sides: random rows everywhere (the prefix
    rows [0, filled) of every slot among them), lengths ``filled``."""
    lengths = np.full((b,), filled, np.int32)
    if mode is None:
        jc, tc = {}, {}
        for name in ("k", "v"):
            dense = rng.randn(nl, b, kvh, s, hd).astype(np.float32)
            jc[name], tc[name] = jnp.asarray(dense), tensor_from_numpy(dense, "cpu")
    else:
        vdt, bits = ((np.int8, 8) if mode == "int8"
                     else (ml_dtypes.float8_e4m3fn, -8))
        jc, tc = {}, {}
        for name in ("k", "v"):
            if mode == "int8":
                vals = rng.randint(-127, 128, size=(nl, b, kvh, s, hd)).astype(vdt)
            else:
                vals = (rng.randn(nl, b, kvh, s, hd) * 100).astype(vdt)
            scl = (rng.rand(nl, b, kvh, s, 1) * 0.02).astype(np.float32)
            jc[name] = JQTensor(jnp.asarray(vals), jnp.asarray(scl), bits=bits)
            tc[name] = QTensor(tensor_from_numpy(vals, "cpu"),
                               tensor_from_numpy(scl, "cpu"), bits=bits)
    jc["lengths"] = jnp.asarray(lengths)
    tc["lengths"] = torch.from_numpy(lengths.copy())
    return jc, tc


def _planes(cache):
    """(name, array) of every plane of a cache, fp8 values as bytes."""
    out = []
    for name in ("k", "v"):
        kv = cache[name]
        if isinstance(kv, (QTensor, JQTensor)):
            out += [(f"{name}.values", kv.values), (f"{name}.scales", kv.scales)]
        else:
            out.append((name, kv))
    out.append(("lengths", cache["lengths"]))
    return [(n, (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
             if isinstance(a, torch.Tensor) else
             (np.asarray(a).view(np.uint8) if a.dtype == jnp.float8_e4m3fn
              else np.asarray(a))) for n, a in out]


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_prefix_rows_and_row_writes_bit_equal_to_jax(mode):
    # the prefix gather with its dequantization (f32 values times scales,
    # then cast to the model dtype, bf16 here) and the chunk's quantized row
    # writes, held bit for bit against the JAX engine's expressions
    # (engine_prefill_chunk: the gather at engine.py:169-177, the write at
    # :220-244) on the same inputs
    rng = np.random.RandomState(11)
    jc, tc = _cache_pair(mode, rng)
    slots, offset = np.array([2, 0, 2], np.int32), 16
    rows = (rng.randn(3, 2, 16, 8) * 3).astype(np.float32)
    rows[2] = rows[0]  # a padded group repeats its last real row
    ts = torch.from_numpy(slots).long()
    for name in ("k", "v"):
        got = teng._prefix_rows(tc[name], 1, ts, offset, torch.bfloat16)
        jkv = jc[name]
        if mode is None:  # a dense cache's rows as they are (f32)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jkv[:, slots, :, :offset][1]))
        else:
            want = (jkv.values[:, slots, :, :offset].astype(jnp.float32)
                    * jkv.scales[:, slots, :, :offset]).astype(jnp.bfloat16)[1]
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
        teng._write_rows(tc[name], 1, ts, offset, torch.from_numpy(rows))
        new = jnp.asarray(rows)[None]  # one layer of JAX's (nl, nb, ...) stack
        if mode is None:
            for i in range(len(slots)):
                jkv = jax.lax.dynamic_update_slice(
                    jkv, new[:, i][:, None].astype(jkv.dtype),
                    (1, slots[i], 0, offset, 0))
        else:
            values, scales = jkv_mod.quantize_kv(new, jkv.bits)
            vals, scls = jkv.values, jkv.scales
            for i in range(len(slots)):
                idx = (1, slots[i], 0, offset, 0)
                vals = jax.lax.dynamic_update_slice(
                    vals, values[:, i][:, None].astype(vals.dtype), idx)
                scls = jax.lax.dynamic_update_slice(
                    scls, scales[:, i][:, None], idx)
            jkv = JQTensor(vals, scls, bits=jkv.bits)
        jc[name] = jkv
    for (n, a), (_, b) in zip(_planes(tc), _planes(jc)):
        np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_prefill_chunk_at_offset_matches_jax(jparams, mode, impl):
    # engine_prefill_chunk at offset 16 over the same cache: a 16-token
    # chunk for slots 2 and 0 (the second prompt ends inside the chunk) and
    # a padding row repeating the first. "auto" takes K1's plain version on
    # the port and JAX's Pallas kernel in interpret mode. Logits within
    # 1e-5; every row outside the chunk's columns, and the lengths, bit for
    # bit. The chunk's rows come out of the two packages' f32 projections,
    # which differ in the last bit (XLA's CPU matmul and rms_norm against
    # torch's): dense rows within 1e-5; quantized scales within 1e-5
    # relative, values within one step (a ratio that lands by a rounding
    # boundary), dequantized within 1e-5 + one step
    kw = dict(TINY_KW, attn_implementation=impl)
    jcfg, tcfg = JConfig(**kw, dtype=jnp.float32), DecoderConfig(**kw, dtype=torch.float32)
    rng = np.random.RandomState(12)
    jc, tc = _cache_pair(mode, rng)
    tokens = rng.randint(0, 97, size=(3, 16)).astype(np.int32)
    tokens[2] = tokens[0]
    true_lens = np.array([32, 25, 32], np.int32)
    slots = np.array([2, 0, 2], np.int32)
    jl, jc = jeng.engine_prefill_chunk(jparams, jcfg, jnp.asarray(tokens),
                                       jnp.asarray(true_lens), jnp.asarray(slots),
                                       jc, offset=16)
    tl, tc_out = teng.engine_prefill_chunk(
        _port(jparams), tcfg, torch.from_numpy(tokens).long(),
        torch.from_numpy(true_lens), torch.from_numpy(slots).long(), tc, offset=16)
    assert tc_out is tc  # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    chunk = np.zeros((4, 64), bool)
    chunk[[2, 0], 16:32] = True  # (slot, column) the chunk writes
    got, want = dict(_planes(tc)), dict(_planes(jc))
    for n in got:
        a, b = got[n], want[n]
        if n == "lengths":
            np.testing.assert_array_equal(a, [25, 16, 32, 16], err_msg=n)
            np.testing.assert_array_equal(a, b, err_msg=n)
            continue
        outside = ~chunk[None, :, None, :, None]
        np.testing.assert_array_equal(np.where(outside, a, 0), np.where(outside, b, 0),
                                      err_msg=n)
        if mode is None:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=n)
        elif n.endswith("scales"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=n)
    if mode is not None:
        fp8 = mode == "fp8"
        for name in ("k", "v"):
            sa, sb = got[f"{name}.scales"], want[f"{name}.scales"]
            va, vb = got[f"{name}.values"], want[f"{name}.values"]
            if fp8:
                va, vb = (v.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
                          for v in (va, vb))
            else:
                assert np.abs(va.astype(int) - vb.astype(int)).max() <= 1
            step = sa * (1.0 if not fp8 else np.maximum(np.abs(va), 1) / 8)
            assert (np.abs(va * sa - vb * sb) <= 1e-5 + step).all()


def _engines(jparams, register=(), **kw):
    """A JAX engine and the port's, both with ``kw``, each with
    ``register`` registered as prefixes."""
    kvq = kw.get("kv_quantization")
    jp = j_quantize_weights(jparams, 8) if kvq == "int8" else jparams
    engines = (JEngine(JTINY, jp, **kw),
               InferenceEngine(TTINY, _port(jp), device="cpu", **kw))
    for eng in engines:
        for p in register:
            eng.register_prefix(p)
    return engines


def _outputs(engine, prompts, budgets, loop_steps=8):
    ids = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    done = {r.request_id: r for r in engine.run_until_done(loop_steps=loop_steps)}
    return ([done[i].output for i in ids], [r.request_id for r in done.values()],
            engine.counters_report())


def _serve_both(jparams, prompts, budgets, register=(), loop_steps=8, **kw):
    """Serve ``prompts`` on both engines; the port's tokens, finish order
    and prefix counters must equal JAX's. Returns the port's (outputs,
    counters, engine)."""
    jeng_, teng_ = _engines(jparams, register, **kw)
    want, want_order, jrep = _outputs(jeng_, prompts, budgets, loop_steps)
    got, order, rep = _outputs(teng_, prompts, budgets, loop_steps)
    assert got == want
    assert order == want_order
    for key in ("prefix_hits", "prefix_reused_tokens", "prefill_real_tokens",
                "prefill_tokens", "prefill_groups", "piggyback_prompts"):
        assert rep.get(key) == jrep.get(key), key
    return got, rep, teng_


def test_chunked_prefill_matches_monolithic(jparams):
    # prompts longer than prefill_chunk admit through chunked prefill; the
    # same tokens as the monolithic prefill, and as JAX's chunked lane
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 97, size=n).tolist() for n in (40, 33, 17)]
    budgets = [6] * 3
    chunked, _, eng = _serve_both(jparams, prompts, budgets, max_batch=2,
                                  max_len=128, prefill_chunk=16)
    # chunked requests really took the chunked lane
    assert set(eng._prefill_chunks) >= {0, 16, 32}
    mono, _, mono_eng = _serve_both(jparams, prompts, budgets, max_batch=2,
                                    max_len=128)
    assert not mono_eng._prefill_chunks
    assert chunked == mono


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_chunked_prefill_quantized_cache(jparams, mode):
    # the chunk at offset 16 and 32 attends the dequantized prefix (f32
    # values times scales), not the quantized decode read of the monolithic
    # engine: the first token must agree and every budget be met
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, 97, size=37).tolist()
    want, _, _ = _serve_both(jparams, [prompt], [6], max_batch=1, max_len=128,
                             kv_quantization=mode)
    got, _, eng = _serve_both(jparams, [prompt], [6], max_batch=1, max_len=128,
                              kv_quantization=mode, prefill_chunk=16)
    assert set(eng._prefill_chunks) == {0, 16, 32}
    assert got[0][0] == want[0][0] and len(got[0]) == len(want[0])


def test_long_prompt_at_queue_head_admits_first(jparams):
    # anti-starvation: with one contested slot, a long prompt at the queue
    # head admits before a younger short one (the finish order is held
    # against JAX's in _serve_both)
    rng = np.random.RandomState(3)
    long_p = rng.randint(0, 97, size=40).tolist()
    _, _, eng = _serve_both(jparams, [long_p, [1, 2, 3]], [4, 4], max_batch=1,
                            max_len=128, prefill_chunk=16)
    eng.submit(long_p, max_new_tokens=4)   # rid 2 (long, head)
    eng.submit([1, 2, 3], max_new_tokens=4)  # rid 3 (short)
    assert [r.request_id for r in eng.run_until_done(loop_steps=8)] == [2, 3]


def _prefix_prompts(seed, prefix_len, suffixes, others=()):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 97, size=prefix_len).tolist()
    prompts = [prefix + rng.randint(0, 97, size=n).tolist() for n in suffixes]
    return prefix, prompts + [rng.randint(0, 97, size=n).tolist() for n in others]


def _cold_and_warm(jparams, prefix, prompts, **kw):
    kw = dict(dict(max_batch=4, max_len=128, prefill_chunk=16), **kw)
    budgets = [6] * len(prompts)
    cold, _, _ = _serve_both(jparams, prompts, budgets, **kw)
    warm, counters, _ = _serve_both(jparams, prompts, budgets, register=[prefix], **kw)
    assert warm == cold
    return counters


def test_prefix_hit_matches_cold_prefill(jparams):
    # three hits, a long prompt that does not match and a short one
    prefix, prompts = _prefix_prompts(7, 33, (5, 11, 2), others=(40,))
    prompts.append([4, 2])
    counters = _cold_and_warm(jparams, prefix, prompts)
    assert counters.get("prefix_hits", 0) == 3
    # chunk 16: floor(33 / 16) * 16 = 32 rows reused per hit
    assert counters.get("prefix_reused_tokens", 0) == 3 * 32


def test_prefix_hit_matches_with_quantized_cache(jparams):
    # the store is quantized as the cache is, so a hit equals prefilling the
    # same rows in place
    prefix, prompts = _prefix_prompts(8, 32, (3, 9))
    counters = _cold_and_warm(jparams, prefix, prompts, kv_quantization="int8")
    assert counters.get("prefix_hits", 0) == 2


def test_prompt_equal_to_prefix(jparams):
    # one suffix token must remain for the first token's logits: the reuse
    # is whole chunks strictly inside the prompt
    prefix, _ = _prefix_prompts(9, 32, ())
    counters = _cold_and_warm(jparams, prefix, [prefix])
    assert counters.get("prefix_hits", 0) == 1
    assert counters.get("prefix_reused_tokens", 0) == 16  # one chunk


def test_longest_prefix_wins(jparams):
    rng = np.random.RandomState(10)
    short = rng.randint(0, 97, size=16).tolist()
    long_ = short + rng.randint(0, 97, size=16).tolist()
    for eng in _engines(jparams, [short, long_], max_batch=2, max_len=128,
                        prefill_chunk=16):
        m = eng._match_prefix(long_ + [5, 6, 7])
        assert m is not None and m[1] == 32 and m[0]["rows"] == 32


def test_register_prefix_validation(jparams):
    eng = InferenceEngine(TTINY, _port(jparams), max_batch=2, max_len=64,
                          prefill_chunk=16, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        eng.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="max_len"):
        eng.register_prefix(list(range(90)) * 2)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_prefix_store_matches_jax_and_a_cold_prefill(jparams, mode):
    # the store against JAX's (values within one step, as the chunk rows in
    # test_prefill_chunk_at_offset_matches_jax) and bit-equal to the rows a
    # cold 1-slot engine writes for the same tokens through its chunked lane
    prefix, _ = _prefix_prompts(13, 40, ())
    jeng_, teng_ = _engines(jparams, [prefix], max_batch=1, max_len=64,
                            kv_quantization=mode, prefill_chunk=16)
    cold = InferenceEngine(TTINY, teng_.params, max_batch=1, max_len=64,
                           kv_quantization=mode, prefill_chunk=16, device="cpu")
    cold.submit(prefix, max_new_tokens=1)
    cold.run_until_done()
    store, jstore = teng_._prefixes[0]["store"], jeng_._prefixes[0]["store"]
    assert teng_._prefixes[0]["rows"] == 32
    for name in ("k", "v"):
        got, want, ref = store[name], jstore[name], cold.cache[name]
        if mode is None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
            assert torch.equal(got, ref[:, 0, :, :32])
            continue
        assert torch.equal(qt_bytes(got.values), qt_bytes(ref.values[:, 0, :, :32]))
        assert torch.equal(got.scales, ref.scales[:, 0, :, :32])
        np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales),
                                   rtol=1e-5)
