"""Port parity: serving over a mesh against the JAX package.

One spawned gloo world of 8 ranks on ``{"data": 2, "model": 4}``
(``tests/torch_worlds.py``) runs the port's ``parallel/serving.py`` and
``InferenceEngine(mesh=)``, each rank on its own shards and slots; the
results are held here against the JAX package on the same parameters
(``params_from_jax``), made from JAX's seeds as its own tests make them.
Mirrored: ``TestShardedServing``, ``TestShardedArgmax`` (plus planted
ties across shards), ``test_meshed_engine_prefill_pallas_matches_xla``
(logits within 2e-4, cache K within 1e-5) and ``TestMeshedInferenceEngine``
of ``tests/test_parallel.py``; ``test_prewarm_on_mesh_and_parity`` and
``test_meshed_hit_matches_cold`` of ``tests/test_engine.py``; the
all-kernel route at d_model 128, d_ff 256; and ``shard_engine_state``'s
rejections (``tests/test_quant.py``'s fused projections among them), with
JAX's messages; also ``make_sharded_decode``'s temperature mode and the
loop's ``eos_token`` against JAX's. Greedy tokens must equal JAX's
single-device ones exactly, as JAX's meshed tests hold its own meshed runs.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.engine import InferenceEngine as JEngine
from flash_attention_softmax_n_tpu.engine.engine import (
    engine_decode_loop as j_decode_loop,
    engine_prefill_batch as j_prefill_batch,
)
from flash_attention_softmax_n_tpu.models import (
    DecoderConfig as JConfig,
    init_decoder_params as j_init,
)
from flash_attention_softmax_n_tpu.quant.kv_cache import (
    init_quantized_kv_cache as j_init_kv,
)
from flash_attention_softmax_n_tpu.quant.qtensor import (
    QTensor as JQTensor,
    dequantize as j_dequantize,
    quantize as j_quantize,
)
from flash_attention_softmax_n_tpu.quant.weights import (
    quantize_decoder_weights as j_quantize_weights,
)
from flash_attention_softmax_n_tpu_torch.engine import engine as teng
from tests import torch_worlds

torch.set_num_threads(2)
# tests/test_parallel.py's TINY with 8 query and 4 KV heads (1 KV head, 2
# query heads a rank at tp = 4), and tests/test_engine.py's
SERVE_KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
                d_ff=128, max_seq_len=64, softmax_n=1.0,
                attn_implementation="xla")
ENG_KW = dict(SERVE_KW, d_model=32, d_ff=64, max_seq_len=128)
PREFILL_KW = dict(SERVE_KW, n_heads=4, attn_implementation="auto")
Q96_KW = dict(SERVE_KW, vocab_size=96)
# the all-kernel route: int8 weights and KV, K7/K9 and K8, d_ff 256 the
# smallest width at which JAX fuses the decode MLP
ALL_KW = dict(vocab_size=96, d_model=128, n_layers=2, n_heads=8, n_kv_heads=4,
              d_ff=256, max_seq_len=64, softmax_n=1.0, attn_implementation="auto",
              int8_mm_impl="pallas", decode_attn_impl="pallas")
PREFILL_TOL, CACHE_TOL = 2e-4, 1e-5
DP, TP = 2, 4


def _jcfg(kw):
    return JConfig(**kw, dtype=jnp.float32)


def _plain(tree):
    """A JAX tree as numpy leaves, its QTensors as plain namespaces (the
    ranks import no JAX; params_from_jax reads the attributes)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return types.SimpleNamespace(
            values=np.asarray(tree.values), scales=np.asarray(tree.scales),
            bits=tree.bits, packed_axis=tree.packed_axis)
    return np.asarray(tree)


def _tie_lm(columns):
    """(x, int8 W, scales) with integer logits (exact in any order) whose
    row maxima are planted in ``columns``: feature 0 is 8 in every row and
    W's row 0 is 127 in the planted columns, which are equal."""
    rng = np.random.RandomState(5)
    x = rng.randint(-2, 3, size=(8, 1, 64)).astype(np.float32)
    x[..., 0] = 8.0
    w = rng.randint(-3, 4, size=(64, 128)).astype(np.int8)
    w[0] = rng.randint(-3, 4, size=128)
    for c in columns:
        w[:, c] = w[:, columns[0]]
        w[0, c] = 127
    return x, w, np.ones((1, 128), np.float32)


TIES = {"tie_within_and_across": [5, 7, 40, 100],  # shards 0, 0, 1, 3
        "tie_across": [100, 40]}  # local columns 4 (shard 3) and 8 (shard 1)


def _engine_prompts():
    rng = np.random.RandomState(11)
    prefix = rng.randint(0, ENG_KW["vocab_size"], size=33).tolist()
    prompts = [prefix + rng.randint(0, ENG_KW["vocab_size"], size=n).tolist()
               for n in (5, 11, 2)] + [[4, 2]]  # one non-matching
    return prefix, prompts


def _all_prompts():
    rng = np.random.RandomState(4)
    return [rng.randint(0, 96, size=n).tolist() for n in (9, 3, 14, 6)]


@pytest.fixture(scope="module")
def jparams():
    serve = j_init(_jcfg(SERVE_KW), jax.random.PRNGKey(0))
    return {
        "serve": serve,
        "prefill": j_init(_jcfg(PREFILL_KW), jax.random.PRNGKey(0)),
        "q96": j_quantize_weights(j_init(_jcfg(Q96_KW), jax.random.PRNGKey(0)),
                                  bits=8),
        "eng": j_init(_jcfg(ENG_KW), jax.random.PRNGKey(0)),
        "all": j_quantize_weights(j_init(_jcfg(ALL_KW), jax.random.PRNGKey(0)),
                                  bits=8),
    }


@pytest.fixture(scope="module")
def payload(jparams):
    shape = (2, 4, 4, 64, 8)
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 1, 64))
    lm = j_quantize(jax.random.normal(jax.random.PRNGKey(1), (64, 128)),
                    bits=8, axis=0)
    argmax = {"random": (np.asarray(x), np.asarray(lm.values),
                         np.asarray(lm.scales))}
    argmax.update({name: _tie_lm(cols) for name, cols in TIES.items()})
    prefix, prompts = _engine_prompts()
    rng = np.random.RandomState(2)
    return {
        "serve_cfg": SERVE_KW, "serve_params": _plain(jparams["serve"]),
        "serve_auto_cfg": dict(SERVE_KW, attn_implementation="auto"),
        "serve_auto_params": _plain(jparams["serve"]),
        "prefill_cfg": PREFILL_KW, "prefill_params": _plain(jparams["prefill"]),
        "q96_cfg": Q96_KW, "q96_params": _plain(jparams["q96"]),
        "eng_cfg": ENG_KW, "eng_params": _plain(jparams["eng"]),
        "all_cfg": ALL_KW, "all_params": _plain(jparams["all"]),
        "decode_k": np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(1), shape)),
        "decode_v": np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(2), shape)),
        "argmax": argmax,
        "prefill_tokens": np.asarray(jax.random.randint(
            jax.random.PRNGKey(1), (4, 16), 0, 97)),
        "prefill_lens": np.array([16, 9, 12, 16], np.int32),
        "chunked_prompts": [rng.randint(0, 97, size=n).tolist() for n in (40, 20)],
        "prefix": prefix, "prefix_prompts": prompts,
        "all_prompts": _all_prompts(),
    }


WORLD = ["sharded_decode", "sharded_argmax", "meshed_prefill", "engine_mesh",
         "engine_fused_argmax", "engine_chunked", "engine_pallas_prefill",
         "engine_prewarm", "engine_prefix", "engine_all_kernel",
         "serving_rejections"]


@pytest.fixture(scope="module")
def world(payload, tmp_path_factory):
    return torch_worlds.run_world(tmp_path_factory.mktemp("serving"), DP * TP,
                                  WORLD, payload)


def _case(world, name):
    return torch_worlds.results(world, name)


def _by_data(per_rank, get=lambda r: r):
    """The model ranks of each data group agree; their rows in slot order."""
    groups = [[get(per_rank[d * TP + m]) for m in range(TP)] for d in range(DP)]
    for g in groups:
        for other in g[1:]:
            np.testing.assert_array_equal(other, g[0])
    return np.concatenate([g[0] for g in groups])


def _same_on_every_rank(per_rank):
    for r in per_rank[1:]:
        assert r == per_rank[0]
    return per_rank[0]


def _jserve(kw, params, prompts, budgets, register=(), **engine_kw):
    """JAX's single-device engine: ({request id: tokens}, counters)."""
    eng = JEngine(_jcfg(kw), params, **engine_kw)
    for p in register:
        eng.register_prefix(p)
    for p, n in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=n)
    done = eng.run_until_done(loop_steps=8)
    return {r.request_id: r.output for r in done}, eng.counters_report()


# ----------------------------------------------------------------------------
# TestShardedServing (tests/test_parallel.py)
# ----------------------------------------------------------------------------


def _decode_ref(jparams, payload, mode):
    cfg = _jcfg(SERVE_KW)
    b, s = 4, 64
    if mode is not None:
        cache = j_init_kv(cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim,
                          mode=mode)
        cache.pop("length")
    else:
        cache = {"k": jnp.asarray(payload["decode_k"]),
                 "v": jnp.asarray(payload["decode_v"])}
    cache["lengths"] = jnp.full((b,), 8, jnp.int32)
    ref, _, _ = j_decode_loop(jparams["serve"], cfg, jnp.arange(b, dtype=jnp.int32) + 3,
                              cache, jnp.ones((b,), bool), num_steps=8)
    return np.asarray(ref)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_sharded_decode_matches_single_device(world, jparams, payload, mode):
    res = [r[mode] for r in _case(world, "sharded_decode")]
    np.testing.assert_array_equal(_by_data(res, lambda r: r["tokens"]),
                                  _decode_ref(jparams, payload, mode))
    for r in res:
        # this rank's 2 slots of 1 KV head; lengths advanced by 8 on the
        # copy (donate=False), the input cache's kept
        assert r["k_shape"] == (2, 2, 1, 64, 8)
        np.testing.assert_array_equal(r["lengths"], [16, 16])
        np.testing.assert_array_equal(r["kept"], [8, 8])


def test_sharded_per_slot_sampling(world, jparams, payload):
    out = _by_data(_case(world, "sharded_decode"), lambda r: r["sampled"])
    ref = _decode_ref(jparams, payload, None)
    # temperature-0 rows reproduce the greedy reference; sampled rows are
    # in range
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[2], ref[2])
    assert out.min() >= 0 and out.max() < SERVE_KW["vocab_size"]


def test_sharded_temperature_sampling(world):
    # every slot sampled at one temperature: the ranks of a 'model' group
    # draw alike (_by_data), the tokens are in range
    out = _by_data(_case(world, "sharded_decode"), lambda r: r["tempered"])
    assert out.shape == (4, 8)
    assert out.min() >= 0 and out.max() < SERVE_KW["vocab_size"]


def test_decode_loop_eos_matches_jax(jparams, payload):
    # eos_token (make_sharded_decode's): a slot that emits it turns
    # inactive and repeats it, as JAX's loop does
    from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
    from flash_attention_softmax_n_tpu_torch.engine import engine_decode_loop
    from flash_attention_softmax_n_tpu_torch.models import DecoderConfig
    ref = _decode_ref(jparams, payload, None)
    eos = int(ref[1, 3])
    b = 4
    jcache = {"k": jnp.asarray(payload["decode_k"]), "v": jnp.asarray(payload["decode_v"]),
              "lengths": jnp.full((b,), 8, jnp.int32)}
    want, jc, jactive = j_decode_loop(
        jparams["serve"], _jcfg(SERVE_KW), jnp.arange(b, dtype=jnp.int32) + 3, jcache,
        jnp.ones((b,), bool), num_steps=8, eos_token=eos)
    cache = {"k": torch.from_numpy(np.array(payload["decode_k"])),
             "v": torch.from_numpy(np.array(payload["decode_v"])),
             "lengths": torch.full((b,), 8, dtype=torch.int32)}
    got, cache, active = engine_decode_loop(
        params_from_jax(payload["serve_params"], device="cpu"),
        DecoderConfig(**SERVE_KW, dtype=torch.float32),
        torch.arange(b, dtype=torch.int32) + 3, cache, torch.ones(b, dtype=torch.bool),
        num_steps=8, eos_token=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jc["lengths"]))
    assert not active[1]


# ----------------------------------------------------------------------------
# TestShardedArgmax, and the merge's order on ties
# ----------------------------------------------------------------------------


def test_sharded_argmax_matches_global_argmax(world, payload):
    x, values, scales = payload["argmax"]["random"]
    lm = JQTensor(jnp.asarray(values), jnp.asarray(scales))
    ref = np.asarray(jnp.argmax(jnp.asarray(x)[:, 0] @ j_dequantize(lm), axis=-1))
    out = _by_data(_case(world, "sharded_argmax"), lambda r: r["random"])
    np.testing.assert_array_equal(out[:, 0], ref)


@pytest.mark.parametrize("name", sorted(TIES))
def test_sharded_argmax_planted_tie(world, payload, name):
    # exact integer logits: the planted columns tie; the lowest global
    # column wins, as a whole-vocabulary argmax takes it
    x, w, s = payload["argmax"][name]
    logits = x[:, 0].astype(np.float64) @ w.astype(np.float64)
    want = np.argmax(logits, axis=-1)
    assert (want == min(TIES[name])).all()
    out = _by_data(_case(world, "sharded_argmax"), lambda r: r[name])
    np.testing.assert_array_equal(out[:, 0], want)


def test_merge_shard_argmax_order():
    # 3 shards, 4 rows: a tie across shards 0 and 2 takes shard 0's index,
    # a tie across 1 and 2 shard 1's, a clear max wherever it is
    vals = torch.tensor([[5.0, 1.0, 2.0, 7.0],
                         [3.0, 4.0, 9.0, 7.0],
                         [5.0, 4.0, 1.0, 2.0]])
    idxs = torch.tensor([[3, 10, 0, 31], [40, 35, 60, 33], [70, 64, 90, 65]],
                        dtype=torch.int32)
    got = teng._merge_shard_argmax(vals, idxs)
    assert got.tolist() == [3, 35, 60, 31]


# ----------------------------------------------------------------------------
# the meshed admission prefill (test_meshed_engine_prefill_pallas_matches_xla)
# ----------------------------------------------------------------------------


def test_meshed_engine_prefill_pallas_matches_xla(world, jparams, payload):
    b, s = 4, 32
    cfg = dataclasses.replace(_jcfg(PREFILL_KW), attn_implementation="xla")
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
    cache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
             "lengths": jnp.zeros((b,), jnp.int32)}
    ref_logits, ref_cache = j_prefill_batch(
        jparams["prefill"], cfg, jnp.asarray(payload["prefill_tokens"]),
        jnp.asarray(payload["prefill_lens"]), jnp.arange(b, dtype=jnp.int32), cache)
    res = _case(world, "meshed_prefill")
    np.testing.assert_allclose(_by_data(res, lambda r: r["logits"]),
                               np.asarray(ref_logits), atol=PREFILL_TOL)
    ref_k = np.asarray(ref_cache["k"])
    for r, got in enumerate(res):
        d, m = divmod(r, TP)
        np.testing.assert_allclose(got["k"], ref_k[:, 2 * d:2 * d + 2, m:m + 1],
                                   atol=CACHE_TOL)
        np.testing.assert_array_equal(got["lengths"],
                                      payload["prefill_lens"][2 * d:2 * d + 2])


# ----------------------------------------------------------------------------
# TestMeshedInferenceEngine (tests/test_parallel.py)
# ----------------------------------------------------------------------------


def test_engine_on_mesh_matches_single_device(world, jparams):
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8], [2, 7]]
    want, _ = _jserve(SERVE_KW, jparams["serve"], prompts, [6, 7, 8, 9],
                      max_batch=4, max_len=64)
    res = _case(world, "engine_mesh")
    assert _same_on_every_rank([r["tokens"] for r in res]) == want
    # this rank's 2 slots of 1 KV head
    assert all(r["next_token"] == (2,) and r["cache"] == (2, 2, 1, 64, 8)
               for r in res)


def test_engine_on_mesh_fused_argmax_matches(world, jparams):
    prompts = [[3, 1, 4, 1], [9, 2], [5, 3, 5], [2, 7, 1, 8]]
    want, _ = _jserve(Q96_KW, jparams["q96"], prompts, [6] * 4, max_batch=4,
                      max_len=64)
    res = _case(world, "engine_fused_argmax")
    assert all(r["fusable"] and r["merges"] > 0 for r in res)
    assert _same_on_every_rank([r["tokens"] for r in res]) == want


def test_engine_on_mesh_chunked_prefill_matches(world, jparams, payload):
    want, _ = _jserve(SERVE_KW, jparams["serve"], payload["chunked_prompts"],
                      [5, 5], max_batch=2, max_len=64, prefill_chunk=16)
    res = _case(world, "engine_chunked")
    assert _same_on_every_rank([r["tokens"] for r in res]) == want


def test_engine_on_mesh_pallas_prefill_matches(world, jparams):
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    want, _ = _jserve(dict(SERVE_KW, attn_implementation="auto"), jparams["serve"],
                      prompts, [5, 6], max_batch=2, max_len=64)
    res = _case(world, "engine_pallas_prefill")
    assert _same_on_every_rank([r["tokens"] for r in res]) == want


# ----------------------------------------------------------------------------
# tests/test_engine.py's meshed cases, and the all-kernel route
# ----------------------------------------------------------------------------


def test_prewarm_on_mesh_and_parity(world, jparams):
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8], [2, 7]]
    want, _ = _jserve(ENG_KW, jparams["eng"], prompts, [6, 7, 8, 9],
                      max_batch=4, max_len=64)
    res = _case(world, "engine_prewarm")
    # chunk 8 x window 64; no piggybacked variant under a mesh
    assert all(r["variants"] == 1 for r in res)
    assert _same_on_every_rank([r["tokens"] for r in res]) == want


@pytest.mark.parametrize("kvq", [None, "int8"])
def test_meshed_hit_matches_cold(world, jparams, kvq):
    prefix, prompts = _engine_prompts()
    cold, _ = _jserve(ENG_KW, jparams["eng"], prompts, [6] * 4, max_batch=4,
                      max_len=128, prefill_chunk=16, kv_quantization=kvq)
    res = [r[kvq] for r in _case(world, "engine_prefix")]
    assert _same_on_every_rank([r["tokens"] for r in res]) == cold
    for r in res:
        # chunk 16: floor(33/16)*16 = 32 rows reused by each of 3 hits
        assert r["counters"]["prefix_hits"] == 3
        assert r["counters"]["prefix_reused_tokens"] == 3 * 32


def test_all_kernel_route_on_mesh(world, jparams):
    want, _ = _jserve(ALL_KW, jparams["all"], _all_prompts(), [7, 5, 9, 6],
                      max_batch=4, max_len=64, kv_quantization="int8",
                      piggyback_prefill=False)
    res = _case(world, "engine_all_kernel")
    assert _same_on_every_rank([r["tokens"] for r in res]) == want
    # K9 on the rank's d_ff slice (256 / 4) at its 2 decode slots
    for r in res:
        assert r["fused_calls"] > 0 and r["fused_mlp"] == [((2, 1, 128), (128, 64))]


# ----------------------------------------------------------------------------
# shard_engine_state's rejections
# ----------------------------------------------------------------------------


def _jax_rejection(name):
    from flash_attention_softmax_n_tpu.parallel import (
        make_mesh,
        shard_engine_state,
    )
    from flash_attention_softmax_n_tpu.quant import fuse_decoder_projections
    params = j_init(_jcfg(SERVE_KW), jax.random.PRNGKey(0))
    mesh = make_mesh({"data": DP, "model": TP})

    def cache(b, kvh):
        shape = (2, b, kvh, 64, 8)
        return {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
                "lengths": jnp.zeros((b,), jnp.int32)}

    call = {"axis": lambda: shard_engine_state(params, cache(4, 4),
                                               make_mesh({"data": 2, "sp": 4})),
            "batch": lambda: shard_engine_state(params, cache(3, 4), mesh),
            "heads": lambda: shard_engine_state(params, cache(4, 2), mesh),
            "fused": lambda: shard_engine_state(
                fuse_decoder_projections(params), cache(4, 4), mesh)}[name]
    with pytest.raises(ValueError) as e:
        call()
    return str(e.value)


@pytest.mark.parametrize("name", ["axis", "batch", "heads", "fused"])
def test_shard_engine_state_rejects(world, name):
    res = _case(world, "serving_rejections")
    assert _same_on_every_rank([r[name] for r in res]) == _jax_rejection(name)


def test_piggyback_under_mesh_raises(world):
    for r in _case(world, "serving_rejections"):
        assert "no mesh" in r["piggy"]
