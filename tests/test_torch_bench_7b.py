"""Port parity: the 7B geometry's line (``utils/bench_7b.py``) against
``scripts/bench_7b.py``.

At a small geometry with Llama-7B's head dim of 128 (2 layers, d_model 256,
2 heads, vocab 512, d_ff 512, f32), once MHA (2 KV heads, G = 1) and once
GQA (1 KV head, G = 2): JAX's ``init_7b_int8`` weights cross over with
``params_from_jax``; both packages admit the same prompts into an int8 KV
cache through ``engine_prefill_batch`` (logits within 1e-5, the int8
engine's tolerance in tests/test_torch_engine.py) and run the fused greedy
loop (``engine_decode_loop``, 8 steps on the ring, then 4 writing the
cache), and both engines serve the same requests: equal tokens. The
port's two initializers give JAX's trees (keys, shapes, dtypes, bits,
packed axes, scale shapes; the synthesized scale exactly), and
``bench_decode`` runs on the CPU with every slot active.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.engine import InferenceEngine as JEngine
from flash_attention_softmax_n_tpu.engine import engine as jeng
from flash_attention_softmax_n_tpu.models import DecoderConfig as JConfig
from flash_attention_softmax_n_tpu.quant.kv_cache import (
    init_quantized_kv_cache as j_init_cache,
)
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
from flash_attention_softmax_n_tpu_torch.engine import engine as teng
from flash_attention_softmax_n_tpu_torch.models import DecoderConfig
from flash_attention_softmax_n_tpu_torch.quant.kv_cache import (
    init_quantized_kv_cache,
)
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor
from flash_attention_softmax_n_tpu_torch.utils import bench_7b
from scripts import bench_7b as j_bench_7b

torch.set_num_threads(2)
SMALL_KW = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=2, d_ff=512,
                max_seq_len=128, softmax_n=1.0)
# the int8 engine's logits tolerance (tests/test_torch_engine.py)
LOGITS_ATOL = 1e-5


def _configs(kv_heads):
    return (JConfig(**SMALL_KW, n_kv_heads=kv_heads, dtype=jnp.float32),
            DecoderConfig(**SMALL_KW, n_kv_heads=kv_heads, dtype=torch.float32))


@pytest.fixture(scope="module", params=[2, 1], ids=["mha_g1", "gqa_g2"])
def small(request):
    jcfg, tcfg = _configs(request.param)
    assert tcfg.head_dim == 128
    jp = j_bench_7b.init_7b_int8(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_prefill_and_decode_loop_match_jax(small):
    jcfg, tcfg, jp, tp = small
    batch, max_len, plen = 4, 64, 16
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, 512, size=(batch, plen)).astype(np.int32)
    true_lens = np.array([16, 11, 16, 7], np.int32)
    slots = np.arange(batch, dtype=np.int32)
    jc = j_init_cache(2, batch, jcfg.n_kv_heads, max_len, 128, mode="int8")
    jc["lengths"] = jnp.zeros((batch,), jnp.int32)
    tc = init_quantized_kv_cache(2, batch, tcfg.n_kv_heads, max_len, 128, mode="int8",
                                 device="cpu")
    tc["lengths"] = torch.zeros((batch,), dtype=torch.int32)
    jl, jc = jax.jit(partial(jeng.engine_prefill_batch, cfg=jcfg))(
        params=jp, tokens=jnp.asarray(tokens), true_lens=jnp.asarray(true_lens),
        slots=jnp.asarray(slots), cache=jc)
    tl, _ = teng.engine_prefill_batch(tp, tcfg, torch.from_numpy(tokens).long(),
                                      torch.from_numpy(true_lens),
                                      torch.from_numpy(slots).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)

    first = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert np.array_equal(first, torch.argmax(tl, -1).numpy())
    jtok, ttok = jnp.asarray(first), torch.from_numpy(first)
    active = np.ones((batch,), bool)
    for steps in (8, 4):  # the ring (K4), then the cache row by row (K3)
        jtoks, jc, _ = jax.jit(partial(jeng.engine_decode_loop, cfg=jcfg, num_steps=steps),
                               static_argnames=("attn_len",))(
            params=jp, tokens=jtok, cache=jc, active=jnp.asarray(active), attn_len=64)
        ttoks, tc, _ = teng.engine_decode_loop(tp, tcfg, ttok, tc, torch.from_numpy(active),
                                               num_steps=steps, attn_len=64)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        jtok, ttok = jtoks[:, -1], ttoks[:, -1]
    np.testing.assert_array_equal(tc["lengths"].numpy(), true_lens + 12)


def test_engines_serve_jax_tokens(small):
    # int8 weights and KV, 5 requests through 4 slots (one queued, so
    # piggybacked), fused chunks of 8
    jcfg, tcfg, jp, tp = small
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, 512, size=int(n)).tolist(), int(b))
            for n, b in zip(rng.randint(4, 40, size=5), rng.randint(2, 12, size=5))]

    def serve(eng):
        for p, n in reqs:
            eng.submit(p, max_new_tokens=n)
        return {r.request_id: r.output for r in eng.run_until_done(loop_steps=8)}

    want = serve(JEngine(jcfg, jp, max_batch=4, max_len=64, kv_quantization="int8"))
    got = serve(InferenceEngine(tcfg, tp, max_batch=4, max_len=64, kv_quantization="int8",
                                device="cpu"))
    assert got == want
    assert [len(got[i]) for i in range(len(reqs))] == [n for _, n in reqs]


def _tree_spec(tree, bits_of):
    """{path: (shape, dtype name, bits, packed axis, scale shape)} of a
    parameter tree, quantized leaves described by ``bits_of``"""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], f"{path}/{k}")
        else:
            out[path] = bits_of(x)
    walk(tree, "")
    return out


def _jax_leaf(x):
    if hasattr(x, "scales"):
        return (tuple(x.values.shape), str(x.values.dtype), x.bits, x.packed_axis,
                tuple(x.scales.shape), str(x.scales.dtype))
    return (tuple(x.shape), str(x.dtype))


def _torch_leaf(x):
    name = {torch.int8: "int8", torch.float32: "float32", torch.bfloat16: "bfloat16"}
    if isinstance(x, QTensor):
        return (tuple(x.values.shape), name[x.values.dtype], x.bits, x.packed_axis,
                tuple(x.scales.shape), name[x.scales.dtype])
    return (tuple(x.shape), name[x.dtype])


@pytest.mark.parametrize("synth", [False, True], ids=["init", "synth"])
def test_initializers_give_jax_trees(synth):
    jcfg, tcfg = _configs(1)
    jtree = (j_bench_7b.init_7b_int8_synth if synth else j_bench_7b.init_7b_int8)(
        jcfg, jax.random.PRNGKey(0))
    init = bench_7b.init_7b_int8_synth if synth else bench_7b.init_7b_int8
    ttree = init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert list(ttree) == list(jtree)
    assert list(ttree["layers"]) == list(jtree["layers"])
    assert _tree_spec(ttree, _torch_leaf) == _tree_spec(jtree, _jax_leaf)
    for name, fan_in in (("wq", 256), ("wk", 256), ("wo", 256), ("w_down", 512)):
        q = ttree["layers"][name]
        if synth:
            want = np.float32(4.5 * fan_in ** -0.5 / 127.0)
            assert torch.equal(q.scales, torch.full_like(q.scales, float(want)))
            assert q.values.min() >= -127
            np.testing.assert_array_equal(q.scales.numpy(),
                                          np.asarray(jtree["layers"][name].scales))
        else:
            # per output channel: each column's absmax maps onto 127
            assert int(q.values.abs().amax(dim=-2).min()) == 127


def test_int8_init_quantizes_each_layer_as_the_whole_leaf():
    # quantizing a leaf layer by layer gives the bits of quantizing it whole
    from flash_attention_softmax_n_tpu_torch.quant.qtensor import quantize

    _, tcfg = _configs(1)
    for bits in (8, 4):
        gen = torch.Generator().manual_seed(5)
        tree = bench_7b.init_7b_int8(tcfg, gen, "cpu", bits=bits)
        # redraw the first matmul leaf (wq) from the same stream: the
        # embedding is drawn after the layers
        gen = torch.Generator().manual_seed(5)
        w = torch.stack([(torch.randn((256, 256), generator=gen) * 256 ** -0.5)
                         .to(torch.float32) for _ in range(2)])
        whole = quantize(w, bits=bits, axis=-2)
        assert torch.equal(tree["layers"]["wq"].values, whole.values)
        assert torch.equal(tree["layers"]["wq"].scales, whole.scales)
        assert tree["layers"]["wq"].packed_axis == whole.packed_axis


def test_bench_decode_runs_on_cpu():
    _, tcfg = _configs(1)
    params = bench_7b.init_7b_int8_synth(tcfg, torch.Generator().manual_seed(0), "cpu")
    res = bench_7b.bench_decode(tcfg, params, kv_quantization="int8", batch=8,
                                prompt_len=16, decode_steps=4, max_len=64)
    assert res["tokens_per_s"] > 0 and res["eager_tokens_per_s"] > 0
    assert res["graph_tokens_per_s"] is None and res["peak_bytes"] is None
    assert res["active_slots"] == 8
    # every slot: its prompt, two warm-up windows and two timed ones
    assert res["lengths"] == [16 + 4 * 4]
    assert res["preflight"]["total"] > res["preflight"]["params"] > 0
