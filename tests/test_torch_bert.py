"""Port parity: ``bert_forward`` against the JAX package's on the same
weights (``params_from_jax``) and against HF ``BertModel`` built from tiny
configs, within 2e-5 (the JAX package's tolerance against HF), in every
mode: the encoder at n 0 and 1, decoder mode with cross-attention, the KV
cache, the relative position modes, head_mask, output_attentions, taps,
int8 weights, and int4 at d_model 256 (K % 256 == 0: K7's plain version
against JAX's Pallas int4 kernel in interpret mode); dropout by its
invariants (JAX draws its masks from another generator).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.models import bert as jb
from flash_attention_softmax_n_tpu.quant.weights import (
    quantize_bert_weights as j_quantize_bert,
)
from flash_attention_softmax_n_tpu.surgery import convert as jconv
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.models import bert as tb
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor
from flash_attention_softmax_n_tpu_torch.quant.weights import (
    BERT_MATMUL_WEIGHTS,
    quantize_bert_weights,
)
from flash_attention_softmax_n_tpu_torch.surgery import convert as tconv

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)
TOL = 2e-5


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=tol, rtol=0)


def _hf(seed=0, **kw):
    torch.manual_seed(seed)
    cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64,
               max_position_embeddings=64, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    cfg.update(kw)
    model = transformers.BertModel(transformers.BertConfig(**cfg))
    model.eval()
    return model


@pytest.fixture(scope="module")
def hf_bert():
    return _hf()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, size=(2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    tt = rng.randint(0, 2, size=(2, 10)).astype(np.int32)
    return ids, mask, tt


def _both(hf_model, softmax_n=0.0, dtype=(jnp.float32, torch.float32)):
    jc = jconv.bert_config_from_hf(hf_model.config, softmax_n=softmax_n, dtype=dtype[0])
    jp = jconv.bert_params_from_hf(hf_model, jc)
    tc = tconv.bert_config_from_hf(hf_model.config, softmax_n=softmax_n, dtype=dtype[1])
    return (jc, jp), (tc, _port(jp))


def _hf_run(model, ids, **kw):
    """HF's forward; numpy arguments (ids and 0/1 masks) as long tensors."""
    kw = {k: torch.from_numpy(v).long() if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    with torch.no_grad():
        return model(input_ids=torch.as_tensor(ids).long(), **kw)


@pytest.mark.parametrize("softmax_n", [0.0, 1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_jax(hf_bert, inputs, softmax_n, masked):
    ids, mask, tt = inputs
    (jc, jp), (tc, tp) = _both(hf_bert, softmax_n)
    m = mask if masked else None
    want = jb.bert_forward(jp, jc, _j(ids), _j(m), _j(tt))
    got = tb.bert_forward(tp, tc, _t(ids).long(), _t(m), _t(tt).long())
    for key in ("last_hidden_state", "pooler_output"):
        _close(got[key], want[key])


def test_encoder_matches_hf(hf_bert, inputs):
    ids, mask, tt = inputs
    _, (tc, tp) = _both(hf_bert)
    hf = _hf_run(hf_bert, ids, attention_mask=mask, token_type_ids=tt)
    got = tb.bert_forward(tp, tc, _t(ids).long(), _t(mask), _t(tt).long())
    _close(got["last_hidden_state"], hf.last_hidden_state.numpy())
    _close(got["pooler_output"], hf.pooler_output.numpy())


def test_n1_changes_the_output(hf_bert, inputs):
    ids, _, _ = inputs
    _, (tc, tp) = _both(hf_bert)
    out0 = tb.bert_forward(tp, tc, _t(ids).long())["last_hidden_state"]
    out1 = tb.bert_forward(tp, dataclasses.replace(tc, softmax_n=1.0),
                           _t(ids).long())["last_hidden_state"]
    assert not torch.allclose(out0, out1)


def test_taps_match_jax(hf_bert, inputs):
    ids, mask, _ = inputs
    (jc, jp), (tc, tp) = _both(hf_bert, 1.0)
    jout, jtaps = jb.bert_forward(jp, jc, _j(ids), _j(mask), collect_taps=True)
    tout, ttaps = tb.bert_forward(tp, tc, _t(ids).long(), _t(mask), collect_taps=True)
    assert list(ttaps) == list(jtaps) == [f"encoder.layer.{i}.attention.output"
                                          for i in range(2)]
    for name in jtaps:
        assert tuple(ttaps[name].shape) == (2, 10, 32)
        _close(ttaps[name], jtaps[name])
    plain = tb.bert_forward(tp, tc, _t(ids).long(), _t(mask))
    assert torch.equal(plain["last_hidden_state"], tout["last_hidden_state"])


@pytest.mark.parametrize("softmax_n", [0.0, 1.0])
def test_head_mask_and_output_attentions_match_jax_and_hf(hf_bert, inputs, softmax_n):
    ids, mask, _ = inputs
    hm = np.ones((2, 4), np.float32)
    hm[0, 1] = 0.0
    hm[1, 3] = 0.0
    (jc, jp), (tc, tp) = _both(hf_bert, softmax_n)
    want = jb.bert_forward(jp, jc, _j(ids), _j(mask), head_mask=_j(hm),
                           output_attentions=True)
    got = tb.bert_forward(tp, tc, _t(ids).long(), _t(mask), head_mask=_t(hm),
                          output_attentions=True)
    assert tuple(got["attentions"].shape) == (2, 2, 4, 10, 10)
    _close(got["attentions"], want["attentions"])
    _close(got["last_hidden_state"], want["last_hidden_state"])
    if softmax_n == 0.0:
        hf = _hf_run(hf_bert, ids, attention_mask=mask, head_mask=torch.tensor(hm),
                     output_attentions=True)
        _close(got["last_hidden_state"], hf.last_hidden_state.numpy())
        for i, probs in enumerate(hf.attentions):
            _close(got["attentions"][i], probs.numpy())
    # a (H,) head_mask is shared by every layer
    shared = tb.bert_forward(tp, tc, _t(ids).long(), _t(mask), head_mask=_t(hm[0]))
    both = tb.bert_forward(tp, tc, _t(ids).long(), _t(mask),
                           head_mask=_t(np.stack([hm[0], hm[0]])))
    assert torch.equal(shared["last_hidden_state"], both["last_hidden_state"])


@pytest.mark.parametrize("pet", ["relative_key", "relative_key_query"])
def test_relative_positions_match_hf_and_jax(pet):
    model = _hf(7, vocab_size=64, max_position_embeddings=32, position_embedding_type=pet)
    ids = np.random.RandomState(5).randint(0, 64, size=(2, 9)).astype(np.int32)
    (jc, jp), (tc, tp) = _both(model)
    assert tc.position_embedding_type == pet and "distance_emb" in tp["layers"]
    got = tb.bert_forward(tp, tc, _t(ids).long())
    _close(got["last_hidden_state"], _hf_run(model, ids).last_hidden_state.numpy())
    _close(got["last_hidden_state"], jb.bert_forward(jp, jc, _j(ids))["last_hidden_state"])


@pytest.fixture(scope="module")
def hf_decoder():
    return _hf(1, is_decoder=True, add_cross_attention=True)


@pytest.fixture(scope="module")
def enc_states():
    return np.random.RandomState(3).randn(2, 7, 32).astype(np.float32)


def test_cross_attention_matches_hf_and_jax(hf_decoder, enc_states):
    ids = np.random.RandomState(1).randint(0, 128, size=(2, 9)).astype(np.int32)
    enc_mask = np.ones((2, 7), np.int32)
    enc_mask[1, 5:] = 0
    (jc, jp), (tc, tp) = _both(hf_decoder)
    assert tc.is_decoder and tc.add_cross_attention
    hf = _hf_run(hf_decoder, ids, encoder_hidden_states=torch.tensor(enc_states),
                 encoder_attention_mask=enc_mask)
    got = tb.bert_forward(tp, tc, _t(ids).long(), encoder_hidden_states=_t(enc_states),
                          encoder_attention_mask=_t(enc_mask), output_attentions=True)
    _close(got["last_hidden_state"], hf.last_hidden_state.numpy())
    want = jb.bert_forward(jp, jc, _j(ids), encoder_hidden_states=_j(enc_states),
                           encoder_attention_mask=_j(enc_mask), output_attentions=True)
    assert tuple(got["cross_attentions"].shape) == (2, 2, 4, 9, 7)
    _close(got["cross_attentions"], want["cross_attentions"])
    _close(got["attentions"], want["attentions"])
    # causal self-attention without an encoder
    plain = tb.bert_forward(tp, tc, _t(ids).long())
    _close(plain["last_hidden_state"], _hf_run(hf_decoder, ids).last_hidden_state.numpy())


def test_kv_cache_matches_hf_past_key_values(hf_decoder, enc_states):
    rng = np.random.RandomState(2)
    prefix = rng.randint(0, 128, size=(2, 6)).astype(np.int32)
    nxt = rng.randint(0, 128, size=(2, 1)).astype(np.int32)
    enc = torch.tensor(enc_states)
    with torch.no_grad():
        hf_pre = hf_decoder(input_ids=torch.tensor(prefix).long(),
                            encoder_hidden_states=enc, use_cache=True)
        hf_step = hf_decoder(input_ids=torch.tensor(nxt).long(), encoder_hidden_states=enc,
                             past_key_values=hf_pre.past_key_values, use_cache=True)
    _, (tc, tp) = _both(hf_decoder)
    cache = tb.init_bert_kv_cache(tc, batch=2, max_len=32, device="cpu")
    pre = tb.bert_forward(tp, tc, _t(prefix).long(), encoder_hidden_states=enc,
                          cache=cache)
    _close(pre["last_hidden_state"], hf_pre.last_hidden_state.numpy())
    assert pre["cache"]["length"] == 6
    step = tb.bert_forward(tp, tc, _t(nxt).long(), encoder_hidden_states=enc,
                           cache=pre["cache"])
    _close(step["last_hidden_state"], hf_step.last_hidden_state.numpy())
    assert step["cache"]["length"] == 7
    full = tb.bert_forward(tp, tc, _t(np.concatenate([prefix, nxt], 1)).long(),
                           encoder_hidden_states=enc)
    _close(step["last_hidden_state"][:, 0], full["last_hidden_state"][:, 6].numpy())
    with pytest.raises(ValueError, match="left-aligned"):
        tb.bert_forward(tp, tc, torch.zeros((2, 1), dtype=torch.long),
                        attention_mask=torch.ones((2, 1)), cache=cache)


@pytest.mark.parametrize("pet", ["absolute", "relative_key_query"])
def test_kv_cache_matches_jax(pet):
    """The cache against JAX's static cache, relative positions included
    (the cached query's distance is taken at its absolute position)."""
    model = _hf(4, is_decoder=True, position_embedding_type=pet)
    (jc, jp), (tc, tp) = _both(model, 1.0)
    rng = np.random.RandomState(6)
    steps = [rng.randint(0, 128, size=(2, n)).astype(np.int32) for n in (5, 1, 2)]
    jcache = jb.init_bert_kv_cache(jc, batch=2, max_len=16)
    tcache = tb.init_bert_kv_cache(tc, batch=2, max_len=16, device="cpu")
    for ids in steps:
        want = jb.bert_forward(jp, jc, _j(ids), cache=jcache)
        got = tb.bert_forward(tp, tc, _t(ids).long(), cache=tcache)
        _close(got["last_hidden_state"], want["last_hidden_state"])
        jcache, tcache = want["cache"], got["cache"]
        assert tcache["length"] == int(jcache["length"])
        _close(tcache["k"], jcache["k"])


def test_quantize_bert_weights_matches_jax(hf_bert):
    (jc, jp), (tc, tp) = _both(hf_bert)
    for bits in (8, 4):
        want = _port(j_quantize_bert(jp, bits=bits))
        got = quantize_bert_weights(tp, bits=bits)
        assert set(got["layers"]) == set(want["layers"])
        for name, leaf in want["layers"].items():
            if isinstance(leaf, QTensor):
                assert name in BERT_MATMUL_WEIGHTS and leaf.bits == got["layers"][name].bits
                assert torch.equal(got["layers"][name].values, leaf.values)
                assert torch.equal(got["layers"][name].scales, leaf.scales)
            else:
                assert torch.equal(got["layers"][name], leaf)
        assert got["embeddings"] is tp["embeddings"]
    sub = quantize_bert_weights(tp, bits=8, include=["q_w"])
    assert isinstance(sub["layers"]["q_w"], QTensor)
    assert not isinstance(sub["layers"]["k_w"], QTensor)


def test_int8_matches_jax_and_stays_near_dense(hf_bert, inputs):
    ids, mask, _ = inputs
    (jc, jp), (tc, tp) = _both(hf_bert, 1.0)
    jq = j_quantize_bert(jp, bits=8)
    want = jb.bert_forward(jq, jc, _j(ids), _j(mask))["last_hidden_state"]
    got = tb.bert_forward(_port(jq), tc, _t(ids).long(), _t(mask))["last_hidden_state"]
    _close(got, want)
    dense = tb.bert_forward(tp, tc, _t(ids).long(), _t(mask))["last_hidden_state"]
    assert float((got - dense).abs().max() / dense.abs().max()) < 0.05


@pytest.fixture(scope="module")
def int4_model():
    """d_model 256 and d_ff 512: every matmul has K % 256 == 0, so JAX runs
    its Pallas int4 kernel (interpret mode here) and the port K7's plain
    version."""
    cfg = jb.BertConfig(vocab_size=64, d_model=256, n_layers=2, n_heads=4, d_ff=512,
                        max_position_embeddings=32, softmax_n=1.0)
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(3))
    tcfg = tb.BertConfig(vocab_size=64, d_model=256, n_layers=2, n_heads=4, d_ff=512,
                         max_position_embeddings=32, softmax_n=1.0)
    return cfg, jp, tcfg


def test_int4_matches_jax_pallas(int4_model):
    jc, jp, tc = int4_model
    jq = j_quantize_bert(jp, bits=4)
    ids = np.random.RandomState(8).randint(0, 64, size=(2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[0, 5:] = 0
    want = jb.bert_forward(jq, jc, _j(ids), _j(mask))
    tq = _port(jq)
    assert tq["layers"]["q_w"].bits == 4 and tq["layers"]["q_w"].packed_axis is not None
    got = tb.bert_forward(tq, tc, _t(ids).long(), _t(mask))
    _close(got["last_hidden_state"], want["last_hidden_state"])
    _close(got["pooler_output"], want["pooler_output"])


def test_int4_is_its_dequantized_tree(int4_model):
    """K7's route (here its plain version) against plain matmuls over the
    same int4 weights dequantized to f32: the check that chip_smoke holds
    on the card at BERT-base."""
    from flash_attention_softmax_n_tpu_torch.quant import dequantize
    jc, jp, tc = int4_model
    tq = quantize_bert_weights(_port(jp), bits=4)
    deq = dict(tq, layers={k: dequantize(v) if isinstance(v, QTensor) else v
                           for k, v in tq["layers"].items()})
    ids = torch.from_numpy(np.random.RandomState(9).randint(0, 64, (2, 8)))
    got = tb.bert_forward(tq, tc, ids)["last_hidden_state"]
    want = tb.bert_forward(deq, tc, ids)["last_hidden_state"]
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_init_bert_params_layout_matches_jax():
    for kw in ({}, {"position_embedding_type": "relative_key", "add_cross_attention": True,
                    "is_decoder": True}):
        jc = jb.BertConfig(vocab_size=40, d_model=16, n_layers=3, n_heads=2, d_ff=24,
                           max_position_embeddings=12, **kw)
        tc = tb.BertConfig(vocab_size=40, d_model=16, n_layers=3, n_heads=2, d_ff=24,
                           max_position_embeddings=12, **kw)
        jshapes = jax.tree.map(lambda a: a.shape, jb.init_bert_params(jc, jax.random.PRNGKey(0)))
        tp = tb.init_bert_params(tc, 0, device="cpu")
        tshapes = {g: {k: tuple(v.shape) for k, v in d.items()} for g, d in tp.items()}
        assert tshapes == jshapes
        assert float(tp["layers"]["q_w"].std()) == pytest.approx(0.02, rel=0.2)
        cache = tb.init_bert_kv_cache(tc, 2, device="cpu")
        assert tuple(cache["k"].shape) == (3, 2, 2, 12, 8) and cache["length"] == 0


# ----------------------------------------------------------------------------
# dropout (HF attention_probs_dropout_prob, hidden_dropout_prob)
# ----------------------------------------------------------------------------


def _train_cfg(hf_bert, **kw):
    _, (tc, tp) = _both(hf_bert)
    return dataclasses.replace(tc, attn_dropout=0.2, hidden_dropout=0.1, **kw), tp


def test_train_dropout_invariants(hf_bert, inputs):
    ids = _t(inputs[0]).long()
    cfg, params = _train_cfg(hf_bert)

    def run(seed):
        return tb.bert_forward(params, cfg, ids, train=True,
                               generator=torch.Generator().manual_seed(seed))[
                                   "last_hidden_state"]

    evl = tb.bert_forward(params, cfg, ids)["last_hidden_state"]
    assert torch.equal(evl, tb.bert_forward(params, cfg, ids)["last_hidden_state"])
    assert torch.equal(run(0), run(0))
    assert not torch.allclose(run(0), evl)
    assert not torch.allclose(run(0), run(1))
    with pytest.raises(ValueError, match="generator"):
        tb.bert_forward(params, cfg, ids, train=True)


def test_train_dropout_gradients_flow(hf_bert, inputs):
    ids = _t(inputs[0]).long()
    cfg, params = _train_cfg(hf_bert, softmax_n=1.0)
    leaves = [v for d in params.values() for v in d.values()]
    for p in leaves:
        p.requires_grad_(True)
    out = tb.bert_forward(params, cfg, ids, train=True,
                          generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad((out["last_hidden_state"] ** 2).sum(), leaves,
                                allow_unused=True)
    grads = [g for g in grads if g is not None]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def _assert_carried(got, want, path=""):
    """``params_from_jax`` kept every leaf bit for bit (QTensor fields too)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_carried(got[k], want[k], f"{path}/{k}")
    elif hasattr(want, "scales"):
        assert isinstance(got, QTensor) and got.bits == want.bits, path
        assert got.packed_axis == want.packed_axis, path
        _assert_carried(got.values, want.values, path + "/values")
        _assert_carried(got.scales, want.scales, path + "/scales")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_params_from_jax_carries_bert_trees(bits):
    cfg = jb.BertConfig(vocab_size=64, d_model=256, n_layers=2, n_heads=4, d_ff=512,
                        max_position_embeddings=32, is_decoder=True,
                        add_cross_attention=True, position_embedding_type="relative_key")
    jp = jb.init_bert_params(cfg, jax.random.PRNGKey(1))
    if bits is not None:
        jp = j_quantize_bert(jp, bits=bits)
    _assert_carried(_port(jp), jax.tree.map(np.asarray, jp))
