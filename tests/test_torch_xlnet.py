"""Port parity: XLNet's relative attention core and ``xlnet_forward``
against HF (``XLNetRelativeAttention`` and ``XLNetModel``, tiny configs)
and against the JAX package on the same weights (``params_from_jax``):
the core and rel_shift within 2e-5, the whole forward within 1e-4 (the JAX
package's tolerances against HF), head_mask and output_attentions within
2e-5. Dropout is held by its invariants (JAX draws its masks from another
generator).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.analysis import (
    activation_stats_to_dict as j_to_dict,
    register_activation_hooks as j_register,
)
from flash_attention_softmax_n_tpu.models import xlnet as jx
from flash_attention_softmax_n_tpu.ops import relative_attention as jra
from flash_attention_softmax_n_tpu.surgery import convert as jconv
from flash_attention_softmax_n_tpu_torch.analysis import (
    activation_stats_to_dict,
    register_activation_hooks,
    summarize_attention,
)
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.models import xlnet as tx
from flash_attention_softmax_n_tpu_torch.ops import relative_attention as tra
from flash_attention_softmax_n_tpu_torch.quant import gate_report
from flash_attention_softmax_n_tpu_torch.surgery import convert as tconv

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)
CORE_TOL = 2e-5
TOL = 1e-4
QLEN, KLEN, BSZ, NH, DH = 6, 6, 2, 4, 8
VOCAB, DM, NL = 97, NH * DH, 2


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=tol, rtol=0)


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def hf_attn():
    torch.manual_seed(0)
    cfg = transformers.XLNetConfig(d_model=NH * DH, n_head=NH, d_inner=64, n_layer=1)
    module = transformers.models.xlnet.modeling_xlnet.XLNetRelativeAttention(cfg)
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.1)
    module.eval()
    return module


@pytest.fixture(scope="module")
def core_inputs():
    g = torch.Generator().manual_seed(1)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.5

    q, k, v = t(QLEN, BSZ, NH, DH), t(KLEN, BSZ, NH, DH), t(KLEN, BSZ, NH, DH)
    kr = t(2 * KLEN, BSZ, NH, DH)
    seg_mat = torch.nn.functional.one_hot(
        torch.randint(0, 2, (QLEN, KLEN, BSZ), generator=g), 2).float()
    attn_mask = (torch.rand(QLEN, KLEN, BSZ, 1, generator=g) < 0.15).float()
    return q, k, v, kr, seg_mat, attn_mask


def _core_kw(hf_attn, seg_mat, attn_mask, to):
    return dict(r_w_bias=to(hf_attn.r_w_bias), r_r_bias=to(hf_attn.r_r_bias),
                r_s_bias=to(hf_attn.r_s_bias), seg_embed=to(hf_attn.seg_embed),
                seg_mat=to(seg_mat), attn_mask=to(attn_mask), scale=float(hf_attn.scale))


def _tt(t):
    return None if t is None else t.detach().clone()


def _jj(t):
    return None if t is None else jnp.asarray(t.detach().numpy())


def test_rel_shift_matches_hf_and_jax():
    x = torch.randn(2, 3, 5, 10, generator=torch.Generator().manual_seed(2))
    want = transformers.models.xlnet.modeling_xlnet.XLNetRelativeAttention.rel_shift_bnij(
        x, klen=5)
    got = tra.rel_shift_bnij(x, klen=5)
    assert torch.equal(got, want)
    _close(got, jra.rel_shift_bnij(jnp.asarray(x.numpy()), klen=5), 1e-6)


@pytest.mark.parametrize("with_mask_and_segments", [True, False])
def test_core_matches_hf_at_n0(hf_attn, core_inputs, with_mask_and_segments):
    q, k, v, kr, seg_mat, attn_mask = core_inputs
    if not with_mask_and_segments:
        seg_mat = attn_mask = None
    kw = _core_kw(hf_attn, seg_mat, attn_mask, _tt)
    if seg_mat is None:
        kw.update(r_s_bias=None, seg_embed=None)
    with torch.no_grad():
        want = hf_attn.rel_attn_core(q, k, v, kr, seg_mat=seg_mat, attn_mask=attn_mask)
    _close(tra.xlnet_rel_attn_core_n(q, k, v, kr, softmax_n_param=0.0, **kw), want, CORE_TOL)


@pytest.mark.parametrize("n", [0.0, 1.0, 3.0])
def test_core_matches_jax(hf_attn, core_inputs, n):
    q, k, v, kr, seg_mat, attn_mask = core_inputs
    hm = torch.ones(QLEN, KLEN, BSZ, NH)
    hm[..., 1] = 0.0
    got, gp = tra.xlnet_rel_attn_core_n(q, k, v, kr, softmax_n_param=n, head_mask=hm,
                                        return_probs=True,
                                        **_core_kw(hf_attn, seg_mat, attn_mask, _tt))
    want, wp = jra.xlnet_rel_attn_core_n(
        _jj(q), _jj(k), _jj(v), _jj(kr), softmax_n_param=n, head_mask=_jj(hm),
        return_probs=True, **_core_kw(hf_attn, seg_mat, attn_mask, _jj))
    _close(got, want, CORE_TOL)
    _close(gp, wp, CORE_TOL)


def test_core_fill_follows_the_mask_dtype(hf_attn, core_inputs):
    """The fill follows the mask's dtype as in JAX (65500 under an fp16
    mask, 1e30 otherwise): with every key masked, both agree with JAX and
    stay finite."""
    q, k, v, kr, seg_mat, _ = core_inputs
    full = torch.ones(QLEN, KLEN, BSZ, 1)
    out = {}
    for dt in (torch.float32, torch.float16):
        got = tra.xlnet_rel_attn_core_n(q, k, v, kr, softmax_n_param=1.0,
                                        **_core_kw(hf_attn, seg_mat, full.to(dt), _tt))
        want = jra.xlnet_rel_attn_core_n(
            _jj(q), _jj(k), _jj(v), _jj(kr), softmax_n_param=1.0,
            **_core_kw(hf_attn, seg_mat, full.to(dt), _jj))
        _close(got, want, CORE_TOL)
        out[dt] = got
    assert torch.isfinite(out[torch.float16]).all()


def test_core_rejects_negative_n(hf_attn, core_inputs):
    q, k, v, kr, seg_mat, attn_mask = core_inputs
    with pytest.raises(ValueError):
        tra.xlnet_rel_attn_core_n(q, k, v, kr, softmax_n_param=-1.0,
                                  **_core_kw(hf_attn, seg_mat, attn_mask, _tt))


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(7)
    cfg = transformers.XLNetConfig(vocab_size=VOCAB, d_model=DM, n_layer=NL, n_head=NH,
                                   d_inner=64, dropout=0.0, mem_len=8, clamp_len=-1)
    model = transformers.XLNetModel(cfg)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.05)
    model.eval()
    return model


@pytest.fixture(scope="module")
def both(hf_model):
    jc = jconv.xlnet_config_from_hf(hf_model.config)
    jp = jconv.xlnet_params_from_hf(hf_model, jc)
    return (jc, jp), (tconv.xlnet_config_from_hf(hf_model.config), _port(jp))


def _ids(seed, b=2, l=10):
    return torch.randint(0, VOCAB, (b, l), generator=torch.Generator().manual_seed(seed))


def _run(both, ids, n=0.0, **kw):
    """(port, JAX) xlnet_forward on the same inputs and weights."""
    (jc, jp), (tc, tp) = both
    jkw = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    return (tx.xlnet_forward(tp, dataclasses.replace(tc, softmax_n=n), ids, **kw),
            jx.xlnet_forward(jp, dataclasses.replace(jc, softmax_n=n),
                             jnp.asarray(ids.numpy()), **jkw))


def _hf_out(hf_model, ids, **kw):
    with torch.no_grad():
        return hf_model(ids, use_mems=kw.pop("use_mems", False), **kw)


@pytest.mark.parametrize("n", [0.0, 1.0])
def test_plain_forward_matches_hf_and_jax(hf_model, both, n):
    ids = _ids(11)
    got, want = _run(both, ids, n)
    _close(got["last_hidden_state"], want["last_hidden_state"], TOL)
    assert got["mems"] is None
    if n == 0.0:
        _close(got["last_hidden_state"], _hf_out(hf_model, ids).last_hidden_state, TOL)


def test_masks_and_token_types_match_hf_and_jax(hf_model, both):
    ids = _ids(12)
    g = torch.Generator().manual_seed(13)
    attention_mask = (torch.rand(2, 10, generator=g) < 0.8).float()
    attention_mask[:, 0] = 1.0
    tt = torch.randint(0, 2, (2, 10), generator=g)
    got, want = _run(both, ids, attention_mask=attention_mask, token_type_ids=tt)
    _close(got["last_hidden_state"], want["last_hidden_state"], TOL)
    hf = _hf_out(hf_model, ids, attention_mask=attention_mask, token_type_ids=tt)
    _close(got["last_hidden_state"], hf.last_hidden_state, TOL)
    # input_mask is attention_mask's complement; both at once is refused
    inv, _ = _run(both, ids, input_mask=1.0 - attention_mask, token_type_ids=tt)
    _close(inv["last_hidden_state"], got["last_hidden_state"], 1e-6)
    with pytest.raises(ValueError, match="only one"):
        _run(both, ids, attention_mask=attention_mask, input_mask=attention_mask)


def _perm_target(P=3, L=10):
    perm_mask = torch.zeros(2, L, L)
    perm_mask[:, :, -P:] = 1.0
    target_mapping = torch.zeros(2, P, L)
    for j in range(P):
        target_mapping[:, j, L - P + j] = 1.0
    return perm_mask, target_mapping


def test_two_stream_target_mapping_matches_hf_and_jax(hf_model, both):
    ids = _ids(14)
    perm_mask, target_mapping = _perm_target()
    got, want = _run(both, ids, perm_mask=perm_mask, target_mapping=target_mapping)
    assert tuple(got["last_hidden_state"].shape) == (2, 3, DM)
    _close(got["last_hidden_state"], want["last_hidden_state"], TOL)
    hf = _hf_out(hf_model, ids, perm_mask=perm_mask, target_mapping=target_mapping)
    _close(got["last_hidden_state"], hf.last_hidden_state, TOL)


def test_mems_recurrence_matches_hf_and_jax(hf_model, both):
    ids1, ids2 = _ids(15), _ids(16)
    hf1 = _hf_out(hf_model, ids1, use_mems=True)
    hf2 = _hf_out(hf_model, ids2, mems=hf1.mems, use_mems=True)
    got1, want1 = _run(both, ids1, use_mems=True)
    assert tuple(got1["mems"].shape) == (NL, 8, 2, DM)
    _close(got1["mems"], want1["mems"], TOL)
    _close(got1["mems"][0], hf1.mems[0], TOL)
    tt = torch.randint(0, 2, (2, 10), generator=torch.Generator().manual_seed(3))
    got2, want2 = _run(both, ids2, mems=got1["mems"], use_mems=True, token_type_ids=tt)
    _close(got2["last_hidden_state"], want2["last_hidden_state"], TOL)
    _close(got2["mems"], want2["mems"], TOL)
    got2, _ = _run(both, ids2, mems=got1["mems"], use_mems=True)
    _close(got2["last_hidden_state"], hf2.last_hidden_state, TOL)


@pytest.mark.parametrize("variant", [
    dict(attn_type="uni"), dict(attn_type="uni", same_length=True),
    dict(bi_data=True), dict(clamp_len=3), dict(reuse_len=4, mem_len=6),
    dict(ff_activation="relu")])
def test_config_variants_match_jax(both, variant):
    (jc, jp), (tc, tp) = both
    both = ((dataclasses.replace(jc, **variant), jp), (dataclasses.replace(tc, **variant), tp))
    ids = _ids(17)
    perm_mask, target_mapping = _perm_target()
    got1, want1 = _run(both, ids, 1.0, use_mems=True)
    _close(got1["last_hidden_state"], want1["last_hidden_state"], TOL)
    got, want = _run(both, ids, 1.0, mems=got1["mems"], use_mems=True,
                     perm_mask=perm_mask, target_mapping=target_mapping)
    _close(got["last_hidden_state"], want["last_hidden_state"], TOL)
    _close(got["mems"], want["mems"], TOL)


def test_head_mask_matches_hf_and_jax(hf_model, both):
    ids = _ids(18, l=6)
    hm = torch.ones(NL, NH)
    hm[0, 0] = 0.0
    hm[1, 2] = 0.0
    got, want = _run(both, ids, head_mask=hm)
    _close(got["last_hidden_state"], want["last_hidden_state"], CORE_TOL)
    _close(got["last_hidden_state"], _hf_out(hf_model, ids, head_mask=hm).last_hidden_state,
           CORE_TOL)


def test_output_attentions_match_hf_and_jax(hf_model, both):
    ids = _ids(19, l=7)
    mask = torch.ones(2, 7)
    mask[1, 5:] = 0.0
    got, want = _run(both, ids, attention_mask=mask, output_attentions=True)
    assert tuple(got["attentions"].shape) == (NL, 2, NH, 7, 7)
    _close(got["attentions"], want["attentions"], CORE_TOL)
    hf = _hf_out(hf_model, ids, attention_mask=mask, output_attentions=True)
    for i, probs in enumerate(hf.attentions):
        _close(got["attentions"][i], probs, CORE_TOL)


def test_output_attentions_two_stream_match_jax(both):
    ids = _ids(20, l=6)
    tmap = torch.zeros(2, 2, 6)
    tmap[:, 0, 3] = 1.0
    tmap[:, 1, 5] = 1.0
    got, want = _run(both, ids, 1.0, target_mapping=tmap, output_attentions=True)
    assert tuple(got["g_attentions"].shape) == (NL, 2, NH, 6, 6)
    _close(got["attentions"], want["attentions"], CORE_TOL)
    _close(got["g_attentions"], want["g_attentions"], CORE_TOL)
    stats = summarize_attention(got["attentions"])
    assert tuple(stats["null_mass_mean"].shape) == (NL, NH)
    assert bool((stats["null_mass_mean"] > 0).all())


def test_taps_match_jax_and_feed_the_gate(both):
    (jc, jp), (tc, tp) = both
    names = [f"layer.{i}.rel_attn.output" for i in range(NL)]
    ids = _ids(21, l=8)
    got, gtaps = tx.xlnet_forward(tp, tc, ids, collect_taps=True)
    _, wtaps = jx.xlnet_forward(jp, jc, jnp.asarray(ids.numpy()), collect_taps=True)
    assert list(gtaps) == list(wtaps) == names
    for name in names:
        assert tuple(gtaps[name].shape) == (2, 8, DM)
        _close(gtaps[name], wtaps[name], TOL)
    assert torch.equal(got["last_hidden_state"],
                       tx.xlnet_forward(tp, tc, ids)["last_hidden_state"])

    th, ts = register_activation_hooks(
        lambda i: tx.xlnet_forward(tp, tc, i, collect_taps=True), names, names, device="cpu")
    jh, js = j_register(lambda i: jx.xlnet_forward(jp, jc, i, collect_taps=True), names, names)
    for seed in range(2):
        ids = _ids(30 + seed, l=8)
        _, ts = th(ts, ids)
        _, js = jh(js, jnp.asarray(ids.numpy()))
    td, jd = activation_stats_to_dict(ts), j_to_dict(js)
    assert td[names[0]]["n_samples"] == 4
    for name in names:
        np.testing.assert_allclose(td[name]["variance"], jd[name]["variance"], rtol=1e-4)
    report = gate_report(td)
    assert set(report) == set(names)
    assert all({"kurtosis", "int8_ok", "int4_ok", "fp8_ok"} <= set(e) for e in report.values())


def test_init_xlnet_params_layout_matches_jax():
    jc = jx.XLNetConfig(vocab_size=40, d_model=16, n_layers=3, n_heads=2, d_head=8,
                        d_inner=24)
    tc = tx.XLNetConfig(vocab_size=40, d_model=16, n_layers=3, n_heads=2, d_head=8,
                        d_inner=24)
    jshapes = jax.tree.map(lambda a: a.shape, jx.init_xlnet_params(jc, jax.random.PRNGKey(0)))
    tp = tx.init_xlnet_params(tc, 0, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == jshapes["layers"]
    assert tuple(tp["word_embedding"].shape) == jshapes["word_embedding"]
    assert tuple(tp["mask_emb"].shape) == jshapes["mask_emb"]


# ----------------------------------------------------------------------------
# dropout (HF XLNetConfig.dropout)
# ----------------------------------------------------------------------------


def test_train_dropout_invariants(both):
    _, (tc, tp) = both
    cfg = dataclasses.replace(tc, dropout=0.2)
    ids = _ids(22, l=6)
    perm_mask, tmap = _perm_target(2, 6)

    def run(seed, **kw):
        return tx.xlnet_forward(tp, cfg, ids, train=True,
                                generator=torch.Generator().manual_seed(seed), **kw)[
                                    "last_hidden_state"]

    evl = tx.xlnet_forward(tp, cfg, ids)["last_hidden_state"]
    assert torch.equal(run(0), run(0))
    assert not torch.allclose(run(0), evl)
    assert not torch.allclose(run(0), run(1))
    two = dict(perm_mask=perm_mask, target_mapping=tmap)
    assert torch.equal(run(2, **two), run(2, **two))
    with pytest.raises(ValueError, match="generator"):
        tx.xlnet_forward(tp, cfg, ids, train=True)


def test_train_dropout_gradients_flow(both):
    _, (tc, tp) = both
    cfg = dataclasses.replace(tc, dropout=0.2, softmax_n=1.0)
    leaves = [tp["word_embedding"], tp["mask_emb"], *tp["layers"].values()]
    leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    params = {"word_embedding": leaves[0], "mask_emb": leaves[1],
              "layers": dict(zip(tp["layers"], leaves[2:]))}
    out = tx.xlnet_forward(params, cfg, torch.tensor([[5, 9, 2, 7]]), train=True,
                           generator=torch.Generator().manual_seed(3))
    grads = torch.autograd.grad((out["last_hidden_state"] ** 2).sum(), leaves,
                                allow_unused=True)
    grads = [g for g in grads if g is not None]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_params_from_jax_carries_init_xlnet_params():
    """JAX's random init crosses bit for bit, and both packages compute the
    same forward on it (n 1, masks, two streams, mems)."""
    jc = jx.XLNetConfig(vocab_size=VOCAB, d_model=DM, n_layers=NL, n_heads=NH, d_head=DH,
                        d_inner=64, mem_len=6)
    jp = jx.init_xlnet_params(jc, jax.random.PRNGKey(4))
    tp = _port(jp)
    for name, leaf in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][name].numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(tp["word_embedding"].numpy(), np.asarray(jp["word_embedding"]))
    tc = tx.XLNetConfig(vocab_size=VOCAB, d_model=DM, n_layers=NL, n_heads=NH, d_head=DH,
                        d_inner=64, mem_len=6)
    both = ((jc, jp), (tc, tp))
    perm_mask, tmap = _perm_target(2, 10)
    got1, want1 = _run(both, _ids(23), 1.0, use_mems=True)
    got, want = _run(both, _ids(24), 1.0, mems=got1["mems"], use_mems=True,
                     perm_mask=perm_mask, target_mapping=tmap,
                     token_type_ids=torch.randint(0, 2, (2, 10),
                                                  generator=torch.Generator().manual_seed(5)))
    _close(got["last_hidden_state"], want["last_hidden_state"], TOL)
    _close(got["mems"], want["mems"], TOL)
