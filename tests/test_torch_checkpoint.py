"""Port parity: ``utils/checkpoint.py`` against the JAX package's
``tests/test_utils.py`` (TestCheckpoint, TestTrainCheckpoint,
TestCheckpointModelFamilies), and checkpoints across the two packages.

Both packages write the same files, so a checkpoint written by one loads in
the other: parameters bit for bit, forward logits within 1e-5 (f32 on the
CPU). The sharded resume runs in a spawned 4-rank gloo world
(``tests/torch_worlds.py``) on {"data": 2, "model": 2} with ZeRO-1; its
losses must equal the uninterrupted run's within 1e-6, as JAX holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu import models as jm
from flash_attention_softmax_n_tpu.quant import (
    quantize_decoder_weights as j_quantize,
)
from flash_attention_softmax_n_tpu.utils import checkpoint as jc
from flash_attention_softmax_n_tpu_torch import models as tm
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.quant import (
    QTensor,
    quantize_decoder_weights,
)
from flash_attention_softmax_n_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_train_checkpoint,
    save_checkpoint,
    save_train_checkpoint,
)
from tests import torch_worlds

torch.set_num_threads(2)
TINY_KW = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=64, max_seq_len=64, softmax_n=1.0, attn_implementation="xla")
TINY = tm.DecoderConfig(**TINY_KW, dtype=torch.float32)
J_TINY = jm.DecoderConfig(**TINY_KW, dtype=jnp.float32)
TOKENS = np.random.RandomState(1).randint(0, 97, size=(4, 16)).astype(np.int64)


@pytest.fixture(scope="module")
def jparams():
    return jm.init_decoder_params(J_TINY, jax.random.PRNGKey(0))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, QTensor):
        return [tree.values, tree.scales]
    return [tree]


def _forward(params, cfg, tokens=TOKENS[:1, :8]):
    with torch.no_grad():
        return tm.decoder_forward(params, cfg, torch.from_numpy(tokens))


class TestCheckpoint:
    def test_roundtrip_dense(self, tmp_path, jparams):
        params = _port(jparams)
        save_checkpoint(tmp_path / "ckpt", TINY, params,
                        metadata={"surgery": {"softmax_n": 1.0}})
        cfg, restored, meta = load_checkpoint(tmp_path / "ckpt", device="cpu")
        assert cfg == TINY
        assert cfg.softmax_n == 1.0  # surgery persists in the checkpoint
        assert meta["surgery"]["softmax_n"] == 1.0
        for a, b in zip(_leaves(params), _leaves(restored)):
            assert torch.equal(a, b)
        np.testing.assert_allclose(_forward(restored, cfg), _forward(params, TINY),
                                   atol=1e-6)

    def test_roundtrip_bf16(self, tmp_path):
        cfg = dataclasses.replace(TINY, dtype=torch.bfloat16)
        params = tm.init_decoder_params(cfg, 0, device="cpu")
        save_checkpoint(tmp_path / "ckpt", cfg, params)
        cfg2, restored, _ = load_checkpoint(tmp_path / "ckpt", device="cpu")
        assert cfg2.dtype == torch.bfloat16
        assert restored["embed"].dtype == torch.bfloat16
        assert torch.equal(restored["embed"].view(torch.int16),
                           params["embed"].view(torch.int16))

    @pytest.mark.parametrize("bits", [8, 4, -8])
    def test_roundtrip_quantized(self, tmp_path, jparams, bits):
        qparams = quantize_decoder_weights(_port(jparams), bits=bits)
        save_checkpoint(tmp_path / "q", TINY, qparams)
        _, restored, _ = load_checkpoint(tmp_path / "q", device="cpu")
        wq = restored["layers"]["wq"]
        assert isinstance(wq, QTensor) and wq.bits == bits
        assert wq.packed_axis == qparams["layers"]["wq"].packed_axis
        assert wq.values.dtype == qparams["layers"]["wq"].values.dtype
        for a, b in zip(_leaves(qparams), _leaves(restored)):
            assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn
                               else a, b.view(torch.uint8)
                               if b.dtype == torch.float8_e4m3fn else b)
        np.testing.assert_allclose(_forward(restored, TINY), _forward(qparams, TINY),
                                   atol=1e-5)

    def test_loads_on_the_card_unless_told(self, tmp_path, jparams):
        if torch.cuda.is_available():
            pytest.skip("a card is present; this checks the CPU-only refusal")
        save_checkpoint(tmp_path / "ckpt", TINY, _port(jparams))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_checkpoint(tmp_path / "ckpt")


class TestCrossPackage:
    """A checkpoint written by either package loads in the other."""

    @pytest.mark.parametrize("bits", [None, 8, 4])
    def test_jax_checkpoint_loads_in_the_port(self, tmp_path, jparams, bits):
        jp = jparams if bits is None else j_quantize(jparams, bits=bits)
        jc.save_checkpoint(tmp_path / "j", J_TINY, jp,
                           metadata={"surgery": {"softmax_n": 1.0}})
        cfg, params, meta = load_checkpoint(tmp_path / "j", device="cpu")
        assert cfg == TINY and meta["surgery"]["softmax_n"] == 1.0
        want = np.asarray(jm.decoder_forward(jp, J_TINY,
                                             jnp.asarray(TOKENS[:1, :8])))
        np.testing.assert_allclose(_forward(params, cfg).numpy(), want,
                                   atol=1e-5)

    @pytest.mark.parametrize("bits", [None, 8, 4])
    def test_port_checkpoint_loads_in_jax(self, tmp_path, jparams, bits):
        params = _port(jparams)
        if bits is not None:
            params = quantize_decoder_weights(params, bits=bits)
        save_checkpoint(tmp_path / "t", TINY, params)
        cfg, jp, _ = jc.load_checkpoint(tmp_path / "t")
        assert cfg == J_TINY
        got = np.asarray(jm.decoder_forward(jp, cfg, jnp.asarray(TOKENS[:1, :8])))
        np.testing.assert_allclose(got, _forward(params, TINY).numpy(), atol=1e-5)

    def test_bf16_bits_cross_both_ways(self, tmp_path, jparams):
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        cfg = dataclasses.replace(J_TINY, dtype=jnp.bfloat16)
        jc.save_checkpoint(tmp_path / "j", cfg, jp)
        tcfg, params, _ = load_checkpoint(tmp_path / "j", device="cpu")
        assert tcfg.dtype == torch.bfloat16
        want = np.asarray(jp["embed"]).view(np.uint16)
        assert np.array_equal(params["embed"].view(torch.int16).numpy().view(np.uint16),
                              want)
        save_checkpoint(tmp_path / "t", tcfg, params)
        back_cfg, back, _ = jc.load_checkpoint(tmp_path / "t")
        assert back_cfg.dtype == jnp.bfloat16
        assert np.array_equal(np.asarray(back["embed"]).view(np.uint16), want)


def _adamw(leaves):
    return torch.optim.AdamW(leaves, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


class TestTrainCheckpoint:
    def test_resume_reproduces_uninterrupted_run(self, tmp_path, jparams):
        # save at step 2 from a ZeRO-1 TP x DP sharded state (gathered on
        # save, sharded again on load), restore, continue: steps 3-4 equal
        # the uninterrupted run's
        payload = {"cfg": TINY_KW, "params": jax.tree.map(np.asarray, jparams),
                   "tokens": TOKENS, "dir": str(tmp_path / "tc")}
        world = torch_worlds.run_world(tmp_path, 4, ["train_resume"], payload)
        for res in torch_worlds.results(world, "train_resume"):
            assert res["same_cfg"] and res["step"] == 2
            assert res["meta"]["run"] == "test"
            assert res["wq"] == (2, 32, 16)  # sharded again over model=2
            np.testing.assert_allclose(res["resumed"], res["straight"], rtol=1e-6)

    def test_resume_on_one_device(self, tmp_path, jparams):
        from flash_attention_softmax_n_tpu_torch.parallel import make_train_step
        tokens = torch.from_numpy(TOKENS)
        init, step = make_train_step(TINY, optimizer=_adamw)

        def run(n, params, opt):
            losses = []
            for _ in range(n):
                params, opt, loss = step(params, opt, tokens)
                losses.append(float(loss))
            return params, opt, losses

        _, _, straight = run(4, *init(_port(jparams)))
        params, opt, first = run(2, *init(_port(jparams)))
        save_train_checkpoint(tmp_path / "tc", TINY, params, opt, step=2)
        cfg, params, opt, step_r, _ = load_train_checkpoint(
            tmp_path / "tc", _adamw, device="cpu")
        assert cfg == TINY and step_r == 2
        _, _, resumed = run(2, params, opt)
        np.testing.assert_allclose(first + resumed, straight, rtol=1e-6)
        # the params part loads alone, for inference
        _, alone, meta = load_checkpoint(tmp_path / "tc", device="cpu")
        assert meta["train_step"] == 2 and "embed" in alone

    def test_wrong_optimizer_rejected(self, tmp_path, jparams):
        params = _port(jparams)
        opt = _adamw(list(params["layers"].values()) + [params["embed"],
                                                       params["final_norm"],
                                                       params["lm_head"]])
        save_train_checkpoint(tmp_path / "tc", TINY, params, opt)
        with pytest.raises(ValueError, match="optimizer"):
            load_train_checkpoint(tmp_path / "tc",
                                  lambda leaves: torch.optim.SGD(leaves, lr=1e-3),
                                  device="cpu")


class TestCheckpointModelFamilies:
    def test_roundtrip_bert_decoder_mode(self, tmp_path):
        from flash_attention_softmax_n_tpu_torch.models.bert import (
            BertConfig,
            bert_forward,
            init_bert_params,
        )
        cfg = BertConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                         d_ff=64, max_position_embeddings=32,
                         is_decoder=True, add_cross_attention=True)
        params = init_bert_params(cfg, 0, device="cpu")
        save_checkpoint(tmp_path / "bert", cfg, params)
        cfg2, restored, _ = load_checkpoint(tmp_path / "bert", device="cpu")
        assert cfg2 == cfg
        ids = torch.tensor([[1, 2, 3, 4]])
        enc = torch.from_numpy(np.random.RandomState(1).standard_normal(
            (1, 3, 32)).astype(np.float32))
        a = bert_forward(params, cfg, ids, encoder_hidden_states=enc)
        b = bert_forward(restored, cfg2, ids, encoder_hidden_states=enc)
        np.testing.assert_allclose(a["last_hidden_state"], b["last_hidden_state"],
                                   atol=1e-6)

    def test_roundtrip_xlnet(self, tmp_path):
        from flash_attention_softmax_n_tpu_torch.models.xlnet import (
            XLNetConfig,
            init_xlnet_params,
            xlnet_forward,
        )
        cfg = XLNetConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                          d_head=16, d_inner=64)
        params = init_xlnet_params(cfg, 0, device="cpu")
        save_checkpoint(tmp_path / "xlnet", cfg, params)
        cfg2, restored, _ = load_checkpoint(tmp_path / "xlnet", device="cpu")
        assert cfg2 == cfg
        ids = torch.tensor([[5, 6, 7]])
        a = xlnet_forward(params, cfg, ids)["last_hidden_state"]
        b = xlnet_forward(restored, cfg2, ids)["last_hidden_state"]
        np.testing.assert_allclose(a, b, atol=1e-6)

    @pytest.mark.parametrize("family", ["bert", "xlnet"])
    def test_jax_family_checkpoint_loads_in_the_port(self, tmp_path, family):
        # the config types map across packages by name, dtype included
        if family == "bert":
            from flash_attention_softmax_n_tpu.models.bert import (
                BertConfig, init_bert_params as init)
            cfg = BertConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                             d_ff=64, max_position_embeddings=32)
        else:
            from flash_attention_softmax_n_tpu.models.xlnet import (
                XLNetConfig, init_xlnet_params as init)
            cfg = XLNetConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                              d_head=16, d_inner=64)
        params = init(cfg, jax.random.PRNGKey(0))
        jc.save_checkpoint(tmp_path / family, cfg, params)
        tcfg, restored, _ = load_checkpoint(tmp_path / family, device="cpu")
        assert type(tcfg).__name__ == type(cfg).__name__
        assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
                if f.name != "dtype"} == {
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}
        assert tcfg.dtype == torch.float32
        for a, b in zip(jax.tree_util.tree_leaves(params), _leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
