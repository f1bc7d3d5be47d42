"""Port parity: the surgery registry, ``apply_attention_softmax_n``, the
algorithm form, and the HF converters, mirroring tests/test_surgery.py on
the port. ``from_pretrained_hf`` on tiny HF BERT, RoBERTa, Llama and XLNet
models must give trees bit-equal (values and dtypes) to ``params_from_jax``
of the JAX package's converter output on the same model, and a converter
fed a state dict and a stand-in config (HF's attribute names, no
``transformers`` object) must give the same tree as the HF model does.
"""

import dataclasses
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu import surgery as jsurgery
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.models import (
    BertConfig,
    DecoderConfig,
    bert_forward,
    decoder_forward,
)
from flash_attention_softmax_n_tpu_torch.models.xlnet import XLNetConfig, xlnet_forward
from flash_attention_softmax_n_tpu_torch.ops.relative_attention import XLNetAttentionConfig
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor
from flash_attention_softmax_n_tpu_torch.surgery import (
    AttentionSoftmaxN,
    PolicyRegistry,
    apply_attention_softmax_n,
    from_pretrained_hf,
    policy_registry,
)
from flash_attention_softmax_n_tpu_torch.surgery import convert

torch.set_num_threads(2)


class TestRegistryValidation:
    def test_wrong_arity_rejected(self):
        reg = PolicyRegistry()
        with pytest.raises(TypeError, match="exactly"):
            @reg.register("foo")
            def bad(config, softmax_n_param: float):
                return config, {}

    def test_wrong_third_name_rejected(self):
        reg = PolicyRegistry()
        with pytest.raises(TypeError, match="softmax_n_param"):
            @reg.register("foo")
            def bad(config, params, n: float):
                return config, params

    def test_wrong_annotation_rejected(self):
        reg = PolicyRegistry()
        with pytest.raises(TypeError, match="annotated float"):
            @reg.register("foo")
            def bad(config, params, softmax_n_param: int):
                return config, params

    def test_duplicate_rejected(self):
        reg = PolicyRegistry()

        @reg.register("foo")
        def ok(config, params, softmax_n_param: float):
            return config, params

        with pytest.raises(ValueError, match="already"):
            @reg.register("foo")
            def dup(config, params, softmax_n_param: float):
                return config, params

    @pytest.mark.parametrize("key", [42, ""])
    def test_invalid_key_rejected(self, key):
        reg = PolicyRegistry()
        with pytest.raises((TypeError, ValueError)):
            reg.register(key)(lambda config, params, softmax_n_param: None)

    def test_no_key_rejected(self):
        with pytest.raises(ValueError, match="at least one"):
            PolicyRegistry().register()

    def test_builtin_registrations_match_jax(self):
        for cfg in (BertConfig(), DecoderConfig(), XLNetConfig(), XLNetAttentionConfig()):
            assert policy_registry.lookup(cfg) is not None
        strings = {k for k in policy_registry if isinstance(k, str)}
        assert strings == {k for k in jsurgery.policy_registry if isinstance(k, str)}
        assert sorted(k.__name__ for k in policy_registry if isinstance(k, type)) == sorted(
            k.__name__ for k in jsurgery.policy_registry if isinstance(k, type))


class TestApply:
    @pytest.mark.parametrize("cfg", [BertConfig(softmax_n=0.0), DecoderConfig(softmax_n=0.0),
                                     XLNetConfig(), XLNetAttentionConfig()])
    def test_config_rewrite(self, cfg):
        new_cfg, params = apply_attention_softmax_n((cfg, {"w": 1}), 4.0)
        assert new_cfg.softmax_n == 4.0 and type(new_cfg) is type(cfg)
        assert params == {"w": 1}
        assert cfg.softmax_n == 0.0  # a rewrite: the input is untouched

    def test_idempotent(self):
        c1, p1 = apply_attention_softmax_n((BertConfig(), {}), 1.0)
        c2, _ = apply_attention_softmax_n((c1, p1), 1.0)
        assert c1 == c2

    def test_negative_n_rejected(self):
        with pytest.raises(ValueError):
            apply_attention_softmax_n((BertConfig(), {}), -1.0)

    def test_missing_n_rejected(self):
        with pytest.raises(ValueError):
            apply_attention_softmax_n((BertConfig(), {}))

    def test_unregistered_warns_and_is_noop(self, caplog):
        @dataclasses.dataclass
        class UnknownConfig:
            softmax_n: float = 0.0

        with caplog.at_level(logging.WARNING):
            out_cfg, _ = apply_attention_softmax_n((UnknownConfig(), {}), 1.0)
        assert out_cfg.softmax_n == 0.0
        assert any("not registered" in r.message for r in caplog.records)

    @pytest.mark.parametrize("model_type", ["roberta", "llama", "mistral", "gpt", "xlnet"])
    def test_hf_model_type_string_lookup(self, model_type):
        @dataclasses.dataclass
        class HFLikeConfig:
            softmax_n: float = 0.0
            model_type: str = "bert"

        out_cfg, _ = apply_attention_softmax_n((HFLikeConfig(model_type=model_type), {}), 2.0)
        assert out_cfg.softmax_n == 2.0


class TestCustomArchitectureEndToEnd:
    def test_register_and_apply(self):
        reg = PolicyRegistry()

        @dataclasses.dataclass(frozen=True)
        class DoubleAttentionConfig:
            softmax_n: float = 0.0

        @reg.register(DoubleAttentionConfig)
        def double_converter(config, params, softmax_n_param: float):
            return (dataclasses.replace(config, softmax_n=softmax_n_param),
                    {k: v * 2.0 for k, v in params.items()})

        fn = reg.lookup(DoubleAttentionConfig())
        new_cfg, new_params = fn(DoubleAttentionConfig(), {"w": torch.ones(2, 2)}, 1.0)
        assert new_cfg.softmax_n == 1.0
        assert torch.equal(new_params["w"], torch.full((2, 2), 2.0))


class TestAlgorithmForm:
    def test_fires_on_init_event(self):
        class State:
            config = BertConfig()
            params = {}

        algo = AttentionSoftmaxN(softmax_n_param=1.0)
        assert algo.required_on_load()
        assert algo.match("init", State)
        assert not algo.match("batch_start", State)
        algo.apply("init", State)
        assert State.config.softmax_n == 1.0


# ----------------------------------------------------------------------------
# the converters
# ----------------------------------------------------------------------------

def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, QTensor):
        _assert_same_tree(got.values, want.values, path + "/values")
        _assert_same_tree(got.scales, want.scales, path + "/scales")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def _jax_tree(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tiny(kind, seed=0):
    """A tiny random HF model (the converter tests skip without transformers)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    if kind in ("bert", "roberta"):
        cls = transformers.BertModel if kind == "bert" else transformers.RobertaModel
        cfg_cls = transformers.BertConfig if kind == "bert" else transformers.RobertaConfig
        model = cls(cfg_cls(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=64,
                            max_position_embeddings=40, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0))
    elif kind == "llama":
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=64, max_position_embeddings=64))
    else:
        model = transformers.XLNetModel(transformers.XLNetConfig(
            vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64, mem_len=8))
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.05)
    model.eval()
    return model


@pytest.mark.parametrize("kind", ["bert", "roberta", "llama", "xlnet"])
@pytest.mark.parametrize("softmax_n", [0.0, 1.0])
def test_from_pretrained_hf_is_bit_equal_to_jax(kind, softmax_n):
    model = _tiny(kind)
    jcfg, jparams = jsurgery.from_pretrained_hf(model, softmax_n_param=softmax_n)
    cfg, params = from_pretrained_hf(model, softmax_n_param=softmax_n, device="cpu")
    _assert_same_tree(params, _jax_tree(jparams))
    assert cfg.softmax_n == jcfg.softmax_n == softmax_n
    fields = {f.name for f in dataclasses.fields(cfg)} - {"dtype"}
    jfields = {f.name for f in dataclasses.fields(jcfg)} - {"dtype"}
    for name in fields & jfields:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_from_pretrained_hf_dtype_matches_jax(dtype):
    model = _tiny("bert")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _, jparams = jsurgery.from_pretrained_hf(model, softmax_n_param=1.0, dtype=jdt)
    cfg, params = from_pretrained_hf(model, softmax_n_param=1.0, dtype=dtype, device="cpu")
    assert cfg.dtype == dtype
    _assert_same_tree(params, _jax_tree(jparams))


def test_unknown_model_type_is_refused():
    stand_in = types.SimpleNamespace(config=types.SimpleNamespace(model_type="gpt2"),
                                     state_dict=dict)
    with pytest.raises(ValueError, match="unsupported HF model_type"):
        from_pretrained_hf(stand_in, device="cpu")


def _stand_in_config(hf_config, names):
    """A plain object with HF's attribute names: no transformers class."""
    return types.SimpleNamespace(**{n: getattr(hf_config, n) for n in names})


BERT_ATTRS = ("model_type", "vocab_size", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "intermediate_size", "max_position_embeddings",
              "type_vocab_size", "layer_norm_eps")
LLAMA_ATTRS = ("model_type", "vocab_size", "hidden_size", "num_hidden_layers",
               "num_attention_heads", "num_key_value_heads", "intermediate_size",
               "max_position_embeddings", "rope_theta", "rms_norm_eps")
XLNET_ATTRS = ("model_type", "vocab_size", "d_model", "n_layer", "n_head", "d_head",
               "d_inner", "ff_activation", "attn_type", "bi_data", "clamp_len",
               "same_length", "mem_len", "reuse_len", "layer_norm_eps")


@pytest.mark.parametrize("kind,attrs", [("bert", BERT_ATTRS), ("llama", LLAMA_ATTRS),
                                        ("xlnet", XLNET_ATTRS)])
def test_state_dict_and_stand_in_config(kind, attrs):
    model = _tiny(kind)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    stand_in = types.SimpleNamespace(config=_stand_in_config(model.config, attrs),
                                     state_dict=lambda: sd)
    cfg, params = from_pretrained_hf(stand_in, softmax_n_param=1.0, device="cpu")
    want_cfg, want = from_pretrained_hf(model, softmax_n_param=1.0, device="cpu")
    _assert_same_tree(params, want)
    # the optional attributes take HF's defaults, dropout off
    assert cfg.softmax_n == want_cfg.softmax_n == 1.0
    # a bare state dict to the params converter
    fn = {"bert": convert.bert_params_from_hf, "llama": convert.llama_params_from_hf,
          "xlnet": convert.xlnet_params_from_hf}[kind]
    _assert_same_tree(fn(sd, cfg, device="cpu"), want)


def test_llama_ties_lm_head_without_one():
    model = _tiny("llama")
    sd = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
    cfg = convert.llama_config_from_hf(model.config)
    params = convert.llama_params_from_hf(sd, cfg, device="cpu")
    assert torch.equal(params["lm_head"], params["embed"].T)
    assert params["lm_head"].is_contiguous()


def test_prefixed_state_dicts_convert():
    """BertForMaskedLM's 'bert.' and XLNetLMHeadModel's 'transformer.'
    prefixes are stripped."""
    model = _tiny("bert")
    cfg = convert.bert_config_from_hf(model.config)
    prefixed = {"bert." + k: v for k, v in model.state_dict().items()}
    _assert_same_tree(convert.bert_params_from_hf(prefixed, cfg, device="cpu"),
                      convert.bert_params_from_hf(model, cfg, device="cpu"))
    xmodel = _tiny("xlnet")
    xcfg = convert.xlnet_config_from_hf(xmodel.config)
    xprefixed = {"transformer." + k: v for k, v in xmodel.state_dict().items()}
    _assert_same_tree(convert.xlnet_params_from_hf(xprefixed, xcfg, device="cpu"),
                      convert.xlnet_params_from_hf(xmodel, xcfg, device="cpu"))


def test_converted_models_run():
    """Surgery's output runs in the port's models: BERT and XLNet at n 0
    compute what HF does; the llama tree runs in decoder_forward."""
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 7)))
    for kind in ("bert", "xlnet"):
        model = _tiny(kind, seed=1)
        cfg, params = from_pretrained_hf(model, softmax_n_param=0.0, device="cpu")
        forward = bert_forward if kind == "bert" else xlnet_forward
        got = forward(params, cfg, ids)["last_hidden_state"]
        with torch.no_grad():
            want = model(ids).last_hidden_state
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    cfg, params = from_pretrained_hf(_tiny("llama"), softmax_n_param=1.0,
                                     dtype=torch.float32, device="cpu")
    cfg = dataclasses.replace(cfg, attn_implementation="xla")
    logits = decoder_forward(params, cfg, ids)
    assert tuple(logits.shape) == (2, 7, 64) and bool(torch.isfinite(logits).all())


def test_exports_match_jax():
    import flash_attention_softmax_n_tpu_torch.surgery as tsurgery
    assert tsurgery.__all__ == jsurgery.__all__
    assert convert.__all__ == __import__(
        "flash_attention_softmax_n_tpu.surgery.convert", fromlist=["__all__"]).__all__
