"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless told otherwise."""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys\n"
        "import flash_attention_softmax_n_tpu_torch as p\n"
        "import flash_attention_softmax_n_tpu_torch.analysis\n"
        "import flash_attention_softmax_n_tpu_torch.convert\n"
        "import flash_attention_softmax_n_tpu_torch.engine\n"
        "import flash_attention_softmax_n_tpu_torch.kernels._build\n"
        "import flash_attention_softmax_n_tpu_torch.kernels.cache_update\n"
        "import flash_attention_softmax_n_tpu_torch.kernels.decode_attention\n"
        "import flash_attention_softmax_n_tpu_torch.kernels.flash_attention\n"
        "import flash_attention_softmax_n_tpu_torch.kernels.fused_mlp\n"
        "import flash_attention_softmax_n_tpu_torch.kernels.prefill_phases\n"
        "import flash_attention_softmax_n_tpu_torch.kernels.quant_matmul\n"
        "import flash_attention_softmax_n_tpu_torch.models\n"
        "import flash_attention_softmax_n_tpu_torch.models.bert\n"
        "import flash_attention_softmax_n_tpu_torch.models.xlnet\n"
        "import flash_attention_softmax_n_tpu_torch.ops.relative_attention\n"
        "import flash_attention_softmax_n_tpu_torch.parallel\n"
        "import flash_attention_softmax_n_tpu_torch.parallel.mesh\n"
        "import flash_attention_softmax_n_tpu_torch.parallel.ring_attention\n"
        "import flash_attention_softmax_n_tpu_torch.parallel.sharding\n"
        "import flash_attention_softmax_n_tpu_torch.parallel.train\n"
        "import flash_attention_softmax_n_tpu_torch.quant\n"
        "import flash_attention_softmax_n_tpu_torch.quant.gates\n"
        "import flash_attention_softmax_n_tpu_torch.surgery\n"
        "import flash_attention_softmax_n_tpu_torch.surgery.convert\n"
        "import flash_attention_softmax_n_tpu_torch.utils.bench_cache_update\n"
        "import flash_attention_softmax_n_tpu_torch.utils.checkpoint\n"
        "import flash_attention_softmax_n_tpu_torch.utils.bench_decode_attn\n"
        "import flash_attention_softmax_n_tpu_torch.utils.profile_prefill_phases\n"
        "import flash_attention_softmax_n_tpu_torch.utils.profiling\n"
        "import chip_smoke\n"
        "assert p.TRITON_INSTALLED is False and p.PALLAS_INSTALLED is True\n"
        "assert callable(p.flash_attention_n_triton)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "       or m == 'flash_attention_softmax_n_tpu'\n"
        "       or m.startswith('flash_attention_softmax_n_tpu.')\n"
        "       or m == 'scripts' or m.startswith('scripts.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
        "hf = [m for m in sys.modules if m == 'transformers'\n"
        "      or m.startswith('transformers.')]\n"
        "assert not hf, hf\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only refusal")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only refusal")
    from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
    from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
    from flash_attention_softmax_n_tpu_torch.models import (
        DecoderConfig,
        greedy_generate,
        init_decoder_params,
    )
    from flash_attention_softmax_n_tpu_torch.analysis import (
        init_activation_stats,
        register_activation_hooks,
    )
    from flash_attention_softmax_n_tpu_torch.models.bert import (
        BertConfig,
        init_bert_kv_cache,
        init_bert_params,
    )
    from flash_attention_softmax_n_tpu_torch.models.xlnet import (
        XLNetConfig,
        init_xlnet_params,
    )
    from flash_attention_softmax_n_tpu_torch.quant import init_quantized_kv_cache
    from flash_attention_softmax_n_tpu_torch.surgery import from_pretrained_hf
    from flash_attention_softmax_n_tpu_torch.surgery.convert import (
        bert_params_from_hf,
        llama_params_from_hf,
        xlnet_params_from_hf,
    )
    from flash_attention_softmax_n_tpu_torch.parallel import initialize_distributed
    from flash_attention_softmax_n_tpu_torch.utils import profile_prefill_phases
    cfg = DecoderConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2,
                        n_kv_heads=1, d_ff=8, max_seq_len=8,
                        dtype=torch.float32)
    params = init_decoder_params(cfg, 0, device="cpu")
    bert = BertConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, d_ff=8,
                      max_position_embeddings=8)
    xlnet = XLNetConfig(vocab_size=16, d_model=8, n_layers=1, n_heads=2, d_head=4,
                        d_inner=8)
    # an HF model's stand-in: its config's attributes and an empty state dict
    stand_in = types.SimpleNamespace(
        config=types.SimpleNamespace(
            model_type="bert", vocab_size=16, hidden_size=8, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=8, max_position_embeddings=8,
            type_vocab_size=2, layer_norm_eps=1e-12),
        state_dict=dict)
    calls = [
        lambda: InferenceEngine(cfg, params, piggyback_prefill=False),
        lambda: init_decoder_params(cfg, 0),
        lambda: params_from_jax({"embed": params["embed"].numpy()}),
        lambda: greedy_generate(params, cfg, [[1, 2]], 2),
        lambda: init_quantized_kv_cache(1, 1, 1, 4, 8),
        lambda: init_quantized_kv_cache(1, 1, 1, 4, 8, mode="fp8"),
        lambda: profile_prefill_phases.run((1, 1, 64, 32)),
        lambda: profile_prefill_phases.main(["--shape", "1,1,64,32"]),
        lambda: init_bert_params(bert, 0),
        lambda: init_bert_kv_cache(bert, 1),
        lambda: init_xlnet_params(xlnet, 0),
        lambda: bert_params_from_hf({}, bert),
        lambda: llama_params_from_hf({}, cfg),
        lambda: xlnet_params_from_hf({}, xlnet),
        lambda: from_pretrained_hf(stand_in, 1.0),
        lambda: init_activation_stats(["a"]),
        lambda: register_activation_hooks(lambda x: (x, {}), ["a.attention.output"]),
        # NCCL on the card unless the caller asks for gloo on the CPU
        lambda: initialize_distributed("localhost:1"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _qkv(seed=0, shape=(1, 2, 16, 8)):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(3))


def test_public_api_matches_the_jax_package():
    import flash_attention_softmax_n_tpu as jp

    import flash_attention_softmax_n_tpu_torch as tp
    assert tp.__all__ == jp.__all__
    assert all(hasattr(tp, name) for name in tp.__all__)
    assert tp.PALLAS_INSTALLED is jp.PALLAS_INSTALLED is True
    assert tp.TRITON_INSTALLED is jp.TRITON_INSTALLED is False


# names of a JAX subpackage's __all__ that the port does not export, each
# with its reason
_EXPORT_EXCEPTIONS = {
    "kernels": {"FlashConfig": "the TPU's block sizes for the Pallas kernel; "
                               "K1 plans its own tiles"},
    "utils": {"V5E": "a TPU's chip spec; the port has H100",
              "V5P": "a TPU's chip spec; the port has H100"},
}


@pytest.mark.parametrize("sub", ["analysis", "engine", "kernels", "models", "ops",
                                 "parallel", "quant", "surgery", "utils"])
def test_subpackage_exports_cover_the_jax_package(sub):
    import importlib
    jax_mod = importlib.import_module(f"flash_attention_softmax_n_tpu.{sub}")
    port = importlib.import_module(f"flash_attention_softmax_n_tpu_torch.{sub}")
    skip = _EXPORT_EXCEPTIONS.get(sub, {})
    assert set(skip) <= set(jax_mod.__all__)
    missing = set(jax_mod.__all__) - set(skip) - set(port.__all__)
    assert not missing, f"{sub} lacks {sorted(missing)}"
    assert all(hasattr(port, name) for name in port.__all__)


@pytest.mark.parametrize("causal", [False, True])
def test_triton_alias_warns_and_takes_the_fused_route(causal):
    import flash_attention_softmax_n_tpu_torch as tp
    q, k, v = _qkv()
    with pytest.warns(UserWarning, match="reference API's name"):
        got = tp.flash_attention_n_triton(q, k, v, softmax_n_param=1.0, is_causal=causal)
    want = tp.flash_attention_n(q, k, v, softmax_n_param=1.0, is_causal=causal,
                                implementation="pallas")
    assert torch.equal(got, want)
    # a caller's own implementation is kept
    with pytest.warns(UserWarning):
        xla = tp.flash_attention_n_triton(q, k, v, softmax_n_param=1.0, is_causal=causal,
                                          implementation="xla")
    torch.testing.assert_close(xla, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("blocks", [(None, None), (128, 128), (64, 512)])
def test_block_sizes_are_accepted_and_ignored(blocks):
    from flash_attention_softmax_n_tpu_torch import flash_attention_n
    q, k, v = _qkv(1)
    bq, bk = blocks
    got = flash_attention_n(q, k, v, softmax_n_param=1.0, is_causal=True, block_q=bq,
                            block_k=bk)
    assert torch.equal(got, flash_attention_n(q, k, v, softmax_n_param=1.0, is_causal=True))
