"""Port parity: multi-device training on ``torch.distributed`` against the
JAX package's ``tests/test_parallel.py``.

The port runs in spawned gloo worlds (``tests/torch_worlds.py``: 8 ranks
for meshes, tensor and data parallelism, ZeRO-1 and training, 4 ranks on
``{"sp": 4}`` for ring attention), one world per module, each rank on its
own explicit shards; JAX runs here on its 8 virtual CPU devices, or through
the unsharded function that JAX's own tests hold its sharded runs against.
Inputs come from numpy seeds. Tolerances are JAX's: 2e-4 for ring attention
against the oracle and for the tensor-parallel logits, 1e-5 for the meshed
kernel, loss rtol 1e-4 against unsharded and 1e-5 between ZeRO-1 and
replicated AdamW; the dropout masks are bit-identical to the port's single
device.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_worlds

torch.set_num_threads(2)
TINY_KW = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
               d_ff=128, max_seq_len=64, softmax_n=1.0, attn_implementation="xla")
SEED = 1234567


def _jcfg(**kw):
    from flash_attention_softmax_n_tpu.models import DecoderConfig
    return DecoderConfig(**{**TINY_KW, **kw}, dtype=jnp.float32)


def _rng(seed):
    return np.random.RandomState(seed)


def _normal(rng, *shape, scale=0.5):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _numpy_tree(tree):
    """JAX params as plain dicts of numpy arrays (the ranks import no JAX)."""
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    from flash_attention_softmax_n_tpu.models import init_decoder_params
    return init_decoder_params(_jcfg(), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def payload(jax_params):
    rng = _rng(0)
    qkv_small = [_normal(rng, 2, 4, 32, 16) for _ in range(3)]
    return {
        "cfg": TINY_KW,
        "params": _numpy_tree(jax_params),
        "tokens": rng.randint(0, 97, size=(4, 16)).astype(np.int64),
        "tokens_long": rng.randint(0, 97, size=(4, 32)).astype(np.int64),
        "qkv": [_normal(rng, 4, 8, 64, 32) for _ in range(3)],
        "mask": np.broadcast_to(np.tril(np.ones((64, 64), bool)),
                                (4, 1, 64, 64)).copy(),
        "qkv_small": qkv_small,
        "qkv_small_ct": _normal(rng, 2, 4, 32, 16, scale=1.0),
        "bias": _normal(rng, 1, 1, 32, 32, scale=0.3),
        "seed": SEED,
        "qkv_ring": [_normal(rng, 2, 4, 32, 32) for _ in range(3)],
    }


WORLD8 = ["mesh", "tp_forward", "quantized_shard", "fused_projections_raise", "meshed_flash",
          "meshed_flash_grads", "meshed_dropout", "meshed_dropout_grads",
          "meshed_bias_indivisible", "train_tp_dp", "train_sp",
          "train_zero1", "train_hybrid", "finetune_dropout", "remat_grads",
          "ring_combined", "sp_train_pallas_remat"]


@pytest.fixture(scope="module")
def world8(payload, tmp_path_factory):
    return torch_worlds.run_world(tmp_path_factory.mktemp("world8"), 8,
                                  WORLD8, payload)


def _case(world, name):
    return torch_worlds.results(world, name)


def _jax_losses(jax_params, tokens, steps, lr=1e-2, **cfg_kw):
    """JAX's unsharded AdamW run, the reference of every sharded one."""
    from flash_attention_softmax_n_tpu.parallel import causal_lm_loss
    cfg = _jcfg(**cfg_kw)
    tx = optax.adamw(lr)

    @jax.jit
    def step(p, o, t):
        loss, g = jax.value_and_grad(causal_lm_loss)(p, cfg, t)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    p, o, out = jax_params, tx.init(jax_params), []
    for _ in range(steps):
        p, o, loss = step(p, o, jnp.asarray(tokens, jnp.int32))
        out.append(float(loss))
    return out


@pytest.fixture(scope="module")
def jax_run(jax_params, payload):
    return _jax_losses(jax_params, payload["tokens"], 3)


# ----------------------------------------------------------------------------
# TestMesh
# ----------------------------------------------------------------------------


class TestMesh:
    def test_make_mesh(self, world8):
        for r, res in enumerate(_case(world8, "mesh")):
            assert res["names"] == ("data", "model")
            assert res["shape"] == (2, 4)
            assert tuple(res["coord"]) == (r // 4, r % 4)
            assert res["local_shape"] == (2, 4)

    def test_too_many_devices_rejected(self, world8):
        for res in _case(world8, "mesh"):
            assert res["raised"][0] and "needs 4096 devices" in res["raised"][0]

    def test_hybrid_mesh_axes(self, world8):
        res = _case(world8, "mesh")[0]
        assert res["hybrid_names"] == ("dcn_data", "data", "model")
        assert res["hybrid_shape"] == (2, 2, 2)
        # DCN outermost, rank-major: one "host" holds ranks 0-3
        assert res["hybrid_ranks"] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]

    def test_hybrid_mesh_too_many_devices(self, world8):
        for res in _case(world8, "mesh"):
            assert res["raised"][1] and "needs 4096 devices" in res["raised"][1]

    def test_initialize_distributed_raises_on_another_world(self, world8):
        # deliberately unlike JAX, which swallows the error
        for res in _case(world8, "mesh"):
            assert "already up" in res["other_world"]


# ----------------------------------------------------------------------------
# TestSpecs: the rule tables, against JAX's PartitionSpecs (no process group:
# a stand-in mesh gives the axis sizes and this rank's coordinates)
# ----------------------------------------------------------------------------


class _MeshStandIn:
    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, data=2, model=4, rank=0):
        self.mesh = torch.zeros((data, model))
        self.coord = {"data": rank // model, "model": rank % model}

    def get_local_rank(self, name):
        return self.coord[name]


def _as_tuples(tree):
    """JAX's spec tree with each PartitionSpec as a tuple (QTensors kept)."""
    from jax.sharding import PartitionSpec
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


class TestSpecs:
    @pytest.mark.parametrize("bits", [None, 8, 4])
    def test_decoder_param_specs_match_jax(self, jax_params, bits):
        from flash_attention_softmax_n_tpu.parallel import (
            decoder_param_specs as j_specs,
        )
        from flash_attention_softmax_n_tpu.quant import quantize_decoder_weights
        from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
        from flash_attention_softmax_n_tpu_torch.parallel import decoder_param_specs
        jp = jax_params if bits is None else quantize_decoder_weights(jax_params, bits)
        port = decoder_param_specs(params_from_jax(_numpy_tree(jp), device="cpu"))
        want = _as_tuples(j_specs(jp))
        for name in ("embed", "final_norm", "lm_head"):
            got, ref = port[name], want[name]
            if bits is not None and name == "lm_head":
                assert (got.values, got.scales) == (tuple(ref.values), tuple(ref.scales))
            else:
                assert got == ref, name
        for name, ref in want["layers"].items():
            got = port["layers"][name]
            if hasattr(ref, "values"):
                assert (got.values, got.scales, got.bits, got.packed_axis) == (
                    tuple(ref.values), tuple(ref.scales), ref.bits, ref.packed_axis)
            else:
                assert got == ref, name

    @pytest.mark.parametrize("quantization", [None, "int8"])
    def test_kv_cache_and_batch_specs_match_jax(self, quantization):
        from flash_attention_softmax_n_tpu.models import init_kv_cache as j_cache
        from flash_attention_softmax_n_tpu.parallel import (
            batch_spec as j_batch,
            kv_cache_specs as j_kv,
        )
        from flash_attention_softmax_n_tpu_torch.models import init_kv_cache
        from flash_attention_softmax_n_tpu_torch.parallel import (
            batch_spec,
            kv_cache_specs,
        )
        jc = j_cache(_jcfg(), 2, 16, quantization=quantization)
        tc = init_kv_cache(_jcfg_port(), 2, 16, quantization=quantization,
                           device="cpu")
        got, want = kv_cache_specs(tc), _as_tuples(j_kv(jc))
        assert set(got) == set(want)
        for name in ("k", "v"):
            if quantization is None:
                assert got[name] == want[name]
            else:
                assert (got[name].values, got[name].scales) == (
                    tuple(want[name].values), tuple(want[name].scales))
        assert got["length"] == want["length"] == ()
        assert batch_spec() == tuple(j_batch()) == ("data", None)

    def test_fit_spec_relaxes_what_does_not_divide(self, jax_params, caplog):
        from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
        from flash_attention_softmax_n_tpu_torch.parallel import (
            decoder_param_specs,
            shard_pytree,
        )
        from flash_attention_softmax_n_tpu_torch.parallel.sharding import (
            param_shardings,
        )
        params = params_from_jax(_numpy_tree(jax_params), device="cpu")
        specs = decoder_param_specs(params)
        fitted = param_shardings(params, specs, _MeshStandIn())
        # vocab 97 does not divide model=4: lm_head replicated, loudly
        assert fitted["lm_head"] == (None, None)
        assert "does not divide mesh axis 'model'" in caplog.text
        assert fitted["embed"] == (None, "model")
        assert fitted["layers"]["wo"] == (None, "model", None)
        local = shard_pytree(params, specs, _MeshStandIn(rank=6))  # model 2
        assert torch.equal(local["layers"]["wq"], params["layers"]["wq"][..., 32:48])
        assert torch.equal(local["layers"]["w_down"],
                           params["layers"]["w_down"][:, 64:96])
        assert torch.equal(local["lm_head"], params["lm_head"])


def _jcfg_port():
    from flash_attention_softmax_n_tpu_torch.models import DecoderConfig
    return DecoderConfig(**TINY_KW, dtype=torch.float32)


# ----------------------------------------------------------------------------
# TestTensorParallel
# ----------------------------------------------------------------------------


class TestTensorParallel:
    def test_sharded_forward_matches_single_device(self, world8, jax_params,
                                                   payload):
        from flash_attention_softmax_n_tpu.models import decoder_forward
        ref = np.asarray(decoder_forward(jax_params, _jcfg(),
                                         jnp.asarray(payload["tokens"])))
        for r, res in enumerate(_case(world8, "tp_forward")):
            rows = slice(2 * (r // 4), 2 * (r // 4) + 2)
            np.testing.assert_allclose(res["logits"], ref[rows], atol=2e-4)

    def test_fit_spec_mixes_sharded_and_replicated(self, world8):
        # vocab 97 does not divide model=4: lm_head replicated; the
        # embedding's hidden 64 does, so it is sharded (JAX's _fit_spec)
        res = _case(world8, "tp_forward")[0]
        assert res["shapes"] == {"embed": (97, 16), "lm_head": (64, 97),
                                 "final_norm": (64,)}
        assert res["wq"] == (2, 64, 16) and res["wo"] == (2, 16, 64)

    def test_fused_projections_cannot_be_tensor_sharded(self, world8):
        # JAX raises the same at parallel/serving.py:71-75
        for res in _case(world8, "fused_projections_raise"):
            assert res and "cannot be tensor-sharded" in res

    def test_quantized_params_shard(self, world8):
        from flash_attention_softmax_n_tpu.parallel import decoder_param_specs
        from flash_attention_softmax_n_tpu.quant import (
            quantize_decoder_weights,
        )
        from flash_attention_softmax_n_tpu.models import init_decoder_params
        jq = quantize_decoder_weights(
            init_decoder_params(_jcfg(), jax.random.PRNGKey(0)), bits=8)
        jspec = decoder_param_specs(jq)["layers"]["wq"]
        for res in _case(world8, "quantized_shard"):
            assert res["spec"] == tuple(jspec.values) == (None, None, "model")
            assert res["scale_spec"] == tuple(jspec.scales)
            assert res["values"] == (2, 64, 16) and res["scales"] == (2, 1, 16)
            assert res["equal"]


# ----------------------------------------------------------------------------
# TestMeshedFlashAttention
# ----------------------------------------------------------------------------


def _slab(x, r, dp=2, tp=4):
    """Rank r's (batch, head) slab on {"data": dp, "model": tp}."""
    d, m = divmod(r, tp)
    nb, nh = x.shape[0] // dp, x.shape[1] // tp
    return x[d * nb:(d + 1) * nb, m * nh:(m + 1) * nh]


class TestMeshedFlashAttention:
    def test_meshed_pallas_matches_unmeshed(self, world8, payload):
        from flash_attention_softmax_n_tpu.ops.flash_attention import (
            flash_attention_n,
        )
        q, k, v = (jnp.asarray(a) for a in payload["qkv"])
        ref = np.asarray(flash_attention_n(
            q, k, v, softmax_n_param=1.0, attn_mask=jnp.asarray(payload["mask"]),
            implementation="pallas"))
        for r, res in enumerate(_case(world8, "meshed_flash")):
            np.testing.assert_allclose(res["out"], _slab(ref, r), atol=1e-5)

    def test_meshed_pallas_grads_match(self, world8, payload):
        # the (1,1,L,S) bias is replicated over both axes: its cotangent
        # is the sum over every slab, as shard_map's transpose gives it
        from flash_attention_softmax_n_tpu.ops.flash_attention import (
            flash_attention_n,
        )
        q, k, v = (jnp.asarray(a) for a in payload["qkv_small"])
        bias, ct = jnp.asarray(payload["bias"]), jnp.asarray(payload["qkv_small_ct"])

        def f(q, k, v, bias):
            out = flash_attention_n(q, k, v, softmax_n_param=1.0, attn_bias=bias,
                                    is_causal=True, implementation="pallas")
            return jnp.sum(out * ct)

        want = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2, 3))(
            q, k, v, bias)]
        for r, res in enumerate(_case(world8, "meshed_flash_grads")):
            for name, w in zip(("dq", "dk", "dv"), want[:3]):
                np.testing.assert_allclose(res[name], _slab(w, r), atol=2e-4,
                                           err_msg=name)
            np.testing.assert_allclose(res["dbias"], want[3], atol=2e-4)

    def test_indivisible_bias_rejected(self, world8):
        for res in _case(world8, "meshed_bias_indivisible"):
            assert res and "does not divide" in res

    def test_meshed_dropout_matches_unsharded(self, world8):
        for res in _case(world8, "meshed_dropout"):
            assert res["bit_equal"]
            assert res["differs"]

    def test_meshed_dropout_grads_match_oracle(self, world8, payload):
        # against the jnp oracle evaluating JAX's hash at global coordinates
        from flash_attention_softmax_n_tpu.kernels.flash_attention import (
            dropout_keep,
        )
        from flash_attention_softmax_n_tpu.ops.functional import softmax_n
        q, k, v = (jnp.asarray(a) for a in payload["qkv_small"])
        ct = jnp.asarray(payload["qkv_small_ct"])
        b, h, l, e = q.shape
        rate, seed = 0.25, jnp.int32(SEED)

        def oracle(q, k, v):
            s = jnp.einsum("bhle,bhse->bhls", q, k) * (e ** -0.5)
            s = jnp.where(jnp.tril(jnp.ones((l, l), bool)), s, -jnp.inf)
            p = softmax_n(s, n=1.0, axis=-1)
            coords = [jnp.arange(d, dtype=jnp.int32) for d in (b, h, l, l)]
            keep = dropout_keep(seed, *jnp.meshgrid(*coords, indexing="ij"), rate)
            p = jnp.where(keep, p / (1.0 - rate), 0.0)
            return jnp.sum(jnp.einsum("bhls,bhsv->bhlv", p, v) * ct)

        want = [np.asarray(g) for g in jax.grad(oracle, argnums=(0, 1, 2))(q, k, v)]
        for r, res in enumerate(_case(world8, "meshed_dropout_grads")):
            for name, w in zip(("dq", "dk", "dv"), want):
                np.testing.assert_allclose(res[name], _slab(w, r), atol=2e-4,
                                           err_msg=name)


# ----------------------------------------------------------------------------
# TestTrainStep, TestFineTuneTrainStep, TestRemat
# ----------------------------------------------------------------------------


class TestTrainStep:
    def test_sharded_train_step_runs_and_reduces_loss(self, world8, jax_run):
        for res in _case(world8, "train_tp_dp"):
            losses = res["losses"]
            assert losses[-1] < losses[0]
            np.testing.assert_allclose(losses, jax_run, rtol=1e-4)

    def test_loss_matches_unsharded(self, world8, jax_params, payload):
        from flash_attention_softmax_n_tpu.parallel import causal_lm_loss
        ref = float(causal_lm_loss(jax_params, _jcfg(),
                                   jnp.asarray(payload["tokens"])))
        for res in _case(world8, "train_tp_dp"):
            np.testing.assert_allclose(res["losses"][0], ref, rtol=1e-4)

    def test_pallas_attention_train_step_matches(self, world8, jax_run):
        for res in _case(world8, "train_tp_dp"):
            np.testing.assert_allclose(res["auto"], jax_run[:2], rtol=1e-4)
            assert res["auto"][1] < res["auto"][0]

    def test_sp_train_step_matches_unsharded(self, world8, jax_run):
        # TP x DP x SP: the sequence split over 'sp', attention as a ring,
        # the target shift across shard boundaries
        for res in _case(world8, "train_sp"):
            np.testing.assert_allclose(res["losses"], jax_run[:2], rtol=1e-4)
            assert res["losses"][1] < res["losses"][0]

    def test_zero1_matches_replicated_and_shards_moments(self, world8, jax_run):
        results = _case(world8, "train_zero1")
        for res in results:
            np.testing.assert_allclose(res["zero"], res["plain"], rtol=1e-5)
            np.testing.assert_allclose(res["zero"], jax_run, rtol=1e-4)
            assert res["equal"]
        # {"data": 4, "model": 2}: each model shard's parameters are held
        # once over its four data ranks, and the data ranks all hold some
        for m in range(2):
            group = [results[d * 2 + m] for d in range(4)]
            assert sum(r["n_state"] for r in group) == group[0]["n_params"]
            assert all(r["n_state"] > 0 for r in group)
            held = sorted(n for r in group for n in r["held"])
            assert held == sorted(group[0]["owners"])
            for d, r in enumerate(group):
                assert r["owners"] == group[0]["owners"]
                assert sorted(r["held"]) == sorted(
                    n for n, o in r["owners"].items() if o == d)

    def test_sp_axis_must_exist(self, world8):
        for res in _case(world8, "train_sp"):
            assert "no axis 'sp'" in res["missing"]

    def test_hybrid_dcn_train_step_matches_unsharded(self, world8, jax_run):
        for res in _case(world8, "train_hybrid"):
            np.testing.assert_allclose(res["losses"], jax_run[:2], rtol=1e-4)
            assert res["losses"][1] < res["losses"][0]


class TestFineTuneTrainStep:
    def test_dropout_step_updates_and_is_deterministic(self, world8):
        for res in _case(world8, "finetune_dropout"):
            assert res["l1"] == pytest.approx(res["l2"])
            assert res["l1"] != pytest.approx(res["eval"])
            assert res["l1"] != pytest.approx(res["l3"])
            assert res["moved"]
            # the sharded mask is one device's: the same loss
            np.testing.assert_allclose(res["l1"], res["one"], rtol=1e-5)


class TestRemat:
    def test_remat_grads_match(self, world8, jax_params, payload):
        from flash_attention_softmax_n_tpu.parallel import causal_lm_loss
        loss, grads = jax.value_and_grad(causal_lm_loss)(
            jax_params, _jcfg(), jnp.asarray(payload["tokens_long"]))
        want = [np.asarray(grads["embed"]), np.asarray(grads["layers"]["wq"]),
                np.asarray(grads["layers"]["w_down"]), np.asarray(grads["lm_head"])]
        results = _case(world8, "remat_grads")
        for m in range(4):
            cut = [want[0][:, 16 * m:16 * m + 16], want[1][..., 16 * m:16 * m + 16],
                   want[2][:, 32 * m:32 * m + 32], want[3]]
            # a data rank's gradient covers its rows; the step sums them
            pair = [results[m], results[4 + m]]
            for res in pair:
                (l0, g0), (l1, g1) = res[False], res[True]
                assert abs(l0 - l1) < 1e-6
                np.testing.assert_allclose(l0, float(loss), rtol=1e-5)
                for a, b in zip(g0, g1):
                    np.testing.assert_allclose(b, a, atol=1e-6)
            for i, w in enumerate(cut):
                got = sum(res[True][1][i] for res in pair)
                np.testing.assert_allclose(got, w, atol=1e-5)


# ----------------------------------------------------------------------------
# TestRingCombinedMeshPallas (on the 8-rank world)
# ----------------------------------------------------------------------------


class TestRingCombinedMeshPallas:
    def test_ring_pallas_under_tp_dp_sp_mesh(self, world8, payload):
        from flash_attention_softmax_n_tpu.ops.functional import slow_attention_n
        q, k, v = (jnp.asarray(a) for a in payload["qkv_ring"])
        ref = np.asarray(slow_attention_n(q, k, v, softmax_n_param=1.0,
                                          is_causal=True))
        for r, res in enumerate(_case(world8, "ring_combined")):
            d, m, s = r // 4, (r // 2) % 2, r % 2
            want = ref[d:d + 1, 2 * m:2 * m + 2, 16 * s:16 * s + 16]
            np.testing.assert_allclose(res, want, atol=2e-4)

    def test_sp_train_step_pallas(self, world8, jax_params, payload):
        from flash_attention_softmax_n_tpu.parallel import causal_lm_loss
        ref = float(causal_lm_loss(jax_params, _jcfg(),
                                   jnp.asarray(payload["tokens_long"])))
        for res in _case(world8, "sp_train_pallas_remat"):
            assert math.isfinite(res["losses"][0])
            np.testing.assert_allclose(res["losses"][0], ref, rtol=1e-4)


# ----------------------------------------------------------------------------
# TestRingAttention, TestRingAttentionPallasImpl, TestRingPaddingStory: the
# 4-rank world on {"sp": 4}
# ----------------------------------------------------------------------------

WORLD4 = ["ring_oracle", "ring_grads", "ring_gqa", "ring_plus_n",
          "ring_padding", "ring_errors"]


@pytest.fixture(scope="module")
def ring_payload():
    from tests.common import constant_qkv
    rng = _rng(5)
    const = constant_qkv((1, 1), 64, 64, 32, 32, 0.5)
    pad = [_normal(rng, 1, 2, 64, 32) for _ in range(3)]
    pad[1][:, :, 40:] = 1e9   # poison the padding tail: it must not leak in
    pad[2][:, :, 40:] = -1e9
    return {
        "qkv": [_normal(rng, 2, 2, 64, 32) for _ in range(3)],
        "qkv_g": [_normal(rng, 1, 2, 32, 16) for _ in range(3)],
        "qkv_g_ct": _normal(rng, 1, 2, 32, 16, scale=1.0),
        "qkv_gqa": [_normal(rng, 1, 4, 32, 16), _normal(rng, 1, 2, 32, 16),
                    _normal(rng, 1, 2, 32, 16)],
        "qkv_gqa_ct": _normal(rng, 1, 4, 32, 16, scale=1.0),
        "qkv_const": [np.asarray(a) for a in const],
        "qkv_pad": pad, "true_len": 40,
    }


@pytest.fixture(scope="module")
def world4(ring_payload, tmp_path_factory):
    return torch_worlds.run_world(tmp_path_factory.mktemp("world4"), 4,
                                  WORLD4, ring_payload)


def _sp_cat(per_rank):
    """The whole sequence from the ranks' shards (dim 2)."""
    return np.concatenate(per_rank, axis=2)


def _oracle(q, k, v, n, causal, ct=None):
    from flash_attention_softmax_n_tpu.ops.functional import slow_attention_n

    def f(q, k, v):
        reps = q.shape[1] // k.shape[1]
        k, v = jnp.repeat(k, reps, axis=1), jnp.repeat(v, reps, axis=1)
        return slow_attention_n(q, k, v, softmax_n_param=n, is_causal=causal)

    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    out = np.asarray(f(q, k, v))
    if ct is None:
        return out, None
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(ct)),
                     argnums=(0, 1, 2))(q, k, v)
    return out, [np.asarray(g) for g in grads]


class TestRingAttention:
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    @pytest.mark.parametrize("n", [0.0, 1.0])
    @pytest.mark.parametrize("is_causal", [False, True])
    def test_matches_oracle(self, world4, ring_payload, impl, n, is_causal):
        want, _ = _oracle(*ring_payload["qkv"], n, is_causal)
        got = _sp_cat([res[(impl, n, is_causal)]["out"]
                       for res in _case(world4, "ring_oracle")])
        np.testing.assert_allclose(got, want, atol=2e-4,
                                   err_msg=f"{impl} n={n} causal={is_causal}")

    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    @pytest.mark.parametrize("n", [0.0, 1.0])
    def test_grads_match_oracle(self, world4, ring_payload, impl, n):
        _, want = _oracle(*ring_payload["qkv_g"], n, True,
                          ct=ring_payload["qkv_g_ct"])
        results = [res[(impl, n)] for res in _case(world4, "ring_grads")]
        for name, w in zip(("dq", "dk", "dv"), want):
            np.testing.assert_allclose(_sp_cat([r[name] for r in results]), w,
                                       atol=2e-4, err_msg=f"{name} {impl} n={n}")

    @pytest.mark.parametrize("impl", ["xla", "pallas", "auto"])
    def test_gqa_kv_heads_rotate_unrepeated(self, world4, ring_payload, impl):
        want_out, want = _oracle(*ring_payload["qkv_gqa"], 1.0, True,
                                 ct=ring_payload["qkv_gqa_ct"])
        results = [res[impl] for res in _case(world4, "ring_gqa")]
        np.testing.assert_allclose(_sp_cat([r["out"] for r in results]),
                                   want_out, atol=2e-4)
        for name, w in zip(("dq", "dk", "dv"), want):
            np.testing.assert_allclose(_sp_cat([r[name] for r in results]), w,
                                       atol=2e-4, err_msg=f"{name} (gqa {impl})")

    def test_plus_n_applied_once(self, world4):
        # constant inputs, unmasked: the denominator is n + S, not n*p + S
        from tests.common import attention_analytic_answer
        want = attention_analytic_answer((1, 1), 64, 64, 32, 32,
                                         1 / math.sqrt(32), 0.5, 4.0)
        got = _sp_cat([res["out"] for res in _case(world4, "ring_plus_n")])
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


class TestRingAttentionPallasImpl:
    def test_unknown_implementation_raises(self, world4):
        for res in _case(world4, "ring_errors"):
            assert "unknown implementation" in res["impl"]

    def test_pallas_requires_matching_ev(self, world4):
        for res in _case(world4, "ring_errors"):
            assert "E == Ev" in res["ev"]


class TestRingPaddingStory:
    def test_causal_right_padding_needs_no_mask(self, world4):
        results = _case(world4, "ring_padding")
        full = _sp_cat([r[0] for r in results])
        crop = _sp_cat([r[1] for r in results])
        np.testing.assert_allclose(full[:, :, :40], crop, atol=1e-5)

    def test_attn_mask_rejected_with_guidance(self, world4):
        for res in _case(world4, "ring_errors"):
            assert "LOSS" in res["mask"]
