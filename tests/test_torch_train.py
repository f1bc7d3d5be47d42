"""Port parity: causal-LM training on the f32 TINY config of
tests/test_torch_decoder.py.

JAX's parameters cross over with ``params_from_jax``; both sides take the
fused attention route (the port's plain K1/K5/K6 on CPU tensors, JAX's
Pallas kernels in interpret mode). The loss is held within 1e-5 and every
parameter gradient within 1e-4 (f32; summation order differs). Dropout
draws from different generators on the two sides, so its invariants are
tested on the port alone. The optimizer is held against ``optax.adamw``
on the same gradients, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attention_softmax_n_tpu import models as jm
from flash_attention_softmax_n_tpu.parallel.train import (
    causal_lm_loss as j_loss,
)
from flash_attention_softmax_n_tpu_torch import models as tm
from flash_attention_softmax_n_tpu_torch.convert import params_from_jax
from flash_attention_softmax_n_tpu_torch.parallel import (
    causal_lm_loss as t_loss,
)
from flash_attention_softmax_n_tpu_torch.parallel import make_train_step

torch.set_num_threads(2)
TINY_KW = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=64, max_seq_len=128, softmax_n=1.0)
TOKENS = np.random.RandomState(0).randint(0, 97, size=(2, 24)).astype(np.int32)


def _configs(**kw):
    return (jm.DecoderConfig(**TINY_KW, dtype=jnp.float32,
                             attn_implementation="pallas", **kw),
            tm.DecoderConfig(**TINY_KW, dtype=torch.float32,
                             attn_implementation="pallas", **kw))


@pytest.fixture(scope="module")
def jparams():
    return jm.init_decoder_params(_configs()[0], jax.random.PRNGKey(0))


def _port(tree, grad=False):
    params = params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    for p in _leaves(params):
        p.requires_grad_(grad)
    return params


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], f"{path}/{k}")]
    return [tree]


def _by_path(tree, path=""):
    """{"/layers/wq": leaf, ...} (JAX returns its dicts with sorted keys)."""
    if isinstance(tree, dict):
        return {p: x for k in tree for p, x in _by_path(tree[k], f"{path}/{k}")
                .items()}
    return {path: tree}


def _tokens():
    return torch.from_numpy(TOKENS).long()


def _port_grads(params, cfg, **kw):
    loss = t_loss(params, cfg, _tokens(), **kw)
    grads = torch.autograd.grad(loss, _leaves(params))
    return loss, grads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(jparams, remat):
    jc, tc = _configs(remat=remat)
    jl, jg = jax.value_and_grad(j_loss)(jparams, jc, jnp.asarray(TOKENS))
    params = _port(jparams, grad=True)
    tl, tg = _port_grads(params, tc)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=0)
    want = _by_path(jg)
    for path, g in zip(_by_path(params), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]),
                                   atol=1e-4, rtol=0, err_msg=path)


def test_remat_gives_the_same_grads(jparams):
    _, plain = _configs()
    _, remat = _configs(remat=True)
    params = _port(jparams, grad=True)
    la, ga = _port_grads(params, plain)
    lb, gb = _port_grads(params, remat)
    assert la.item() == lb.item()
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7, rtol=0)


def test_training_config_constructs_and_unported_raise(jparams, tmp_path):
    tm.DecoderConfig(**TINY_KW, remat=True, attn_dropout=0.1)
    for kw in (dict(act_bits=8), dict(int8_mm_impl="pallas")):
        tm.DecoderConfig(**TINY_KW, remat=True, **kw)
    # the meshed options are ported (tests/test_torch_parallel.py); without
    # a mesh they raise
    for kw in (dict(sp_axis="sp"), dict(dcn_data_axis="dcn"), dict(zero1=True)):
        with pytest.raises(ValueError, match="need a mesh"):
            make_train_step(_configs()[1], **kw)
    # a mesh of one rank takes the step of one device, SP ring and ZeRO-1
    # included
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    from tests.torch_worlds import one_rank_group
    cfg = _configs()[1]
    init, step = make_train_step(cfg, learning_rate=1e-2)
    _, _, want = step(*init(_port(jparams)), _tokens())
    with one_rank_group(tmp_path):
        mesh = make_mesh({"data": 1, "model": 1, "sp": 1})
        for kw in (dict(sp_axis="sp"), dict(zero1=True)):
            init, step = make_train_step(cfg, mesh, learning_rate=1e-2, **kw)
            _, _, got = step(*init(_port(jparams)), _tokens())
            np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


class TestDropout:
    """The invariants of JAX's tests/test_decoder.py TestTrainingMode, on
    the port's fused route with attn_dropout = 0.25."""

    def _forward(self, params, cfg, seed=None, **kw):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tm.decoder_forward(params, cfg, _tokens(), generator=gen,
                                      **kw)

    def test_deterministic_per_seed_and_off_in_eval(self, jparams):
        _, cfg = _configs(attn_dropout=0.25)
        params = _port(jparams)
        evl = self._forward(params, cfg)
        t1 = self._forward(params, cfg, 0, train=True)
        t2 = self._forward(params, cfg, 0, train=True)
        t3 = self._forward(params, cfg, 9, train=True)
        assert torch.equal(t1, t2)
        assert not torch.allclose(t1, evl)
        assert not torch.allclose(t1, t3)
        # train=False ignores dropout, generator or not
        assert torch.equal(self._forward(params, cfg, 0), evl)

    def test_train_requires_generator(self, jparams):
        _, cfg = _configs(attn_dropout=0.25)
        with pytest.raises(ValueError, match="generator"):
            tm.decoder_forward(_port(jparams), cfg, _tokens(), train=True)

    def test_grads_finite_nonzero_and_same_under_remat(self, jparams):
        _, cfg = _configs(attn_dropout=0.25)
        _, cfg_remat = _configs(attn_dropout=0.25, remat=True)
        params = _port(jparams, grad=True)

        def grads(c):
            return _port_grads(params, c, train=True,
                               generator=torch.Generator().manual_seed(1))

        la, ga = grads(cfg)
        lb, gb = grads(cfg_remat)
        assert all(bool(torch.isfinite(g).all()) for g in ga)
        assert all(float(g.abs().max()) > 0 for g in ga)
        # the recompute must see the forward's masks: the seeds are drawn
        # before the checkpointed layers
        assert la.item() == lb.item()
        for a, b in zip(ga, gb):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7, rtol=0)
        _, gc = _port_grads(params, cfg)
        assert not all(torch.allclose(a, c) for a, c in zip(ga, gc))


def test_default_optimizer_matches_optax_adamw(jparams):
    jc, tc = _configs()
    _, jg = jax.value_and_grad(j_loss)(jparams, jc, jnp.asarray(TOKENS))
    tx = optax.adamw(1e-3)
    state = tx.init(jparams)
    want = jparams
    for _ in range(2):
        updates, state = tx.update(jg, state, want)
        want = optax.apply_updates(want, updates)
    init, _ = make_train_step(tc, learning_rate=1e-3)
    params, opt = init(_port(jparams))
    grads, want = _by_path(_port(jg)), _by_path(want)
    for _ in range(2):
        for path, p in _by_path(params).items():
            p.grad = grads[path].clone()
        opt.step()
    for path, got in _by_path(params).items():
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want[path]),
                                   atol=1e-6, rtol=0, err_msg=path)


def test_train_step_lowers_the_loss(jparams):
    _, cfg = _configs(attn_dropout=0.1, remat=True)
    init, step = make_train_step(cfg, learning_rate=3e-3)
    params, opt = init(_port(jparams))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        params, opt, loss = step(params, opt, _tokens(), generator=gen)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in _leaves(params))
