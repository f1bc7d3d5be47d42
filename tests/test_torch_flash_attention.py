"""Port parity: the plain version of kernel K1 against the Pallas forward.

``flash_attention_n_fused`` and ``flash_attention_n`` of the port run on
CPU tensors, so they take K1's plain version; the JAX side runs the Pallas
kernel in interpret mode. fp32, held within 1e-5: both use f32 scores and
statistics, and only the summation order differs. lse is compared too,
including the NEG_INF sentinel of dead rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu import flash_attention_n as j_flash
from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    flash_attention_n_fused as j_fused,
)
from flash_attention_softmax_n_tpu_torch import flash_attention_n as t_flash
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    flash_attention_n_fused as t_fused,
)

torch.set_num_threads(2)
TOL = 1e-5


def _qkv(seed, B, H, L, S, E):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, m, E).astype(np.float32) * 0.5
                 for m in (L, S, S))


def _t(a):
    return torch.from_numpy(np.array(a))


def _both_fused(q, k, v, **kw):
    jkw = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    tkw = {k_: (_t(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    jo, jl = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     return_residuals=True, **jkw)
    to, tl = t_fused(_t(q), _t(k), _t(v), return_residuals=True, **tkw)
    return (np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy())


@pytest.mark.parametrize("n", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("case", [
    # (L, S, is_causal): lengths off the 128 grid, square and rectangular
    (200, 200, False),
    (150, 150, True),
    (100, 164, True),   # L < S: causal offset S - L
    (96, 40, True),     # L > S: rows with no visible key at n == 0
])
def test_fused_matches_pallas(n, case):
    L, S, causal = case
    q, k, v = _qkv(0, 1, 2, L, S, 32)
    (jo, jl), (to, tl) = _both_fused(q, k, v, softmax_n_param=n,
                                     is_causal=causal)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=1e-6)
    if n == 0 and L > S:
        dead = np.arange(L) + (S - L) < 0
        assert (to[:, :, dead] == 0).all()


@pytest.mark.parametrize("n", [0.0, 1.0])
def test_fused_engine_mask_bias(n):
    # the engine's admission mask: right-padded prompts (true lengths per
    # row), causal within, turned into the -f32max/2 bias, broadcast over
    # heads
    L = 70
    q, k, v = _qkv(1, 3, 2, L, L, 64)
    true_lens = np.array([70, 33, 5])
    pos = np.arange(L)
    mask = ((pos[None, None, :] < true_lens[:, None, None])
            & (pos[None, :] <= pos[:, None])[None])[:, None]
    bias = np.where(mask, 0.0, -np.finfo(np.float32).max / 2).astype(np.float32)
    (jo, jl), (to, tl) = _both_fused(q, k, v, softmax_n_param=n, bias=bias)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=1e-6)


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("implementation", ["pallas", "xla"])
def test_public_api_matches_jax(n, implementation):
    # bool mask + causal merge, 3-D K/V broadcast against 4-D Q
    rng = np.random.RandomState(3)
    q = rng.randn(2, 4, 130, 32).astype(np.float32) * 0.5
    k = rng.randn(2, 130, 32).astype(np.float32) * 0.5
    v = rng.randn(2, 130, 32).astype(np.float32) * 0.5
    mask = rng.rand(2, 1, 130, 130) > 0.2
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              softmax_n_param=n, attn_mask=jnp.asarray(mask),
                              is_causal=True, implementation=implementation))
    got = t_flash(_t(q), _t(k), _t(v), softmax_n_param=n, attn_mask=_t(mask),
                  is_causal=True, implementation=implementation).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_unported_options_raise(tmp_path):
    # ALiBi and dropout are ported: tests/test_torch_flash_backward.py;
    # mesh is too (tests/test_torch_parallel.py): on a mesh of one rank the
    # slab is the whole problem, dropout mask included
    from flash_attention_softmax_n_tpu_torch.parallel import make_mesh
    from tests.torch_worlds import one_rank_group
    q, k, v = (_t(a) for a in _qkv(4, 1, 2, 8, 8, 32))
    kw = dict(softmax_n_param=1.0, is_causal=True, dropout_p=0.3,
              dropout_seed=torch.tensor(7, dtype=torch.int32))
    with one_rank_group(tmp_path):
        got = t_flash(q, k, v, mesh=make_mesh({"data": 1, "model": 1}), **kw)
    assert torch.equal(got, t_flash(q, k, v, **kw))


# On CUDA tensors the wrappers run K1, K5 and K6 at the next of 32, 64, 128
# and 256, zero-padding q, k, v (and o, do) along D and slicing o, dq, dk,
# dv back. Here the same padding runs around the plain versions (the CPU's
# stand-in for the kernels) and must give the unpadded plain version's
# results: zero columns add nothing to q k^T, give zero columns of o and
# leave delta = rowsum(do o) alone. Under a bias, ALiBi and dropout, with
# the true D's scale; f32 within 1e-6 of max(1, max |plain|) (only the
# summation's blocking may differ)
def test_kernel_head_dims():
    # up to 256 the next of 32, 64, 128, 256; above, the next multiple of
    # 128, as JAX pads D there
    from flash_attention_softmax_n_tpu_torch.kernels import flash_attention as fa
    assert [fa.kernel_head_dim(d) for d in (1, 16, 20, 32, 33, 80, 96, 128, 129, 256)] == [
        32, 32, 32, 32, 64, 128, 128, 128, 256, 256]
    assert [fa.kernel_head_dim(d) for d in (257, 300, 384, 385, 512, 520)] == [
        384, 384, 384, 512, 512, 640]


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("d", [16, 20, 80, 96, 160, 200, 300])
def test_head_dim_padding_is_exact(d, n):
    from flash_attention_softmax_n_tpu_torch.kernels import flash_attention as fa
    B, H, L, S = 2, 3, 40, 56
    rng = np.random.RandomState(d)
    q, k, v, do = (_t(rng.randn(B, H, m, d).astype(np.float32) * 0.5)
                   for m in (L, S, S, L))
    bias = _t(rng.randn(1, H, L, S).astype(np.float32) * 0.5)
    slopes = _t(np.array([0.5, 0.25, 0.125], np.float32))
    seed = torch.tensor([77], dtype=torch.int32)
    kw = dict(n=n, scale=d ** -0.5, is_causal=True, slopes=slopes, seed=seed,
              dropout_rate=0.2)
    want = fa.flash_fwd_reference(q, k, v, bias, **kw)
    got = fa._padded_fwd(fa.flash_fwd_reference, q, k, v, bias, **kw)
    assert got[0].shape == q.shape
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
    o, lse = want
    args = (q, k, v, bias, slopes, seed, o, lse, do)
    bkw = dict(scale=d ** -0.5, is_causal=True, dropout_rate=0.2)
    grads = fa._padded_bwd(fa.flash_bwd_reference, *args, **bkw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dslopes"), grads,
                          fa.flash_bwd_reference(*args, **bkw)):
        assert g.shape == w.shape, name
        err = float((g - w).abs().max())
        assert err <= 1e-6 * max(1.0, float(w.abs().max())), (name, err)


# the port's public API at head dims that JAX pads (16 to 32 on the card,
# 80 to 128 on both, 300 to 384 on both): forward and the three gradients
# against JAX's (its Pallas kernel in interpret mode), f32 within 1e-5
@pytest.mark.parametrize("d", [16, 80, 300])
def test_public_api_head_dims_match_jax(d):
    import jax

    rng = np.random.RandomState(5)
    q, k, v, do = (rng.randn(1, 2, m, d).astype(np.float32) * 0.5
                   for m in (70, 70, 70, 70))

    def jfn(q, k, v):
        return j_flash(q, k, v, softmax_n_param=1.0, is_causal=True,
                       implementation="pallas")

    want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = t_flash(tq, tk, tv, softmax_n_param=1.0, is_causal=True,
                  implementation="pallas")
    got.backward(_t(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    for g, w in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
