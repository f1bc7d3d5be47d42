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
