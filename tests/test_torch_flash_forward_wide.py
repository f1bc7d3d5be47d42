"""Port parity above head dim 256, forward: K1's plain version, which the
card holds ``flash_fwd_wide_wgmma_kernel`` against (bf16 at D 384 and
512, and so 300), against JAX's fused forward.

CPU tensors take K1's plain version through ``flash_attention_n_fused``
(``return_residuals=True``: o and lse); the JAX side runs its Pallas
kernel in interpret mode, padding D to a multiple of 128 (300 to 384) as
the card's wrapper does. The same inputs, made with numpy from a seed, go
to both. The shapes cross the card kernel's tile edges: its 64-row query
tiles (L 65 and 130), S ending mid-way through its 32-key tiles, L < S,
L > S with dead rows at n = 0, and non-causal. f32: o and lse within 1e-5
(both keep f32 scores and statistics; only the summation order differs).
bf16: o within one bf16 ulp of |o| (2^-7 |o|) plus 2^-9 of the largest
|o| (p and o round to bf16 on either side of a tie), lse within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    flash_attention_n_fused as j_fused,
)
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import NEG_INF
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    flash_attention_n_fused as t_fused,
)

torch.set_num_threads(2)
TOL = 1e-5
LSE_TOL_BF16 = 1e-3


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32) * scale for s in shapes)


def _both(q, k, v, *, extra=None, **kw):
    """(JAX's (o, lse), the port's (o, lse)) as f32 numpy arrays"""
    extra = extra or {}
    jo, jl = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_residuals=True,
                     **{n: jnp.asarray(a) for n, a in extra.items()}, **kw)
    to, tl = t_fused(*(torch.from_numpy(np.asarray(a)) for a in (q, k, v)),
                     return_residuals=True,
                     **{n: torch.from_numpy(np.asarray(a)) for n, a in extra.items()}, **kw)
    return ((np.asarray(jo, np.float32), np.asarray(jl, np.float32)),
            (to.float().numpy(), tl.float().numpy()))


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("D", [300, 384, 512])
@pytest.mark.parametrize("case", [
    (65, 65, True),     # a second 64-row tile of one row; S mid-tile
    (130, 130, True),   # three query tiles, the last of 2 rows
    (40, 140, True),    # L < S: causal offset 100, S past four 32-key tiles
    (150, 70, True),    # L > S: dead rows at n == 0, S mid-tile
    (65, 97, False),    # non-causal, S one past three 32-key tiles
], ids=["L65-S65-causal", "L130-S130-causal", "L40-S140-causal", "L150-S70-causal",
        "L65-S97-full"])
def test_wide_forward_matches_jax(case, D, n):
    L, S, causal = case
    q, k, v = _arrays(40 + D, (1, 2, L, D), (1, 2, S, D), (1, 2, S, D))
    (jo, jl), (to, tl) = _both(q, k, v, softmax_n_param=n, is_causal=causal)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=1e-6)
    if n == 0 and causal and L > S:
        dead = np.arange(L) + (S - L) < 0
        assert (to[:, :, dead] == 0).all()
        assert (tl[:, :, dead] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("D", [300, 384, 512])
def test_wide_forward_bias_alibi_dropout_match_jax(D):
    # every modifier the card kernel applies on its summed S fragment at
    # once: a (1, H) bias, ALiBi and dropout (the hash at each (b, h, q, k))
    L, S, H = 70, 130, 2
    q, k, v, bias = _arrays(41 + D, (1, H, L, D), (1, H, S, D), (1, H, S, D), (1, H, L, S))
    slopes = np.asarray([0.5, 0.25], np.float32)
    (jo, jl), (to, tl) = _both(q, k, v, extra={"bias": bias, "alibi_slopes": slopes},
                               softmax_n_param=1.0, is_causal=True, dropout_rate=0.2,
                               dropout_seed=29)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=1e-6)


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("D", [300, 384, 512])
def test_wide_bf16_forward_matches_jax(D, n):
    # bf16, causal, L > S (dead rows at n == 0) and S ending mid-tile: the
    # plain version rounds the scaled q, p and o where JAX's kernel rounds
    L, S = 72, 70
    arrays = _arrays(42 + D, (1, 2, L, D), (1, 2, S, D), (1, 2, S, D), scale=1.0)
    bf = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in arrays]
    jo, jl = j_fused(*(jnp.asarray(a) for a in bf), softmax_n_param=n, is_causal=True,
                     return_residuals=True)
    to, tl = t_fused(*(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in bf),
                     softmax_n_param=n, is_causal=True, return_residuals=True)
    assert to.dtype == torch.bfloat16
    w = np.asarray(jo.astype(jnp.float32))
    g = to.float().numpy()
    excess = np.abs(g - w) - 2.0 ** -7 * np.abs(w) - 2.0 ** -9 * np.abs(w).max()
    assert excess.max() <= 0, float(excess.max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LSE_TOL_BF16, rtol=0)
    if n == 0:
        dead = np.arange(L) + (S - L) < 0
        assert (g[:, :, dead] == 0).all()
