"""Port parity above head dim 256: K5's and K6's plain versions, which the
card holds ``flash_bwd_dq_wide_wgmma_kernel`` and
``flash_bwd_dkv_wide_wgmma_kernel`` against, and the fused route's
gradients, against JAX.

CPU tensors take the plain versions of K1 (forward) and K5/K6 (backward);
the JAX side runs its Pallas kernels in interpret mode, padding D to a
multiple of 128 (300 to 384) as the card's wrappers do. The same inputs,
made with numpy from a seed, go to both. The shapes cross the card
kernels' tile edges above D 256: K5's 128-row query tiles and 64-key
tiles, K6's 64-key and 64-row tiles (L and S ending mid-tile, L < S, L > S
with dead rows at n = 0, non-causal). f32: gradients within 1e-4 (only
summation order differs), dslopes within rtol 2e-4, atol 1e-5; bf16:
within one bf16 ulp plus 2^-9 of the largest |jax|, at most 2% of the
elements differing at all (``test_torch_flash_backward``'s bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    flash_attention_block_grads as j_block_grads,
)
from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    flash_attention_n_fused as j_fused,
)
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    flash_attention_block_grads as t_block_grads,
)
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    flash_attention_n_fused as t_fused,
)
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import kernel_head_dim

torch.set_num_threads(2)
GRAD_TOL = 1e-4


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32) * scale for s in shapes)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _grads(q, k, v, cot, *, extra=None, **kw):
    """(JAX's vjp, the port's autograd.grad) of the fused forward at the
    cotangent ``cot``, for q, k, v and each array of ``extra``"""
    extra = extra or {}
    names = list(extra)

    def j_fn(q, k, v, *xs):
        return j_fused(q, k, v, **dict(zip(names, xs)), **kw)

    _, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (q, k, v, *extra.values())))
    want = vjp(jnp.asarray(cot))
    t_in = [_t(a, grad=True) for a in (q, k, v, *extra.values())]
    out = t_fused(*t_in[:3], **dict(zip(names, t_in[3:])), **kw)
    got = torch.autograd.grad(out, t_in, grad_outputs=_t(cot))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_wide_head_dims_pad_to_multiples_of_128():
    # the card runs D 300 at 384 and 512 as it is, on the wide kernels
    assert [kernel_head_dim(d) for d in (257, 300, 384, 385, 512, 520, 640)] == [
        384, 384, 384, 512, 512, 640, 640]


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("D", [300, 512])
@pytest.mark.parametrize("case", [
    (130, 130, True),   # K5's second query tile ragged, K6's third key tile
    (65, 65, False),
    (40, 140, True),    # L < S: keys past K5's last 64-key tile
    (150, 70, True),    # L > S: dead rows at n == 0
], ids=["L130-S130-causal", "L65-S65-full", "L40-S140-causal", "L150-S70-causal"])
def test_wide_grads_match_jax_vjp(case, D, n):
    L, S, causal = case
    q, k, v, cot = _arrays(30 + D, (1, 2, L, D), (1, 2, S, D), (1, 2, S, D), (1, 2, L, D))
    want, got = _grads(q, k, v, cot, softmax_n_param=n, is_causal=causal)
    for w, g, name in zip(want, got, "qkv"):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")
    if n == 0 and L > S:
        dead = np.arange(L) + (S - L) < 0
        assert (got[0][:, :, dead] == 0).all()


@pytest.mark.parametrize("D", [300, 512])
def test_wide_bias_alibi_dropout_grads_match_jax(D):
    # every modifier the card kernels apply on their fragments at once: a
    # (1, H) bias (dbias written in full by the first column chunk's CTAs),
    # ALiBi (dslopes from K5's per-row partials) and dropout (the hash at
    # each (b, h, q, k))
    L, S, H = 70, 130, 2
    q, k, v, cot, bias = _arrays(31 + D, (1, H, L, D), (1, H, S, D), (1, H, S, D),
                                 (1, H, L, D), (1, H, L, S))
    slopes = np.asarray([0.5, 0.25], np.float32)
    want, got = _grads(q, k, v, cot, extra={"bias": bias, "alibi_slopes": slopes},
                       softmax_n_param=1.0, is_causal=True, dropout_rate=0.2,
                       dropout_seed=29)
    for w, g, name in zip(want[:4], got[:4], ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(got[4], want[4], rtol=2e-4, atol=1e-5, err_msg="dslopes")


@pytest.mark.parametrize("causal", [False, True])
def test_wide_block_grads_match_jax(causal):
    # one kv block against the lse of a larger key range (the ring's use)
    L, S, D = 70, 90, 384
    q, k, v, k2, v2, dout = _arrays(32, (1, 2, L, D), (1, 2, S, D), (1, 2, S, D),
                                    (1, 2, 40, D), (1, 2, 40, D), (1, 2, L, D))
    out, lse = j_fused(jnp.asarray(q), jnp.concatenate([k2, k], 2),
                       jnp.concatenate([v2, v], 2), softmax_n_param=1.0,
                       is_causal=causal, return_residuals=True)
    want = j_block_grads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
                         jnp.asarray(dout), is_causal=causal)
    got = t_block_grads(_t(q), _t(k), _t(v), _t(out), _t(lse), _t(dout), is_causal=causal)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("D", [300, 512])
def test_wide_bf16_grads_match_jax_vjp(D, n):
    # bf16, causal, L and S ending mid-tile: the plain version must round
    # where JAX's kernels round (ds to bf16 for dq and dk, the dropped p
    # kept in f32 for dv)
    L, S = 72, 130
    arrays = _arrays(33 + D, (1, 2, L, D), (1, 2, S, D), (1, 2, S, D), (1, 2, L, D), scale=1.0)
    bf = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in arrays]

    def j_fn(q, k, v):
        return j_fused(q, k, v, softmax_n_param=n, is_causal=True)

    _, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in bf[:3]))
    want = vjp(jnp.asarray(bf[3]))
    tin = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).requires_grad_(True)
           for a in bf[:3]]
    out = t_fused(*tin, softmax_n_param=n, is_causal=True)
    got = torch.autograd.grad(
        out, tin, grad_outputs=torch.from_numpy(bf[3].astype(np.float32)).to(torch.bfloat16))
    for w, g, name in zip(want, got, "qkv"):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        diff = np.abs(g - w)
        excess = diff - 2.0 ** -7 * np.abs(w) - 2.0 ** -9 * np.abs(w).max()
        assert excess.max() <= 0, (name, float(excess.max()))
        assert (diff > 0).mean() <= 0.02, (name, float((diff > 0).mean()))
