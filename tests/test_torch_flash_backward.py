"""Port parity: the fused route's dropout, ALiBi and backward against JAX.

CPU tensors take the plain versions of K1 (forward) and K5/K6 (backward);
the JAX side runs its Pallas kernels in interpret mode. The same inputs,
made with numpy from a seed, go to both. f32: forwards within 1e-5 and
dq/dk/dv/dbias within 1e-4 (only summation order differs), dslopes within
rtol 2e-4, atol 1e-5 (a sum over every (b, q, k) of the head). bf16 at
d128 (the card kernels' tile edges): gradients within one bf16 ulp, with
few elements differing at all (``test_bf16_grads_match_jax_vjp``). The
dropout hash must agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu import flash_attention_n as j_flash
from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    dropout_keep as j_keep,
)
from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    flash_attention_block_grads as j_block_grads,
)
from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    flash_attention_n_fused as j_fused,
)
from flash_attention_softmax_n_tpu_torch import flash_attention_n as t_flash
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    dropout_keep as t_keep,
)
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    flash_attention_block_grads as t_block_grads,
)
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    flash_attention_n_fused as t_fused,
)

torch.set_num_threads(2)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _arrays(seed, *shapes, scale=0.5):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32) * scale for s in shapes)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ----------------------------------------------------------------------------
# the dropout hash
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 123, -5, 2 ** 31 - 1, -2 ** 31])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_keep_bit_equal(seed, rate):
    q = np.arange(512, dtype=np.int32)[:, None]
    k = np.arange(512, dtype=np.int32)[None, :]
    want = np.asarray(j_keep(jnp.int32(seed), jnp.int32(1), jnp.int32(3),
                             jnp.asarray(q), jnp.asarray(k), rate))
    got = t_keep(torch.tensor(seed, dtype=torch.int32), 1, 3,
                 torch.from_numpy(q), torch.from_numpy(k), rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs((1.0 - got.mean()) - rate) < 0.01


def test_dropout_keep_wrapping_coordinates():
    # batch/head/position terms that wrap the 32-bit sum
    b = np.array([0, 7, 65535, 2 ** 31 - 1], np.int32)[:, None]
    h = np.array([0, 1, 31, 2 ** 30], np.int32)[None, :]
    for seed in (9, -77):
        want = np.asarray(j_keep(jnp.int32(seed), jnp.asarray(b), jnp.asarray(h),
                                 jnp.int32(100000), jnp.int32(2 ** 30 + 5), 0.5))
        got = t_keep(seed, torch.from_numpy(b), torch.from_numpy(h), 100000,
                     2 ** 30 + 5, 0.5).numpy()
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------------
# the forward with dropout and ALiBi
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0.0, 1.0])
def test_fused_dropout_forward_matches_jax(n):
    q, k, v = _arrays(30, (2, 3, 200, 64), (2, 3, 264, 64), (2, 3, 264, 64))
    want = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   softmax_n_param=n, dropout_rate=0.3, dropout_seed=77,
                   block_q=128, block_k=128)
    got = t_fused(_t(q), _t(k), _t(v), softmax_n_param=n, dropout_rate=0.3,
                  dropout_seed=77)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)


@pytest.mark.parametrize("case", [(96, 96), (100, 164), (96, 40)])
def test_fused_alibi_forward_matches_jax(case):
    L, S = case
    q, k, v = _arrays(12, (1, 4, L, 64), (1, 4, S, 64), (1, 4, S, 64))
    slopes = np.asarray([2.0 ** -(i + 1) for i in range(4)], np.float32)
    jo, jl = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     softmax_n_param=1.0, alibi_slopes=jnp.asarray(slopes),
                     is_causal=True, return_residuals=True)
    to, tl = t_fused(_t(q), _t(k), _t(v), softmax_n_param=1.0,
                     alibi_slopes=_t(slopes), is_causal=True,
                     return_residuals=True)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_TOL,
                               rtol=1e-6)


# ----------------------------------------------------------------------------
# gradients
# ----------------------------------------------------------------------------


def _grads(q, k, v, cot, *, argnums=(0, 1, 2), extra=None, **kw):
    """(JAX's vjp, the port's autograd.grad) of the fused forward at the
    cotangent ``cot``; ``extra`` maps a keyword to an array to
    differentiate as well (bias, alibi_slopes)."""
    extra = extra or {}
    names = list(extra)

    def j_fn(q, k, v, *xs):
        return j_fused(q, k, v, **dict(zip(names, xs)), **kw)

    j_in = [jnp.asarray(a) for a in (q, k, v, *extra.values())]
    _, vjp = jax.vjp(j_fn, *j_in)
    want = vjp(jnp.asarray(cot))
    t_in = [_t(a, grad=True) for a in (q, k, v, *extra.values())]
    kw = {k_: v_ for k_, v_ in kw.items() if k_ not in ("block_q", "block_k")}
    out = t_fused(*t_in[:3], **dict(zip(names, t_in[3:])), **kw)
    got = torch.autograd.grad(out, [t_in[i] for i in argnums],
                              grad_outputs=_t(cot))
    return [np.asarray(want[i]) for i in argnums], [g.numpy() for g in got]


@pytest.mark.parametrize("n", [0.0, 1.0, 4.0])
@pytest.mark.parametrize("case", [
    (136, 136, False), (136, 136, True),
    (100, 164, True),   # L < S
    (96, 40, True),     # L > S: dead rows at n == 0
])
def test_grads_match_jax_vjp(n, case):
    L, S, causal = case
    q, k, v, cot = _arrays(13, (2, 2, L, 64), (2, 2, S, 64), (2, 2, S, 64),
                           (2, 2, L, 64))
    want, got = _grads(q, k, v, cot, softmax_n_param=n, is_causal=causal)
    for w, g, name in zip(want, got, "qkv"):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0,
                                   err_msg=f"d{name}")
    if n == 0 and L > S:
        dead = np.arange(L) + (S - L) < 0
        assert (got[0][:, :, dead] == 0).all()


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("case", [(129, 129), (100, 300)],
                         ids=["L129-S129", "L100-S300"])
def test_bf16_grads_match_jax_vjp(n, case):
    # bf16 at d128, causal, L and S ending mid-tile of the card's 128-row
    # tiles: the plain version (which the card tests hold K5/K6 against)
    # must round where JAX's kernels round (ds to bf16 for dq and dk, the
    # dropped p kept in f32 for dv). Each element within one bf16 ulp
    # (2^-7 |jax|) plus 2^-9 of the largest |jax| (sums that cancel carry
    # the f32 summation order and o's own one-ulp differences through
    # delta); and at most 2% of the elements may differ at all, which a
    # rounding point out of place (e.g. p rounded to bf16 for dv: 41%)
    # exceeds.
    L, S = case
    arrays = _arrays(13, (1, 2, L, 128), (1, 2, S, 128), (1, 2, S, 128),
                     (1, 2, L, 128), scale=1.0)
    bf = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in arrays]

    def j_fn(q, k, v):
        return j_fused(q, k, v, softmax_n_param=n, is_causal=True)

    _, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in bf[:3]))
    want = vjp(jnp.asarray(bf[3]))
    tin = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
           .requires_grad_(True) for a in bf[:3]]
    out = t_fused(*tin, softmax_n_param=n, is_causal=True)
    got = torch.autograd.grad(
        out, tin, grad_outputs=torch.from_numpy(bf[3].astype(np.float32))
        .to(torch.bfloat16))
    for w, g, name in zip(want, got, "qkv"):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        diff = np.abs(g - w)
        excess = diff - 2.0 ** -7 * np.abs(w) - 2.0 ** -9 * np.abs(w).max()
        assert excess.max() <= 0, (name, float(excess.max()))
        assert (diff > 0).mean() <= 0.02, (name, float((diff > 0).mean()))
    if n == 0 and L > S:
        dead = np.arange(L) + (S - L) < 0
        assert (got[0].float().numpy()[:, :, dead] == 0).all()


@pytest.mark.parametrize("bshape", [(2, 2), (1, 2), (2, 1), (1, 1)])
def test_bias_grad_matches_jax(bshape):
    q, k, v, cot, bias = _arrays(33, (2, 2, 96, 64), (2, 2, 96, 64),
                                 (2, 2, 96, 64), (2, 2, 96, 64),
                                 (*bshape, 96, 96))
    want, got = _grads(q, k, v, cot, argnums=(0, 3), extra={"bias": bias},
                       softmax_n_param=1.0, is_causal=True)
    assert got[1].shape == bias.shape
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0)


def test_alibi_slopes_grad_matches_jax():
    q, k, v, cot = _arrays(35, (2, 4, 96, 64), (2, 4, 128, 64),
                           (2, 4, 128, 64), (2, 4, 96, 64))
    slopes = np.asarray([2.0 ** -(i + 1) for i in range(4)], np.float32)
    want, got = _grads(q, k, v, cot, argnums=(0, 1, 2, 3),
                       extra={"alibi_slopes": slopes}, softmax_n_param=1.0,
                       is_causal=True)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(got[3], want[3], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_bias_and_dropout_grads_match_jax(causal):
    q, k, v, cot, bias = _arrays(36, (1, 2, 64, 32), (1, 2, 64, 32),
                                 (1, 2, 64, 32), (1, 2, 64, 32),
                                 (1, 2, 64, 64))
    want, got = _grads(q, k, v, cot, argnums=(0, 1, 2, 3),
                       extra={"bias": bias}, softmax_n_param=2.0,
                       is_causal=causal, dropout_rate=0.1, dropout_seed=11)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=0)


def test_bias_needs_grad_false_gives_no_bias_grad():
    q, k, v, bias = _arrays(40, (1, 2, 32, 32), (1, 2, 32, 32),
                            (1, 2, 32, 32), (1, 1, 32, 32))
    tq, tb = _t(q, grad=True), _t(bias, grad=True)
    out = t_fused(tq, _t(k), _t(v), bias=tb, bias_needs_grad=False)
    dq, db = torch.autograd.grad(out.sum(), [tq, tb], allow_unused=True)
    assert db is None and dq is not None
    # the same forward with the bias gradient on: dq does not change
    out = t_fused(tq, _t(k), _t(v), bias=tb)
    dq2, db2 = torch.autograd.grad(out.sum(), [tq, tb])
    assert torch.equal(dq, dq2) and db2.shape == tb.shape


@pytest.mark.parametrize("case", [(96, 160, False), (130, 130, True),
                                  (120, 70, True)])
def test_block_grads_match_jax(case):
    # one kv block against the lse of a larger key range (the ring's use)
    L, S, causal = case
    q, k, v, k2, v2, dout = _arrays(41, (1, 2, L, 64), (1, 2, S, 64),
                                    (1, 2, S, 64), (1, 2, 50, 64),
                                    (1, 2, 50, 64), (1, 2, L, 64))
    out, lse = j_fused(jnp.asarray(q), jnp.concatenate([k2, k], 2),
                       jnp.concatenate([v2, v], 2), softmax_n_param=1.0,
                       is_causal=causal, return_residuals=True)
    want = j_block_grads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                         lse, jnp.asarray(dout), is_causal=causal)
    got = t_block_grads(_t(q), _t(k), _t(v), _t(out), _t(lse), _t(dout),
                        is_causal=causal)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=0)


def test_public_api_dropout_through_fused_route():
    q, k, v = (_t(a) for a in _arrays(38, *[(1, 2, 64, 32)] * 3))

    def run(seed, implementation="pallas", **kw):
        gen = torch.Generator().manual_seed(seed)
        return t_flash(q, k, v, softmax_n_param=1.0, dropout_p=0.4,
                       generator=gen, implementation=implementation, **kw)

    a, b, c = run(2), run(2), run(3)
    base = t_flash(q, k, v, softmax_n_param=1.0, implementation="pallas")
    assert torch.equal(a, b)
    assert not torch.allclose(a, c) and not torch.allclose(a, base)
    assert torch.equal(run(2, train=False), base)
    with pytest.raises(ValueError, match="generator"):
        t_flash(q, k, v, dropout_p=0.4, implementation="pallas")
    # the xla route draws the same hash mask from the same seed
    np.testing.assert_allclose(run(2, "xla").numpy(), a.numpy(),
                               atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("implementation", ["pallas", "xla"])
def test_public_api_mask_grads_match_jax(implementation):
    # bool mask + causal, 3-D K/V broadcast: grads through both routes
    q, k, v, cot = _arrays(3, (2, 4, 70, 32), (2, 70, 32), (2, 70, 32),
                           (2, 4, 70, 32))
    mask = np.random.RandomState(4).rand(2, 1, 70, 70) > 0.2

    def j_fn(q, k, v):
        return j_flash(q, k, v, softmax_n_param=1.0, attn_mask=jnp.asarray(mask),
                       is_causal=True, implementation=implementation)

    _, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(cot))
    tin = [_t(a, grad=True) for a in (q, k, v)]
    out = t_flash(*tin, softmax_n_param=1.0, attn_mask=_t(mask),
                  is_causal=True, implementation=implementation)
    got = torch.autograd.grad(out, tin, grad_outputs=_t(cot))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=0)
