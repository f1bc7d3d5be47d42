"""The numeric plan of K1's f32 kernels at head dims 32, 64 and 128
(``csrc/flash_fwd_f32.cu``) and at 256 and above
(``csrc/flash_fwd_f32_wide.cu``), checked on the CPU before the card runs
them.

Those kernels take both products of the f32 forward, S = q k^T and O = P V,
as three TF32 passes (``kernels/flash_attention._tf32x3_matmul``: each
operand's TF32 head, x rounded to its top 19 bits, plus its rest, x less
the head, whose low 13 bits the tensor cores drop; rest x head and head x
rest, then head x head). ``flash_fwd_tf32x3_reference`` is the plain
forward with that product. The same inputs, made with numpy from a seed, go
through it and through JAX's f32 ``flash_attention_n_fused`` forward (its
Pallas kernels in interpret mode, as the JAX package's tests run them), at
the card kernel's tile edges (64-row query tiles, 32- or 64-key tiles: L
and S ending mid-tile, L > S with dead rows at n = 0, non-causal) and under
a bias, ALiBi and dropout. At D >= 256 (300 padded to 384 and 640 as the
wrappers pad, ``_padded_fwd``) the emulation sums as the wide kernel does,
S in chunks of 32 columns of D and P V in tiles of 64 keys added in f32
(``chunk=TF32X3_WIDE_FWD_CHUNK``), at that kernel's tile edges (64-row
query tiles, 64-key tiles). Tolerances are the smoke's f32 ones
(``chip_smoke.check_attention``): o within 2e-5, lse within 1e-3. One TF32
pass (the heads' product alone) misses o's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    flash_attention_n_fused as j_fused,
)
from flash_attention_softmax_n_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(2)
O_TOL = 2e-5
LSE_TOL = 1e-3


def _case(seed, D, L, S, *, n, causal, H=2, bias=False, alibi=False, rate=0.0):
    """(JAX's o and lse, the inputs and kwargs of the plain forward)"""
    rng = np.random.RandomState(seed)
    q, k, v, b = (rng.randn(*s).astype(np.float32)
                  for s in ((1, H, L, D), (1, H, S, D), (1, H, S, D), (1, H, L, S)))
    b = 0.5 * b
    slopes = np.asarray([2.0 ** -(i + 1) for i in range(H)], np.float32)
    extra = {}
    if bias:
        extra["bias"] = jnp.asarray(b)
    if alibi:
        extra["alibi_slopes"] = jnp.asarray(slopes)
    o, lse = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **extra,
                     softmax_n_param=n, is_causal=causal, dropout_rate=rate,
                     dropout_seed=23 if rate else None, return_residuals=True)
    inputs = tuple(torch.from_numpy(a) for a in (q, k, v)) + (
        torch.from_numpy(b) if bias else None,)
    kw = dict(n=n, scale=D ** -0.5, is_causal=causal,
              slopes=torch.from_numpy(slopes) if alibi else None,
              seed=torch.tensor([23], dtype=torch.int32) if rate else None,
              dropout_rate=rate)
    return (np.asarray(o), np.asarray(lse)), inputs, kw


def _errors(got, want):
    """(max |o - o_jax|, max |lse - lse_jax|)"""
    return tuple(float(np.abs(g.double().numpy() - w.astype(np.float64)).max())
                 for g, w in zip(got, want))


CASES = [(72, 100, True, 1.0), (65, 65, False, 0.0), (70, 30, True, 0.0), (33, 130, True, 1.0)]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("case", CASES, ids=["L72-S100-causal-n1", "L65-S65-full-n0",
                                             "L70-S30-causal-n0", "L33-S130-causal-n1"])
def test_tf32x3_forward_matches_jax(D, case):
    L, S, causal, n = case
    want, inputs, kw = _case(60 + D, D, L, S, n=n, causal=causal)
    got = fa.flash_fwd_tf32x3_reference(*inputs, **kw)
    o_err, lse_err = _errors(got, want)
    assert o_err <= O_TOL and lse_err <= LSE_TOL, (o_err, lse_err)
    if n == 0 and L > S:
        dead = np.arange(L) + (S - L) < 0
        assert bool((got[0][:, :, dead] == 0).all())
        assert bool((got[1][:, :, dead] == fa.NEG_INF).all())


@pytest.mark.parametrize("D", [32, 64, 128])
def test_tf32x3_forward_bias_alibi_dropout_match_jax(D):
    # every modifier at once: a (1, H) bias, ALiBi and dropout (the hash at
    # each (b, h, q, k)), causal with L < S
    want, inputs, kw = _case(70 + D, D, 48, 80, n=1.0, causal=True, bias=True, alibi=True,
                             rate=0.2)
    got = fa.flash_fwd_tf32x3_reference(*inputs, **kw)
    o_err, lse_err = _errors(got, want)
    assert o_err <= O_TOL and lse_err <= LSE_TOL, (o_err, lse_err)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_one_tf32_pass_misses_the_f32_o_tolerance(D):
    # the heads' product alone keeps about 10 mantissa bits: its o leaves
    # 2e-5 far behind, where the three passes stay inside
    want, inputs, kw = _case(80 + D, D, 72, 100, n=1.0, causal=True, bias=True, alibi=True)
    three = _errors(fa.flash_fwd_tf32x3_reference(*inputs, **kw), want)
    one = _errors(fa.flash_fwd_tf32x3_reference(*inputs, **kw, passes=1), want)
    assert three[0] <= O_TOL and three[1] <= LSE_TOL, three
    assert one[0] > 10 * O_TOL, one


def test_tf32x3_forward_reference_takes_f32_only():
    q = torch.zeros((1, 1, 8, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        fa.flash_fwd_tf32x3_reference(q, q, q, None, n=1.0, scale=1.0, is_causal=True)


# D >= 256: the wide kernel's numerics at the D it runs (300 at 384)
WIDE_DIMS = [256, 300, 384, 512, 640]
WIDE_CASES = [(72, 100, True, 1.0), (65, 65, False, 0.0), (70, 30, True, 0.0)]


def _wide(inputs, kw, passes=3):
    """the chunked split-TF32 forward at the kernel's head dim, o sliced back"""
    return fa._padded_fwd(fa.flash_fwd_tf32x3_reference, *inputs, passes=passes,
                          chunk=fa.TF32X3_WIDE_FWD_CHUNK, **kw)


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("case", WIDE_CASES, ids=["L72-S100-causal-n1", "L65-S65-full-n0",
                                                  "L70-S30-causal-n0"])
def test_tf32x3_wide_forward_matches_jax(D, case):
    L, S, causal, n = case
    want, inputs, kw = _case(90 + D, D, L, S, n=n, causal=causal)
    got = _wide(inputs, kw)
    assert got[0].shape == inputs[0].shape
    o_err, lse_err = _errors(got, want)
    assert o_err <= O_TOL and lse_err <= LSE_TOL, (o_err, lse_err)
    if n == 0 and L > S:
        dead = np.arange(L) + (S - L) < 0
        assert bool((got[0][:, :, dead] == 0).all())
        assert bool((got[1][:, :, dead] == fa.NEG_INF).all())


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_tf32x3_wide_forward_bias_alibi_dropout_match_jax(D):
    want, inputs, kw = _case(100 + D, D, 48, 80, n=1.0, causal=True, bias=True, alibi=True,
                             rate=0.2)
    o_err, lse_err = _errors(_wide(inputs, kw), want)
    assert o_err <= O_TOL and lse_err <= LSE_TOL, (o_err, lse_err)


@pytest.mark.parametrize("D", [256, 640])
def test_one_tf32_pass_misses_the_f32_o_tolerance_wide(D):
    want, inputs, kw = _case(110 + D, D, 72, 100, n=1.0, causal=True, bias=True, alibi=True)
    three = _errors(_wide(inputs, kw), want)
    one = _errors(_wide(inputs, kw, passes=1), want)
    assert three[0] <= O_TOL and three[1] <= LSE_TOL, three
    assert one[0] > 10 * O_TOL, one
