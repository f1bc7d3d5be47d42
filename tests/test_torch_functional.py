"""Port parity: softmax_n and slow_attention_n against the JAX package.

The same seeded numpy inputs go through both; fp32 on the CPU, held within
1e-6 (both compute the same float32 formula; only summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.ops import functional as jf
from flash_attention_softmax_n_tpu_torch.ops import functional as tf

torch.set_num_threads(2)
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("offset", [0.0, -100.0])
def test_softmax_n_matches_jax(n, offset):
    # offset -100 puts every row below -88.7, where exp(-rowmax) overflows
    # f32: the n == 0 term must be dropped, the n > 0 shift clamped at 0
    x = np.random.RandomState(0).randn(4, 7, 33).astype(np.float32) + offset
    want = np.asarray(jf.softmax_n(jnp.asarray(x), n=n))
    got = tf.softmax_n(_t(x), n=n).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_softmax_n_axis_and_dtype():
    x = np.random.RandomState(1).randn(5, 6).astype(np.float32)
    want = np.asarray(jf.softmax_n(jnp.asarray(x), n=1.0, axis=0,
                                   dtype=jnp.float16)).astype(np.float32)
    got = tf.softmax_n(_t(x), n=1.0, axis=0, dtype=torch.float16)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["none", "causal", "rect_causal", "bool_mask",
                                  "float_bias"])
def test_slow_attention_n_matches_jax(n, mode):
    rng = np.random.RandomState(2)
    L, S, E = (5, 9, 16) if mode == "rect_causal" else (7, 7, 16)
    q, k, v = (rng.randn(2, 3, m, E).astype(np.float32) * 0.5
               for m in (L, S, S))
    kw = {}
    if mode in ("causal", "rect_causal"):
        kw["is_causal"] = True
    elif mode == "bool_mask":
        kw["attn_mask"] = rng.rand(2, 1, L, S) > 0.3
    elif mode == "float_bias":
        kw["attn_mask"] = rng.randn(L, S).astype(np.float32)
    want = np.asarray(jf.slow_attention_n(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), softmax_n_param=n,
        **{k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}))
    got = tf.slow_attention_n(
        _t(q), _t(k), _t(v), softmax_n_param=n,
        **{k_: _t(v_) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
