"""Port parity: decode_attention_n against the JAX package's
``implementation="xla"`` route (the one the serving path takes).

Cases cover the current token's k/v (``k_new``), the fused loop's tail
window, int8 caches with scales, GQA, and a slot of length 0. Both sides
round q and the probabilities to the compute dtype and accumulate in f32;
held within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.kernels.decode_attention import (
    decode_attention_n as j_decode,
)
from flash_attention_softmax_n_tpu.quant.kv_cache import quantize_kv
from flash_attention_softmax_n_tpu_torch.convert import tensor_from_numpy
from flash_attention_softmax_n_tpu_torch.kernels.decode_attention import (
    decode_attention_n as t_decode,
)

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return tensor_from_numpy(a, "cpu")


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("with_tail", [False, True])
def test_decode_attention_matches_jax_xla(n, quantized, with_tail):
    rng = np.random.RandomState(0)
    b, h, kvh, s, hd, w = 4, 8, 2, 24, 16, 8
    q = rng.randn(b, h, hd).astype(np.float32)
    kc = rng.randn(b, kvh, s, hd).astype(np.float32)
    vc = rng.randn(b, kvh, s, hd).astype(np.float32)
    lengths = np.array([0, 5, 24, 17], np.int32)  # slot 0 holds nothing
    kw = dict(softmax_n_param=n,
              k_new=rng.randn(b, kvh, hd).astype(np.float32),
              v_new=rng.randn(b, kvh, hd).astype(np.float32))
    if quantized:
        k_vals, k_scl = (np.asarray(a) for a in quantize_kv(jnp.asarray(kc), 8))
        v_vals, v_scl = (np.asarray(a) for a in quantize_kv(jnp.asarray(vc), 8))
        kw.update(k_scales=k_scl, v_scales=v_scl)
    else:
        k_vals, v_vals = kc, vc
    if with_tail:
        tail_len = np.array([3, 0, 8, 1], np.int32)
        kw.update(k_tail=rng.randn(b, kvh, w, hd).astype(np.float32).astype(
                      jnp.bfloat16),
                  v_tail=rng.randn(b, kvh, w, hd).astype(np.float32).astype(
                      jnp.bfloat16),
                  tail_lengths=tail_len)
    want = j_decode(jnp.asarray(q), jnp.asarray(k_vals), jnp.asarray(v_vals),
                    jnp.asarray(lengths), implementation="xla",
                    **{k_: jnp.asarray(v_) for k_, v_ in kw.items()
                       if isinstance(v_, np.ndarray)},
                    softmax_n_param=n)
    got = t_decode(_t(q), _t(k_vals), _t(v_vals), _t(lengths),
                   implementation="xla",
                   **{k_: _t(v_) for k_, v_ in kw.items()
                      if isinstance(v_, np.ndarray)},
                   softmax_n_param=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_empty_slot_without_new_token_is_zero():
    q = torch.randn(2, 4, 8)
    kc = torch.randn(2, 2, 6, 8)
    out = t_decode(q, kc, kc, torch.tensor([0, 6]), softmax_n_param=1.0)
    assert torch.equal(out[0], torch.zeros(4, 8))
    assert torch.isfinite(out).all()


def test_pallas_route_and_fp8_cache_match_jax():
    # "pallas" runs (K8's plain version on the CPU), an fp8 cache too, on
    # both routes against JAX's Pallas kernel in interpret mode: within
    # 8e-2 (tests/test_decode_attention.py's fp8 tolerance), and each route
    # within 1e-5 of JAX's same route. An unknown route and int8 compute
    # over a dense or an fp8 cache raise.
    q = torch.randn(1, 2, 8)
    kc = torch.randn(1, 1, 4, 8)
    out = t_decode(q, kc, kc, torch.tensor([4]), implementation="pallas")
    torch.testing.assert_close(
        out, t_decode(q, kc, kc, torch.tensor([4]), implementation="xla"),
        atol=TOL, rtol=0)
    rng = np.random.RandomState(6)
    b, h, kvh, s, hd = 3, 8, 2, 300, 64
    qf = (0.5 * rng.randn(b, h, hd)).astype(np.float32)
    kq, ks = (np.asarray(a) for a in quantize_kv(jnp.asarray(rng.randn(b, kvh, s, hd)
                                                            .astype(np.float32)), -8))
    vq, vs = (np.asarray(a) for a in quantize_kv(jnp.asarray(rng.randn(b, kvh, s, hd)
                                                            .astype(np.float32)), -8))
    lengths = np.array([300, 0, 129], np.int32)
    kw = dict(k_scales=ks, v_scales=vs, k_new=rng.randn(b, kvh, hd).astype(np.float32),
              v_new=rng.randn(b, kvh, hd).astype(np.float32))
    for dt in (jnp.float32, jnp.bfloat16):
        jargs = (jnp.asarray(qf).astype(dt), jnp.asarray(kq), jnp.asarray(vq),
                 jnp.asarray(lengths))
        targs = (_t(np.asarray(jargs[0])), _t(kq), _t(vq), _t(lengths))
        assert targs[1].dtype == torch.float8_e4m3fn
        jw = {k_: jnp.asarray(v_) for k_, v_ in kw.items()}
        tw = {k_: _t(v_) for k_, v_ in kw.items()}
        want_pallas = np.asarray(j_decode(*jargs, softmax_n_param=1.0, **jw,
                                          implementation="pallas", interpret=True),
                                 np.float32)
        for route in ("xla", "pallas"):
            got = t_decode(*targs, softmax_n_param=1.0, **tw,
                           implementation=route).float().numpy()
            want = (want_pallas if route == "pallas" else np.asarray(
                j_decode(*jargs, softmax_n_param=1.0, **jw, implementation="xla"),
                np.float32))
            np.testing.assert_allclose(got, want_pallas, atol=8e-2, rtol=0)
            # bf16 outputs: one bf16 ulp of |out| apart at most
            tol = TOL if dt == jnp.float32 else 2.0 ** -7 * np.abs(want).max()
            np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    with pytest.raises(ValueError, match="implementation"):
        t_decode(q, kc, kc, torch.tensor([4]), implementation="mosaic")
    with pytest.raises(ValueError, match="int8_compute"):
        t_decode(q, kc, kc, torch.tensor([4]), int8_compute=True)
    with pytest.raises(ValueError, match="int8_compute"):
        t_decode(targs[0], targs[1], targs[2], targs[3], k_scales=tw["k_scales"],
                 v_scales=tw["v_scales"], int8_compute=True)
