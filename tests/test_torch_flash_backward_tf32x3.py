"""The numeric plan of K5's and K6's f32 kernels at head dims 32, 64 and 128
(``csrc/flash_bwd_f32.cu``) and at 256 and above
(``csrc/flash_bwd_f32_wide.cu``), checked on the CPU before the card runs
it.

Those kernels take every product of the f32 backward as three TF32 passes
(``kernels/flash_attention._tf32x3_matmul``: each operand's TF32 head, x
rounded to its top 19 bits, plus its rest, x less the head, whose low 13
bits the tensor cores drop; rest x head and head x rest, then head x head).
``flash_bwd_tf32x3_reference`` is the plain backward with that product. The
same inputs, made with numpy from a seed, go through it and through JAX's
f32 ``flash_attention_n_fused`` backward (its Pallas kernels in interpret
mode, as the JAX package's tests run them), at the card kernels' tile edges
(K5's 64-row query tiles and 32- or 64-key tiles, K6's 64-key tiles and 16-
or 32-row query tiles: L and S ending mid-tile, L > S with dead rows at n =
0, non-causal) and under a bias, ALiBi and dropout. At D >= 256 the
emulation sums every product as those kernels do, in chunks of 32 of the
contraction (columns of D, keys or query rows) added in f32
(``chunk=32``). Tolerances are the
smoke's f32 ones (``chip_smoke.check_attention``): each gradient within
1e-4 of max(1, max |jax|) element-wise and within 1e-5 of max(1, ||jax||)
as a whole. One TF32 pass (the heads' product alone) misses them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.kernels.flash_attention import (
    flash_attention_n_fused as j_fused,
)
from flash_attention_softmax_n_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(2)
ELEM_TOL = 1e-4
NORM_TOL = 1e-5
NAMES = ("dq", "dk", "dv", "dbias", "dslopes")


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32) for s in shapes)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, D, L, S, *, n, causal, H=2, bias=False, alibi=False, rate=0.0):
    """(JAX's gradients, the kwargs and inputs of the plain backward at
    JAX's own o and lse)"""
    q, k, v, do, b = _arrays(seed, (1, H, L, D), (1, H, S, D), (1, H, S, D), (1, H, L, D),
                             (1, H, L, S))
    b = 0.5 * b
    slopes = np.asarray([2.0 ** -(i + 1) for i in range(H)], np.float32)
    extra = {}
    if bias:
        extra["bias"] = b
    if alibi:
        extra["alibi_slopes"] = slopes
    kw = dict(softmax_n_param=n, is_causal=causal, dropout_rate=rate,
              dropout_seed=23 if rate else None)
    names = list(extra)

    def j_fn(q, k, v, *xs):
        return j_fused(q, k, v, **dict(zip(names, xs)), **kw)

    args = [jnp.asarray(a) for a in (q, k, v, *extra.values())]
    _, vjp = jax.vjp(j_fn, *args)
    grads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    want = dict(zip(("dq", "dk", "dv"), grads[:3]))
    for name, g in zip(names, grads[3:]):
        want["dbias" if name == "bias" else "dslopes"] = g
    o, lse = j_fused(*args[:3], **dict(zip(names, args[3:])), **kw, return_residuals=True)
    seed_t = torch.tensor([23], dtype=torch.int32) if rate else None
    inputs = (_t(q), _t(k), _t(v), _t(b) if bias else None, _t(slopes) if alibi else None,
              seed_t, _t(o), _t(lse), _t(do))
    bkw = dict(scale=D ** -0.5, is_causal=causal, dropout_rate=rate)
    return want, inputs, bkw


def _errors(got, want):
    """{gradient: (element-wise error over max(1, max |jax|), norm error
    over max(1, ||jax||))}"""
    out = {}
    for name, g in zip(NAMES, got):
        if name not in want:
            continue
        w = want[name].astype(np.float64)
        diff = g.double().numpy() - w
        out[name] = (float(np.abs(diff).max()) / max(1.0, float(np.abs(w).max())),
                     float(np.linalg.norm(diff)) / max(1.0, float(np.linalg.norm(w))))
    return out


def _assert_within(errs):
    for name, (elem, norm) in errs.items():
        assert elem <= ELEM_TOL and norm <= NORM_TOL, (name, elem, norm)


CASES = [(72, 100, True, 1.0), (65, 65, False, 0.0), (70, 30, True, 0.0), (33, 130, True, 1.0)]
# the head dims of the kernels at D <= 128 and, above, of the wide kernels
# (256, and the multiples of 128 the wrappers pad to: 640 takes K5's and
# K6's column groups)
HEAD_DIMS = [32, 64, 128, 256, 384, 512, 640]


def _chunk(D):
    """the emulation's product at D: the wide kernels' 32-chunk sums above
    128"""
    return 32 if D >= 256 else None


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=["L72-S100-causal-n1", "L65-S65-full-n0",
                                             "L70-S30-causal-n0", "L33-S130-causal-n1"])
def test_tf32x3_grads_match_jax(D, case):
    L, S, causal, n = case
    want, inputs, bkw = _case(30 + D, D, L, S, n=n, causal=causal)
    got = fa.flash_bwd_tf32x3_reference(*inputs, **bkw, chunk=_chunk(D))
    _assert_within(_errors(got, want))
    if n == 0 and L > S:
        dead = np.arange(L) + (S - L) < 0
        assert bool((got[0][:, :, dead] == 0).all())


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_tf32x3_bias_alibi_dropout_grads_match_jax(D):
    # every modifier at once: a (1, H) bias (dbias), ALiBi (dslopes) and
    # dropout (the hash at each (b, h, q, k)), causal with L < S
    want, inputs, bkw = _case(40 + D, D, 48, 80, n=1.0, causal=True, bias=True, alibi=True,
                              rate=0.2)
    got = fa.flash_bwd_tf32x3_reference(*inputs, **bkw, chunk=_chunk(D))
    errs = _errors(got, want)
    assert set(errs) == set(NAMES)
    _assert_within(errs)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_one_tf32_pass_misses_the_f32_tolerance(D):
    # the heads' product alone keeps about 10 mantissa bits: its gradients
    # leave 1e-5 of the norm (and 1e-4 element-wise) far behind, where the
    # three passes stay inside
    want, inputs, bkw = _case(50 + D, D, 72, 100, n=1.0, causal=True, bias=True, alibi=True)
    chunk = _chunk(D)
    three = _errors(fa.flash_bwd_tf32x3_reference(*inputs, **bkw, chunk=chunk), want)
    one = _errors(fa.flash_bwd_tf32x3_reference(*inputs, **bkw, passes=1, chunk=chunk), want)
    _assert_within(three)
    assert all(one[name][1] > 10 * NORM_TOL for name in ("dq", "dk", "dv")), one
    assert max(e for e, _ in one.values()) > ELEM_TOL, one


def test_tf32x3_chunked_products_match_jax_at_d512():
    # the wide kernels' sums (every product in 32-wide chunks of its
    # contraction, three passes each, the chunks added in f32) hold the
    # tolerance at D 512 as the unchunked products do, and move the
    # gradients by less than the split's own error
    want, inputs, bkw = _case(60, 512, 72, 100, n=1.0, causal=True, bias=True, alibi=True,
                              rate=0.2)
    chunked = fa.flash_bwd_tf32x3_reference(*inputs, **bkw, chunk=32)
    whole = fa.flash_bwd_tf32x3_reference(*inputs, **bkw)
    _assert_within(_errors(chunked, want))
    _assert_within(_errors(whole, want))
    for name, c, w in zip(NAMES, chunked, whole):
        assert not torch.equal(c, w), name
        assert float((c - w).norm()) <= NORM_TOL * max(1.0, float(w.norm())), name


def test_tf32x3_chunked_product_sums_chunks_in_order():
    # chunk c of a's columns (and of b's rows) alone, three passes, then f32
    # sums from the first chunk up; a ragged last chunk keeps its columns
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((6, 80), (80, 5)))
    parts = [fa._tf32x3_matmul(a[:, c:c + 32], b[c:c + 32]) for c in (0, 32, 64)]
    assert torch.equal(fa._tf32x3_matmul(a, b, chunk=32), (parts[0] + parts[1]) + parts[2])
    assert torch.equal(fa._tf32x3_matmul(a, b, chunk=80), fa._tf32x3_matmul(a, b))


def test_tf32_split_is_exact():
    # head + rest is x bit for bit over signs, binades and subnormals; the
    # head keeps 10 mantissa bits, rounded to nearest, so for a normal x the
    # rest is at most 2^-11 of |x|; truncation (the tensor cores' reading)
    # leaves up to 2^-10
    rng = np.random.RandomState(3)
    x = (rng.randn(4096) * np.exp2(rng.randint(-140, 120, 4096))).astype(np.float32)
    x = torch.from_numpy(np.concatenate([x, [0.0, -0.0, 1.0, 3.0e38, 1e-45]]).astype(np.float32))
    x = x[x.abs() < 3.0e38]  # rounding up the largest binade's top would pass FLT_MAX
    normal = x.abs() >= 2.0 ** -126
    for split, bound in ((fa._tf32_head, 2.0 ** -11), (fa._tf32, 2.0 ** -10)):
        head = split(x)
        rest = x - head
        assert torch.equal(head + rest, x)
        assert bool(((head.view(torch.int32) & 0x1FFF) == 0).all())
        assert bool((rest.abs() <= x.abs() * bound)[normal].all())
    a, b = (torch.from_numpy(rng.randn(*s)) for s in ((64, 96), (96, 48)))
    exact = a @ b
    three = fa._tf32x3_matmul(a.float(), b.float()).double()
    one = fa._tf32x3_matmul(a.float(), b.float(), passes=1).double()
    scale = (a.abs() @ b.abs()).max()
    assert float((three - exact).abs().max() / scale) < 2.0 ** -19
    assert float((one - exact).abs().max() / scale) > 2.0 ** -14


def test_tf32x3_reference_takes_f32_only():
    q = torch.zeros((1, 1, 8, 32), dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError, match="f32"):
        fa.flash_bwd_tf32x3_reference(q, q, q, None, None, None, q, lse, q, scale=1.0,
                                      is_causal=True)
