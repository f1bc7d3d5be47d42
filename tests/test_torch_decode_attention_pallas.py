"""Port parity: ``decode_attention_n(implementation="pallas")`` (the plain
version of kernel K8 on the CPU) against the JAX package's Pallas route in
interpret mode.

Caches: dense f32 and bf16, int8 with scales, and int8 with
``int8_compute``; GQA groups of 1 and 4; lengths 0, 1, a full cache and a
non-multiple of the 256-position tile (S = 300 makes two tiles); with and
without the tail window and the current token's self-term; n = 0 and 1.
Both sides walk the same tiles with a running maximum and round at the
same places, so f32 outputs are held within 1e-5 and bf16 ones within
2e-2 (one bf16 ulp of the output for |out| < 2). Head dims above 128 (200,
which JAX pads to 256, and Gemma-2B's 256) over f32 and int8 caches, and
512 under ``int8_compute``; K8's split planner at head dims up to 1024.
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
from flash_attention_softmax_n_tpu_torch.kernels import decode_attention as tda

torch.set_num_threads(2)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16))


def _inputs(rng, cache, group, extras, hd=32):
    b, kvh, s, w = 4, 2, 300, 8
    q = rng.randn(b, kvh * group, hd).astype(np.float32)
    kc = rng.randn(b, kvh, s, hd).astype(np.float32)
    vc = rng.randn(b, kvh, s, hd).astype(np.float32)
    kw = {}
    if cache in ("int8", "int8_compute"):
        (kc, ks), (vc, vs) = ((np.asarray(a) for a in quantize_kv(jnp.asarray(c), 8))
                              for c in (kc, vc))
        kw.update(k_scales=ks, v_scales=vs)
    elif cache == "bf16":
        q, kc, vc = _bf16(q), _bf16(kc), _bf16(vc)
    if extras:
        kw.update(k_new=rng.randn(b, kvh, hd).astype(np.float32),
                  v_new=rng.randn(b, kvh, hd).astype(np.float32),
                  k_tail=_bf16(rng.randn(b, kvh, w, hd)),
                  v_tail=_bf16(rng.randn(b, kvh, w, hd)),
                  tail_lengths=np.array([3, 0, 8, 1], np.int32))
    lengths = np.array([0, 1, 300, 257], np.int32)
    return q, kc, vc, lengths, kw


@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "int8_compute"])
@pytest.mark.parametrize("group", [1, 4])
def test_decode_attention_matches_jax_pallas(group, cache, extras, n):
    rng = np.random.RandomState(group + 10 * len(cache))
    q, kc, vc, lengths, kw = _inputs(rng, cache, group, extras)
    int8c = cache == "int8_compute"
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), softmax_n_param=n,
                    int8_compute=int8c, implementation="pallas",
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tda.decode_attention_n(_t(q), _t(kc), _t(vc), _t(lengths),
                                 softmax_n_param=n, int8_compute=int8c,
                                 **{k: _t(v) for k, v in kw.items()})
    assert got.dtype == (torch.bfloat16 if cache == "bf16" else torch.float32)
    tol = 2e-2 if cache == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


def test_stats_of_empty_slot_and_strided_cache():
    # (acc 0, m NEG_INF, l 0) for length 0; a cache view that slices S and
    # takes one layer (the fused loop's window) gives the same statistics
    # as a contiguous copy
    rng = np.random.RandomState(3)
    full = torch.from_numpy(rng.randn(2, 3, 2, 40, 16).astype(np.float32))
    view = full[1, :, :, :24]
    q = torch.from_numpy(rng.randn(3, 2, 2, 16).astype(np.float32))
    lengths = torch.tensor([0, 24, 5])
    got = tda.decode_attn_stats_reference(q, None, view, view, lengths, None, None)
    want = tda.decode_attn_stats_reference(q, None, view.contiguous(),
                                           view.contiguous(), lengths, None, None)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    acc, m, l = got
    assert torch.equal(acc[0], torch.zeros_like(acc[0]))
    assert bool((m[0] == tda.NEG_INF).all()) and bool((l[0] == 0).all())


def test_pallas_route_differs_from_xla_only_in_q_rounding():
    # an f32 model over an int8 cache: the "pallas" route keeps q in f32,
    # the "xla" route rounds it to bf16 (JAX's two routes differ the same way)
    rng = np.random.RandomState(4)
    q, kc, vc, lengths, kw = _inputs(rng, "int8", 4, False)
    args = (_t(q), _t(kc), _t(vc), _t(lengths))
    kws = {k: _t(v) for k, v in kw.items()}
    pallas = tda.decode_attention_n(*args, **kws)
    q_bf16 = _t(q).to(torch.bfloat16).float()
    pallas_bf16_q = tda.decode_attention_n(q_bf16, *args[1:], **kws)
    xla = tda.decode_attention_n(*args, implementation="xla", **kws)
    assert not torch.equal(pallas, xla)
    torch.testing.assert_close(pallas_bf16_q, xla, atol=2e-2, rtol=0)


# head dims above 128: JAX pads hd to a multiple of 128 for its kernel,
# K8's plain version (and K8) take it as it is
@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("hd", [200, 256])
def test_decode_attention_wide_head_dims_match_jax_pallas(hd, cache, extras):
    rng = np.random.RandomState(hd + len(cache))
    q, kc, vc, lengths, kw = _inputs(rng, cache, 4, extras, hd=hd)
    q = q * hd ** -0.25  # keep the scores' spread that of hd 32
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), softmax_n_param=1.0, implementation="pallas",
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tda.decode_attention_n(_t(q), _t(kc), _t(vc), _t(lengths), softmax_n_param=1.0,
                                 **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# int8 compute at hd 512, where the 256-position tile's k and v rows no
# longer fit a block and K8 brings them in sub-tiles: the same function
# (p requantized per row over each 256-position tile, integer products)
@pytest.mark.parametrize("extras", [False, True])
def test_decode_attention_int8_compute_wide_head_dim_matches_jax_pallas(extras):
    hd = 512
    rng = np.random.RandomState(hd + 7)
    q, kc, vc, lengths, kw = _inputs(rng, "int8_compute", 4, extras, hd=hd)
    q = q * hd ** -0.25  # keep the scores' spread that of hd 32
    want = j_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(lengths), softmax_n_param=1.0, int8_compute=True,
                    implementation="pallas", **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tda.decode_attention_n(_t(q), _t(kc), _t(vc), _t(lengths), softmax_n_param=1.0,
                                 int8_compute=True, **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# K8's split planner at wide head dims: a split whose k and v rows fit the
# 48 KB where one of SPLITS does, else the 16-position WIDE_SPLIT; none raises
@pytest.mark.parametrize("hd", [256, 512, 1024])
@pytest.mark.parametrize("elem", [1, 2, 4])
def test_decode_attn_plan_fits_wide_head_dims(hd, elem):
    row = -(-hd * elem // 16) * 16 + 16
    for b, kvh, s in ((8, 1, 512), (64, 4, 512), (1, 1, 64)):
        split = tda.decode_attn_plan(b, kvh, s, hd, elem, False)
        if split in tda.SPLITS:
            assert 2 * split * row <= 48 * 1024
        else:
            assert split == tda.WIDE_SPLIT == 16
            assert all(2 * sp * row > 48 * 1024 for sp in tda.SPLITS)
    assert tda.decode_attn_plan(8, 1, 512, 256, 1, False) == 32  # Gemma-2B's decode, int8


# K8's split planner (kernels/decode_attention.decode_attn_plan): the
# serving shapes' split lengths, int8 compute's fixed tile, and the shared
# memory cap
@pytest.mark.parametrize("case", [(8, 4, 256, 64, 1, 32), (2, 4, 512, 64, 1, 32),
                                  (64, 4, 512, 64, 1, 256), (64, 4, 256, 64, 1, 256),
                                  (64, 4, 512, 64, 2, 128), (5, 2, 600, 64, 2, 32),
                                  (16, 4, 512, 64, 1, 128)],
                         ids=lambda c: "-".join(map(str, c)))
def test_decode_attn_plan_fills_the_card_with_the_longest_split(case):
    b, kvh, s, hd, elem, want = case
    split = tda.decode_attn_plan(b, kvh, s, hd, elem, False)
    assert split == want
    ctas = b * kvh * -(-s // split)
    assert ctas >= 132 or split == min(tda.SPLITS)
    # no longer split would have put a CTA on each SM within 48 KB of rows
    row = -(-hd * elem // 16) * 16 + 16
    for longer in tda.SPLITS:
        if longer > split:
            assert b * kvh * -(-s // longer) < 132 or 2 * longer * row > 48 * 1024


def test_decode_attn_plan_int8_compute_keeps_the_pallas_tile():
    for b, s in ((2, 512), (8, 256), (64, 512), (1, 64)):
        assert tda.decode_attn_plan(b, 4, s, 64, 1, True) == tda.TILE == 256


def test_decode_attn_plan_caps_the_split_by_shared_memory():
    # f32 rows at hd 128: 528 padded bytes, so 32 positions of k and v
    # (33 KB) are the most within 48 KB; bf16 at hd 64 (144 bytes): 128
    assert tda.decode_attn_plan(256, 8, 4096, 128, 4, False) == 32
    assert tda.decode_attn_plan(64, 4, 512, 64, 2, False) == 128
    for split in tda.SPLITS:
        for hd in (32, 64, 128):
            for elem in (1, 2, 4):
                got = tda.decode_attn_plan(1, 1, split, hd, elem, False)
                assert 2 * got * (-(-hd * elem // 16) * 16 + 16) <= 48 * 1024


# K8's product design (kernels/decode_attention.decode_attn_products): the
# tensor cores where bf16 operands are exact and hd fills 16-wide steps,
# f32 FMAs elsewhere
@pytest.mark.parametrize("case", [
    (torch.bfloat16, torch.int8, 64, tda.MMA),
    (torch.bfloat16, torch.float8_e4m3fn, 64, tda.MMA),
    (torch.bfloat16, torch.bfloat16, 128, tda.MMA),
    (torch.bfloat16, torch.bfloat16, 32, tda.MMA),
    (torch.bfloat16, torch.float32, 64, tda.FMA),  # f32 cache: f32 PV
    (torch.float32, torch.bfloat16, 64, tda.FMA),  # f32 q: f32 products
    (torch.int8, torch.int8, 64, tda.FMA),  # int8 compute: exact integer sums
    (torch.bfloat16, torch.int8, 40, tda.FMA),  # hd not a multiple of 16
], ids=lambda c: str(c))
def test_decode_attn_products_plan(case):
    q_dtype, kv_dtype, hd, want = case
    assert tda.decode_attn_products(q_dtype, kv_dtype, hd) == want
