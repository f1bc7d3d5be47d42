"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test skips (decided in the fixture,
not at import). On the machine with the card run

    python -m pytest tests/test_torch_cuda_kernels.py -q

These cover what the serving and training shapes in ``chip_smoke.py`` do
not: n = 0 and fractional n, rectangular causal with L < S and L > S (dead
rows), f32 inputs, head dims 32/64/128/256/384/512 and, padded,
16/20/80/96/160/288, ragged tiles, dense caches, and for
the backward (K5, K6) bias, ALiBi and dropout in every combination; for
K7-K9 every mode (int8, W8A8, int4, W4A8; dense, int8, int8-compute and
fp8 caches), ragged M/N/F, slot lengths 0 and full, strided cache views;
K2 at every row tile, ties met at each stage of its reduction, NaN and -inf rows, views off 16 bytes;
K3 and K4 at both vector widths (16-byte vectors; 4-byte words for 12-byte
rows and views off 16 bytes), the engine's four-tensor call with int8 or
fp8 values, positions at 0, S - 1 and outside the cache (skipped), row
counts that fill no block, and strided or f32 new rows (cast and copied as
the plain versions take them);
K10 in its four modes at head dims 32/64/128 and, padded or on its scalar
kernels, 80/256/320, bf16 and f32, ragged L; K8 at hd 160, 256, 512, 520
and 1152 (int8 compute too). The
bf16 K1, K5, K6 and K10 run the TMA + wgmma tile (128-row tiles; K1, K5
and K6 at D 256, and K5 and K6 above it, on kernels of their own with a
producer warpgroup, which the d256 and wide cases check ran, through
torch.profiler): L and S
ending mid-tile, every bias broadcast, ALiBi, dropout (K5's and K6's masks
bit-equal to the hash), a ring block against an external lse, and
misaligned inputs that must raise; f32 K1, K5 and K6 run their
split-TF32 kernels at every D (32-128 and, wide, 256 and above), held the
same way and also against the plain emulation of their split (which the
profiler checks ran), the wide ones also repeated bit-equal inside NaN
guards. The engine's CUDA graphs: each greedy
loop variant (plain, piggybacked, under 8 steps) replays bit-equal to the
eager loop on the default, all-kernel and fp8 routes, launch counts
included, and ``prewarm`` leaves the engine's state bit-equal. Chunked
prefill and the prefix cache: K1 at a chunk's rectangular shape with the
engine's offset mask (f32 and bf16, n 0 and 1, repeats bit-equal), a
prefix store bit-equal to a cold 1-slot chunked prefill of the same tokens,
and prefix hits in a prewarmed engine (tokens of an engine that captures
nothing; the loop variants then replay bit-equal over the inserted rows).
Surgery and analysis: K7's f32 mode with int4 weights at BERT-base's
matmul shapes, an int4 BERT (six K7 launches a layer) within 1e-3 of its
dequantized tree, and the decoder's taps on the card within bf16 tolerance
of the CPU's (``output_attentions`` launches no K1). Multi-device
training: the ring's per-rank schedule at p = 4 (K1 at n = 0 with its lse
per visiting block, K5/K6 against the global lse, GQA K/V unrepeated)
against single-device K1 and K5/K6, bf16 and f32, and
``flash_attention_n(mesh=)``'s dropout on each (batch, head) slab of a
{"data": 2, "model": 4} mesh bit-equal to the unmeshed kernel's (a stand-in
mesh gives each slab its coordinates; no process group is needed). The 7B
geometry: Llama-7B's serving shapes (head dim 128, 32 heads over 32 KV
heads: G = 1) and Llama-3-8B's where its kernels differ (G = 4, d_ff 14336,
vocab 128256): K1 over an admission group under the engine's mask, K8 as
planned over bf16, int8 and fp8 caches, K2 at K4096, K7 with int8 and int4
weights at the projections' and MLP's shapes, K9 at d_ff 11008 and 14336,
K3 and K4 at KVH32 D128, each bit-equal on repeat; ``bench_7b.bench_decode``
replays its windows through the engine's capture helpers.
Tolerances: forward f32 within 2e-5 (summation order), bf16 within 2e-2 (p
rounded to bf16 before PV, as in the plain version), lse within 1e-4;
gradients within 1e-4 (f32) or 2e-2 (bf16: ds rounds to bf16 on either side
of a tie) of the plain version's largest magnitude; dropout masks and
repeated calls bit-equal; cache writes bit-exact. K7: f32 within 1e-5 of
max |out|, bf16 within one bf16 ulp; W8A8 bit-exact (integer sums, the same
f32 epilogue). K9: f32 within 1e-5, bf16 within 2e-2 of max |out|. K8:
outputs within 1e-5 (f32 cache) or 2e-2 (p rounded to bf16 or requantized
to int8 against a split's own maximum where the plain version uses the
running one). K10: f32 within 1e-5 of max(1, max |o|); bf16 within
``mini_tolerance``, one bf16 ulp of |o| plus one p of each row rounded to
bf16 the other way (p is rounded from values that may differ in their
last bits).
"""

import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build
from flash_attention_softmax_n_tpu_torch.kernels import cache_update as cu
from flash_attention_softmax_n_tpu_torch.kernels import decode_attention as da
from flash_attention_softmax_n_tpu_torch.kernels import flash_attention as fa
from flash_attention_softmax_n_tpu_torch.kernels import fused_mlp as fm
from flash_attention_softmax_n_tpu_torch.kernels import prefill_phases as pp
from flash_attention_softmax_n_tpu_torch.kernels import quant_matmul as qm
from flash_attention_softmax_n_tpu_torch.quant import qtensor as qt

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(200, 200, False), (150, 150, True),
                                   (100, 164, True), (96, 40, True)])
def test_flash_fwd_matches_plain(gen, dtype, d, n, shape):
    L, S, causal = shape
    q, k, v = (torch.randn((2, 3, m, d), generator=gen, device="cuda").to(dtype)
               for m in (L, S, S))
    before = _build.LAUNCHES["flash_fwd"]
    o, lse = fa.flash_fwd(q, k, v, None, n=n, scale=d ** -0.5, is_causal=causal)
    assert _build.LAUNCHES["flash_fwd"] == before + 1
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, None, n=n, scale=d ** -0.5,
                                            is_causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("bias_shape", [(2, 1), (1, 3), (2, 3)])
def test_flash_fwd_bias_broadcast(gen, bias_shape):
    q, k, v = (torch.randn((2, 3, 70, 64), generator=gen, device="cuda")
               for _ in range(3))
    bias = torch.randn((*bias_shape, 70, 70), generator=gen, device="cuda")
    bias[..., 5:9] = -torch.finfo(torch.float32).max / 2
    o, lse = fa.flash_fwd(q, k, v, bias, n=1.0, scale=0.125, is_causal=True)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, n=1.0, scale=0.125,
                                            is_causal=True)
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-6)


# K2 at every row tile (M 1-64: 64 rows and 256 vocab columns a tile; 100:
# 128 rows; 256: 256; 300: two 256-row tiles) at the lm_head's K2048
# N32000, and N that TMA cannot take (97, 1000: the predicated producer);
# f32 x takes K7's f32 tiles (64 rows below M = 128, else 128: M300 three
# row tiles) with the argmax epilogue, cp.async where N % 16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", [(1, 64, 97), (13, 200, 1000), (1, 2048, 32000),
                                 (13, 2048, 32000), (64, 2048, 32000), (100, 2048, 32000),
                                 (256, 2048, 32000), (300, 2048, 32000)],
                         ids=lambda c: "-".join(map(str, c)))
def test_qmm_argmax_matches_plain(gen, dtype, mkn):
    m, k, n = mkn
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    s = torch.rand((n,), generator=gen, device="cuda") + 0.5
    x[-1, 3] = float("nan")  # a row whose logits are all NaN: index 0 wins
    if m > 1:  # a row whose logits are all -inf: index 0 wins
        x[0, 0] = float("-inf")
        w[0] = torch.randint(1, 128, (n,), generator=gen, device="cuda").to(torch.int8)
    plan = qm.qmm_argmax_plan(m, k, n, dtype)
    assert plan.kernel == ("wgmma" if dtype == torch.bfloat16 else "simt")
    before = _build.LAUNCHES["qmm_argmax"]
    idx, val = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    assert _build.LAUNCHES["qmm_argmax"] == before + 1
    again = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    # bit-equal, the NaN row's value too
    assert torch.equal(idx, again[0]) and torch.equal(val.view(torch.int32),
                                                      again[1].view(torch.int32))
    idx_ref, val_ref = qm.quantized_matmul_argmax_reference(x, w, s)
    top2 = torch.topk((x.float() @ w.float()) * s, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0].abs()
    assert torch.equal(idx[decided], idx_ref[decided]), plan
    assert idx[-1].item() == idx_ref[-1].item() == 0 and val[-1].isnan()
    if m > 1:
        assert idx[0].item() == idx_ref[0].item() == 0 and val[0].item() == float("-inf")
    torch.testing.assert_close(val, val_ref, atol=0, rtol=1e-5, equal_nan=True)


# Ties, each between columns that meet at one stage of K2's reduction: one
# thread's pair, two lanes of a warp, two warps, two warpgroups (and at 256
# columns the two W boxes), two tiles of one CTA's walk (the plan's CTA
# count apart, in row tile 0: N128256 has 501 tiles of 256 at M <= 64), two
# CTAs; a lone winner at column N - 1 (N 272: the second W box lies past N
# and is not loaded; N 97, 1000: the predicated producer); and a three-way
# tie across tiles with the first index not listed first, at N300 with one
# K stage (K64), where the second W box also lies past N. (M, K, N, columns)
_ARGMAX_TIES = [
    (3, 256, 32000, [3, 2]), (3, 256, 32000, [9, 4]), (3, 256, 32000, [20, 5]),
    (3, 256, 32000, [70, 10]), (3, 256, 32000, [200, 130, 60]),
    (3, 256, 128256, [132 * 256 + 5, 5]), (100, 256, 32000, [132 * 128 + 5, 5]),
    (300, 256, 32000, [66 * 128 + 5, 5]), (3, 256, 32000, [20000, 900]),
    (300, 256, 32000, [20000, 900]), (3, 256, 32000, [31999]), (100, 256, 32000, [31999]),
    (300, 256, 32000, [31999]), (3, 256, 272, [271]), (3, 256, 272, [271, 270]),
    (3, 256, 97, [96]), (13, 256, 1000, [999]), (13, 256, 1000, [300, 130]),
    (3, 64, 300, [70, 5, 260]),
]


@pytest.mark.parametrize("case", _ARGMAX_TIES, ids=lambda c: "-".join(map(str, c)))
def test_qmm_argmax_first_index_wins_ties(gen, case):
    m, k, n, cols = case
    x = torch.ones((m, k), device="cuda", dtype=torch.bfloat16)
    w = torch.zeros((k, n), device="cuda", dtype=torch.int8)
    w[:, cols] = 1
    s = torch.ones(n, device="cuda")
    idx, val = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    assert idx.tolist() == [min(cols)] * m, qm.qmm_argmax_plan(m, k, n)
    assert val.tolist() == [float(k)] * m


# K2's f32 kernel at a K that is no multiple of 4 (x's rows off 16 bytes:
# the cp.async loader) and at two and three 128-row tiles, with the NaN and
# -inf rows of test_qmm_argmax_matches_plain
@pytest.mark.parametrize("mkn", [(13, 203, 1000), (70, 130, 4001), (200, 2048, 32000),
                                 (300, 203, 32000)], ids=lambda c: "-".join(map(str, c)))
def test_qmm_argmax_f32_loaders_and_row_tiles(gen, mkn):
    m, k, n = mkn
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    s = torch.rand((n,), generator=gen, device="cuda") + 0.5
    x[-1, 3] = float("nan")
    x[0, 0] = float("-inf")
    w[0] = torch.randint(1, 128, (n,), generator=gen, device="cuda").to(torch.int8)
    plan = qm.qmm_argmax_plan(m, k, n, torch.float32)
    assert plan.kernel == "simt" and plan.bm == (64 if m < 128 else 128)
    assert plan.producer == ("tma" if k % 4 == 0 and n % 16 == 0 else "cp.async")
    idx, val = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    again = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    assert torch.equal(idx, again[0]) and torch.equal(val.view(torch.int32),
                                                      again[1].view(torch.int32))
    idx_ref, val_ref = qm.quantized_matmul_argmax_reference(x, w, s)
    top2 = torch.topk((x.float() @ w.float()) * s, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-4 * top2[:, 0].abs()
    assert torch.equal(idx[decided], idx_ref[decided]), plan
    assert idx[-1].item() == idx_ref[-1].item() == 0 and val[-1].isnan()
    assert idx[0].item() == idx_ref[0].item() == 0 and val[0].item() == float("-inf")
    torch.testing.assert_close(val, val_ref, atol=0, rtol=1e-5, equal_nan=True)


# K2's f32 kernel at the ties of _ARGMAX_TIES: in one thread, between the
# threads of a row, between tiles (CTAs, met in the merge), and a lone
# winner at column N - 1
@pytest.mark.parametrize("case", _ARGMAX_TIES, ids=lambda c: "-".join(map(str, c)))
def test_qmm_argmax_f32_first_index_wins_ties(gen, case):
    m, k, n, cols = case
    x = torch.ones((m, k), device="cuda")
    w = torch.zeros((k, n), device="cuda", dtype=torch.int8)
    w[:, cols] = 1
    s = torch.ones(n, device="cuda")
    idx, val = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    assert idx.tolist() == [min(cols)] * m, qm.qmm_argmax_plan(m, k, n, torch.float32)
    assert val.tolist() == [float(k)] * m


def test_qmm_argmax_view_off_16_bytes(gen):
    # a contiguous view that starts 2 bytes past a 16-byte boundary (TMA's)
    m, k, n = 5, 512, 4096
    buf = torch.randn(m * k + 1, generator=gen, device="cuda").to(torch.bfloat16)
    x = buf[1:].view(m, k)
    assert x.data_ptr() % 16 != 0
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    s = torch.rand((n,), generator=gen, device="cuda") + 0.5
    assert qm.qmm_argmax_plan(m, k, n).producer == "tma"
    idx, val = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    idx2, val2 = qm.quantized_matmul_argmax(x.clone(), w, s, return_max=True)
    assert torch.equal(idx, idx2) and torch.equal(val, val2)
    idx_ref, val_ref = qm.quantized_matmul_argmax_reference(x, w, s)
    torch.testing.assert_close(val, val_ref, atol=0, rtol=1e-5)


def test_qmm_argmax_bad_plans_raise(gen):
    m, k, n = 64, 256, 1024
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    s = torch.ones(n, device="cuda")
    plan = qm.qmm_argmax_plan(m, k, n)
    with pytest.raises(ValueError, match="no kernel"):  # a row tile no kernel is built for
        qm._qmm_argmax_cuda(x, w, s, plan._replace(bm=96))
    with pytest.raises(ValueError, match="CTAs"):  # more CTAs than tiles
        qm._qmm_argmax_cuda(x, w, s, plan._replace(ctas=plan.ctas + 1, slots=plan.ctas + 1))
    with pytest.raises(ValueError, match="one CTA a tile"):  # f32 x under the bf16 plan
        qm._qmm_argmax_cuda(x.float(), w, s, plan)
    plan32 = qm.qmm_argmax_plan(m, k, n, torch.float32)
    qm._qmm_argmax_cuda(x.float(), w, s, plan32)
    with pytest.raises(ValueError, match="no f32 kernel"):  # f32 tiles are 64 or 128 rows
        qm._qmm_argmax_cuda(x.float(), w, s, plan32._replace(bm=256, ctas=4))
    with pytest.raises(ValueError, match="TMA needs"):  # x's f32 rows off 16 bytes
        qm._qmm_argmax_cuda(x[:, :253].float(), w[:253], s, plan32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cache_append_dense_bit_exact(gen, dtype):
    caches = tuple(torch.randn((3, 5, 2, 33, 64), generator=gen, device="cuda")
                   .to(dtype) for _ in range(2))
    news = tuple(torch.randn((3, 5, 2, 64), generator=gen, device="cuda").to(dtype)
                 for _ in range(2))
    pos = torch.tensor([0, 32, 7, 7, 19], device="cuda", dtype=torch.int32)
    got = tuple(c.clone() for c in caches)
    want = tuple(c.clone() for c in caches)
    cu.cache_append(got, news, pos)
    cu.cache_append_reference(want, news, pos)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tail_append_every_index(gen):
    kt, vt = (torch.randn((2, 3, 4, 16, 64), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    want = (kt.clone(), vt.clone())
    for i in range(16):
        kn, vn = (torch.randn((2, 3, 4, 64), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        cu.tail_append(kt, vt, kn, vn, i)
        cu.tail_append_reference(*want, kn, vn, i)
    assert torch.equal(kt, want[0]) and torch.equal(vt, want[1])


def _at_offset(t, offset):
    """A contiguous copy of t whose first byte lies ``offset`` bytes past a
    16-byte boundary (the allocator's blocks start on one)."""
    nbytes = t.numel() * t.element_size()
    buf = torch.zeros(nbytes + 16, dtype=torch.uint8, device=t.device)
    out = buf[offset:offset + nbytes].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def _kv_rows(gen, shape, dtype):
    """random values of ``dtype`` (int8, fp8 e4m3, f32 scales, bf16, f32)"""
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=gen, device="cuda").to(dtype)
    if dtype == qt.FP8:
        return torch.randint(0, 256, shape, generator=gen,
                             device="cuda").to(torch.uint8).view(dtype)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _append_both(caches, news, pos):
    """(kernel's caches, plain version's caches), each from copies of
    ``caches``, after one cache_append; slots whose position lies outside
    [0, S) are left out of the plain version's call, as the kernel skips them"""
    got = tuple(c.clone() for c in caches)
    want = tuple(c.clone() for c in caches)
    cu.cache_append(got, news, pos)
    S = caches[0].shape[3]
    for b, p in enumerate(pos.tolist()):
        if 0 <= p < S:
            cu.cache_append_reference(tuple(c[:, b:b + 1] for c in want),
                                      tuple(nw[:, b:b + 1] for nw in news), pos[b:b + 1])
    return got, want


def _bytes_equal(a, b):
    return torch.equal(qt.as_bytes(a), qt.as_bytes(b))


# K3's and K4's two vector widths: 16-byte vectors where the row bytes are a
# multiple of 16 and both base pointers 16-byte aligned, 4-byte words
# otherwise: rows of 12 bytes, and caches or new rows offset by 4 bytes
# (not by 16), which must take the word path and not raise
# (dtype, D, cache offset, new rows' offset, vector bytes)
_WIDTH_CASES = [(torch.bfloat16, 64, 0, 0, 16), (torch.int8, 64, 0, 0, 16),
                (torch.float32, 3, 0, 0, 4), (torch.bfloat16, 6, 0, 0, 4),
                (torch.int8, 64, 4, 0, 4), (torch.bfloat16, 64, 0, 4, 4),
                (torch.float32, 4, 4, 4, 4), (torch.bfloat16, 64, 8, 0, 4)]


@pytest.mark.parametrize("case", _WIDTH_CASES)
def test_cache_append_vector_widths(gen, case):
    dtype, d, c_off, n_off, vec = case
    caches = tuple(_at_offset(_kv_rows(gen, (2, 5, 3, 17, d), dtype), c_off)
                   for _ in range(2))
    news = tuple(_at_offset(_kv_rows(gen, (2, 5, 3, d), dtype), n_off) for _ in range(2))
    assert [_build.ops().cache_vector_bytes(c, nw) for c, nw in zip(caches, news)] == [vec] * 2
    pos = torch.tensor([0, 16, 3, 3, 9], device="cuda", dtype=torch.int32)
    got = tuple(_at_offset(c, c_off) for c in caches)
    want = tuple(c.clone() for c in caches)
    cu.cache_append(got, news, pos)
    cu.cache_append_reference(want, news, pos)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", _WIDTH_CASES)
def test_tail_append_vector_widths(gen, case):
    dtype, d, c_off, n_off, vec = case
    kt, vt = (_at_offset(_kv_rows(gen, (2, 3, 4, 8, d), dtype), c_off) for _ in range(2))
    kn, vn = (_at_offset(_kv_rows(gen, (2, 3, 4, d), dtype), n_off) for _ in range(2))
    assert _build.ops().cache_vector_bytes(kt, kn) == vec
    want = (kt.clone(), vt.clone())
    for i in (0, 5, 7):
        cu.tail_append(kt, vt, kn, vn, i)
        cu.tail_append_reference(*want, kn, vn, i)
    assert torch.equal(kt, want[0]) and torch.equal(vt, want[1])


# the engine's four-tensor call: k and v values (int8 or fp8, 64-byte rows
# at D64, 16-byte vectors) with their f32 scale planes (4-byte rows, words)
# in one launch, at row counts (NL, B, KVH) that fill no block, one, and
# several of each tensor
@pytest.mark.parametrize("values", ["int8", "fp8"])
@pytest.mark.parametrize("rows", [(1, 1, 1), (1, 3, 1), (3, 5, 7), (22, 4, 4)])
def test_cache_append_engine_call(gen, values, rows):
    dtype = torch.int8 if values == "int8" else qt.FP8
    S, D = 40, 64
    caches, news = [], []
    for _ in range(2):
        caches += [_kv_rows(gen, (*rows, S, D), dtype),
                   _kv_rows(gen, (*rows, S, 1), torch.float32)]
        news += [_kv_rows(gen, (*rows, D), dtype), _kv_rows(gen, (*rows, 1), torch.float32)]
    assert [_build.ops().cache_vector_bytes(c, nw)
            for c, nw in zip(caches, news)] == [16, 4, 16, 4]
    pos = torch.randint(0, S, (rows[1],), generator=gen, device="cuda").to(torch.int32)
    got, want = _append_both(caches, news, pos)
    assert all(_bytes_equal(a, b) for a, b in zip(got, want))


# positions at 0 and S - 1 are written; those outside [0, S) (-1, S, far
# past it) are skipped and leave the cache as it was
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_cache_append_positions_at_the_edges(gen, dtype):
    S, D = 33, 64
    caches = (_kv_rows(gen, (3, 7, 2, S, D), dtype),
              _kv_rows(gen, (3, 7, 2, S, 1), torch.float32))
    news = (_kv_rows(gen, (3, 7, 2, D), dtype), _kv_rows(gen, (3, 7, 2, 1), torch.float32))
    pos = torch.tensor([0, S - 1, -1, S, 7, 1 << 20, S - 1], device="cuda",
                       dtype=torch.int32)
    got, want = _append_both(caches, news, pos)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for c, g in zip(caches, got):  # the skipped slots are untouched
        assert torch.equal(c[:, [2, 3, 5]], g[:, [2, 3, 5]])


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    # every head dim runs (zero-padded by the wrappers); dtypes and
    # alignment are still refused
    half = torch.randn((1, 1, 8, 64), device="cuda").half()
    with pytest.raises(ValueError, match="bf16 or f32"):
        fa.flash_fwd(half, half, half, None, n=1.0, scale=0.1, is_causal=False)
    # a contiguous cache that starts one byte past a word boundary
    cache = torch.zeros(2 * 3 * 4 * 64 + 1, dtype=torch.int8,
                        device="cuda")[1:].view(2, 3, 1, 4, 64)
    rows = torch.ones((2, 3, 1, 64), dtype=torch.int8, device="cuda")
    pos = torch.zeros(3, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="4-byte boundary"):
        cu.cache_append((cache,), (rows,), pos)
    with pytest.raises(ValueError, match="positions"):
        cu.cache_append((cache.clone(),), (rows,), pos[:2])


# new rows as the plain versions take them: a strided view (the (..., D)
# slice of wider rows) and f32 rows, cast to the cache's dtype; the result
# must be bit-exact against the plain version on the same rows
@pytest.mark.parametrize("target", ["int8_cache", "bf16_cache", "bf16_ring"])
@pytest.mark.parametrize("rows", ["strided", "f32"])
def test_row_writes_take_strided_and_f32_rows(gen, target, rows):
    dtype = torch.int8 if target == "int8_cache" else torch.bfloat16
    nl, b, kvh, s, d = 3, 5, 2, 17, 64

    def new_rows():
        t = _kv_rows(gen, (nl, b, kvh, 2 * d), dtype)
        if rows == "strided":
            t = t[..., :d]
            assert not t.is_contiguous()
        else:  # integer values in int8's range, exact in f32 and bf16
            t = t[..., :d].float().round().clamp(-128, 127).contiguous()
        return t

    news = (new_rows(), new_rows())
    if target == "bf16_ring":
        got = tuple(_kv_rows(gen, (nl, b, kvh, 8, d), dtype) for _ in range(2))
        want = tuple(t.clone() for t in got)
        cu.tail_append(*got, *news, 5)
        cu.tail_append_reference(*want, *news, 5)
    else:
        caches = tuple(_kv_rows(gen, (nl, b, kvh, s, d), dtype) for _ in range(2))
        pos = torch.tensor([0, 16, 3, 3, 9], device="cuda", dtype=torch.int32)
        got = tuple(c.clone() for c in caches)
        want = tuple(c.clone() for c in caches)
        cu.cache_append(got, news, pos)
        cu.cache_append_reference(want, news, pos)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ----------------------------------------------------------------------------
# the engine's CUDA graphs: replay against the eager loop, prewarm
# ----------------------------------------------------------------------------


def _graph_engine(route, kv):
    """A small int8 (or fp8) engine on the card with 8 live slots and 8
    prompts still queued, which the mixed step can piggyback."""
    import dataclasses

    from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
    from flash_attention_softmax_n_tpu_torch.models import decoder as dec
    from flash_attention_softmax_n_tpu_torch.quant import weights as qw

    cfg = dec.DecoderConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, max_seq_len=512, softmax_n=1.0,
                            dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, int8_mm_impl=route, decode_attn_impl=route)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = qw.quantize_decoder_weights(dec.init_decoder_params(cfg, g, device="cuda"),
                                         bits=-8 if kv == "fp8" else 8)
    eng = InferenceEngine(cfg, params, max_batch=16, max_len=256, kv_quantization=kv)
    rng = np.random.RandomState(0)
    for j in range(16):
        eng.submit(rng.randint(0, 512, size=int(rng.randint(5, 100))).tolist(),
                   max_new_tokens=40)
    # admit the first 8 into live slots, leave 8 queued
    queued = [eng.queue.pop() for _ in range(8)][::-1]
    eng._finalize_admission(eng._admit_async())
    eng.queue.extend(queued)
    eng._active_mask()
    return eng


def _state(eng):
    return [qt.as_bytes(t).clone() for t in eng._state_tensors()]


def _check_replays(eng, keys=((16, 256, False), (8, 256, True), (6, 256, False))):
    """Each loop variant in ``keys``, run eagerly from the engine's state,
    then put back, captured and replayed: tokens, first tokens, the
    cache's value, scale and length bytes and the launch counts equal."""
    for key in keys:
        if key[2]:
            eng._load_piggyback(eng._take_piggyback(key[0]))
        start = _state(eng)
        before = dict(_build.LAUNCHES)
        eager = [t.clone() for t in eng._loop(key)[::3]]  # tokens, first
        eager_launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
        eager_state = _state(eng)
        for t, s in zip(eng._state_tensors(), start):
            qt.as_bytes(t).copy_(s)
        eng._capture(key)
        assert _build.LAUNCHES == {k: n + eager_launches[k] for k, n in before.items()}
        before = dict(_build.LAUNCHES)
        replayed = eng._greedy_loop(key)[::3]
        assert {k: n - before[k] for k, n in _build.LAUNCHES.items()} == eager_launches
        assert all(torch.equal(a, b) for a, b in zip(replayed, eager))
        assert all(torch.equal(a, b) for a, b in zip(_state(eng), eager_state))
        if key[2]:  # both paths ran the payload: put it back in the queue
            eng._undo_piggyback({"reqs": list(eng._pending_prefill.values()),
                                 "slots": list(eng._pending_prefill)})


@pytest.mark.parametrize("route,kv", [("xla", "int8"), ("pallas", "int8"),
                                      ("pallas", "fp8")])
def test_graph_replay_matches_eager_loop(gen, route, kv):
    _check_replays(_graph_engine(route, kv))


def test_prewarm_leaves_the_state_bit_equal(gen):
    eng = _graph_engine("pallas", "int8")
    start = _state(eng)
    assert eng.prewarm(loop_steps=16, attn_lens=[256]) == 4
    assert sorted(eng._graphs) == [(8, 256, False), (8, 256, True),
                                   (16, 256, False), (16, 256, True)]
    assert all(torch.equal(a, b) for a, b in zip(_state(eng), start))


# ----------------------------------------------------------------------------
# chunked prefill and the prefix cache on the card
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0.0, 1.0])
def test_flash_fwd_at_a_chunk_offset(gen, dtype, n):
    # K1 as a chunk at offset 128 launches it: 64 queries over 192 keys, the
    # engine's mask (key j visible iff j < true_len and j <= 128 + i) as a
    # (B, 1, L, S) bias, the causal flag off; true lengths in (128, 192]
    B, H, L, S, d = 2, 4, 64, 192, 64
    from flash_attention_softmax_n_tpu_torch.ops import flash_attention as ofa
    q, k, v = (torch.randn((B, H, m, d), generator=gen, device="cuda").to(dtype)
               for m in (L, S, S))
    true_lens = torch.tensor([140, 192], device="cuda")
    kpos = torch.arange(S, device="cuda")
    visible = ((kpos[None, None, :] < true_lens[:, None, None])
               & (kpos[None, :] <= torch.arange(L, device="cuda")[:, None] + S - L)[None])
    bias = ofa._mask_to_bias(visible[:, None])
    kw = dict(n=n, scale=d ** -0.5, is_causal=False)
    before = _build.LAUNCHES["flash_fwd"]
    got = fa.flash_fwd(q, k, v, bias, **kw)
    assert _build.LAUNCHES["flash_fwd"] == before + 1
    want = fa.flash_fwd_reference(q, k, v, bias, **kw)
    if dtype == torch.bfloat16:
        _check_bf16_fwd(got, want)
    else:
        torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-6)
    again = fa.flash_fwd(q, k, v, bias, **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def _prefix_setup(max_batch, kv="int8"):
    """The graph tests' bf16 model with int8 weights, engines of
    ``max_batch`` slots with 64-token chunks over an int8 (or ``kv``) cache,
    and a 128-token prefix."""
    from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine
    from flash_attention_softmax_n_tpu_torch.models import decoder as dec
    from flash_attention_softmax_n_tpu_torch.quant import weights as qw

    cfg = dec.DecoderConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, max_seq_len=512, softmax_n=1.0,
                            dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = qw.quantize_decoder_weights(dec.init_decoder_params(cfg, g, device="cuda"),
                                         bits=8)
    prefix = np.random.RandomState(99).randint(0, 512, size=128).tolist()

    def make(cls=InferenceEngine, slots=max_batch):
        return cls(cfg, params, max_batch=slots, max_len=256, kv_quantization=kv,
                   prefill_chunk=64)

    return make, prefix


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_prefix_store_bit_equal_to_a_cold_chunked_prefill(gen, kv):
    # the store's rows against those a cold 1-slot engine writes for the
    # same tokens through its chunked lane (two 64-token chunks at offsets 0
    # and 64, one more at 128 for the prompt's last token): value and scale
    # bytes equal; the later chunks read the cached prefix as fp8 too
    make, prefix = _prefix_setup(4, kv)
    eng = make()
    assert eng.register_prefix(prefix) == 0
    cold = make(slots=1)
    cold.submit(prefix + [7], max_new_tokens=1)
    before = _build.LAUNCHES["flash_fwd"]
    cold.run_until_done()
    assert _build.LAUNCHES["flash_fwd"] == before + 3 * 2  # 3 chunks x 2 layers
    assert set(cold._prefill_chunks) == {0, 64, 128}
    store = eng._prefixes[0]["store"]
    for name in ("k", "v"):
        ref = cold.cache[name]
        assert torch.equal(qt.as_bytes(store[name].values),
                           qt.as_bytes(ref.values[:, 0, :, :128]))
        assert torch.equal(store[name].scales, ref.scales[:, 0, :, :128])


def test_prefix_hit_inside_a_prewarmed_engine(gen):
    # prefix hits served by a prewarmed engine (its greedy chunks replay
    # graphs) give the tokens of an engine that captures nothing; then,
    # with the inserted rows live in its cache, each loop variant still
    # replays bit-equal to the eager loop
    from flash_attention_softmax_n_tpu_torch.engine import InferenceEngine

    class Eager(InferenceEngine):
        def _capture(self, key):
            pass

    make, prefix = _prefix_setup(16)
    rng = np.random.RandomState(1)
    reqs = [(prefix + rng.randint(0, 512, size=int(rng.randint(1, 60))).tolist()
             if j % 2 == 0 else rng.randint(0, 512, size=int(rng.randint(5, 100))).tolist(),
             int(rng.randint(8, 40))) for j in range(12)]
    outs = []
    for eng in (make(), make(Eager)):
        if not isinstance(eng, Eager):
            eng.prewarm(loop_steps=16, attn_lens=[256])
        eng.register_prefix(prefix)
        for prompt, budget in reqs:
            eng.submit(prompt, max_new_tokens=budget)
        done = sorted(eng.run_until_done(loop_steps=16), key=lambda r: r.request_id)
        assert eng.counters_report()["prefix_hits"] == 6
        assert [len(r.output) for r in done] == [b for _, b in reqs]
        outs.append([r.output for r in done])
    assert outs[0] == outs[1]
    # live slots over inserted prefix rows, and 8 short prompts queued for
    # the piggybacked variant
    eng = make()
    eng.register_prefix(prefix)
    for prompt, budget in reqs[:8]:
        eng.submit(prompt, max_new_tokens=40)
    eng._finalize_admission(eng._admit_async())
    assert eng.counters_report()["prefix_hits"] == 4
    for _ in range(8):
        eng.submit(rng.randint(0, 512, size=int(rng.randint(5, 100))).tolist(),
                   max_new_tokens=40)
    eng._active_mask()
    _check_replays(eng)


# ----------------------------------------------------------------------------
# K1 with ALiBi and dropout, K5 and K6
# ----------------------------------------------------------------------------


def _attn_inputs(gen, dtype, B, H, L, S, d, *, bias_shape=None, alibi=False,
                 rate=0.0):
    q, k, v, do = (torch.randn((B, H, m, d), generator=gen, device="cuda").to(dtype)
                   for m in (L, S, S, L))
    extras = dict(bias=None, slopes=None, seed=None, dropout_rate=rate)
    if bias_shape is not None:
        extras["bias"] = 0.5 * torch.randn((*bias_shape, L, S), generator=gen,
                                           device="cuda")
    if alibi:
        extras["slopes"] = torch.tensor([2.0 ** -(i + 1) for i in range(H)],
                                        device="cuda")
    if rate > 0:
        extras["seed"] = torch.tensor([-123457], dtype=torch.int32, device="cuda")
    return q, k, v, do, extras


# K5's and K6's bf16 kernels at D 256 and above it, K1's at D 384 and 512,
# as torch.profiler names them
_D256_BWD_KERNELS = ("flash_bwd_dq_d256_kernel", "flash_bwd_dkv_d256_kernel")
_WIDE_BWD_KERNELS = ("flash_bwd_dq_wide_wgmma_kernel", "flash_bwd_dkv_wide_wgmma_kernel")
_WIDE_FWD_KERNEL = "flash_fwd_wide_wgmma_kernel"


def _launched(fn, tries=3):
    """fn()'s result, the names of the CUDA kernels it launched and how
    many calls that took: torch.profiler at times records no device event
    at all (PERF.md section 7), and fn then runs again under a new
    profiler, up to ``tries`` calls"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for calls in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return out, names, calls


def _assert_bwd_kernels(names, d):
    """bf16 K5 and K6 at D 256 and above ran their own TMA + wgmma kernels"""
    for kernel in _D256_BWD_KERNELS if d == 256 else _WIDE_BWD_KERNELS:
        assert any(kernel in n for n in names), (kernel, sorted(set(names)))


def _fwd_launched(fn, d):
    """fn()'s result; bf16 K1 at D 384 and 512 must have run its wide TMA +
    wgmma kernel"""
    if d not in (384, 512):
        return fn()
    out, names, _ = _launched(fn)
    assert any(_WIDE_FWD_KERNEL in n for n in names), sorted(set(names))
    return out


def _assert_close(got, want, tol):
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    assert err <= tol * max(1.0, top), (err, "max |plain|", top)


# K5's and K6's bf16 gradients as a whole: ||got - plain|| within 1e-2 of
# max(1, ||plain||), as chip_smoke.BWD_NORM_TOL holds them; an error only
# on far tiles, small beside max |plain|, still moves it
_BWD_NORM_TOL = 1e-2


def _assert_norm_close(got, want, tol):
    err = float((got.float() - want.float()).norm()) / max(1.0, float(want.float().norm()))
    assert err <= tol, (err, "max |plain|", float(want.float().abs().max()))


def _fwd_bwd(fn_fwd, fn_bwd, q, k, v, do, extras, *, n, causal, grad_bias=True):
    scale = q.shape[-1] ** -0.5
    o, lse = fn_fwd(q, k, v, extras["bias"], n=n, scale=scale, is_causal=causal,
                    slopes=extras["slopes"], seed=extras["seed"],
                    dropout_rate=extras["dropout_rate"])
    grads = fn_bwd(q, k, v, extras["bias"], extras["slopes"], extras["seed"], o,
                   lse, do, scale=scale, is_causal=causal,
                   dropout_rate=extras["dropout_rate"], grad_bias=grad_bias)
    return (o, lse), grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("extra", ["none", "bias", "alibi", "dropout", "all"])
def test_flash_fwd_bwd_extras_match_plain(gen, dtype, n, extra):
    kw = dict(bias_shape=(2, 1) if extra in ("bias", "all") else None,
              alibi=extra in ("alibi", "all"),
              rate=0.25 if extra in ("dropout", "all") else 0.0)
    q, k, v, do, extras = _attn_inputs(gen, dtype, 2, 4, 200, 264, 64, **kw)
    before = {name: _build.LAUNCHES[name]
              for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    (o, lse), got = _fwd_bwd(fa.flash_fwd, fa.flash_bwd, q, k, v, do, extras,
                             n=n, causal=True)
    assert all(_build.LAUNCHES[name] == c + 1 for name, c in before.items())
    (o_ref, lse_ref), want = _fwd_bwd(fa.flash_fwd_reference,
                                      fa.flash_bwd_reference, q, k, v, do,
                                      extras, n=n, causal=True)
    ftol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=ftol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-6)
    gtol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _assert_close(g, w, gtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("shape", [(200, 200, False), (150, 150, True),
                                   (100, 164, True), (96, 40, True)])
def test_flash_bwd_matches_plain(gen, dtype, d, n, shape):
    L, S, causal = shape
    q, k, v, do, extras = _attn_inputs(gen, dtype, 2, 3, L, S, d)
    _, got = _fwd_bwd(fa.flash_fwd, fa.flash_bwd, q, k, v, do, extras, n=n,
                      causal=causal)
    _, want = _fwd_bwd(fa.flash_fwd_reference, fa.flash_bwd_reference, q, k,
                       v, do, extras, n=n, causal=causal)
    for g, w in zip(got[:3], want[:3]):
        _assert_close(g, w, 1e-4 if dtype == torch.float32 else 2e-2)
    if n == 0 and L > S:
        dead = torch.arange(L, device="cuda") + (S - L) < 0
        assert bool((got[0][:, :, dead] == 0).all())


@pytest.mark.parametrize("bias_shape", [(2, 4), (1, 4), (2, 1), (1, 1)])
def test_flash_bwd_bias_shapes_and_no_bias_grad(gen, bias_shape):
    q, k, v, do, extras = _attn_inputs(gen, torch.float32, 2, 4, 96, 96, 64,
                                       bias_shape=bias_shape)
    _, got = _fwd_bwd(fa.flash_fwd, fa.flash_bwd, q, k, v, do, extras, n=1.0,
                      causal=True)
    _, want = _fwd_bwd(fa.flash_fwd_reference, fa.flash_bwd_reference, q, k,
                       v, do, extras, n=1.0, causal=True)
    assert got[3].shape == (2, 4, 96, 96)
    _assert_close(got[3], want[3], 1e-4)
    _, none = _fwd_bwd(fa.flash_fwd, fa.flash_bwd, q, k, v, do, extras, n=1.0,
                       causal=True, grad_bias=False)
    assert none[3] is None and torch.equal(none[0], got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_repeat_bit_equal(gen, dtype):
    q, k, v, do, extras = _attn_inputs(gen, dtype, 2, 4, 200, 264, 64,
                                       bias_shape=(1, 4), alibi=True, rate=0.25)
    first = _fwd_bwd(fa.flash_fwd, fa.flash_bwd, q, k, v, do, extras, n=1.0,
                     causal=True)
    again = _fwd_bwd(fa.flash_fwd, fa.flash_bwd, q, k, v, do, extras, n=1.0,
                     causal=True)
    flat = lambda r: [*r[0], *r[1]]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(first), flat(again)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_masks_bit_equal_to_the_hash(gen, dtype):
    # q = k = 0 makes p uniform (1/S), so with v = I (K1), dout = I (K6:
    # dv = pd^T) and o = 0 against an external lse = log S (K5: dbias = ds =
    # pd * dp with dp = 1), the kept entries are exactly the nonzero ones;
    # bf16 runs the wgmma kernels (head dim N = 128, one tile)
    B, H, N = 2, 4, 128
    z = torch.zeros((B, H, N, N), device="cuda", dtype=dtype)
    eye = torch.eye(N, device="cuda").expand(B, H, N, N).to(dtype).contiguous()
    seed = torch.tensor([-99], dtype=torch.int32, device="cuda")
    rate = 0.3
    keep = fa.dropout_multiplier(seed, (B, H, N, N), rate, "cuda") > 0
    o, _ = fa.flash_fwd(z, z, eye, None, n=0.0, scale=1.0, is_causal=False,
                        seed=seed, dropout_rate=rate)
    assert torch.equal(o != 0, keep)
    lse = torch.full((B, H, N), float(np.log(N)), device="cuda")
    ones = torch.zeros_like(z)
    ones[..., 0] = 1.0  # dout rows e_0 and v[:, 0] = 1 give dp = 1
    _, _, dv, dbias, _ = fa.flash_bwd(z, z, ones, torch.zeros((1, 1, N, N), device="cuda"),
                                      None, seed, z, lse, ones, scale=1.0,
                                      is_causal=False, dropout_rate=rate)
    assert torch.equal(dbias != 0, keep)
    _, _, dv, _, _ = fa.flash_bwd(z, z, z, None, None, seed, z, lse, eye, scale=1.0,
                                  is_causal=False, dropout_rate=rate)
    assert torch.equal(dv.transpose(-1, -2) != 0, keep)


# K1's bf16 kernel (TMA + wgmma): L and S ending mid-tile (its tiles are 128
# rows), rectangular causal with L < S and with L > S (dead rows at n = 0),
# the three head dims; o within 2e-3 + 2^-7 |o_plain| (o rounds one bf16 ulp
# apart, p may round to bf16 on the other side of a tie), lse within 1e-3,
# as chip_smoke.check_flash holds it; repeat calls bit-equal
_WGMMA_SHAPES = [(1, 1, False), (63, 63, True), (65, 65, True), (127, 127, False),
                 (129, 129, True), (2049, 2049, True), (100, 300, True), (300, 100, True),
                 (129, 65, False)]


def _check_bf16_fwd(got, want):
    (o, lse), (o_ref, lse_ref) = got, want
    excess = float(((o.float() - o_ref.float()).abs() - 2.0 ** -7 * o_ref.float().abs()).max())
    assert excess <= 2e-3, excess
    assert float((lse - lse_ref).abs().max()) <= 1e-3


def _check_bf16_fwd_dropped(got, want, q, k, v, bias, kw):
    """bf16 o against the plain version under bias, ALiBi and dropout, with
    chip_smoke.o_excess's allowance on each side: a bf16 o is half an ulp
    (2^-8 |o|) off, and each dropped p rounds to bf16 against its own
    running maximum (2^-8 of p, so 2^-8 sum p|v| / l of o), plus 2^-11 of
    that for the f32 arithmetic; sum p|v| / l is the plain version over |v|
    in f32. lse within 1e-3."""
    o_abs = fa.flash_fwd_reference(q.float(), k.float(), v.float().abs(), bias, **kw)[0]
    diff = (got[0].float() - want[0].float()).abs()
    tol = 2.0 ** -7 * want[0].float().abs() + (2.0 ** -7 + 2.0 ** -10) * o_abs
    assert float((diff - tol).max()) <= 0.0, float((diff - tol).max())
    assert float((got[1] - want[1]).abs().max()) <= 1e-3


@pytest.mark.parametrize("d", [32, 64, 128, 256, 384, 512, 640])
@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("shape", _WGMMA_SHAPES, ids=lambda s: "L{}-S{}-{}".format(*s))
def test_flash_fwd_wgmma_matches_plain(gen, d, n, shape):
    L, S, causal = shape
    q, k, v = (torch.randn((1, 2, m, d), generator=gen, device="cuda").to(torch.bfloat16)
               for m in (L, S, S))
    kw = dict(n=n, scale=d ** -0.5, is_causal=causal)
    got = _fwd_launched(lambda: fa.flash_fwd(q, k, v, None, **kw), d)
    _check_bf16_fwd(got, fa.flash_fwd_reference(q, k, v, None, **kw))
    again = fa.flash_fwd(q, k, v, None, **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    if n == 0 and causal and L > S:
        dead = torch.arange(L, device="cuda") + (S - L) < 0
        assert bool((got[0][:, :, dead] == 0).all())
        assert bool((got[1][:, :, dead] == fa.NEG_INF).all())


@pytest.mark.parametrize("d", [32, 64, 128, 384, 512])
@pytest.mark.parametrize("extra", ["bias11", "bias21", "bias13", "bias23", "alibi", "dropout",
                                   "all"])
def test_flash_fwd_wgmma_extras_match_plain(gen, d, extra):
    bias_shape = {"bias11": (1, 1), "bias21": (2, 1), "bias13": (1, 3), "bias23": (2, 3),
                  "all": (2, 1)}.get(extra)
    q, k, v, _, ex = _attn_inputs(gen, torch.bfloat16, 2, 3, 200, 264, d, bias_shape=bias_shape,
                                  alibi=extra in ("alibi", "all"),
                                  rate=0.25 if extra in ("dropout", "all") else 0.0)
    kw = dict(n=1.0, scale=d ** -0.5, is_causal=True, slopes=ex["slopes"], seed=ex["seed"],
              dropout_rate=ex["dropout_rate"])
    got = _fwd_launched(lambda: fa.flash_fwd(q, k, v, ex["bias"], **kw), d)
    want = fa.flash_fwd_reference(q, k, v, ex["bias"], **kw)
    if d <= 128:
        _check_bf16_fwd(got, want)
    else:
        # at D 384 and 512 o has 3-4x the columns, and 2e-3 is no bound on
        # the rounding of dropped p (the "all" case read up to 3.3e-3 on
        # the D 64-256 kernels over eight seeds, both sides within the
        # float64 evaluation's allowance): the allowance that
        # test_flash_kernels_take_every_head_dim holds these D to
        _check_bf16_fwd_dropped(got, want, q, k, v, ex["bias"], kw)
    assert torch.equal(got[0], fa.flash_fwd(q, k, v, ex["bias"], **kw)[0])


def test_flash_fwd_bf16_dropout_mask_bit_equal_to_the_hash(gen):
    # the dropout probe of test_dropout_masks_bit_equal_to_the_hash through
    # K1's bf16 kernel: q = k = 0, v = I (head dim 128, one key tile), so o
    # is nonzero where the hash keeps
    B, H, N, rate = 2, 4, 128, 0.3
    z = torch.zeros((B, H, N, N), device="cuda", dtype=torch.bfloat16)
    eye = torch.eye(N, device="cuda").expand(B, H, N, N).to(torch.bfloat16).contiguous()
    seed = torch.tensor([-99], dtype=torch.int32, device="cuda")
    keep = fa.dropout_multiplier(seed, (B, H, N, N), rate, "cuda") > 0
    o, _ = fa.flash_fwd(z, z, eye, None, n=0.0, scale=1.0, is_causal=False, seed=seed,
                        dropout_rate=rate)
    assert torch.equal(o != 0, keep)


@pytest.mark.parametrize("d", [64, 384, 512])
def test_flash_fwd_wgmma_rejects_misaligned_inputs(gen, d):
    # contiguous bf16 views starting 4 bytes past an allocation: TMA needs
    # 16; the same call on aligned inputs then runs (at D 384 and 512 on K1's
    # wide TMA + wgmma kernel)
    base = torch.randn(2 * 128 * d + 2, device="cuda").to(torch.bfloat16)
    q = base[2:].view(1, 2, 128, d)
    k = torch.randn((1, 2, 128, d), device="cuda").to(torch.bfloat16)
    before = _build.LAUNCHES["flash_fwd"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa.flash_fwd(q, k, k, None, n=1.0, scale=0.125, is_causal=True)
    with pytest.raises(ValueError, match="16-byte boundary"):
        pp.mini("softmax", q, k, k)
    assert _build.LAUNCHES["flash_fwd"] == before
    got = _fwd_launched(lambda: fa.flash_fwd(k, k, k, None, n=1.0, scale=0.125,
                                             is_causal=True), d)
    _check_bf16_fwd(got, fa.flash_fwd_reference(k, k, k, None, n=1.0, scale=0.125,
                                                is_causal=True))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 64),
                                     (torch.bfloat16, 128), (torch.bfloat16, 256),
                                     (torch.bfloat16, 384)])
def test_block_grads_against_an_external_lse(gen, dtype, d):
    # the ring's use: one kv block against a global lse (here from the same
    # block and 50 more keys), o and dout of the whole range; bf16 at d256
    # on K5's and K6's D 256 kernels and at d384 on their wide ones,
    # repeats bit-equal
    L, S = 200, 140
    q, k, v, do, _ = _attn_inputs(gen, dtype, 1, 2, L, S + 50, d)
    o, lse = fa.flash_fwd_reference(q, k, v, None, n=1.0, scale=d ** -0.5, is_causal=True)
    kb, vb = k[:, :, 50:].contiguous(), v[:, :, 50:].contiguous()

    def run():
        return fa.flash_attention_block_grads(q, kb, vb, o, lse, do, is_causal=True)

    got, names, _ = _launched(run)
    if d >= 256:
        _assert_bwd_kernels(names, d)
        assert all(torch.equal(a, b) for a, b in zip(got, run()))
    want = fa.flash_bwd_reference(q, kb, vb, None, None, None, o, lse, do,
                                  scale=d ** -0.5, is_causal=True)[:3]
    for g, w in zip(got, want):
        if dtype == torch.float32:
            _assert_close(g, w, 1e-4)
        else:
            _assert_close(g, w, 2e-2)
            _assert_norm_close(g, w, _BWD_NORM_TOL)


# K5's and K6's bf16 kernels (TMA + wgmma, on K1's tile; at d256 their own
# 64-row kernels and above 256 their wide ones, D streamed in 64-column
# chunks, which must be the ones launched): the shapes of
# _WGMMA_SHAPES, each backward held alone against the plain version from
# the plain forward's o and lse, within 2e-2 of max(1, |plain|) (ds and the
# dropped p round to bf16 on either side of a tie; the kernel rounds the
# dropped p to bf16 for dv, the plain version keeps it in f32) and within
# _BWD_NORM_TOL of max(1, ||plain||); dbias within 1e-4 (f32, from the same p);
# repeat calls bit-equal
def _bwd_bf16(gen, B, H, L, S, d, *, n=1.0, causal=True, **extras):
    q, k, v, do, ex = _attn_inputs(gen, torch.bfloat16, B, H, L, S, d, **extras)
    kw = dict(n=n, scale=d ** -0.5, is_causal=causal, slopes=ex["slopes"], seed=ex["seed"],
              dropout_rate=ex["dropout_rate"])
    o, lse = fa.flash_fwd_reference(q, k, v, ex["bias"], **kw)
    args = (q, k, v, ex["bias"], ex["slopes"], ex["seed"], o, lse, do)
    bkw = dict(scale=d ** -0.5, is_causal=causal, dropout_rate=ex["dropout_rate"])
    before = {name: _build.LAUNCHES[name] for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    calls = 1
    if d >= 256:
        got, names, calls = _launched(lambda: fa.flash_bwd(*args, **bkw))
        _assert_bwd_kernels(names, d)
    else:
        got = fa.flash_bwd(*args, **bkw)
    assert all(_build.LAUNCHES[name] == c + calls for name, c in before.items())
    want = fa.flash_bwd_reference(*args, **bkw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dslopes"), got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            _assert_close(g, w, 1e-4 if name == "dbias" else 2e-2)
            _assert_norm_close(g, w, _BWD_NORM_TOL)
    again = fa.flash_bwd(*args, **bkw)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("d", [32, 64, 128, 256, 384, 512, 640])
@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("shape", _WGMMA_SHAPES, ids=lambda s: "L{}-S{}-{}".format(*s))
def test_flash_bwd_wgmma_matches_plain(gen, d, n, shape):
    L, S, causal = shape
    dq, dk, dv, _, _ = _bwd_bf16(gen, 1, 2, L, S, d, n=n, causal=causal)
    if n == 0 and causal and L > S:
        dead = torch.arange(L, device="cuda") + (S - L) < 0
        assert bool((dq[:, :, dead] == 0).all())


@pytest.mark.parametrize("d", [32, 64, 128, 256, 384, 512, 640])
@pytest.mark.parametrize("extra", ["bias11", "bias21", "bias13", "bias23", "alibi", "dropout",
                                   "all"])
def test_flash_bwd_wgmma_extras_match_plain(gen, d, extra):
    bias_shape = {"bias11": (1, 1), "bias21": (2, 1), "bias13": (1, 3), "bias23": (2, 3),
                  "all": (2, 1)}.get(extra)
    _bwd_bf16(gen, 2, 3, 200, 264, d, bias_shape=bias_shape, alibi=extra in ("alibi", "all"),
              rate=0.25 if extra in ("dropout", "all") else 0.0)


# head dims the kernels are not built for (16, 20, 80, 96, 160, 288) run
# zero-padded to the next of 32, 64, 128, 256 and the multiples of 128
# above; 256 runs K1's, K5's and K6's D 256 wgmma kernels in bf16; 384 and
# 512 (and 288 at 384) the wide TMA + wgmma kernels in bf16; 640 K5's and
# K6's wide TMA + wgmma kernels in bf16 and K1's wide scalar kernel; f32
# K1, K5 and K6 at 256 and above their wide split-TF32 kernels. Under a bias, ALiBi and dropout, n 0 and 1, at chip_smoke's
# B2 H4 L200 S264; the backward from the plain forward's o and lse;
# tolerances as above, repeats bit-equal
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 20, 80, 96, 160, 256, 288, 384, 512, 640])
@pytest.mark.parametrize("n", [0.0, 1.0])
def test_flash_kernels_take_every_head_dim(gen, dtype, d, n):
    q, k, v, do, ex = _attn_inputs(gen, dtype, 2, 4, 200, 264, d, bias_shape=(1, 4),
                                   alibi=True, rate=0.25)
    kw = dict(n=n, scale=d ** -0.5, is_causal=True, slopes=ex["slopes"], seed=ex["seed"],
              dropout_rate=ex["dropout_rate"])
    before = _build.LAUNCHES["flash_fwd"]
    got, names, calls = _launched(lambda: fa.flash_fwd(q, k, v, ex["bias"], **kw))
    assert _build.LAUNCHES["flash_fwd"] == before + calls and got[0].shape == q.shape
    if dtype == torch.float32 and fa.kernel_head_dim(d) >= 256:
        assert any(_TF32X3_WIDE_FWD_KERNELS[1] in n for n in names), sorted(set(names))
    elif fa.kernel_head_dim(d) in (384, 512):
        assert any(_WIDE_FWD_KERNEL in n for n in names), sorted(set(names))
    elif fa.kernel_head_dim(d) > 256:
        assert any("flash_fwd_wide_kernel" in n for n in names), sorted(set(names))
    want = fa.flash_fwd_reference(q, k, v, ex["bias"], **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=0)
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-6)
    else:
        _check_bf16_fwd_dropped(got, want, q, k, v, ex["bias"], kw)
    assert all(torch.equal(a, b) for a, b in zip(got, fa.flash_fwd(q, k, v, ex["bias"], **kw)))
    o, lse = want
    args = (q, k, v, ex["bias"], ex["slopes"], ex["seed"], o, lse, do)
    bkw = dict(scale=d ** -0.5, is_causal=True, dropout_rate=ex["dropout_rate"])
    before = {name: _build.LAUNCHES[name] for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    grads = fa.flash_bwd(*args, **bkw)
    assert all(_build.LAUNCHES[name] == c + 1 for name, c in before.items())
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dslopes"), grads,
                          fa.flash_bwd_reference(*args, **bkw)):
        assert g.shape == w.shape, name
        if dtype == torch.float32:
            _assert_close(g, w, 1e-4)
        else:
            _assert_close(g, w, 1e-4 if name == "dbias" else 2e-2)
            _assert_norm_close(g, w, _BWD_NORM_TOL)
    assert all(torch.equal(a, b) for a, b in zip(grads, fa.flash_bwd(*args, **bkw)))


@pytest.mark.parametrize("d", [64, 256, 384])
def test_flash_bwd_wgmma_rejects_misaligned_inputs(gen, d):
    # contiguous bf16 views starting 4 bytes past an allocation: TMA needs 16
    base = torch.randn(2 * 128 * d + 2, device="cuda").to(torch.bfloat16)
    bad = base[2:].view(1, 2, 128, d)
    k = torch.randn((1, 2, 128, d), device="cuda").to(torch.bfloat16)
    rows = torch.zeros((1, 2, 128), device="cuda")
    ops = _build.ops()
    for q, do in ((bad, k), (k, bad)):
        before = {name: _build.LAUNCHES[name] for name in ("flash_bwd_dq", "flash_bwd_dkv")}
        with pytest.raises(ValueError, match="16-byte boundary"):
            fa.flash_bwd(q, k, k, None, None, None, k, rows, do, scale=0.125, is_causal=True)
        assert all(_build.LAUNCHES[name] == c for name, c in before.items())
        with pytest.raises(ValueError, match="16-byte boundary"):
            ops.flash_bwd_dkv(q, k, k, None, None, None, do, rows, rows, torch.empty_like(k),
                              torch.empty_like(k), 0.125, True, 0, 1.0)


# K5's and K6's f32 kernels: split-TF32 products on TMA + wgmma, at D 32, 64
# and 128 flash_bwd_dq_tf32x3_kernel / flash_bwd_dkv_tf32x3_kernel
# (csrc/flash_bwd_f32.cu), at 256 and above flash_bwd_dq_tf32x3_wide_kernel
# / flash_bwd_dkv_tf32x3_wide_kernel after their pre-passes
# (csrc/flash_bwd_f32_wide.cu; 640 runs K5's two column groups and K6's
# three), which must be the ones launched, and no f32 kernel of the other
# width (the scalar f32 kernels are gone): the shapes of
# _WGMMA_SHAPES (L and S ending mid-tile against K5's 64-row query tiles
# and 16- to 64-key tiles, K6's 64-key tiles and 16- or 32-row query tiles;
# rectangular causal both ways, dead rows at n = 0; non-causal), each
# backward held alone against the plain version from the plain forward's o
# and lse, within 1e-4 of max(1, |plain|) element-wise, as every f32 card
# test holds K5 and K6; at chip_smoke's shapes (B2 H3 L200 S264 under the
# extras, train_agreement's) also within 1e-5 of max(1, ||plain||) as a
# whole, as check_attention holds them (three TF32 passes drop about 2^-21
# of a product; where dq and dk are exactly zero, as at L = S = 1 with n =
# 0, p = 1 and ds = dp - delta keeps dp's 2^-21 of sum |do v|, which
# max(1, ||plain||) leaves absolute: 1.2e-5 of the norm at d128, 4.1e-6 at
# d64 on an H100, against at most 1.5e-6 at every other shape here);
# repeat calls bit-equal
_TF32X3_BWD_KERNELS = ("flash_bwd_dq_tf32x3_kernel", "flash_bwd_dkv_tf32x3_kernel")
_TF32X3_WIDE_BWD_KERNELS = ("flash_bwd_dq_tf32x3_split_kernel", "flash_bwd_dq_tf32x3_wide_kernel",
                            "flash_bwd_dkv_tf32x3_split_kernel",
                            "flash_bwd_dkv_tf32x3_wide_kernel")
_F32_NORM_TOL = 1e-5


def _bwd_f32(gen, B, H, L, S, d, *, n=1.0, causal=True, norm=False, **extras):
    q, k, v, do, ex = _attn_inputs(gen, torch.float32, B, H, L, S, d, **extras)
    kw = dict(n=n, scale=d ** -0.5, is_causal=causal, slopes=ex["slopes"], seed=ex["seed"],
              dropout_rate=ex["dropout_rate"])
    o, lse = fa.flash_fwd_reference(q, k, v, ex["bias"], **kw)
    args = (q, k, v, ex["bias"], ex["slopes"], ex["seed"], o, lse, do)
    bkw = dict(scale=d ** -0.5, is_causal=causal, dropout_rate=ex["dropout_rate"])
    before = {name: _build.LAUNCHES[name] for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    got, names, calls = _launched(lambda: fa.flash_bwd(*args, **bkw))
    assert all(_build.LAUNCHES[name] == c + calls for name, c in before.items())
    wide = fa.kernel_head_dim(d) >= 256
    ran, other = ((_TF32X3_WIDE_BWD_KERNELS, _TF32X3_BWD_KERNELS) if wide
                  else (_TF32X3_BWD_KERNELS, _TF32X3_WIDE_BWD_KERNELS))
    for kernel in ran:
        assert any(kernel in nm for nm in names), (kernel, sorted(set(names)))
    # no name is a substring of another: the other width's kernels did not run
    assert not any(k in nm for k in other for nm in names), sorted(set(names))
    want = fa.flash_bwd_reference(*args, **bkw)
    for name, g, w in zip(("dq", "dk", "dv", "dbias", "dslopes"), got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == torch.float32 and g.shape == w.shape, name
            _assert_close(g, w, 1e-4)
            if norm:
                _assert_norm_close(g, w, _F32_NORM_TOL)
    again = fa.flash_bwd(*args, **bkw)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("d", [32, 64, 128, 256, 384, 512, 640])
@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("shape", _WGMMA_SHAPES, ids=lambda s: "L{}-S{}-{}".format(*s))
def test_flash_bwd_tf32x3_matches_plain(gen, d, n, shape):
    L, S, causal = shape
    dq, dk, dv, _, _ = _bwd_f32(gen, 1, 2, L, S, d, n=n, causal=causal)
    if n == 0 and causal and L > S:
        dead = torch.arange(L, device="cuda") + (S - L) < 0
        assert bool((dq[:, :, dead] == 0).all())


@pytest.mark.parametrize("d", [32, 64, 128, 256, 384, 512, 640])
@pytest.mark.parametrize("extra", ["bias11", "bias21", "bias13", "bias23", "alibi", "dropout",
                                   "all"])
def test_flash_bwd_tf32x3_extras_match_plain(gen, d, extra):
    # dbias from every bias broadcast, dslopes from ALiBi, dropout's hash
    bias_shape = {"bias11": (1, 1), "bias21": (2, 1), "bias13": (1, 3), "bias23": (2, 3),
                  "all": (2, 1)}.get(extra)
    _bwd_f32(gen, 2, 3, 200, 264, d, norm=True, bias_shape=bias_shape,
             alibi=extra in ("alibi", "all"), rate=0.25 if extra in ("dropout", "all") else 0.0)


def test_flash_bwd_tf32x3_at_train_agreements_shape(gen):
    # B2 H32 L=S=1024 d64 causal, n 1: the f32 training path's (chip_smoke
    # train_agreement); every query tile crosses the diagonal at its end
    _bwd_f32(gen, 2, 32, 1024, 1024, 64, norm=True)


@pytest.mark.parametrize("d", [32, 128, 256, 384, 512, 640])
def test_flash_bwd_tf32x3_rejects_misaligned_inputs(gen, d):
    # contiguous f32 views starting 4 bytes past an allocation: TMA needs 16
    # (at 256 and above the pre-pass's 16-byte loads)
    base = torch.randn(2 * 128 * d + 1, device="cuda")
    bad = base[1:].view(1, 2, 128, d)
    k = torch.randn((1, 2, 128, d), device="cuda")
    rows = torch.zeros((1, 2, 128), device="cuda")
    for q, do in ((bad, k), (k, bad)):
        before = {name: _build.LAUNCHES[name] for name in ("flash_bwd_dq", "flash_bwd_dkv")}
        with pytest.raises(ValueError, match="16-byte boundary"):
            fa.flash_bwd(q, k, k, None, None, None, k, rows, do, scale=0.125, is_causal=True)
        assert all(_build.LAUNCHES[name] == c for name, c in before.items())


@pytest.mark.parametrize("d", [256, 640])
def test_flash_bwd_tf32x3_wide_guarded_repeats(gen, d):
    # K5's and K6's wide split-TF32 kernels (640: both column-group paths)
    # under bias, ALiBi and dropout, called through the operators with every
    # f32 input and output inside 16 KB of NaN on each side and the outputs
    # filled with NaN before each call: 16 calls, every other one beside a
    # matmul on a second stream, must each give flash_bwd's gradients bit
    # for bit (a read past an input, a race on the ring or the exchange
    # buffers, or an output element left unwritten would show) and leave
    # every guard NaN (a write past an output would show)
    B, H, L, S, rate = 2, 3, 200, 264, 0.25
    q, k, v, do, ex = _attn_inputs(gen, torch.float32, B, H, L, S, d, bias_shape=(2, 1),
                                   alibi=True, rate=rate)
    kw = dict(scale=d ** -0.5, is_causal=True, dropout_rate=rate)
    o, lse = fa.flash_fwd_reference(q, k, v, ex["bias"], n=1.0, slopes=ex["slopes"],
                                    seed=ex["seed"], **kw)
    want = fa.flash_bwd(q, k, v, ex["bias"], ex["slopes"], ex["seed"], o, lse, do, **kw)
    guard = 4096

    def guarded(shape):
        n = int(np.prod(shape))
        buf = torch.full((2 * guard + n,), float("nan"), device="cuda")
        return buf, buf[guard:guard + n].view(shape)

    def placed(t):
        buf, view = guarded(t.shape)
        view.copy_(t)
        return buf, view

    delta = torch.sum(do * o, dim=-1)
    ins = [placed(t) for t in (q, k, v, fa._plane_bias(ex["bias"], L, S), ex["slopes"], do, lse,
                               delta)]
    outs = [guarded(s) for s in ((B, H, L, d), (B, H, S, d), (B, H, S, d), (B, H, L, S),
                                 (B, H, L))]
    qg, kg, vg, bg, sg, dog, lseg, dg = (view for _, view in ins)
    dq, dk, dv, dbias, dslope_rows = (view for _, view in outs)
    seed = fa._seed_arg(ex["seed"], rate, q.device)
    thresh, mult = fa._dropout_args(rate)
    scale_q = fa._scale_q(d ** -0.5, torch.float32)
    ops = _build.ops()
    side = torch.cuda.Stream()
    noise = torch.randn((4096, 4096), generator=gen, device="cuda")
    for rep in range(16):
        for view in (dq, dk, dv, dbias, dslope_rows):
            view.fill_(float("nan"))
        if rep % 2:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                torch.mm(noise, noise)
        ops.flash_bwd_dq(qg, kg, vg, bg, sg, seed, dog, lseg, dg, dq, dbias, dslope_rows,
                         scale_q, d ** -0.5, True, thresh, mult)
        ops.flash_bwd_dkv(qg, kg, vg, bg, sg, seed, dog, lseg, dg, dk, dv, scale_q, True,
                          thresh, mult)
        got = (dq, dk, dv, dbias, torch.sum(dslope_rows, dim=(0, 2)))
        for name, g, w in zip(("dq", "dk", "dv", "dbias", "dslopes"), got, want):
            assert torch.equal(g, w), (rep, name)
        torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for name, (buf, view) in zip(("q", "k", "v", "bias", "slopes", "do", "lse", "delta", "dq",
                                  "dk", "dv", "dbias", "dslope_rows"), ins + outs):
        n = view.numel()
        assert bool(torch.isnan(buf[:guard]).all() and torch.isnan(buf[guard + n:]).all()), name


# K1's f32 kernels: split-TF32 products on TMA + wgmma, at D 32, 64 and 128
# flash_fwd_tf32x3_kernel (csrc/flash_fwd_f32.cu), at 256 and above (300 at
# 384) flash_fwd_tf32x3_wide_kernel after its pre-pass
# (csrc/flash_fwd_f32_wide.cu), which must be the ones launched (and not
# the other width's, nor the scalar flash_fwd_kernel or
# flash_fwd_wide_kernel that they replaced): the shapes of _WGMMA_SHAPES (L
# and S ending mid-tile against their 64-row query tiles and 32- or 64-key
# tiles; rectangular causal both ways, dead rows at n = 0; non-causal) and
# the extras, o within 2e-5 and lse within 1e-3 of the plain version and of
# the plain emulation of the split (flash_fwd_tf32x3_reference, at D >= 256
# chunked as the wide kernel sums), as chip_smoke.check_attention holds f32
# K1; repeat calls bit-equal
_TF32X3_FWD_KERNEL = "flash_fwd_tf32x3_kernel"
_TF32X3_WIDE_FWD_KERNELS = ("flash_fwd_tf32x3_split_kernel", "flash_fwd_tf32x3_wide_kernel")
_TF32X3_FWD_DIMS = [32, 64, 128, 256, 300, 384, 512, 640]


def _fwd_f32(gen, B, H, L, S, d, *, n=1.0, causal=True, **extras):
    q, k, v, _, ex = _attn_inputs(gen, torch.float32, B, H, L, S, d, **extras)
    kw = dict(n=n, scale=d ** -0.5, is_causal=causal, slopes=ex["slopes"], seed=ex["seed"],
              dropout_rate=ex["dropout_rate"])
    before = _build.LAUNCHES["flash_fwd"]
    got, names, calls = _launched(lambda: fa.flash_fwd(q, k, v, ex["bias"], **kw))
    assert _build.LAUNCHES["flash_fwd"] == before + calls
    wide = fa.kernel_head_dim(d) >= 256
    ran, other = (((*_TF32X3_WIDE_FWD_KERNELS,), (_TF32X3_FWD_KERNEL,)) if wide
                  else ((_TF32X3_FWD_KERNEL,), _TF32X3_WIDE_FWD_KERNELS))
    for kernel in ran:
        assert any(kernel in nm for nm in names), (kernel, sorted(set(names)))
    # no name is a substring of another: neither the other width's kernels
    # nor the scalar ones ran
    for kernel in (*other, "flash_fwd_kernel", "flash_fwd_wide_kernel"):
        assert not any(kernel in nm for nm in names), (kernel, sorted(set(names)))
    chunk = fa.TF32X3_WIDE_FWD_CHUNK if wide else None
    for want in (fa.flash_fwd_reference(q, k, v, ex["bias"], **kw),
                 fa._padded_fwd(fa.flash_fwd_tf32x3_reference, q, k, v, ex["bias"],
                                chunk=chunk, **kw)):
        assert got[0].dtype == torch.float32 and got[0].shape == want[0].shape
        torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=0)
        assert float((got[1] - want[1]).abs().max()) <= 1e-3
    again = fa.flash_fwd(q, k, v, ex["bias"], **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    return got


@pytest.mark.parametrize("d", _TF32X3_FWD_DIMS)
@pytest.mark.parametrize("n", [0.0, 1.0])
@pytest.mark.parametrize("shape", _WGMMA_SHAPES, ids=lambda s: "L{}-S{}-{}".format(*s))
def test_flash_fwd_tf32x3_matches_plain(gen, d, n, shape):
    L, S, causal = shape
    o, lse = _fwd_f32(gen, 1, 2, L, S, d, n=n, causal=causal)
    if n == 0 and causal and L > S:
        dead = torch.arange(L, device="cuda") + (S - L) < 0
        assert bool((o[:, :, dead] == 0).all())
        assert bool((lse[:, :, dead] == fa.NEG_INF).all())


@pytest.mark.parametrize("d", _TF32X3_FWD_DIMS)
@pytest.mark.parametrize("extra", ["bias11", "bias21", "bias13", "bias23", "alibi", "dropout",
                                   "all"])
def test_flash_fwd_tf32x3_extras_match_plain(gen, d, extra):
    # every bias broadcast, ALiBi, dropout's hash
    bias_shape = {"bias11": (1, 1), "bias21": (2, 1), "bias13": (1, 3), "bias23": (2, 3),
                  "all": (2, 1)}.get(extra)
    _fwd_f32(gen, 2, 3, 200, 264, d, bias_shape=bias_shape, alibi=extra in ("alibi", "all"),
             rate=0.25 if extra in ("dropout", "all") else 0.0)


def test_flash_fwd_tf32x3_at_train_agreements_shape(gen):
    # B2 H32 L=S=1024 d64 causal, n 1: the f32 training path's (chip_smoke
    # train_agreement)
    _fwd_f32(gen, 2, 32, 1024, 1024, 64)


@pytest.mark.parametrize("d", [32, 128, 256, 640])
def test_flash_fwd_tf32x3_rejects_misaligned_inputs(gen, d):
    # contiguous f32 views starting 4 bytes past an allocation: TMA needs 16
    # (at 256 and above the pre-pass's 16-byte loads of v too)
    base = torch.randn(2 * 128 * d + 1, device="cuda")
    bad = base[1:].view(1, 2, 128, d)
    k = torch.randn((1, 2, 128, d), device="cuda")
    for q, kv in ((bad, k), (k, bad)):
        before = _build.LAUNCHES["flash_fwd"]
        with pytest.raises(ValueError, match="16-byte boundary"):
            fa.flash_fwd(q, kv, kv, None, n=1.0, scale=0.125, is_causal=True)
        assert _build.LAUNCHES["flash_fwd"] == before


def test_flash_fwd_tf32x3_at_the_smokes_wide_shapes(gen):
    # B2 H8 L=S=1024 causal, n 1, d256 / 384 / 512: chip_smoke head_dims'
    # f32 timed lines; every query tile crosses the diagonal at its end
    for d in (256, 384, 512):
        _fwd_f32(gen, 2, 8, 1024, 1024, d)


@pytest.mark.parametrize("d", [256, 640])
def test_flash_fwd_tf32x3_wide_guarded_repeats(gen, d):
    # K1's wide split-TF32 kernel and its pre-pass (640: two column groups)
    # under bias, ALiBi and dropout, called through the operator with every
    # f32 input and output inside 16 KB of NaN on each side and the outputs
    # filled with NaN before each call: 16 calls, every other one beside a
    # matmul on a second stream, must each give flash_fwd's o and lse bit
    # for bit (a read past an input, a race on the ring, the exchange
    # buffers or the pre-pass's scratch, or an output element left unwritten
    # would show) and leave every guard NaN (a write past an output would
    # show)
    B, H, L, S, rate = 2, 3, 200, 264, 0.25
    q, k, v, _, ex = _attn_inputs(gen, torch.float32, B, H, L, S, d, bias_shape=(2, 1),
                                  alibi=True, rate=rate)
    kw = dict(n=1.0, scale=d ** -0.5, is_causal=True, dropout_rate=rate)
    want = fa.flash_fwd(q, k, v, ex["bias"], slopes=ex["slopes"], seed=ex["seed"], **kw)
    guard = 4096

    def guarded(shape):
        n = int(np.prod(shape))
        buf = torch.full((2 * guard + n,), float("nan"), device="cuda")
        return buf, buf[guard:guard + n].view(shape)

    def placed(t):
        buf, view = guarded(t.shape)
        view.copy_(t)
        return buf, view

    ins = [placed(t) for t in (q, k, v, fa._plane_bias(ex["bias"], L, S), ex["slopes"])]
    outs = [guarded(s) for s in ((B, H, L, d), (B, H, L))]
    qg, kg, vg, bg, sg = (view for _, view in ins)
    o, lse = (view for _, view in outs)
    seed = fa._seed_arg(ex["seed"], rate, q.device)
    thresh, mult = fa._dropout_args(rate)
    scale_q = fa._scale_q(d ** -0.5, torch.float32)
    ops = _build.ops()
    side = torch.cuda.Stream()
    noise = torch.randn((4096, 4096), generator=gen, device="cuda")
    for rep in range(16):
        for view in (o, lse):
            view.fill_(float("nan"))
        if rep % 2:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                torch.mm(noise, noise)
        ops.flash_fwd(qg, kg, vg, bg, sg, seed, o, lse, scale_q, 1.0, True, thresh, mult)
        assert torch.equal(o, want[0]) and torch.equal(lse, want[1]), rep
        torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for name, (buf, view) in zip(("q", "k", "v", "bias", "slopes", "o", "lse"), ins + outs):
        n = view.numel()
        assert bool(torch.isnan(buf[:guard]).all() and torch.isnan(buf[guard + n:]).all()), name


# ----------------------------------------------------------------------------
# K7 (dequant matmul), K9 (fused MLP), K8 (decode attention)
# ----------------------------------------------------------------------------


def _qweight(gen, k, n, bits):
    w = torch.randn((k, n), generator=gen, device="cuda")
    q = qt.quantize(w, bits=bits, axis=0)
    return q.values, q.scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4", "w4a8"])
@pytest.mark.parametrize("mkn", [(1, 256, 97), (13, 512, 200), (64, 2048, 256),
                                 (300, 768, 1000)])
def test_qmm_matches_plain(gen, dtype, mode, mkn):
    m, k, n = mkn
    bits, act = (4 if "4" in mode else 8), mode in ("w8a8", "w4a8")
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    wv, ws = _qweight(gen, k, n, bits)
    before = _build.LAUNCHES["qmm"]
    out = qm.quantized_matmul(x, wv, ws, bits=bits, act_quant=act)
    assert _build.LAUNCHES["qmm"] == before + 1
    again = qm.quantized_matmul(x, wv, ws, bits=bits, act_quant=act)
    xq, xs = qm.quantize_rows(x) if act else (x, None)
    ref = qm.quantized_matmul_reference(xq, xs, wv, ws, bits=bits, out_dtype=dtype)
    assert out.dtype == dtype and out.shape == (m, n) and torch.equal(out, again)
    if act:
        assert torch.equal(out, ref)
    else:
        atol = 1e-5 * float(ref.float().abs().max())
        rtol = 0 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_qmm_f32_out_from_bf16_and_leading_dims(gen):
    x = torch.randn((2, 3, 512), generator=gen, device="cuda").to(torch.bfloat16)
    wv, ws = _qweight(gen, 512, 130, 8)
    out = qm.quantized_matmul(x, wv, ws, out_dtype=torch.float32)
    ref = qm.quantized_matmul_reference(x.reshape(6, 512), None, wv, ws, bits=8,
                                        out_dtype=torch.float32).reshape(2, 3, 130)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)


# K7's tensor-core modes: K at the ring's wrap (its stages of 64 logical K
# rows, 128 under W8A8: "ring") and one stage past it ("ring+1"; int4 rounds
# K up to whole 256-row groups), M either side of a 64-row tile and at an
# admission group, both producers (N 200, and K % 8 for bf16 x or K % 16 for
# int8 x, take the predicated one), and K5632
_QMM_WGMMA_CASES = [
    ("int8", 1, 256, 256), ("int8", 63, "ring", 256), ("int8", 65, "ring+1", 200),
    ("int8", 1024, "ring+1", 256), ("int8", 13, 300, 256), ("int8", 64, 5632, 2048),
    ("w8a8", 1, 512, 256), ("w8a8", 63, "ring", 256), ("w8a8", 65, "ring+1", 200),
    ("w8a8", 1024, "ring+1", 512), ("w8a8", 13, 312, 256), ("w8a8", 64, 5632, 2048),
    ("int4", 1, 256, 256), ("int4", 63, "ring", 256), ("int4", 65, "ring+1", 200),
    ("int4", 1024, "ring+1", 256), ("int4", 64, 5632, 2048),
    ("w4a8", 1, 512, 256), ("w4a8", 63, "ring", 256), ("w4a8", 65, "ring+1", 200),
    ("w4a8", 1024, "ring+1", 512), ("w4a8", 64, 5632, 2048),
    # 256-row tiles (bf16 x at M2048 N5632)
    ("int8", 2048, "ring+1", 5632), ("int4", 2048, "ring", 5632),
]


def _case_k(mode, m, k, n):
    if isinstance(k, int):
        return k
    plan = qm.qmm_plan(m, 4096, n, mode)
    k = (plan.stages + (k == "ring+1")) * plan.bk
    return -(-k // 256) * 256 if mode in ("int4", "w4a8") else k


@pytest.mark.parametrize("case", _QMM_WGMMA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_qmm_wgmma_matches_plain(gen, case):
    mode, m, k, n = case
    k = _case_k(mode, m, k, n)
    bits, act = (4 if "4" in mode else 8), mode in ("w8a8", "w4a8")
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    wv, ws = _qweight(gen, k, n, bits)
    xq, xs = qm.quantize_rows(x) if act else (x, None)
    plan = qm.qmm_plan(m, k, n, mode)
    assert plan.kernel == "wgmma"
    before = _build.LAUNCHES["qmm"]
    out = qm.quantized_matmul(x, wv, ws, bits=bits, act_quant=act)
    again = qm.quantized_matmul(x, wv, ws, bits=bits, act_quant=act)
    assert _build.LAUNCHES["qmm"] == before + 2
    ref = qm.quantized_matmul_reference(xq, xs, wv, ws, bits=bits, out_dtype=torch.bfloat16)
    assert torch.equal(out, again), plan
    if act:
        assert torch.equal(out, ref), plan
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                                   atol=1e-5 * float(ref.float().abs().max()))


@pytest.mark.parametrize("mkn", [(1024, 256, 2048), (1024, 512, 256), (64, 2048, 5632)])
def test_qmm_wgmma_f32_out(gen, mkn):
    # f32 output from the tensor cores, with one split (1024 x 2048) and more
    m, k, n = mkn
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    wv, ws = _qweight(gen, k, n, 8)
    out = qm.quantized_matmul(x, wv, ws, out_dtype=torch.float32)
    ref = qm.quantized_matmul_reference(x, None, wv, ws, bits=8, out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)


def test_qmm_plan_matches_the_kernels_and_bad_plans_raise(gen):
    ops = _build.ops()
    for code, mode in ((0, "f32"), (1, "int8"), (2, "w8a8")):
        assert ops.qmm_stage_k(code) == qm.qmm_plan(64, 512, 256, mode).bk
    # the f32 kernel's ring, as deep as the plan says, at both tile heights
    for m, n in ((64, 256), (4096, 3072)):
        plan = qm.qmm_plan(m, 768, n, "f32")
        stages, smem = ops.qmm_f32_layout(plan.bm)
        assert stages == plan.stages and 0 < smem <= 232448
    x = torch.randn((64, 512), generator=gen, device="cuda").to(torch.bfloat16)
    wv, ws = _qweight(gen, 512, 256, 8)
    ws = ws.reshape(-1).float().contiguous()
    out = torch.empty((64, 256), dtype=torch.bfloat16, device="cuda")
    part = torch.empty((2, 64, 256), device="cuda")
    with pytest.raises(ValueError, match="do not cover"):  # 8 slices, 2 x 3
        ops.qmm(x, None, wv, ws, out, part, 8, 64, 2, 3, True)
    with pytest.raises(ValueError, match="TMA"):  # N % 16 != 0
        ops.qmm(x, None, wv[:, :200].contiguous(), ws[:200].contiguous(),
                out[:, :200].contiguous(), part, 8, 64, 2, 4, True)
    with pytest.raises(ValueError, match="tile height"):  # no kernel has 96-row tiles
        ops.qmm(x, None, wv, ws, out, part, 8, 96, 2, 4, True)


# K9 at M either side of a 64-row tile and up to the fusion limit (512),
# with K and F that split the gate/up phase's K (13 x 256 x 1024: 16 tiles
# of 64 d_ff columns, 4 slices) and that do not (64 x 2048 x 5632: 88
# tiles), 256-row gate/up tiles (256 x 2048 x 5632), and K 128, where the
# gate/up phase has 2 slices and does not split but the down phase does
_MLP_SHAPES = [(1, 128, 256), (1, 512, 256), (13, 256, 1024), (64, 2048, 5632),
               (65, 512, 1536), (256, 2048, 5632), (300, 512, 1536), (512, 1024, 2816)]


def _mlp_inputs(gen, dtype, m, k, f):
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    (wg, sg), (wu, su) = _qweight(gen, k, f, 8), _qweight(gen, k, f, 8)
    wd, sd = _qweight(gen, f, k, 8)
    return x, wg, sg, wu, su, wd, sd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkf", _MLP_SHAPES, ids=lambda c: "-".join(map(str, c)))
def test_fused_mlp_matches_plain(gen, dtype, mkf):
    args = _mlp_inputs(gen, dtype, *mkf)
    plan = fm.fused_mlp_plan(*mkf, dtype)
    assert plan.kernel == ("wgmma" if dtype == torch.bfloat16 else "simt")
    before = _build.LAUNCHES["fused_mlp"]
    out = fm.fused_mlp_matmul(*args)
    assert _build.LAUNCHES["fused_mlp"] == before + 1
    again = fm.fused_mlp_matmul(*args)
    ref = fm.fused_mlp_reference(*args)
    assert out.dtype == dtype and torch.equal(out, again)
    tol = (1e-5 if dtype == torch.float32 else 2e-2) * float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    if dtype == torch.bfloat16:
        # as a whole too: an error on a few tiles, small beside max |plain|,
        # still moves the norm (h rounds to bf16 on either side of a tie)
        _assert_norm_close(out, ref, 1e-2)


# K9's f32 phases: the gate/up phase split (M64 F5632: 3 ranges) and not
# (M256: 128-row tiles), K and F that no 16-byte row takes (the cp.async
# loaders: K 126 and 200, F 90 and 300, h's rows F * 4 bytes), both phases
# split at a small shape; f32 within 1e-5 of max |plain| and as a whole
@pytest.mark.parametrize("mkf", [(64, 2048, 5632), (256, 2048, 5632), (13, 200, 300),
                                 (5, 126, 90), (130, 512, 1000)],
                         ids=lambda c: "-".join(map(str, c)))
def test_fused_mlp_f32_phases(gen, mkf):
    m, k, f = mkf
    plan = fm.fused_mlp_plan(m, k, f, torch.float32)
    assert plan.gate_up.producer == ("tma" if k % 4 == 0 and f % 16 == 0 else "cp.async")
    assert plan.down.producer == ("tma" if f % 4 == 0 and k % 16 == 0 else "cp.async")
    if mkf == (64, 2048, 5632):
        assert plan.gate_up.splits == 3
    if mkf == (256, 2048, 5632):
        assert plan.gate_up.splits == 1 and plan.gate_up.bm == 128
    args = _mlp_inputs(gen, torch.float32, m, k, f)
    before = _build.LAUNCHES["fused_mlp"]
    out = fm.fused_mlp_matmul(*args)
    assert _build.LAUNCHES["fused_mlp"] == before + 1
    again = fm.fused_mlp_matmul(*args)
    ref = fm.fused_mlp_reference(*args)
    assert out.dtype == torch.float32 and torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    _assert_norm_close(out, ref, 1e-5)


def test_fused_mlp_f32_layout_and_bad_plans(gen):
    # the f32 tiles' ring is the plan's, and their CTAs an SM fit its 228 KB
    # (each with the 1 KB the card reserves)
    for bm in (64, 128):
        for dual in (False, True):
            stages, smem = _build.ops().qmm_f32_layout(bm, dual)
            assert stages == qm.F32_STAGES
            assert qm.F32_CTAS_PER_SM[bm] * (smem + 1024) <= 233472
    x, wg, sg, wu, su, wd, sd = _mlp_inputs(gen, torch.float32, 64, 512, 256)
    sg, su, sd = (t.reshape(-1).float().contiguous() for t in (sg, su, sd))
    plan = fm.fused_mlp_plan(64, 512, 256, torch.float32)
    out, h = torch.empty_like(x), torch.empty((64, 256), device="cuda")
    gp = torch.empty((2 * plan.gate_up.splits, 64, 256), device="cuda")
    dp = torch.empty((plan.down.splits, 64, 512), device="cuda")
    good = fm._phase_ints(plan.gate_up) + fm._phase_ints(plan.down)
    fm_ops = _build.ops().fused_mlp
    fm_ops(x, wg, sg, wu, su, wd, sd, out, h, gp, dp, good)
    torch.testing.assert_close(out, fm.fused_mlp_reference(x, wg, sg, wu, su, wd, sd), rtol=0,
                               atol=1e-5 * float(out.abs().max()))
    bad_rows = list(good)
    bad_rows[0] = 256  # no f32 kernel takes 256-row tiles
    with pytest.raises(ValueError, match="tile height"):
        fm_ops(x, wg, sg, wu, su, wd, sd, out, h, gp, dp, bad_rows)
    bad_cover = list(good)
    bad_cover[8] = 1  # one 32-row slice a down split: 8 slices are not covered
    with pytest.raises(ValueError, match="do not cover"):
        fm_ops(x, wg, sg, wu, su, wd, sd, out, h, gp, dp, bad_cover)
    bad_ring = list(good)
    bad_ring[1] = 4  # not the ring the kernel is built with
    with pytest.raises(RuntimeError, match="invalid argument"):
        fm_ops(x, wg, sg, wu, su, wd, sd, out, h, gp, dp, bad_ring)


@pytest.mark.parametrize("mkf", [(13, 200, 300), (64, 2048, 5640)],
                         ids=lambda c: "-".join(map(str, c)))
def test_fused_mlp_predicated_producers(gen, mkf):
    # F % 16 (and K % 16) that TMA cannot take: the predicated producers
    m, k, f = mkf
    plan = fm.fused_mlp_plan(m, k, f, torch.bfloat16)
    assert plan.gate_up.producer == "predicated"
    args = _mlp_inputs(gen, torch.bfloat16, m, k, f)
    out, again = fm.fused_mlp_matmul(*args), fm.fused_mlp_matmul(*args)
    ref = fm.fused_mlp_reference(*args)
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=2e-2 * float(ref.float().abs().max()))
    _assert_norm_close(out, ref, 1e-2)


def test_fused_mlp_counts_one_launch_and_no_qmm(gen):
    # the down product runs K7's kernel under K9's name, from K9's launcher
    args = _mlp_inputs(gen, torch.bfloat16, 64, 2048, 5632)
    before = dict(_build.LAUNCHES)
    fm.fused_mlp_matmul(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_mlp"] == before["fused_mlp"] + 1
    assert _build.LAUNCHES["qmm"] == before["qmm"]


def test_fused_mlp_bad_plans_raise(gen):
    x, wg, sg, wu, su, wd, sd = _mlp_inputs(gen, torch.bfloat16, 64, 512, 256)
    sg, su, sd = (t.reshape(-1).float().contiguous() for t in (sg, su, sd))
    ops = _build.ops()
    plan = fm.fused_mlp_plan(64, 512, 256, torch.bfloat16)
    out = torch.empty_like(x)
    h = torch.empty((64, 256), dtype=torch.bfloat16, device="cuda")
    gp = torch.empty((2 * plan.gate_up.splits, 64, 256), device="cuda")
    dp = torch.empty((plan.down.splits, 64, 512), device="cuda")
    good = fm._phase_ints(plan.gate_up) + fm._phase_ints(plan.down)
    ops.fused_mlp(x, wg, sg, wu, su, wd, sd, out, h, gp, dp, good)
    bad_cover = list(good)
    bad_cover[3] = 1  # one slice a split: 8 slices are not covered
    with pytest.raises(ValueError, match="do not cover"):
        ops.fused_mlp(x, wg, sg, wu, su, wd, sd, out, h, gp, dp, bad_cover)
    bad_ring = list(good)
    bad_ring[1] = 3  # not the ring the kernel is built with
    with pytest.raises(RuntimeError, match="invalid argument"):
        ops.fused_mlp(x, wg, sg, wu, su, wd, sd, out, h, gp, dp, bad_ring)


def _decode_inputs(gen, cache, qdtype, group, hd, *, B=5, KVH=2, S=600):
    """A strided cache view (layer 1 of 2, S cut from 700), lengths 0, 1,
    full, a non-multiple of the 256-position split, and 511."""
    full_k, full_v = (torch.randn((2, B, KVH, 700, hd), generator=gen, device="cuda")
                      for _ in range(2))
    ks = vs = None
    if cache.startswith("int8") or cache == "fp8":
        from flash_attention_softmax_n_tpu_torch.quant.kv_cache import quantize_kv
        bits = -8 if cache == "fp8" else 8
        (kv, ksf), (vv, vsf) = quantize_kv(full_k, bits), quantize_kv(full_v, bits)
        k, v = kv[1, :, :, :S], vv[1, :, :, :S]
        ks, vs = ksf[1, :, :, :S], vsf[1, :, :, :S]
    else:
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        k, v = full_k.to(dt)[1, :, :, :S], full_v.to(dt)[1, :, :, :S]
    assert not k.is_contiguous()
    q = torch.randn((B, KVH, group, hd), generator=gen, device="cuda") * hd ** -0.5
    lengths = torch.tensor([0, 1, S, 257, 511][:B], device="cuda", dtype=torch.int32)
    return q, k, v, ks, vs, lengths


def _prep_q(q, cache, qdtype):
    if cache == "int8_compute":
        absmax = q.abs().amax(-1, keepdim=True)
        scales = torch.where(absmax == 0, 1.0, absmax / 127.0)
        return torch.clamp(torch.round(q / scales), -128, 127).to(torch.int8), scales
    return q.to(qdtype), None


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "int8_compute", "fp8"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gh", [(1, 64), (4, 128), (8, 64), (16, 32)])
def test_decode_attn_matches_plain(gen, cache, qdtype, gh):
    group, hd = gh
    q, k, v, ks, vs, lengths = _decode_inputs(gen, cache, qdtype, group, hd)
    qv, qs = _prep_q(q, cache, qdtype)
    before = _build.LAUNCHES["decode_attn"]
    acc, m, l = da._decode_attn_cuda(qv, qs, k, v, lengths, ks, vs)
    assert _build.LAUNCHES["decode_attn"] == before + 1
    again = da._decode_attn_cuda(qv, qs, k, v, lengths, ks, vs)
    assert all(torch.equal(a, b) for a, b in zip((acc, m, l), again))
    acc_r, m_r, l_r = da.decode_attn_stats_reference(qv, qs, k, v, lengths, ks, vs)
    # slot 0 holds nothing: (0, NEG_INF, 0) exactly
    assert torch.equal(acc[0], torch.zeros_like(acc[0]))
    assert bool((m[0] == da.NEG_INF).all()) and bool((l[0] == 0).all())
    live = lengths > 0
    torch.testing.assert_close(m[live], m_r[live], atol=1e-4, rtol=0)
    torch.testing.assert_close(l[live], l_r[live], atol=0, rtol=1e-4)
    out, out_r = acc[live] / l[live][..., None], acc_r[live] / l_r[live][..., None]
    exact = cache == "f32" and qdtype == torch.float32
    torch.testing.assert_close(out, out_r, atol=1e-5 if exact else 2e-2, rtol=0)


@pytest.mark.parametrize("cache", ["bf16", "int8", "fp8"])
def test_decode_attn_reads_only_valid_rows(gen, cache):
    q, k, v, ks, vs, lengths = _decode_inputs(gen, cache, torch.bfloat16, 8, 64)
    qv, _ = _prep_q(q, cache, torch.bfloat16)
    want = da._decode_attn_cuda(qv, None, k, v, lengths, ks, vs)
    # poison every row at or past a slot's length: the statistics must not move
    pos = torch.arange(k.shape[2], device="cuda")
    dead = (pos[None, :] >= lengths[:, None].long())[:, None, :, None]
    if cache in ("int8", "fp8"):
        ks, vs = (torch.where(dead, float("nan"), s) for s in (ks, vs))
    else:
        k, v = (torch.where(dead, float("nan"), t).to(t.dtype) for t in (k, v))
    got = da._decode_attn_cuda(qv, None, k, v, lengths, ks, vs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("cache", ["int8", "fp8"])
def test_decode_attention_n_pallas_route_end_to_end(gen, monkeypatch, cache):
    # the whole op (epilogue with tail, self-term and +n) through K8 against
    # the same op with the plain statistics
    B, KVH, G, hd, W = 4, 2, 4, 64, 16
    q0, k, v, ks, vs, lengths = _decode_inputs(gen, cache, torch.bfloat16, G, hd, B=B)
    q = q0.reshape(B, KVH * G, hd).to(torch.bfloat16)
    kn, vn = (torch.randn((B, KVH, hd), generator=gen, device="cuda") for _ in range(2))
    kt, vt = (torch.randn((B, KVH, W, hd), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    tl = torch.tensor([3, 0, 16, 1], device="cuda", dtype=torch.int32)
    kw = dict(k_scales=ks, v_scales=vs, softmax_n_param=1.0, k_new=kn, v_new=vn,
              k_tail=kt, v_tail=vt, tail_lengths=tl)
    got = da.decode_attention_n(q, k, v, lengths, **kw)
    monkeypatch.setattr(da, "_decode_attn_cuda", da.decode_attn_stats_reference)
    want = da.decode_attention_n(q, k, v, lengths, **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


def test_decode_attn_rejects_fp8_int8_compute(gen):
    q, k, v, ks, vs, lengths = _decode_inputs(gen, "fp8", torch.bfloat16, 4, 64)
    with pytest.raises(ValueError, match="int8 cache"):
        da._decode_attn_cuda(*_prep_q(q, "int8_compute", None), k, v, lengths, ks, vs)
    with pytest.raises(ValueError, match="scales"):
        da._decode_attn_cuda(q.to(torch.bfloat16), None, k, v, lengths, None, None)


# the split lengths the plan takes at the serving shapes: serve_fp8's fused
# loop (B8 over a 256-row window) and step path (B2 over 512 rows), and
# serve_pallas's B64 over 512 rows with int8
@pytest.mark.parametrize("case", [(8, 256, "fp8", 32), (2, 512, "fp8", 32),
                                  (64, 512, "int8", 256)], ids=lambda c: "-".join(map(str, c)))
def test_decode_attn_at_planned_splits(gen, case):
    B, S, cache, split = case
    KVH, G, hd = 4, 8, 64
    assert da.decode_attn_plan(B, KVH, S, hd, 1, False) == split
    assert B * KVH * -(-S // split) >= 128  # at least about one CTA per SM
    full = [torch.randn((2, B, KVH, S, hd), generator=gen, device="cuda") for _ in range(2)]
    from flash_attention_softmax_n_tpu_torch.quant.kv_cache import quantize_kv
    (kq, ksf), (vq, vsf) = (quantize_kv(t, -8 if cache == "fp8" else 8) for t in full)
    k, v, ks, vs = kq[1], vq[1], ksf[1], vsf[1]
    q = (torch.randn((B, KVH, G, hd), generator=gen, device="cuda") * hd ** -0.5)
    qv = q.to(torch.bfloat16)
    lengths = torch.randint(0, S + 1, (B,), generator=gen, device="cuda").to(torch.int32)
    lengths[0], lengths[-1] = 0, S
    got = da._decode_attn_cuda(qv, None, k, v, lengths, ks, vs)
    again = da._decode_attn_cuda(qv, None, k, v, lengths, ks, vs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    acc, m, l = got
    acc_r, m_r, l_r = da.decode_attn_stats_reference(qv, None, k, v, lengths, ks, vs)
    live = lengths > 0
    assert torch.equal(acc[~live], torch.zeros_like(acc[~live]))
    assert bool((m[~live] == da.NEG_INF).all()) and bool((l[~live] == 0).all())
    torch.testing.assert_close(m[live], m_r[live], atol=1e-4, rtol=0)
    torch.testing.assert_close(l[live], l_r[live], atol=0, rtol=1e-4)
    torch.testing.assert_close(acc[live] / l[live][..., None],
                               acc_r[live] / l_r[live][..., None], atol=2e-2, rtol=0)


def _decode_direct(qv, qs, k, v, ks, vs, lengths, split, products):
    """K8's operator called with a plan of the caller's: (acc, m, l)"""
    B, KVH, G, hd = qv.shape
    n = -(-k.shape[2] // split)
    outs = [torch.empty(s, device="cuda") for s in ((B, KVH, G, hd), (B, KVH, G), (B, KVH, G),
                                                     (B, KVH, n, G, hd), (B, KVH, n, G),
                                                     (B, KVH, n, G))]
    _build.ops().decode_attn(qv, qs, k, v, ks, vs, lengths, *outs, split, products)
    return outs[:3]


def _assert_decode_close(got, qv, qs, k, v, ks, vs, lengths, atol):
    acc, m, l = got
    acc_r, m_r, l_r = da.decode_attn_stats_reference(qv, qs, k, v, lengths, ks, vs)
    live = lengths > 0
    assert torch.equal(acc[~live], torch.zeros_like(acc[~live]))
    assert bool((m[~live] == da.NEG_INF).all()) and bool((l[~live] == 0).all())
    torch.testing.assert_close(m[live], m_r[live], atol=1e-4, rtol=0)
    torch.testing.assert_close(l[live], l_r[live], atol=0, rtol=1e-4)
    torch.testing.assert_close(acc[live] / l[live][..., None],
                               acc_r[live] / l_r[live][..., None], atol=atol, rtol=0)


@pytest.mark.parametrize("products", [da.FMA, da.MMA], ids=["fma", "mma"])
@pytest.mark.parametrize("split", da.SPLITS)
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "fp8"])
def test_decode_attn_every_split_length(gen, split, cache, products):
    # each split length the kernel takes, called with it directly, with
    # either product design where it applies (an f32 cache: FMAs only)
    q, k, v, ks, vs, lengths = _decode_inputs(gen, cache, torch.bfloat16, 8, 64)
    qv = q.to(torch.bfloat16)
    if cache == "f32" and products == da.MMA:
        with pytest.raises(ValueError, match="not a plan"):
            _decode_direct(qv, None, k, v, ks, vs, lengths, split, products)
        return

    def run():
        return _decode_direct(qv, None, k, v, ks, vs, lengths, split, products)

    (acc, m, l), again = run(), run()
    assert all(torch.equal(a, b) for a, b in zip((acc, m, l), again))
    acc_r, m_r, l_r = da.decode_attn_stats_reference(qv, None, k, v, lengths, ks, vs)
    live = lengths > 0
    torch.testing.assert_close(m[live], m_r[live], atol=1e-4, rtol=0)
    torch.testing.assert_close(l[live], l_r[live], atol=0, rtol=1e-4)
    torch.testing.assert_close(acc[live] / l[live][..., None],
                               acc_r[live] / l_r[live][..., None], atol=2e-2, rtol=0)


# head dims above 128 (Gemma-2B's 256 among them), as planned: 32-position
# splits, and 16 where a row is 1 KB or more (f32 at hd 256, bf16 and f32
# at hd 512: 32 positions of them no longer fit 48 KB); against the plain version, repeats
# bit-equal. Int8 compute keeps the Pallas kernel's 256-position tile at
# every hd: above about hd 400 its k and v rows (270 KB at hd 512) do not
# fit a block, and decode_attn_int8c_kernel brings them in sub-tiles (int32
# sums, exact past hd 1024, as at 1152; at 520 rows copied element by
# element)
@pytest.mark.parametrize("hd", [160, 256, 512, 520, 1152])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "int8_compute", "fp8"])
def test_decode_attn_wide_head_dims(gen, hd, cache):
    q, k, v, ks, vs, lengths = _decode_inputs(gen, cache, torch.bfloat16, 8, hd, B=4, S=600)
    qv, qs = _prep_q(q, cache, torch.bfloat16)
    if cache != "int8_compute":
        want = 16 if hd * k.element_size() >= 1024 else 32
        assert da.decode_attn_plan(4, 2, 600, hd, k.element_size(), False) == want
    got = da._decode_attn_cuda(qv, qs, k, v, lengths, ks, vs)
    assert all(torch.equal(a, b)
               for a, b in zip(got, da._decode_attn_cuda(qv, qs, k, v, lengths, ks, vs)))
    _assert_decode_close(got, qv, qs, k, v, ks, vs, lengths,
                         1e-5 if cache == "f32" and qv.dtype == torch.float32 else 2e-2)


def test_decode_attn_int8_compute_keeps_256_position_splits(gen):
    q, k, v, ks, vs, lengths = _decode_inputs(gen, "int8_compute", None, 8, 64)
    qv, qs = _prep_q(q, "int8_compute", None)
    B, KVH, G, hd = qv.shape
    assert da.decode_attn_plan(64, 4, 256, hd, 1, True) == 256  # even where 32 fills the card
    assert da.decode_attn_products(qv.dtype, k.dtype, hd) == da.FMA
    with pytest.raises(ValueError, match="split of 32"):
        _decode_direct(qv, qs.reshape(B, KVH, G), k, v, ks, vs, lengths, 32, da.FMA)
    with pytest.raises(ValueError, match="products 1"):  # integer products stay FMAs
        _decode_direct(qv, qs.reshape(B, KVH, G), k, v, ks, vs, lengths, 256, da.MMA)


# views the 16-byte copies cannot take (rows of 34 or 42 values, no
# multiple of 16 bytes in any cache type; a base one element off 16 bytes):
# K8 copies them element by element into the same shared layout, zero past
# hd (the offset view at hd 64 takes the mma products with bf16 q)
@pytest.mark.parametrize("view", ["hd34", "hd42", "offset"])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_decode_attn_element_copies(gen, cache, view):
    hd = {"hd34": 34, "hd42": 42, "offset": 64}[view]
    qdtype = torch.float32 if cache == "f32" else torch.bfloat16
    q, k, v, ks, vs, lengths = _decode_inputs(gen, cache, qdtype, 8, hd)
    if view == "offset":
        # the same values in a buffer one element longer, viewed from its
        # second element
        def shift(t):
            flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device="cuda")
            flat[1:] = t.reshape(-1)
            return flat[1:].view(t.shape)
        k, v = shift(k.contiguous()), shift(v.contiguous())
        assert k.data_ptr() % 16 != 0
    else:
        assert (hd * k.element_size()) % 16 != 0
    qv, _ = _prep_q(q, cache, qdtype)
    got = da._decode_attn_cuda(qv, None, k, v, lengths, ks, vs)
    again = da._decode_attn_cuda(qv, None, k, v, lengths, ks, vs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _assert_decode_close(got, qv, None, k, v, ks, vs, lengths,
                         1e-5 if cache == "f32" else 2e-2)


# both product designs at the serving lines' shape (G 8, hd 64): each
# against the plain version, and the two within the same tolerance
@pytest.mark.parametrize("cache", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("split", [32, 256])
def test_decode_attn_products_agree(gen, cache, split):
    q, k, v, ks, vs, lengths = _decode_inputs(gen, cache, torch.bfloat16, 8, 64)
    qv = q.to(torch.bfloat16)
    assert da.decode_attn_products(qv.dtype, k.dtype, 64) == da.MMA
    fma = _decode_direct(qv, None, k, v, ks, vs, lengths, split, da.FMA)
    mma = _decode_direct(qv, None, k, v, ks, vs, lengths, split, da.MMA)
    for got in (fma, mma):
        _assert_decode_close(got, qv, None, k, v, ks, vs, lengths, 2e-2)
    live = lengths > 0
    torch.testing.assert_close(mma[0][live] / mma[2][live][..., None],
                               fma[0][live] / fma[2][live][..., None], atol=2e-2, rtol=0)


# ----------------------------------------------------------------------------
# K10 (the prefill-phase kernel)
# ----------------------------------------------------------------------------


# head dims K10 is not built for (80 at 128, 320 at 384) run zero-padded;
# in bf16, 256 on its D 256 kernel and 384 (for 320) and 512 on its wide
# TMA + wgmma one, which must be the ones launched; f32 on its scalar and
# wide scalar kernels
_MINI_KERNELS = {256: "prefill_phase_d256_kernel", 384: "prefill_phase_wide_wgmma_kernel",
                 512: "prefill_phase_wide_wgmma_kernel"}


@pytest.mark.parametrize("mode", pp.MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 80, 256, 320, 512])
@pytest.mark.parametrize("L", [64, 129, 200, 512, 2048])
def test_prefill_phase_matches_plain(gen, mode, dtype, d, L):
    q, k, v = ((0.3 * torch.randn((2, 3, L, d), generator=gen, device="cuda")).to(dtype)
               for _ in range(3))
    before = _build.LAUNCHES[f"mini_{mode}"]
    out, names, calls = _launched(lambda: pp.mini(mode, q, k, v))
    assert _build.LAUNCHES[f"mini_{mode}"] == before + calls
    kernel = _MINI_KERNELS.get(fa.kernel_head_dim(d)) if dtype == torch.bfloat16 else None
    if kernel is not None:
        assert any(kernel in n for n in names), (kernel, sorted(set(names)))
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, pp.mini(mode, q, k, v))
    ref = pp.mini_reference(mode, q, k, v)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    else:
        assert bool((diff <= pp.mini_tolerance(mode, q, k, v, ref)).all())


def test_prefill_phase_rejects_what_it_does_not_take(gen):
    # every head dim runs (zero-padded by the wrapper); shapes and modes are
    # still refused
    q = torch.randn((1, 2, 64, 64), device="cuda")
    with pytest.raises(ValueError, match="prefill_phase"):
        pp.mini("softmax", q, q[:, :, :32], q)
    with pytest.raises(ValueError, match="unknown mode"):
        pp.mini("relu", q, q, q)


# ----------------------------------------------------------------------------
# fp8 weights and KV caches through the decoder on the card
# ----------------------------------------------------------------------------


def _decode_logits(params, cfg, tokens, kv, dev):
    """prefill, then three decode steps on fixed tokens; the logits"""
    from flash_attention_softmax_n_tpu_torch import models as tm

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, qt.QTensor):
            return qt.QTensor(x.values.to(dev), x.scales.to(dev), bits=x.bits)
        return x.to(dev)

    p = to(params)
    cache = tm.init_kv_cache(cfg, tokens.shape[0], max_len=16, quantization=kv,
                             device=dev)
    out, cache = tm.prefill(p, cfg, tokens.to(dev), cache)
    outs, tok = [out], torch.argmax(out, -1)
    for _ in range(3):
        out, cache = tm.decode_step(p, cfg, tok, cache)
        outs.append(out)
    return torch.stack(outs).cpu()


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_decode_steps_with_quantized_cache_match_the_cpu(gen, kv):
    # fp8 weights; prefill (K1, head dim 64) and decode_step write the cache
    # rows by slices and attend through cached_attention_quantized; f32,
    # logits within 1e-4 of the same calls on the CPU (summation order)
    from flash_attention_softmax_n_tpu_torch import models as tm
    from flash_attention_softmax_n_tpu_torch.quant.weights import (
        quantize_decoder_weights,
    )
    cfg = tm.DecoderConfig(vocab_size=97, d_model=256, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_ff=256, max_seq_len=128,
                           dtype=torch.float32)
    params = quantize_decoder_weights(tm.init_decoder_params(cfg, 0, device="cpu"),
                                      bits=-8)
    tokens = torch.randint(0, 97, (2, 11), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(_decode_logits(params, cfg, tokens, kv, "cuda"),
                               _decode_logits(params, cfg, tokens, kv, "cpu"),
                               atol=1e-4, rtol=0)


# K7's f32 mode with grouped int4 weights at BERT-base's three matmul shapes
# (K768: three 256-row groups; K3072), as bert_forward launches it on an
# int4 tree in f32
@pytest.mark.parametrize("kn", [(768, 768), (768, 3072), (3072, 768)],
                         ids=lambda c: "-".join(map(str, c)))
def test_qmm_f32_int4_at_bert_shapes(gen, kn):
    k, n = kn
    x = torch.randn((512, k), generator=gen, device="cuda")
    wv, ws = _qweight(gen, k, n, 4)
    assert qm.qmm_plan(512, k, n, "f32").kernel == "simt"
    before = _build.LAUNCHES["qmm"]
    out = qm.quantized_matmul(x, wv, ws, bits=4)
    assert _build.LAUNCHES["qmm"] == before + 1
    assert torch.equal(out, qm.quantized_matmul(x, wv, ws, bits=4))
    ref = qm.quantized_matmul_reference(x, None, wv, ws, bits=4, out_dtype=torch.float32)
    torch.testing.assert_close(out, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)


# K7's f32 mode beyond BERT's shapes: int8 W at decode (M64, split K) and
# at an admission group (M1024, 128-row tiles), ragged shapes that take the
# cp.async loader (N200: W's rows off 16 bytes; N131 and K100: W's rows off
# 4 bytes, x's off 16), and bf16 out (one bf16 ulp of the plain output on
# top of 1e-5 max|ref|)
_QMM_F32_CASES = [(64, 2048, 2048, 8, "f32", "tma"), (1024, 2048, 2048, 8, "f32", "tma"),
                  (300, 776, 200, 8, "f32", "cp.async"), (300, 768, 200, 4, "f32", "cp.async"),
                  (129, 100, 131, 8, "f32", "cp.async"), (4096, 768, 768, 4, "bf16", "tma"),
                  (300, 776, 200, 8, "bf16", "cp.async")]


@pytest.mark.parametrize("case", _QMM_F32_CASES, ids=lambda c: "-".join(map(str, c)))
def test_qmm_f32_matches_plain(gen, case):
    m, k, n, bits, out, producer = case
    od = torch.float32 if out == "f32" else torch.bfloat16
    x = torch.randn((m, k), generator=gen, device="cuda")
    wv, ws = _qweight(gen, k, n, bits)
    plan = qm.qmm_plan(m, k, n, "f32")
    assert (plan.kernel, plan.producer) == ("simt", producer)
    before = _build.LAUNCHES["qmm"]
    got = qm.quantized_matmul(x, wv, ws, bits=bits, out_dtype=od)
    assert _build.LAUNCHES["qmm"] == before + 1
    assert torch.equal(got, qm.quantized_matmul(x, wv, ws, bits=bits, out_dtype=od))
    ref = qm.quantized_matmul_reference(x, None, wv, ws, bits=bits, out_dtype=od)
    assert got.dtype == od and got.shape == (m, n)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-5 * float(ref.float().abs().max()),
                               rtol=0 if od == torch.float32 else 2.0 ** -7)


def test_bert_int4_on_the_card_is_its_dequantized_tree(gen):
    # an f32 BERT with int4 weights (every matmul's K % 256 == 0) runs K7's
    # f32 mode, six launches a layer; held against plain f32 matmuls over the
    # same weights dequantized (relative 1e-3: f32 on GPU)
    from flash_attention_softmax_n_tpu_torch.models import bert as tb
    from flash_attention_softmax_n_tpu_torch.quant.weights import quantize_bert_weights
    cfg = tb.BertConfig(vocab_size=1000, d_model=768, n_layers=2, n_heads=12, d_ff=3072,
                        softmax_n=1.0)
    params = quantize_bert_weights(tb.init_bert_params(cfg, gen, device="cuda"), bits=4)
    deq = dict(params, layers={k: qt.dequantize(v) if isinstance(v, qt.QTensor) else v
                               for k, v in params["layers"].items()})
    ids = torch.randint(0, 1000, (2, 64), generator=gen, device="cuda")
    mask = torch.ones((2, 64), device="cuda")
    mask[1, 40:] = 0
    before = _build.LAUNCHES["qmm"]
    got = tb.bert_forward(params, cfg, ids, mask)["last_hidden_state"]
    assert _build.LAUNCHES["qmm"] == before + 6 * cfg.n_layers
    want = tb.bert_forward(deq, cfg, ids, mask)["last_hidden_state"]
    assert _build.LAUNCHES["qmm"] == before + 6 * cfg.n_layers
    assert float((got - want).abs().max() / want.abs().max()) < 1e-3


def test_decoder_taps_on_the_card_match_the_cpu(gen):
    # bf16, 2 layers: the taps and logits of decoder_forward(collect_taps)
    # through K1 on the card against the same on the CPU (K1's plain
    # version), within bf16 tolerance (2e-2 of the largest magnitude); the
    # materializing output_attentions path launches no K1
    from flash_attention_softmax_n_tpu_torch import models as tm
    cfg = tm.DecoderConfig(vocab_size=97, d_model=256, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_ff=512, max_seq_len=128, dtype=torch.bfloat16)
    params = tm.init_decoder_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, 97, (2, 64), generator=torch.Generator().manual_seed(1))
    cuda = {k: (v.cuda() if isinstance(v, torch.Tensor) else {n: w.cuda() for n, w in v.items()})
            for k, v in params.items()}
    before = _build.LAUNCHES["flash_fwd"]
    logits, taps = tm.decoder_forward(cuda, cfg, tokens.cuda(), collect_taps=True)
    assert _build.LAUNCHES["flash_fwd"] == before + cfg.n_layers
    ref_logits, ref_taps = tm.decoder_forward(params, cfg, tokens, collect_taps=True)
    for got, want in [(logits, ref_logits), *((taps[n], ref_taps[n]) for n in ref_taps)]:
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float().cpu(), want.float(), atol=2e-2 * scale, rtol=0)
    _, probs = tm.decoder_forward(cuda, cfg, tokens.cuda(), output_attentions=True)
    assert _build.LAUNCHES["flash_fwd"] == before + cfg.n_layers
    assert tuple(probs.shape) == (2, 2, 4, 64, 64)


# ----------------------------------------------------------------------------
# multi-device training: the ring's schedule and the meshed kernel
# ----------------------------------------------------------------------------


def _ring_schedule(q, k, v, do, *, p, n, scale):
    """All p ranks' ring schedules in one process, through the package's
    per-rank step functions: (o, lse, dq, dk, dv) over the whole sequence
    and the K1/K5/K6 launches they made."""
    from flash_attention_softmax_n_tpu_torch.parallel import ring_attention as ra
    shard = lambda x: list(x.chunk(p, dim=2))  # noqa: E731
    qs, ks, vs, dos = shard(q), shard(k), shard(v), shard(do)
    _build.reset_launches()
    outs, lses = [], []
    for my in range(p):
        state = ra.ring_init(qs[my], vs[my])
        for t in range(p):
            owner = (my - t) % p
            state = ra.ring_fold(state, ra.ring_block_forward(
                qs[my], ks[owner], vs[owner], mode=ra.block_mode(True, p, my, t),
                scale=scale, implementation="pallas"))
        o, lse = ra.ring_finish(state, n, q.dtype)
        outs.append(o)
        lses.append(lse)
    dq = [torch.zeros_like(x, dtype=torch.float32) for x in qs]
    dk = [torch.zeros_like(x, dtype=torch.float32) for x in ks]
    dv = [torch.zeros_like(x, dtype=torch.float32) for x in vs]
    for my in range(p):
        delta = torch.sum(dos[my].float() * outs[my].float(), dim=-1)
        for t in range(p):
            owner = (my - t) % p
            g = ra.ring_block_backward(
                qs[my], ks[owner], vs[owner], outs[my], dos[my], lses[my], delta,
                mode=ra.block_mode(True, p, my, t), scale=scale,
                implementation="pallas")
            if g is not None:
                dq[my] += g[0]
                dk[owner] += g[1]
                dv[owner] += g[2]
    torch.cuda.synchronize()
    launches = {k_: _build.LAUNCHES[k_]
                for k_ in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    cat = lambda xs, dt: torch.cat(xs, dim=2).to(dt)  # noqa: E731
    return (cat(outs, q.dtype), torch.cat(lses, dim=2), cat(dq, q.dtype),
            cat(dk, k.dtype), cat(dv, v.dtype), launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_schedule_matches_single_device(gen, dtype):
    B, H, KVH, L, D, p, n = 1, 8, 2, 1024, 64, 4, 1.0
    q, do = (torch.randn((B, H, L, D), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, KVH, L, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = D ** -0.5
    o, lse, dq, dk, dv, launches = _ring_schedule(q, k, v, do, p=p, n=n,
                                                  scale=scale)
    # p = 4 causal: 10 blocks launch (6 full, 4 diagonal), 6 are skipped
    assert launches == {"flash_fwd": 10, "flash_bwd_dq": 10, "flash_bwd_dkv": 10}
    rep = H // KVH
    kr, vr = (x.repeat_interleave(rep, dim=1) for x in (k, v))
    o1, lse1 = fa.flash_fwd(q, kr, vr, None, n=n, scale=scale, is_causal=True)
    dq1, dk1, dv1, _, _ = fa.flash_bwd(q, kr, vr, None, None, None, o1, lse1, do,
                                       scale=scale, is_causal=True)
    group = lambda g: g.float().reshape(B, KVH, rep, L, D).sum(2)  # noqa: E731
    f32 = dtype == torch.float32
    # bf16: the ring rounds each block's o and gradients to bf16 once more
    otol, gtol = (2e-5, 1e-4) if f32 else (2e-2, 1e-2)
    assert float((o.float() - o1.float()).abs().max()) <= otol
    assert float((lse - lse1).abs().max()) <= (1e-4 if f32 else 1e-3)
    for got, want in ((dq, dq1.float()), (dk, group(dk1)), (dv, group(dv1))):
        err = float((got.float() - want).norm()) / max(1.0, float(want.norm()))
        assert err <= gtol, err


class _MeshStandIn:
    """The coordinates of one rank of {"data": 2, "model": 4}: what
    ``flash_attention_n(mesh=)`` reads when no bias needs its cotangent
    summed."""

    mesh_dim_names = ("data", "model")
    mesh = torch.zeros((2, 4))

    def __init__(self, rank):
        self.coord = {"data": rank // 4, "model": rank % 4}

    def get_local_rank(self, name):
        return self.coord[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meshed_dropout_bit_equal_to_unmeshed(gen, dtype):
    from flash_attention_softmax_n_tpu_torch.ops.flash_attention import (
        flash_attention_n,
    )
    B, H, L, D = 4, 8, 256, 64
    q, k, v = (torch.randn((B, H, L, D), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    kw = dict(softmax_n_param=1.0, is_causal=True, dropout_p=0.35,
              dropout_seed=torch.tensor(-424242, dtype=torch.int32),
              implementation="pallas")
    whole = flash_attention_n(q, k, v, **kw)
    for rank in range(8):
        d, m = divmod(rank, 4)
        cut = lambda x: x[2 * d:2 * d + 2, 2 * m:2 * m + 2]  # noqa: E731
        slab = flash_attention_n(cut(q), cut(k), cut(v), mesh=_MeshStandIn(rank),
                                 **kw)
        torch.cuda.synchronize()
        assert torch.equal(slab, cut(whole)), rank


# ----------------------------------------------------------------------------
# serving over {"data": 2, "model": 4} at TinyLlama-1.1B's widths: the shapes
# each of 8 cards launches (32 slots, 1 KV head and 8 query heads a rank)
# ----------------------------------------------------------------------------


# None: random rows; else the columns of a tie planted in every row, across
# shards 1 and 3 (and within 3), and across shards 0, 1 and 3
@pytest.mark.parametrize("ties", [None, [24001, 8005, 24003], [8005, 31999, 7999]],
                         ids=["random", "tie_1_3", "tie_0_1_3"])
def test_vocab_shard_merge_equals_whole_vocab(gen, ties):
    # K2 on each of four 8000-column shards, the index offset and the
    # engine's merge, against K2 over all 32000 columns on the same rows.
    # K is never split, so a column's value is bit-equal either way; a tie
    # takes the lowest global column
    from flash_attention_softmax_n_tpu_torch.engine.engine import (
        _merge_shard_argmax,
    )
    m, k, n, tp = 32, 2048, 32000, 4
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    s = torch.rand((n,), generator=gen, device="cuda") + 0.5
    if ties is not None:
        x, w, s = torch.ones_like(x), torch.zeros_like(w), torch.ones_like(s)
        w[:, ties] = 1
    whole = qm.quantized_matmul_argmax(x, w, s)
    part = n // tp
    vals, idxs = [], []
    for r in range(tp):
        cols = slice(r * part, (r + 1) * part)
        idx, val = qm.quantized_matmul_argmax(x, w[:, cols].contiguous(),
                                              s[cols].contiguous(), return_max=True)
        vals.append(val.double())
        idxs.append(idx + r * part)
    merged = _merge_shard_argmax(torch.stack(vals), torch.stack(idxs).to(torch.int32))
    assert torch.equal(merged, whole)
    if ties is not None:
        assert merged.tolist() == [min(ties)] * m


def test_cache_rows_at_a_ranks_shard(gen):
    # K3 at NL22 B32 KVH1 S512 D64 int8 with its scales (the engine's
    # four-tensor call), K4 at NL22 B32 KVH1 W64 D64 bf16
    caches, news = [], []
    for _ in range(2):
        caches += [_kv_rows(gen, (22, 32, 1, 512, 64), torch.int8),
                   _kv_rows(gen, (22, 32, 1, 512, 1), torch.float32)]
        news += [_kv_rows(gen, (22, 32, 1, 64), torch.int8),
                 _kv_rows(gen, (22, 32, 1, 1), torch.float32)]
    pos = torch.randint(0, 512, (32,), generator=gen, device="cuda").to(torch.int32)
    got, want = _append_both(caches, news, pos)
    assert all(_bytes_equal(a, b) for a, b in zip(got, want))
    kt, vt = (torch.randn((22, 32, 1, 64, 64), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    ref = (kt.clone(), vt.clone())
    for i in (0, 31, 63):
        kn, vn = (torch.randn((22, 32, 1, 64), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        cu.tail_append(kt, vt, kn, vn, i)
        cu.tail_append_reference(*ref, kn, vn, i)
    assert torch.equal(kt, ref[0]) and torch.equal(vt, ref[1])


# (K, N): wq, wk/wv, gate/up on the rank's columns; wo, w_down on its rows
@pytest.mark.parametrize("kn", [(2048, 512), (2048, 64), (2048, 1408), (512, 2048),
                                (1408, 2048)], ids=lambda c: "-".join(map(str, c)))
def test_qmm_at_a_ranks_shard(gen, kn):
    k, n = kn
    x = torch.randn((32, k), generator=gen, device="cuda").to(torch.bfloat16)
    wv, ws = _qweight(gen, k, n, 8)
    out = qm.quantized_matmul(x, wv, ws, bits=8)
    assert torch.equal(out, qm.quantized_matmul(x, wv, ws, bits=8))
    ref = qm.quantized_matmul_reference(x, None, wv, ws, bits=8, out_dtype=torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=1e-5 * float(ref.float().abs().max()))


def test_decode_attn_at_a_ranks_heads(gen):
    # B32 KVH1 G8 S512 over an int8 cache, bf16 q
    q, k, v, ks, vs, _ = _decode_inputs(gen, "int8", torch.bfloat16, 8, 64, B=32,
                                        KVH=1, S=512)
    lengths = torch.randint(0, 513, (32,), generator=gen, device="cuda").to(torch.int32)
    qv = q.to(torch.bfloat16)
    acc, m, l = da._decode_attn_cuda(qv, None, k, v, lengths, ks, vs)
    acc_r, m_r, l_r = da.decode_attn_stats_reference(qv, None, k, v, lengths, ks, vs)
    live = lengths > 0
    torch.testing.assert_close(m[live], m_r[live], atol=1e-3, rtol=0)
    torch.testing.assert_close(l[live], l_r[live], atol=0, rtol=1e-3)
    torch.testing.assert_close(acc[live] / l[live][..., None],
                               acc_r[live] / l_r[live][..., None], atol=2e-2, rtol=0)


def test_fused_mlp_at_a_ranks_d_ff(gen):
    # K9 at M32 K2048 F1408 (a quarter of d_ff 5632)
    args = _mlp_inputs(gen, torch.bfloat16, 32, 2048, 1408)
    out = fm.fused_mlp_matmul(*args)
    assert torch.equal(out, fm.fused_mlp_matmul(*args))
    ref = fm.fused_mlp_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=2e-2 * float(ref.float().abs().max()))
    _assert_norm_close(out, ref, 1e-2)


# ----------------------------------------------------------------------------
# Llama-7B's serving shapes (head dim 128, 32 heads over 32 KV heads: G = 1;
# d 4096, d_ff 11008, vocab 32000) and Llama-3-8B's where its kernels differ
# (8 KV heads: G = 4; d_ff 14336; vocab 128256): the serve_7b path
# ----------------------------------------------------------------------------


def test_flash_fwd_at_7b_admission(gen):
    # K1 over one admission group: B8 H32 L=S=128 d128 bf16 under the
    # engine's mask (key j visible iff j < true_len and j <= i) as a
    # (B, 1, L, S) bias, the causal flag off
    from flash_attention_softmax_n_tpu_torch.ops import flash_attention as ofa
    B, H, L, d = 8, 32, 128, 128
    q, k, v = (torch.randn((B, H, L, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    true_lens = torch.randint(16, L + 1, (B,), generator=gen, device="cuda")
    kpos = torch.arange(L, device="cuda")
    visible = ((kpos[None, None, :] < true_lens[:, None, None])
               & (kpos[None, :] <= kpos[:, None])[None])
    bias = ofa._mask_to_bias(visible[:, None])
    kw = dict(n=1.0, scale=d ** -0.5, is_causal=False)
    got = fa.flash_fwd(q, k, v, bias, **kw)
    _check_bf16_fwd(got, fa.flash_fwd_reference(q, k, v, bias, **kw))
    again = fa.flash_fwd(q, k, v, bias, **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("cache", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("b_kvh_g", [(48, 32, 1), (96, 8, 4)], ids=["7b-g1", "8b-g4"])
def test_decode_attn_at_7b_heads(gen, cache, b_kvh_g):
    # K8 as planned (split length and products) at S512 d128, bf16 q;
    # slot 0 empty, slot 1 full, the rest drawn from 0..S
    B, KVH, G = b_kvh_g
    S, hd = 512, 128
    full_k, full_v = (torch.randn((B, KVH, S, hd), generator=gen, device="cuda")
                      for _ in range(2))
    ks = vs = None
    if cache == "bf16":
        k, v = full_k.to(torch.bfloat16), full_v.to(torch.bfloat16)
    else:
        from flash_attention_softmax_n_tpu_torch.quant.kv_cache import quantize_kv
        bits = -8 if cache == "fp8" else 8
        (k, ks), (v, vs) = quantize_kv(full_k, bits), quantize_kv(full_v, bits)
    q = (torch.randn((B, KVH, G, hd), generator=gen, device="cuda") * hd ** -0.5).to(
        torch.bfloat16)
    lengths = torch.randint(0, S + 1, (B,), generator=gen, device="cuda").to(torch.int32)
    lengths[0], lengths[1] = 0, S
    acc, m, l = da._decode_attn_cuda(q, None, k, v, lengths, ks, vs)
    again = da._decode_attn_cuda(q, None, k, v, lengths, ks, vs)
    assert all(torch.equal(a, b) for a, b in zip((acc, m, l), again))
    acc_r, m_r, l_r = da.decode_attn_stats_reference(q, None, k, v, lengths, ks, vs)
    assert torch.equal(acc[0], torch.zeros_like(acc[0])) and bool((l[0] == 0).all())
    live = lengths > 0
    torch.testing.assert_close(m[live], m_r[live], atol=1e-3, rtol=0)
    torch.testing.assert_close(l[live], l_r[live], atol=0, rtol=1e-3)
    torch.testing.assert_close(acc[live] / l[live][..., None],
                               acc_r[live] / l_r[live][..., None], atol=2e-2, rtol=0)


@pytest.mark.parametrize("mn", [(48, 32000), (96, 128256)], ids=["7b", "8b"])
def test_qmm_argmax_at_7b_vocab(gen, mn):
    # K2 over the lm_head at K4096: 64 stages of 64 rows; at N128256 501
    # column tiles of 256
    m, n = mn
    k = 4096
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    s = (torch.rand((n,), generator=gen, device="cuda") + 0.5) / (127.0 * k ** 0.5)
    idx, val = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    again = qm.quantized_matmul_argmax(x, w, s, return_max=True)
    assert torch.equal(idx, again[0]) and torch.equal(val, again[1])
    idx_ref, val_ref = qm.quantized_matmul_argmax_reference(x, w, s)
    top2 = torch.topk((x.float() @ w.float()) * s, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(idx[decided], idx_ref[decided])
    torch.testing.assert_close(val, val_ref, atol=0, rtol=1e-3)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mkn", [(48, 4096, 4096), (48, 4096, 11008), (48, 11008, 4096),
                                 (1024, 4096, 11008)], ids=lambda c: "-".join(map(str, c)))
def test_qmm_at_7b_shapes(gen, bits, mkn):
    # K7: the projections (the engine fuses none: wq, wk, wv and wo are each
    # K4096 N4096), the MLP's matmuls (int4 takes them to K7 at decode; int8
    # at admission), grouped int4 needing K % 256 == 0 (11008 = 43 * 256)
    m, k, n = mkn
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    wv, ws = _qweight(gen, k, n, bits)
    out = qm.quantized_matmul(x, wv, ws, bits=bits)
    assert torch.equal(out, qm.quantized_matmul(x, wv, ws, bits=bits))
    ref = qm.quantized_matmul_reference(x, None, wv, ws, bits=bits, out_dtype=torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7,
                               atol=1e-5 * float(ref.float().abs().max()))


@pytest.mark.parametrize("f", [11008, 14336])
def test_fused_mlp_at_7b_d_ff(gen, f):
    # K9 at M48 K4096: F11008 = 43 * 256 and F14336 = 56 * 256 gate/up
    # columns, the down product's splits over F
    args = _mlp_inputs(gen, torch.bfloat16, 48, 4096, f)
    plan = fm.fused_mlp_plan(48, 4096, f, torch.bfloat16)
    assert plan.kernel == "wgmma"
    before = _build.LAUNCHES["fused_mlp"]
    out = fm.fused_mlp_matmul(*args)
    assert _build.LAUNCHES["fused_mlp"] == before + 1
    assert torch.equal(out, fm.fused_mlp_matmul(*args))
    ref = fm.fused_mlp_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=2e-2 * float(ref.float().abs().max()))
    _assert_norm_close(out, ref, 1e-2)


def test_cache_rows_at_7b_heads(gen):
    # K3 at B48 KVH32 S512 D128 int8 with its scales (the engine's
    # four-tensor call; 4 of the 32 layers), K4 at B48 KVH32 W64 D128 bf16
    caches, news = [], []
    for _ in range(2):
        caches += [_kv_rows(gen, (4, 48, 32, 512, 128), torch.int8),
                   _kv_rows(gen, (4, 48, 32, 512, 1), torch.float32)]
        news += [_kv_rows(gen, (4, 48, 32, 128), torch.int8),
                 _kv_rows(gen, (4, 48, 32, 1), torch.float32)]
    pos = torch.randint(0, 512, (48,), generator=gen, device="cuda").to(torch.int32)
    got, want = _append_both(caches, news, pos)
    assert all(_bytes_equal(a, b) for a, b in zip(got, want))
    kt, vt = (torch.randn((4, 48, 32, 64, 128), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    ref = (kt.clone(), vt.clone())
    for i in (0, 37, 63):
        kn, vn = (torch.randn((4, 48, 32, 128), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        cu.tail_append(kt, vt, kn, vn, i)
        cu.tail_append_reference(*ref, kn, vn, i)
    assert torch.equal(kt, ref[0]) and torch.equal(vt, ref[1])


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_bench_decode_replays_the_engines_graphs(gen, route):
    # utils/bench_7b.bench_decode at a small head-dim-128 MHA geometry: its
    # graph windows run through the engine's warm_on_side_stream,
    # capture_loop and replay_loop, so K2 (one launch a greedy step) counts
    # 7 windows of 8 steps: two warm-ups, two eager, one on the side stream
    # before capture (both windows are 128 rows) and two replayed
    from flash_attention_softmax_n_tpu_torch.models.decoder import DecoderConfig
    from flash_attention_softmax_n_tpu_torch.utils import bench_7b

    cfg = DecoderConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=2,
                        d_ff=512, max_seq_len=256, softmax_n=1.0, dtype=torch.bfloat16,
                        int8_mm_impl=route, decode_attn_impl=route)
    params = bench_7b.init_7b_int8_synth(cfg, gen, "cuda")
    _build.reset_launches()
    res = bench_7b.bench_decode(cfg, params, kv_quantization="int8", batch=8,
                                prompt_len=16, decode_steps=8, max_len=128)
    assert res["graph_tokens_per_s"] > 0 and res["eager_tokens_per_s"] > 0
    assert res["active_slots"] == 8 and res["lengths"] == [16 + 4 * 8]
    assert _build.LAUNCHES["qmm_argmax"] == 7 * 8
