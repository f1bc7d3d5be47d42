"""Port parity: grouped int4 packing, the dequant matmul K7 and the fused
SwiGLU MLP K9 (plain versions on the CPU) against the JAX package, whose
Pallas kernels run in interpret mode; K7's and K2's plans.

Packing and int4 quantization are held bit-exact. ``quantized_matmul``:
f32 within 1e-5 of max |out| (f32 sums in another order); bf16 within one
bf16 ulp (rtol 2^-7, the two round one f32 sum apart), with 1e-5 of max
|out| for values near 0. W8A8 sums integers and is exact before the scales.
``fused_mlp_matmul``: f32 within 1e-5 of max |out|; bf16 within 2e-2 of
max |out| (h rounds to bf16 on either side of a tie before the down
product).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_softmax_n_tpu.kernels import fused_mlp as jfm
from flash_attention_softmax_n_tpu.kernels import quant_matmul as jqm
from flash_attention_softmax_n_tpu.quant import qtensor as jq
from flash_attention_softmax_n_tpu_torch.convert import tensor_from_numpy
from flash_attention_softmax_n_tpu_torch.kernels import fused_mlp as tfm
from flash_attention_softmax_n_tpu_torch.kernels import quant_matmul as tqm
from flash_attention_softmax_n_tpu_torch.quant import qtensor as tq

torch.set_num_threads(2)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("rows", [256, 512, 6])  # 6: one group of the whole axis
@pytest.mark.parametrize("axis", [0, 1])
def test_int4_pack_unpack_every_byte_bit_exact(rows, axis):
    # every byte value in every row position of a group
    b = (np.arange(rows // 2 * 256) % 256 - 128).astype(np.int8)
    packed = b.reshape(rows // 2, 256)
    if axis == 1:
        packed = np.ascontiguousarray(packed.T)
    want = np.asarray(jq.unpack_int4(jnp.asarray(packed), axis))
    got = tq.unpack_int4(_t(packed), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int8 and got.min() >= -8 and got.max() <= 7
    np.testing.assert_array_equal(tq.pack_int4(got, axis).numpy(), packed)
    np.testing.assert_array_equal(
        tq.pack_int4(got, axis).numpy(),
        np.asarray(jq.pack_int4(jnp.asarray(want), axis)))


@pytest.mark.parametrize("axis", [0, -2, 1, -1])
def test_quantize_int4_bit_exact(axis):
    rng = np.random.RandomState(0)
    x = rng.randn(512, 6).astype(np.float32) * 3
    x[:, 0] = 0.0  # a zero column: scale 0
    x[7, :] = np.linspace(-3.5, 3.5, 6)  # values on .5 boundaries
    if axis in (1, -1):
        x = np.ascontiguousarray(x.T)
    jqt = jq.quantize(jnp.asarray(x), bits=4, axis=axis)
    tqt = tq.quantize(_t(x), bits=4, axis=axis)
    assert tqt.packed_axis == jqt.packed_axis < 0
    assert tqt.logical_shape == tuple(jqt.logical_shape)
    np.testing.assert_array_equal(tqt.values.numpy(), np.asarray(jqt.values))
    np.testing.assert_array_equal(tqt.scales.numpy(), np.asarray(jqt.scales))
    np.testing.assert_array_equal(tq.dequantize(tqt).numpy(),
                                  np.asarray(jq.dequantize(jqt)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 13, 300])
@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_matches_pallas(bits, act_quant, m, dtype):
    rng = np.random.RandomState(m + bits)
    k, n = 512, 200  # N not a multiple of 128: ragged tiles
    xj = jnp.asarray(rng.randn(m, k).astype(np.float32)).astype(dtype)
    w = jq.quantize(jnp.asarray(rng.randn(k, n).astype(np.float32)), bits=bits,
                    axis=0)
    want = np.asarray(jqm.quantized_matmul(xj, w.values, w.scales, bits=bits,
                                           act_quant=act_quant).astype(jnp.float32))
    got = tqm.quantized_matmul(_t(xj), _t(w.values), _t(w.scales), bits=bits,
                               act_quant=act_quant)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, n)
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=1e-5 * scale, rtol=0)
    else:
        np.testing.assert_allclose(_np(got), want, atol=1e-5 * scale,
                                   rtol=2.0 ** -7)


def test_quantized_matmul_leading_dims_and_out_dtype():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 256).astype(np.float32)
    w = jq.quantize(jnp.asarray(rng.randn(256, 40).astype(np.float32)), bits=8,
                    axis=0)
    want = np.asarray(jqm.quantized_matmul(jnp.asarray(x).astype(jnp.bfloat16),
                                           w.values, w.scales,
                                           out_dtype=jnp.float32))
    got = tqm.quantized_matmul(_t(x).to(torch.bfloat16), _t(w.values),
                               _t(w.scales), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 40)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)


def test_quantized_matmul_rejects_bad_shapes():
    x = torch.randn(4, 128)
    with pytest.raises(ValueError, match="K % 256"):
        tqm.quantized_matmul(x, torch.zeros(64, 8, dtype=torch.int8),
                             torch.ones(8), bits=4)
    with pytest.raises(ValueError, match="contraction"):
        tqm.quantized_matmul(x, torch.zeros(100, 8, dtype=torch.int8),
                             torch.ones(8))
    with pytest.raises(ValueError, match="bits"):
        tqm.quantized_matmul(x, torch.zeros(128, 8, dtype=torch.int8),
                             torch.ones(8), bits=2)


# K7's plan at the shapes its paths give it (TinyLlama-1.1B: K 2048 or 5632,
# N 256, 2048, 2560, 5632, 11264; M 1-64 decode, 1024-2048 admission) and at
# the card tests' ragged ones
_PATH_SHAPES = [(m, k, n) for m in (1, 8, 64, 1024, 2048) for k in (2048, 5632)
                for n in (256, 2048, 2560, 5632, 11264)]
_RAGGED_SHAPES = [(1, 256, 97), (13, 512, 200), (64, 2048, 256), (300, 768, 1000),
                  (6, 512, 130), (63, 320, 200), (65, 640, 256), (13, 300, 256),
                  (13, 312, 256), (1024, 2048, 512)]


def _plan_shapes(mode):
    shapes = _PATH_SHAPES + _RAGGED_SHAPES
    if mode in ("int4", "w4a8"):  # grouped int4 needs K % 256 == 0
        shapes = [(m, k, n) for m, k, n in shapes if k % 256 == 0]
    return shapes


@pytest.mark.parametrize("mode", tqm.QMM_MODES)
def test_qmm_plan_covers_every_slice_once(mode):
    for m, k, n in _plan_shapes(mode):
        plan = tqm.qmm_plan(m, k, n, mode)
        n_slices = -(-k // plan.bk)
        per = plan.slices_per_split
        assert plan.splits >= 1 and per >= 1, (m, k, n, plan)
        # consecutive ranges of `per` slices: all covered, the last not empty
        assert plan.splits * per >= n_slices > (plan.splits - 1) * per, (m, k, n, plan)
        if m < 128:
            assert plan.bm == 64
        elif mode == "f32":
            assert plan.bm == 128
        else:
            assert plan.bm in ((128, 256) if mode in ("int8", "int4") else (128,))


def test_qmm_plan_takes_256_rows_only_where_it_saves_rounds():
    # M2048 N5632: 704 tiles of 128 rows (6 rounds of 132) or 352 of 256 (3)
    assert tqm.qmm_plan(2048, 2048, 5632, "int8").bm == 256
    assert tqm.qmm_plan(2048, 2048, 5632, "int4").bm == 256
    assert tqm.qmm_plan(2048, 2048, 5632, "w8a8").bm == 128  # int8 x: 128 at most
    # M1024 N5632: 3 rounds either way once the 256-row tile's cost counts
    assert tqm.qmm_plan(1024, 2048, 5632, "int8").bm == 128
    assert tqm.qmm_plan(1024, 5632, 2048, "int8").bm == 128  # one round of 128 tiles
    plan = tqm.qmm_plan(2048, 2048, 5632, "int8")
    assert plan.stages == 5 and plan.splits == 1


def test_qmm_plan_splits_only_narrow_products():
    # a full wave of tiles is not split; decode at N 5632 is, to a wave
    assert tqm.qmm_plan(1024, 2048, 2048, "int8").splits == 1  # 128 tiles
    assert tqm.qmm_plan(2048, 5632, 2048, "int8").splits == 1
    plan = tqm.qmm_plan(64, 2048, 5632, "int8")  # 44 tiles
    assert plan.splits == 3 and 44 * plan.splits <= 132
    assert tqm.qmm_plan(64, 5632, 2048, "w8a8").splits == 8  # 16 tiles: 128, not 144
    # f32: 88 tiles of 64 x 64, two thirds of the SMs, not split
    assert tqm.qmm_plan(64, 2048, 5632, "f32").splits == 1
    # the tiles, splits included, stay within one round (f32: two CTAs an SM)
    for mode in ("int8", "int4", "w8a8", "w4a8", "f32"):
        for m, k, n in _plan_shapes(mode):
            plan = tqm.qmm_plan(m, k, n, mode)
            if plan.splits > 1:
                ctas = -(-m // plan.bm) * -(-n // plan.bn) * plan.splits
                assert ctas <= (264 if mode == "f32" else 132), (m, k, n)


@pytest.mark.parametrize("mode", ["int4", "w4a8"])
def test_qmm_plan_int4_stage_stays_in_one_half_group(mode):
    # a stage's logical rows: one nibble of packed byte rows of one group
    for m, k, n in _plan_shapes(mode):
        plan = tqm.qmm_plan(m, k, n, mode)
        for t in range(k // plan.bk):
            first = t * plan.bk
            assert first // 128 == (first + plan.bk - 1) // 128, (k, plan, t)


@pytest.mark.parametrize("mode", ["int8", "int4", "w8a8", "w4a8"])
def test_qmm_plan_predicated_exactly_where_a_row_stride_is_unaligned(mode):
    x_bytes = 1 if mode in ("w8a8", "w4a8") else 2
    ks = range(256, 1024 + 1, 256) if mode in ("int4", "w4a8") else range(248, 320)
    for k in ks:
        for n in range(240, 272):
            plan = tqm.qmm_plan(64, k, n, mode)
            assert plan.kernel == "wgmma"
            unaligned = (k * x_bytes) % 16 != 0 or n % 16 != 0
            assert plan.producer == ("predicated" if unaligned else "tma"), (k, n)


def test_qmm_f32_plan_takes_cp_async_exactly_where_tma_cannot():
    # TMA needs 16-byte row strides: x's K % 4 (f32) and W's N % 16
    for k in range(248, 320):
        for n in range(240, 272):
            plan = tqm.qmm_plan(300, k, n, "f32")
            assert plan.kernel == "simt"
            tma = k % 4 == 0 and n % 16 == 0
            assert plan.producer == ("tma" if tma else "cp.async"), (k, n)
    assert tqm.qmm_plan(300, 776, 200, "f32").producer == "cp.async"


def test_qmm_mode_and_f32_plan():
    assert tqm.qmm_mode(torch.float32, 8) == tqm.qmm_mode(torch.float32, 4) == "f32"
    assert tqm.qmm_mode(torch.bfloat16, 4) == "int4"
    assert tqm.qmm_mode(torch.int8, 8) == "w8a8"
    plan = tqm.qmm_plan(64, 2048, 5632, "f32")
    assert (plan.kernel, plan.producer, plan.bk, plan.bn) == ("simt", "tma", 32, 64)
    # BERT-base over B8 x L512 (M4096): 128 x 64 tiles (384 at N768, three
    # CTAs an SM), a ring of three, no split
    for k, n in ((768, 768), (768, 3072), (3072, 768)):
        plan = tqm.qmm_plan(4096, k, n, "f32")
        assert (plan.bm, plan.bn, plan.stages, plan.splits, plan.producer) == (
            128, 64, 3, 1, "tma"), (k, n, plan)
    # decode (M64, 32 tiles of 64 x 64): K split to about two CTAs an SM
    plan = tqm.qmm_plan(64, 2048, 2048, "f32")
    assert (plan.bm, plan.splits, plan.slices_per_split) == (64, 8, 8)
    assert tqm.qmm_plan(1024, 2048, 2048, "f32")[1:7] == (128, 64, 32, 3, 1, 64)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tqm.qmm_mode(torch.float16, 8)
    with pytest.raises(ValueError, match="mode"):
        tqm.qmm_plan(64, 256, 256, "fp8")


def _nibble(b, high):
    """sign-extended nibble of each int8 byte, by integer arithmetic"""
    v = (b.to(torch.int32) >> 4) if high else (((b.to(torch.int32) & 15) ^ 8) - 8)
    return v


@pytest.mark.parametrize("mode", ["int4", "w4a8"])
def test_int4_stage_order_matches_the_reference(mode):
    """The kernel's int4 stages, emulated: stage t is x's columns
    [t*bk, (t+1)*bk), which lie in one half h of one 256-row group g, times
    nibble h of packed byte rows 128g + (their offset in the half)."""
    rng = np.random.RandomState(7)
    m, k, n = 5, 768, 48
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(torch.bfloat16)
    w = tq.quantize(torch.from_numpy(rng.randn(k, n).astype(np.float32)), bits=4, axis=0)
    act = mode == "w4a8"
    xk, xs = tqm.quantize_rows(x) if act else (x, None)
    bk = tqm.qmm_plan(m, k, n, mode).bk
    acc = torch.zeros((m, n), dtype=torch.int64 if act else torch.float32)
    for t in range(k // bk):
        g, j = divmod(t * bk, 256)
        rows = w.values[128 * g + j % 128:128 * g + j % 128 + bk]
        wt = _nibble(rows, j >= 128)
        cols = slice(t * bk, (t + 1) * bk)
        if act:
            acc += xk[:, cols].to(torch.int64) @ wt.to(torch.int64)
        else:
            acc += xk[:, cols].float() @ wt.float()
    s = w.scales.reshape(1, -1).float()
    got = acc.float() * s * xs.reshape(-1, 1) if act else acc * s
    want = tqm.quantized_matmul_reference(xk, xs, w.values, w.scales, bits=4,
                                          out_dtype=torch.float32)
    if act:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)


# K2's plan at the lm_head's shapes (TinyLlama-1.1B: K2048 N32000; Llama-3's
# N128256), around its row tiles and at N and K that TMA cannot take
_ARGMAX_SHAPES = [(m, k, n) for m in (1, 8, 13, 63, 64, 65, 100, 128, 129, 256, 300, 1024,
                                      4096)
                  for k in (64, 200, 2048, 2052) for n in (97, 272, 1000, 32000, 32001, 128256)]


def _argmax_walk(m, n, plan):
    """the kernel's walk: CTA b takes tiles b, b + ctas, ... of (row tile
    fastest, then column tile), each over every K stage (no split), and
    writes its rows' slot b // (row tiles)"""
    tiles_m, tiles_n = -(-m // plan.bm), -(-n // plan.bn)
    seen, slots = {}, {}
    for b in range(plan.ctas):
        rows = set()
        for u in range(b, tiles_m * tiles_n, plan.ctas):
            tile = (u % tiles_m, u // tiles_m)
            seen[tile] = seen.get(tile, 0) + 1
            rows.add(tile[0])
        assert len(rows) == 1, (m, n, plan, b)  # one row tile a CTA
        key = (rows.pop(), b // tiles_m)
        slots[key] = slots.get(key, 0) + 1
    return tiles_m, tiles_n, seen, slots


# the shapes by row tile: 64 (256 vocab columns a tile), 128 and 256
@pytest.mark.parametrize("bm", [64, 128, 256])
def test_qmm_argmax_plan_covers_every_tile_once(bm):
    lo, hi = {64: (0, 64), 128: (64, 128), 256: (128, 1 << 30)}[bm]
    shapes = [(m, k, n) for m, k, n in _ARGMAX_SHAPES if lo < m <= hi]
    assert shapes
    for m, k, n in shapes:
        plan = tqm.qmm_argmax_plan(m, k, n)
        assert plan.bm == bm
        assert "splits" not in plan._fields and plan.bk == 64  # K walked whole
        tiles_m, tiles_n, seen, slots = _argmax_walk(m, n, plan)
        assert set(seen) == {(i, j) for i in range(tiles_m) for j in range(tiles_n)}
        assert set(seen.values()) == {1}, (m, k, n, plan)
        # every row tile has plan.slots CTAs, each writing its own slot once
        assert set(slots) == {(i, t) for i in range(tiles_m) for t in range(plan.slots)}
        assert set(slots.values()) == {1} and plan.ctas == tiles_m * plan.slots
        assert plan.ctas <= 132, (m, n, plan)
        assert plan.ctas == min(132, tiles_m * tiles_n) // tiles_m * tiles_m


def test_qmm_argmax_plan_rows_width_and_ring():
    for m, k, n in _ARGMAX_SHAPES:
        plan = tqm.qmm_argmax_plan(m, k, n)
        assert plan.bm == (64 if m <= 64 else 128 if m <= 128 else 256), (m, plan)
        assert plan.bn == (256 if m <= 64 else 128)
        # as deep a ring as shared memory holds beside 2 KB, at most 8
        stage = plan.bm * 128 + plan.bk * plan.bn
        assert plan.stages == min(8, (232448 - 2048) // stage)
    # the serving lines: M64 (the fused loop's batch) and M256
    assert tqm.qmm_argmax_plan(64, 2048, 32000) == tqm.ArgmaxPlan(
        "wgmma", 64, 256, 64, 8, 125, 125, "tma")
    assert tqm.qmm_argmax_plan(256, 2048, 32000) == tqm.ArgmaxPlan(
        "wgmma", 256, 128, 64, 5, 132, 132, "tma")
    with pytest.raises(ValueError, match="bf16 or f32"):
        tqm.qmm_argmax_plan(64, 2048, 32000, torch.float16)


def test_qmm_argmax_plan_predicated_exactly_where_a_row_stride_is_unaligned():
    for k in range(248, 280):
        for n in range(240, 272):
            plan = tqm.qmm_argmax_plan(64, k, n)
            unaligned = (k * 2) % 16 != 0 or n % 16 != 0
            assert plan.producer == ("predicated" if unaligned else "tma"), (k, n)


def test_qmm_argmax_f32_plan_is_the_scalar_kernel():
    for m, k, n in _ARGMAX_SHAPES:
        plan = tqm.qmm_argmax_plan(m, k, n, torch.float32)
        tiles = -(-n // 64)
        assert plan == tqm.ArgmaxPlan("scalar", 64, 64, 32, 1, tiles, tiles, "scalar")


def test_mlp_fusion_eligible_matches_jax():
    # the grid of tests/test_quant.py's routing cases, and around its edges
    cases = [(m, k, f, bits)
             for m in (1, 8, 64, 256, 300, 512, 513, 2048)
             for k in (32, 128, 256, 2048, 4096, 8192)
             for f in (64, 256, 1024, 5632, 11008, 14336)
             for bits in (8, 4)]
    for m, k, f, bits in cases:
        assert (tfm.mlp_fusion_eligible(m, k, f, bits)
                == jfm.mlp_fusion_eligible(m, k, f, bits)), (m, k, f, bits)
    assert tfm.mlp_fusion_eligible(64, 2048, 5632, 8)  # TinyLlama decode
    assert not tfm.mlp_fusion_eligible(64, 32, 64, 8)  # K % 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kf", [(128, 256), (256, 1024)])
@pytest.mark.parametrize("m", [1, 8, 64])
def test_fused_mlp_matches_pallas(m, kf, dtype):
    k, f = kf
    rng = np.random.RandomState(m + k)
    xj = jnp.asarray(rng.randn(m, k).astype(np.float32)).astype(dtype)
    wg, wu = (jq.quantize(jnp.asarray(rng.randn(k, f).astype(np.float32)),
                          bits=8, axis=0) for _ in range(2))
    wd = jq.quantize(jnp.asarray(rng.randn(f, k).astype(np.float32)), bits=8,
                     axis=0)
    want = np.asarray(jfm.fused_mlp_matmul(
        xj, wg.values, wg.scales, wu.values, wu.scales, wd.values,
        wd.scales).astype(jnp.float32))
    got = tfm.fused_mlp_matmul(_t(xj), _t(wg.values), _t(wg.scales),
                               _t(wu.values), _t(wu.scales), _t(wd.values),
                               _t(wd.scales))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, k)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), want, atol=tol * np.abs(want).max(),
                               rtol=0)


def test_fused_mlp_rejects_mismatched_weights():
    x = torch.randn(2, 128)
    w = torch.zeros(128, 256, dtype=torch.int8)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfm.fused_mlp_matmul(x, w, torch.ones(256), w, torch.ones(256), w,
                             torch.ones(128))
