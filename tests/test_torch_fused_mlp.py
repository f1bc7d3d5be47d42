"""K9's plan (``kernels/fused_mlp.fused_mlp_plan``), on the CPU.

The plan sets the tiles, rings, K splits and producers of both phases of
``csrc/fused_mlp.cu`` before the launch; the tensor-core kernels (bf16 x)
walk the tiles in ``csrc/qmm_tile.h`` ``tile_of``'s order and the f32 FMA
kernels (f32 x) take one block a tile and split, both mirrored here, so
these tests hold what the card runs: every output tile once, every K slice
of it in exactly one split, splits only where the tiles leave the card
half empty, TMA exactly where the row strides allow it, a ring that fits
shared memory, and K9's device-memory traffic at the serving shape within
1.2x its weights.
"""

import math

import pytest
import torch

from flash_attention_softmax_n_tpu_torch.kernels import fused_mlp as fm
from flash_attention_softmax_n_tpu_torch.kernels import quant_matmul as tqm
from flash_attention_softmax_n_tpu_torch.kernels.quant_matmul import QmmPlan

torch.set_num_threads(2)

# M of a decode step (1-512: the fusion limit) at the TinyLlama-1.1B widths,
# and shapes that split the gate/up phase or take the predicated producer
_SHAPES = [(m, 2048, 5632) for m in (1, 13, 64, 65, 256, 300, 512)] + [
    (1, 512, 256), (13, 256, 1024), (65, 512, 1536), (13, 200, 300), (64, 2048, 5640),
    (7, 120, 88)]
_SMEM = 232448  # bytes of shared memory one block may use on the H100


def _tiles(plan, m, k, n):
    """(m0, n0, split, first slice, slices) of each tile, as tile_of walks them"""
    tiles_m = math.ceil(m / plan.bm)
    n_slices = math.ceil(k / plan.bk)
    out = []
    for u in range(tiles_m * math.ceil(n / plan.bn) * plan.splits):
        rest = u // tiles_m
        split = rest % plan.splits
        t0 = split * plan.slices_per_split
        out.append(((u % tiles_m) * plan.bm, (rest // plan.splits) * plan.bn, split, t0,
                    min(n_slices, t0 + plan.slices_per_split) - t0))
    return out


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_tiles_cover_every_output_and_slice_once(shape):
    m, k, f = shape
    plan = fm.fused_mlp_plan(m, k, f, torch.bfloat16)
    for phase, (kk, n) in ((plan.gate_up, (k, f)), (plan.down, (f, k))):
        n_slices = math.ceil(kk / phase.bk)
        seen = {}
        for m0, n0, split, t0, nk in _tiles(phase, m, kk, n):
            assert nk >= 1, (shape, phase)  # no split is empty
            seen.setdefault((m0, n0), []).extend(range(t0, t0 + nk))
        # every (row tile, column tile) once, its slices each in one split
        assert set(seen) == {(m0, n0) for m0 in range(0, m, phase.bm)
                             for n0 in range(0, n, phase.bn)}, (shape, phase)
        for slices in seen.values():
            assert sorted(slices) == list(range(n_slices)), (shape, phase)


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_phases_take_tma_exactly_where_row_strides_allow(shape):
    m, k, f = shape
    plan = fm.fused_mlp_plan(m, k, f, torch.bfloat16)
    # gate/up: x (M, K) bf16 rows of 2K bytes, Wg and Wu (K, F) rows of F
    assert plan.gate_up.producer == ("tma" if k % 8 == 0 and f % 16 == 0 else "predicated")
    # down: h (M, F) bf16 rows of 2F bytes, Wd (F, K) rows of K
    assert plan.down.producer == ("tma" if f % 8 == 0 and k % 16 == 0 else "predicated")


@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_rings_fit_and_splits_stay_in_one_round(shape):
    m, k, f = shape
    plan = fm.fused_mlp_plan(m, k, f, torch.bfloat16)
    gu, dn = plan.gate_up, plan.down
    assert (gu.bn, gu.bk, dn.bn, dn.bk) == (64, 64, 128, 64)
    # the gate/up ring beside warpgroup 1's accumulators (BM/2 floats a thread)
    assert gu.stages * (gu.bm + gu.bk) * 128 + 256 * gu.bm + 2048 <= _SMEM
    assert dn.stages * (dn.bm + dn.bk) * 128 + 2048 <= _SMEM
    assert 4 <= gu.stages <= 8 and dn.stages == 8
    assert dn.splits <= 4
    for phase, n in ((gu, f), (dn, k)):
        if phase.splits > 1:
            assert math.ceil(m / phase.bm) * math.ceil(n / phase.bn) * phase.splits <= 132


def test_serving_shape_reads_within_1_2x_its_weights():
    # M64 K2048 F5632, one decode step at B64: 88 gate/up tiles in one round
    # with no split, and the down product's partials kept small
    m, k, f = 64, 2048, 5632
    plan = fm.fused_mlp_plan(m, k, f, torch.bfloat16)
    assert plan.gate_up.splits == 1 and plan.gate_up.bm == 64
    assert math.ceil(f / 64) == 88
    assert plan.down.splits == 4
    weights = 3 * k * f
    traffic = (weights + 2 * m * k * 2          # x read, out written
               + 2 * m * f * 2                  # h written and read
               + 2 * plan.down.splits * m * k * 4)  # down partials written and read
    assert traffic <= 1.2 * weights, traffic / weights


def test_m256_takes_256_row_gate_up_tiles():
    plan = fm.fused_mlp_plan(256, 2048, 5632, torch.bfloat16)
    assert (plan.gate_up.bm, plan.gate_up.stages, plan.gate_up.splits) == (256, 4, 1)


def test_f32_takes_the_scalar_kernel_and_other_types_raise():
    # f32 x runs on the FMA pipes, outside the tensor cores: K7's f32 tiles,
    # the gate/up phase's 32 d_ff columns of both Wg and Wu, the down phase
    # as K7's f32 mode plans h (M, F) @ Wd (F, K)
    plan = fm.fused_mlp_plan(64, 2048, 5632, torch.float32)
    assert plan == fm.MlpPlan(
        "simt", QmmPlan("simt", 64, 32, 32, 3, 3, 22, "tma"),
        QmmPlan("simt", 64, 64, 32, 3, 8, 22, "tma"))
    assert plan.down == tqm.qmm_plan(64, 5632, 2048, "f32")
    plan = fm.fused_mlp_plan(256, 2048, 5632, torch.float32)
    assert plan.gate_up == QmmPlan("simt", 128, 32, 32, 3, 1, 64, "tma")
    with pytest.raises(ValueError, match="bf16 or f32"):
        fm.fused_mlp_plan(64, 2048, 5632, torch.float16)


# f32 x: the grids of fused_mlp_gateup_f32_kernel and fused_mlp_down_f32_kernel,
# block (x, y, z) column tile x of row tile y over split z's K stages
_F32_SHAPES = _SHAPES + [(5, 126, 90), (130, 512, 1000), (13, 203, 301), (1024, 2048, 5632)]


def _f32_grid(plan, m, k, n):
    """(m0, n0, split, first slice, slices) of each block of a phase's grid"""
    n_slices = math.ceil(k / plan.bk)
    out = []
    for z in range(plan.splits):
        t0 = z * plan.slices_per_split
        for y in range(math.ceil(m / plan.bm)):
            for x in range(math.ceil(n / plan.bn)):
                out.append((y * plan.bm, x * plan.bn, z, t0,
                            min(n_slices, t0 + plan.slices_per_split) - t0))
    return out


@pytest.mark.parametrize("shape", _F32_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_f32_phases_cover_every_output_and_slice_once(shape):
    m, k, f = shape
    plan = fm.fused_mlp_plan(m, k, f, torch.float32)
    assert plan.kernel == "simt"
    # gate/up: 32 d_ff columns of each matrix a tile; down: K7's 64 columns
    for phase, (kk, n), bn in ((plan.gate_up, (k, f), 32), (plan.down, (f, k), 64)):
        assert (phase.kernel, phase.bn, phase.bk, phase.stages) == ("simt", bn, 32, 3)
        assert phase.bm == (64 if m < 128 else 128)
        n_slices = math.ceil(kk / 32)
        seen = {}
        for m0, n0, split, t0, nk in _f32_grid(phase, m, kk, n):
            assert nk >= 1, (shape, phase)  # no split is empty
            seen.setdefault((m0, n0), []).extend(range(t0, t0 + nk))
        assert set(seen) == {(m0, n0) for m0 in range(0, m, phase.bm)
                             for n0 in range(0, n, phase.bn)}, (shape, phase)
        for slices in seen.values():
            assert sorted(slices) == list(range(n_slices)), (shape, phase)


@pytest.mark.parametrize("shape", _F32_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_f32_splits_only_where_tiles_fill_less_than_half(shape):
    m, k, f = shape
    plan = fm.fused_mlp_plan(m, k, f, torch.float32)
    gu, dn = plan.gate_up, plan.down
    # gate/up: against the CTA slots, four an SM at 64 rows, three at 128
    slots = (4 if gu.bm == 64 else 3) * 132
    tiles = math.ceil(m / gu.bm) * math.ceil(f / 32)
    if 2 * tiles > slots:
        assert gu.splits == 1, (shape, gu)
    else:
        assert tiles * gu.splits <= slots and gu.slices_per_split >= min(2, math.ceil(k / 32))
    # down: K7's f32 rule, against the SMs (about two CTAs an SM)
    tiles = math.ceil(m / dn.bm) * math.ceil(k / 64)
    if 2 * tiles > 132:
        assert dn.splits == 1, (shape, dn)
    else:
        assert tiles * dn.splits <= 264


@pytest.mark.parametrize("shape", _F32_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_f32_phases_take_tma_exactly_where_row_strides_allow(shape):
    m, k, f = shape
    plan = fm.fused_mlp_plan(m, k, f, torch.float32)
    # gate/up: x (M, K) f32 rows of 4K bytes, Wg and Wu (K, F) rows of F
    assert plan.gate_up.producer == ("tma" if k % 4 == 0 and f % 16 == 0 else "cp.async")
    # down: h (M, F) f32 rows of 4F bytes, Wd (F, K) rows of K
    assert plan.down.producer == ("tma" if f % 4 == 0 and k % 16 == 0 else "cp.async")


def test_f32_serving_shape_splits_the_gate_up_phase_to_fill_the_card():
    # M64 F5632: 176 tiles of 64 rows fill a third of the 528 CTA slots, so
    # K splits in 3 (22 stages each); M256: 352 tiles of 128 rows, no split
    gu = fm.fused_mlp_plan(64, 2048, 5632, torch.float32).gate_up
    assert math.ceil(5632 / 32) == 176 and (gu.splits, gu.slices_per_split) == (3, 22)
    assert fm.fused_mlp_plan(256, 2048, 5632, torch.float32).gate_up.splits == 1
