"""Quantized matmuls: the dequant matmul K7 and the greedy lm_head K2.

Counterparts of ``quantized_matmul`` and ``quantized_matmul_argmax``
(``flash_attention_softmax_n_tpu/kernels/quant_matmul.py``). On a CUDA
tensor the hand-written kernels run (``csrc/qmm.cu``, ``csrc/qmm_argmax.cu``,
both on the tensor-core pieces of ``csrc/qmm_tile.h`` for bf16 x and on
its f32 FMA tiles for f32 x, planned here by ``qmm_plan`` and
``qmm_argmax_plan``); on a CPU tensor their plain
versions ``*_reference`` do. Both accumulate in
f32 (int32 under W8A8) and apply the per-column scale after accumulation,
which is not the plain route's ``x @ dequantize(w)`` (that rounds w * s to
x's type first); K2's argmax can therefore pick another token at a near-tie
than an argmax over bf16-rounded logits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build
from flash_attention_softmax_n_tpu_torch.quant.qtensor import (
    INT4_GROUP,
    INT8_MAX,
    unpack_int4,
)

__all__ = ["quantized_matmul", "quantized_matmul_reference",
           "quantize_rows", "quantized_matmul_argmax",
           "quantized_matmul_argmax_reference", "QMM_MODES", "QmmPlan",
           "qmm_mode", "qmm_plan", "wgmma_plan", "ArgmaxPlan",
           "qmm_argmax_plan", "f32_rows", "f32_producer"]

# K7's modes: bf16 x with int8 or int4 weights, int8 x (W8A8) with int8 or
# int4 weights, and f32 x (either weight type)
QMM_MODES = ("int8", "int4", "w8a8", "w4a8", "f32")
_SMS = 132  # the H100's streaming multiprocessors
_SMEM = 232448  # bytes of shared memory one block may use on the H100
_MAX_STAGES = 8
_MAX_SPLITS = 32
_MIN_SLICES_PER_SPLIT = 2


class QmmPlan(NamedTuple):
    """How ``csrc/qmm.cu`` runs one (M, K, N) product."""

    kernel: str        # "wgmma" (tensor cores) or "simt" (f32 x, f32 FMAs)
    bm: int            # output rows per tile: 64, 128 or (bf16 x) 256
    bn: int            # output columns per tile
    bk: int            # logical K rows per stage (slice)
    stages: int        # ring depth the kernel is built with (Cfg::STAGES, F32Cfg::STAGES)
    splits: int        # K ranges, each summed by its own CTAs
    slices_per_split: int
    # "tma", or where a row stride TMA cannot take: "predicated" (wgmma)
    # or "cp.async" (simt)
    producer: str


# the time of a 256-row bf16 tile against a 128-row one at the same K
# (qmm_wgmma_kernel on an NVIDIA H100 80GB HBM3: 1.1 against 0.64 us a stage)
_TILE_256_COST = 1.75


def _rounds(m: int, n: int, bm: int, bn: int) -> int:
    """rounds of one (bm x bn) tile per SM that cover an (m, n) output"""
    return math.ceil(math.ceil(m / bm) * math.ceil(n / bn) / _SMS)


def qmm_mode(x_dtype: torch.dtype, bits: int) -> str:
    """K7's mode for activations of ``x_dtype`` (int8 under W8A8)."""
    if x_dtype == torch.int8:
        return "w4a8" if bits == 4 else "w8a8"
    if x_dtype == torch.bfloat16:
        return "int4" if bits == 4 else "int8"
    if x_dtype == torch.float32:
        return "f32"
    raise ValueError(f"quantized_matmul takes bf16 or f32 inputs, got {x_dtype}")


def _split(n_slices: int, want: int, max_splits: int = _MAX_SPLITS) -> Tuple[int, int]:
    """(splits, slices per split): at most ``want`` and ``max_splits``
    ranges of at least two slices each, none empty"""
    splits = min(want, max(1, n_slices // _MIN_SLICES_PER_SPLIT), max_splits)
    per = math.ceil(n_slices / splits)
    return math.ceil(n_slices / per), per


def wgmma_plan(m: int, k: int, n: int, *, int8_x: bool = False, dual: bool = False,
               max_splits: int = _MAX_SPLITS) -> QmmPlan:
    """The tensor-core kernel's plan (``csrc/qmm_tile.h``) for an (M, K, N)
    product: K7's bf16 or int8 x, or (``dual``) K9's gate/up phase, whose
    tiles are 64 columns of each of two weight matrices.

    Tiles are 64 rows of x below M = 128 and 128 from there; bf16 x takes
    256 rows where that needs fewer rounds of tiles over the SMs by more
    than a 256-row tile's extra cost. A stage is one 128-byte row of K: 64
    logical K rows of bf16 x, 128 of int8 x, so an int4 stage lies in one
    half of one 256-row group (one nibble of as many packed byte rows); its
    W bytes are as many 128-byte rows (``dual``: two matrices' 64-byte
    rows). The ring is as deep as shared memory allows (4-8 stages) beside
    2 KB and, under W8A8, three converted W tiles or, under ``dual``,
    warpgroup 1's accumulators handed to warpgroup 0. The producer is TMA
    unless a row stride is not a multiple of 16 bytes (bf16 x with K % 8,
    int8 x with K % 16, W with N % 16). Where the tiles fill less than half
    the card's SMs, K is split into as many ranges (at least two slices
    each, at most ``max_splits``) as keep the tiles within one round over
    the SMs.
    """
    bn = 64 if dual else 128
    bm = 128 if m >= 128 else 64
    bk = 128 if int8_x else 64
    if bm == 128 and not int8_x and (_rounds(m, n, 256, bn) * _TILE_256_COST
                                     < _rounds(m, n, 128, bn)):
        bm = 256
    reserved = 3 * bn * 128 if int8_x else (256 * bm if dual else 0)
    stages = min(_MAX_STAGES, (_SMEM - reserved - 2048) // ((bm + bk) * 128))
    aligned = (k * (1 if int8_x else 2)) % 16 == 0 and n % 16 == 0
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    # persistent CTAs, one per SM: as many splits as keep the tiles within
    # one round over the SMs
    want = _SMS // tiles if 2 * tiles <= _SMS else 1
    splits, per = _split(math.ceil(k / bk), want, max_splits)
    return QmmPlan("wgmma", bm, bn, bk, stages, splits, per,
                   "tma" if aligned else "predicated")


# the f32 FMA tiles (``csrc/qmm_tile.h`` F32Cfg): K rows a stage, the
# ring's depth, and the CTAs an SM holds at 64 and 128 rows a tile
F32_BK = 32
F32_STAGES = 3
F32_CTAS_PER_SM = {64: 4, 128: 3}


def f32_rows(m: int) -> int:
    """rows of x a tile of the f32 FMA kernels: 128, or 64 below M = 128"""
    return 64 if m < 128 else 128


def f32_producer(k: int, n: int) -> str:
    """TMA where x's f32 rows (K % 4) and W's byte rows (N % 16) are
    multiples of 16 bytes, else the cp.async loader"""
    return "tma" if k % 4 == 0 and n % 16 == 0 else "cp.async"


def _f32_plan(m: int, k: int, n: int) -> QmmPlan:
    """f32 x: the f32 FMA kernel's (BM x 64) tiles, 32-row stages, a ring
    of three.

    BM is 128 (three CTAs an SM), or 64 below M = 128 (four). Where the
    tiles fill less than half the SMs, K is split into as many ranges (at
    least two stages each) as put about two CTAs on each SM. The loader is
    TMA where x's rows (K % 4) and W's (N % 16) are multiples of 16 bytes,
    else cp.async.
    """
    bm = f32_rows(m)
    tiles = math.ceil(m / bm) * math.ceil(n / 64)
    want = 2 * _SMS // tiles if 2 * tiles <= _SMS else 1
    splits, per = _split(math.ceil(k / F32_BK), want)
    return QmmPlan("simt", bm, 64, F32_BK, F32_STAGES, splits, per, f32_producer(k, n))


def qmm_plan(m: int, k: int, n: int, mode: str) -> QmmPlan:
    """The tiles, ring, K splits and producer of K7 for an (M, K, N)
    product in ``mode`` (``QMM_MODES``): ``wgmma_plan`` for bf16 or int8 x
    (W's int8 or int4 columns 128 to a tile); f32 x takes the SIMT kernel
    (``_f32_plan``).
    """
    if mode not in QMM_MODES:
        raise ValueError(f"qmm_plan: mode {mode!r} is not one of {QMM_MODES}")
    if mode != "f32":
        return wgmma_plan(m, k, n, int8_x=mode in ("w8a8", "w4a8"))
    return _f32_plan(m, k, n)


class ArgmaxPlan(NamedTuple):
    """How ``csrc/qmm_argmax.cu`` runs one (M, K, N) greedy lm_head."""

    kernel: str    # "wgmma" (bf16 x, tensor cores) or "simt" (f32 x, f32 FMAs)
    bm: int        # x rows per tile: 64, 128 or 256 (simt: 64 or 128)
    bn: int        # vocab columns per tile: 256 at bm 64, else 128 (simt: 64)
    bk: int        # K rows per stage
    stages: int    # ring depth the kernel is built with (Cfg::STAGES, F32Cfg::STAGES)
    ctas: int      # wgmma: persistent CTAs, a multiple of the row tiles; simt: one a tile
    slots: int     # (value, index) pairs a row in the scratch, merged by the second kernel
    producer: str  # "tma", or where a row stride TMA cannot take "predicated" (wgmma)
                   # or "cp.async" (simt)


def qmm_argmax_plan(m: int, k: int, n: int,
                    dtype: torch.dtype = torch.bfloat16) -> ArgmaxPlan:
    """K2's plan for an (M, K, N) lm_head over x of ``dtype``.

    bf16 x: the tensor-core kernel (``csrc/qmm_tile.h`` with the argmax
    epilogue). The row tile is the smallest of 64, 128 and 256 that holds
    M (256 above). At bm 64 a tile is 256 vocab columns (four consumer
    warpgroups, two 128-column W boxes a stage), which halves x's share of
    a stage's bytes (M64 K2048 N32000 on an H100: 0.035 against 0.044 ms
    at 128 columns), else 128. A stage is 64 K rows (one 128-byte row of
    x); the ring is as deep as shared memory allows (5-8 stages), which
    ``stages`` reports: the kernel is built with that depth and does not
    take it from the plan. K is never split, since an argmax of partial
    sums is not the argmax of the sum. The CTAs are persistent, at most
    one per SM, and a multiple of the row tiles, so that each keeps one
    row tile and writes one (value, index) slot for each of its rows. The
    producer is TMA unless K % 8 or N % 16 leaves a row stride off 16
    bytes.

    f32 x: K7's f32 FMA tiles (``_f32_plan``'s rows: 64 below M = 128,
    else 128; 64 vocab columns; a ring of three 32-row stages) over the
    whole of K, one CTA a tile (500 at M64 N32000: about one wave at four
    CTAs an SM), one slot a row for each column tile; TMA where K % 4 and
    N % 16 allow it, else cp.async.
    """
    if dtype == torch.float32:
        bm = f32_rows(m)
        tiles_n = math.ceil(n / 64)
        return ArgmaxPlan("simt", bm, 64, F32_BK, F32_STAGES, math.ceil(m / bm) * tiles_n,
                          tiles_n, f32_producer(k, n))
    if dtype != torch.bfloat16:
        raise ValueError(f"quantized_matmul_argmax takes bf16 or f32 x, got {dtype}")
    bm = 64 if m <= 64 else 128 if m <= 128 else 256
    bn = 256 if bm == 64 else 128
    bk = 64
    stages = min(_MAX_STAGES, (_SMEM - 2048) // (bm * 128 + bk * bn))
    tiles_m = math.ceil(m / bm)
    tiles = tiles_m * math.ceil(n / bn)
    ctas = tiles_m * max(1, min(_SMS, tiles) // tiles_m)
    aligned = (k * 2) % 16 == 0 and n % 16 == 0
    return ArgmaxPlan("wgmma", bm, bn, bk, stages, ctas, ctas // tiles_m,
                      "tma" if aligned else "predicated")


def _route(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {x.device}")
    return False


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """W8A8's activation quantization, as JAX does it outside its kernel:
    x (M, K) -> (int8 (M, K), per-row scales absmax / 127 (M, 1) f32)."""
    xf = x2.float()
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    x_scales = torch.where(absmax == 0, 1.0, absmax / INT8_MAX)
    xq = torch.clamp(torch.round(xf / x_scales), -128, 127).to(torch.int8)
    return xq, x_scales


def quantized_matmul_reference(x2: torch.Tensor, x_scales: Optional[torch.Tensor],
                               w_values: torch.Tensor, w_scales: torch.Tensor, *,
                               bits: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K7 on x (M, K): bf16/f32 x, or int8 x with its row
    scales (M, 1) (W8A8); int8 w (K, N) or int4 w packed (K/2, N)."""
    w = unpack_int4(w_values, 0) if bits == 4 else w_values
    s = w_scales.reshape(1, -1).float()
    if x2.dtype == torch.int8:
        # the int32 sums, exact in f64 (|sum| < 2^53), then rounded to f32
        acc = (x2.double() @ w.double()).float()
        out = acc * s * x_scales.reshape(-1, 1).float()
    else:
        out = (x2.float() @ w.float()) * s
    return out.to(out_dtype)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on a 16-byte boundary (TMA's), copied
    only where a view starts elsewhere."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _qmm_cuda(x2, x_scales, w_values, w_scales, bits, out_dtype):
    m, k = x2.shape
    n = w_values.shape[1]
    plan = qmm_plan(m, k, n, qmm_mode(x2.dtype, bits))
    ops = _build.ops()
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    part = torch.empty((plan.splits, m, n) if plan.splits > 1 else (0,),
                       dtype=torch.float32, device=x2.device)
    xs = None if x_scales is None else x_scales.reshape(-1).contiguous()
    ops.qmm(aligned16(x2), xs, aligned16(w_values),
            w_scales.reshape(-1).float().contiguous(), out, part, bits,
            plan.bm, plan.splits, plan.slices_per_split,
            plan.producer == "tma")
    _build.LAUNCHES["qmm"] += 1
    return out


def quantized_matmul(x: torch.Tensor, w_values: torch.Tensor,
                     w_scales: torch.Tensor, *, bits: int = 8,
                     act_quant: bool = False,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., K) @ dequant(w) (K, N) -> (..., N) in ``out_dtype`` (x's
    type by default).

    ``w_values``: int8 (K, N), or int4 packed (K/2, N) along K
    (``quantize(w, bits=4, axis=0)``; needs K % 256 == 0). ``w_scales``:
    (1, N) or (N,). ``act_quant`` (W8A8): x is quantized per row
    (``quantize_rows``) and the products run int8 x int8 with int32
    accumulation; the epilogue multiplies by the column scale, then the
    row scale.
    """
    if bits not in (8, 4):
        raise ValueError(f"quantized_matmul takes bits 8 or 4, got {bits}")
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    kw = w_values.shape[0] * (2 if bits == 4 else 1)
    if kw != k:
        raise ValueError(f"contraction mismatch: x K={k}, w K={kw}")
    if bits == 4 and k % INT4_GROUP:
        raise ValueError("int4 fused matmul requires K % 256 == 0 "
                         "(grouped nibble packing)")
    n = w_values.shape[1]
    x2 = x.reshape(-1, k)
    x_scales = None
    if act_quant:
        x2, x_scales = quantize_rows(x2)
    if _route(x2, "quantized_matmul"):
        out = _qmm_cuda(x2, x_scales, w_values, w_scales, bits, out_dtype)
    else:
        out = quantized_matmul_reference(x2, x_scales, w_values, w_scales,
                                         bits=bits, out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], n)


def quantized_matmul_argmax_reference(x2: torch.Tensor, w_values: torch.Tensor,
                                      w_scales: torch.Tensor
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 on x (M, K): (first argmax (M,) int32, max (M,) f32)."""
    w = w_values.to(x2.dtype).float()
    logits = (x2.float() @ w) * w_scales.reshape(1, -1).float()
    val, idx = torch.max(logits, dim=-1)
    return idx.to(torch.int32), val


def _qmm_argmax_cuda(x2, w_values, w_scales, plan: Optional[ArgmaxPlan] = None):
    m, k = x2.shape
    n = w_values.shape[1]
    plan = plan or qmm_argmax_plan(m, k, n, x2.dtype)
    ops = _build.ops()
    dev = x2.device
    part_val = torch.empty((m, plan.slots), dtype=torch.float32, device=dev)
    part_idx = torch.empty((m, plan.slots), dtype=torch.int32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    val = torch.empty((m,), dtype=torch.float32, device=dev)
    ops.qmm_argmax(aligned16(x2), aligned16(w_values),
                   w_scales.reshape(-1).float().contiguous(), idx, val,
                   part_val, part_idx, plan.bm, plan.ctas, plan.producer == "tma")
    _build.LAUNCHES["qmm_argmax"] += 1
    return idx, val


def quantized_matmul_argmax(x: torch.Tensor, w_values: torch.Tensor,
                            w_scales: torch.Tensor, *,
                            return_max: bool = False):
    """argmax_N(x (..., M, K) @ dequant(w) (K, N)) -> (..., M) int32.

    ``return_max=True`` also returns the winning logits (..., M) f32.
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    if w_values.shape[0] != k:
        raise ValueError(f"contraction mismatch: x K={k}, w K={w_values.shape[0]}")
    x2 = x.reshape(-1, k)
    if _route(x2, "quantized_matmul_argmax"):
        idx, val = _qmm_argmax_cuda(x2, w_values, w_scales)
    else:
        idx, val = quantized_matmul_argmax_reference(x2, w_values, w_scales)
    idx, val = idx.reshape(lead), val.reshape(lead)
    return (idx, val) if return_max else idx
