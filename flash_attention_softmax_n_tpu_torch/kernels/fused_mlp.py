"""The decode SwiGLU MLP over int8 weights in one kernel: K9.

Counterpart of ``fused_mlp_matmul`` and ``mlp_fusion_eligible``
(``flash_attention_softmax_n_tpu/kernels/fused_mlp.py``):

    y = ((silu((x @ Wg) * sg) * ((x @ Wu) * su)) @ Wd) * sd

with g and u accumulated in f32 and scaled before the silu, h = silu(g)*u
rounded to x's type before the down product, and sd applied after the
down product's accumulation. On a CUDA tensor the hand-written kernel
(``csrc/fused_mlp.cu``) runs; on a CPU tensor the plain version
``fused_mlp_reference`` does. For bf16 x the kernel runs two tensor-core
phases, planned here by ``fused_mlp_plan``: x @ [Wg | Wu] into h, then
h @ Wd; f32 x takes a scalar kernel.

``mlp_fusion_eligible`` is JAX's routing predicate, copied with its TPU
VMEM arithmetic: it decides which function the decoder computes (the fused
block and the two-matmul block round at different places), so the port
must route exactly as JAX does. It sets no tile of K9.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from flash_attention_softmax_n_tpu_torch.kernels import _build
from flash_attention_softmax_n_tpu_torch.kernels.quant_matmul import (
    QmmPlan,
    aligned16,
    wgmma_plan,
)

__all__ = ["fused_mlp_matmul", "fused_mlp_reference", "mlp_fusion_eligible",
           "MlpPlan", "fused_mlp_plan"]

# JAX's per-kernel scoped-VMEM budget on v5e (kernels/quant_matmul.py),
# kept only for the routing predicate
VMEM_BUDGET = 11 * 1024 * 1024


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _pick_block_f(f: int, budget_bytes: int, k: int, bm: int) -> Optional[int]:
    """JAX's FF tile: the largest 128-multiple dividing F that fits the
    VMEM budget (double-buffered int8 wg, wu, wd tiles, the f32 g/u and
    bf16 h tiles, the fixed x and f32 accumulator); None if none does."""
    fixed = 2 * bm * k + 4 * bm * k
    avail = budget_bytes - fixed
    if avail <= 0:
        return None
    cap = avail // (6 * k + 10 * bm)
    best = None
    for mult in range(1, f // 128 + 1):
        bf = 128 * mult
        if f % bf == 0 and bf <= cap:
            best = bf
    return best


def mlp_fusion_eligible(m_total: int, k: int, f: int, bits: int) -> bool:
    """Static predicate: does the JAX decoder route this shape to the fused
    MLP kernel?"""
    return (m_total <= 512 and bits == 8 and k % 128 == 0
            and _pick_block_f(f, VMEM_BUDGET, k,
                              min(256, _round_up(m_total, 8))) is not None)


# K splits of the down product at most: at M64 K2048 F5632 its partials'
# round trip is then 2 * 4 * 64 * 2048 * 4 bytes = 4.2 MB, which keeps K9's
# device-memory traffic within 1.2x its 34.6 MB of weights
_DOWN_MAX_SPLITS = 4


class MlpPlan(NamedTuple):
    """How ``csrc/fused_mlp.cu`` runs one (M, K, F) MLP."""

    kernel: str                  # "wgmma" (bf16 x) or "scalar" (f32 x)
    gate_up: Optional[QmmPlan]   # x @ [Wg | Wu] -> h: 64 d_ff columns of each a tile
    down: Optional[QmmPlan]      # h @ Wd: K7's tiles, at most _DOWN_MAX_SPLITS splits


def fused_mlp_plan(m: int, k: int, f: int, x_dtype: torch.dtype) -> MlpPlan:
    """K9's plan for x (M, K) of ``x_dtype`` and d_ff F: for bf16 x the
    tensor-core plan of each phase (``quant_matmul.wgmma_plan``; the gate/up
    phase's stage carries 64 columns of both Wg and Wu), for f32 x the
    scalar kernel."""
    if x_dtype == torch.float32:
        return MlpPlan("scalar", None, None)
    if x_dtype != torch.bfloat16:
        raise ValueError(f"fused_mlp_matmul takes bf16 or f32 inputs, got {x_dtype}")
    return MlpPlan("wgmma", wgmma_plan(m, k, f, dual=True),
                   wgmma_plan(m, f, k, max_splits=_DOWN_MAX_SPLITS))


def fused_mlp_reference(x2, wg_values, wg_scales, wu_values, wu_scales,
                        wd_values, wd_scales) -> torch.Tensor:
    """Plain version of K9 on x (M, K)."""
    g = (x2.float() @ wg_values.float()) * wg_scales.reshape(1, -1).float()
    u = (x2.float() @ wu_values.float()) * wu_scales.reshape(1, -1).float()
    h = (F.silu(g) * u).to(x2.dtype)
    out = (h.float() @ wd_values.float()) * wd_scales.reshape(1, -1).float()
    return out.to(x2.dtype)


def _phase_ints(p: QmmPlan):
    return [p.bm, p.stages, p.splits, p.slices_per_split, int(p.producer == "tma")]


def _fused_mlp_cuda(x2, wg, sg, wu, su, wd, sd):
    m, k = x2.shape
    f = wg.shape[1]
    plan = fused_mlp_plan(m, k, f, x2.dtype)
    ops = _build.ops()
    dev = x2.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def vec(s):
        return s.reshape(-1).float().contiguous()

    out = torch.empty((m, k), dtype=x2.dtype, device=dev)
    h = dn_part = f32(0)
    if plan.kernel == "scalar":
        gu_part, ints = f32(ops.fused_mlp_tiles(f), m, k), []
    else:
        gu, dn = plan.gate_up, plan.down
        h = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
        gu_part = f32(2 * gu.splits, m, f) if gu.splits > 1 else f32(0)
        if dn.splits > 1:
            dn_part = f32(dn.splits, m, k)
        ints = _phase_ints(gu) + _phase_ints(dn)
    ops.fused_mlp(aligned16(x2), aligned16(wg), vec(sg), aligned16(wu), vec(su),
                  aligned16(wd), vec(sd), out, h, gu_part, dn_part, ints)
    _build.LAUNCHES["fused_mlp"] += 1
    return out


def fused_mlp_matmul(x: torch.Tensor,
                     wg_values: torch.Tensor, wg_scales: torch.Tensor,
                     wu_values: torch.Tensor, wu_scales: torch.Tensor,
                     wd_values: torch.Tensor, wd_scales: torch.Tensor
                     ) -> torch.Tensor:
    """silu(x @ Wg) * (x @ Wu) @ Wd with int8 weights: x (..., K) bf16 or
    f32; wg/wu int8 (K, F) with per-column scales (F,); wd int8 (F, K) with
    per-column scales (K,). Returns (..., K) in x's type. With f32 x the
    kernel takes K and F in multiples of 64."""
    k = x.shape[-1]
    f = wg_values.shape[1]
    if (tuple(wg_values.shape) != (k, f) or tuple(wu_values.shape) != (k, f)
            or tuple(wd_values.shape) != (f, k)):
        raise ValueError(
            f"shape mismatch: x K={k}, wg {tuple(wg_values.shape)}, wu "
            f"{tuple(wu_values.shape)}, wd {tuple(wd_values.shape)}")
    x2 = x.reshape(-1, k)
    args = (x2, wg_values, wg_scales, wu_values, wu_scales, wd_values,
            wd_scales)
    if x2.is_cuda:
        out = _fused_mlp_cuda(*args)
    elif x2.device.type == "cpu":
        out = fused_mlp_reference(*args)
    else:
        raise ValueError(f"fused_mlp_matmul runs on CUDA or CPU tensors, "
                         f"not {x2.device}")
    return out.reshape(x.shape)
