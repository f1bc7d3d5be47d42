"""The decode SwiGLU MLP over int8 weights in one kernel: K9.

Counterpart of ``fused_mlp_matmul`` and ``mlp_fusion_eligible``
(``flash_attention_softmax_n_tpu/kernels/fused_mlp.py``):

    y = ((silu((x @ Wg) * sg) * ((x @ Wu) * su)) @ Wd) * sd

with g and u accumulated in f32 and scaled before the silu, h = silu(g)*u
rounded to x's type before the down product, and sd applied after the
down product's accumulation. On a CUDA tensor the hand-written kernel
(``csrc/fused_mlp.cu``) runs; on a CPU tensor the plain version
``fused_mlp_reference`` does.

``mlp_fusion_eligible`` is JAX's routing predicate, copied with its TPU
VMEM arithmetic: it decides which function the decoder computes (the fused
block and the two-matmul block round at different places), so the port
must route exactly as JAX does. It sets no tile of K9.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from flash_attention_softmax_n_tpu_torch.kernels import _build

__all__ = ["fused_mlp_matmul", "fused_mlp_reference", "mlp_fusion_eligible"]

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


def fused_mlp_reference(x2, wg_values, wg_scales, wu_values, wu_scales,
                        wd_values, wd_scales) -> torch.Tensor:
    """Plain version of K9 on x (M, K)."""
    g = (x2.float() @ wg_values.float()) * wg_scales.reshape(1, -1).float()
    u = (x2.float() @ wu_values.float()) * wu_scales.reshape(1, -1).float()
    h = (F.silu(g) * u).to(x2.dtype)
    out = (h.float() @ wd_values.float()) * wd_scales.reshape(1, -1).float()
    return out.to(x2.dtype)


def _fused_mlp_cuda(x2, wg, sg, wu, su, wd, sd):
    m, k = x2.shape
    f = wg.shape[1]
    ops = _build.ops()
    out = torch.empty((m, k), dtype=x2.dtype, device=x2.device)
    part = torch.empty((ops.fused_mlp_tiles(f), m, k), dtype=torch.float32,
                       device=x2.device)

    def vec(s):
        return s.reshape(-1).float().contiguous()

    ops.fused_mlp(x2.contiguous(), wg.contiguous(), vec(sg), wu.contiguous(),
                  vec(su), wd.contiguous(), vec(sd), out, part)
    _build.LAUNCHES["fused_mlp"] += 1
    return out


def fused_mlp_matmul(x: torch.Tensor,
                     wg_values: torch.Tensor, wg_scales: torch.Tensor,
                     wu_values: torch.Tensor, wu_scales: torch.Tensor,
                     wd_values: torch.Tensor, wd_scales: torch.Tensor
                     ) -> torch.Tensor:
    """silu(x @ Wg) * (x @ Wu) @ Wd with int8 weights: x (..., K) bf16 or
    f32; wg/wu int8 (K, F) with per-column scales (F,); wd int8 (F, K) with
    per-column scales (K,). Returns (..., K) in x's type. The kernel takes
    K and F in multiples of 64."""
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
