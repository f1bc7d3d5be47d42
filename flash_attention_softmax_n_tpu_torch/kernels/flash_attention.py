"""Fused softmax-N flash-attention forward: kernel K1 and its plain version.

Counterpart of the forward of ``flash_attention_n_fused``
(``flash_attention_softmax_n_tpu/kernels/flash_attention.py``). The ``+n``
enters as a phantom key with score 0 and value 0, so the online softmax
starts from ``m = 0, l = n`` (n > 0) and the stored residual is
``lse = log(n + sum_j exp(s_j))``.

``flash_fwd`` picks by the tensors' device: a CUDA tensor launches the
hand-written kernel (``csrc/flash_fwd.cu``), a CPU tensor runs
``flash_fwd_reference``, the same arithmetic in plain PyTorch. L and S need
no padding: the kernel masks the ragged tile itself. The TPU's block
policy, causal staircase and compiler fences have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build

__all__ = ["flash_attention_n_fused", "flash_fwd", "flash_fwd_reference",
           "NEG_INF", "DEAD_LSE"]

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
# any real lse is above DEAD_LSE; only the dead-row sentinel NEG_INF is below
DEAD_LSE = 0.5 * NEG_INF


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], *, n: float,
                        scale: float, is_causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (o (B,H,L,D) in q's dtype, lse (B,H,L) f32).

    q (B,H,L,D), k/v (B,H,S,D); bias None or f32 broadcastable to
    (B,H,L,S). The scale folds into q in q's dtype; scores and statistics
    are f32; p is rounded to v's dtype before the PV product.
    """
    L, S = q.shape[2], k.shape[2]
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    s = qs @ k.float().transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    if is_causal:
        kpos = torch.arange(S, device=q.device)
        qpos = torch.arange(L, device=q.device)
        visible = kpos[None, :] <= qpos[:, None] + (S - L)
        s = torch.where(visible, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    if n > 0:
        m = torch.clamp(m, min=0.0)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if n > 0:
        l = l + n * torch.exp(-m)
    acc = p.to(v.dtype).float() @ v.float()
    if n == 0:
        # rows with no visible key (rectangular causal, L > S)
        dead = (l == 0.0) | (m == NEG_INF)
        l_safe = torch.where(dead, 1.0, l)
        o = torch.where(dead, 0.0, acc / l_safe)
        lse = torch.where(dead, NEG_INF, m + torch.log(l_safe))
    else:
        o = acc / l
        lse = m + torch.log(l)
    return o.to(q.dtype), lse[..., 0]


def _flash_fwd_cuda(q, k, v, bias, *, n, scale, is_causal):
    B, H, L, _ = q.shape
    S = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bias is not None:
        if bias.ndim != 4:
            raise ValueError("bias must be (B|1, H|1, L, S)")
        # the kernel reads (L, S) planes; broadcast axes of size 1 stay so
        bias = bias.float().expand(bias.shape[0], bias.shape[1], L,
                                   S).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    # the Pallas kernel multiplies q by the scale cast to q's dtype
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    _build.ops().flash_fwd(q, k, v, bias, o, lse, scale_q, float(n),
                           bool(is_causal))
    _build.LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, n: float, scale: float,
              is_causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, bias, n=n, scale=scale,
                               is_causal=is_causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    return flash_fwd_reference(q, k, v, bias, n=n, scale=scale,
                               is_causal=is_causal)


def flash_attention_n_fused(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    *,
    softmax_n_param: float = 0.0,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    return_residuals: bool = False,
):
    """Fused softmax-N flash attention forward on (B, H, L, E) inputs.

    ``bias`` is an additive float bias broadcastable as (B|1, H|1, L, S).
    ``return_residuals=True`` also returns ``lse`` (B, H, L) f32. ALiBi and
    dropout belong to the training slice and raise here.
    """
    if alibi_slopes is not None:
        raise NotImplementedError(
            "in-kernel ALiBi is not ported yet (training slice); see "
            "ROADMAP.md")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "in-kernel dropout is not ported yet (training slice); see "
            "ROADMAP.md")
    if query.ndim != 4 or key.ndim != 4 or value.ndim != 4:
        raise ValueError("flash_attention_n_fused expects (B, H, L, E) tensors")
    if key.shape[-1] != query.shape[-1]:
        raise ValueError("query/key head dims must match")
    if value.shape[-1] != key.shape[-1]:
        raise ValueError("fused kernel requires E == Ev (use the xla path)")
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if bias is not None and bias.ndim != 4:
        raise ValueError("bias must be 4-D (B|1, H|1, L, S)")
    out, lse = flash_fwd(query, key, value, bias, n=float(softmax_n_param),
                         scale=float(scale), is_causal=bool(is_causal))
    if return_residuals:
        return out, lse
    return out
