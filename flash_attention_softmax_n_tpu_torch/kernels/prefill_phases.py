"""The prefill-phase ablation: kernel K10 (``csrc/prefill_phases.cu``).

Counterpart of ``_mini_kernel`` and ``mini`` in
``scripts/profile_prefill_phases.py``. Per (b, h), with q, k, v
(B, H, L, hd): ``s = q k^T`` in f32 with no scale and no ``+n``; then p by
``mode``:

  * ``dots_only``: p = s;
  * ``exp_only``: p = exp(s) (timing only: it overflows for large s);
  * ``softmax``: row max, exp, divide by the row sum;
  * ``mask_softmax``: the same after setting keys past the query to -1e30;

and ``o = round(p) v``, p rounded to v's type, f32 sums, o in q's type.
Each mode strips attention down to a phase, so their times say where an
attention forward spends its time. ``mini`` launches K10 on a CUDA tensor
and runs the plain version ``mini_reference`` on a CPU tensor;
``mini_tolerance`` bounds how far two correct bf16 results lie apart. K10
is built for head dims 32, 64, 128, 256 and the multiples of 128 above, as
K1 is; on a CUDA tensor ``mini`` zero-pads any other hd up to the next of
them and slices o back, which is exact: zero columns change neither s nor
p and give zero columns of o.
"""

from __future__ import annotations

import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build
from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    _cut_head, _pad_head, kernel_head_dim)

__all__ = ["MODES", "mini", "mini_reference", "mini_tolerance"]

MODES = ("dots_only", "exp_only", "softmax", "mask_softmax")
MASKED = -1e30


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _probabilities(mode: str, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """p of ``mode`` in f32, before its rounding to v's type: (B, H, L, L)."""
    _check_mode(mode)
    s = q.float() @ k.float().transpose(-1, -2)
    if mode == "exp_only":
        return torch.exp(s)
    if mode == "dots_only":
        return s
    if mode == "mask_softmax":
        pos = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, MASKED)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    return p / torch.sum(p, dim=-1, keepdim=True)


def mini_reference(mode: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Plain version of K10: materializes the (B, H, L, L) f32 scores."""
    p = _probabilities(mode, q, k)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def mini_tolerance(mode: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """How far a bf16 result may lie from ``o``, another correct one, per
    element: o rounds one bf16 ulp apart (2^-7 |o|), and one p of the row
    may round to bf16 the other way, since each side forms p from f32 values
    summed in its own order (2^-7 of the row's largest |p| times its head's
    largest |v|)."""
    p_max = _probabilities(mode, q, k).abs().amax(-1, keepdim=True)
    v_max = v.float().abs().amax((-2, -1), keepdim=True)
    return 2.0 ** -7 * (o.float().abs() + p_max * v_max)


def _mini_cuda(mode: str, q, k, v):
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    q, k, v = (_pad_head(t, dp).contiguous() for t in (q, k, v))
    o = torch.empty_like(q)
    _build.ops().prefill_phase(q, k, v, o, MODES.index(mode))
    _build.LAUNCHES[f"mini_{mode}"] += 1
    return _cut_head(o, d)


def mini(mode: str, q: torch.Tensor, k: torch.Tensor,
         v: torch.Tensor) -> torch.Tensor:
    """K10 on CUDA tensors (at ``kernel_head_dim``), its plain version on
    CPU tensors. q, k, v (B, H, L, hd) bf16 or f32, any hd."""
    _check_mode(mode)
    if q.is_cuda:
        return _mini_cuda(mode, q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"mini runs on CUDA or CPU tensors, not {q.device}")
    return mini_reference(mode, q, k, v)
