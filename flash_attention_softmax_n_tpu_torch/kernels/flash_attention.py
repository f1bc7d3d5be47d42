"""Fused softmax-N flash attention: kernels K1 (forward), K5 and K6
(backward), their plain versions, and the autograd binding.

Counterpart of ``flash_attention_softmax_n_tpu/kernels/flash_attention.py``.
The ``+n`` enters as a phantom key with score 0 and value 0, so the online
softmax starts from ``m = 0, l = n`` (n > 0) and the stored residual is
``lse = log(n + sum_j exp(s_j))``. With it the backward is the standard
flash backward: ``p = exp(s - lse)`` are the softmax-N probabilities and
``ds = p * (dp - delta)``, ``delta = rowsum(do * o)``.

``flash_fwd`` and ``flash_bwd`` pick by the tensors' device: a CUDA tensor
launches the hand-written kernels (``csrc/flash_fwd.cu`` K1,
``csrc/flash_bwd_dq.cu`` K5, ``csrc/flash_bwd_dkv.cu`` K6), a CPU tensor
runs ``flash_fwd_reference`` / ``flash_bwd_reference``, the same arithmetic
in plain PyTorch. L and S need no padding: the kernels mask ragged tiles
themselves. The TPU's block policy, causal staircase and compiler fences
have no counterpart here.

Dropout is a counter-based hash of the global coordinates (seed, b, h,
q_pos, k_pos), so the forward and both backward kernels regenerate one mask
without storing it, and the mask is bit-equal to the JAX package's for the
same seed.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build

__all__ = ["flash_attention_n_fused", "flash_attention_block_grads",
           "flash_fwd", "flash_fwd_reference", "flash_bwd",
           "flash_bwd_reference", "dropout_keep", "dropout_multiplier",
           "NEG_INF", "DEAD_LSE"]

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
# any real lse is above DEAD_LSE; only the dead-row sentinel NEG_INF is
# below, and the backward clamps lse there so dead rows get p = 0
DEAD_LSE = 0.5 * NEG_INF

# ----------------------------------------------------------------------------
# Dropout hash: murmur3's finalizer over the global coordinates, in uint32
# arithmetic. Torch has no uint32 multiply and its int32 ``>>`` is
# arithmetic, so the plain version holds each value in [0, 2^32) as int64
# and multiplies in 16-bit halves to stay clear of int64 overflow.
# ----------------------------------------------------------------------------

_MIX_A = 0x9E3779B9  # golden-ratio odd constants
_MIX_B = 0x85EBCA6B
_MIX_C = 0xC2B2AE35
_MIX_D = 0x27D4EB2F
_M32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32)."""
    return (((((x >> 16) * c) & _M32) << 16) + (x & 0xFFFF) * c) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX_B)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX_C)
    return x ^ (x >> 16)


def _keep_threshold(rate: float) -> int:
    return min(int(round(rate * 2147483648.0)), 2147483647)


def dropout_keep(seed, b, h, q_pos, k_pos, rate: float) -> torch.Tensor:
    """Deterministic Bernoulli(1 - rate) keep mask from global coordinates.

    Integer arguments are ints or integer tensors that broadcast; ``seed``
    is read as an int32 (negative and wrapping seeds included). Keeps where
    ``(fmix32(q*A + k*B + b*C + h*D + seed) & 0x7FFFFFFF) >= round(rate *
    2^31)``, all in wrapping 32-bit arithmetic.
    """
    x = (_mul32(_u32(q_pos), _MIX_A) + _mul32(_u32(k_pos), _MIX_B)
         + _mul32(_u32(b), _MIX_C) + _mul32(_u32(h), _MIX_D) + _u32(seed))
    u = _fmix32(x & _M32) & 0x7FFFFFFF
    return u >= _keep_threshold(rate)


def dropout_multiplier(seed: torch.Tensor, shape, rate: float,
                       device) -> torch.Tensor:
    """(B, H, L, S) f32 inverted-dropout multiplier: 1/(1-rate) or 0."""
    B, H, L, S = shape
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    keep = dropout_keep(seed.to(device).reshape(()), ar(B)[:, None, None, None],
                        ar(H)[None, :, None, None], ar(L)[None, None, :, None],
                        ar(S)[None, None, None, :], rate)
    mult = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device)
    return torch.where(keep, mult, 0.0)


def _dropout_args(rate: float) -> Tuple[int, float]:
    """The kernels' (keep threshold, f32 multiplier) for ``rate``."""
    return _keep_threshold(rate), float(np.float32(1.0 / (1.0 - rate)))


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------


def _scores_reference(q, k, bias, slopes, *, scale, is_causal):
    """(q scaled in q's dtype as f32, f32 (B,H,L,S) masked scores) as the
    kernels form them: bias, then ALiBi, then the causal mask."""
    L, S = q.shape[2], k.shape[2]
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    s = qs @ k.float().transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    qpos = torch.arange(L, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    if slopes is not None:
        dist = (qpos + (S - L) - kpos).float().abs()
        s = s - slopes.float()[:, None, None] * dist
    if is_causal:
        s = torch.where(kpos <= qpos + (S - L), s, NEG_INF)
    return qs, s


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], *, n: float,
                        scale: float, is_causal: bool,
                        slopes: Optional[torch.Tensor] = None,
                        seed: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (o (B,H,L,D) in q's dtype, lse (B,H,L) f32).

    q (B,H,L,D), k/v (B,H,S,D); bias None or f32 broadcastable to
    (B,H,L,S); slopes None or (H,) f32 ALiBi slopes; seed a 1-element int32
    tensor when ``dropout_rate > 0``. The scale folds into q in q's dtype;
    scores and statistics are f32; l sums the undropped p, and p is then
    dropped and rounded to v's dtype before the PV product.
    """
    _, s = _scores_reference(q, k, bias, slopes, scale=scale,
                             is_causal=is_causal)
    m = torch.amax(s, dim=-1, keepdim=True)
    if n > 0:
        m = torch.clamp(m, min=0.0)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if n > 0:
        l = l + n * torch.exp(-m)
    if dropout_rate > 0.0:
        p = p * dropout_multiplier(seed, p.shape, dropout_rate, q.device)
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


def flash_bwd_reference(q, k, v, bias, slopes, seed, o, lse, do, *,
                        scale: float, is_causal: bool,
                        dropout_rate: float = 0.0, grad_bias: bool = True,
                        grad_slopes: bool = True,
                        delta: Optional[torch.Tensor] = None):
    """Plain version of K5 and K6: (dq, dk, dv, dbias, dslopes).

    Arguments as ``flash_fwd_reference``, with the forward's o and lse (or,
    for ``flash_attention_block_grads``, a caller's) and the cotangent do.
    Rounding points follow the kernels: lse is clamped at DEAD_LSE,
    ``p = exp(s - lse)``, dp = do v^T in f32 times the dropout multiplier,
    ``ds = p (dp - delta)``; ds is rounded to k's dtype for dq (times the
    scale) and to q's dtype for dk (against the scaled q); dv takes the
    dropped p in f32 against do widened to f32, as the JAX kernel does (the
    bf16 kernel rounds it to bf16 for the tensor cores, within the card
    tests' tolerance). dbias is ds as f32 (B,H,L,S) when a bias is given
    and ``grad_bias``; dslopes (H,) is the sum of ``ds * -|dist|`` over
    batch and positions when slopes are given and ``grad_slopes``. A
    caller's ``delta`` (B,H,L) f32 stands for ``rowsum(do * o)``.
    """
    qs, s = _scores_reference(q, k, bias, slopes, scale=scale,
                              is_causal=is_causal)
    p = torch.exp(s - torch.clamp(lse, min=DEAD_LSE)[..., None])
    do = do.to(q.dtype).float()
    delta = (torch.sum(do * o.float(), dim=-1, keepdim=True) if delta is None
             else delta.float()[..., None])
    dp = do @ v.float().transpose(-1, -2)
    pd = p
    if dropout_rate > 0.0:
        mult = dropout_multiplier(seed, p.shape, dropout_rate, q.device)
        dp = dp * mult
        pd = p * mult
    ds = p * (dp - delta)
    dq = ((ds.to(k.dtype).float() @ k.float()) * scale).to(q.dtype)
    dk = (ds.to(q.dtype).float().transpose(-1, -2) @ qs).to(k.dtype)
    dv = (pd.transpose(-1, -2) @ do).to(v.dtype)
    dbias = ds if bias is not None and grad_bias else None
    dslopes = None
    if slopes is not None and grad_slopes:
        L, S = q.shape[2], k.shape[2]
        qpos = torch.arange(L, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        dist = (qpos + (S - L) - kpos).float().abs()
        dslopes = torch.sum(ds * -dist, dim=(0, 2, 3))
    return dq, dk, dv, dbias, dslopes


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------


def _plane_bias(bias, L, S):
    """The kernels read contiguous f32 (L, S) planes; broadcast batch and
    head axes of size 1 stay so."""
    if bias is None:
        return None
    if bias.ndim != 4:
        raise ValueError("bias must be (B|1, H|1, L, S)")
    return bias.float().expand(bias.shape[0], bias.shape[1], L,
                               S).contiguous()


def _scale_q(scale: float, dtype) -> float:
    # the Pallas kernels multiply q by the scale cast to q's dtype
    return float(torch.tensor(scale, dtype=dtype))


def _opt_f32(t):
    return None if t is None else t.float().contiguous()


def _seed_arg(seed, rate, device):
    if rate <= 0.0:
        return None
    return seed.to(device=device, dtype=torch.int32).reshape(1)


def _flash_fwd_cuda(q, k, v, bias, slopes, seed, *, n, scale, is_causal,
                    dropout_rate):
    B, H, L, _ = q.shape
    S = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    thresh, mult = _dropout_args(dropout_rate)
    _build.ops().flash_fwd(q, k, v, _plane_bias(bias, L, S), _opt_f32(slopes),
                           _seed_arg(seed, dropout_rate, q.device), o, lse,
                           _scale_q(scale, q.dtype), float(n),
                           bool(is_causal), thresh, mult)
    _build.LAUNCHES["flash_fwd"] += 1
    return o, lse


def _flash_bwd_cuda(q, k, v, bias, slopes, seed, o, lse, do, *, scale,
                    is_causal, dropout_rate, grad_bias, grad_slopes,
                    delta=None):
    B, H, L, _ = q.shape
    S = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    # delta = rowsum(do * o) stays a torch op, as JAX leaves it to XLA
    delta = (torch.sum(do.float() * o.float(), dim=-1) if delta is None
             else delta.float().contiguous())
    lse = lse.float().contiguous()
    bias_p = _plane_bias(bias, L, S)
    slopes = _opt_f32(slopes)
    seed = _seed_arg(seed, dropout_rate, q.device)
    thresh, mult = _dropout_args(dropout_rate)
    scale_q = _scale_q(scale, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = (torch.empty((B, H, L, S), dtype=torch.float32, device=q.device)
             if bias is not None and grad_bias else None)
    # one partial per (b, h, query row), summed below in a fixed order: no
    # atomics, so two calls give bit-identical gradients
    dslope_rows = (torch.empty((B, H, L), dtype=torch.float32, device=q.device)
                   if slopes is not None and grad_slopes else None)
    ops = _build.ops()
    ops.flash_bwd_dq(q, k, v, bias_p, slopes, seed, do, lse, delta, dq, dbias,
                     dslope_rows, scale_q, float(scale), bool(is_causal),
                     thresh, mult)
    _build.LAUNCHES["flash_bwd_dq"] += 1
    ops.flash_bwd_dkv(q, k, v, bias_p, slopes, seed, do, lse, delta, dk, dv,
                      scale_q, bool(is_causal), thresh, mult)
    _build.LAUNCHES["flash_bwd_dkv"] += 1
    dslopes = (torch.sum(dslope_rows, dim=(0, 2))
               if dslope_rows is not None else None)
    return dq, dk, dv, dbias, dslopes


def _check_device(q, what):
    if q.device.type != "cpu":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not {q.device}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, n: float, scale: float,
              is_causal: bool, slopes: Optional[torch.Tensor] = None,
              seed: Optional[torch.Tensor] = None, dropout_rate: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    kw = dict(n=n, scale=scale, is_causal=is_causal, slopes=slopes, seed=seed,
              dropout_rate=dropout_rate)
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, bias, **kw)
    _check_device(q, "flash_fwd")
    return flash_fwd_reference(q, k, v, bias, **kw)


def flash_bwd(q, k, v, bias, slopes, seed, o, lse, do, *, scale: float,
              is_causal: bool, dropout_rate: float = 0.0,
              grad_bias: bool = True, grad_slopes: bool = True,
              delta: Optional[torch.Tensor] = None):
    """K5 and K6 on CUDA tensors, their plain version on CPU tensors:
    (dq, dk, dv, dbias (B,H,L,S) f32 or None, dslopes (H,) f32 or None).
    ``delta`` (B,H,L) f32, if given, is ``rowsum(do * o)`` computed once by
    the caller."""
    kw = dict(scale=scale, is_causal=is_causal, dropout_rate=dropout_rate,
              grad_bias=grad_bias, grad_slopes=grad_slopes, delta=delta)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, bias, slopes, seed, o, lse, do, **kw)
    _check_device(q, "flash_bwd")
    return flash_bwd_reference(q, k, v, bias, slopes, seed, o, lse, do, **kw)


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K5/K6 backward (counterpart of JAX's custom_vjp
    ``_flash``). lse is a non-differentiable second output."""

    @staticmethod
    def forward(ctx, q, k, v, bias, slopes, seed, n, scale, is_causal,
                dropout_rate, bias_needs_grad):
        o, lse = flash_fwd(q, k, v, bias, n=n, scale=scale,
                           is_causal=is_causal, slopes=slopes, seed=seed,
                           dropout_rate=dropout_rate)
        ctx.save_for_backward(q, k, v, bias, slopes, seed, o, lse)
        ctx.cfg = (scale, is_causal, dropout_rate, bias_needs_grad)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, slopes, seed, o, lse = ctx.saved_tensors
        scale, is_causal, dropout_rate, bias_needs_grad = ctx.cfg
        grad_bias = (bias is not None and bias_needs_grad
                     and ctx.needs_input_grad[3])
        grad_slopes = slopes is not None and ctx.needs_input_grad[4]
        dq, dk, dv, dbias, dslopes = flash_bwd(
            q, k, v, bias, slopes, seed, o, lse, do, scale=scale,
            is_causal=is_causal, dropout_rate=dropout_rate,
            grad_bias=grad_bias, grad_slopes=grad_slopes)
        if dbias is not None:
            # reduce to the bias's broadcast shape, as autograd would
            dims = [i for i in (0, 1) if bias.shape[i] == 1]
            if dims:
                dbias = torch.sum(dbias, dim=dims, keepdim=True)
            dbias = dbias.to(bias.dtype)
        return (dq, dk, dv, dbias, dslopes) + (None,) * 6


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
    bias_needs_grad: bool = True,
    return_residuals: bool = False,
):
    """Fused softmax-N flash attention on (B, H, L, E) inputs, differentiable.

    ``bias`` is an additive float bias broadcastable as (B|1, H|1, L, S),
    differentiable unless ``bias_needs_grad=False`` (a non-learned mask:
    the (B, H, L, S) f32 cotangent is then never formed).
    ``alibi_slopes`` (H,) applies ``-slope_h * |q_pos + (S - L) - k_pos|``
    in the kernel, also differentiable. ``dropout_rate``/``dropout_seed``
    (an int or int32 tensor): in-kernel inverted dropout of the normalized
    weights from the hash ``dropout_keep``, regenerated by the backward.
    ``return_residuals=True`` also returns ``lse`` (B, H, L) f32.
    """
    if query.ndim != 4 or key.ndim != 4 or value.ndim != 4:
        raise ValueError("flash_attention_n_fused expects (B, H, L, E) tensors")
    if key.shape[-1] != query.shape[-1]:
        raise ValueError("query/key head dims must match")
    if value.shape[-1] != key.shape[-1]:
        raise ValueError("fused kernel requires E == Ev (use the xla path)")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if bias is not None and bias.ndim != 4:
        raise ValueError("bias must be 4-D (B|1, H|1, L, S)")
    seed = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        seed = torch.as_tensor(dropout_seed, device=query.device).to(
            torch.int32).reshape(1)
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(query.shape[1])
    out, lse = _FlashAttention.apply(
        query, key, value, bias, slopes, seed, float(softmax_n_param),
        float(scale), bool(is_causal), float(dropout_rate),
        bool(bias_needs_grad))
    if return_residuals:
        return out, lse
    return out


def flash_attention_block_grads(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    scale: Optional[float] = None,
    is_causal: bool = False,
    delta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward of ONE kv block against an external normalizer.

    The ring-attention building block: ``lse`` (B, H, L) f32 is the global
    ``log(n + sum_j exp(s_j))`` over the full key range, ``out``/``dout``
    the global output and its cotangent. Returns (dq, dk, dv) of this block
    through K5/K6 (their plain version on CPU tensors). Ragged query rows
    are masked in the kernels, so nothing is padded. ``delta`` (B, H, L)
    f32 is ``rowsum(dout * out)``: a ring computes it once for all its
    blocks; None computes it here.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    dq, dk, dv, _, _ = flash_bwd(query, key, value, None, None, None, out,
                                 lse, dout, scale=float(scale),
                                 is_causal=bool(is_causal), delta=delta)
    return dq, dk, dv
