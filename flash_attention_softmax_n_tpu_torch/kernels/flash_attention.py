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
``csrc/flash_bwd_dq.cu`` K5, ``csrc/flash_bwd_dkv.cu`` K6; in f32 at head
dims 32-128 the split-TF32 kernels, K1's in ``csrc/flash_fwd_f32.cu``, K5's
and K6's in ``csrc/flash_bwd_f32.cu``, and at 256 and above K1's in
``csrc/flash_fwd_f32_wide.cu``, K5's and K6's in
``csrc/flash_bwd_f32_wide.cu``), a CPU tensor runs
``flash_fwd_reference`` / ``flash_bwd_reference``, the same arithmetic in
plain PyTorch. L and S need no padding: the kernels mask ragged tiles
themselves. The kernels are built for head dims 32, 64, 128, 256 and any
multiple of 128 above; on CUDA tensors the wrappers zero-pad any other D up
to the next of them and slice o, dq, dk and dv back (``kernel_head_dim``),
as JAX pads D to its kernel's widths (a multiple of 128). The TPU's block
policy, causal staircase and compiler fences have no counterpart here.

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
           "flash_fwd", "flash_fwd_reference", "flash_fwd_tf32x3_reference",
           "flash_bwd", "flash_bwd_reference", "flash_bwd_tf32x3_reference",
           "dropout_keep", "dropout_multiplier", "NEG_INF", "DEAD_LSE"]

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


def _scores_reference(q, k, bias, slopes, *, scale, is_causal, mm=torch.matmul):
    """(q scaled in q's dtype as f32, f32 (B,H,L,S) masked scores) as the
    kernels form them: bias, then ALiBi, then the causal mask. ``mm`` is the
    product (``flash_bwd_tf32x3_reference``'s split)."""
    L, S = q.shape[2], k.shape[2]
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    s = mm(qs, k.float().transpose(-1, -2))
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
                        dropout_rate: float = 0.0, mm=torch.matmul, mm_pv=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: (o (B,H,L,D) in q's dtype, lse (B,H,L) f32).

    q (B,H,L,D), k/v (B,H,S,D); bias None or f32 broadcastable to
    (B,H,L,S); slopes None or (H,) f32 ALiBi slopes; seed a 1-element int32
    tensor when ``dropout_rate > 0``. The scale folds into q in q's dtype;
    scores and statistics are f32; l sums the undropped p, and p is then
    dropped and rounded to v's dtype before the PV product. ``mm`` is the
    product of the two matmuls, ``mm_pv`` (if given) that of P V.
    """
    _, s = _scores_reference(q, k, bias, slopes, scale=scale,
                             is_causal=is_causal, mm=mm)
    m = torch.amax(s, dim=-1, keepdim=True)
    if n > 0:
        m = torch.clamp(m, min=0.0)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    if n > 0:
        l = l + n * torch.exp(-m)
    if dropout_rate > 0.0:
        p = p * dropout_multiplier(seed, p.shape, dropout_rate, q.device)
    acc = (mm_pv or mm)(p.to(v.dtype).float(), v.float())
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
                        delta: Optional[torch.Tensor] = None, mm=torch.matmul):
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
    caller's ``delta`` (B,H,L) f32 stands for ``rowsum(do * o)``. ``mm``
    is the product of the five matmuls.
    """
    qs, s = _scores_reference(q, k, bias, slopes, scale=scale,
                              is_causal=is_causal, mm=mm)
    p = torch.exp(s - torch.clamp(lse, min=DEAD_LSE)[..., None])
    do = do.to(q.dtype).float()
    delta = (torch.sum(do * o.float(), dim=-1, keepdim=True) if delta is None
             else delta.float()[..., None])
    dp = mm(do, v.float().transpose(-1, -2))
    pd = p
    if dropout_rate > 0.0:
        mult = dropout_multiplier(seed, p.shape, dropout_rate, q.device)
        dp = dp * mult
        pd = p * mult
    ds = p * (dp - delta)
    dq = (mm(ds.to(k.dtype).float(), k.float()) * scale).to(q.dtype)
    dk = mm(ds.to(q.dtype).float().transpose(-1, -2), qs).to(k.dtype)
    dv = mm(pd.transpose(-1, -2), do).to(v.dtype)
    dbias = ds if bias is not None and grad_bias else None
    dslopes = None
    if slopes is not None and grad_slopes:
        L, S = q.shape[2], k.shape[2]
        qpos = torch.arange(L, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        dist = (qpos + (S - L) - kpos).float().abs()
        dslopes = torch.sum(ds * -dist, dim=(0, 2, 3))
    return dq, dk, dv, dbias, dslopes


# The tensor cores read a TF32 operand from an f32 word and ignore its low 13
# bits (0xFFFFE000 keeps sign, exponent and 10 mantissa bits)
_TF32_KEEP = -8192


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read it in TF32: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & _TF32_KEEP).view(torch.float32)


def _tf32_head(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (to nearest, ties away from zero), as the kernels
    round it: 2^12 added to the bits, then the low 13 dropped."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & _TF32_KEEP).view(torch.float32)


def _tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """a @ b as K1's, K5's and K6's f32 kernels form it
    (``csrc/tf32x3.h``): each f32 operand x is its TF32 head
    (``_tf32_head``) plus its rest x - head (exact in f32, read as TF32 by
    the tensor cores, ``_tf32``); the two cross products first, then the
    heads', rest x rest dropped. ``passes=1`` is one TF32 pass over the
    operands as they stand (the tensor cores' own truncation). With
    ``chunk``, the contraction runs in chunks of that many columns of a
    (rows of b), each chunk's three passes summed on their own and the
    chunks added in f32 in order, as K1's, K5's and K6's kernels at D >=
    256 sum every product (``csrc/flash_fwd_f32_wide.cu``,
    ``csrc/flash_bwd_f32_wide.cu``: 32 columns of D for S and dP, a tile of
    keys or query rows for P V, dQ, dK and dV)."""
    if chunk is not None:
        out = None
        for c in range(0, a.shape[-1], chunk):
            part = _tf32x3_matmul(a[..., c:c + chunk], b[..., c:c + chunk, :], passes)
            out = part if out is None else out + part
        return out
    if passes == 1:
        return _tf32(a) @ _tf32(b)
    a_hi, b_hi = _tf32_head(a), _tf32_head(b)
    return (_tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi)) + a_hi @ b_hi


# K1's f32 kernel at D >= 256 (``csrc/flash_fwd_f32_wide.cu``) sums S = Q_s
# K^T in chunks of 32 columns of D and P V in tiles of 64 keys, each
# chunk's three passes on their own, added in f32
TF32X3_WIDE_FWD_CHUNK = (32, 64)


def flash_fwd_tf32x3_reference(q, k, v, bias, *, n: float, scale: float,
                               is_causal: bool, slopes=None, seed=None,
                               dropout_rate: float = 0.0, passes: int = 3,
                               chunk: Optional[Tuple[int, int]] = None):
    """``flash_fwd_reference`` in f32 with both products (q k^T and p v)
    taken as K1's split-TF32 kernels take them (``_tf32x3_matmul``;
    ``passes=1``: one TF32 pass). ``chunk`` (columns of D, keys): S in
    chunks of that many columns of D and P V in tiles of that many keys,
    each chunk's passes summed on their own and the chunks added in f32 in
    order, as the kernel at D >= 256 sums (``TF32X3_WIDE_FWD_CHUNK``; its
    two warpgroups each sum half of D's chunks in order, then add the two
    halves). A plain emulation of their numerics for the CPU tests; no path
    calls it. Sums within a chunk run in the CPU's f32 order, and p against
    the rows' final maxima where the kernels take their running ones."""
    if q.dtype != torch.float32:
        raise ValueError("the split-TF32 kernels take f32 inputs")
    s_chunk, pv_chunk = chunk if chunk is not None else (None, None)
    return flash_fwd_reference(
        q, k, v, bias, n=n, scale=scale, is_causal=is_causal, slopes=slopes,
        seed=seed, dropout_rate=dropout_rate,
        mm=lambda a, b: _tf32x3_matmul(a, b, passes, s_chunk),
        mm_pv=lambda a, b: _tf32x3_matmul(a, b, passes, pv_chunk))


def flash_bwd_tf32x3_reference(q, k, v, bias, slopes, seed, o, lse, do, *,
                               scale: float, is_causal: bool,
                               dropout_rate: float = 0.0, passes: int = 3,
                               chunk: Optional[int] = None, **kw):
    """``flash_bwd_reference`` in f32 with every product taken as the
    split-TF32 kernels take it (``_tf32x3_matmul``; ``passes=1``: one TF32
    pass; ``chunk``: in chunks of the contraction added in f32, as the
    kernels at D >= 256 sum, ``chunk=32``). A plain emulation of their
    numerics for the CPU tests; no path calls it. Sums within a product run
    in the CPU's f32 order, not the tensor cores'."""
    if q.dtype != torch.float32:
        raise ValueError("the split-TF32 kernels take f32 inputs")
    return flash_bwd_reference(
        q, k, v, bias, slopes, seed, o, lse, do, scale=scale,
        is_causal=is_causal, dropout_rate=dropout_rate,
        mm=lambda a, b: _tf32x3_matmul(a, b, passes, chunk), **kw)


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------

# the head dims the kernels are built for up to 256 (bf16 K1, K5 and K6 at
# 256 on their own TMA + wgmma kernels; f32 K1, K5 and K6 at 32, 64 and 128
# on the split-TF32 TMA + wgmma kernels, at 256 on the wide split-TF32
# ones); above, every multiple of WIDE_HEAD_DIM: bf16 K5 and K6 on their
# wide TMA + wgmma kernels and f32 K1, K5 and K6 on their wide split-TF32
# ones at every such D, bf16 K1 on its wide TMA + wgmma kernel at 384 and
# 512 (and on the wide scalar kernel above 512)
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
WIDE_HEAD_DIM = 128


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: the next of
    ``KERNEL_HEAD_DIMS``, and above 256 the next multiple of 128, as JAX
    pads D there."""
    for dp in KERNEL_HEAD_DIMS:
        if d <= dp:
            return dp
    return -(-d // WIDE_HEAD_DIM) * WIDE_HEAD_DIM


def _pad_head(t: torch.Tensor, dp: int) -> torch.Tensor:
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


def _cut_head(t: torch.Tensor, d: int) -> torch.Tensor:
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _padded_fwd(run, q, k, v, bias, **kw):
    """``run`` (K1's launch, or its plain version) at ``kernel_head_dim``:
    q, k and v zero-padded along D, o sliced back. Exact: zero columns add
    nothing to q k^T and give zero columns of o. The scale stays the
    caller's, of the true D."""
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    o, lse = run(*(_pad_head(t, dp) for t in (q, k, v)), bias, **kw)
    return _cut_head(o, d), lse


def _padded_bwd(run, q, k, v, bias, slopes, seed, o, lse, do, **kw):
    """``run`` (K5 and K6, or their plain version) at ``kernel_head_dim``:
    q, k, v, o and do zero-padded along D (delta = rowsum(do o) is
    unchanged), dq, dk and dv sliced back; dbias and dslopes as they come."""
    d = q.shape[-1]
    dp = kernel_head_dim(d)
    q, k, v, o, do = (_pad_head(t, dp) for t in (q, k, v, o, do))
    dq, dk, dv, dbias, dslopes = run(q, k, v, bias, slopes, seed, o, lse, do,
                                     **kw)
    return _cut_head(dq, d), _cut_head(dk, d), _cut_head(dv, d), dbias, dslopes


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
    """K1 on CUDA tensors (at ``kernel_head_dim``), its plain version on
    CPU tensors."""
    kw = dict(n=n, scale=scale, is_causal=is_causal, slopes=slopes, seed=seed,
              dropout_rate=dropout_rate)
    if q.is_cuda:
        return _padded_fwd(_flash_fwd_cuda, q, k, v, bias, **kw)
    _check_device(q, "flash_fwd")
    return flash_fwd_reference(q, k, v, bias, **kw)


def flash_bwd(q, k, v, bias, slopes, seed, o, lse, do, *, scale: float,
              is_causal: bool, dropout_rate: float = 0.0,
              grad_bias: bool = True, grad_slopes: bool = True,
              delta: Optional[torch.Tensor] = None):
    """K5 and K6 on CUDA tensors (at ``kernel_head_dim``), their plain
    version on CPU tensors:
    (dq, dk, dv, dbias (B,H,L,S) f32 or None, dslopes (H,) f32 or None).
    ``delta`` (B,H,L) f32, if given, is ``rowsum(do * o)`` computed once by
    the caller."""
    kw = dict(scale=scale, is_causal=is_causal, dropout_rate=dropout_rate,
              grad_bias=grad_bias, grad_slopes=grad_slopes, delta=delta)
    if q.is_cuda:
        return _padded_bwd(_flash_bwd_cuda, q, k, v, bias, slopes, seed, o,
                           lse, do, **kw)
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
