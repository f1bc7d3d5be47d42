"""In-place KV row writes for decode: kernels K3 (cache_append) and K4
(tail_append).

Counterpart of ``flash_attention_softmax_n_tpu/kernels/cache_update.py``.
Both write into the caller's tensors in place and return them. On CUDA
tensors the hand-written kernels (``csrc/cache_update.cu``) run; on CPU
tensors the plain versions ``*_reference`` do.
"""

from __future__ import annotations

from typing import Tuple

import torch

from flash_attention_softmax_n_tpu_torch.kernels import _build
from flash_attention_softmax_n_tpu_torch.quant.qtensor import as_bytes

__all__ = ["cache_append", "cache_append_reference", "tail_append",
           "tail_append_reference"]


def cache_append_reference(caches: Tuple[torch.Tensor, ...],
                           news: Tuple[torch.Tensor, ...],
                           positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of K3: caches[i][l, b, :, positions[b]] = news[i][l, b]
    (fp8 rows move as bytes)."""
    b = torch.arange(positions.shape[0], device=positions.device)
    pos = positions.long()
    for c, nw in zip(caches, news):
        # (NL, B, KVH, S, D) viewed as (B, S, NL, KVH, D)
        rows = as_bytes(nw.to(c.dtype)).permute(1, 0, 2, 3)
        as_bytes(c).permute(1, 3, 0, 2, 4)[b, pos] = rows
    return tuple(caches)


def tail_append_reference(k_tail: torch.Tensor, v_tail: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: tail[:, :, :, index] = new for k and v."""
    k_tail[:, :, :, index] = k_new.to(k_tail.dtype)
    v_tail[:, :, :, index] = v_new.to(v_tail.dtype)
    return k_tail, v_tail


def _as_rows(new: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``new`` as the operator takes it: ``dst``'s dtype, contiguous. Cast
    and copy only where needed, as the plain versions cast; the engine's
    rows need neither, so its decode steps convert nothing."""
    if new.dtype != dst.dtype:
        new = new.to(dst.dtype)
    if not new.is_contiguous():
        new = new.contiguous()
    return new


def _cache_append_cuda(caches, news, positions):
    # the operator checks device, shapes, dtypes and contiguity
    if positions.dtype != torch.int32:
        positions = positions.to(torch.int32)
    news = tuple(_as_rows(n, c) for n, c in zip(news, caches))
    _build.ops().cache_append(caches, news, positions)
    _build.LAUNCHES["cache_append"] += 1
    return tuple(caches)


def cache_append(caches: Tuple[torch.Tensor, ...],
                 news: Tuple[torch.Tensor, ...],
                 positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Write ``news[i][l, b]`` into ``caches[i][l, b, :, positions[b], :]``.

    caches[i] (NL, B, KVH, S, D_i); news[i] (NL, B, KVH, D_i), cast to
    the cache's dtype; positions (B,) int32 in [0, S), clamped by the caller (the
    kernel skips rows at positions outside it). Writes in place and returns
    the caches.
    """
    if caches[0].is_cuda:
        return _cache_append_cuda(caches, news, positions)
    return cache_append_reference(caches, news, positions)


def _tail_append_cuda(k_tail, v_tail, k_new, v_new, index):
    k_new, v_new = _as_rows(k_new, k_tail), _as_rows(v_new, v_tail)
    _build.ops().tail_append(k_tail, v_tail, k_new, v_new, int(index))
    _build.LAUNCHES["tail_append"] += 1
    return k_tail, v_tail


def tail_append(k_tail: torch.Tensor, v_tail: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor,
                index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write ``new[l, b]`` into ``tail[l, b, :, index, :]`` at one ring index
    shared by every slot, in place. k/v_tail (NL, B, KVH, W, D); k/v_new
    (NL, B, KVH, D), cast to the ring's dtype."""
    if k_tail.is_cuda:
        return _tail_append_cuda(k_tail, v_tail, k_new, v_new, index)
    return tail_append_reference(k_tail, v_tail, k_new, v_new, index)
