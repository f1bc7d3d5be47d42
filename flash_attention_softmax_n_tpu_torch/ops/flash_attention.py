"""Public fused softmax-N attention API.

Counterpart of ``flash_attention_n``
(``flash_attention_softmax_n_tpu/ops/flash_attention.py``):

  * ``implementation='auto'`` or ``'pallas'``: the fused route, kernel K1
    forward and K5/K6 backward on CUDA tensors, their plain versions on CPU
    tensors; in-kernel hash dropout; requires E == Ev;
  * ``implementation='xla'``: the unfused formulation in plain tensor ops,
    differentiated by autograd; supports E != Ev.

Inputs may be 2-D, 3-D or 4-D; 3-D K/V broadcast against 4-D Q; boolean
masks (True = attend) become an f32 bias of -f32max/2, additive biases add
to it, and both combine with ``is_causal``.

Under ``mesh`` the inputs are one rank's (batch, head) slab, as the port's
explicit shards hold them (``parallel/sharding.py``); JAX instead takes the
global arrays and ``shard_map``s the kernel over them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (
    dropout_multiplier,
    flash_attention_n_fused,
)
from flash_attention_softmax_n_tpu_torch.ops.functional import softmax_n

__all__ = ["flash_attention_n"]

_BIG_NEG = -float(np.finfo(np.float32).max) / 2


def _to_4d(x: torch.Tensor, name: str):
    """Normalize to (B, H, L, E); returns (tensor, ndim_added)."""
    if x.ndim == 4:
        return x, 0
    if x.ndim == 3:
        return x[:, None], 1
    if x.ndim == 2:
        return x[None, None], 2
    raise ValueError(f"{name} must be 2-D, 3-D, or 4-D, got {x.ndim}-D")


def _mask_to_bias(attn_mask: torch.Tensor) -> torch.Tensor:
    """Boolean attend-mask -> f32 additive bias (False -> -f32max/2: large
    enough to zero the probability, small enough to avoid inf - inf)."""
    zero = torch.zeros((), dtype=torch.float32, device=attn_mask.device)
    return torch.where(attn_mask, zero, _BIG_NEG)


def _bias_to_4d(b: torch.Tensor, L: int, S: int) -> torch.Tensor:
    if b.ndim == 2:
        b = b[None, None]
    elif b.ndim == 3:
        b = b[:, None]
    elif b.ndim != 4:
        raise ValueError("attention mask/bias must be 2-D, 3-D, or 4-D")
    if b.shape[-2] not in (1, L) or b.shape[-1] not in (1, S):
        raise ValueError(f"mask/bias trailing dims {tuple(b.shape[-2:])} "
                         f"incompatible with (L={L}, S={S})")
    if b.shape[-2] == 1 or b.shape[-1] == 1:
        b = b.expand(*b.shape[:-2], L, S)
    return b


def _slab(mesh, batch_axis, head_axis, q4, bias, bias_grad, seed):
    """(bias, seed) of this rank's (batch, head) slab under ``mesh``."""
    from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
        axis_index,
        axis_size,
    )
    from flash_attention_softmax_n_tpu_torch.parallel.sharding import (
        copy_to_axis,
    )

    names = mesh.mesh_dim_names or ()
    b_axes = tuple(a for a in ((batch_axis,) if isinstance(batch_axis, str)
                               else batch_axis or ()) if a in names)
    h_axes = (head_axis,) if head_axis in names else ()
    broadcast = []
    for dim, axes in ((0, b_axes), (1, h_axes)):
        parts = math.prod(axis_size(mesh, a) for a in axes)
        local = q4.shape[dim]
        if bias is None or parts == 1 or bias.shape[dim] == local != 1:
            continue
        if bias.shape[dim] == 1:
            broadcast += axes
        elif bias.shape[dim] == local * parts:
            bias = bias.narrow(dim, axis_index(mesh, axes) * local, local)
        else:
            raise ValueError(
                f"bias dim {dim} of size {bias.shape[dim]} does not divide "
                f"mesh axes {axes} over a slab of {local}")
    if broadcast and bias_grad:
        bias = copy_to_axis(bias, mesh, tuple(broadcast))
    if seed is not None:
        from flash_attention_softmax_n_tpu_torch.kernels.flash_attention import (  # noqa: E501
            _MIX_C,
            _MIX_D,
        )
        base = (axis_index(mesh, b_axes) * q4.shape[0] * _MIX_C
                + axis_index(mesh, h_axes) * q4.shape[1] * _MIX_D)
        # wrapping int32 arithmetic, as the hash reads its seed
        seed = ((torch.as_tensor(seed).to(torch.int64) + base + 2 ** 31)
                % 2 ** 32 - 2 ** 31).to(torch.int32)
    return bias, seed


def flash_attention_n(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    softmax_n_param: Optional[float] = None,
    scale: Optional[float] = None,
    dropout_p: float = 0.0,
    attn_mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    is_causal: bool = False,
    *,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    dropout_seed: Optional[torch.Tensor] = None,
    implementation: str = "auto",
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    mesh=None,
    batch_axis="data",
    head_axis: Optional[str] = "model",
) -> torch.Tensor:
    """Scaled-dot-product attention with softmax-N (any real n >= 0).

    ``attn_mask`` is boolean (True = attend); ``attn_bias`` is an additive
    float bias; both may combine with ``is_causal``. Dropout (``dropout_p``
    under ``train``) runs on both routes with the mask of the hash
    ``dropout_keep``, keyed on an int32 seed: ``dropout_seed`` if given,
    else one drawn from ``generator``. The fused route regenerates the mask
    in its kernels; the ``'xla'`` route materializes it. ``block_q`` and
    ``block_k`` are accepted for the JAX package's signature and ignored:
    its TPU tiling is not ported, and the kernels choose their own tiles.

    ``mesh``: the inputs are this rank's slab of a problem split evenly,
    batch over ``batch_axis`` (a name, or names outermost first) and heads
    over ``head_axis``; axes the mesh lacks, or None, are skipped. Attention
    rows are independent over batch and heads, so the kernels run on the
    slab as they are, and only the global coordinates change: the dropout
    seed takes the slab's global batch and head base (``seed + b0*C +
    h0*D``, wrapping int32; the hash is linear in b and h), so the sharded
    mask is bit-identical to the unsharded one. A bias dim of size 1 over a
    sharded axis is a broadcast: its cotangent is summed over that axis, as
    JAX's ``shard_map`` transpose sums it. A bias dim at the global size is
    sliced to the slab; any other size does not divide and raises.
    """
    n = 0.0 if softmax_n_param is None else float(softmax_n_param)
    if n < 0:
        raise ValueError(f"softmax_n_param must be >= 0, got {n}")

    q4, added = _to_4d(query, "query")
    k4, _ = _to_4d(key, "key")
    v4, _ = _to_4d(value, "value")

    # MQA-style broadcast: 3-D K/V against 4-D Q shares KV across heads
    if key.ndim == 3 and query.ndim == 4:
        k4 = key[:, None].expand(key.shape[0], q4.shape[1], *key.shape[1:])
        v4 = value[:, None].expand(value.shape[0], q4.shape[1],
                                   *value.shape[1:])

    L, S = q4.shape[-2], k4.shape[-2]
    E, Ev = q4.shape[-1], v4.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(E)

    bias = None
    if attn_mask is not None:
        if attn_mask.dtype != torch.bool:
            raise ValueError("attn_mask must be boolean (True = attend); "
                             "use attn_bias for additive float biases")
        bias = _bias_to_4d(_mask_to_bias(attn_mask), L, S)
    if attn_bias is not None:
        b4 = _bias_to_4d(attn_bias.float(), L, S)
        bias = b4 if bias is None else bias + b4

    use_dropout = dropout_p > 0.0 and train
    if use_dropout and dropout_seed is None:
        if generator is None:
            raise ValueError("dropout requires generator or dropout_seed")
        # the counterpart of JAX's jax.random.randint(rng, (), 0, int32 max):
        # a device tensor on the generator's device, so no host sync
        dropout_seed = torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                                     device=generator.device,
                                     dtype=torch.int32)
    if mesh is not None:
        bias, dropout_seed = _slab(mesh, batch_axis, head_axis, q4, bias,
                                   attn_bias is not None,
                                   dropout_seed if use_dropout else None)
    if implementation == "auto":
        implementation = "pallas" if E == Ev else "xla"
    if implementation == "pallas" and E != Ev:
        raise ValueError("pallas path requires E == Ev; use "
                         "implementation='xla'")

    if implementation == "pallas":
        out = flash_attention_n_fused(
            q4, k4, v4, softmax_n_param=n, scale=scale, bias=bias,
            is_causal=is_causal,
            dropout_rate=dropout_p if use_dropout else 0.0,
            dropout_seed=dropout_seed,
            # a boolean attend-mask is not a learned parameter: skip the
            # (B, H, L, S) dbias unless a float bias was given
            bias_needs_grad=attn_bias is not None)
    elif implementation == "xla":
        scores = torch.einsum("bhle,bhse->bhls", q4.float(),
                              k4.float()) * scale
        if bias is not None:
            scores = scores + bias
        if is_causal:
            causal = torch.ones((L, S), dtype=torch.bool,
                                device=q4.device).tril(diagonal=S - L)
            scores = scores.masked_fill(~causal, float("-inf"))
        probs = softmax_n(scores, n=n, axis=-1)
        if use_dropout:
            probs = probs * dropout_multiplier(dropout_seed, probs.shape,
                                               dropout_p, probs.device)
        out = torch.einsum("bhls,bhsv->bhlv", probs.to(q4.dtype), v4)
    else:
        raise ValueError(f"unknown implementation {implementation!r}")

    if added == 1:
        out = out[:, 0]
    elif added == 2:
        out = out[0, 0]
    return out
