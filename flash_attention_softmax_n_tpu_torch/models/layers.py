"""Shared model building blocks: norms, rotary embeddings, GELU and
dropout.

Counterpart of ``flash_attention_softmax_n_tpu/models/layers.py``. RoPE is
half-split (not interleaved) and computed in float32. ``dropout`` draws its
mask from an explicit ``torch.Generator`` (JAX's models draw theirs from a
``jax.random`` key, so the masks differ).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "layer_norm", "rope_frequencies", "apply_rope", "gelu",
           "dropout"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with a cast back to the input dtype."""
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (normed * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm in float32 with a cast back to the input dtype (HF BERT's
    eps is 1e-12)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device=None):
    """(max_len, head_dim//2) cos/sin tables for rotary embeddings."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, L, E) by position-indexed tables.

    ``positions`` is (B, L) or (L,) absolute positions.
    """
    if positions.ndim == 1:
        positions = positions[None, :]
    c = cos[positions][:, None]  # (B, 1, L, E//2)
    s = sin[positions][:, None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return rotated.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, HF BERT's and XLNet's default."""
    return F.gelu(x, approximate="none")


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate (and
    scaled by 1 / (1 - rate)), the mask drawn from ``generator``."""
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = u.to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))
