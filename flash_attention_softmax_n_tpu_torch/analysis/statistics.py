"""Moment statistics (mean, variance, skewness, excess kurtosis) and the
statistics of softmax-N attention probabilities.

Counterpart of ``flash_attention_softmax_n_tpu/analysis/statistics.py``:
plain reductions in float32 that stay on the tensor's device, so a running
collector never waits for the host.

* ``kurtosis`` is the *excess* kurtosis (k4 / var^2 - 3): 0 for a normal
  distribution.
* ``*_batch_mean`` compute the statistic per sample (over every axis but
  the first) and average it over the batch.
"""

from __future__ import annotations

import torch

__all__ = [
    "central_moment",
    "variance",
    "std",
    "standardized_moment",
    "skewness",
    "kurtosis",
    "mean_batch_mean",
    "variance_batch_mean",
    "skewness_batch_mean",
    "kurtosis_batch_mean",
    "null_attention_mass",
    "attention_entropy",
    "summarize_attention",
]


def central_moment(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th central moment over all elements: E[(x - E[x])^k]."""
    x = x.float()
    return torch.mean((x - torch.mean(x)) ** k)


def variance(x: torch.Tensor) -> torch.Tensor:
    return central_moment(x, 2)


def std(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(variance(x))


def standardized_moment(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th standardized moment: E[(x - mu)^k] / sigma^k."""
    return central_moment(x, k) / std(x) ** k


def skewness(x: torch.Tensor) -> torch.Tensor:
    return standardized_moment(x, 3)


def kurtosis(x: torch.Tensor) -> torch.Tensor:
    """Excess kurtosis: k4 / var^2 - 3 (0 for a normal distribution)."""
    return central_moment(x, 4) / variance(x) ** 2 - 3.0


def _central_moment_per_sample(x: torch.Tensor, k: int) -> torch.Tensor:
    x = x.float()
    axes = tuple(range(1, x.ndim))
    mu = torch.mean(x, dim=axes, keepdim=True)
    return torch.mean((x - mu) ** k, dim=axes)


def mean_batch_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x.float())


def variance_batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Per-sample variance (axes 1..ndim), then the batch mean."""
    return torch.mean(_central_moment_per_sample(x, 2))


def skewness_batch_mean(x: torch.Tensor) -> torch.Tensor:
    m2 = _central_moment_per_sample(x, 2)
    m3 = _central_moment_per_sample(x, 3)
    return torch.mean(m3 / m2 ** 1.5)


def kurtosis_batch_mean(x: torch.Tensor) -> torch.Tensor:
    m2 = _central_moment_per_sample(x, 2)
    m4 = _central_moment_per_sample(x, 4)
    return torch.mean(m4 / m2 ** 2 - 3.0)


# softmax-N lets a head attend to nothing: with n > 0 a row's probabilities
# sum to sum_j exp(s_j) / (n + sum_j exp(s_j)) < 1, and the deficit is the
# mass on the phantom key. These reductions read it off the probabilities
# that the models return under output_attentions.


def null_attention_mass(probs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Per-row mass on the phantom key, 1 - sum_j p_j, in [0, 1]: 0 for
    softmax-0. Pass pre-dropout probabilities (eval mode): inverted
    dropout's rescaling breaks the sum."""
    return 1.0 - torch.sum(probs.float(), dim=axis)


def attention_entropy(probs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Shannon entropy (nats) of each attention row with the phantom key's
    mass as one more outcome, so that it stays defined where rows do not
    sum to 1."""
    p = probs.float()
    null = torch.clamp(1.0 - torch.sum(p, dim=axis), 0.0, 1.0)
    plogp = torch.where(p > 0.0, p * torch.log(p), 0.0)
    nlogn = torch.where(null > 0.0, null * torch.log(null), 0.0)
    return -(torch.sum(plogp, dim=axis) + nlogn)


def summarize_attention(probs: torch.Tensor) -> dict:
    """Per-head summary of (B, H, L, S) or (n_layers, B, H, L, S)
    probabilities (what ``output_attentions=True`` returns in eval mode):
    over batch and query rows, {'null_mass_mean', 'null_mass_max',
    'entropy_mean'}, each (H,) or (n_layers, H)."""
    if probs.ndim not in (4, 5):
        raise ValueError(
            "expected (B, H, L, S) or (n_layers, B, H, L, S) attention "
            f"probabilities, got shape {tuple(probs.shape)}")
    null = null_attention_mass(probs)  # (..., B, H, L)
    ent = attention_entropy(probs)
    reduce_axes = (probs.ndim - 4, probs.ndim - 2)
    return {
        "null_mass_mean": torch.mean(null, dim=reduce_axes),
        "null_mass_max": torch.amax(null, dim=reduce_axes),
        "entropy_mean": torch.mean(ent, dim=reduce_axes),
    }
