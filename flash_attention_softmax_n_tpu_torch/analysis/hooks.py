"""Running activation statistics and weight statistics.

Counterpart of ``flash_attention_softmax_n_tpu/analysis/hooks.py``, with
its functional API. The port's models are functions over parameter dicts,
not ``nn.Module``s, so there are no modules to hook: a model run with
``collect_taps=True`` returns its named activation taps, and
``update_activation_stats`` folds each into running statistics with the
streaming batch-weighted update

    w = B / (n_samples + B);  stat <- (1 - w) * stat + w * f(acts)

in float32. The statistics stay 0-dim tensors on the device; only
``activation_stats_to_dict`` copies them to the host, once.

``compute_weight_statistics`` reports {n_weights, kurtosis, skewness,
variance, mean} for each leaf of a parameter dict, named by its
'/'-joined path as the JAX package names pytree leaves: a ``QTensor``
gives ``<path>/0`` (its values) and ``<path>/1`` (its scales).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.analysis.statistics import (
    kurtosis,
    kurtosis_batch_mean,
    mean_batch_mean,
    skewness,
    skewness_batch_mean,
    variance,
    variance_batch_mean,
)
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor

__all__ = [
    "DEFAULT_LAYER_PATTERN",
    "init_activation_stats",
    "update_activation_stats",
    "register_activation_hooks",
    "activation_stats_to_dict",
    "compute_weight_statistics",
]

# taps whose name holds this are collected unless the caller names others
DEFAULT_LAYER_PATTERN = "attention.output"

_ACTIVATION_STAT_FUNCS: Dict[str, Callable] = {
    "kurtosis": kurtosis_batch_mean,
    "skewness": skewness_batch_mean,
    "variance": variance_batch_mean,
    "mean": mean_batch_mean,
}


def _check_name(name: str, layers_to_save: Optional[Iterable[str]]) -> bool:
    if layers_to_save is None:
        return DEFAULT_LAYER_PATTERN in name
    return name in set(layers_to_save)


def init_activation_stats(layer_names: Iterable[str], *, device=None) -> Dict:
    """Zero running statistics for the given tap names, on ``device``."""
    dev = resolve_device(device)
    return {
        name: {
            "n_samples": torch.zeros((), dtype=torch.int32, device=dev),
            **{s: torch.zeros((), dtype=torch.float32, device=dev)
               for s in _ACTIVATION_STAT_FUNCS},
        }
        for name in layer_names
    }


def update_activation_stats(stats: Dict, taps: Mapping[str, torch.Tensor]) -> Dict:
    """Fold one step's taps (name -> activation, batch first) into the
    running statistics; returns the new statistics. Taps that ``stats``
    does not hold are skipped."""
    new_stats = dict(stats)
    for name, acts in taps.items():
        if name not in stats:
            continue
        entry = stats[name]
        batch = acts.shape[0]
        n_prev = entry["n_samples"]
        w = batch / (n_prev.float() + batch)
        updated = {"n_samples": n_prev + batch}
        for stat_name, fn in _ACTIVATION_STAT_FUNCS.items():
            updated[stat_name] = (1.0 - w) * entry[stat_name] + w * fn(acts)
        new_stats[name] = updated
    return new_stats


def register_activation_hooks(apply_fn: Callable, layer_names: Iterable[str],
                              layers_to_save: Optional[Iterable[str]] = None,
                              *, device=None):
    """Wrap a taps-producing function into ``(hooked_fn, stats0)``.

    ``apply_fn(*args, **kwargs) -> (outputs, taps)``; ``layer_names``: every
    tap name it can produce; ``layers_to_save``: the names to collect
    (default: those holding ``'attention.output'``; a name the model has no
    tap for warns). ``hooked_fn(stats, *args, **kwargs)`` returns
    ``(outputs, new_stats)``; ``stats0`` lies on ``device``.
    """
    selected = [n for n in layer_names if _check_name(n, layers_to_save)]
    if layers_to_save is not None:
        for name in set(layers_to_save) - set(layer_names):
            warnings.warn(f"requested layer {name!r} has no activation tap")

    stats0 = init_activation_stats(selected, device=device)

    def hooked_fn(stats, *args, **kwargs):
        outputs, taps = apply_fn(*args, **kwargs)
        taps = {k: v for k, v in taps.items() if k in stats}
        return outputs, update_activation_stats(stats, taps)

    return hooked_fn, stats0


def activation_stats_to_dict(stats: Dict) -> Dict[str, Dict[str, float]]:
    """The running statistics as Python numbers, in one copy to the host;
    names and statistics in sorted order, as the JAX package's copy (a
    pytree round trip) gives them."""
    keys = [(name, k) for name in sorted(stats) for k in sorted(stats[name])]
    if not keys:
        return {}
    # f64 holds every int32 count and f32 statistic exactly
    host = torch.stack([stats[name][k].double() for name, k in keys]).tolist()
    out: Dict[str, Dict[str, float]] = {name: {} for name in sorted(stats)}
    for (name, k), v in zip(keys, host):
        out[name][k] = int(v) if k == "n_samples" else float(v)
    return out


def _leaves(tree, path=()):
    """(path, tensor) pairs in the JAX package's pytree order: dict keys
    sorted, a QTensor's values then scales under indices 0 and 1, None no
    leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, QTensor):
        yield path + ("0",), tree.values
        yield path + ("1",), tree.scales
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def compute_weight_statistics(params) -> Dict[str, Dict[str, float]]:
    """Per-leaf {n_weights, kurtosis, skewness, variance, mean} of a
    parameter dict, keyed by '/'-joined paths."""
    results = {}
    for path, leaf in _leaves(params):
        leaf = torch.as_tensor(leaf)
        stats = torch.stack([kurtosis(leaf), skewness(leaf), variance(leaf),
                             torch.mean(leaf.float())]).tolist()
        results["/".join(path)] = {
            "n_weights": int(leaf.numel()),
            **dict(zip(("kurtosis", "skewness", "variance", "mean"), stats)),
        }
    return results
