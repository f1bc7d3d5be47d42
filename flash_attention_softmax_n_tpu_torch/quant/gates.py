"""Outlier gates: measured excess kurtosis -> per-layer quantization
decisions.

Counterpart of ``flash_attention_softmax_n_tpu/quant/gates.py``, with its
thresholds (round 5 of the JAX package, calibrated on its 181M-parameter
quantization study): the activation gate at int8 sits at the kurtosis up to
which int8 KV caching measured no perplexity cost, the weight gates key on
weight kurtosis with a tight int4 bar, and int4 activations keep a
near-Gaussian bar because nothing measured them safe. Inputs are the
statistics dicts of ``analysis.activation_stats_to_dict`` or
``analysis.compute_weight_statistics`` (or the reference library's JSON):
each entry carries 'kurtosis'.
"""

from __future__ import annotations

from typing import Dict, Mapping

__all__ = ["KURTOSIS_THRESHOLDS", "outlier_gate", "gate_report"]

# the largest acceptable excess kurtosis (normal = 0) per target and bit
# width (-8: fp8 e4m3)
KURTOSIS_THRESHOLDS: Dict[str, Dict[int, float]] = {
    "activations": {8: 150.0, 4: 3.0, -8: 150.0},
    "weights": {8: 12.0, 4: 1.0, -8: 50.0},
}


def outlier_gate(stats: Mapping[str, Mapping[str, float]],
                 bits: int = 8, target: str = "activations") -> Dict[str, bool]:
    """Per tap: may ``target`` tensors be quantized at ``bits``?"""
    if target not in KURTOSIS_THRESHOLDS:
        raise ValueError(f"unknown target {target!r}; expected one of "
                         f"{sorted(KURTOSIS_THRESHOLDS)}")
    table = KURTOSIS_THRESHOLDS[target]
    if bits not in table:
        raise ValueError(f"no threshold defined for bits={bits}")
    thr = table[bits]
    return {name: float(entry["kurtosis"]) <= thr
            for name, entry in stats.items()}


def gate_report(stats: Mapping[str, Mapping[str, float]],
                target: str = "activations") -> Dict[str, Dict]:
    """Per tap, the measured kurtosis and each bit width's verdict."""
    table = KURTOSIS_THRESHOLDS[target]
    report = {}
    for name, entry in stats.items():
        k = float(entry["kurtosis"])
        report[name] = {
            "kurtosis": k,
            "int8_ok": k <= table[8],
            "int4_ok": k <= table[4],
            "fp8_ok": k <= table[-8],
        }
    return report
