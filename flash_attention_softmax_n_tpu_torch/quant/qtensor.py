"""Quantized tensor container and int8 quantize/dequantize.

Counterpart of ``flash_attention_softmax_n_tpu/quant/qtensor.py``, int8
only: int4 and fp8 are still to be ported (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["QTensor", "quantize", "dequantize"]

INT8_MAX = 127.0


@dataclasses.dataclass
class QTensor:
    """values + scales; ``dequantize(qt) == values.float() * scales``."""

    values: torch.Tensor
    scales: torch.Tensor
    bits: int = 8
    packed_axis: Optional[int] = None

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        return tuple(self.values.shape)


def _require_int8(bits: int) -> None:
    if bits in (4, -8):
        raise NotImplementedError(
            f"bits={bits} (int4 / fp8) is not ported yet; see ROADMAP.md")
    if bits != 8:
        raise ValueError(f"unsupported bits {bits}")


def quantize(x: torch.Tensor, bits: int = 8, axis: int = -1,
             scale_dtype: torch.dtype = torch.float32) -> QTensor:
    """Symmetric quantization with per-slice absmax scales along ``axis``.

    ``axis`` is the reduction axis of the scale: a (K, N) weight with
    ``axis=0`` gets per-output-channel (1, N) scales. Rounds half to even.
    """
    _require_int8(bits)
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    scales = (absmax / INT8_MAX).to(scale_dtype)
    safe = torch.where(scales == 0, 1.0, scales.float())
    q = torch.clamp(torch.round(xf / safe), -INT8_MAX - 1, INT8_MAX)
    return QTensor(q.to(torch.int8), scales, bits=8)


def dequantize(qt: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    _require_int8(qt.bits)
    return (qt.values.float() * qt.scales.float()).to(dtype)
