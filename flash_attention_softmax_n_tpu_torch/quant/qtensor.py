"""Quantized tensor container and int8 / grouped-int4 / fp8 quantize and
dequantize.

Counterpart of ``flash_attention_softmax_n_tpu/quant/qtensor.py``. fp8
(``bits=-8``) stores ``torch.float8_e4m3fn`` values with f32 absmax scales
that map each slice onto +-448, so the cast never saturates and gives JAX's
bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["QTensor", "quantize", "dequantize", "pack_int4", "unpack_int4",
           "as_bytes"]

INT4_MAX = 7.0
INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn max normal
FP8 = torch.float8_e4m3fn
INT4_GROUP = 256  # rows per packing group (two halves of 128)


@dataclasses.dataclass
class QTensor:
    """values + scales; ``dequantize(qt) == values.float() * scales``.

    ``scales`` broadcasts against the logical (unpacked) value shape. For
    int4, ``values`` holds two nibbles per byte along ``packed_axis``, kept
    negative so that the tensor stays valid when leading axes are taken
    away (one layer of a stacked weight).
    """

    values: torch.Tensor
    scales: torch.Tensor
    bits: int = 8
    packed_axis: Optional[int] = None

    @property
    def logical_shape(self) -> Tuple[int, ...]:
        shape = list(self.values.shape)
        if self.packed_axis is not None:
            shape[self.packed_axis] *= 2
        return tuple(shape)


def _check_bits(bits: int) -> None:
    if bits not in (8, 4, -8):
        raise ValueError(f"unsupported bits {bits}")


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor viewed as uint8, anything else as it is: moving fp8
    values is moving bytes, and some PyTorch ops (indexed writes,
    ``torch.where``) have no fp8 kernel on every device."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def _int4_group(axis_len: int) -> int:
    """Packing group: 256 rows when the axis tiles by it, else the whole
    axis. A byte at group row i holds original rows g*G + i (low nibble)
    and g*G + G/2 + i (high nibble), so a tile of whole groups unpacks
    without the rest of the tensor."""
    return INT4_GROUP if axis_len % INT4_GROUP == 0 else axis_len


def pack_int4(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack int8 values in [-8, 7] into nibbles, two per byte along ``axis``."""
    if x.shape[axis] % 2:
        raise ValueError(f"axis {axis} length must be even to pack int4")
    axis = axis % x.ndim
    g = _int4_group(x.shape[axis])
    shape = x.shape[:axis] + (x.shape[axis] // g, g) + x.shape[axis + 1:]
    lo, hi = torch.chunk(x.reshape(shape), 2, dim=axis + 1)
    packed = (hi.to(torch.int8) << 4) | (lo.to(torch.int8) & 0x0F)
    out_shape = x.shape[:axis] + (x.shape[axis] // 2,) + x.shape[axis + 1:]
    return packed.reshape(out_shape)


def unpack_int4(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: int8 bytes -> int8 values in [-8, 7]."""
    axis = axis % packed.ndim
    g2 = _int4_group(packed.shape[axis] * 2) // 2
    shape = (packed.shape[:axis] + (packed.shape[axis] // g2, g2)
             + packed.shape[axis + 1:])
    pg = packed.reshape(shape)
    lo = (pg << 4) >> 4  # arithmetic shifts on int8 sign-extend the nibble
    hi = pg >> 4
    out_shape = (packed.shape[:axis] + (packed.shape[axis] * 2,)
                 + packed.shape[axis + 1:])
    return torch.cat([lo, hi], dim=axis + 1).reshape(out_shape)


def quantize(x: torch.Tensor, bits: int = 8, axis: int = -1,
             scale_dtype: torch.dtype = torch.float32) -> QTensor:
    """Symmetric quantization with per-slice absmax scales along ``axis``.

    ``axis`` is the reduction axis of the scale: a (K, N) weight with
    ``axis=0`` gets per-output-channel (1, N) scales. Rounds half to even.
    ``bits=4`` packs along ``axis`` (``pack_int4``); ``bits=-8`` casts to
    fp8 e4m3 (round to nearest even).
    """
    _check_bits(bits)
    qmax = {8: INT8_MAX, 4: INT4_MAX, -8: FP8_MAX}[bits]
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    scales = (absmax / qmax).to(scale_dtype)
    safe = torch.where(scales == 0, 1.0, scales.float())
    if bits == -8:
        return QTensor((xf / safe).to(FP8), scales, bits=-8)
    q = torch.clamp(torch.round(xf / safe), -qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        ax = axis % x.ndim - x.ndim
        return QTensor(pack_int4(q, ax), scales, bits=4, packed_axis=ax)
    return QTensor(q, scales, bits=8)


def dequantize(qt: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    _check_bits(qt.bits)
    values = qt.values
    if qt.bits == 4:
        values = unpack_int4(values, qt.packed_axis)
    return (values.float() * qt.scales.float()).to(dtype)
