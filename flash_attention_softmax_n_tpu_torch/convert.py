"""Carry a JAX decoder parameter tree across to the port.

``params_from_jax`` takes the tree with its leaves as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``, which keeps the JAX package's
``QTensor`` nodes with numpy ``values``/``scales``) and returns the port's
parameter dict on ``device``. It reads quantized leaves by their
``values``/``scales``/``bits``/``packed_axis`` attributes (int8, grouped
int4 and fp8), so nothing of the JAX package is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor on ``device``, bf16 and fp8 e4m3
    included."""
    a = np.array(a, order="C")  # a writable copy: JAX's buffers are read-only
    # torch.from_numpy rejects ml_dtypes' types: cross as integers of their
    # width, then view the bytes as the torch type
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(a).to(device)


def _convert(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _convert(v, device) for k, v in x.items()}
    if hasattr(x, "values") and hasattr(x, "scales"):
        bits = getattr(x, "bits", 8)
        if bits not in (8, 4, -8):
            raise ValueError(f"unsupported quantized leaf bits={bits}")
        return QTensor(tensor_from_numpy(x.values, device),
                       tensor_from_numpy(x.scales, device),
                       bits=bits, packed_axis=getattr(x, "packed_axis", None))
    return tensor_from_numpy(x, device)


def params_from_jax(tree, device=None):
    """The JAX parameter tree (numpy leaves) as the port's parameters."""
    return _convert(tree, resolve_device(device))
