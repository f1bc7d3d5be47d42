"""Checkpoint save/restore with surgery metadata.

Counterpart of ``flash_attention_softmax_n_tpu/utils/checkpoint.py``, on
the same files, so that a checkpoint written by either package loads in the
other: ``params.npz`` holds the flattened parameters (keys are tree paths
with ``|`` for ``/``; bf16 stored as its uint16 bits and fp8 e4m3 as its
uint8 bits, as JAX stores them), and ``checkpoint.json`` the config (its
``dtype`` by name, ``"bfloat16"`` or ``"float32"``), the tree's
``structure`` (dicts, arrays and ``QTensor`` leaves with their ``bits`` and
``packed_axis``: int8, grouped int4 and fp8 round-trip), the ``dtypes`` of
the npz entries and the user's metadata. Surgery is part of the checkpoint:
the config, ``softmax_n`` included, is saved next to the weights, so a
restored model is already softmax-N.

A training checkpoint adds ``opt_state.npz`` and ``opt_state.json``: the
port's ``torch.optim`` state (a ``ZeroRedundancyOptimizer``'s consolidated
over its data ranks) keyed by parameter path, with the optimizer's class
and param groups. It loads only into the same kind of optimizer, and only
in the port: optax's state tree and torch's state dict differ, so optimizer
state does not cross packages (parameters and configs do). On a mesh the
train checkpoint gathers the tensor-parallel shards into whole tensors on
save and shards them again on load.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flash_attention_softmax_n_tpu_torch._device import resolve_device
from flash_attention_softmax_n_tpu_torch.convert import tensor_from_numpy
from flash_attention_softmax_n_tpu_torch.models.bert import BertConfig
from flash_attention_softmax_n_tpu_torch.models.decoder import DecoderConfig
from flash_attention_softmax_n_tpu_torch.models.xlnet import XLNetConfig
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor

__all__ = ["save_checkpoint", "load_checkpoint",
           "save_train_checkpoint", "load_train_checkpoint"]

_CONFIG_TYPES = {"DecoderConfig": DecoderConfig, "BertConfig": BertConfig,
                 "XLNetConfig": XLNetConfig}
# npz cannot hold bf16 or fp8: their bits travel as unsigned integers
_VIEWS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
          torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8)}
_FROM_VIEW = {name: (torch_dt, bits) for torch_dt, (name, bits, _)
              in _VIEWS.items()}


def _config_to_json(config) -> Dict[str, Any]:
    d = dataclasses.asdict(config)
    for k, v in d.items():
        if isinstance(v, torch.dtype):
            d[k] = str(v).replace("torch.", "")
    return {"type": type(config).__name__, "fields": d}


def _config_from_json(blob: Dict[str, Any]):
    cls = _CONFIG_TYPES[blob["type"]]
    fields = dict(blob["fields"])
    if "dtype" in fields:
        fields["dtype"] = getattr(torch, fields["dtype"])
    return cls(**fields)


def _flatten_params(params) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Tree -> flat {path: tensor} + structure descriptor (QTensor-aware)."""
    flat, structure = {}, {}

    def walk(node, path):
        if isinstance(node, QTensor):
            flat[path + "/__values"] = node.values
            flat[path + "/__scales"] = node.scales
            structure[path] = {"kind": "qtensor", "bits": node.bits,
                               "packed_axis": node.packed_axis}
        elif isinstance(node, dict):
            structure[path] = {"kind": "dict", "keys": sorted(node.keys())}
            for k in node:
                walk(node[k], f"{path}/{k}" if path else k)
        else:
            flat[path] = node
            structure[path] = {"kind": "array"}

    walk(params, "")
    return flat, structure


def _unflatten_params(flat: Dict[str, torch.Tensor], structure: Dict):
    def build(path):
        desc = structure[path]
        if desc["kind"] == "dict":
            return {k: build(f"{path}/{k}" if path else k)
                    for k in desc["keys"]}
        if desc["kind"] == "qtensor":
            return QTensor(flat[path + "/__values"], flat[path + "/__scales"],
                           bits=desc["bits"], packed_axis=desc["packed_axis"])
        return flat[path]

    return build("")


def _save_npz(path: Path, flat: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """npz of host copies; returns the dtype map that reverses the views."""
    arrays, dtypes = {}, {}
    for k, t in flat.items():
        t = torch.as_tensor(t).detach().cpu().contiguous()
        if t.dtype in _VIEWS:
            name, bits, np_bits = _VIEWS[t.dtype]
            arrays[k] = t.view(bits).numpy().view(np_bits)
            dtypes[k] = name
        else:
            arrays[k] = t.numpy()
            dtypes[k] = str(arrays[k].dtype)
    np.savez(path, **{k.replace("/", "|"): v for k, v in arrays.items()})
    return dtypes


def _load_npz(path: Path, dtypes: Dict[str, str],
              device) -> Dict[str, torch.Tensor]:
    flat = {}
    with np.load(path) as npz:
        for key in npz.files:
            p = key.replace("|", "/")
            arr = npz[key]
            if dtypes[p] in _FROM_VIEW:
                torch_dt, bits = _FROM_VIEW[dtypes[p]]
                flat[p] = torch.from_numpy(np.ascontiguousarray(arr)).view(
                    bits).view(torch_dt).to(device)
            else:
                flat[p] = tensor_from_numpy(arr, device)
    return flat


def save_checkpoint(directory, config, params,
                    metadata: Optional[Dict[str, Any]] = None) -> Path:
    """Write config + params (+ user metadata) under ``directory``."""
    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    flat, structure = _flatten_params(params)
    dtypes = _save_npz(out / "params.npz", flat)
    blob = {
        "config": _config_to_json(config),
        "structure": structure,
        "dtypes": dtypes,
        "metadata": dict(metadata or {}),
        "format_version": 1,
    }
    with open(out / "checkpoint.json", "w") as f:
        json.dump(blob, f, indent=2)
    return out


def load_checkpoint(directory, device=None):
    """Returns (config, params, metadata), the tensors on ``device`` (the
    card unless the caller asks for the CPU)."""
    out = Path(directory)
    with open(out / "checkpoint.json") as f:
        blob = json.load(f)
    flat = _load_npz(out / "params.npz", blob["dtypes"],
                     resolve_device(device))
    params = _unflatten_params(flat, blob["structure"])
    return _config_from_json(blob["config"]), params, blob["metadata"]


# ----------------------------------------------------------------------------
# training checkpoints
# ----------------------------------------------------------------------------


def _paths(tree, path="") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) in the order the trainer lists its parameters."""
    if isinstance(tree, dict):
        return [x for k in tree
                for x in _paths(tree[k], f"{path}/{k}" if path else k)]
    return [(path, tree)]


def _optimizer_state(opt, mesh):
    """({param index: {name: value}}, param_groups, holder): the whole
    state, gathered over the mesh onto ``holder`` ranks (rank 0 among
    them); other ranks get an empty state."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    holder = True
    if isinstance(opt, ZeroRedundancyOptimizer):
        opt.consolidate_state_dict(to=0)
        holder = opt.rank == 0
    if mesh is not None:
        from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
            axis_index,
        )
        holder = holder and all(
            axis_index(mesh, a) == 0 for a in mesh.mesh_dim_names
            if a != "model")
    if not holder:
        return {}, [], False
    sd = opt.state_dict()
    return sd["state"], sd["param_groups"], True


def save_train_checkpoint(directory, config, params, opt_state, step: int = 0,
                          metadata: Optional[Dict[str, Any]] = None, *,
                          mesh=None) -> Path:
    """Full training checkpoint: config + params + optimizer state + step.

    The params part stays loadable alone by ``load_checkpoint`` (inference
    never pays for optimizer bytes). ``opt_state`` is the step's
    ``torch.optim`` optimizer (or ``ZeroRedundancyOptimizer``) over
    ``params`` in their dict order. On ``mesh`` (``params`` are this rank's
    shards from ``make_train_step``'s ``init``) every rank calls it: the
    shards and the moments are gathered into whole tensors and rank 0
    writes.
    """
    import torch.distributed as dist

    state, groups, holder = _optimizer_state(opt_state, mesh)
    paths = [p for p, _ in _paths(params)]
    if mesh is not None:
        from flash_attention_softmax_n_tpu_torch.parallel.sharding import (
            gather_decoder_leaf,
            gather_decoder_tree,
        )
        if holder:
            params = gather_decoder_tree(params, config, mesh)
            state = {i: {name: (gather_decoder_leaf(v, paths[i], config, mesh)
                                if torch.is_tensor(v) and v.ndim else v)
                         for name, v in s.items()}
                     for i, s in state.items()}
        holder = dist.get_rank() == 0
    out = Path(directory)
    if holder:
        meta = dict(metadata or {})
        meta["train_step"] = int(step)
        save_checkpoint(out, config, params, metadata=meta)
        flat, entries = {}, []
        for i, s in sorted(state.items()):
            for name, value in s.items():
                key = f"leaf_{len(entries):05d}"
                flat[key] = value
                entries.append({"path": paths[i], "name": name, "key": key})
        dtypes = _save_npz(out / "opt_state.npz", flat)
        groups = [{**g, "params": [paths[i] for i in g["params"]]}
                  for g in groups]
        with open(out / "opt_state.json", "w") as f:
            json.dump({"optimizer": type(_local(opt_state)).__name__,
                       "param_groups": groups, "entries": entries,
                       "dtypes": dtypes}, f)
    if mesh is not None:
        dist.barrier()
    return out


def _local(opt):
    """The optimizer that holds the state (a ZeRO wrapper's local one)."""
    return getattr(opt, "optim", opt)


def load_train_checkpoint(directory, optimizer: Callable, *, device=None,
                          mesh=None, zero1: bool = False):
    """Returns (config, params, opt_state, step, metadata).

    ``optimizer`` maps a list of parameters to a ``torch.optim`` optimizer
    of the kind used at save time (``make_train_step``'s ``optimizer``);
    another kind, or state that does not fit the parameters, raises
    ``ValueError``. Without ``mesh`` the params are whole tensors on
    ``device`` with ``requires_grad``. With ``mesh`` (every rank calls it)
    they are this rank's shards, as ``make_train_step(cfg, mesh,
    optimizer=optimizer, zero1=zero1)``'s ``init`` gives them, its
    ``step`` continues the run, and the moments are sharded alike.
    """
    from flash_attention_softmax_n_tpu_torch.parallel.train import (
        init_train_state,
    )

    config, params, metadata = load_checkpoint(directory, device)
    out = Path(directory)
    with open(out / "opt_state.json") as f:
        blob = json.load(f)
    params, opt = init_train_state(params, optimizer, mesh, zero1)
    kind = type(_local(opt)).__name__
    if kind != blob["optimizer"]:
        raise ValueError(
            f"optimizer mismatch: the checkpoint holds {blob['optimizer']} "
            f"state, the optimizer given builds {kind} — pass the optimizer "
            "used at save time")
    leaves = _paths(params)
    index = {p: i for i, (p, _) in enumerate(leaves)}
    flat = _load_npz(out / "opt_state.npz", blob["dtypes"], "cpu")
    state: Dict[int, Dict[str, Any]] = {}
    for e in blob["entries"]:
        if e["path"] not in index:
            raise ValueError(f"optimizer state for {e['path']!r}, which the "
                             "model does not have — optimizer or model "
                             "changed since save")
        i = index[e["path"]]
        value = flat[e["key"]]
        leaf = leaves[i][1]
        if value.ndim:
            if mesh is not None:
                from flash_attention_softmax_n_tpu_torch.parallel.sharding import (  # noqa: E501
                    shard_decoder_leaf,
                )
                value = shard_decoder_leaf(value, e["path"], mesh)
            if tuple(value.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"optimizer state {e['path']}/{e['name']} of shape "
                    f"{tuple(value.shape)} does not fit the parameter's "
                    f"{tuple(leaf.shape)} — optimizer or model changed since "
                    "save")
            value = value.to(leaf.device)
        state.setdefault(i, {})[e["name"]] = value
    groups = [{**g, "params": [index[p] for p in g["params"]]}
              for g in blob["param_groups"]]
    opt.load_state_dict({"state": state, "param_groups": groups})
    return (config, params, opt, metadata.get("train_step", 0), metadata)
