"""Device meshes over ``torch.distributed`` and the process-group bootstrap.

Counterpart of ``flash_attention_softmax_n_tpu/parallel/mesh.py``. A mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the axis names in the order given; one process drives one device, and
the mesh's ranks are global process ranks. Every function here needs the
default process group to be up (``initialize_distributed``).

One deliberate difference: JAX's ``initialize_distributed`` swallows every
``RuntimeError``/``ValueError`` of ``jax.distributed.initialize``. Here it
is a no-op only when a group of the same world is already up; every other
error propagates, so a wrong address or world size is not mistaken for a
single-process run.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from flash_attention_softmax_n_tpu_torch._device import resolve_device

__all__ = ["make_mesh", "make_hybrid_mesh", "initialize_distributed",
           "local_mesh", "axis_size", "axis_index"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None) -> None:
    """Start the default process group: NCCL for the card, gloo when the
    caller asks for the CPU (``device="cpu"``).

    ``coordinator_address`` is ``host:port`` (read as ``tcp://``) or an
    init URL (``tcp://...``, ``file://...``); ``num_processes`` defaults to
    1 and ``process_id`` to 0. On the card, process ``i`` takes device
    ``i % device_count``. A no-op when a group of the same world size and
    rank is already up; any other state raises.
    """
    dev = resolve_device(device)
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        raise RuntimeError(
            f"a process group of world {dist.get_world_size()} (rank "
            f"{dist.get_rank()}) is already up; asked for world {world} "
            f"rank {rank}")
    if coordinator_address is None:
        raise ValueError("initialize_distributed needs a coordinator_address "
                         "(host:port, tcp://... or file://...)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)


def _build(names, shape, ranks, device=None) -> DeviceMesh:
    """``device`` None takes the default group's: the card under NCCL, else
    the CPU."""
    if device is None:
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    else:
        kind = torch.device(device).type
    grid = torch.as_tensor(list(ranks), dtype=torch.int64).reshape(shape)
    return DeviceMesh(kind, grid, mesh_dim_names=tuple(names))


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence[int]] = None,
              *, device=None) -> DeviceMesh:
    """A mesh from named axis sizes, e.g. ``{'data': 2, 'model': 4}``.

    ``devices`` are global ranks in mesh order; by default the first
    ``prod(sizes)`` ranks. Every process of the world calls it (the axes'
    groups are made collectively); a rank outside the mesh gets a mesh
    whose ``get_coordinate()`` is None. Raises ``ValueError`` when the mesh
    needs more ranks than the world has. ``device`` (``"cuda"`` or
    ``"cpu"``) defaults to the default group's backend: NCCL's card, gloo's
    CPU.
    """
    names, shape = tuple(axes), tuple(axes.values())
    n = math.prod(shape)
    world = dist.get_world_size()
    if devices is None:
        if n > world:
            raise ValueError(f"mesh {axes} needs {n} devices, have {world}")
        devices = range(n)
    return _build(names, shape, devices, device)


def make_hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int],
                     devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """Hybrid mesh: the ``dcn_axes`` (data parallelism across hosts) are
    outermost and the ``ici_axes`` innermost, over ranks in rank-major
    order, so consecutive ranks (one host's cards) share every per-layer
    collective and only the gradient reduction crosses hosts. This is the
    JAX package's CPU branch; NCCL finds the links itself."""
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    n = math.prod(shape)
    ranks = list(devices) if devices is not None else list(
        range(dist.get_world_size()))
    if n > len(ranks):
        raise ValueError(f"hybrid mesh {dcn_axes} x {ici_axes} needs {n} "
                         f"devices, have {len(ranks)}")
    return _build(names, shape, sorted(ranks)[:n])


def local_mesh(model_parallel: Optional[int] = None) -> DeviceMesh:
    """Every rank on ``'model'`` (or ``model_parallel`` of them), the
    remaining factor on ``'data'``."""
    n = dist.get_world_size()
    tp = model_parallel or n
    if n % tp:
        raise ValueError(f"{n} devices not divisible by model_parallel={tp}")
    return make_mesh({"data": n // tp, "model": tp})


def axis_size(mesh: DeviceMesh, axis: Optional[str]) -> int:
    """The size of a mesh axis; 1 for None or an axis the mesh lacks."""
    if axis is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh: DeviceMesh, axes) -> int:
    """This rank's coordinate along one axis name, or along several taken
    together (outermost first, as a batch split over ``(dcn_data, data)``
    is numbered); 0 over axes the mesh lacks."""
    names = mesh.mesh_dim_names or ()
    index = 0
    for axis in ((axes,) if isinstance(axes, str) else axes or ()):
        if axis in names:
            index = index * axis_size(mesh, axis) + mesh.get_local_rank(axis)
    return index
