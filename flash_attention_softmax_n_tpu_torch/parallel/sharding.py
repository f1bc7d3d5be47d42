"""Tensor-parallel sharding rules for the decoder's parameters, and the
collectives that explicit shards need.

Counterpart of ``flash_attention_softmax_n_tpu/parallel/sharding.py``.
The rules are JAX's (Megatron-style over the ``"model"`` axis):

  * attention q/k/v projections and the MLP gate/up: column-parallel
    (output dim sharded),
  * attention output and MLP down projections: row-parallel (input dim
    sharded; the partial products are summed over ``"model"``),
  * the embedding sharded on hidden, ``lm_head`` on vocab,
  * norms replicated.

A spec is a tuple with one mesh axis name (or None) per dim, JAX's
``PartitionSpec`` as a plain tuple. The design differs from JAX's in one
respect: there is no GSPMD and no DTensor. ``shard_pytree`` returns each
rank's local slice as a plain tensor, and the model runs on those slices
with explicit collectives (``copy_to_axis``, ``reduce_from_axis``,
``gather_from_axis`` below, in the Megatron pairing), because the port's
kernels (``torch.ops.fasn.*``) have no DTensor sharding strategies and its
models are functions over dicts, not modules. A dim that does not divide
its axis is replicated, with JAX's warning (``_fit_spec``), so the forward
takes any mix of sharded and replicated leaves: it reads which from the
local shapes.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
)
from flash_attention_softmax_n_tpu_torch.quant.qtensor import QTensor

__all__ = ["decoder_param_specs", "kv_cache_specs", "shard_pytree",
           "batch_spec", "param_shardings", "zero1_opt_shardings",
           "copy_to_axis", "reduce_from_axis", "gather_from_axis",
           "all_reduce_grads"]

Spec = Tuple[Optional[str], ...]

# leaf name -> spec of the stacked (n_layers, K, N) weight
_DECODER_LAYER_RULES: Dict[str, Spec] = {
    # column-parallel: the output (head) dim
    "wq": (None, None, "model"),
    "wk": (None, None, "model"),
    "wv": (None, None, "model"),
    "w_gate": (None, None, "model"),
    "w_up": (None, None, "model"),
    # row-parallel: the input dim; the partial outputs are summed
    "wo": (None, "model", None),
    "w_down": (None, "model", None),
    # norms replicated
    "attn_norm": (None, None),
    "mlp_norm": (None, None),
}

_DECODER_TOP_RULES: Dict[str, Spec] = {
    "embed": (None, "model"),      # hidden-sharded embedding table
    "final_norm": (None,),
    "lm_head": (None, "model"),    # vocab-sharded logits
}


def _spec_for(name: str, leaf, rules: Dict[str, Spec]):
    spec = rules.get(name)
    if spec is None:
        return ()
    if isinstance(leaf, QTensor):
        # values shard like the dense weight; scales (.., 1, N) shard on the
        # output-channel axis only (never on the contracted axis)
        scale_spec = tuple(None if i != len(spec) - 1 else spec[-1]
                           for i in range(len(spec)))
        return QTensor(spec, scale_spec, bits=leaf.bits,
                       packed_axis=leaf.packed_axis)
    return spec


def decoder_param_specs(params: Dict) -> Dict:
    """Spec tree matching a decoder parameter dict (dense or quantized)."""
    specs = {
        "embed": _DECODER_TOP_RULES["embed"],
        "layers": {
            name: _spec_for(name, leaf, _DECODER_LAYER_RULES)
            for name, leaf in params["layers"].items()
        },
        "final_norm": _DECODER_TOP_RULES["final_norm"],
    }
    if "lm_head" in params:
        specs["lm_head"] = _spec_for("lm_head", params["lm_head"],
                                     _DECODER_TOP_RULES)
    return specs


def kv_cache_specs(cache: Dict) -> Dict:
    """KV cache (n_layers, B, KVH, S, hd): batch on 'data', heads on 'model'."""
    kv_spec = (None, "data", "model", None, None)

    def leaf_spec(leaf):
        if isinstance(leaf, QTensor):
            return QTensor(kv_spec, kv_spec, bits=leaf.bits,
                           packed_axis=leaf.packed_axis)
        return kv_spec

    specs = {"k": leaf_spec(cache["k"]), "v": leaf_spec(cache["v"])}
    if "lengths" in cache:
        specs["lengths"] = ("data",)
    if "length" in cache:
        specs["length"] = ()
    return specs


def batch_spec() -> Spec:
    """Token batches shard on the 'data' axis."""
    return ("data", None)


def _fit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from dims they don't divide (e.g. odd vocab sizes).

    Production models pad vocab/hidden to multiples of the TP degree; for
    arbitrary checkpoints we degrade to replication on the offending dim
    instead of erroring, loudly, because a silently replicated weight is a
    perf cliff (a full copy per device and no TP speedup on its matmul).
    An axis the mesh lacks replicates too.
    """
    fitted = []
    for i, axis in enumerate(spec):
        if i >= len(shape):
            fitted.append(None)
            continue
        if axis is None or axis not in (mesh.mesh_dim_names or ()):
            fitted.append(None)
            continue
        size = axis_size(mesh, axis)
        if shape[i] % size == 0:
            fitted.append(axis)
        else:
            logging.warning(
                "sharding relaxed to replication: dim %d of shape %s does "
                "not divide mesh axis %r (size %d) — pad this dim to a "
                "multiple of %d to restore tensor parallelism",
                i, tuple(shape), axis, size, size)
            fitted.append(None)
    return tuple(fitted)


def _tensors(tree):
    """Every tensor of a tree in order (a QTensor's values, then scales)."""
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors(tree[k])]
    if isinstance(tree, QTensor):
        return [tree.values, tree.scales]
    return [tree]


def _map(tree, specs, fn):
    """``fn(leaf, spec)`` over a tree and its spec tree (a QTensor's values
    and scales each with their own spec)."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError("specs tree does not match params tree")
        return {k: _map(tree[k], specs[k], fn) for k in tree}
    if isinstance(tree, QTensor):
        if not isinstance(specs, QTensor):
            raise ValueError("specs tree does not match params tree")
        return QTensor(fn(tree.values, specs.values),
                       fn(tree.scales, specs.scales), bits=tree.bits,
                       packed_axis=tree.packed_axis)
    return fn(tree, specs)


def _local_slice(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = x.shape[dim] // axis_size(mesh, axis)
            x = x.narrow(dim, axis_index(mesh, axis) * n, n)
    return x


def shard_pytree(tree, specs, mesh):
    """Each leaf's local slice on this rank, as its own tensor on the
    mesh's device (QTensor-aware). Specs whose mesh axis doesn't divide the
    corresponding dim are relaxed to replication on that dim."""
    device = torch.device(mesh.device_type)

    def place(leaf, spec):
        fitted = _fit_spec(spec, leaf.shape, mesh)
        return _local_slice(leaf, fitted, mesh).to(device).clone()

    return _map(tree, specs, place)


def param_shardings(params, specs, mesh):
    """The fitted spec tree: which dims of each (global) leaf are sharded
    over which axis. ``params`` are the global tensors."""
    return _map(params, specs,
                lambda leaf, spec: _fit_spec(spec, leaf.shape, mesh))


def zero1_opt_shardings(opt_state, params, mesh, data_axis: str = "data"):
    """Where ZeRO-1 keeps each parameter's optimizer state: a tree like
    ``params`` whose leaves are the ``data_axis`` coordinate of the rank
    holding it. ``opt_state`` is the ``ZeroRedundancyOptimizer`` of
    ``make_train_step(..., zero1=True)``, which partitions whole
    parameters over the data ranks (JAX instead shards each moment on its
    largest free dim). A collective over ``data_axis``: every rank of the
    group calls it."""
    leaves = _tensors(params)
    mine = torch.tensor([p in opt_state.optim.state for p in leaves],
                        dtype=torch.int64)
    group_size = axis_size(mesh, data_axis)
    owners = torch.zeros(len(leaves), dtype=torch.int64)
    if group_size > 1:
        dev = torch.device(mesh.device_type)
        flags = [torch.empty_like(mine, device=dev) for _ in range(group_size)]
        dist.all_gather(flags, mine.to(dev), group=mesh.get_group(data_axis))
        flags = torch.stack([f.cpu() for f in flags])
        if not torch.all(flags.sum(0) == 1):
            raise RuntimeError("a parameter's optimizer state is held by "
                               "more or fewer than one data rank")
        owners = flags.argmax(0)
    it = iter(owners.tolist())
    return _map(params, params, lambda leaf, _: next(it))


# ----------------------------------------------------------------------------
# Collectives of the explicit shards (Megatron's f and g, and the gather)
# ----------------------------------------------------------------------------


def _groups(mesh, axes):
    names = mesh.mesh_dim_names or ()
    return [mesh.get_group(a) for a in ((axes,) if isinstance(axes, str)
                                        else axes)
            if a in names and axis_size(mesh, a) > 1]


def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    x = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _CopyToAxis(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated activation
    entering column-parallel products."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.groups), None


class _ReduceFromAxis(torch.autograd.Function):
    """All-reduce forward, identity backward: row-parallel partial sums
    (and a loss summed over data ranks) becoming replicated."""

    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromAxis(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward takes this rank's slice
    of the (replicated, complete) cotangent."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.slice = (dim, index, x.shape[dim])
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, dy):
        dim, index, n = ctx.slice
        return dy.narrow(dim, index * n, n).contiguous(), None, None, None, None


def copy_to_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    groups = _groups(mesh, axis)
    return _CopyToAxis.apply(x, groups) if groups else x


def reduce_from_axis(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes`` (a name or several), identity backward."""
    groups = _groups(mesh, axes)
    return _ReduceFromAxis.apply(x, groups) if groups else x


def gather_from_axis(x: torch.Tensor, mesh, axis: str, dim: int
                     ) -> torch.Tensor:
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    return _GatherFromAxis.apply(x, mesh.get_group(axis), size,
                                 axis_index(mesh, axis), dim % x.ndim)


def all_reduce_grads(tensors: Sequence[torch.Tensor], mesh,
                     axes: Sequence[str]) -> None:
    """Sum the ``.grad`` of every tensor over ``axes`` in place, one flat
    buffer per dtype."""
    groups = _groups(mesh, tuple(axes))
    if not groups:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        if t.grad is not None:
            by_dtype.setdefault(t.grad.dtype, []).append(t.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for g in groups:
            dist.all_reduce(flat, group=g)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


# ----------------------------------------------------------------------------
# Whole tensors from shards and back, for training checkpoints
# ----------------------------------------------------------------------------


def _rule(path: str) -> Spec:
    name = path.split("/")[-1]
    return _DECODER_LAYER_RULES.get(name) or _DECODER_TOP_RULES.get(name) or ()


def _whole_size(name: str, cfg) -> Optional[int]:
    """The size of a decoder leaf's tensor-parallel dim, from the config."""
    q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"embed": cfg.d_model, "lm_head": cfg.vocab_size, "wq": q,
            "wk": kv, "wv": kv, "wo": q, "w_gate": cfg.d_ff, "w_up": cfg.d_ff,
            "w_down": cfg.d_ff}.get(name)


def gather_decoder_leaf(x: torch.Tensor, path: str, cfg, mesh) -> torch.Tensor:
    """The whole tensor of a decoder leaf (or of a moment shaped like it)
    from this rank's shard: all-gathered over ``"model"`` when its local
    size on the rule's dim is below the config's (a collective over the
    rank's model group)."""
    spec = _rule(path)
    if "model" not in spec or axis_size(mesh, "model") == 1:
        return x
    dim = spec.index("model")
    if x.shape[dim] >= _whole_size(path.split("/")[-1], cfg):
        return x
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, "model"))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("model"))
    return torch.cat(parts, dim=dim)


def gather_decoder_tree(tree, cfg, mesh, path: str = ""):
    """``gather_decoder_leaf`` over a decoder parameter dict."""
    if isinstance(tree, dict):
        return {k: gather_decoder_tree(v, cfg, mesh,
                                       f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return gather_decoder_leaf(tree, path, cfg, mesh)


def shard_decoder_leaf(x: torch.Tensor, path: str, mesh) -> torch.Tensor:
    """This rank's slice of a whole decoder leaf (or of a moment shaped
    like it), as ``shard_pytree`` cuts it."""
    return _local_slice(x, _fit_spec(_rule(path), x.shape, mesh), mesh)
