"""Causal-LM training: the loss and an AdamW step, on one device or over a
mesh.

Counterpart of ``flash_attention_softmax_n_tpu/parallel/train.py``. On a
mesh every rank runs the step on its own shards: the weights are
tensor-sharded over ``"model"`` by ``decoder_param_specs``
(``shard_pytree`` gives each rank its slices), the batch is split over
``"data"`` (and a DCN data axis), the sequence over an SP axis with ring
attention, and the collectives are explicit (``parallel/sharding.py``)
where JAX lets GSPMD insert them. Parameters stay the decoder's dict of
stacked tensors; a step updates them in place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from flash_attention_softmax_n_tpu_torch.models.decoder import (
    DecoderConfig,
    decoder_forward,
)
from flash_attention_softmax_n_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
)
from flash_attention_softmax_n_tpu_torch.parallel.sharding import (
    all_reduce_grads,
    decoder_param_specs,
    reduce_from_axis,
    shard_pytree,
)

__all__ = ["causal_lm_loss", "make_train_step", "TrainState"]


def _local_tokens(tokens, mesh, data_axes, sp_axis):
    """This rank's rows (over ``data_axes``) and, under SP, its sequence
    shard, with the tokens that its last position predicts."""
    rows = 1
    for a in data_axes:
        rows *= axis_size(mesh, a)
    b, l = tokens.shape
    if b % rows:
        raise ValueError(f"batch {b} does not divide the data axes "
                         f"{tuple(data_axes)} ({rows} ranks)")
    nb = b // rows
    tokens = tokens.narrow(0, axis_index(mesh, data_axes) * nb, nb)
    p = axis_size(mesh, sp_axis) if sp_axis is not None else 1
    if l % p:
        raise ValueError(f"sequence length {l} does not divide the "
                         f"{sp_axis!r} axis ({p} ranks)")
    n = l // p
    start = axis_index(mesh, sp_axis) * n if p > 1 else 0
    local = tokens.narrow(1, start, n)
    # the targets of positions start .. start+n-1; the last position of
    # the sequence predicts nothing
    targets = tokens[:, start + 1:start + n + 1]
    return local, targets


def causal_lm_loss(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                   *, sp_mesh=None, sp_axis: str = "sp", tp_mesh=None,
                   data_axes: Sequence[str] = ("data",),
                   train: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Next-token cross-entropy over (B, L) tokens (shift by one), mean NLL
    from an f32 log-softmax. ``train=True`` with ``generator`` activates
    ``cfg.attn_dropout``.

    On a mesh (``sp_mesh`` or ``tp_mesh``, see ``decoder_forward``)
    ``tokens`` are the whole batch on every rank (token rows are small);
    each rank takes its rows over ``data_axes`` and, under ``sp_mesh``, its
    sequence shard over ``sp_axis``. A shard's last token predicts the
    first of the next shard. The mean is over all B·(L−1) targets: each
    rank sums its own and the sum crosses the data and SP axes (identity
    backward), so every rank returns the global loss.
    """
    mesh = sp_mesh if sp_mesh is not None else tp_mesh
    if mesh is None:
        logits = decoder_forward(params, cfg, tokens, train=train,
                                 generator=generator)
        targets = tokens[:, 1:].long()
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return torch.mean(nll)
    sp = sp_axis if sp_mesh is not None else None
    local, targets = _local_tokens(tokens, mesh, data_axes, sp)
    logits = decoder_forward(params, cfg, local, train=train,
                             generator=generator, sp_mesh=sp_mesh,
                             sp_axis=sp_axis, tp_mesh=tp_mesh,
                             data_axes=data_axes)
    logp = torch.log_softmax(logits[:, :targets.shape[1]].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    total = tokens.shape[0] * (tokens.shape[1] - 1)
    return reduce_from_axis(nll.sum() / total, mesh,
                            tuple(data_axes) + ((sp,) if sp else ()))


class TrainState:
    """Minimal train state: params + optimizer state."""

    def __init__(self, params, opt_state):
        self.params = params
        self.opt_state = opt_state


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"only dense tensors train, got {type(tree).__name__}")
    return [tree]


def init_train_state(params, make_optimizer: Callable, mesh=None,
                     zero1: bool = False):
    """(params, optimizer) ready to train: on ``mesh``, this rank's slices
    of the whole ``params``; every parameter ``requires_grad``;
    ``make_optimizer`` over them, inside a ``ZeroRedundancyOptimizer`` over
    ``'data'`` under ``zero1``."""
    if mesh is not None:
        params = shard_pytree(params, decoder_param_specs(params), mesh)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    if not zero1:
        return params, make_optimizer(leaves)
    from torch.distributed.optim import ZeroRedundancyOptimizer

    def local_optimizer(groups, **_):
        return make_optimizer(groups)

    return params, ZeroRedundancyOptimizer(
        leaves, optimizer_class=local_optimizer,
        process_group=mesh.get_group("data"))


def make_train_step(cfg: DecoderConfig, mesh=None,
                    learning_rate: float = 1e-4,
                    optimizer: Optional[Callable] = None,
                    sp_axis: Optional[str] = None,
                    dcn_data_axis: Optional[str] = None,
                    zero1: bool = False):
    """Build ``(init, step)`` for training on one device or on ``mesh``.

    ``init(params)`` -> (params, opt_state): on a mesh, each rank's slices
    of the (whole) ``params`` (``decoder_param_specs``); sets
    ``requires_grad`` on every parameter and builds the optimizer over them
    (moments start at zero). ``optimizer`` maps the list of parameters to a
    ``torch.optim`` optimizer; the default is ``optax.adamw(learning_rate)``'s:
    AdamW with b1 0.9, b2 0.999, eps 1e-8 and weight decay 1e-4
    (``torch.optim.AdamW`` defaults to 1e-2).

    ``step(params, opt_state, tokens, generator=None)`` -> (params,
    opt_state, loss): one update, in place, from the whole (B, L) batch
    (every rank passes the same). Given a generator (seeded alike on every
    rank) the model runs in training mode with ``cfg.attn_dropout`` active,
    as JAX's ``dropout_rng`` does. Each parameter's ``.grad`` holds the
    step's gradient until the next step.

    On a mesh: without ``sp_axis`` attention runs on each rank's (batch,
    head) slab (``tp_mesh``); ``sp_axis`` names the axis that splits the
    sequence, over which attention runs as a ring (long-context training).
    ``dcn_data_axis`` adds a data-parallel axis across hosts: the batch
    splits over (``dcn_data_axis``, ``'data'``) and only the gradient sum
    crosses it. Parameters are replicated over the data, DCN and SP axes,
    and their gradients are **summed** there: the loss is each rank's share
    of the global mean, and SP ranks see different tokens. ``zero1`` wraps
    the optimizer in ``ZeroRedundancyOptimizer`` over ``'data'`` (never the
    DCN axis): each data rank keeps the state of a share of the parameters
    and broadcasts their update, with AdamW's numerics.
    """
    if mesh is None and (sp_axis or dcn_data_axis or zero1):
        raise ValueError("sp_axis, dcn_data_axis and zero1 need a mesh")
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    for ax in (sp_axis, dcn_data_axis, "data" if zero1 else None):
        if ax is not None and ax not in names:
            raise ValueError(f"mesh has no axis {ax!r}: {names}")
    data_axes = tuple(a for a in (dcn_data_axis, "data") if a in names)
    reduce_axes = data_axes + ((sp_axis,) if sp_axis else ())

    def adamw(leaves):
        return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    make_optimizer = optimizer or adamw

    def init(params):
        return init_train_state(params, make_optimizer, mesh, zero1)

    def step(params, opt_state, tokens, generator=None):
        opt_state.zero_grad(set_to_none=True)
        kw = {}
        if mesh is not None:
            kw = dict(sp_mesh=mesh if sp_axis else None,
                      sp_axis=sp_axis or "sp",
                      tp_mesh=None if sp_axis else mesh, data_axes=data_axes)
        loss = causal_lm_loss(params, cfg, tokens, train=generator is not None,
                              generator=generator, **kw)
        loss.backward()
        if mesh is not None:
            all_reduce_grads(_leaves(params), mesh, reduce_axes)
        opt_state.step()
        return params, opt_state, loss.detach()

    return init, step
