"""Causal-LM training on one device: the loss and an AdamW step.

Counterpart of ``flash_attention_softmax_n_tpu/parallel/train.py`` without
its meshes: tensor and data parallelism, sequence-parallel ring attention,
DCN data parallelism and ZeRO-1 are not ported yet and raise
(``ROADMAP.md``, A12). Parameters stay the decoder's dict of stacked
tensors; a step updates them in place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from flash_attention_softmax_n_tpu_torch.models.decoder import (
    DecoderConfig,
    decoder_forward,
)

__all__ = ["causal_lm_loss", "make_train_step", "TrainState"]


def causal_lm_loss(params: Dict, cfg: DecoderConfig, tokens: torch.Tensor,
                   *, train: bool = False,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Next-token cross-entropy over (B, L) tokens (shift by one), mean NLL
    from an f32 log-softmax. ``train=True`` with ``generator`` activates
    ``cfg.attn_dropout``."""
    logits = decoder_forward(params, cfg, tokens, train=train,
                             generator=generator)
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return torch.mean(nll)


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


def make_train_step(cfg: DecoderConfig, mesh=None,
                    learning_rate: float = 1e-4,
                    optimizer: Optional[Callable] = None,
                    sp_axis: Optional[str] = None,
                    dcn_data_axis: Optional[str] = None,
                    zero1: bool = False):
    """Build ``(init, step)`` for training on one device.

    ``init(params)`` -> (params, opt_state): sets ``requires_grad`` on every
    parameter and builds the optimizer over them (moments start at zero).
    ``optimizer`` maps the list of parameters to a ``torch.optim``
    optimizer; the default is ``optax.adamw(learning_rate)``'s: AdamW with
    b1 0.9, b2 0.999, eps 1e-8 and weight decay 1e-4 (``torch.optim.AdamW``
    defaults to 1e-2).

    ``step(params, opt_state, tokens, generator=None)`` -> (params,
    opt_state, loss): one update, in place. Given a generator the model runs
    in training mode with ``cfg.attn_dropout`` active, as JAX's
    ``dropout_rng`` does. Each parameter's ``.grad`` holds the step's
    gradient until the next step.
    """
    multi = {"mesh": mesh is not None, "sp_axis": sp_axis is not None,
             "dcn_data_axis": dcn_data_axis is not None, "zero1": zero1}
    bad = [k for k, v in multi.items() if v]
    if bad:
        raise NotImplementedError(
            f"make_train_step {bad}: multi-device training is not ported "
            "yet; see ROADMAP.md (A12)")
    def adamw(leaves):
        return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    make_optimizer = optimizer or adamw

    def init(params):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return params, make_optimizer(leaves)

    def step(params, opt_state, tokens, generator=None):
        opt_state.zero_grad(set_to_none=True)
        loss = causal_lm_loss(params, cfg, tokens, train=generator is not None,
                              generator=generator)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return init, step
