"""The train step (counterpart of pdf_table_tpu/train/train_step.py, on one
card: no mesh).

A :class:`TrainState` holds the step count, the model's own trainable
tensors (``params``, by state_dict name), its buffers (BatchNorm
statistics, which get no gradient) and the optimizer state. The step
updates the params in place, as the JAX step donates its state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

Batch = Mapping[str, torch.Tensor]


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]

    @classmethod
    def create(cls, model: nn.Module, optimizer) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, params=params,
                   buffers=dict(model.named_buffers()),
                   opt_state=optimizer.init(params))


def value_and_grad(apply_fn: Callable[[Batch], Any],
                   loss_fn: Callable[[Any, Batch], Dict[str, torch.Tensor]],
                   params: Mapping[str, torch.Tensor], batch: Batch
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, Optional[torch.Tensor]]]:
    """(losses, gradient of ``losses["loss"]`` for each param); a param the
    loss does not reach gets None."""
    names = list(params)
    with torch.enable_grad():
        losses = loss_fn(apply_fn(batch), batch)
        grads = torch.autograd.grad(losses["loss"],
                                    [params[k] for k in names],
                                    allow_unused=True)
    return ({k: v.detach() for k, v in losses.items()},
            dict(zip(names, grads)))


def split_batch(batch: Batch, n: int):
    """``n`` microbatches along the leading axis, which ``n`` must
    divide."""
    size = next(iter(batch.values())).shape[0]
    if size % n:
        raise ValueError(f"batch of {size} does not split into {n} "
                         f"microbatches")
    m = size // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(apply_fn: Callable[[Batch], Any],
                    loss_fn: Callable[[Any, Batch], Dict[str, torch.Tensor]],
                    optimizer, accum_steps: int = 1
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)``.

    ``apply_fn(batch)`` runs the model that owns ``state.params``;
    ``loss_fn(outputs, batch)`` returns ``{"loss": scalar, ...}``. A param
    the loss does not reach gets a zero gradient (as under ``jax.grad``).
    ``accum_steps > 1`` splits the batch into that many microbatches,
    averages their gradients and losses, and updates once: the effective
    batch at the activation memory of one microbatch."""

    def grads_of(params, batch):
        losses, grads = value_and_grad(apply_fn, loss_fn, params, batch)
        return losses, {k: torch.zeros_like(params[k]) if g is None else g
                        for k, g in grads.items()}

    def step(state: TrainState, batch: Batch):
        if accum_steps > 1:
            losses, grads = {}, {}
            for mb in split_batch(batch, accum_steps):
                ls, gs = grads_of(state.params, mb)
                for k, v in ls.items():
                    losses[k] = losses[k] + v if k in losses else v
                for k, g in gs.items():
                    grads[k] = grads[k] + g if k in grads else g
            grads = {k: g / accum_steps for k, g in grads.items()}
            losses = {k: v / accum_steps for k, v in losses.items()}
        else:
            losses, grads = grads_of(state.params, batch)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        with torch.no_grad():
            for k, u in updates.items():
                state.params[k].add_(u.to(state.params[k].dtype))
        state.step += 1
        state.opt_state = opt_state
        return state, losses

    return step
