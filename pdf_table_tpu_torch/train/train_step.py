"""The train step (counterpart of pdf_table_tpu/train/train_step.py).

A :class:`TrainState` holds the step count, the model's own trainable
tensors (``params``, by state_dict name), its buffers (BatchNorm
statistics, which get no gradient) and the optimizer state. The step
updates the params in place, as the JAX step donates its state.

With a mesh (parallel/mesh.py, one process per card, axes ``dp``, ``tp``
and ``sp``) the step is JAX's GSPMD step over the global batch, whose
result is the one-device step's:

- every process passes the same global batch and takes its dp rows of it;
  the gradients and losses are summed over dp, so the clip and the
  optimizer see the one-device step's gradient. For that sum to be the
  global batch's loss, ``loss_fn`` must divide by sums over the global
  batch, not over its own rows: the LORE trainer passes ``lore_loss``
  :func:`dp_batch_sum`'s all-reduce over dp for its denominators;
- under ``sp`` (``rows``, a ``parallel.spatial.Rows``) each process also
  takes its rows of the image (JAX's ``spec_for``: a leaf of 4 or more
  dims whose rows sp divides; else the leaf stays whole and the sp ranks
  compute alike). The params used in the sp region get partial
  gradients, summed over sp in one flat all-reduce;
- under ``tp`` the state's params are column shards
  (``parallel/tensor_parallel.py::shard_state``): their gradients stay
  local, and the clip's norm sums the shards over tp.

The losses come out the same on every tp and sp rank. A model whose
BatchNorm runs on batch statistics would take them over its own rows: the
mesh step is for models on running statistics, as LORE's train forward
is (in the sp region batch statistics raise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

Batch = Mapping[str, torch.Tensor]


@dataclass
class TrainState:
    """``model`` owns ``params`` and ``buffers``; ``sharding`` (a
    ``ParamSharding``) names the params that are tp shards, None
    off a tp mesh."""

    step: int
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    model: Optional[nn.Module] = None
    sharding: Any = None

    @classmethod
    def create(cls, model: nn.Module, optimizer) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, params=params,
                   buffers=dict(model.named_buffers()),
                   opt_state=optimizer.init(params), model=model)


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


def dp_batch_sum(mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """A loss denominator's sum over the global batch: the processes'
    local sums all-reduced over the mesh's dp axis (a copy, outside
    autograd: denominators are counts of the targets); the identity
    without a mesh or on one process."""
    from ..parallel.mesh import all_reduce_sum, dp_rank_and_size

    if dp_rank_and_size(mesh)[1] == 1:
        return lambda t: t
    group = mesh.get_group("dp")
    return lambda t: all_reduce_sum(t.detach().clone(), group)


def dp_rows(batch: Batch, rank: int, size: int) -> Dict[str, torch.Tensor]:
    """Process ``rank``'s contiguous rows of a batch split ``size`` ways;
    the batch must split evenly (as JAX's dp sharding needs)."""
    n = next(iter(batch.values())).shape[0]
    if n % size:
        raise ValueError(f"a batch of {n} does not split over dp={size}")
    m = n // size
    return {k: v[rank * m:(rank + 1) * m] for k, v in batch.items()}


def _sum_flat(grads: Dict[str, torch.Tensor], names, group) -> None:
    """``grads[k]`` for ``k`` in ``names`` summed over ``group``, in one
    all-reduce of their concatenation (in place of the dict's entries)."""
    from ..parallel.mesh import all_reduce_sum

    names = [k for k in grads if k in names]
    flat = all_reduce_sum(torch.cat([grads[k].reshape(-1) for k in names]),
                          group)
    for k, t in zip(names, flat.split([grads[k].numel() for k in names])):
        grads[k] = t.view_as(grads[k])


def make_train_step(apply_fn: Callable[[Batch], Any],
                    loss_fn: Callable[[Any, Batch], Dict[str, torch.Tensor]],
                    optimizer, accum_steps: int = 1, mesh=None, rows=None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)``.

    ``apply_fn(batch)`` runs the model that owns ``state.params``;
    ``loss_fn(outputs, batch)`` returns ``{"loss": scalar, ...}``. A param
    the loss does not reach gets a zero gradient (as under ``jax.grad``).
    ``accum_steps > 1`` splits the batch into that many microbatches,
    averages their gradients and losses, and updates once: the effective
    batch at the activation memory of one microbatch. With a ``mesh``
    (module docstring) ``batch`` is the global batch; each microbatch is
    split over dp (and its ``"image"`` over sp, where ``rows``, the model's
    sp region, is given), and its gradients and losses summed."""
    from ..parallel.mesh import all_reduce_sum, dp_rank_and_size, sp_split

    rank, size = dp_rank_and_size(mesh)

    def grads_of(params, batch):
        if size > 1:
            batch = dp_rows(batch, rank, size)
        split = False
        if rows is not None:
            image, split = sp_split(batch["image"], rows.axis.rank,
                                    rows.axis.size)
            batch = {**batch, "image": image}
        if rows is None:
            losses, grads = value_and_grad(apply_fn, loss_fn, params, batch)
        else:
            with rows.region(split):
                losses, grads = value_and_grad(apply_fn, loss_fn, params,
                                               batch)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        if split:
            _sum_flat(grads, rows.param_names, rows.axis.group)
        if size > 1:
            group = mesh.get_group("dp")
            _sum_flat(grads, grads.keys(), group)
            keys = list(losses)
            vals = all_reduce_sum(torch.stack([losses[k].float()
                                               for k in keys]), group)
            losses = dict(zip(keys, vals.unbind()))
        return losses, grads

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
                                              state.params, state.sharding)
        with torch.no_grad():
            for k, u in updates.items():
                state.params[k].add_(u.to(state.params[k].dtype))
        state.step += 1
        state.opt_state = opt_state
        return state, losses

    return step
