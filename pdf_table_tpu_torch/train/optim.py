"""The optimizer of the LORE trainer, written out: optax's
``chain(clip_by_global_norm(max_norm), adamw(schedule, weight_decay))`` and
the learning-rate schedules it is built with, with optax's arithmetic:

- the clip divides by the global norm with no epsilon, and only when the
  norm reaches ``max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
  and always scales);
- Adam's moments are ``(1 - b) * g**k + b * m``, bias-corrected by ``1 -
  b**count`` with the count after the increment, ``eps`` outside the root;
- the decoupled weight decay adds ``wd * p`` before the learning rate
  scales the update;
- the schedule is read at the count *before* the update, so a warm-up from
  0 makes the first step's learning rate 0;
- a piecewise-constant schedule scales *at* its boundary count.

A state is ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``.

On a mesh with a ``tp`` axis (``parallel/tensor_parallel.py``) the
sharded params' gradients and moments are this rank's columns: the
clip's norm adds the replicated leaves' squares once and the sharded
leaves' local sums all-reduced over tp, and Adam updates each shard
elementwise.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Schedule:
    """``(init - end) * (1 - t / T) ** power + end``, t clipped to [0, T];
    constant ``init_value`` for T <= 0."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        t = min(max(count, 0), transition_steps)
        frac = 1 - t / transition_steps
        return (init_value - end_value) * frac ** power + end_value
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps)


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Mapping[int, float]
                                ) -> Schedule:
    """``init_value`` times each scale whose boundary ``count`` has
    reached."""
    def schedule(count: int) -> float:
        v = init_value
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if count >= boundary:
                v = v * scale
        return v
    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """``schedules[i + 1](count - boundaries[i])`` from ``boundaries[i]``
    on."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out
    return schedule


def global_norm(tensors, sharded=(), group=None) -> torch.Tensor:
    """``sqrt(sum of every element squared)``, f32, over the replicated
    ``tensors`` and the tp shards ``sharded`` (their squares summed over
    ``group``, the tp axis's process group)."""
    sq = sum(torch.sum(t.float() * t.float()) for t in tensors)
    sharded = list(sharded)
    if sharded:
        from ..parallel.collectives import all_reduce

        part = sum(torch.sum(t.float() * t.float()) for t in sharded)
        sq = sq + all_reduce(part, group)
    return torch.sqrt(sq)


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay=weight_decay))``."""

    def __init__(self, schedule: Schedule, max_norm: float,
                 weight_decay: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.max_norm = max_norm
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Dict,
               params: Mapping[str, torch.Tensor], sharding=None
               ) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """(updates to add to the params, the next state); the moments are
        updated in place. ``sharding`` (a ``ParamSharding``) names the tp
        shards among ``grads``."""
        if sharding is not None and sharding.dims:
            g_norm = global_norm(
                [g for k, g in grads.items() if k not in sharding.dims],
                [g for k, g in grads.items() if k in sharding.dims],
                sharding.axis.group)
        else:
            g_norm = global_norm(grads.values())
        clip = bool(g_norm >= self.max_norm)
        count = state["count"] + 1
        f32 = torch.float32
        dev = g_norm.device
        bc1 = 1 - torch.tensor(self.b1, dtype=f32, device=dev) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32, device=dev) ** count
        lr = self.schedule(state["count"])
        updates = {}
        for k, g in grads.items():
            g = g.float()
            if clip:
                g = g / g_norm * self.max_norm
            mu, nu = state["mu"][k], state["nu"][k]
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * params[k].float()
            updates[k] = u * -lr
        return updates, {"count": count, "mu": state["mu"],
                         "nu": state["nu"]}
