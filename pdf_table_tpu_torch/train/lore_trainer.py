"""LORE TSR trainer (counterpart of pdf_table_tpu/train/lore_trainer.py):
teacher-forced forward, the LORE loss, the global-norm clip and AdamW
(``optim.py``), checkpoints in the port's format, best-model tracking. On
one card, or over a mesh of ``dp``, ``tp`` and ``sp`` (one process per
card, train/train_step.py): every process takes the same global batch
(``fit`` draws it from the same seed on each) and steps on its dp rows;
under ``tp`` the wide layers hold their rank's columns
(parallel/tensor_parallel.py), under ``sp`` the detector runs on the
rank's image rows (parallel/spatial.py). Its result is the one-device
step's. Checkpoints hold the whole, meshless tree, written by the mesh's
first process; a restore shards it again.

The trainer runs f32 (``LoreConfig.dtype``'s default, what the JAX tool
trains): its parameters are the model's own tensors, updated in place.
Every deform conv of the forward runs the kernel through
``ops.deform_conv.DeformConv2dFunction`` on the card.
"""

from __future__ import annotations

import functools
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..convert.flax_bridge import (flax_to_state_dict, load_flax_variables,
                                   state_dict_to_flax, transposed_modules)
from ..engine.device import compute_dtype, resolve_device
from ..engine.params import (init_lore, load_params, save_params,
                             save_params_async, wait_for_async_saves)
from ..models.lore.config import LoreConfig
from ..models.lore.dla import DeformConvBlock
from ..models.lore.model import LoreModel
from .lore_loss import lore_loss
from .optim import (ClipAdamW, Schedule, constant_schedule, join_schedules,
                    linear_schedule, piecewise_constant_schedule,
                    polynomial_schedule)
from .train_step import TrainState, dp_batch_sum, make_train_step

logger = logging.getLogger(__name__)


@dataclass
class LoreTrainArgs:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_schedule: str = "poly"          # poly | step | constant
    step_lr_drops: tuple = (0.7, 0.9)  # fractions of total at which lr /= 10
    batch_size: int = 4
    grad_clip: float = 10.0
    output_dir: str = "lore_train"
    save_every: int = 500
    log_every: int = 50
    # checkpoint the forward stage by stage (remat_stages): a stage keeps
    # only its input, and the backward recomputes its activations one
    # stage at a time, at the cost of a second forward (on a mesh with its
    # collectives, in the same order on every rank)
    remat: bool = False
    # >1: split the batch into this many microbatches, average their
    # gradients, update once
    grad_accum_steps: int = 1


def build_lr_schedule(args: LoreTrainArgs) -> Schedule:
    """Poly with a linear warm-up from 0 (to 1 % of the rate at
    ``total_steps``), step (/10 at each drop), or constant; the values of
    the JAX trainer's optax schedule at every count."""
    if args.lr_schedule == "constant":
        return constant_schedule(args.learning_rate)
    if args.lr_schedule == "step":
        bounds = {int(f * args.total_steps): 0.1 for f in args.step_lr_drops}
        return piecewise_constant_schedule(args.learning_rate, bounds)
    warmup = linear_schedule(0.0, args.learning_rate,
                             max(args.warmup_steps, 1))
    decay = polynomial_schedule(
        args.learning_rate, args.learning_rate * 0.01, power=1.0,
        transition_steps=max(args.total_steps - args.warmup_steps, 1))
    return join_schedules([warmup, decay], [args.warmup_steps])


def remat_stages(model: LoreModel) -> List[nn.Module]:
    """The stages ``remat`` checkpoints, one by one: DLA-34's stem and six
    levels, each deform-conv block of the two IDA-up pyramids, the heads
    and the regressor. None holds another."""
    base = model.detector.base
    stages = [base.base] + [getattr(base, f"level{i}") for i in range(6)]
    stages += [m for m in model.detector.modules()
               if isinstance(m, DeformConvBlock)]
    return stages + [model.detector.heads, model.processor]


def checkpoint_stages(modules: List[nn.Module]) -> None:
    """Run each module's forward under ``torch.utils.checkpoint``
    (``use_reentrant=False``): its activations are dropped after the
    forward and recomputed when the backward reaches it."""
    for m in modules:
        m.forward = functools.partial(checkpoint, m.forward,
                                      use_reentrant=False)


def _skeleton(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The tree's structure with None leaves."""
    return {k: _skeleton(v) if isinstance(v, Mapping) else None
            for k, v in tree.items()}


class LoreTrainer:
    """``LoreTrainer(config, args, mesh=None, device=None)`` trains on
    ``cuda`` unless given ``device="cpu"``; with a ``mesh`` each process
    steps on its part of the global batch (module docstring).
    ``init_state(variables)`` starts from a flax-layout tree (default:
    ``init_lore``); ``train_step(batch)`` takes one step on a batch of
    numpy arrays (``WtwDataset.batch``'s keys). ``min_shard_dim`` is the tp
    rule's threshold (JAX's trainer keeps the default, 256)."""

    def __init__(self, config: Optional[LoreConfig] = None,
                 args: Optional[LoreTrainArgs] = None, mesh=None,
                 device=None, min_shard_dim: int = 256):
        from ..parallel.mesh import check_axes

        check_axes(mesh)
        self.config = config or LoreConfig.wtw()
        self.args = args or LoreTrainArgs()
        self.mesh = mesh
        self.min_shard_dim = min_shard_dim
        self._batch_sum = dp_batch_sum(mesh)
        if compute_dtype(self.config.dtype) != torch.float32:
            raise ValueError("the trainer runs f32 (its parameters are the "
                             "model's own tensors); got dtype "
                             f"{self.config.dtype!r}")
        self.device = resolve_device(device)
        self.model = LoreModel(self.config).to(self.device).train()
        if self.args.remat:
            checkpoint_stages(remat_stages(self.model))
        self.optimizer = ClipAdamW(build_lr_schedule(self.args),
                                   self.args.grad_clip,
                                   weight_decay=self.args.weight_decay)
        self.state: Optional[TrainState] = None
        self.rows = None   # the detector's sp region (parallel/spatial.py)
        self._step_fn: Optional[Callable] = None
        self._layout: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, float]] = []
        self.best_loss = float("inf")

    # -- setup --------------------------------------------------------------

    def init_state(self, variables: Optional[Mapping[str, Any]] = None,
                   seed: int = 0) -> None:
        """Load a flax-layout ``{"params", "batch_stats"}`` tree (default
        ``init_lore(config, seed)``) into the model and start the optimizer
        at step 0; on a mesh, rank 0's tree placed on the mesh
        (``shard_state`` and the sp region)."""
        if self.mesh is not None and self.state is not None:
            raise RuntimeError("a trainer on a mesh shards its model once: "
                               "restore_checkpoint or restore_train_state "
                               "load a tree later")
        if variables is None:
            variables = init_lore(self.config, seed=seed)
        load_flax_variables(self.model, variables)
        self._layout = _skeleton({"params": variables["params"],
                                  "batch_stats": variables["batch_stats"]})
        self.state = TrainState.create(self.model, self.optimizer)
        if self.mesh is not None:
            from ..parallel.mesh import replicate_params
            from ..parallel.spatial import shard_rows
            from ..parallel.tensor_parallel import shard_state

            replicate_params(self.model, self.mesh)
            self.state = shard_state(self.state, self.mesh,
                                     self.min_shard_dim)
            self.rows = shard_rows(self.model, self.mesh)
        self._step_fn = make_train_step(self.apply, self.loss,
                                        self.optimizer,
                                        self.args.grad_accum_steps,
                                        mesh=self.mesh, rows=self.rows)

    def apply(self, batch: Mapping[str, torch.Tensor]):
        """The teacher-forced forward on a device batch (under ``remat``
        its stages checkpointed, :func:`remat_stages`)."""
        return self.model.train_forward(
            batch["image"], batch["hm_ind"], batch["gt_dets"],
            batch["hm_mask"], batch.get("cc_match"))

    def loss(self, outputs, batch) -> Dict[str, torch.Tensor]:
        return lore_loss(outputs, batch,
                         wiz_stacking=self.config.wiz_stacking,
                         batch_sum=self._batch_sum)

    def to_device(self, batch: Mapping[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """Numpy batch -> tensors on the device: integers int64 (indices),
        the rest f32."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            t = t.long() if not t.is_floating_point() else t.float()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    # -- loop ---------------------------------------------------------------

    def train_step(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        if self.state is None:
            self.init_state()
        self.state, metrics = self._step_fn(self.state,
                                            self.to_device(batch))
        return {k: float(v) for k, v in metrics.items()}

    def fit(self, dataset, steps: int, rng_seed: int = 0,
            eval_fn: Optional[Callable[["LoreTrainer"], Dict]] = None,
            eval_every: int = 0, prefetch: int = 2
            ) -> List[Dict[str, float]]:
        """Train loop. Batches (``dataset.batch`` of ``rng.choice`` indices
        from ``rng_seed``) are built on a prefetch thread while the card
        runs the step. ``eval_fn(trainer) -> {metric: float}`` every
        ``eval_every`` steps; the full train state is saved at the best
        eval metric (``output_dir/best_model``)."""
        rng = np.random.default_rng(rng_seed)
        n = len(dataset)
        bs = self.args.batch_size
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()

        def producer():
            try:
                for _ in range(steps):
                    if stop.is_set():
                        return
                    idx = rng.choice(n, size=min(bs, n), replace=n < bs)
                    q.put(dataset.batch(list(idx)))
            except Exception as e:   # re-raised by the loop
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        best_eval = float("inf")
        try:
            for step in range(steps):
                batch = q.get()
                if isinstance(batch, Exception):
                    raise batch
                t0 = time.perf_counter()
                metrics = self.train_step(batch)
                metrics["step_time"] = time.perf_counter() - t0
                self.history.append(metrics)
                if step % self.args.log_every == 0:
                    logger.info("step %d: %s", step,
                                {k: round(v, 4) for k, v in metrics.items()})
                self.best_loss = min(self.best_loss, metrics["loss"])
                if eval_fn is not None and eval_every \
                        and step > 0 and step % eval_every == 0:
                    ev = eval_fn(self)
                    self.history[-1].update(
                        {f"eval_{k}": float(v) for k, v in ev.items()})
                    key = float(ev.get("loss", next(iter(ev.values()))))
                    if key < best_eval:
                        best_eval = key
                        self.save_train_state(
                            os.path.join(self.args.output_dir,
                                         "best_model"))
                if self.args.save_every and step > 0 \
                        and step % self.args.save_every == 0:
                    self.save_checkpoint(blocking=False)
        finally:
            stop.set()
            while not q.empty():   # unblock a producer stuck on put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()
        wait_for_async_saves()
        return self.history

    # -- checkpointing ------------------------------------------------------

    def whole(self, tensors: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Params (or their moments) by name, the tp shards gathered whole
        (a collective on a tp mesh: every process calls it)."""
        tensors = {k: t.detach() for k, t in tensors.items()}
        sharding = self.state.sharding
        return tensors if sharding is None else sharding.gather_tree(tensors)

    def _writes(self) -> bool:
        """Whether this process writes the checkpoints: the mesh's first,
        or the only one."""
        if self.mesh is None:
            return True
        import torch.distributed as dist

        return dist.get_rank() == int(self.mesh.mesh.flatten()[0])

    def _load(self, variables: Mapping[str, Any]) -> None:
        """A whole flax-layout tree into the model, each tp shard cut from
        it."""
        sharding = self.state.sharding
        if sharding is None:
            load_flax_variables(self.model, variables)
            return
        sd = flax_to_state_dict(variables, transposed_modules(self.model))
        with torch.no_grad():
            for k, t in self.model.state_dict(keep_vars=True).items():
                t.copy_(sharding.shard(k, sd[k]))

    def variables(self) -> Dict[str, Any]:
        """The model's params and batch_stats as a flax-layout tree (device
        tensors), whole on a mesh, which ``init_state`` and the inference
        tasks load."""
        sd = {**self.whole(self.state.params),
              **{k: t.detach() for k, t in self.state.buffers.items()}}
        return state_dict_to_flax(sd, self._layout,
                                  transposed_modules(self.model))

    def save_checkpoint(self, path: Optional[str] = None,
                        blocking: bool = True) -> str:
        """The flax-layout variables; ``blocking=False`` writes the file on
        a thread while training goes on (``fit`` waits for it at the
        end). On a mesh every process calls it and the first writes."""
        path = path or os.path.join(self.args.output_dir, "checkpoint")
        variables = self.variables()
        if self._writes():
            (save_params if blocking else save_params_async)(variables,
                                                             path)
        return path

    def restore_checkpoint(self, path: str) -> None:
        variables = load_params(path)
        if self.state is None:
            self.init_state(variables)
        else:
            self._load(variables)

    # -- full-state resume ----------------------------------------------------

    def save_train_state(self, path: Optional[str] = None) -> str:
        """The full state: params, batch_stats, Adam's moments and count,
        and the step, so that training resumes bit for bit (a params-only
        checkpoint restarts the moments and the schedule)."""
        path = path or os.path.join(self.args.output_dir, "train_state")
        opt = self.state.opt_state
        tree = {**self.variables(),
                "opt_state": {"count": opt["count"],
                              "mu": self.whole(opt["mu"]),
                              "nu": self.whole(opt["nu"])},
                "step": self.state.step}
        if self._writes():
            save_params(tree, path)
        return path

    def restore_train_state(self, path: str) -> None:
        """The inverse of :meth:`save_train_state`."""
        tree = load_params(path)
        variables = {"params": tree["params"],
                     "batch_stats": tree["batch_stats"]}
        if self.state is None:
            self.init_state(variables)
        else:
            self._load(variables)
        opt = tree["opt_state"]
        sharding = self.state.sharding

        def placed(moments):
            moments = {k: torch.as_tensor(v) for k, v in moments.items()}
            if sharding is not None:
                moments = sharding.shard_tree(moments)
            return {k: v.to(self.device) for k, v in moments.items()}

        self.state.opt_state = {"count": int(opt["count"]),
                                "mu": placed(opt["mu"]),
                                "nu": placed(opt["nu"])}
        self.state.step = int(tree["step"])
