"""Quick DBNet fitting on synthetic pages (counterpart of
pdf_table_tpu/train/quick_det.py).

The loss and targets are the production ones (train/losses.py::db_loss,
data/det_targets.py::make_db_targets); only the page generator differs per
caller. The run follows JAX's step for step: a fixed pool of
``min(steps, 16)`` batches drawn from ``rng`` in JAX's order and
normalized on the host, the loss read every 25 steps and at the last, the
time budget counted from the first step's loss, the early exit. So
``first`` and ``last`` are read at the same steps as JAX's.

The optimizer is ``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8 and a
weight decay of 1e-4 on every parameter, the BatchNorm scales and biases
included (train/optim.py with no clipping). Every BatchNorm runs on its
batch's statistics (models/layers.py::batch_statistics). The trainer runs
f32: its parameters are the model's own tensors, with no f32 master copy
for a bf16 model, so a bf16 config raises.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..convert.flax_bridge import load_flax_variables, model_variables
from ..data.det_targets import make_db_targets
from ..engine.device import compute_dtype, resolve_device
from ..engine.params import init_dbnet
from ..models.dbnet.model import DBNet
from .losses import db_loss
from .optim import ClipAdamW, constant_schedule
from .train_step import TrainState, make_train_step

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
_IMAGENET_STD = np.array([0.229, 0.224, 0.225])
_TARGETS = ("gt", "gt_mask", "thresh_map", "thresh_mask")


def make_batch(render_page: Callable, rng: np.random.Generator, size: int,
               batch_size: int) -> Dict[str, np.ndarray]:
    """``batch_size`` pages of ``render_page(rng, size) -> (img, boxes)``:
    ImageNet-normalized f32 images (B, size, size, 3) and the DB targets
    (B, size, size)."""
    imgs = np.zeros((batch_size, size, size, 3), np.float32)
    tg = {k: np.zeros((batch_size, size, size), np.float32)
          for k in _TARGETS}
    for i in range(batch_size):
        img, boxes = render_page(rng, size)[:2]
        x = img.astype(np.float32) / 255.0
        imgs[i] = (x - _IMAGENET_MEAN) / _IMAGENET_STD
        t = make_db_targets(boxes, (size, size))
        for k in tg:
            tg[k][i] = t[k]
    return {"image": imgs, **tg}


def train_quick_detector(cfg, render_page: Callable,
                         steps: int = 300, size: int = 320,
                         batch_size: int = 4, lr: float = 1e-3,
                         rng: Optional[np.random.Generator] = None,
                         log: Optional[Callable[[str], None]] = None,
                         time_budget_s: Optional[float] = None,
                         early_exit_ratio: Optional[float] = None,
                         device=None,
                         on_step: Optional[Callable[[int, Dict], None]] = None
                         ) -> Tuple[dict, float, float]:
    """Fit a DBNet config on ``render_page(rng, size) -> (img, boxes)``
    pages on ``device`` (``cuda`` unless ``"cpu"`` is asked for). Returns
    (variables, first_loss, last_loss); ``variables`` is a flax-layout
    ``{"params", "batch_stats"}`` tree of host tensors, ``thresh`` head
    included, which ``engine/params.py::save_params`` caches and the
    detection task loads. ``time_budget_s`` stops training at the next
    sync point past the budget; ``early_exit_ratio`` stops as soon as the
    loss falls under ``ratio * first_loss``. ``on_step(s, losses)`` is
    called after every step with its index and its loss dict (tensors on
    the device, not synced), for a caller that records or times steps."""
    if compute_dtype(cfg.dtype) != torch.float32:
        raise ValueError("the quick trainer runs f32 (its parameters are "
                         f"the model's own tensors); got dtype {cfg.dtype!r}")
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    model = DBNet(cfg, train=True)
    variables = init_dbnet(cfg, 0, train=True)
    load_flax_variables(model, variables)
    model.to(dev)
    # optax.adamw(lr): no clipping, weight decay 1e-4 on every leaf
    tx = ClipAdamW(constant_schedule(lr), max_norm=float("inf"),
                   weight_decay=1e-4)
    state = TrainState.create(model, tx)
    step = make_train_step(lambda b: model(b["image"], train=True),
                           db_loss, tx)

    pool = [{k: torch.from_numpy(v).to(dev) for k, v in
             make_batch(render_page, rng, size, batch_size).items()}
            for _ in range(min(steps, 16))]
    sync_every = 25
    first = last = None
    t0 = None   # the budget clock starts after the first step's loss
    for s in range(steps):
        state, losses = step(state, pool[s % len(pool)])
        if on_step is not None:
            on_step(s, losses)
        if t0 is None:
            _ = float(losses["loss"])       # waits for the first step
            t0 = time.perf_counter()
        at_sync = (s % sync_every == 0 or s == steps - 1)
        over_budget = (time_budget_s is not None
                       and time.perf_counter() - t0 > time_budget_s)
        if not (at_sync or over_budget):
            continue
        lv = float(losses["loss"])
        first = lv if first is None else first
        last = lv
        if log is not None:
            log(f"det step {s}: loss {lv:.3f}")
        if over_budget:
            if log is not None:
                log(f"det: wall budget {time_budget_s:.0f}s hit at "
                    f"step {s} - stopping")
            break
        if (early_exit_ratio is not None and s > 0
                and lv < first * early_exit_ratio):
            if log is not None:
                log(f"det: early exit at step {s} "
                    f"(loss {lv:.3f} < {early_exit_ratio} x {first:.3f})")
            break
    out = model_variables(model, variables)
    return ({col: _host(tree) for col, tree in out.items()}, first, last)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu()
