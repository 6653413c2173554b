"""The task base class (counterpart of pdf_table_tpu/engine/infer_task.py):
``TaskConfig``, ``InferTask`` and the batch buckets.

A task's per-image ``__call__`` is

    host ``_preprocess`` -> ``_run_model`` on the task's device -> host
    ``_postprocess``

with the seconds of each stage appended to ``timings`` under the JAX
package's keys ("preprocess", "infer", "postprocess", "total"); "infer"
ends when the device has finished (a CUDA synchronize), as JAX's ends at
``block_until_ready``. ``timing_summary``, ``reset_timings`` and
``pad_batch`` are JAX's. There is no jit or compile cache: the port
runs eagerly, and its tasks load their weights when they are made, so
there is no ``ensure_built`` either (the system's lazy tasks and the
kernels' build are guarded by locks of their own: ``pipeline/system.py``,
``ops/kernels/build.py``). A task given a ``mesh`` (parallel/mesh.py)
takes the mesh's first rank's weights once they are loaded
(:func:`replicate_on`), as JAX's task replicates its parameters over the
mesh: every process of a data-parallel run computes with one tree.
Building a task on a mesh is therefore a collective: every process builds
the same tasks in the same order.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .buckets import BUCKET_SIZES, bucket_batch_size  # noqa: F401


@dataclass
class TaskConfig:
    """Common task knobs (the JAX package's ``TaskConfig``), kept for API
    parity: no port task takes or reads one."""
    model_name: str = ""
    task_type: str = ""
    lang: str = "en"
    batch_size: int = 8
    score_threshold: float = 0.5
    debug: bool = False
    output_dir: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)


def replicate_on(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """``model``'s parameters and buffers taken from the mesh's first rank
    (``parallel.mesh.replicate_params``); without a mesh, as it is."""
    if mesh is not None:
        from ..parallel.mesh import replicate_params
        replicate_params(model, mesh)
    return model


class InferTask:
    """Base class of the detection, classification and table-structure
    tasks. Subclasses implement ``_preprocess(inputs) -> (batch, meta)``,
    ``_run_model(batch) -> raw`` and ``_postprocess(raw, meta)``."""

    task_name = "base"

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.timings: Dict[str, List[float]] = {
            "preprocess": [], "infer": [], "postprocess": [], "total": []}

    def _preprocess(self, inputs, **kwargs):
        raise NotImplementedError

    def _run_model(self, batch):
        raise NotImplementedError

    def _postprocess(self, raw, meta):
        raise NotImplementedError

    def _synchronize(self) -> None:
        device = getattr(self, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    # -- execution ---------------------------------------------------------

    def __call__(self, inputs, **kwargs):
        t_start = time.perf_counter()
        t0 = time.perf_counter()
        batch, meta = self._preprocess(inputs, **kwargs)
        self.timings["preprocess"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        raw = self._run_model(batch)
        self._synchronize()
        self.timings["infer"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        out = self._postprocess(raw, meta)
        self.timings["postprocess"].append(time.perf_counter() - t0)
        self.timings["total"].append(time.perf_counter() - t_start)
        return out

    # -- batching helpers --------------------------------------------------

    @staticmethod
    def pad_batch(arrays: Dict[str, np.ndarray],
                  bucket: Optional[int] = None):
        """Pad every array's dim 0 to the bucketed batch size with zeros;
        returns (padded dict, real n)."""
        n = next(iter(arrays.values())).shape[0]
        b = bucket if bucket is not None else bucket_batch_size(n)
        out = {}
        for k, v in arrays.items():
            if v.shape[0] == n and b > n:
                pad = [(0, b - n)] + [(0, 0)] * (v.ndim - 1)
                out[k] = np.pad(v, pad)
            else:
                out[k] = v
        return out, n

    def timing_summary(self) -> Dict[str, Dict[str, float]]:
        from ..utils.benchmark_utils import timing_stats
        return {k: timing_stats([t * 1000 for t in v])
                for k, v in self.timings.items()}

    def reset_timings(self) -> None:
        for v in self.timings.values():
            v.clear()
