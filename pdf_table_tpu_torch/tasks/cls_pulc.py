"""PULC image-classification task (counterpart of
pdf_table_tpu/tasks/cls_pulc.py): the PP-LCNet module and its weights on a
device, for every task type of ``ClsPulcConfig.for_task``
(``text_image_orientation`` 0/90/180/270, ``textline_orientation``
0/180, ``language_classification``, ``table_attribute``).

The recognition lane feeds ``probs`` crops that are already cut on the
device; ``__call__(image)`` (``InferTask``'s, engine/infer_task.py, with
its timings) and ``batch_infer(crops)`` run the host
pre-processor (``models/cls/processor.py``) and the post-processor, as the
JAX task does: all crops of ``batch_infer`` in one forward, padded to a
batch bucket.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.buckets import bucket_batch_size
from ..engine.device import resolve_device, set_float_precision
from ..engine.infer_task import InferTask
from ..engine.params import init_cls, load_or_init
from ..models.registry import weights_dir
from ..models.cls.config import ClsPulcConfig
from ..models.cls.model import PPLCNetClassifier
from ..models.cls.processor import PulcPostProcessor, PulcPreProcessor

# the imagenet normalization of the PULC models, on 0..1 RGB
CLS_MEAN = (0.485, 0.456, 0.406)
CLS_STD = (0.229, 0.224, 0.225)


class ClsImagePulcTask(InferTask):
    """PP-LCNet classifier on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for). Weights: ``variables`` (a flax-layout tree) or, when None,
    the seeded :func:`init_cls`. ``cfg_overrides`` go to
    ``ClsPulcConfig.for_task``."""

    task_name = "cls_pulc"

    def __init__(self, task_type: str = "text_image_orientation",
                 device=None, variables: Optional[Dict[str, Any]] = None,
                 **cfg_overrides):
        super().__init__()
        self.device = resolve_device(device)
        set_float_precision()
        self.model_config = cfg = ClsPulcConfig.for_task(task_type,
                                                         **cfg_overrides)
        self.pre = PulcPreProcessor(cfg)
        self.post = PulcPostProcessor(cfg)
        self.model = PPLCNetClassifier(cfg).eval()
        if variables is None:
            variables = load_or_init(
                weights_dir("cls", "PPLCNet", cfg.task_type),
                lambda: init_cls(cfg, 0), self.task_name)
        self.load_variables(variables)
        self.model.to(self.device)
        self.mean = torch.tensor(CLS_MEAN, device=self.device)
        self.std = torch.tensor(CLS_STD, device=self.device)

    def load_variables(self, variables: Dict[str, Any]) -> None:
        """Load a flax-layout {"params", "batch_stats"} tree."""
        from ..convert.flax_bridge import load_flax_variables

        load_flax_variables(self.model, variables)

    @torch.inference_mode()
    def probs(self, crops: torch.Tensor) -> torch.Tensor:
        """Crops (n, h, w, 3) f32 RGB in 0..255 at the config's
        ``img_size`` -> class probabilities (n, class_num)."""
        return self.model((crops / 255.0 - self.mean) / self.std)

    @torch.inference_mode()
    def _forward(self, batch: np.ndarray) -> np.ndarray:
        """Normalized (n, h, w, 3) f32 images -> probabilities (n, C)."""
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        return self.model(x).cpu().numpy()

    # -- the per-image path (InferTask.__call__) ----------------------------

    def _preprocess(self, image: np.ndarray):
        """One (H, W, 3) uint8 RGB image -> its normalized input."""
        return self.pre(image)["image"], None

    def _run_model(self, batch: np.ndarray) -> np.ndarray:
        return self._forward(batch)

    def _postprocess(self, raw: np.ndarray, meta) -> Dict[str, Any]:
        """{"labels", "scores"} (and "label", "score" unless
        multilabel)."""
        return self.post(raw[0])

    def batch_infer(self, images: Sequence[np.ndarray]
                    ) -> List[Dict[str, Any]]:
        """All images in one forward, padded with zeros to a batch bucket;
        one result per image, in order."""
        if not len(images):
            return []
        batch, n = self.pad_batch({"image": np.concatenate(
            [self.pre(img)["image"] for img in images])},
            bucket_batch_size(len(images)))
        raw = self._forward(batch["image"])
        return [self.post(raw[i]) for i in range(n)]
