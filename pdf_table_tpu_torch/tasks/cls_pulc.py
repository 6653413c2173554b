"""PULC image-classification task (counterpart of
pdf_table_tpu/tasks/cls_pulc.py): the PP-LCNet module and its weights on a
device. The recognition lane feeds it crops that are already cut and
normalized on the device; the cv2 host preprocessing is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..engine.device import resolve_device, set_float_precision
from ..engine.params import init_cls
from ..models.cls.config import ClsPulcConfig
from ..models.cls.model import PPLCNetClassifier

# the imagenet normalization of the PULC models, on 0..1 RGB
CLS_MEAN = (0.485, 0.456, 0.406)
CLS_STD = (0.229, 0.224, 0.225)


class ClsImagePulcTask:
    """PP-LCNet classifier on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for). Weights: ``variables`` (a flax-layout tree) or, when None,
    the seeded :func:`init_cls`. ``cfg_overrides`` go to
    ``ClsPulcConfig.for_task``."""

    task_name = "cls_pulc"

    def __init__(self, task_type: str = "text_image_orientation",
                 device=None, variables: Optional[Dict[str, Any]] = None,
                 **cfg_overrides):
        if task_type != "textline_orientation":
            raise NotImplementedError(
                f"PULC task {task_type!r} is not ported yet (the page "
                f"orientation classifier comes with the per-page system, "
                f"ROADMAP.md Queue 1 item 17)")
        self.device = resolve_device(device)
        set_float_precision()
        self.model_config = cfg = ClsPulcConfig.for_task(task_type,
                                                         **cfg_overrides)
        self.model = PPLCNetClassifier(cfg).eval()
        self.load_variables(variables if variables is not None
                            else init_cls(cfg, 0))
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
