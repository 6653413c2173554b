"""Table-structure-recognition task, LORE model (counterpart of
pdf_table_tpu/tasks/table_structure.py, the ``Lore`` path).

``batch_infer_from_pages`` takes page images and table regions, samples
every crop on the device (corner-anchored axis-aligned resample, BGR flip,
CenterNet normalization), runs the LORE trunk, decode and logical-location
regressor per resolution bucket and sub-batch, and post-processes each crop
on the host into {"cells": [...]} in crop coordinates. Under ``wiz_rev``
(``task_type="wtw"``, the default) a sub-batch runs detect-decode, the
dense corner refine and re-sort, then the feature gathers and regressor,
all on the device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.buckets import bucket_batch_size
from ..engine.device import on_device, resolve_device, set_float_precision
from ..engine.params import init_lore
from ..models.lore.config import LoreConfig
from ..models.lore.model import LoreModel, unpack_lore
from ..models.lore.processor import LorePostProcessor, LorePreProcessor
from ..ops.warp import resample_axis_aligned_crops

Region = Tuple[int, Tuple[float, float, float, float]]


def lore_config(task_type: str = "wtw", **kw) -> LoreConfig:
    if task_type == "wtw":
        return LoreConfig.wtw(**kw)
    if task_type == "wireless":
        return LoreConfig.wireless(**kw)
    return LoreConfig(task_type=task_type, **kw)


class OcrTableStructureTask:
    """LORE table structure on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for). Weights: ``variables`` (a flax-layout tree, see
    convert/flax_bridge.py) or, when None, the seeded :func:`init_lore`.
    ``res_buckets`` ("auto" or a tuple of sides) runs small crops at a
    smaller square resolution; ``batch_size`` caps a full-resolution
    sub-batch."""

    task_name = "table_structure"

    def __init__(self, model: str = "Lore", task_type: str = "wtw",
                 config: Optional[LoreConfig] = None,
                 res_buckets: Any = (), device=None, batch_size: int = 8,
                 variables: Optional[Dict[str, Any]] = None, **kw):
        if model != "Lore":
            raise NotImplementedError(f"TSR model {model!r} is not ported "
                                      f"yet")
        self.device = resolve_device(device)
        set_float_precision()
        self.model_config = config or lore_config(task_type, **kw)
        cfg = self.model_config
        if res_buckets == "auto":
            self.res_buckets = (384, 512)
        else:
            self.res_buckets = tuple(res_buckets or ())
        self.batch_size = batch_size
        self.post = LorePostProcessor(cfg)
        self.model = LoreModel(cfg).eval()
        self.load_variables(variables if variables is not None
                            else init_lore(cfg, 0))
        self.model.to(self.device)
        self.mean = torch.as_tensor(LorePreProcessor.MEAN, device=self.device)
        self.std = torch.as_tensor(LorePreProcessor.STD, device=self.device)

    def load_variables(self, variables: Dict[str, Any]) -> None:
        """Load a flax-layout {"params", "batch_stats"} tree."""
        from ..convert.flax_bridge import load_flax_variables

        load_flax_variables(self.model, variables)

    def _region_plan(self, regions: Sequence[Region]):
        """Per crop: src box, resolution bucket, valid dst extent, meta."""
        cfg = self.model_config
        inp_h, inp_w = cfg.resolution
        plan = []
        for pi, (x1, y1, x2, y2) in regions:
            h, w = float(y2 - y1), float(x2 - x1)
            s = max(h, w, 1.0)
            ri_h, ri_w = inp_h, inp_w
            for rb in self.res_buckets:
                if s <= rb and rb < max(inp_h, inp_w):
                    ri_h = ri_w = rb
                    break
            if cfg.upper_left:
                box = np.array([x1, y1, x1 + s, y1 + s], np.float32)
                c = np.array([0.0, 0.0], np.float32)
            else:
                cx, cy = x1 + w / 2.0, y1 + h / 2.0
                box = np.array([cx - s / 2, cy - s / 2,
                                cx + s / 2, cy + s / 2], np.float32)
                c = np.array([w / 2.0, h / 2.0], np.float32)
            plan.append({
                "page": pi, "box": box, "res": (ri_h, ri_w),
                "valid_w": min(int(np.ceil(w * ri_w / s)), ri_w),
                "valid_h": min(int(np.ceil(h * ri_h / s)), ri_h),
                "meta": {"c": c, "s": s, "org_shape": (int(h), int(w)),
                         "out_h": ri_h // cfg.down_ratio,
                         "out_w": ri_w // cfg.down_ratio}})
        return plan

    @torch.inference_mode()
    def _crops(self, pages: torch.Tensor, items: List[dict],
               res: Tuple[int, int]) -> torch.Tensor:
        """Normalized NHWC crops of one sub-batch, padded to its bucket."""
        nb = bucket_batch_size(len(items))
        pad = nb - len(items)
        boxes = np.stack([it["box"] for it in items]
                         + [np.array([0, 0, 1, 1], np.float32)] * pad)
        dev = self.device

        def ints(key, fill):
            return torch.as_tensor([it[key] for it in items] + [fill] * pad,
                                   device=dev)

        crops = resample_axis_aligned_crops(
            pages, ints("page", 0), torch.as_tensor(boxes, device=dev), res,
            valid_w=ints("valid_w", 1), valid_h=ints("valid_h", 1))
        return (crops.flip(-1) / 255.0 - self.mean) / self.std

    def sub_batches(self, pages, regions: Sequence[Region]):
        """Yield (crop indices, meta per crop, normalized crops) for each
        sub-batch: grouped by resolution bucket, each group cut at a cap
        that scales with the bucket's pixel ratio. A page tensor already on
        the device is used as it is, not copied."""
        pages_t = on_device(pages, self.device)
        plan = self._region_plan(regions)
        inp_h, inp_w = self.model_config.resolution
        base_cap = max(1, self.batch_size)
        by_res: Dict[tuple, list] = {}
        for i, it in enumerate(plan):
            by_res.setdefault(it["res"], []).append(i)
        for res, idx in sorted(by_res.items()):
            cap = max(1, int(base_cap * inp_h * inp_w / (res[0] * res[1])))
            for s0 in range(0, len(idx), cap):
                sub = idx[s0:s0 + cap]
                yield (sub, [plan[i]["meta"] for i in sub],
                       self._crops(pages_t, [plan[i] for i in sub], res))

    @torch.inference_mode()
    def batch_infer_from_pages(self, pages, regions: Sequence[Region]
                               ) -> List[Dict[str, Any]]:
        """``pages`` (P, H, W, 3) uint8 RGB (numpy or tensor); ``regions``
        [(page_idx, (x1, y1, x2, y2))] in page coords. Returns one
        {"cells": [...], "type": "lore"} per region."""
        if not regions:
            return []
        # every sub-batch is enqueued before the first download blocks
        pending = [(sub, metas, self.model.forward_packed(x))
                   for sub, metas, x in self.sub_batches(pages, regions)]
        results: List[Dict[str, Any]] = [{} for _ in regions]
        for sub, metas, packed in pending:
            packed_np = packed.cpu().numpy()
            for j, (i, meta) in enumerate(zip(sub, metas)):
                results[i] = self.post(unpack_lore(packed_np[j:j + 1]), meta)
        return results

    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """One table image (H, W, 3) uint8 RGB: the from-pages path with the
        image as the page and the whole image as the region."""
        h, w = image.shape[:2]
        return self.batch_infer_from_pages(image[None],
                                           [(0, (0, 0, w, h))])[0]
