"""Text-detection task, DBNet (counterpart of
pdf_table_tpu/tasks/detection.py and of the detection lane of
pdf_table_tpu/pipeline/batch_runner.py::BatchPipeline): ``PP-OCRv4_det``
(MobileNetV3, imagenet normalization) and ModelScope's ``db_resnet18``,
``db_resnet50`` and ``db_proxylessnas`` (BGR, mean subtracted, / 255), the
configs of the JAX registry (models/registry.py).

``batch_infer_from_pages`` groups pages by canvas bucket and runs each
chunk of up to 8 canvases as one device program: the resize+normalize
kernel, DBNet, a 2x2 max-pool of the prob map, uint8 quantization and the
connected-component boxes. Only the (n, 64, 6) box rows come back; the
host finishes them (box thresholds, analytic unclip, page coordinates).

``__call__(image)`` is the per-image path of ``InferTask``
(engine/infer_task.py, with its timings), as in JAX: the
host pre-processor (``models/dbnet/processor.py``, the resize on the
host), DBNet on the device, the full-resolution prob map downloaded, the
host post-processor (contours and min-area rectangles), or with
``use_device_postprocess`` the connected-component boxes on the device.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.device import (on_device, resolve_device, set_float_precision,
                             with_default_dtype)
from ..engine.infer_task import InferTask, replicate_on
from ..engine.params import init_dbnet, load_or_init
from ..models.dbnet.config import DbNetConfig
from ..models.dbnet.model import DBNet, inference_variables
from ..models.dbnet.processor import DbNetPostProcessor, DbNetPreProcessor
from ..models.registry import build_config, weights_dir
from ..ops.connected_components import batch_component_boxes_u8
from ..ops.resize_norm import resize_normalize
from ..pipeline.batch_runner import det_input_size, pack_pages

# pages per device program, box slots per page, and the CC scan rounds of
# the fused det+CC program
CHUNK_PAGES = 8
MAX_COMPONENTS = 64
CC_ITERS = 4
# resize_normalize arguments per DbNetConfig.norm_style: imagenet scales
# to [0, 1] then takes mean/std; modelscope flips RGB -> BGR and takes the
# mean off the 0..255 values, then / 255
NORM = {
    "imagenet": dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                     scale=1.0 / 255.0, reverse_channels=False),
    "modelscope": dict(mean=(123.68, 116.78, 103.94),
                       std=(255.0, 255.0, 255.0), scale=1.0,
                       reverse_channels=True),
}

Chunk = Tuple[List[int], List[Tuple[int, int]], Tuple[int, int], np.ndarray]


def det_config(model: str = "PP-OCRv4_det", **kw) -> DbNetConfig:
    """The config of a registered detector name (models/registry.py)."""
    return build_config("detection", model, **kw)


class OcrDetectionTask(InferTask):
    """DBNet text detection on ``device`` (``cuda`` unless ``"cpu"`` is
    asked for). Weights: ``variables`` (a flax-layout tree, see
    convert/flax_bridge.py) or, when None, the converted tree in
    ``weights_dir("detection", model)``, else the seeded :func:`init_dbnet`
    (engine/params.py::load_or_init).
    ``half_res_probs`` max-pools the prob map 2x2 before quantizing, as
    the JAX pipeline does; ``cfg_overrides`` go to :func:`det_config`,
    with the device's default dtype (engine/device.py::default_dtype)
    where they name none.
    Every backbone takes the detector size of the limit-side rule
    (``det_input_size``), as the JAX batched lane does.
    ``use_device_postprocess`` sends ``__call__``'s prob map through the
    device boxes instead of the host contours, as in the JAX task."""

    task_name = "detection"

    def __init__(self, model: str = "PP-OCRv4_det", device=None,
                 variables: Optional[Dict[str, Any]] = None,
                 half_res_probs: bool = True,
                 use_device_postprocess: bool = False, mesh=None,
                 **cfg_overrides):
        super().__init__(mesh)
        self.model_name = model
        self.device = resolve_device(device)
        self.model_config = cfg = det_config(
            model, **with_default_dtype(cfg_overrides, self.device))
        set_float_precision()
        self.half_res_probs = half_res_probs
        self.use_device_postprocess = use_device_postprocess
        self.pre = DbNetPreProcessor(cfg)
        self.post = DbNetPostProcessor(cfg)
        self.norm = NORM[cfg.norm_style]
        self.model = DBNet(cfg).eval()
        if variables is None:
            variables = load_or_init(weights_dir("detection", model),
                                     lambda: init_dbnet(cfg, 0),
                                     self.task_name)
        self.load_variables(variables)
        replicate_on(self.model.to(self.device), mesh)

    def load_variables(self, variables: Dict[str, Any]) -> None:
        """Load a flax-layout {"params", "batch_stats"} tree; a trained
        tree's ``thresh`` head is dropped (models/dbnet/model.py::
        inference_variables)."""
        from ..convert.flax_bridge import load_flax_variables

        load_flax_variables(self.model, inference_variables(variables))

    # -- the device program, stage by stage ---------------------------------

    def det_size(self, bucket_hw: Tuple[int, int]) -> Tuple[int, int]:
        return det_input_size(bucket_hw, self.model_config.limit_side_len)

    def prob_size(self, det_hw: Tuple[int, int]) -> Tuple[int, int]:
        nh, nw = det_hw
        return (nh // 2, nw // 2) if self.half_res_probs else (nh, nw)

    def normalize(self, canvas_u8: torch.Tensor, det_hw: Tuple[int, int]
                  ) -> torch.Tensor:
        """uint8 canvases (n, H, W, 3) -> normalized det input (n, nh, nw,
        3) f32, through the resize+normalize kernel on the card."""
        return resize_normalize(canvas_u8, det_hw, **self.norm)

    def quantize(self, prob: torch.Tensor) -> torch.Tensor:
        """prob (n, nh, nw) -> uint8 maps, 2x2 max-pooled first under
        ``half_res_probs``. Pooling before rounding equals rounding
        before pooling: rounding is monotone."""
        if self.half_res_probs:
            prob = F.max_pool2d(prob[:, None], 2)[:, 0]
        return torch.round(prob * 255.0).to(torch.uint8)

    def boxes(self, probs_u8: torch.Tensor, valid_hw: torch.Tensor
              ) -> torch.Tensor:
        """uint8 maps -> packed (n, 64, 6) box rows."""
        thr = int(round(self.model_config.thresh * 255))
        return batch_component_boxes_u8(probs_u8, thr, valid_hw,
                                        max_components=MAX_COMPONENTS,
                                        num_iters=CC_ITERS)

    @torch.inference_mode()
    def enqueue(self, canvas_u8, shapes, bucket_hw
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Enqueue one chunk's device program on its canvases (a numpy
        stack, uploaded here, or a tensor already on the device, used as it
        is); returns the (not yet downloaded) packed boxes and the prob
        map's size."""
        det_hw = self.det_size(bucket_hw)
        prob_hw = self.prob_size(det_hw)
        dev = self.device
        canvas = on_device(canvas_u8, dev)
        valid = torch.from_numpy(
            self._valid_extents(shapes, bucket_hw, prob_hw)).to(dev)
        prob = self.model(self.normalize(canvas, det_hw))["prob"]
        return self.boxes(self.quantize(prob), valid), prob_hw

    @torch.inference_mode()
    def enqueue_probs(self, canvas_u8, bucket_hw) -> torch.Tensor:
        """The chunk's uint8 prob maps (n, ph, pw), not yet downloaded: the
        resize+normalize kernel, DBNet and the quantization (2x2 max-pooled
        first under ``half_res_probs``), as the JAX runner's lane without
        device boxes returns them."""
        canvas = on_device(canvas_u8, self.device)
        prob = self.model(self.normalize(canvas,
                                         self.det_size(bucket_hw)))["prob"]
        return self.quantize(prob)

    # -- host side -----------------------------------------------------------

    def chunks(self, pages: Sequence[np.ndarray]) -> Iterator[Chunk]:
        """(page indices, page shapes, bucket, canvases) per chunk of up to
        ``CHUNK_PAGES`` pages of one canvas bucket."""
        for bucket, g in pack_pages(pages).items():
            for s in range(0, len(g["indices"]), CHUNK_PAGES):
                e = s + CHUNK_PAGES
                yield (g["indices"][s:e], g["shapes"][s:e], bucket,
                       g["images"][s:e])

    @staticmethod
    def _valid_extents(shapes, bucket_hw, prob_hw) -> np.ndarray:
        """Per-page valid (h, w) extents in prob-map pixels."""
        H, W = bucket_hw
        ph, pw = prob_hw
        return np.array([[int(round(h / H * ph)), int(round(w / W * pw))]
                         for h, w in shapes], np.int32).reshape(-1, 2)

    def _boxes_finish(self, packed: np.ndarray, shapes, bucket_hw,
                      prob_hw) -> List[np.ndarray]:
        """Box thresholds, analytic unclip and prob -> page coordinates;
        (n, 4, 2) f32 quads per page."""
        cfg = self.model_config
        H, W = bucket_hw
        ph, pw = prob_hw
        # min_size is in det-input pixels; half-res boxes are in half-res
        # prob pixels, so it shrinks with them
        min_size = cfg.min_size * (0.5 if self.half_res_probs else 1.0)
        results = []
        for i, (h, w) in enumerate(shapes):
            rows = packed[i]
            vh = max(int(round(h / H * ph)), 1)
            vw = max(int(round(w / W * pw)), 1)
            boxes = rows[:, :4]
            means = rows[:, 4]
            areas = rows[:, 5]
            bw = boxes[:, 2] - boxes[:, 0]
            bh = boxes[:, 3] - boxes[:, 1]
            keep = (areas > 0) & (means >= cfg.box_thresh) \
                & (np.minimum(bw, bh) >= min_size)
            b = boxes[keep]
            bw, bh = bw[keep], bh[keep]
            d = (bw * bh * cfg.unclip_ratio) / np.maximum(
                2.0 * (bw + bh), 1e-6)
            x1 = np.clip((b[:, 0] - d) / vw * w, 0, w)
            y1 = np.clip((b[:, 1] - d) / vh * h, 0, h)
            x2 = np.clip((b[:, 2] + d) / vw * w, 0, w)
            y2 = np.clip((b[:, 3] + d) / vh * h, 0, h)
            quads = np.stack([x1, y1, x2, y1, x2, y2, x1, y2],
                             axis=1).astype(np.float32)
            results.append(quads.reshape(-1, 4, 2))
        return results

    def batch_infer_from_pages(self, pages: Sequence[np.ndarray]
                               ) -> List[np.ndarray]:
        """``pages``: uint8 HWC RGB images. Returns one (n, 4, 2) f32 quad
        array per page, in page coordinates."""
        # every chunk is enqueued before the first download blocks
        pending = [(idx, shapes, bucket, *self.enqueue(canv, shapes, bucket))
                   for idx, shapes, bucket, canv in self.chunks(pages)]
        results: List[np.ndarray] = [np.zeros((0, 4, 2), np.float32)] \
            * len(pages)
        for idx, shapes, bucket, packed, prob_hw in pending:
            quads = self._boxes_finish(packed.cpu().numpy(), shapes, bucket,
                                       prob_hw)
            for i, q in zip(idx, quads):
                results[i] = q
        return results

    # -- the per-image path ----------------------------------------------------

    @torch.inference_mode()
    def prob_map(self, x: np.ndarray) -> torch.Tensor:
        """A pre-processed (1, H, W, 3) f32 input -> its (H, W) f32 prob
        map, on the device."""
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self.model(x)["prob"][0].float()

    def _preprocess(self, image: np.ndarray):
        pre = self.pre(image)
        return pre["image"], {"org_shape": pre["org_shape"],
                              "net_shape": tuple(pre["image"].shape[1:3])}

    def _run_model(self, batch: np.ndarray) -> torch.Tensor:
        return self.prob_map(batch)

    def _postprocess(self, prob: torch.Tensor, meta) -> Dict[str, Any]:
        if self.use_device_postprocess:
            result = self.post.fast_device_boxes(prob, meta["org_shape"])
        else:
            result = self.post(prob.cpu().numpy(), meta["org_shape"],
                               meta["net_shape"])
        result["prob_shape"] = tuple(prob.shape)
        return result
