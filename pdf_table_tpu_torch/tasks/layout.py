"""Layout-analysis task, PicoDet and DocXLayout (counterpart of
pdf_table_tpu/tasks/layout.py, the page-batched path that
``BatchPipeline`` runs: ``batch_enqueue_pages`` and ``batch_finish``).

``enqueue`` takes the uint8 canvas stack of one chunk (numpy, or a tensor
already on the task's device) and returns the chunk's device result
without downloading it; ``finish`` downloads it and builds each page's
layout cells in canvas coordinates.

- PicoDet: the stack resized to the model's 800x608 input with the
  antialiased bilinear weights of ``jax.image.resize``, normalized,
  PicoDet, the GFL decode with a global top-k and the per-class
  fixed-point NMS; the survivors (P, C, keep_top_k, 5).
- DocXLayout (``"DocXLayout"`` or ``"docx_layout"``): each canvas warped
  to 768^2 as the JAX pre-processor's ``cv2.warpAffine`` of its BGR copy
  does, normalized, the DLA trunk (its 16 deform convs on the DCN kernel)
  in sub-batches of ``DOCX_SUB_BATCH`` and the 4-point decode; the slots
  (P, top_k + 20, 10). The host scales them back, thresholds, runs the
  polygon NMS and labels the cells. The JAX runner downloads the canvases
  and runs the cv2 path once per page instead.

The per-image path of the JAX task: ``__call__(image)`` (PicoDet: the host
pre-processor's resize, the forward, the host decode and ``hard_nms``;
DocXLayout: the page path with the image as the page) and
``batch_enqueue`` / ``batch_finish`` / ``batch_infer`` over images resized
on the host (PicoDet: one forward and the device decode, the NMS on the
host; DocXLayout: one ``__call__`` per image).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..engine.device import (on_device, resolve_device, set_float_precision,
                             with_default_dtype)
from ..engine.infer_task import replicate_on
from ..engine.params import init_docx_layout, init_picodet, load_or_init
from ..entity.ocr_cell import OcrCell
from ..models.center_net.processor import CenterNetPreProcessor
from ..models.docx_layout.model import DocXLayoutModel, unpack_docx
from ..models.docx_layout.processor import DocXLayoutPostProcessor
from ..models.picodet.model import PicoDet
from ..models.picodet.processor import (PicoDetPostProcessor,
                                        PicoDetPreProcessor,
                                        device_decode_topk, device_nms_pack)
from ..models.registry import build_config, weights_dir

Handle = Tuple[torch.Tensor, List[Dict[str, Any]]]
# the registry's DocXLayout and the alias the system's config takes
DOCX_ALIASES = {"docx_layout": "DocXLayout"}
# DocXLayout pages per forward: a runner chunk's
DOCX_SUB_BATCH = 8


@functools.lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis (``scale_and_translate`` with the triangle kernel): on a
    downscale the kernel is widened by 1 / scale, which antialiases; each
    output's weights are normalized to sum to 1 and zeroed where its sample
    point lies outside the input. Computed in f32 and rounded where XLA
    rounds the jitted resize: the sample point as one fused multiply-add,
    the constant kernel scale as a reciprocal (the weights then agree with
    JAX's to 6e-8, against 1.5e-5 from the plain expression)."""
    inv = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, np.float32(1.0))
    half = np.arange(n_out, dtype=np.float32) + np.float32(0.5)
    sample = (half.astype(np.float64) * np.float64(inv) - 0.5) \
        .astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        * np.float32(1.0 / kernel_scale)
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _resize_weights_on(n_in: int, n_out: int, device: torch.device
                       ) -> torch.Tensor:
    """:func:`resize_weights` on ``device``, uploaded once."""
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def resize_bilinear_aa(pages: torch.Tensor, out_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """uint8 (P, H, W, 3) -> f32 (P, Ho, Wo, 3) in 0..255: the separable
    antialiased resize as two matmuls with :func:`resize_weights` (the
    result is an NHWC view of NCHW memory)."""
    _, H, W, _ = pages.shape
    ho, wo = out_hw
    wx = _resize_weights_on(W, wo, pages.device)
    wy = _resize_weights_on(H, ho, pages.device)
    x = pages.permute(0, 3, 1, 2).float()                # (P, 3, H, W)
    x = torch.matmul(torch.matmul(x, wx).transpose(-1, -2), wy)
    return x.permute(0, 3, 2, 1)                         # (P, Ho, Wo, 3)


class OcrLayoutTask:
    """Layout analysis on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for), ``model`` a layout name of models/registry.py (or
    "docx_layout"). Weights: ``variables`` (a flax-layout tree, see
    convert/flax_bridge.py) or, when None, the model's seeded ``init_*``.
    ``config`` or ``cfg_overrides`` set ``PicoDetConfig`` (with
    ``task_type``, and the device's default dtype,
    engine/device.py::default_dtype, where they name none, as the JAX
    registry builds it) or ``DocXLayoutConfig`` (which ignores
    ``task_type``, and is f32 unless asked, as the JAX task does). On the
    CPU, ``PDFTABLE_DEVICE_NMS=0`` selects PicoDet's host route (``hard_nms``
    over the downloaded candidates), as in the JAX task; on a card the NMS
    always runs on the device."""

    task_name = "layout"

    def __init__(self, model: str = "picodet", device=None,
                 variables: Optional[Dict[str, Any]] = None,
                 task_type: str = "en", config: Optional[Any] = None,
                 mesh=None, **cfg_overrides):
        self.device = resolve_device(device)
        self.mesh = mesh
        set_float_precision()
        self.model_name = DOCX_ALIASES.get(model, model)
        if config is None:
            kw = cfg_overrides if self.model_name == "DocXLayout" \
                else with_default_dtype(cfg_overrides, self.device)
            config = build_config("layout", self.model_name,
                                  task_type=task_type, **kw)
        self.model_config = cfg = config
        if self.docx:
            # Cycle-CenterNet's warp and normalize are DocXLayout's: the
            # same centred matrix, sampling and MEAN / STD; a canvas is
            # the window (p, 0, 0, W, H)
            self.pre = CenterNetPreProcessor(cfg)
            self.post = DocXLayoutPostProcessor(cfg)
            self.model = DocXLayoutModel(cfg).eval()
            init = init_docx_layout
            wdir = weights_dir("layout", "DocXLayout")
        else:
            self.pre = PicoDetPreProcessor(cfg)
            self.post = PicoDetPostProcessor(cfg)
            self.model = PicoDet(cfg).eval()
            init = init_picodet
            wdir = weights_dir("layout", self.model_name, cfg.task_type)
            self.mean = torch.tensor(cfg.norm_mean, device=self.device)
            self.std = torch.tensor(cfg.norm_std, device=self.device)
        if variables is None:
            variables = load_or_init(wdir, lambda: init(cfg, 0),
                                     self.task_name)
        self.load_variables(variables)
        replicate_on(self.model.to(self.device), mesh)

    @property
    def docx(self) -> bool:
        return self.model_name == "DocXLayout"

    def load_variables(self, variables: Dict[str, Any]) -> None:
        """Load a flax-layout {"params", "batch_stats"} tree."""
        from ..convert.flax_bridge import load_flax_variables

        load_flax_variables(self.model, variables)

    @property
    def device_nms(self) -> bool:
        return not self.docx and (
            self.device.type == "cuda"
            or os.environ.get("PDFTABLE_DEVICE_NMS", "1") != "0")

    # -- the device program, stage by stage -----------------------------------

    def preprocess(self, pages: torch.Tensor) -> torch.Tensor:
        """uint8 canvases (P, H, W, 3) on the device -> the normalized
        model input: PicoDet's (P, 800, 608, 3), DocXLayout's (P, 768,
        768, 3) BGR warp, both f32."""
        if self.docx:
            P, H, W = pages.shape[:3]
            coef, _ = self.pre.plan(H, W)
            return self.pre.normalize(self.pre.warp_crops(
                pages, [(i, 0, 0, W, H) for i in range(P)],
                np.tile(coef, (P, 1))))
        cfg = self.model_config
        x = resize_bilinear_aa(pages, (cfg.img_height, cfg.img_width))
        return (x / 255.0 - self.mean) / self.std

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The model's head maps: DocXLayout in sub-batches of
        ``DOCX_SUB_BATCH``, joined."""
        if not self.docx:
            return self.model(x)
        outs = [self.model.heads(x[s:s + DOCX_SUB_BATCH])
                for s in range(0, x.shape[0], DOCX_SUB_BATCH)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def decode(self, raw: Dict[str, Any]) -> torch.Tensor:
        """Head maps -> PicoDet's top-k candidates [boxes | scores] (P, k,
        4 + C), or DocXLayout's slots (P, top_k + 20, 10)."""
        if self.docx:
            return self.model.decode(raw)
        return device_decode_topk(raw, self.model_config)

    def nms(self, cand: torch.Tensor) -> torch.Tensor:
        """Candidates -> survivors (P, C, keep_top_k, 5)."""
        return device_nms_pack(cand[..., :4], cand[..., 4:],
                               self.model_config)

    @torch.inference_mode()
    def enqueue(self, pages) -> Handle:
        """One chunk's device program; returns the (not yet downloaded)
        PicoDet survivors (the candidates on the host route) or
        DocXLayout slots, and per-page metas (boxes decode in canvas
        coordinates)."""
        pages = on_device(pages, self.device)
        P, H, W = pages.shape[:3]
        out = self.decode(self.forward(self.preprocess(pages)))
        if self.docx:
            meta = self.pre.plan(H, W)[1]
            return out, [dict(meta) for _ in range(P)]
        dev_nms = self.device_nms
        metas = [{"org_shape": (H, W), "device_nms": dev_nms}
                 for _ in range(P)]
        return (self.nms(out) if dev_nms else out), metas

    # -- host side ------------------------------------------------------------

    def results(self, handle: torch.Tensor, metas: List[Dict[str, Any]]
                ) -> List[Dict[str, Any]]:
        """Download an :meth:`enqueue` result -> each page's post-processor
        result with its ``layout_cells``."""
        packed = handle.cpu().numpy()
        out = []
        for i, meta in enumerate(metas):
            if self.docx:
                result = self.post(unpack_docx(packed[i],
                                               self.model_config.top_k),
                                   meta)
            elif meta["device_nms"]:
                result = self.post.from_device_nms(packed[i],
                                                   meta["org_shape"])
            else:
                result = self.post.from_candidates(
                    packed[i, :, :4], packed[i, :, 4:], meta["org_shape"])
            result["layout_cells"] = self.post.to_layout_cells(result)
            out.append(result)
        return out

    def finish(self, handle: torch.Tensor, metas: List[Dict[str, Any]]
               ) -> List[List[OcrCell]]:
        """Download an :meth:`enqueue` result -> layout cells per page."""
        return [r["layout_cells"] for r in self.results(handle, metas)]

    def batch_infer_from_pages(self, pages) -> List[List[OcrCell]]:
        """``pages`` (P, H, W, 3) uint8 RGB canvases (numpy, or a tensor on
        the task's device). Returns per page its layout cells in canvas
        coordinates."""
        return self.finish(*self.enqueue(pages))

    @torch.inference_mode()
    def __call__(self, image: np.ndarray) -> Dict[str, Any]:
        """One image (H, W, 3) uint8 RGB -> {"bboxs", "layout_cells"} (and
        DocXLayout's "subfield_dets") in image coordinates. PicoDet: the
        host pre-processor, the forward, the host decode with
        ``hard_nms``. DocXLayout: the page path with the image as the page
        (the JAX task warps it with cv2 on the host; the same sample points
        are taken here on the device)."""
        if self.docx:
            return self.results(*self.enqueue(
                np.ascontiguousarray(image)[None]))[0]
        pre = self.pre(image)
        x = torch.from_numpy(pre["image"]).to(self.device)
        raw = self.model(x)
        result = self.post([s[0].float().cpu().numpy() for s in raw["scores"]],
                           [b[0].float().cpu().numpy() for b in raw["boxes"]],
                           pre["org_shape"])
        result["layout_cells"] = self.post.to_layout_cells(result)
        return result

    @torch.inference_mode()
    def batch_enqueue(self, images):
        """Images resized on the host to PicoDet's input, uploaded as one
        uint8 stack, normalized, the forward and the device decode's top-k
        candidates (not yet downloaded); with the per-image metas.
        DocXLayout: (None, images), each image runs :meth:`__call__` in
        :meth:`batch_finish`."""
        if self.docx:
            return None, list(images)
        prepped = [self.pre.resize_u8(img) for img in images]
        u8 = np.concatenate([p.pop("image_u8") for p in prepped])
        x = torch.from_numpy(u8).to(self.device).float()
        x = (x / 255.0 - self.mean) / self.std
        return device_decode_topk(self.model(x), self.model_config), prepped

    def batch_finish(self, handle, metas) -> List[List[OcrCell]]:
        """Download a :meth:`batch_enqueue` result -> layout cells per
        image (the per-class ``hard_nms`` on the host)."""
        if self.docx:
            return [self(img)["layout_cells"] for img in metas]
        packed = handle.cpu().numpy()
        out = []
        for i, meta in enumerate(metas):
            result = self.post.from_candidates(
                packed[i, :, :4], packed[i, :, 4:], meta["org_shape"])
            out.append(self.post.to_layout_cells(result))
        return out

    def batch_infer(self, images) -> List[List[OcrCell]]:
        return self.batch_finish(*self.batch_enqueue(images))
