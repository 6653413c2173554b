"""Table-structure-recognition task (counterpart of
pdf_table_tpu/tasks/table_structure.py): ``Lore``, ``LoreAndLineCell``,
``CenterNet``, ``Lgpma``, ``LineCell`` (and ``LineCellPdf``, the same task
here as in the JAX dispatcher: the vector lines of digital pages are read
by the runner, ``pipeline/batch_runner.py::_digital_tables``), ``SLANet``,
``TableMaster`` and ``MtlTabNet``.

``batch_infer_from_pages`` takes page images and table regions, cuts every
crop on the device from the resident pages, runs the model per sub-batch,
downloads each sub-batch once and post-processes each crop on the host.

- LORE: corner-anchored axis-aligned resample, BGR flip, CenterNet
  normalization; the trunk, decode and logical-location regressor per
  resolution bucket and sub-batch, into {"cells": [...]} in crop
  coordinates. Under ``wiz_rev`` (``task_type="wtw"``, the default) a
  sub-batch runs detect-decode, the dense corner refine and re-sort, then
  the feature gathers and regressor, all on the device.
  ``LoreAndLineCell`` is LORE plus the line cells of each window (one
  download of the windows, the host LineCell), merged by
  :func:`merge_tsr_cells`.
- Cycle-CenterNet: the integer window warped to 1024^2 as the JAX
  pre-processor's ``cv2.warpAffine`` does, in sub-batches of
  ``batch_size``; the trunk (its deform convs on the DCN kernel) and the
  cell and vertex decode on the device; the vertex snap and logical
  coordinates on the host.
- LGPMA: one crop a forward (the JAX program takes one image): the window
  resized as ``cv2.resize`` does, ImageNet normalization, the two-stage
  detector and mask heads on the device, the pyramid refine and the
  adjacency cliques on the host.
- LineCell: the windows downloaded with one copy, the lines and the grid
  cells on the host (no model).
- SLANet, TableMaster / MtlTabNet (the token models): the integer window
  of the region resized to uint8 as ``cv2.resize`` does
  (ops/crop_resize.py), each model's normalize and pad, the encoder and
  the 500-step greedy decode in sub-batches of ``batch_size``, into
  {"structure_tokens", "cells", "type"} for the token path of table HTML.

The per-crop surface takes table images instead: ``__call__(image)`` runs
one crop through its model's host preprocess (JAX's ``InferTask.__call__``
through ``_preprocess``), ``batch_infer(crops)`` all of a page's crops as
JAX's ``batch_infer`` does: LORE's uint8 warps uploaded as one stack, the
BGR flip and normalize on the device; the other models' host preprocess
per crop; sub-batches of ``batch_size`` padded to the bucket size (LGPMA:
one crop a forward).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.buckets import bucket_batch_size
from ..engine.infer_task import InferTask
from ..engine.device import (on_device, resolve_device, set_float_precision,
                             with_default_dtype)
from ..engine.params import (init_centernet, init_lgpma, init_lore,
                             init_slanet, init_table_master, load_or_init)
from ..models.center_net.config import CenterNetConfig
from ..models.center_net.model import CycleCenterNet, unpack_centernet
from ..models.center_net.processor import (CenterNetPostProcessor,
                                           CenterNetPreProcessor,
                                           assign_logical_coords)
from ..models.lgpma.config import LgpmaConfig
from ..models.lgpma.model import LGPMA
from ..models.lgpma.processor import (LgpmaPostProcessor,
                                      LgpmaPreProcessor)
from ..models.line_cell.algo import extract_cells_from_image
from ..models.lore.config import LoreConfig
from ..models.lore.model import LoreModel, unpack_lore
from ..models.lore.processor import LorePostProcessor, LorePreProcessor
from ..models.registry import build_config, weights_dir
from ..models.slanet.config import SLANetConfig
from ..models.slanet.model import SLANet
from ..models.slanet.processor import SLANetPostProcessor, SLANetPreProcessor
from ..models.table_master.config import TableMasterConfig
from ..models.table_master.model import TableMaster
from ..models.table_master.processor import (TableMasterPostProcessor,
                                             TableMasterPreProcessor)
from ..models.table_master.vocab import load_pubtabnet_textline_alphabet
from ..ops.crop_resize import crop_resize_u8, crop_taps, crop_windows
from ..ops.warp import resample_axis_aligned_crops
from .table_to_html import bbox_iou

Region = Tuple[int, Tuple[float, float, float, float]]
TOKEN_MODELS = ("SLANet", "TableMaster", "MtlTabNet")
MODELS = ("Lore", "LoreAndLineCell", "CenterNet", "Lgpma",
          "LineCell", "LineCellPdf") + TOKEN_MODELS
# the outputs of an LGPMA forward that its post-processor reads
LGPMA_OUTPUTS = ("cls_probs", "det_boxes", "mask_idx", "lpma_masks")


def merge_tsr_cells(primary: Dict[str, Any], secondary: Dict[str, Any],
                    iou_thresh: float = 0.5) -> Dict[str, Any]:
    """LORE and LineCell merged (a copy of the JAX function): the
    secondary (line) cells, plus each primary (model) cell that no
    secondary cell covers at ``iou_thresh``, with logical coordinates
    derived again over the union."""
    base = [dict(c) for c in secondary.get("cells", [])]
    for c in primary.get("cells", []):
        covered = any(bbox_iou(c["bbox"], b["bbox"]) >= iou_thresh
                      for b in base)
        if not covered:
            base.append(dict(c))
    assign_logical_coords(base)
    return {"cells": base, "type": "lore_line_cell_merge"}


def lore_config(task_type: str = "wtw", **kw) -> LoreConfig:
    """LORE's config for ``task_type`` (models/registry.py)."""
    return build_config("table_structure", "Lore", task_type=task_type,
                        **kw)


def _sidecar_dict(wdir: str, name_keys: Sequence[str]) -> str:
    """The first vocab txt in ``wdir`` whose name holds one of
    ``name_keys`` (the converter copies a snapshot's dict files beside the
    converted weights); "" when there is none."""
    if not os.path.isdir(wdir):
        return ""
    for p in sorted(glob.glob(os.path.join(wdir, "*.txt"))):
        base = os.path.basename(p).lower()
        if any(k in base for k in name_keys):
            return p
    return ""


def _with_sidecar_dict(cfg, model: str, name_keys: Sequence[str]):
    """``cfg`` with its ``dict_path`` set to the sidecar dict of
    ``model``'s weights directory where it names none, as JAX's task
    does."""
    if cfg.dict_path:
        return cfg
    path = _sidecar_dict(weights_dir("table_structure", model), name_keys)
    return dataclasses.replace(cfg, dict_path=path) if path else cfg


class OcrTableStructureTask(InferTask):
    """Table structure on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for) with ``model`` one of ``MODELS``. Weights: ``variables`` (a
    flax-layout tree, see convert/flax_bridge.py) or, when None, the
    model's seeded ``init_*`` (LineCell has none). LORE (and
    LoreAndLineCell): ``res_buckets`` ("auto" or a tuple of sides) runs
    small crops at a smaller square resolution; ``batch_size`` caps a
    full-resolution sub-batch. CenterNet and the token models run
    sub-batches of ``batch_size`` crops at their one input size, LGPMA one
    crop at a time. ``config`` or the config fields in ``kw`` set the
    model; LORE and SLANet, which the JAX package builds through its
    registry, take the device's default dtype
    (engine/device.py::default_dtype) where ``kw`` names none, the other
    models f32."""

    task_name = "table_structure"

    def __init__(self, model: str = "Lore", task_type: str = "wtw",
                 config: Optional[Any] = None,
                 res_buckets: Any = (), device=None, batch_size: int = 8,
                 variables: Optional[Dict[str, Any]] = None, **kw):
        super().__init__()
        if model not in MODELS:
            raise ValueError(f"unknown TSR model {model!r}; expected one "
                             f"of {MODELS}")
        if model == "LineCellPdf":
            model = "LineCell"
        # merge mode: LORE cells fused with the line cells, as in JAX
        self.merge_line_cell = model == "LoreAndLineCell"
        if self.merge_line_cell:
            model = "Lore"
        self.model_name = model
        self.device = resolve_device(device)
        set_float_precision()
        self.batch_size = batch_size
        if model == "LineCell":
            self.model_config = self.model = None
            return
        if model == "Lore":
            self._init_lore(config, task_type, res_buckets, **kw)
        elif model == "CenterNet":
            self.model_config = cfg = config or CenterNetConfig(**kw)
            self.pre = CenterNetPreProcessor(cfg)
            self.post = CenterNetPostProcessor(cfg)
            self.model = CycleCenterNet(cfg).eval()
            self._init_tree = init_centernet
        elif model == "Lgpma":
            self.model_config = cfg = config or LgpmaConfig(**kw)
            self.pre = LgpmaPreProcessor(cfg)
            self.post = LgpmaPostProcessor(cfg)
            self.model = LGPMA(cfg).eval()
            self._init_tree = init_lgpma
        else:
            self._init_token_model(config, **kw)
        if variables is None:
            cfg = self.model_config
            variables = load_or_init(
                weights_dir("table_structure", self.model_name,
                            getattr(cfg, "task_type", "")),
                lambda: self._init_tree(cfg), self.task_name)
        self.load_variables(variables)
        self.model.to(self.device)

    def _init_lore(self, config, task_type, res_buckets, **kw) -> None:
        self.model_config = config or lore_config(
            task_type, **with_default_dtype(kw, self.device))
        cfg = self.model_config
        if res_buckets == "auto":
            self.res_buckets = (384, 512)
        else:
            self.res_buckets = tuple(res_buckets or ())
        self.pre = LorePreProcessor(cfg)
        self.post = LorePostProcessor(cfg)
        self.model = LoreModel(cfg).eval()
        self._init_tree = init_lore
        self.mean = torch.as_tensor(LorePreProcessor.MEAN, device=self.device)
        self.std = torch.as_tensor(LorePreProcessor.STD, device=self.device)

    def _init_token_model(self, config, **kw) -> None:
        """SLANet, TableMaster or MtlTabNet (the MtlTabNet cell branch's
        parameters are declared, so that its tree loads; the runner does
        not decode cells, as in JAX)."""
        if self.model_name == "SLANet":
            cfg = config or SLANetConfig(**with_default_dtype(kw, self.device))
            # a converted snapshot ships its structure dict next to the
            # weights (the converter copies it); it wins over the built-in
            # token set, so that ids match the checkpoint
            self.model_config = cfg = _with_sidecar_dict(
                cfg, self.model_name, ("table_structure", "structure"))
            self.pre = SLANetPreProcessor(cfg)
            self.post = SLANetPostProcessor(cfg)
            self.model = SLANet(cfg).eval()
            self._init_tree = init_slanet
            self.input_hw = (cfg.table_max_len, cfg.table_max_len)
            return
        kw.setdefault("variant", "mtl_tabnet" if self.model_name
                      == "MtlTabNet" else "table_master")
        self.model_config = cfg = _with_sidecar_dict(
            config or TableMasterConfig(**kw), self.model_name,
            ("structure_alphabet", "structure"))
        self.pre = TableMasterPreProcessor(cfg)
        cell_charset = None
        if cfg.variant == "mtl_tabnet":
            # the PubTabNet textline alphabet + the master specials
            cell_charset = load_pubtabnet_textline_alphabet()
            if not cfg.cell_vocab_size:
                cfg.cell_vocab_size = len(cell_charset) + 4
        self.post = TableMasterPostProcessor(cfg, cell_charset=cell_charset)
        self.model = TableMaster(cfg).eval()
        self._init_tree = init_table_master
        self.input_hw = tuple(cfg.img_size)

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
        """Yield (crop indices, meta per crop, model input) for each
        sub-batch. LORE: grouped by resolution bucket, each group cut at a
        cap that scales with the bucket's pixel ratio; CenterNet and the
        token models: runs of ``batch_size`` in region order; LGPMA: one
        crop each. A page tensor already on the device is used as it is,
        not copied."""
        pages_t = on_device(pages, self.device)
        if self.model_name in TOKEN_MODELS:
            yield from self._token_sub_batches(pages_t, regions)
            return
        if self.model_name == "CenterNet":
            yield from self._centernet_sub_batches(pages_t, regions)
            return
        if self.model_name == "Lgpma":
            yield from self._lgpma_sub_batches(pages_t, regions)
            return
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

    def _centernet_sub_batches(self, pages_t: torch.Tensor,
                               regions: Sequence[Region]):
        """Cycle-CenterNet's sub-batches: the integer windows warped to
        the model's resolution and normalized."""
        windows = crop_windows(tuple(pages_t.shape[1:3]), regions)
        plans = [self.pre.plan(y2 - y1, x2 - x1)
                 for _, x1, y1, x2, y2 in windows]
        cap = max(1, self.batch_size)
        for s0 in range(0, len(windows), cap):
            sub = list(range(s0, min(s0 + cap, len(windows))))
            with torch.inference_mode():
                x = self.pre.normalize(self.pre.warp_crops(
                    pages_t, [windows[i] for i in sub],
                    np.stack([plans[i][0] for i in sub])))
            yield sub, [plans[i][1] for i in sub], x

    def _lgpma_sub_batches(self, pages_t: torch.Tensor,
                           regions: Sequence[Region]):
        """LGPMA's one-crop sub-batches: the window resized as
        ``cv2.resize`` does to its multiple-of-32 size, normalized."""
        windows = crop_windows(tuple(pages_t.shape[1:3]), regions)
        for i, (pi, x1, y1, x2, y2) in enumerate(windows):
            nh, nw, meta = self.pre.plan(y2 - y1, x2 - x1)
            taps = torch.from_numpy(crop_taps([windows[i]], [(nh, nw)],
                                              (nh, nw)))
            with torch.inference_mode():
                u8 = crop_resize_u8(pages_t, taps.to(self.device), (nh, nw))
                x = self.pre.normalize(u8)
            yield [i], [meta], x

    def _token_sub_batches(self, pages_t: torch.Tensor,
                           regions: Sequence[Region]):
        """The token models' sub-batches: metas are the shape lists."""
        windows = crop_windows(tuple(pages_t.shape[1:3]), regions)
        plans = [self.pre.plan(y2 - y1, x2 - x1)
                 for _, x1, y1, x2, y2 in windows]
        cap = max(1, self.batch_size)
        for s0 in range(0, len(windows), cap):
            sub = list(range(s0, min(s0 + cap, len(windows))))
            sizes = [plans[i][:2] for i in sub]
            yield (sub, [plans[i][2] for i in sub],
                   self._token_crops(pages_t, [windows[i] for i in sub],
                                     sizes))

    @torch.inference_mode()
    def _token_crops(self, pages: torch.Tensor, windows, sizes
                     ) -> torch.Tensor:
        """Normalized NHWC model inputs of one sub-batch: the windows
        resized to ``sizes`` as cv2.resize does, then the model's own
        normalize and pad."""
        taps = torch.from_numpy(crop_taps(windows, sizes, self.input_hw))
        u8 = crop_resize_u8(pages, taps.to(self.device), self.input_hw)
        if self.model_name == "SLANet":
            return self.pre.normalize(u8, sizes)
        return self.pre.normalize(u8)

    def _forward_packed(self, x: torch.Tensor):
        """One sub-batch's outputs to download: LORE's packed cells;
        CenterNet's packed cells and vertices; LGPMA's outputs that its
        post reads; the token models' probabilities and locs side by side,
        (B, T, V + L)."""
        if self.model_name in ("Lore", "CenterNet"):
            return self.model.forward_packed(x)
        out = self.model(x)
        if self.model_name == "Lgpma":
            return {k: out[k] for k in LGPMA_OUTPUTS}
        return torch.cat([out["structure_probs"], out["loc_preds"]], dim=-1)

    def _post_one(self, packed, meta) -> Dict[str, Any]:
        """One crop's host post from its (1, ...) slice of the download
        (LGPMA: the whole download, a dict of arrays)."""
        if self.model_name == "Lore":
            return self.post(unpack_lore(packed), meta)
        if self.model_name == "CenterNet":
            return self.post(unpack_centernet(packed,
                                              self.model_config.K), meta)
        if self.model_name == "Lgpma":
            return self.post(packed, meta)
        v = self.model.head.vocab_size if self.model_name == "SLANet" \
            else self.model.vocab_size
        raw = {"structure_probs": packed[..., :v],
               "loc_preds": packed[..., v:]}
        if self.model_name == "SLANet":
            return self.post(raw, meta)
        return self.post(raw, {"shape_list": meta})

    def host_windows(self, pages, regions: Sequence[Region]
                     ) -> List[np.ndarray]:
        """The regions' integer windows as host uint8 arrays, cut on the
        pages' device and downloaded with one copy."""
        pages_t = torch.as_tensor(pages)
        windows = crop_windows(tuple(pages_t.shape[1:3]), regions)
        flat = torch.cat([pages_t[pi, y1:y2, x1:x2].reshape(-1)
                          for pi, x1, y1, x2, y2 in windows]).cpu().numpy()
        out, o = [], 0
        for _, x1, y1, x2, y2 in windows:
            n = (y2 - y1) * (x2 - x1) * 3
            out.append(flat[o:o + n].reshape(y2 - y1, x2 - x1, 3))
            o += n
        return out

    @torch.inference_mode()
    def batch_infer_from_pages(self, pages, regions: Sequence[Region]
                               ) -> List[Dict[str, Any]]:
        """``pages`` (P, H, W, 3) uint8 RGB (numpy or tensor); ``regions``
        [(page_idx, (x1, y1, x2, y2))] in page coords. Returns one result
        per region: {"cells": [...], "type"} ("lore",
        "lore_line_cell_merge", "center_net", "lgpma", "line_cell"), and
        for the token models {"structure_tokens", "cells", "score",
        "type"}."""
        if not regions:
            return []
        if self.model_name == "LineCell":
            return [extract_cells_from_image(w)
                    for w in self.host_windows(pages, regions)]
        # every sub-batch is enqueued before the first download blocks
        pending = [(sub, metas, self._forward_packed(x))
                   for sub, metas, x in self.sub_batches(pages, regions)]
        line_cells = None
        if self.merge_line_cell:
            # host line cells while the card runs LORE
            line_cells = [extract_cells_from_image(w)
                          for w in self.host_windows(pages, regions)]
        results = self._download_post(pending, len(regions))
        if line_cells is not None:
            results = [merge_tsr_cells(r, lc)
                       for r, lc in zip(results, line_cells)]
        return results

    def _download_post(self, pending, n: int) -> List[Dict[str, Any]]:
        """Download each sub-batch's outputs once and post-process its
        crops: ``pending`` is [(crop indices, metas, device outputs)]."""
        results: List[Dict[str, Any]] = [{} for _ in range(n)]
        for sub, metas, packed in pending:
            if isinstance(packed, dict):
                host = {k: v.cpu().numpy() for k, v in packed.items()}
                results[sub[0]] = self._post_one(host, metas[0])
                continue
            packed_np = packed.cpu().numpy()
            for j, (i, meta) in enumerate(zip(sub, metas)):
                results[i] = self._post_one(packed_np[j:j + 1], meta)
        return results

    def host_preprocess(self, image: np.ndarray
                        ) -> Tuple[np.ndarray, Any]:
        """One uint8 RGB crop through its model's host preprocess (JAX's
        ``_preprocess``): the (1, H, W, 3) f32 model input and the meta
        that :meth:`_post_one` takes."""
        out = self.pre(image)
        if self.model_name == "SLANet":
            return out["image"], out["shape_list"]
        meta = out["meta"]
        if self.model_name in TOKEN_MODELS:
            return out["image"], meta["shape_list"]
        return out["image"], meta

    # -- the per-image path (InferTask.__call__) ----------------------------
    #
    # One table image (H, W, 3) uint8 RGB through its model's host
    # preprocess, as JAX's ``__call__``: LORE's float warp, CenterNet's,
    # LGPMA's resize, the token models' resize and pad; LineCell on the
    # host. ``LoreAndLineCell`` merges the line cells where the image has
    # any, as JAX's ``_postprocess`` does.

    def _preprocess(self, image: np.ndarray):
        if self.model_name == "LineCell":
            return {"host_result": extract_cells_from_image(image)}, None
        x, meta = self.host_preprocess(image)
        line_cells = extract_cells_from_image(image) \
            if self.merge_line_cell else None
        return {"image": x}, (meta, line_cells)

    @torch.inference_mode()
    def _run_model(self, batch):
        if "host_result" in batch:
            return batch["host_result"]
        return self._forward_packed(torch.from_numpy(batch["image"]).to(
            self.device))

    @torch.inference_mode()
    def _postprocess(self, raw, meta) -> Dict[str, Any]:
        if self.model_name == "LineCell":
            return raw
        meta, line_cells = meta
        result = self._download_post([([0], [meta], raw)], 1)[0]
        if line_cells is not None and line_cells.get("cells"):
            result = merge_tsr_cells(result, line_cells)
        return result

    @torch.inference_mode()
    def batch_infer(self, crops: Sequence[np.ndarray]
                    ) -> List[Dict[str, Any]]:
        """All table crops of a page (uint8 RGB arrays), as JAX's
        ``batch_infer``: LORE's ``warp_u8`` per crop, the uint8 stack
        uploaded once, the BGR flip and normalize on the device; the other
        models' host preprocess per crop; sub-batches of ``batch_size``
        padded to the bucket size, every one enqueued before the first
        download. LGPMA runs one crop a forward at the crop's own
        multiple-of-32 size (its JAX program takes one image); LineCell
        runs :meth:`__call__` per crop. LORE's results carry no line cells,
        as JAX's warp path's do not."""
        if not crops:
            return []
        if self.model_name == "LineCell":
            return [self(c) for c in crops]
        if self.model_name == "Lgpma":
            pending = []
            for i, c in enumerate(crops):
                x, meta = self.host_preprocess(c)
                pending.append(([i], [meta], self._forward_packed(
                    on_device(x, self.device))))
            return self._download_post(pending, len(crops))
        if self.model_name == "Lore":
            prepped = [self.pre.warp_u8(c) for c in crops]
            stack = on_device(np.concatenate(
                [p["image_u8"] for p in prepped]), self.device)
            metas = [p["meta"] for p in prepped]
        else:
            prepped = [self.host_preprocess(c) for c in crops]
            stack = on_device(np.concatenate([p[0] for p in prepped]),
                              self.device)
            metas = [p[1] for p in prepped]
        cap = max(1, self.batch_size)
        pending = []
        for s0 in range(0, len(crops), cap):
            sub = list(range(s0, min(s0 + cap, len(crops))))
            x = stack[s0:s0 + len(sub)]
            pad = bucket_batch_size(len(sub)) - len(sub)
            if pad:    # zero crops, as JAX's pad_batch adds
                x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
            if self.model_name == "Lore":
                x = (x.float().flip(-1) / 255.0 - self.mean) / self.std
            pending.append((sub, [metas[i] for i in sub],
                            self._forward_packed(x)))
        return self._download_post(pending, len(crops))
