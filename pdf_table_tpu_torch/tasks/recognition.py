"""Text-recognition task (counterpart of pdf_table_tpu/tasks/recognition.py
and of the fused device recognition lane of
pdf_table_tpu/pipeline/batch_runner.py::BatchPipeline,
``_recognize_all_device``): ``PP-OCRv4_rec`` (SVTR-LCNet, 48 px),
``CRNN`` and ``LightweightEdge`` (32 px, the same lane), and
``ConvNextViT`` (32 px: every crop warped to the full 804 px width, cut
into three 300 px chunks that overlap by 48 px, their logits joined along
time before the decode). ConvNextViT scales its input by ``1 / 255``, the
others by ``x / 127.5 - 1``. The ModelScope recognizers decode with the
built-in ``en`` charset, as the JAX config's default does.

``batch_infer_from_pages`` takes the uint8 page canvases of one chunk
(numpy, or a tensor already on the device) and the text quads of every
page. The host works out each crop's geometry with vectorized numpy; the
device cuts every crop out of the resident pages at the model's height
(both orientations when the 0/180 classifier is on), cuts the classifier's
input at its own tight geometry, classifies, picks the rotated crop where
the 180 class wins with more than ``FLIP_THRESH``, normalizes, runs the
recognizer and the CTC greedy decode. One packed int32 array
``[ids | keep | round(conf * 1e6)]`` per group comes back, and the host
maps ids to characters.

``__call__(crops)`` is the per-crop path of the JAX task: natural-size
uint8 crops resized on the host by width bucket
(``models/rec_ctc/processor.py``), each group uploaded as uint8 and
normalized on the device, the recognizer, and the CTC greedy decode on the
device (ConvNextViT's three chunks joined along time first); texts and
scores in crop order.

Crops are grouped by (width bucket, axis-aligned or not). Axis-aligned
quads take the row-gather + matmul sampler, rotated ones the homography
sampler. With ``single_rec_bucket`` (the default, as in the JAX pipeline)
every crop goes to the widest bucket; its own width masks the padding.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..engine.buckets import bucket_batch_size
from ..engine.device import (on_device, resolve_device, set_float_precision,
                             with_default_dtype)
from ..engine.params import has_saved_params, init_rec, load_or_init
from ..models.rec_ctc.charset import Charset, resolve_charset
from ..models.rec_ctc.config import RecConfig
from ..models.rec_ctc.model import CTCRecModel
from ..models.registry import build_config, weights_dir
from ..models.rec_ctc.processor import RecPostProcessor, RecPreProcessor
from ..ops.ctc import ctc_greedy_decode
from ..ops.warp import (homographies_from_quads_batch,
                        order_points_clockwise_batch, quads_axis_aligned,
                        resample_axis_aligned_crops, warp_crops_from_pages)
from .cls_pulc import ClsImagePulcTask

# the rotated crop replaces the forward one where P(180_degree) exceeds this
FLIP_THRESH = 0.75
# geometry of a padding slot: a 1 px box / the identity homography
PAD_BOX = np.asarray([[0.0, 0.0, 1.0, 1.0]], np.float32)
PAD_MAT = np.eye(3, dtype=np.float32)[None]

Group = Dict[str, Any]



def rec_config(lang: str = "en", model: str = "PP-OCRv4_rec",
               **kw) -> RecConfig:
    """The config of a registered recognizer name (models/registry.py).
    ``PP-OCRv4_rec`` is lang-keyed: the charset comes from the lang's dict
    file and the vocab size follows it; the ModelScope recognizers ignore
    ``lang``."""
    return build_config("recognition", model, lang=lang, **kw)


def unpack_rec(packed: np.ndarray, real_n: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[ids | keep | conf * 1e6] int32 -> (ids, keep, conf) of the first
    ``real_n`` rows."""
    arr = np.asarray(packed)[:real_n]
    T = (arr.shape[1] - 1) // 2
    return (arr[:, :T], arr[:, T:2 * T].astype(bool),
            arr[:, -1].astype(np.float32) / 1e6)


class OcrRecognitionTask:
    """Text recognition on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for), ``model`` a recognizer of models/registry.py. Weights:
    ``variables`` (a flax-layout tree, see convert/flax_bridge.py) or, when
    None, the converted tree in the lang-keyed ``weights_dir`` or else the
    seeded :func:`init_rec` (engine/params.py::load_or_init). ``charset``
    or, when None, the lang's dict file, searched first in that directory
    (the converter copies the checkpoint's dict there); with a converted
    tree to load, a dict that cannot be found raises, since the fallback's
    ids would not match the checkpoint's. ``cls_task`` is the 0/180 textline
    classifier (a :class:`ClsImagePulcTask` on the same device) or None for
    no orientation check. ``cfg_overrides`` go to :func:`rec_config`, with
    the device's default dtype (engine/device.py::default_dtype) where
    they name none."""

    task_name = "recognition"

    def __init__(self, model: str = "PP-OCRv4_rec", device=None,
                 variables: Optional[Dict[str, Any]] = None,
                 cls_task: Optional[ClsImagePulcTask] = None,
                 charset: Optional[Charset] = None,
                 single_rec_bucket: bool = True, **cfg_overrides):
        self.model_name = model
        self.device = resolve_device(device)
        self.model_config = cfg = rec_config(
            model=model, **with_default_dtype(cfg_overrides, self.device))
        self.convnext = cfg.backbone == "convnext_vit"
        set_float_precision()
        if cls_task is not None and cls_task.device != self.device:
            raise ValueError(f"the classifier runs on {cls_task.device}, "
                             f"the recognizer on {self.device}")
        self.cls_task = cls_task
        self.single_rec_bucket = single_rec_bucket
        self.pre = RecPreProcessor(cfg)
        wdir = self._weights_dir()
        if charset is None:
            charset = self._resolve_charset(
                converted=variables is None and has_saved_params(wdir))
        self.post = RecPostProcessor(cfg, charset=charset)
        self.model = CTCRecModel(cfg).eval()
        if variables is None:
            variables = load_or_init(wdir, lambda: init_rec(cfg, 0),
                                     self.task_name)
        self.load_variables(variables)
        self.model.to(self.device)

    def _weights_dir(self) -> str:
        """The lang-keyed weights directory, as JAX's (PP-OCRv4_rec_ch
        etc.; ``en`` and a dict-file path key none)."""
        cfg = self.model_config
        lang = "" if cfg.charset_name in ("en", "") \
            or os.path.sep in str(cfg.charset_name) else cfg.charset_name
        return weights_dir("recognition", self.model_name, lang)

    def _resolve_charset(self, converted: bool) -> Charset:
        """The decode's charset, as JAX's task resolves it: the weights
        directory is searched first for the lang's dict file. With a
        converted tree to load (``converted``) the search is strict, and a
        generic-fallback charset is an error: its ids do not match the
        checkpoint's, and every decode would be silently wrong."""
        cfg = self.model_config
        wdir = self._weights_dir()
        cs = resolve_charset(cfg.charset_name, cfg.use_space_char,
                             extra_dirs=(wdir,), strict=converted)
        if converted and getattr(cs, "generic_fallback", False):
            raise RuntimeError(
                f"converted weights at {wdir!r} but charset "
                f"{cfg.charset_name!r} resolved to the generic fallback: "
                f"ship the checkpoint's dict file next to the weights")
        return cs

    @property
    def charset(self) -> Charset:
        return self.post.charset

    def load_variables(self, variables: Dict[str, Any]) -> None:
        """Load a flax-layout {"params", "batch_stats"} tree."""
        from ..convert.flax_bridge import load_flax_variables

        load_flax_variables(self.model, variables)

    # -- host geometry --------------------------------------------------------

    def plan(self, quads_per_page: Sequence[Any]) -> List[Group]:
        """Per-crop geometry, vectorized: quads ordered [tl, tr, br, bl],
        each crop's width at the model's height, its width bucket, its
        bounding box (axis-aligned quads) or its homographies (the others:
        one onto the crop's own width, one onto the classifier's canvas).
        Returns the groups in (bucket, axis-aligned) order, each padded to
        its batch bucket: ``idxs`` (flat crop indices, pages in order),
        ``n``, ``bucket``, ``aa``, ``mats``, ``cmats``, ``pidx``,
        ``widths``."""
        cfg = self.model_config
        all_quads = [np.asarray(q, np.float32).reshape(-1, 4, 2)
                     for q in quads_per_page]
        pidx_all = np.concatenate(
            [np.full(len(q), pi, np.int32)
             for pi, q in enumerate(all_quads)] or [np.zeros(0, np.int32)])
        if not len(pidx_all):
            return []
        qs = order_points_clockwise_batch(np.concatenate(all_quads))
        ones = np.ones(len(qs), np.float32)
        ww = np.maximum.reduce([
            np.linalg.norm(qs[:, 0] - qs[:, 1], axis=1),
            np.linalg.norm(qs[:, 3] - qs[:, 2], axis=1), ones])
        hh = np.maximum.reduce([
            np.linalg.norm(qs[:, 0] - qs[:, 3], axis=1),
            np.linalg.norm(qs[:, 1] - qs[:, 2], axis=1), ones])
        if self.convnext:
            # warped to the full width, cut into the chunks on the device
            buckets = np.full(len(qs), 3 * cfg.chunk_width
                              - 2 * cfg.chunk_overlap, np.int32)
        elif self.single_rec_bucket:
            buckets = np.full(len(qs), cfg.width_buckets[-1], np.int32)
        else:
            buckets = np.asarray(
                [self.pre.pick_bucket(int(round(w)), int(round(h)))
                 for w, h in zip(ww, hh)], np.int32)
        nws = np.clip(np.round(ww * cfg.img_height / hh), 1,
                      buckets).astype(np.int32)
        aa_mask = quads_axis_aligned(qs)
        boxes_all = np.stack([qs[:, :, 0].min(1), qs[:, :, 1].min(1),
                              qs[:, :, 0].max(1), qs[:, :, 1].max(1)],
                             1).astype(np.float32)
        mats_all = cmats_all = None
        if not aa_mask.all():
            mats_all = homographies_from_quads_batch(qs, nws, cfg.img_height)
            if self.cls_task is not None:
                ch, cw = self.cls_task.model_config.img_size
                cmats_all = homographies_from_quads_batch(qs, float(cw),
                                                          float(ch))
        members: Dict[Tuple[int, bool], List[int]] = {}
        for ci in range(len(qs)):
            members.setdefault((int(buckets[ci]), bool(aa_mask[ci])),
                               []).append(ci)
        groups = []
        for (b, aa), idxs in sorted(members.items()):
            n = len(idxs)
            pad = bucket_batch_size(n) - n
            sel = np.asarray(idxs)
            if aa:
                mats = cmats = np.concatenate(
                    [boxes_all[sel], np.tile(PAD_BOX, (pad, 1))])
            else:
                eye = np.tile(PAD_MAT, (pad, 1, 1))
                mats = cmats = np.concatenate([mats_all[sel], eye])
                if cmats_all is not None:
                    cmats = np.concatenate([cmats_all[sel], eye])
            groups.append({
                "idxs": sel, "n": n, "bucket": b, "aa": aa,
                "mats": mats, "cmats": cmats,
                "pidx": np.concatenate([pidx_all[sel],
                                        np.zeros(pad, np.int32)]),
                "widths": np.concatenate([nws[sel],
                                          np.ones(pad, np.int32)])})
        return groups

    # -- the device program, stage by stage -----------------------------------

    def upload(self, g: Group) -> Dict[str, torch.Tensor]:
        """A group's geometry on the device."""
        dev = self.device
        return {k: torch.from_numpy(g[k]).to(dev)
                for k in ("mats", "cmats", "pidx", "widths")}

    def cut(self, pages: torch.Tensor, g: Group, t: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                       Optional[torch.Tensor]]:
        """(crops, rotated crops, classifier input) of one group, cut from
        ``pages`` (P, H, W, 3) uint8 on the device: crops (nb, height,
        bucket, 3) f32 in 0..255, zero right of each crop's width; the
        other two are None without a classifier."""
        oh = self.model_config.img_height
        out_hw = (oh, g["bucket"])
        use_cls = self.cls_task is not None
        widths = t["widths"]
        flipped = cls_in = None
        if g["aa"]:
            crops = resample_axis_aligned_crops(
                pages, t["pidx"], t["mats"], out_hw,
                dst_w=widths.float(), valid_w=widths, also_flipped=use_cls)
            if use_cls:
                crops, flipped = crops
        else:
            crops = warp_crops_from_pages(pages, t["pidx"], t["mats"],
                                          widths, out_hw)
        if not use_cls:
            return crops, None, None
        if flipped is None:
            # the crop rotated by 180 degrees is the warped crop reversed on
            # both axes, which puts its content at [bucket - w, bucket):
            # shift it back to the left edge
            b = g["bucket"]
            jj = torch.arange(b, device=crops.device)[None, :]
            src = (jj + (b - widths)[:, None]).clamp(0, b - 1)
            flipped = torch.take_along_dim(
                crops.flip(1, 2), src[:, None, :, None].long(), dim=2)
            flipped = torch.where(
                (jj < widths[:, None])[:, None, :, None], flipped,
                torch.zeros_like(flipped))
        # the classifier's input: the quad stretched over its whole canvas
        ch, cw = self.cls_task.model_config.img_size
        if g["aa"]:
            cls_in = resample_axis_aligned_crops(pages, t["pidx"],
                                                 t["cmats"], (ch, cw))
        else:
            cls_in = warp_crops_from_pages(
                pages, t["pidx"], t["cmats"],
                torch.full_like(widths, cw), (ch, cw))
        return crops, flipped, cls_in

    def orient(self, crops: torch.Tensor, flipped: torch.Tensor,
               cls_in: torch.Tensor) -> torch.Tensor:
        """The rotated crop where the classifier's ``180_degree`` class
        (label 1) exceeds ``FLIP_THRESH``."""
        flip = self.cls_task.probs(cls_in)[:, 1] > FLIP_THRESH
        return torch.where(flip[:, None, None, None], flipped, crops)

    def logits(self, crops: torch.Tensor) -> torch.Tensor:
        """Crops in 0..255 -> CTC logits (nb, T, V): ``x / 127.5 - 1``,
        then the recognizer; ConvNextViT: the crops' luma cut into three
        overlapping chunks, each ``/ 255`` through the recognizer, their
        logits joined along time (nb, 3 T, V)."""
        if not self.convnext:
            return self.model(crops / 127.5 - 1.0)
        cfg = self.model_config
        cw, step = cfg.chunk_width, cfg.chunk_width - cfg.chunk_overlap
        y = 0.299 * crops[..., 0] + 0.587 * crops[..., 1] \
            + 0.114 * crops[..., 2]
        chunks = torch.stack([y[:, :, s:s + cw]
                              for s in (0, step, 2 * step)], dim=1)
        logits = self.model(chunks.reshape(-1, y.shape[1], cw)[..., None]
                            / 255.0)
        return logits.reshape(crops.shape[0], -1, logits.shape[-1])

    def pack(self, logits: torch.Tensor) -> torch.Tensor:
        """CTC greedy decode, packed ``[ids | keep | round(conf * 1e6)]``
        int32 (nb, 2T + 1)."""
        ids, keep, conf = ctc_greedy_decode(
            logits, blank_id=self.model_config.blank_id)
        return torch.cat([ids.int(), keep.int(),
                          torch.round(conf * 1e6).int()[:, None]], dim=1)

    @torch.inference_mode()
    def enqueue(self, pages: torch.Tensor, g: Group) -> torch.Tensor:
        """One group's device program; returns the (not yet downloaded)
        packed decode."""
        crops, flipped, cls_in = self.cut(pages, g, self.upload(g))
        if cls_in is not None:
            crops = self.orient(crops, flipped, cls_in)
        return self.pack(self.logits(crops))

    # -- host side ------------------------------------------------------------

    def finish(self, quads_per_page: Sequence[Any], groups: List[Group],
               packed: List[np.ndarray]
               ) -> Tuple[List[List[str]], List[List[float]]]:
        """Downloaded packed decodes -> (texts, scores) per page."""
        counts = [len(np.asarray(q, np.float32).reshape(-1, 4, 2))
                  for q in quads_per_page]
        n_total = sum(counts)
        flat_t: List[str] = [""] * n_total
        flat_s: List[float] = [0.0] * n_total
        for g, arr in zip(groups, packed):
            self.post(unpack_rec(arr, g["n"]), g["idxs"], flat_t, flat_s)
        texts, scores, off = [], [], 0
        for n in counts:
            texts.append(flat_t[off:off + n])
            scores.append(flat_s[off:off + n])
            off += n
        return texts, scores

    def batch_infer_from_pages(self,
                               canvases_u8: Union[np.ndarray, torch.Tensor],
                               quads_per_page: Sequence[Any]
                               ) -> Tuple[List[List[str]],
                                          List[List[float]]]:
        """``canvases_u8`` (P, H, W, 3) uint8 RGB: the numpy canvas stack
        of one chunk, or a tensor already on the task's device;
        ``quads_per_page``: per page an (n, 4, 2) array of text quads in
        page coordinates. Returns (texts, scores): per page one string
        and one confidence per quad, in the quads' order."""
        pages = torch.as_tensor(canvases_u8)
        if pages.dim() != 4 or pages.dtype != torch.uint8:
            raise ValueError(f"canvases are (P, H, W, 3) uint8, got "
                             f"{tuple(pages.shape)} {pages.dtype}")
        if len(quads_per_page) != pages.shape[0]:
            raise ValueError(f"{len(quads_per_page)} quad lists for "
                             f"{pages.shape[0]} pages")
        groups = self.plan(quads_per_page)
        pages = on_device(pages, self.device)
        # every group is enqueued before the first download blocks
        pending = [self.enqueue(pages, g) for g in groups]
        packed = [p.cpu().numpy() for p in pending]
        return self.finish(quads_per_page, groups, packed)

    # -- the per-crop path ----------------------------------------------------

    @torch.inference_mode()
    def _group_decode(self, group: Dict[str, Any]) -> torch.Tensor:
        """One width group's uint8 images -> the packed decode of its real
        rows (ConvNextViT: the chunks' logits joined along time)."""
        imgs = group["images"]
        n = imgs.shape[0]
        pad = bucket_batch_size(n) - n
        if pad:
            imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:],
                                                  np.uint8)])
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device) \
            .float()
        x = x / 255.0 if self.convnext else x / 127.5 - 1.0
        logits = self.model(x)[:n]
        chunks = group.get("chunked")
        if chunks:
            logits = logits.reshape(n // chunks, chunks * logits.shape[1],
                                    logits.shape[2])
        return self.pack(logits)

    def __call__(self, crops: Sequence[np.ndarray]) -> Dict[str, List]:
        """(H, W, 3) uint8 RGB crops -> {"texts", "scores"} in crop
        order."""
        pre = self.pre([np.asarray(c) for c in crops])
        n = pre["n"]
        texts: List[str] = [""] * n
        scores: List[float] = [0.0] * n
        # every group is enqueued before the first download blocks
        pending = [(g, self._group_decode(g)) for g in pre["groups"]]
        for g, packed in pending:
            self.post(unpack_rec(packed.cpu().numpy(), len(g["indices"])),
                      g["indices"], texts, scores)
        return {"texts": texts, "scores": scores}
