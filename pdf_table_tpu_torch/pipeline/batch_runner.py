"""The batched page pipeline (counterpart of
pdf_table_tpu/pipeline/batch_runner.py): page canvases and
``BatchPipeline.run`` over raster and digital PDF pages on one card.

Pages are padded with white into the smallest fitting canvas bucket, and
each bucket has one detector input size (limit-side rule, multiples of
32), so a chunk of pages is one fixed-shape device program. A page larger
than the largest bucket is first scaled to fit, on the host, with
OpenCV's INTER_LINEAR arithmetic (``ops/crop_resize.py::resize_u8_plain``),
as the JAX runner does with ``cv2.resize``: its output's image, shape and
``pdf_scale`` are those of the scaled page.

A page is its ``image`` or, for a page that carries a ``pdf_page`` and no
image, the page rendered by ``pdfio.render_page`` (``render_dpi``). A page
whose ``pdf_page`` has text is digital: its text cells come from the PDF's
vector text (``tasks/pdf_text.py``), its tables from the vector lines on
the host (LineCellPdf, ``_digital_tables``), never from the TSR model; its
canvas still joins the chunks of the raster pages, so that detection and
layout run over it on the card, and its detected quads are dropped before
recognition. A digital page authored rotated by 90 degrees runs the
serial per-page system (``OcrSystemTask.__call__``), its failure contained
to its page.

``BatchPipeline.run`` packs the pages into chunks of ``batch_pages`` of one
bucket and uploads each chunk's canvas stack once; it stays resident. Every
chunk's layout and detection programs are enqueued from it before the first
download blocks. Then, chunk by chunk: the layout finish, the table regions
and the TSR model over crops cut from the resident stack (the table
regions as the layout gives them, for every model: like the JAX runner,
this one does not widen them for LineCell); the detection finish and
recognition (with the 0/180 classifier when ``use_textline_cls``) over text
crops cut from it; then each page's text cells, table HTML and page HTML.
One CUDA stream, no host threads.

Two lanes of the JAX runner are options here too. ``device_boxes=False``
downloads the chunk's uint8 prob maps and finishes them on the host
(``_det_post``: the connected components, or with ``fast_post=False`` the
contours, ``models/dbnet/processor.py``). ``device_crops=False`` (or None
with the 0/180 classifier off) cuts natural-size crops from the page
images on the host (``ops/warp.py::crop_rotated_boxes``), classifies them
in one pooled forward, flips those that read 180 degrees and recognizes
them with the recognizer's per-crop ``__call__`` (``_recognize_all``).
``half_res_probs`` max-pools the prob maps 2x2 before they are quantized
(it is set on the system's detection task).

A failure is contained to its page
(rendering, vector text, HTML assembly) or its chunk (the lanes): those
pages get an error output, the rest of the batch goes on; nothing is re-run
elsewhere.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..entity.enums import HtmlContentType
from ..entity.ocr_cell import OcrCell
from ..ops.crop_resize import resize_u8_plain
from ..tasks.pdf_text import check_pdf_text_need_rotate90
from .output import OcrSystemModelOutput
from .system import OcrSystemConfig, OcrSystemTask, filter_figure_tables

logger = logging.getLogger(__name__)

# page canvas buckets (H, W): most A4-ish rasters at 144 dpi land in the
# first two
PAGE_BUCKETS = ((1280, 960), (1600, 1280), (2048, 1536))


def pick_page_bucket(h: int, w: int) -> Tuple[int, int]:
    for bh, bw in PAGE_BUCKETS:
        if h <= bh and w <= bw:
            return (bh, bw)
    return PAGE_BUCKETS[-1]


def det_input_size(bucket: Tuple[int, int], limit_side_len: int
                   ) -> Tuple[int, int]:
    """Detector input size for a canvas bucket (limit-side rule, /32)."""
    H, W = bucket
    ratio = min(limit_side_len / max(H, W), 1.0) \
        if max(H, W) > limit_side_len else 1.0
    nh = max(int(round(H * ratio / 32) * 32), 32)
    nw = max(int(round(W * ratio / 32) * 32), 32)
    return nh, nw


def fit_page(img: np.ndarray) -> np.ndarray:
    """A page larger than the largest canvas bucket scaled to fit, as the
    JAX runner scales it (``cv2.resize`` INTER_LINEAR to ``max(1, int(w *
    s))`` x ``max(1, int(h * s))``); any other page as it is."""
    h, w = img.shape[:2]
    b = pick_page_bucket(h, w)
    if h <= b[0] and w <= b[1]:
        return img
    s = min(b[0] / h, b[1] / w)
    nh, nw = max(1, int(h * s)), max(1, int(w * s))
    logger.warning("page (%dx%d) exceeds the largest canvas bucket %s: "
                   "scaling to %dx%d", h, w, b, nh, nw)
    return resize_u8_plain(img, nh, nw)


def pack_pages(images: Sequence[np.ndarray]
               ) -> Dict[Tuple[int, int], Dict]:
    """Group uint8 HWC pages by canvas bucket, padded with white:
    {bucket: {"indices": [...], "images": (n, H, W, 3) uint8, "shapes":
    [(h, w), ...]}}. A page larger than the largest bucket is scaled to fit
    first (:func:`fit_page`)."""
    groups: Dict[Tuple[int, int], Dict] = {}
    for i, img in enumerate(images):
        img = fit_page(img)
        h, w = img.shape[:2]
        b = pick_page_bucket(h, w)
        g = groups.setdefault(b, {"indices": [], "images": [], "shapes": []})
        canvas = np.full((b[0], b[1], 3), 255, np.uint8)
        canvas[:h, :w] = img
        g["indices"].append(i)
        g["images"].append(canvas)
        g["shapes"].append((h, w))
    for g in groups.values():
        g["images"] = np.stack(g["images"])
    return groups


def _error_output(page: int, exc: Exception,
                  is_pdf: bool = False) -> OcrSystemModelOutput:
    """Failed-page placeholder: the error rides the metric dict."""
    out = OcrSystemModelOutput(page=page, is_pdf=is_pdf)
    out.metric = {"error": f"{type(exc).__name__}: {exc}"}
    return out


def page_image(page: Dict[str, Any], dpi: int = 144) -> np.ndarray:
    """The page's uint8 RGB image: its ``image``, else its ``pdf_page``
    rendered at ``dpi`` (``pdfio.render_page``, with its ``pdf_doc``),
    scaled to fit the largest canvas bucket (:func:`fit_page`)."""
    img = page.get("image")
    if img is None:
        if page.get("pdf_page") is None:
            raise ValueError("the page carries neither an image nor a "
                             "pdf_page")
        from ..pdfio.render import render_page
        img = render_page(page.get("pdf_doc"), page["pdf_page"], dpi=dpi)
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"page images are (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    return fit_page(img)


class BatchPipeline:
    """Raster and digital pages -> ``OcrSystemModelOutput`` per page, on one
    card
    (``device``: ``cuda`` unless ``"cpu"`` is asked for). The tasks are
    ``self.system``'s; ``system._det/_layout/_rec/_tsr/_line_cls`` may be
    assigned, and ``_boxes_finish`` overridden (bench.py injects its line
    grid there). ``last_stats`` holds the last run's seconds per lane.
    ``half_res_probs``, ``device_boxes`` and ``device_crops`` take the JAX
    runner's defaults (module docstring)."""

    def __init__(self, config: Optional[OcrSystemConfig] = None,
                 batch_pages: int = 8, device=None,
                 half_res_probs: bool = True, device_boxes: bool = True,
                 device_crops: Optional[bool] = None):
        self.system = OcrSystemTask(config or OcrSystemConfig(),
                                    device=device)
        self.batch_pages = batch_pages
        self.half_res_probs = half_res_probs
        self.device_boxes = device_boxes
        self.device_crops = device_crops
        self.last_stats: Optional[Dict[str, float]] = None

    @property
    def device(self) -> torch.device:
        return self.system.device

    # -- stages -----------------------------------------------------------------

    def _upload_chunk(self, images_np: np.ndarray) -> torch.Tensor:
        """One chunk's canvas stack on the device: pinned and copied
        asynchronously to a card."""
        t = torch.from_numpy(np.ascontiguousarray(images_np))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _chunks(self, images: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
        """Chunks of up to ``batch_pages`` canvases of one bucket;
        ``indices`` index ``images``."""
        chunks = []
        for bucket, g in pack_pages(images).items():
            n = len(g["indices"])
            for s in range(0, n, self.batch_pages):
                e = min(s + self.batch_pages, n)
                chunks.append({"images": g["images"][s:e],
                               "shapes": g["shapes"][s:e],
                               "indices": g["indices"][s:e],
                               "bucket": bucket})
        return chunks

    def _enqueue_chunk(self, chunk: Dict[str, Any]):
        """Upload the chunk once, enqueue layout then detection from the
        resident stack: (canvases, layout handle or None, (packed boxes or
        uint8 prob maps, prob size))."""
        canv = self._upload_chunk(chunk["images"])
        layout = self.system.layout_task
        lh = layout.enqueue(canv) if layout is not None else None
        det_task = self.system.det_task
        det_task.half_res_probs = self.half_res_probs
        if self.device_boxes:
            det = det_task.enqueue(canv, chunk["shapes"], chunk["bucket"])
        else:
            probs = det_task.enqueue_probs(canv, chunk["bucket"])
            det = (probs, tuple(probs.shape[1:]))
        return canv, lh, det

    def _layout_regions_for_chunk(self, page_shapes, layout_handle,
                                  digital_info: Optional[Dict[int, tuple]]
                                  = None):
        """Block on the layout download, build the layout cells and the
        table regions: (cells per page, table results per page, regions,
        owners) for :meth:`_tsr_from_regions`. ``digital_info`` maps the
        chunk positions of digital pages to (pdf_page, pdf_scale): their
        tables come from the vector lines on the host
        (:meth:`_digital_tables`), not from the TSR model."""
        digital_info = digital_info or {}
        n = len(page_shapes)
        if layout_handle is None:
            cells_per_page = [[] for _ in range(n)]
        else:
            cells_per_page = self.system.layout_task.finish(*layout_handle)
        table_results: List[List] = [[] for _ in range(n)]
        tsr = self.system.tsr_task if self.system.config.use_table else None
        if tsr is None and not digital_info:
            return cells_per_page, table_results, [], []
        regions, owners = [], []
        for pi, ((ph, pw), cells) in enumerate(zip(page_shapes,
                                                   cells_per_page)):
            tbs = filter_figure_tables(
                cells, [c.bbox for c in cells
                        if c.cell_type == HtmlContentType.TABLE])
            if pi in digital_info and self.system.config.use_table:
                pdf_page, pdf_scale = digital_info[pi]
                table_results[pi] = self._digital_tables(pdf_page,
                                                         pdf_scale, tbs)
                continue
            kept = {tuple(b) for b in tbs}
            for c in cells:
                if c.cell_type != HtmlContentType.TABLE \
                        or tuple(c.bbox) not in kept:
                    continue
                x1, y1, x2, y2 = [int(round(v)) for v in c.bbox]
                x1, y1 = max(0, x1), max(0, y1)
                x2, y2 = min(x2, pw), min(y2, ph)
                if x2 - x1 >= 2 and y2 - y1 >= 2:
                    regions.append((pi, (x1, y1, x2, y2)))
                    owners.append((pi, c.bbox, (x1, y1)))
        return cells_per_page, table_results, regions, owners

    @staticmethod
    def _digital_tables(pdf_page, pdf_scale: float, table_bboxes) -> List:
        """Vector-line table cells of one digital page: a result per
        layout table region that holds lines (regions inside an embedded
        image skipped), else one per cluster of the page's own lines."""
        from ..models.line_cell import (detect_table_regions,
                                        extract_cells_from_pdf_page)
        from ..tasks.pdf_text import table_bbox_is_pdf_image

        out: List = []
        if pdf_page.segs is None or not (pdf_page.segs or pdf_page.rects):
            return out
        for tb in table_bboxes or ():
            if table_bbox_is_pdf_image(tb, pdf_page, pdf_scale):
                continue   # a figure detected as a table
            r = extract_cells_from_pdf_page(pdf_page, pdf_scale, bbox=tb)
            if r["cells"]:
                r["offset"] = (0, 0)
                out.append((tb, r))
        if not out:
            # for a digital page the vector lines are ground truth, a
            # layout proposal is not
            for region in detect_table_regions(pdf_page, pdf_scale):
                r = {"cells": region["cells"], "type": "line_cell_pdf",
                     "offset": (0, 0)}
                out.append((region["bbox"], r))
        return out

    def _tsr_from_regions(self, canv: torch.Tensor, prep):
        """The TSR task over the table crops, cut from the resident
        canvases: (layout cells, table results) per page; a table result
        is (bbox, tsr result)."""
        cells_per_page, table_results, regions, owners = prep
        if regions:
            results = self.system.tsr_task.batch_infer_from_pages(canv,
                                                                  regions)
            for (pi, bbox, offset), r in zip(owners, results):
                r["offset"] = offset
                table_results[pi].append((bbox, r))
        return cells_per_page, table_results

    def _boxes_finish(self, packed: np.ndarray, shapes, bucket_hw, prob_hw
                      ) -> List[np.ndarray]:
        """Host finish of the device boxes -> (n, 4, 2) quads per page."""
        return self.system.det_task._boxes_finish(packed, shapes, bucket_hw,
                                                  prob_hw)

    def _det_post(self, probs_u8: np.ndarray, shapes, bucket_hw,
                  fast_post: bool = True) -> List[np.ndarray]:
        """Host finish of downloaded uint8 prob maps: each page's valid
        extent / 255 through the detection post-processor's connected
        components (``fast_post``) or its contours -> (n, 4, 2) quads per
        page."""
        post = self.system.det_task.post
        H, W = bucket_hw
        ph, pw = probs_u8.shape[1], probs_u8.shape[2]
        results = []
        for i, (h, w) in enumerate(shapes):
            vh = int(round(h / H * ph))
            vw = int(round(w / W * pw))
            page_prob = probs_u8[i, :vh, :vw].astype(np.float32) / 255.0
            r = (post.fast_host_boxes if fast_post else post)(page_prob,
                                                              (h, w))
            results.append(r["det_polygons"].reshape(-1, 4, 2))
        return results

    def _recognize_all(self, images: Sequence[np.ndarray],
                       quads_per_page: Sequence[np.ndarray]):
        """Host crops of every page's quads, the pooled 0/180 classifier
        (a crop that reads 180 degrees with a score over 0.75 is flipped in
        place) and the recognizer's per-crop path: (texts, scores) per
        page."""
        from ..ops.warp import crop_rotated_boxes

        crops: List[np.ndarray] = []
        owners: List[Tuple[int, int]] = []
        for pi, (img, quads) in enumerate(zip(images, quads_per_page)):
            if not len(quads):
                continue
            for bi, c in enumerate(crop_rotated_boxes(img,
                                                      np.asarray(quads))):
                crops.append(c)
                owners.append((pi, bi))
        if not crops:
            return [[] for _ in images], [[] for _ in images]
        cls_task = self.system.textline_cls_task
        if cls_task is not None:
            for c, r in zip(crops, cls_task.batch_infer(crops)):
                if r["label"] == "180_degree" and r["score"] > 0.75:
                    c[:] = c[::-1, ::-1]
        out = self.system.rec_task(crops)
        texts = [[""] * len(q) for q in quads_per_page]
        scores = [[0.0] * len(q) for q in quads_per_page]
        for (pi, bi), t, sc in zip(owners, out["texts"], out["scores"]):
            texts[pi][bi] = t
            scores[pi][bi] = sc
        return texts, scores

    def _recognize_chunk(self, canv: torch.Tensor, quads):
        """Recognition over crops cut from the resident canvases, with the
        system's 0/180 classifier when ``use_textline_cls``."""
        rec = self.system.rec_task
        cls_task = self.system.textline_cls_task
        if cls_task is not None and cls_task.device != rec.device:
            raise ValueError(f"the classifier runs on {cls_task.device}, "
                             f"the recognizer on {rec.device}")
        rec.cls_task = cls_task
        return rec.batch_infer_from_pages(canv, quads)

    def _page_output(self, page: Dict[str, Any], i: int, image: np.ndarray,
                     text_cells, layout_cells, table_results,
                     pdf_scale: Optional[float] = None
                     ) -> OcrSystemModelOutput:
        """One page's output; ``pdf_scale`` is given for a digital page."""
        out = OcrSystemModelOutput(page=page.get("page", i),
                                   is_pdf=pdf_scale is not None)
        out.image = image
        out.image_shape = image.shape[:2]
        if pdf_scale is not None:
            out.pdf_page = page["pdf_page"]
            out.pdf_scale = pdf_scale
        out.text_cells = text_cells
        out.layout_cells = layout_cells
        out.table_structures = [r for _, r in table_results]
        table_regions = []
        for tb, r in table_results:
            html = self.system.table_html_task(r, out.text_cells)
            out.table_html.append(html)
            table_regions.append((tb, html))
        out.page_html = self.system.to_html_task(
            out.text_cells, table_regions, page_width=float(image.shape[1]))
        return out

    def _vector_text(self, pages, digital, images, results):
        """The vector text cells and ``pdf_scale`` (image px per PDF unit)
        of each digital page; a failure errors its page only."""
        cells, scales = {}, {}
        for i in digital:
            pg = pages[i]["pdf_page"]
            try:
                scale = images[i].shape[0] / pg.height if pg.height else 1.0
                cells[i] = self.system.pdf_text_task(pg, scale)
                scales[i] = scale
            except Exception as e:
                logger.exception("page %s vector text failed", i)
                results[i] = _error_output(pages[i].get("page", i), e,
                                           is_pdf=True)
        return cells, scales

    # -- run --------------------------------------------------------------------

    def run(self, pages: Sequence[Dict[str, Any]]
            ) -> List[OcrSystemModelOutput]:
        """``pages``: [{'image': (H, W, 3) uint8 RGB, 'page': n}] or
        [{'pdf_page': PdfPage, 'pdf_doc': PdfDocument, 'page': n}] (with or
        without an 'image'). Returns one output per page, in order.
        ``last_stats`` gets the seconds of each lane on the host clock
        (cumulative over chunks; a lane's time includes its wait for the
        device) and the total."""
        t_start = time.perf_counter()
        stats = {k: 0.0 for k in (
            "rasterize", "digital_serial", "pdf_text", "h2d_enqueue",
            "layout_lane", "tsr_lane", "det_wait_d2h", "det_host_post",
            "rec_lane", "html")}
        results: List[Optional[OcrSystemModelOutput]] = [None] * len(pages)
        images: Dict[int, np.ndarray] = {}
        dpi = self.system.config.render_dpi
        t0 = time.perf_counter()
        for i, p in enumerate(pages):
            try:
                images[i] = page_image(p, dpi)
            except Exception as e:
                logger.exception("page %s rasterize failed", i)
                results[i] = _error_output(p.get("page", i), e,
                                           is_pdf=p.get("pdf_page")
                                           is not None)
        stats["rasterize"] = time.perf_counter() - t0

        # a page whose pdf_page has text is digital; one authored rotated
        # runs the serial per-page system
        digital, serial = [], []
        for i in sorted(images):
            pg = pages[i].get("pdf_page")
            if pg is None or not getattr(pg, "texts", None):
                continue
            (serial if check_pdf_text_need_rotate90(pg)
             else digital).append(i)
        t0 = time.perf_counter()
        for i in serial:
            try:
                results[i] = self.system(image=images[i],
                                         pdf_page=pages[i]["pdf_page"],
                                         pdf_doc=pages[i].get("pdf_doc"),
                                         page=pages[i].get("page", i))
            except Exception as e:
                logger.exception("digital page %s failed", i)
                results[i] = _error_output(pages[i].get("page", i), e,
                                           is_pdf=True)
        stats["digital_serial"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pdf_cells, pdf_scales = self._vector_text(pages, digital, images,
                                                  results)
        stats["pdf_text"] = time.perf_counter() - t0
        batched = [i for i in sorted(images) if results[i] is None]

        def timed(key, fn, *args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                stats[key] += time.perf_counter() - t

        # every chunk's upload and programs go into the queue before the
        # first download blocks
        pending = []
        for chunk in self._chunks([images[i] for i in batched]):
            try:
                pending.append((chunk, timed("h2d_enqueue",
                                             self._enqueue_chunk, chunk),
                                None))
            except Exception as e:
                logger.exception("chunk upload/enqueue failed")
                pending.append((chunk, None, e))
        for chunk, handles, err in pending:
            idx = [batched[gi] for gi in chunk["indices"]]
            digital_info = {k: (pages[i]["pdf_page"], pdf_scales[i])
                            for k, i in enumerate(idx) if i in pdf_scales}
            # each lane fails on its own, as JAX's runner contains it: a
            # failed layout/TSR lane drops the chunk's tables, a failed
            # recognition empties its texts, and the page HTML is still
            # built; only a failed detection errors the chunk's pages
            if err is None:
                canv, lh, (packed, prob_hw) = handles
                try:
                    prep = timed("layout_lane",
                                 self._layout_regions_for_chunk,
                                 chunk["shapes"], lh, digital_info)
                    layout_cells, table_results = timed(
                        "tsr_lane", self._tsr_from_regions, canv, prep)
                except Exception:
                    logger.exception("chunk layout/TSR failed - tables "
                                     "dropped for this chunk")
                    layout_cells = [[] for _ in idx]
                    table_results = [[] for _ in idx]
                try:
                    arr = timed("det_wait_d2h", lambda: packed.cpu().numpy())
                    if self.device_boxes:
                        quads = timed("det_host_post", self._boxes_finish,
                                      arr, chunk["shapes"], chunk["bucket"],
                                      prob_hw)
                    else:
                        quads = timed("det_host_post", self._det_post, arr,
                                      chunk["shapes"], chunk["bucket"])
                except Exception as e:
                    logger.exception("chunk detection failed")
                    err = e
            if err is not None:
                for k, i in enumerate(idx):
                    results[i] = _error_output(pages[i].get("page", i), err,
                                               is_pdf=k in digital_info)
                continue
            # digital pages take their vector text: no text crops
            for k in digital_info:
                quads[k] = np.zeros((0, 4, 2), np.float32)
            use_dev = self.device_crops
            if use_dev is None:
                use_dev = self.system.config.use_textline_cls
            try:
                if use_dev:
                    texts, scores = timed("rec_lane", self._recognize_chunk,
                                          canv, quads)
                else:
                    texts, scores = timed(
                        "rec_lane", self._recognize_all,
                        [images[i] for i in idx], quads)
            except Exception:
                logger.exception("chunk recognition failed")
                texts = [[""] * len(q) for q in quads]
                scores = [[0.0] * len(q) for q in quads]
            t0 = time.perf_counter()
            for k, i in enumerate(idx):
                try:
                    if k in digital_info:
                        text_cells = pdf_cells[i]
                    else:
                        text_cells = [OcrCell.from_poly(q, text=t, score=sc)
                                      for q, t, sc in zip(quads[k], texts[k],
                                                          scores[k])]
                    results[i] = self._page_output(
                        pages[i], i, images[i], text_cells, layout_cells[k],
                        table_results[k], pdf_scales.get(i))
                except Exception as e:
                    logger.exception("page %s HTML assembly failed", i)
                    results[i] = _error_output(pages[i].get("page", i), e,
                                               is_pdf=k in digital_info)
            stats["html"] += time.perf_counter() - t0
        stats["total"] = time.perf_counter() - t_start
        stats["n_pages"] = float(len(pages))
        self.last_stats = stats
        return [r for r in results if r is not None]
