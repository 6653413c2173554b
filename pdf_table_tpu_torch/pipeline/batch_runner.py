"""The batched page pipeline (counterpart of
pdf_table_tpu/pipeline/batch_runner.py): page canvases and
``BatchPipeline.run`` over raster pages on one card.

Pages are padded with white into the smallest fitting canvas bucket, and
each bucket has one detector input size (limit-side rule, multiples of
32), so a chunk of pages is one fixed-shape device program.

``BatchPipeline.run`` packs the pages into chunks of ``batch_pages`` of one
bucket and uploads each chunk's canvas stack once; it stays resident. Every
chunk's layout and detection programs are enqueued from it before the first
download blocks. Then, chunk by chunk: the layout finish, the table regions
and the TSR model over crops cut from the resident stack (the table
regions as the layout gives them, for every model: like the JAX runner,
this one does not widen them for LineCell); the detection finish and
recognition (with the 0/180 classifier when ``use_textline_cls``) over text
crops cut from it; then each page's text cells, table HTML and page HTML.
One CUDA stream, no host threads. A failure is contained to its page (HTML
assembly) or its chunk (the lanes): those pages get an error output, the
rest of the batch goes on; nothing is re-run elsewhere.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..entity.enums import HtmlContentType
from ..entity.ocr_cell import OcrCell
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


def pack_pages(images: Sequence[np.ndarray]
               ) -> Dict[Tuple[int, int], Dict]:
    """Group uint8 HWC pages by canvas bucket, padded with white:
    {bucket: {"indices": [...], "images": (n, H, W, 3) uint8, "shapes":
    [(h, w), ...]}}. A page larger than the largest bucket raises: the JAX
    package scales it down with cv2 first, which the port does not carry
    yet."""
    groups: Dict[Tuple[int, int], Dict] = {}
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        b = pick_page_bucket(h, w)
        if h > b[0] or w > b[1]:
            raise ValueError(
                f"page {i} ({h}x{w}) exceeds the largest canvas bucket {b}; "
                f"scale it to fit first")
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


def raster_image(page: Dict[str, Any]) -> np.ndarray:
    """The page's uint8 RGB image, for the raster pages this runner takes.
    A digital page (one carrying a ``pdf_page``) and a page larger than the
    largest canvas bucket raise, naming the ROADMAP item that brings
    them."""
    if page.get("pdf_page") is not None:
        raise NotImplementedError(
            "digital PDF pages are not ported yet (ROADMAP.md Queue 1 "
            "item 9)")
    img = page.get("image")
    if img is None:
        raise ValueError("the page carries no image")
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"page images are (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    b = pick_page_bucket(h, w)
    if h > b[0] or w > b[1]:
        raise NotImplementedError(
            f"the page ({h}x{w}) exceeds the largest canvas bucket {b}; its "
            f"rescale needs a resize without cv2 (ROADMAP.md Queue 1 item 6)")
    return img


class BatchPipeline:
    """Raster pages -> ``OcrSystemModelOutput`` per page, on one card
    (``device``: ``cuda`` unless ``"cpu"`` is asked for). The tasks are
    ``self.system``'s; ``system._det/_layout/_rec/_tsr/_line_cls`` may be
    assigned, and ``_boxes_finish`` overridden (bench.py injects its line
    grid there). ``last_stats`` holds the last run's seconds per lane."""

    def __init__(self, config: Optional[OcrSystemConfig] = None,
                 batch_pages: int = 8, device=None):
        self.system = OcrSystemTask(config or OcrSystemConfig(),
                                    device=device)
        self.batch_pages = batch_pages
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
        """Upload the chunk once, enqueue layout then det + CC from the
        resident stack: (canvases, layout handle or None, (packed boxes,
        prob size))."""
        canv = self._upload_chunk(chunk["images"])
        layout = self.system.layout_task
        lh = layout.enqueue(canv) if layout is not None else None
        det = self.system.det_task.enqueue(canv, chunk["shapes"],
                                           chunk["bucket"])
        return canv, lh, det

    def _layout_regions_for_chunk(self, page_shapes, layout_handle):
        """Block on the layout download, build the layout cells and the
        table regions: (cells per page, table results per page, regions,
        owners) for :meth:`_tsr_from_regions`."""
        n = len(page_shapes)
        if layout_handle is None:
            cells_per_page = [[] for _ in range(n)]
        else:
            cells_per_page = self.system.layout_task.finish(*layout_handle)
        table_results: List[List] = [[] for _ in range(n)]
        tsr = self.system.tsr_task if self.system.config.use_table else None
        if tsr is None:
            return cells_per_page, table_results, [], []
        regions, owners = [], []
        for pi, ((ph, pw), cells) in enumerate(zip(page_shapes,
                                                   cells_per_page)):
            kept = {tuple(b) for b in filter_figure_tables(
                cells, [c.bbox for c in cells
                        if c.cell_type == HtmlContentType.TABLE])}
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
                     quads, texts, scores, layout_cells,
                     table_results) -> OcrSystemModelOutput:
        out = OcrSystemModelOutput(page=page.get("page", i), is_pdf=False)
        out.image = image
        out.image_shape = image.shape[:2]
        out.text_cells = [OcrCell.from_poly(q, text=t, score=s)
                          for q, t, s in zip(quads, texts, scores)]
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

    # -- run --------------------------------------------------------------------

    def run(self, pages: Sequence[Dict[str, Any]]
            ) -> List[OcrSystemModelOutput]:
        """``pages``: [{'image': (H, W, 3) uint8 RGB, 'page': n}]. Returns
        one output per page, in order. ``last_stats`` gets the seconds of
        each lane on the host clock (cumulative over chunks; a lane's time
        includes its wait for the device) and the total."""
        t_start = time.perf_counter()
        stats = {k: 0.0 for k in (
            "h2d_enqueue", "layout_lane", "tsr_lane", "det_wait_d2h",
            "det_host_post", "rec_lane", "html")}
        results: List[Optional[OcrSystemModelOutput]] = [None] * len(pages)
        images: Dict[int, np.ndarray] = {}
        for i, p in enumerate(pages):
            try:
                images[i] = raster_image(p)
            except Exception as e:
                results[i] = _error_output(p.get("page", i), e,
                                           is_pdf=p.get("pdf_page")
                                           is not None)
        raster = sorted(images)

        def timed(key, fn, *args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                stats[key] += time.perf_counter() - t

        # every chunk's upload and programs go into the queue before the
        # first download blocks
        pending = []
        for chunk in self._chunks([images[i] for i in raster]):
            try:
                pending.append((chunk, timed("h2d_enqueue",
                                             self._enqueue_chunk, chunk),
                                None))
            except Exception as e:
                logger.exception("chunk upload/enqueue failed")
                pending.append((chunk, None, e))
        for chunk, handles, err in pending:
            idx = [raster[gi] for gi in chunk["indices"]]
            if err is None:
                try:
                    canv, lh, (packed, prob_hw) = handles
                    prep = timed("layout_lane",
                                 self._layout_regions_for_chunk,
                                 chunk["shapes"], lh)
                    layout_cells, table_results = timed(
                        "tsr_lane", self._tsr_from_regions, canv, prep)
                    arr = timed("det_wait_d2h", lambda: packed.cpu().numpy())
                    quads = timed("det_host_post", self._boxes_finish, arr,
                                  chunk["shapes"], chunk["bucket"], prob_hw)
                    texts, scores = timed("rec_lane", self._recognize_chunk,
                                          canv, quads)
                except Exception as e:
                    logger.exception("chunk failed")
                    err = e
            if err is not None:
                for i in idx:
                    results[i] = _error_output(pages[i].get("page", i), err)
                continue
            t0 = time.perf_counter()
            for k, i in enumerate(idx):
                try:
                    results[i] = self._page_output(
                        pages[i], i, images[i], quads[k], texts[k],
                        scores[k], layout_cells[k], table_results[k])
                except Exception as e:
                    logger.exception("page %s HTML assembly failed", i)
                    results[i] = _error_output(pages[i].get("page", i), e)
            stats["html"] += time.perf_counter() - t0
        stats["total"] = time.perf_counter() - t_start
        stats["n_pages"] = float(len(pages))
        self.last_stats = stats
        return [r for r in results if r is not None]
