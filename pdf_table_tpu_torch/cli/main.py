"""The ``pdftable`` CLI (counterpart of pdf_table_tpu/cli/main.py): a PDF
or an image -> per-page HTML -> one merged HTML file and a metrics JSON.

    python -m pdf_table_tpu_torch.cli.main --file_path_or_url doc.pdf \\
        --output_dir out [--pages 1,3-end] [--batch_pages 8] [--debug]

The flags are JAX's (``entity/args.py``). A PDF's pages go one by one
through the per-page system (``OcrSystemTask.__call__``), a page's failure
contained to its page; with ``--batch_pages`` above 1 they go through
``BatchPipeline.run`` in chunks of that many pages; an image goes
through the per-page system, read without OpenCV (``utils/image_io.py``).
``--debug`` writes each page's annotated overlay as PNG;
``--profile_dir`` writes a ``torch.profiler`` trace of the run
(``utils/profiling.py``). The models run on ``cuda`` unless ``main`` or
:class:`PdfTableCli` is given ``device="cpu"``; ``--device_mesh`` is
declared and read by nothing, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import fields as dc_fields
from typing import Any, Dict, List, Optional

from ..entity.args import PdfTableCliArguments
from ..pipeline.system import OcrSystemConfig, OcrSystemTask
from ..utils.constants import Constants
from ..utils.logging_utils import logger

PAGE_SEP = "@" * 48  # the reference's merge separator

# the CLI's model names to the registry's
DET_ALIASES = {"PP-OCRv4": "PP-OCRv4_det", "PP-OCRv3": "PP-OCRv4_det",
               "resnet18": "db_resnet18", "resnet50": "db_resnet50",
               "proxylessnas": "db_proxylessnas"}
REC_ALIASES = {"PP-OCRv4": "PP-OCRv4_rec", "PP-OCRv3": "PP-OCRv4_rec",
               "PP-Table": "PP-OCRv4_rec", "ConvNextViT": "ConvNextViT",
               "CRNN": "CRNN", "LightweightEdge": "LightweightEdge"}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pdftable", description="PDF/image table extraction -> HTML")
    for f in dc_fields(PdfTableCliArguments):
        name = "--" + f.name
        help_text = f.metadata.get("help", "")
        if f.type in ("bool", bool) or isinstance(f.default, bool):
            p.add_argument(name, action="store_true", default=f.default,
                           help=help_text)
        elif isinstance(f.default, int) and not isinstance(f.default, bool):
            p.add_argument(name, type=int, default=f.default, help=help_text)
        elif isinstance(f.default, float):
            p.add_argument(name, type=float, default=f.default, help=help_text)
        else:
            p.add_argument(name, type=str, default=f.default, help=help_text)
    return p


def parse_pages(spec: Optional[str], n_pages: int) -> List[int]:
    """'1,3,4', '2-5', '1,4-end', 'all' -> sorted 0-based page indices."""
    if not spec or spec == "all":
        return list(range(n_pages))
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            a, b = part.split("-", 1)
            start = int(a)
            end = n_pages if b in ("end", "") else int(b)
            out.extend(range(start - 1, min(end, n_pages)))
        elif part:
            out.append(int(part) - 1)
    return sorted({i for i in out if 0 <= i < n_pages})


class PdfTableCli:
    def __init__(self, args: PdfTableCliArguments, device=None):
        # ``device_mesh`` is declared and never read, as in the JAX CLI
        self.args = args
        cfg = OcrSystemConfig(
            detect_model=DET_ALIASES.get(args.detect_model or "",
                                         args.detect_model or "PP-OCRv4_det"),
            recognizer_model=REC_ALIASES.get(
                args.recognizer_model or "",
                args.recognizer_model or "PP-OCRv4_rec"),
            layout_model=args.layout_model or "picodet",
            table_structure_model=args.table_structure_model or "Lore",
            lang=args.lang or "en",
            debug=bool(args.debug),
            output_dir=args.output_dir or Constants.OUTPUT_DIR,
        )
        self.system = OcrSystemTask(cfg, device=device)

    @staticmethod
    def resolve_input(src: str, cache_dir: str) -> str:
        """An http(s) input is downloaded to ``cache_dir`` once and the
        local copy reused; a local path passes through."""
        if not src.lower().startswith(("http://", "https://")):
            return src
        import urllib.parse
        import urllib.request

        name = os.path.basename(
            urllib.parse.urlparse(src).path) or "download.pdf"
        local = os.path.join(cache_dir, name)
        if not os.path.exists(local):
            os.makedirs(cache_dir, exist_ok=True)
            tmp = local + ".part"
            urllib.request.urlretrieve(src, tmp)
            os.replace(tmp, local)
            logger.info("downloaded %s -> %s", src, local)
        return local

    def run_extract_pdf_table(self) -> Dict[str, Any]:
        args = self.args
        out_dir = args.output_dir or Constants.OUTPUT_DIR
        os.makedirs(out_dir, exist_ok=True)
        src = self.resolve_input(args.file_path_or_url,
                                 os.path.join(out_dir, "downloads"))

        t_start = time.time()
        page_results = []
        metrics: List[Dict[str, Any]] = []

        if src.lower().endswith(".pdf") and args.batch_pages > 1:
            from ..pdfio.reader import PdfDocument
            from ..pipeline.batch_runner import BatchPipeline

            bp = BatchPipeline(self.system.config,
                               batch_pages=args.batch_pages,
                               device=self.system.device)
            bp.system = self.system
            with PdfDocument.open(src) as doc:
                idxs = parse_pages(args.pages, doc.page_count)
                pages = [{"pdf_page": doc.load_page(i), "pdf_doc": doc,
                          "page": i} for i in idxs]
                for i, r in zip(idxs, bp.run(pages)):
                    page_results.append((i, r.page_html))
                    metrics.append(r.to_metric_dict())
        elif src.lower().endswith(".pdf"):
            from ..pdfio.reader import PdfDocument
            with PdfDocument.open(src) as doc:
                idxs = parse_pages(args.pages, doc.page_count)
                for i in idxs:
                    page = doc.load_page(i)
                    try:
                        r = self.system(pdf_page=page, pdf_doc=doc, page=i,
                                        src_id=os.path.basename(src))
                        page_results.append((i, r.page_html))
                        metrics.append(r.to_metric_dict())
                        self._save_debug(r, out_dir, src, i)
                    except Exception as e:  # page-level containment
                        logger.exception("page %d failed: %s", i, e)
                        metrics.append({"page": i, "error": str(e)})
        else:
            from ..utils.image_io import read_image

            img = read_image(src)
            if img is None:
                raise FileNotFoundError(src)
            r = self.system(image=img, page=0, src_id=os.path.basename(src))
            page_results.append((0, r.page_html))
            metrics.append(r.to_metric_dict())
            self._save_debug(r, out_dir, src, 0)

        merged = self.make_pdf_output_html(page_results)
        base = os.path.splitext(os.path.basename(src))[0]
        html_path = os.path.join(out_dir, f"{base}.html")
        with open(html_path, "w", encoding="utf-8") as f:
            f.write(merged)
        metric_path = os.path.join(out_dir, f"{base}_metrics.json")
        with open(metric_path, "w", encoding="utf-8") as f:
            json.dump({"pages": metrics,
                       "total_s": time.time() - t_start}, f, indent=1)
        logger.info("wrote %s (%d pages, %.2fs)", html_path,
                    len(page_results), time.time() - t_start)
        return {"html": html_path, "metrics": metric_path,
                "n_pages": len(page_results)}

    def _save_debug(self, result, out_dir: str, src: str, page: int) -> None:
        """The page's annotated overlay as PNG, in debug mode."""
        render = result.debug.get("render") if result.debug else None
        if render is None:
            return
        from ..utils.image_io import write_png

        base = os.path.splitext(os.path.basename(src))[0]
        write_png(os.path.join(out_dir, f"{base}_page{page + 1}_debug.png"),
                  render)

    def make_pdf_output_html(self, page_results) -> str:
        from ..tasks.to_html import HTML_FOOTER, HTML_HEADER
        sep = self.args.html_page_merge_sep or PAGE_SEP
        bodies = []
        for i, html in page_results:
            bodies.append(f"<!-- page {i + 1} -->\n{html}")
        joined = f"\n<p>{sep}</p>\n".join(bodies)
        return HTML_HEADER + joined + "\n" + HTML_FOOTER


def main(argv: Optional[List[str]] = None, device=None) -> int:
    parser = build_arg_parser()
    ns = parser.parse_args(argv)
    args = PdfTableCliArguments(**vars(ns))
    if not args.file_path_or_url:
        parser.error("--file_path_or_url is required")
    cli = PdfTableCli(args, device=device)
    from ..utils.profiling import device_trace
    with device_trace(args.profile_dir):
        result = cli.run_extract_pdf_table()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
