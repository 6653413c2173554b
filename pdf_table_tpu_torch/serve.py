"""The HTTP extraction service with dynamic batching (counterpart of
pdf_table_tpu/serve.py), on one card or, data-parallel, on several.

    python -m pdf_table_tpu_torch.serve --port 8400 [--batch_pages 8]
    torchrun --nproc_per_node=N -m pdf_table_tpu_torch.serve --mesh dp=N

* A ``ThreadingHTTPServer`` front end; each handler parks on its
  request's event.
* One batcher thread drains the queue, groups up to ``batch_pages``
  requests (a PDF's pages expand into the batch) or waits ``max_wait_ms``,
  then runs ONE ``BatchPipeline.run`` over the batch: K3 once a chunk,
  K1 at every LORE sub-batch's deform convs.
* Endpoints:
    POST /v1/extract     application/pdf or image bytes -> JSON
                         {pages: [{page, html, tables, metric}]};
                         ?format=xlsx -> {tables: [{page, xlsx_b64}]}
    POST /debug/profile  a ``torch.profiler`` trace of the next seconds
    GET  /healthz        liveness and the device's platform ("gpu" on a
                         card, "cpu" otherwise, as JAX names its backends)
    GET  /v1/models      the registry's names per task
    GET  /metrics        counters and the last run's ms a page per lane

Images are decoded without OpenCV (``utils/image_io.py``). ``warm=True``
builds every task's model and loads every kernel's library before the
batcher starts, so that the first request does not pay for ``nvcc``. The
models run on ``cuda`` unless ``device="cpu"`` is given.

With a ``mesh`` (parallel/mesh.py, one process per card; ``--mesh dp=N``
under ``torchrun``) the process of rank 0 binds the port,
batches the requests and sends each batch's payloads to the other ranks
(``broadcast_object_list``); each of those runs :meth:`serve_worker`,
which expands the same payloads into the same pages and enters the
collective ``BatchPipeline.run`` beside rank 0, until rank 0 sends a stop
(:meth:`close`). Every dp row runs its shard of the batch's pages on its
own card (the tp and sp ranks of a row alike); rank 0 answers with all of
them. ``/healthz`` and ``/metrics`` are
rank 0's.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Any, Dict, List, Optional

MAX_PAYLOAD = 256 * 1024 * 1024   # one request is not one corpus


@dataclass
class _Request:
    kind: str                       # "pdf" | "image"
    payload: bytes
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None


class ExtractionService:
    """Owns the pipeline and the batching loop; separable from HTTP, so
    that tests (and other front ends) drive it directly."""

    def __init__(self, config=None, batch_pages: int = 8,
                 max_wait_ms: float = 25.0, warm: bool = False,
                 mesh=None, device=None):
        from .parallel.mesh import dp_rank_and_size
        from .pipeline.batch_runner import BatchPipeline
        from .pipeline.system import OcrSystemConfig

        self.pipeline = BatchPipeline(config or OcrSystemConfig(), mesh=mesh,
                                      batch_pages=batch_pages, device=device)
        self.mesh = mesh
        dp_rank_and_size(mesh)   # an axis but dp, tp and sp raises here
        # the mesh's first process batches; every other one (of any dp,
        # tp or sp index) runs in serve_worker
        self.rank = 0 if mesh is None else mesh.get_rank() - int(
            mesh.mesh.flatten()[0])
        self.batch_pages = batch_pages
        self.max_wait_ms = max_wait_ms
        self.queue: "Queue[_Request]" = Queue()
        self.counters = {"requests": 0, "pages": 0, "errors": 0,
                         "batches": 0}
        self._counter_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._batch_loop,
                                        daemon=True)
        if warm:
            self.warm()
        if self.rank == 0:
            self._thread.start()

    @property
    def platform(self) -> str:
        return "gpu" if self.pipeline.device.type == "cuda" else "cpu"

    def warm(self) -> None:
        """Build every task the runner calls and, on a card, load every
        kernel's library (built first where missing)."""
        self.pipeline.system.build_tasks()
        if self.pipeline.device.type == "cuda":
            from .ops.kernels.build import load_all
            load_all()

    # -- request side --------------------------------------------------------

    def submit(self, kind: str, payload: bytes,
               timeout_s: float = 300.0) -> Dict[str, Any]:
        req = _Request(kind, payload)
        self._bump("requests")
        self.queue.put(req)
        if not req.done.wait(timeout_s):
            raise TimeoutError("extraction timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result  # type: ignore[return-value]

    def close(self) -> None:
        self._stop.set()
        if self.mesh is not None and self.rank == 0:
            # the batch in flight is a collective: let it end, then stop
            # the other ranks' workers
            self._thread.join()
            self._send_batch(None)
        else:
            self._thread.join(timeout=5)
        # fail whatever is still queued, so that parked handlers return
        # now instead of riding out their submit timeout
        while True:
            try:
                req = self.queue.get_nowait()
            except Empty:
                break
            req.error = "service shutting down"
            self._bump("errors")
            req.done.set()

    # -- batch side ----------------------------------------------------------

    def _send_batch(self, items):
        """Rank 0's (kind, payload) list of a batch, or None to stop, to
        every rank of the mesh; returns what rank 0 sent."""
        import torch.distributed as dist

        box = [items]
        dist.broadcast_object_list(box, src=int(self.mesh.mesh.flatten()[0]))
        return box[0]

    def serve_worker(self) -> None:
        """A rank other than 0: run each batch rank 0 sends through the
        collective ``BatchPipeline.run``, until it sends a stop."""
        import os

        while True:
            items = self._send_batch(None)
            if items is None:
                return
            pages: List[Dict[str, Any]] = []
            for kind, payload in items:
                try:
                    pages.extend(self._expand(_Request(kind, payload)))
                except Exception:
                    continue   # rank 0 fails this request the same way
            try:
                if pages:
                    self.pipeline.run(pages)
            except Exception:
                from .utils.logging_utils import logger
                logger.exception("worker batch failed")
            finally:
                for p in pages:
                    tmp = p.get("_tmp_path")
                    if tmp and os.path.exists(tmp):
                        os.unlink(tmp)

    def _expand(self, req: _Request) -> List[Dict[str, Any]]:
        """One request -> page dicts for ``BatchPipeline.run``."""
        if req.kind == "pdf":
            import os
            import tempfile

            from .pdfio.reader import PdfDocument

            # the reader maps a file; the pages keep its path for cleanup
            tmp = tempfile.NamedTemporaryFile(suffix=".pdf", delete=False)
            tmp.write(req.payload)
            tmp.close()
            try:
                doc = PdfDocument.open(tmp.name)
                pages = [{"pdf_page": doc.load_page(i), "pdf_doc": doc,
                          "page": i} for i in range(doc.page_count)]
            except Exception:
                os.unlink(tmp.name)
                raise
            for p in pages:
                p["_tmp_path"] = tmp.name
            return pages
        from .utils.image_io import decode_image

        img = decode_image(req.payload)
        if img is None:
            raise ValueError("undecodable image payload")
        return [{"image": img, "page": 0}]

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except Empty:
                continue
            batch = [first]
            deadline = time.time() + self.max_wait_ms / 1000.0
            while len(batch) < self.batch_pages:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=left))
                except Empty:
                    break
            self._process(batch)

    def _process(self, batch: List[_Request]) -> None:
        import os

        if self.mesh is not None:
            self._send_batch([(r.kind, r.payload) for r in batch])
        pages, owners = [], []
        for req in batch:
            try:
                expanded = self._expand(req)
            except Exception as e:
                req.error = f"{type(e).__name__}: {e}"
                self._bump("errors")
                req.done.set()
                continue
            owners.append((req, len(pages), len(expanded)))
            pages.extend(expanded)
        try:
            if pages:
                self._bump("batches")
                self._bump("pages", len(pages))
                try:
                    results = self.pipeline.run(pages)
                except Exception as e:  # total failure: report everyone
                    for req, _lo, _n in owners:
                        req.error = f"{type(e).__name__}: {e}"
                        self._bump("errors")
                        req.done.set()
                    return
                for req, lo, n in owners:
                    outs = results[lo:lo + n]
                    req.result = {"pages": [self._render(o) for o in outs]}
                    req.done.set()
        finally:
            # the temp PDFs go even when the run raises
            for p in pages:
                tmp = p.get("_tmp_path")
                if tmp and os.path.exists(tmp):
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass

    def _bump(self, key: str, n: int = 1) -> None:
        """Counters are written from every handler thread: serialized."""
        with self._counter_lock:
            self.counters[key] = self.counters.get(key, 0) + n

    @staticmethod
    def _render(out) -> Dict[str, Any]:
        return {
            "page": out.page,
            "html": out.page_html or "",
            "tables": list(out.table_html or []),
            "metric": {k: v for k, v in (out.metric or {}).items()
                       if isinstance(v, (int, float, str))},
        }


def tables_as_xlsx(result: Dict[str, Any]) -> Dict[str, Any]:
    """Every table of an extraction result as a base64 xlsx workbook."""
    import base64
    import os
    import tempfile

    from .utils.xlsx_writer import html_table_to_xlsx

    books = []
    for p in result["pages"]:
        for t in p["tables"]:
            fd, path = tempfile.mkstemp(suffix=".xlsx")
            os.close(fd)
            try:
                html_table_to_xlsx(t, path)
                with open(path, "rb") as f:
                    books.append({"page": p["page"], "xlsx_b64":
                                  base64.b64encode(f.read()).decode()})
            finally:
                os.unlink(path)
    return {"tables": books}


def make_server(service: ExtractionService, host: str = "127.0.0.1",
                port: int = 8400):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            from .utils.logging_utils import get_logger

            get_logger().debug("serve: " + fmt % args)

        def _send(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "platform": service.platform})
            elif self.path == "/v1/models":
                from .models import registry

                self._send(200, {t: registry.list_models(t)
                                 for t in registry.TASKS})
            elif self.path == "/metrics":
                stats = service.pipeline.last_stats or {}
                n = max(stats.get("n_pages", 1.0), 1.0)
                self._send(200, {
                    "counters": service.counters,
                    "last_stage_ms_per_page": {
                        k: round(v / n * 1000, 1)
                        for k, v in stats.items() if k != "n_pages"}})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path == "/debug/profile":
                # a torch.profiler trace of the next seconds of serving
                import tempfile

                from .utils.profiling import device_trace

                q = parse_qs(url.query)
                secs = min(float(q.get("seconds", ["3"])[0]), 60.0)
                out_dir = q.get("dir", [tempfile.mkdtemp(
                    prefix="serve_profile_")])[0]
                try:
                    with device_trace(out_dir):
                        time.sleep(secs)
                    self._send(200, {"trace_dir": out_dir, "seconds": secs})
                except Exception as e:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if url.path != "/v1/extract":
                self._send(404, {"error": "not found"})
                return
            fmt = parse_qs(url.query).get("format", ["json"])[0]
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_PAYLOAD:
                self._send(413, {"error": "payload too large (256MB cap)"})
                return
            payload = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            kind = "pdf" if ("pdf" in ctype
                             or payload[:5] == b"%PDF-") else "image"
            try:
                result = service.submit(kind, payload)
                if fmt == "xlsx":
                    result = tables_as_xlsx(result)
                self._send(200, result)
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="pdf_table_tpu_torch serving")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--batch_pages", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=25.0)
    ap.add_argument("--no_warm", action="store_true",
                    help="skip building the models and kernels at startup")
    ap.add_argument("--mesh", default=None,
                    help="dp=N: data parallel over N processes, one per "
                         "card (run under torchrun --nproc_per_node=N)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh
        from .parallel.multihost import initialize

        axis, _, n = args.mesh.partition("=")
        if axis != "dp" or not n.isdigit():
            raise ValueError(f"--mesh {args.mesh!r}: expected dp=N")
        initialize()
        mesh = make_mesh(int(n))
    service = ExtractionService(batch_pages=args.batch_pages,
                                max_wait_ms=args.max_wait_ms,
                                warm=not args.no_warm, mesh=mesh)
    if service.rank != 0:
        service.serve_worker()
        return 0
    server = make_server(service, args.host, args.port)
    print(f"serving on http://{args.host}:{args.port}", flush=True)

    import signal

    def _term(_sig, _frm):  # drain in-flight work, then exit cleanly
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
