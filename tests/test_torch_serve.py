"""The port's HTTP service (``pdf_table_tpu_torch/serve.py``) against the
JAX package's on the CPU: the eleven cases of tests/test_serve.py, each
served by both, on the same payloads.

Both services' runners are those of tests/test_torch_pipeline.py on the
trees of tests/test_torch_system.py (tiny detection, PicoDet and LORE,
full-width recognition with one width bucket and the 0/180 classifier,
bench.py's line grid injected; the JAX runner asked for the canvases as
they are and its device crops). Held: the JSON answers equal (page, page
HTML and table HTML; the metric keys, whose values are seconds) on a
two-page digital PDF, a raster PNG page, a payload that is no image, the
xlsx answer (the decoded worksheet XML equal) and three concurrent
requests (fewer pipeline runs than requests); ``/healthz`` ("cpu" on
both, as JAX names its CPU backend), ``/metrics`` (its counters add up),
``/v1/models`` (equal to JAX's ``list_models``), ``/debug/profile``
(a trace written), the 413 cap; ``close()`` fails the requests still
queued; a crashed run still deletes its temp PDFs. Then the port's
``warm`` (every task built before the batcher starts) and the refusals
of ``mesh``: an axis other than dp, tp and sp raises, ``--mesh dp=2``
outside a process group of two raises, as does another axis (the dp
service itself runs in tests/test_torch_parallel_runner.py, on a tp
mesh in tests/test_torch_tp_sp.py)."""

import base64
import http.client
import io
import json
import os
import threading
import zipfile

import numpy as np
import pytest
import torch

import pdf_table_tpu.serve as jserve
from pdf_table_tpu.pdfio import writer as jwriter
from pdf_table_tpu.pipeline.system import OcrSystemConfig as JConfig
from pdf_table_tpu_torch import serve
from pdf_table_tpu_torch.models import registry
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.utils.image_io import decode_image
from test_torch_pipeline import PAGES, jax_pipeline, port_pipeline
from test_torch_system import jtasks, trees  # noqa: F401

torch.set_num_threads(1)

PIPE_TASKS = ("_det", "_layout", "_rec", "_tsr", "_line_cls")


def _start(service):
    srv = (serve if isinstance(service, serve.ExtractionService)
           else jserve).make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


@pytest.fixture(scope="module")
def servers(trees, jtasks):
    """(port service, its port, JAX service, its port)."""
    svc = serve.ExtractionService(OcrSystemConfig(), batch_pages=4,
                                  max_wait_ms=50.0, device="cpu")
    svc.pipeline = port_pipeline(trees, True)
    jsvc = jserve.ExtractionService(JConfig(), batch_pages=4,
                                    max_wait_ms=50.0, warm=False)
    jsvc.pipeline = jax_pipeline({k: jtasks[k] for k in PIPE_TASKS}, True)
    srvs = [_start(svc), _start(jsvc)]
    yield svc, srvs[0].server_address[1], jsvc, srvs[1].server_address[1]
    for s in srvs:
        s.shutdown()
    svc.close()
    jsvc.close()


def _request(port, method, path, body=None, ctype="application/pdf"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, body, {"Content-Type": ctype} if body
                 else {})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def _both(servers, method, path, body=None, ctype="application/pdf"):
    _, port, _, jport = servers
    return (_request(port, method, path, body, ctype),
            _request(jport, method, path, body, ctype))


def _digital_pdf_bytes(n_pages=1):
    doc = jwriter.PdfWriter()
    for i in range(n_pages):
        pg = doc.add_page(300, 240)
        pg.text(20, 200, f"served page {i}")
        pg.table(20, 160, [80, 80], 24, [["A", "B"], ["1", "2"]])
    return doc.tobytes()


def _png(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def same_answer(got, want):
    (status, out), (jstatus, jout) = got, want
    assert status == jstatus
    if "pages" not in jout:
        assert out == jout
        return
    assert len(out["pages"]) == len(jout["pages"])
    for p, j in zip(out["pages"], jout["pages"]):
        assert (p["page"], p["html"], p["tables"]) == \
            (j["page"], j["html"], j["tables"])
        assert set(p["metric"]) == set(j["metric"])


class TestServe:
    def test_healthz_and_metrics(self, servers):
        (s, h), (js, jh) = _both(servers, "GET", "/healthz")
        assert s == js == 200 and h == jh == {"ok": True, "platform": "cpu"}
        (s, m), (js, jm) = _both(servers, "GET", "/metrics")
        assert s == js == 200 and set(m) == set(jm) == {
            "counters", "last_stage_ms_per_page"}
        assert set(m["counters"]) == set(jm["counters"])

    def test_extract_digital_pdf(self, servers):
        got, want = _both(servers, "POST", "/v1/extract",
                          _digital_pdf_bytes(2))
        same_answer(got, want)
        pages = got[1]["pages"]
        assert len(pages) == 2 and all("served page" in p["html"]
                                       for p in pages)
        assert all("<table" in t for p in pages for t in p["tables"])

    def test_bad_payload_contained(self, servers):
        got, want = _both(servers, "POST", "/v1/extract", b"not an image",
                          "image/png")
        assert got == want and got[0] == 500
        assert got[1]["error"].endswith("undecodable image payload")
        got, want = _both(servers, "POST", "/v1/extract",
                          _digital_pdf_bytes(1))
        same_answer(got, want)
        assert got[0] == 200

    def test_concurrent_requests_batch_together(self, servers):
        svc, port, jsvc, jport = servers
        before = svc.counters["batches"], svc.counters["requests"]
        body = _digital_pdf_bytes(1)
        results = {port: [], jport: []}

        def post(p):
            results[p].append(_request(p, "POST", "/v1/extract", body))

        ts = [threading.Thread(target=post, args=(p,))
              for p in (port, jport) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        assert len(results[port]) == len(results[jport]) == 3
        for got in results[port]:
            same_answer(got, results[jport][0])
        assert svc.counters["requests"] - before[1] == 3
        assert svc.counters["batches"] - before[0] <= 2

    def test_xlsx_format(self, servers):
        got, want = _both(servers, "POST", "/v1/extract?format=xlsx",
                          _digital_pdf_bytes(1))
        assert got[0] == want[0] == 200
        books, jbooks = got[1]["tables"], want[1]["tables"]
        assert books and len(books) == len(jbooks)
        for b, j in zip(books, jbooks):
            assert b["page"] == j["page"]
            blobs = [base64.b64decode(x["xlsx_b64"]) for x in (b, j)]
            assert blobs[0][:2] == b"PK"
            sheets = [zipfile.ZipFile(io.BytesIO(x)).read(
                "xl/worksheets/sheet1.xml") for x in blobs]
            assert sheets[0] == sheets[1]

    def test_profile_endpoint(self, servers, tmp_path):
        _, port, _, _ = servers
        status, out = _request(
            port, "POST", f"/debug/profile?seconds=0.2&dir={tmp_path}/prof")
        assert status == 200, out
        assert os.path.isdir(out["trace_dir"]) and os.listdir(
            out["trace_dir"])

    def test_extract_image_payload(self, servers):
        img = np.ascontiguousarray(PAGES[2][:520, :760])
        got, want = _both(servers, "POST", "/v1/extract", _png(img),
                          "image/png")
        same_answer(got, want)
        assert got[0] == 200 and len(got[1]["pages"]) == 1
        page = got[1]["pages"][0]
        assert page["tables"] and page["html"].count("<table") == len(
            page["tables"])

    def test_models_endpoint(self, servers):
        (s, out), (js, jout) = _both(servers, "GET", "/v1/models")
        assert s == js == 200 and out == jout
        assert out == {t: registry.list_models(t) for t in registry.TASKS}
        assert "Lore" in out["table_structure"]

    def test_payload_cap(self, servers):
        _, port, _, _ = servers
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/v1/extract")
        conn.putheader("Content-Type", "application/pdf")
        conn.putheader("Content-Length", str(300 * 1024 * 1024))
        conn.endheaders()
        assert conn.getresponse().status == 413


def _idle_service(**kw):
    cfg = OcrSystemConfig(use_layout=False, use_table=False,
                          use_orientation_cls=False)
    svc = serve.ExtractionService(cfg, batch_pages=2, max_wait_ms=5.0,
                                  device="cpu", **kw)
    svc._stop.set()          # wedge the batcher first
    svc._thread.join(timeout=5)
    return svc


class TestServeShutdown:
    def test_close_fails_pending_requests(self):
        svc = _idle_service()
        req = serve._Request("pdf", b"%PDF-bogus")
        svc.queue.put(req)
        svc.close()
        assert req.done.is_set() and req.error == "service shutting down"
        assert svc.counters["errors"] == 1


class TestTempCleanupOnFailure:
    def test_pipeline_crash_still_unlinks_temp_pdfs(self):
        svc = _idle_service()
        try:
            pages = svc._expand(serve._Request("pdf", _digital_pdf_bytes(1)))
            tmp_file = pages[0]["_tmp_path"]
            assert os.path.exists(tmp_file)
            svc._expand = lambda req: pages

            def boom(_pages):
                raise RuntimeError("injected pipeline failure")

            svc.pipeline.run = boom
            req = serve._Request("pdf", b"ignored")
            svc._process([req])
            assert req.done.is_set()
            assert "injected pipeline failure" in (req.error or "")
            assert not os.path.exists(tmp_file), "temp PDF leaked"
            assert svc.counters["errors"] >= 1
        finally:
            svc.close()


def test_warm_builds_every_task_and_mesh_raises():
    cfg = OcrSystemConfig(use_orientation_cls=False,
                          table_structure_kwargs=dict(
                              task_type="wireless", resolution=(64, 64),
                              max_objs=8, hidden_size=32, head_conv=16,
                              tsfm_layers=1, stacking_layers=1, num_heads=4,
                              max_fmp_size=64, d_ff=64))
    svc = serve.ExtractionService(cfg, device="cpu", warm=True)
    try:
        s = svc.pipeline.system
        assert all(getattr(s, k) is not None for k in PIPE_TASKS)
        assert svc.platform == "cpu"
    finally:
        svc.close()
    class PpMesh:
        mesh_dim_names = ("dp", "pp")

    with pytest.raises(ValueError, match="'pp'"):
        serve.ExtractionService(mesh=PpMesh(), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        serve.main(["--mesh", "dp=2"])
    with pytest.raises(ValueError, match="dp=N"):
        serve.main(["--mesh", "tp=2"])
    assert decode_image(_png(PAGES[0][:8, :8])).shape == (8, 8, 3)
