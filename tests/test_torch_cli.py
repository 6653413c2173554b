"""The port's ``pdftable`` CLI (``pdf_table_tpu_torch/cli/main.py``) on the
CPU.

The eight digital golden cases (tests/golden/cases.py) go through the
port's ``main([... "--layout_model", "none"], device="cpu")`` as
``run_digital_case`` sends them through JAX's, and each merged HTML is
byte-equal to tests/golden/expected/<case>.html.

Against JAX's ``PdfTableCli`` on the trees and systems of
tests/test_torch_system.py (the per-image detector and the natural-size
crops the port's on both sides, as there): the raster image route
(``--debug``: the per-page system, the overlay PNG written and equal to
JAX's outside its labels) and the ``--batch_pages 2`` route of a
two-page digital PDF (``BatchPipeline.run``; the JAX runner asked for the
canvases as they are) give the same merged HTML and the same metric
keys. Then ``parse_pages`` against JAX's, the flag surface,
``--profile_dir`` (a trace written), ``--device_mesh`` (declared and
read by nothing, as in the JAX CLI: the same outputs) and the CUDA
default."""

import contextlib
import io
import json
import os
import sys

import cv2
import pytest
import torch

import pdf_table_tpu.pipeline.batch_runner as jbr
from pdf_table_tpu.cli import main as jmain
from pdf_table_tpu.entity.args import PdfTableCliArguments as JArgs
from pdf_table_tpu.pdfio import PdfWriter
from pdf_table_tpu_torch.cli import main as tmain
from pdf_table_tpu_torch.entity.args import PdfTableCliArguments
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from test_torch_aux_tasks import assert_overlays_match, overlay_labels
from test_torch_pipeline import DET, DET_BENCH
from test_torch_system import (TABLE_PAGE, jtasks,  # noqa: F401
                               systems, trees)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "golden"))
import cases  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(cases.DIGITAL_CASES))
def test_digital_golden_case_through_the_cli(name, tmp_path):
    pdf = cases.DIGITAL_CASES[name](str(tmp_path))
    out_dir = str(tmp_path / "out")
    with contextlib.redirect_stdout(io.StringIO()) as stdout:
        rc = tmain.main(["--file_path_or_url", pdf, "--output_dir", out_dir,
                         "--layout_model", "none"], device="cpu")
    assert rc == 0
    result = json.loads(stdout.getvalue().strip().splitlines()[-1])
    base = os.path.splitext(os.path.basename(pdf))[0]
    assert result["html"] == os.path.join(out_dir, base + ".html")
    with open(result["html"], encoding="utf-8") as f:
        assert f.read() == cases.load_expected(name)


def clis(trees, jtasks, tmp_path, **flags):
    """(port CLI, JAX CLI) on the system tests' systems, with ``flags``."""
    port_sys, jax_sys = systems(trees, jtasks, debug=flags.get("debug",
                                                               False))
    kw = dict(output_dir=str(tmp_path / "p"), **flags)
    port = tmain.PdfTableCli(PdfTableCliArguments(**kw), device="cpu")
    jax_ = jmain.PdfTableCli.__new__(jmain.PdfTableCli)
    jax_.args = JArgs(**dict(kw, output_dir=str(tmp_path / "j")))
    port.system, jax_.system = port_sys, jax_sys
    return port, jax_


def run_both(port, jax_):
    got, want = port.run_extract_pdf_table(), jax_.run_extract_pdf_table()
    assert got["n_pages"] == want["n_pages"]
    with open(got["html"]) as f, open(want["html"]) as g:
        assert f.read() == g.read()
    with open(got["metrics"]) as f, open(want["metrics"]) as g:
        pm, jm = json.load(f)["pages"], json.load(g)["pages"]
    assert [set(p) for p in pm] == [set(p) for p in jm]
    assert all("error" not in p for p in pm)
    return got, want, pm


def test_image_route_with_debug_matches_jax(trees, jtasks, tmp_path):
    path = str(tmp_path / "table_page.png")
    cv2.imwrite(path, cv2.cvtColor(TABLE_PAGE, cv2.COLOR_RGB2BGR))
    port, jax_ = clis(trees, jtasks, tmp_path, file_path_or_url=path,
                      debug=True)
    got, want, pm = run_both(port, jax_)
    assert pm[0]["n_text"] and pm[0]["n_tables"]
    name = "table_page_page1_debug.png"
    overlay = cv2.imread(str(tmp_path / "p" / name))
    joverlay = cv2.imread(str(tmp_path / "j" / name))
    out = port.system(image=TABLE_PAGE.copy())
    assert_overlays_match(
        overlay[..., ::-1], joverlay[..., ::-1], out.image,
        overlay_labels(out.layout_cells,
                       [(None, r) for r in out.table_structures]))


def _two_page_pdf(path):
    w = PdfWriter()
    for k in range(2):
        p = w.add_page(612, 792)
        p.text(60, 740, f"Page {k} of a digital document.")
        for i in range(4):
            p.text(60, 700 - 20 * i, f"Body line {i} of page {k}.")
        p.table(60, 560 - 40 * k, [150, 100, 100], 24,
                [["name", "qty", "price"], ["bolts", "40", "0.10"],
                 ["nuts", str(12 + k), "0.05"]])
    w.save(path)
    return path


class RgbRunner(jbr.BatchPipeline):
    """JAX's runner with the canvases uploaded as they are and its device
    crops (tests/test_torch_pipeline.py)."""

    def __init__(self, *a, **kw):
        kw.update(upload_codec="rgb", device_crops=True)
        super().__init__(*a, **kw)


def test_batched_pdf_route_matches_jax(trees, jtasks, tmp_path,
                                       monkeypatch):
    monkeypatch.setattr(jbr, "BatchPipeline", RgbRunner)
    pdf = _two_page_pdf(str(tmp_path / "doc.pdf"))
    port, jax_ = clis(trees, jtasks, tmp_path, file_path_or_url=pdf,
                      batch_pages=2)
    # the runners' own detection lanes (the digital pages drop its quads)
    port.system._det = OcrDetectionTask(model="PP-OCRv4_det", device="cpu",
                                        variables=trees["det"], **DET,
                                        **DET_BENCH)
    jax_.system._det = jtasks["_det"]
    got, want, pm = run_both(port, jax_)
    assert got["n_pages"] == 2 and all(p["n_tables"] for p in pm)
    with open(got["html"]) as f:
        html = f.read()
    assert html.count("<!-- page") == 2 and "Body line 3 of page 1" in html


def test_parse_pages_and_flags_match_jax():
    for spec in ("all", "", "1,3,4", "2-5", "1,4-end", "3-", "9,1-2,2"):
        for n in (1, 5, 12):
            assert tmain.parse_pages(spec, n) == jmain.parse_pages(spec, n)
    argv = ["--file_path_or_url", "x.png", "--debug", "--batch_pages", "3",
            "--detect_db_thresh", "0.4", "--pages", "1-2"]
    assert vars(tmain.build_arg_parser().parse_args(argv)) == \
        vars(jmain.build_arg_parser().parse_args(argv))
    assert tmain.DET_ALIASES == jmain.DET_ALIASES
    assert tmain.REC_ALIASES == jmain.REC_ALIASES


def test_profile_dir_mesh_and_cuda_default(tmp_path, monkeypatch):
    pdf = cases.DIGITAL_CASES["digital_simple"](str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()):
        assert tmain.main(["--file_path_or_url", pdf, "--output_dir",
                           str(tmp_path / "o"), "--layout_model", "none",
                           "--profile_dir", str(tmp_path / "prof")],
                          device="cpu") == 0
    assert [f.endswith(".json") for f in os.listdir(tmp_path / "prof")] \
        == [True]
    # declared and read by nothing, as in the JAX CLI
    with contextlib.redirect_stdout(io.StringIO()):
        assert tmain.main(["--file_path_or_url", pdf, "--output_dir",
                           str(tmp_path / "m"), "--layout_model", "none",
                           "--device_mesh", "dp=8"], device="cpu") == 0
    assert sorted(os.listdir(tmp_path / "m")) == \
        sorted(os.listdir(tmp_path / "o"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.main(["--file_path_or_url", pdf])
    with pytest.raises(FileNotFoundError):
        tmain.main(["--file_path_or_url", str(tmp_path / "none.png"),
                    "--output_dir", str(tmp_path / "o")], device="cpu")
