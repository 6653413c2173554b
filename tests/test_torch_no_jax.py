"""The port runs its slices with nothing of JAX, flax or pdf_table_tpu
imported: a fresh interpreter imports pdf_table_tpu_torch, runs the tiny
wireless and wtw LORE slices on the CPU down to table HTML, the detection
slice (full width, small detector input) down to page quads and the
recognition lane (full width, 0/180 classifier on, an axis-aligned and a
rotated quad) down to texts, and lists what got imported. A second fresh
interpreter runs the layout lane (PicoDet, full backbone, small input) and
the port's ``BatchPipeline.run`` over three pages, two buckets, with every
lane on small configs and the 0/180 classifier on, down to page HTML. A
third runs the training slice: the LORE trainer on synthetic wired tables
(``fit``, a checkpoint, a full-state save and restore), with neither JAX,
flax, optax, orbax, cv2 nor PIL imported. A fourth runs the token models
(SLANet, TableMaster, MtlTabNet at tiny configs: crops cut from the pages,
the decode, the token path of table HTML) and ``BatchPipeline.run`` with
``table_structure_model="SLANet"``, with neither JAX, flax, cv2 nor the JAX
package imported. A fifth builds and runs the rest of table structure
(CenterNet, Lgpma, LineCell, LoreAndLineCell and a ``resnet18`` LORE, at
tiny configs) on a page with two regions, with neither JAX, flax, cv2 nor
the JAX package imported. A sixth runs the rest of the backbones:
DocXLayout (tiny config) through ``batch_infer_from_pages`` and
``__call__``, the three ModelScope DBNets (full width, small detector
input), the CRNN, ConvNextViT and LightweightEdge recognizers (full width,
0/180 classifier on) and ``BatchPipeline.run`` with
``layout_model="DocXLayout"``, ``detect_model="db_resnet18"`` and
``recognizer_model="CRNN"`` down to page HTML, with neither JAX, flax, cv2
nor the JAX package imported. A seventh runs the digital lane: it writes a
PDF with the port's writer, reads it with the port's reader, runs
``BatchPipeline.run`` on the digital page carrying the image of the
vector-and-image half of the renderer, and ``read_pdf(flavor="pdf")``,
with neither JAX, flax, cv2, PIL nor the JAX package imported. An eighth
builds every model that runs bf16 (the four DBNets, the four
recognizers, PicoDet, PP-LCNet, SLANet, TableMaster, MtlTabNet, LGPMA,
LORE) in bf16, runs each once on a small input, and runs the per-crop
table-structure surface (``batch_infer`` and ``__call__`` of LORE,
SLANet, CenterNet, LGPMA and LineCell), with neither JAX, flax, cv2 nor
the JAX package imported. A ninth runs the per-page system
(``OcrSystemTask.__call__`` with the deskew, the page-orientation and
0/180 classifiers, PicoDet, LORE, the host detection and recognition
paths) on a skewed raster page and a digital page authored rotated by 90
degrees, ``ocr`` and ``timing_summary``, ``BatchPipeline.run`` with its
``device_boxes=False`` and ``device_crops=False`` lanes, and the OpenCV
host geometry (its C++ library built at first use), with neither JAX,
flax, cv2 nor the JAX package imported. A tenth imports every module of
the task surface and serving, runs the ``pdftable`` CLI on a digital PDF
and the HTTP service on one request, with neither JAX, flax, cv2, lxml
nor the JAX package imported. An eleventh runs the DBNet quick trainer,
``ctc_loss`` and the converter entry point, with neither JAX, flax,
optax, orbax, cv2 nor the JAX package imported. A twelfth runs the
parallel package on a one-process gloo group (the dp mesh, ``shard_batch``,
``replicate_params``, GPipe at one stage, the dp train step), the FLOP
count of a deform conv and a conv with a stage around it, and DBNet's
polygon mode, with neither JAX, flax, cv2 nor the JAX package
imported. A thirteenth starts four gloo ranks, each a fresh interpreter,
that take one LORE train step (dla34, small widths) on a (dp 1, tp 2,
sp 2) mesh, with neither JAX, flax, optax, cv2 nor the JAX package
imported on any rank. A fourteenth imports the data model (no model module
comes with it), resolves every export of the JAX package's packages through
the port's, and calls the entity and ops names of the public surface on the
CPU, with neither JAX, flax, cv2, lxml nor the JAX package imported. A
fifteenth runs the scanned route: a PDF of two CMYK JPEG scans of a ruled
table (one with an invisible OCR text layer) through ``BatchPipeline.run``,
``read_pdf(flavor="lattice")`` and the ``pdftable`` CLI, then decodes every
committed image fixture (the port's own readers and the OpenJPEG and
libtiff bindings among them) to its digest of cv2's decode, with neither
JAX, flax, cv2, lxml nor the JAX package imported."""

import json
import os
import subprocess
import sys

_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask
task = OcrTableStructureTask(
    model="Lore", task_type="wireless", device="cpu", resolution=(64, 64),
    max_objs=8, hidden_size=32, head_conv=16, tsfm_layers=1,
    stacking_layers=1, num_heads=4, max_fmp_size=64, d_ff=64)
pages = np.full((1, 90, 80, 3), 255, np.uint8)
pages[0, ::12] = 20
res = task.batch_infer_from_pages(pages, [(0, (5, 5, 75, 85))])
html = OcrTableToHtmlTask()(res[0], [])
wtw = OcrTableStructureTask(
    model="Lore", task_type="wtw", device="cpu", resolution=(64, 64),
    max_objs=8, max_corners=16, hidden_size=32, head_conv=16, tsfm_layers=1,
    stacking_layers=1, num_heads=4, max_fmp_size=64, d_ff=64,
    vis_thresh_corner=0.1)
res = wtw.batch_infer_from_pages(pages, [(0, (5, 5, 75, 85))])
wtw_html = OcrTableToHtmlTask()(res[0], [])
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
det = OcrDetectionTask(device="cpu", limit_side_len=64, thresh=0.5,
                       box_thresh=0.0)
quads = det.batch_infer_from_pages([pages[0], pages[0][:50]])
from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
rec = OcrRecognitionTask(device="cpu", cls_task=ClsImagePulcTask(
    "textline_orientation", device="cpu"))
texts, scores = rec.batch_infer_from_pages(pages, [np.array(
    [[[5, 10], [70, 10], [70, 24], [5, 24]],
     [[8, 40], [60, 46], [58, 60], [6, 54]]], np.float32)])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "html": html.startswith("<table"),
                  "wtw_html": wtw_html.startswith("<table"),
                  "quads": [list(q.shape[1:]) for q in quads],
                  "texts": [[type(t).__name__ for t in p] for p in texts],
                  "scores": [len(p) for p in scores]}))
"""


def test_slice_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "html": True, "wtw_html": True,
                   "quads": [[4, 2], [4, 2]], "texts": [["str", "str"]],
                   "scores": [2]}


_PIPELINE_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
tiny = dict(img_height=64, img_width=64, neck_channels=32, head_convs=1)
layout = OcrLayoutTask(device="cpu", task_type="table", score_threshold=0.0,
                       keep_top_k=2, **tiny)
pages = np.full((2, 1280, 960, 3), 255, np.uint8)
pages[:, ::40] = 20
cells = layout.batch_infer_from_pages(pages)
from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
bp = BatchPipeline(OcrSystemConfig(use_orientation_cls=False), batch_pages=2,
                   device="cpu")
bp.system._det = OcrDetectionTask(device="cpu", limit_side_len=64,
                                  thresh=0.45, box_thresh=0.0)
bp.system._layout = layout
bp.system._rec = OcrRecognitionTask(device="cpu", width_buckets=(80,))
bp.system._tsr = OcrTableStructureTask(
    model="Lore", task_type="wireless", device="cpu", resolution=(64, 64),
    max_objs=8, hidden_size=32, head_conv=16, tsfm_layers=1,
    stacking_layers=1, num_heads=4, max_fmp_size=64, d_ff=64)
orig = bp._boxes_finish
bp._boxes_finish = lambda *a: [np.concatenate([q, np.array(
    [[[70, 60], [300, 60], [300, 82], [70, 82]]], np.float32)])
    for q in orig(*a)]
imgs = [pages[0][:1200, :900], pages[1][:1000], pages[0][:1500, :1100]]
out = bp.run([{"image": im, "page": i} for i, im in enumerate(imgs)])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "layout": [len(c) for c in cells],
                  "pages": [o.page for o in out],
                  "errors": [o.metric.get("error") for o in out],
                  "html": [bool(o.page_html) for o in out],
                  "texts": [len(o.text_cells) >= 1 for o in out],
                  "cls": bp.system.rec_task.cls_task is not None}))
"""


def test_layout_and_pipeline_run_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _PIPELINE_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "layout": [2, 2], "pages": [0, 1, 2],
                   "errors": [None, None, None], "html": [True] * 3,
                   "texts": [True] * 3, "cls": True}


_TRAIN_SCRIPT = r"""
import json, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.data.synthetic import SyntheticTableDataset
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.train.lore_trainer import LoreTrainArgs, LoreTrainer
cfg = LoreConfig.wtw(resolution=(64, 64), max_objs=8, hidden_size=32,
                     head_conv=16, tsfm_layers=1, stacking_layers=1,
                     num_heads=4, max_fmp_size=64, d_ff=64)
out = tempfile.mkdtemp()
tr = LoreTrainer(cfg, LoreTrainArgs(batch_size=2, save_every=1,
                                    lr_schedule="constant", output_dir=out),
                 device="cpu")
hist = tr.fit(SyntheticTableDataset(cfg, n=4), steps=2)
ck = tr.save_train_state()
tr2 = LoreTrainer(cfg, LoreTrainArgs(output_dir=out), device="cpu")
tr2.restore_train_state(ck)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL",
    "pdf_table_tpu"))
print(json.dumps({"bad": bad, "steps": len(hist), "step": tr2.state.step,
                  "finite": all(np.isfinite(h["loss"]) for h in hist)}))
"""


def test_training_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _TRAIN_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "steps": 2, "step": 2, "finite": True}


_TOKEN_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.entity.ocr_cell import OcrCell
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask
pages = np.full((2, 150, 170, 3), 255, np.uint8)
pages[:, ::15] = 20
regions = [(0, (10, 20, 160, 120)), (1, (0, 0, 170, 150))]
kw = {"SLANet": dict(table_max_len=64, hidden_size=32, max_structure_len=8),
      "TableMaster": dict(img_size=(64, 64), d_model=32, decoder_layers=2,
                          heads=4, ff_dim=64, max_structure_len=8)}
kw["MtlTabNet"] = kw["TableMaster"]
types, htmls = [], []
for model, k in kw.items():
    task = OcrTableStructureTask(model=model, device="cpu", **k)
    for r in task.batch_infer_from_pages(pages, regions) + [task(pages[0])]:
        types.append(r["type"])
        r = dict(r, structure_tokens=["<tr>", "<td></td>", "</tr>"],
                 cells=[{"bbox": [0, 0, 60, 20]}], offset=(0, 0))
        htmls.append(OcrTableToHtmlTask()(
            r, [OcrCell.from_bbox((5, 2, 55, 18), text="a&b")]))
from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
bp = BatchPipeline(OcrSystemConfig(
    use_orientation_cls=False, use_textline_cls=False,
    table_structure_model="SLANet", table_structure_kwargs=kw["SLANet"]),
    batch_pages=2, device="cpu")
bp.system._det = OcrDetectionTask(device="cpu", limit_side_len=64,
                                  thresh=0.45, box_thresh=0.0)
bp.system._layout = OcrLayoutTask(
    device="cpu", task_type="table", score_threshold=0.0, keep_top_k=2,
    img_height=64, img_width=64, neck_channels=32, head_convs=1)
bp.system._rec = OcrRecognitionTask(device="cpu", width_buckets=(80,))
page = np.full((1200, 900, 3), 255, np.uint8)
page[300:700:40, 60:840] = 20
out = bp.run([{"image": page, "page": 0}])
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "types": types,
                  "cells": [h.split("<td>")[1].split("</td>")[0]
                            for h in htmls],
                  "errors": [o.metric.get("error") for o in out],
                  "tsr": bp.system.tsr_task.model_name,
                  "tables": [r["type"] for r in out[0].table_structures]}))
"""


def test_token_models_run_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _TOKEN_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    tables = res.pop("tables")
    assert res == {"bad": [], "types": ["slanet"] * 3 + ["master"] * 6,
                   "cells": ["a&amp;b"] * 3 + ["a&b"] * 6,
                   "errors": [None], "tsr": "SLANet"}
    assert tables and set(tables) == {"slanet"}


_REST_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask
lore = dict(resolution=(64, 64), max_objs=8, hidden_size=32, head_conv=16,
            tsfm_layers=1, stacking_layers=1, num_heads=4, max_fmp_size=64,
            d_ff=64)
kw = {"CenterNet": dict(resolution=(64, 64), head_conv=16, K=8, MK=16),
      "Lgpma": dict(backbone_depth=18, fpn_channels=32, rpn_pre_topk=32,
                    num_proposals=16, mask_top=8, fc_dim=64, max_side=64),
      "LineCell": {},
      "LoreAndLineCell": dict(lore, task_type="wireless"),
      "Lore": dict(lore, task_type="wireless", backbone="resnet18")}
pages = np.full((1, 150, 170, 3), 255, np.uint8)
pages[:, 10:140:20, 10:160] = 20
pages[:, 10:141, 10:160:25] = 20
regions = [(0, (5, 5, 165, 145)), (0, (30, 20, 120, 100))]
types, html = [], []
for model, k in kw.items():
    task = OcrTableStructureTask(model=model, device="cpu", **k)
    for r in task.batch_infer_from_pages(pages, regions):
        types.append(r["type"])
        html.append(OcrTableToHtmlTask()(r, []).startswith("<table"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "types": types, "html": all(html)}))
"""


def test_rest_of_table_structure_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _REST_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "html": True, "types": [
        "center_net"] * 2 + ["lgpma"] * 2 + ["line_cell"] * 2
        + ["lore_line_cell_merge"] * 2 + ["lore"] * 2}


_BACKBONE_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
docx = dict(resolution=(64, 64), head_conv=16)
layout = OcrLayoutTask(model="DocXLayout", device="cpu", **docx)
pages = np.full((2, 160, 120, 3), 255, np.uint8)
pages[:, 10:150:12, 10:110] = 30
cells = layout.batch_infer_from_pages(pages)
one = layout(pages[0])
det = {m: OcrDetectionTask(model=m, device="cpu", limit_side_len=64,
                           thresh=0.45, box_thresh=0.0)
       for m in ("db_resnet18", "db_resnet50", "db_proxylessnas")}
quads = {m: [q.shape[1:] for q in t.batch_infer_from_pages(list(pages))]
         for m, t in det.items()}
cls = ClsImagePulcTask("textline_orientation", device="cpu")
boxes = [np.array([[[5, 10], [110, 10], [110, 24], [5, 24]],
                   [[8, 40], [100, 46], [98, 60], [6, 54]]], np.float32)] * 2
texts = {}
for m in ("CRNN", "ConvNextViT", "LightweightEdge"):
    rec = OcrRecognitionTask(model=m, device="cpu", cls_task=cls)
    texts[m] = [len(t) for t in rec.batch_infer_from_pages(pages, boxes)[0]]
from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
bp = BatchPipeline(OcrSystemConfig(
    layout_model="DocXLayout", detect_model="db_resnet18",
    recognizer_model="CRNN", use_orientation_cls=False,
    use_textline_cls=False, table_structure_model="LineCell"),
    batch_pages=2, device="cpu")
bp.system._det = det["db_resnet18"]
bp.system._layout = layout
page = np.full((1200, 900, 3), 255, np.uint8)
page[300:700:40, 60:840] = 20
out = bp.run([{"image": page, "page": 0}])
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "pages": len(cells),
                  "one": sorted(one), "quads": quads, "texts": texts,
                  "errors": [o.metric.get("error") for o in out],
                  "html": bool(out[0].page_html),
                  "models": [bp.system.layout_task.model_name,
                             bp.system.det_task.model_name,
                             bp.system.rec_task.model_name]}))
"""


def test_backbones_run_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _BACKBONE_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    quads = res.pop("quads")
    assert res == {"bad": [], "pages": 2,
                   "one": ["bboxs", "layout_cells", "subfield_dets"],
                   "texts": {m: [2, 2] for m in (
                       "CRNN", "ConvNextViT", "LightweightEdge")},
                   "errors": [None], "html": True,
                   "models": ["DocXLayout", "db_resnet18", "CRNN"]}
    assert {m: q for m, q in quads.items()} == {
        m: [[4, 2], [4, 2]] for m in (
            "db_resnet18", "db_resnet50", "db_proxylessnas")}


_DIGITAL_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch import read_pdf
from pdf_table_tpu_torch.pdfio import (PdfDocument, PdfWriter,
                                       render_page_vector)
from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
w = PdfWriter()
p = w.add_page(300, 200)
p.text(20, 190, "A page of vector text.", size=9)
p.table(20, 180, [80, 80, 80], 30, [["h1", "h2", "h3"], ["a", "b", "c"]])
data = w.tobytes()
doc = PdfDocument.open(data)
page = doc.load_page(0)
bp = BatchPipeline(OcrSystemConfig(
    layout_model="none", use_orientation_cls=False, use_textline_cls=False,
    table_structure_model="LineCellPdf"), device="cpu")
bp.system._det = OcrDetectionTask(device="cpu", limit_side_len=64,
                                  thresh=0.45, box_thresh=0.0)
img = render_page_vector(doc, page)
out = bp.run([{"image": img, "pdf_page": page, "pdf_doc": doc, "page": 0}])
tables = read_pdf(data, flavor="pdf")
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "PIL", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "is_pdf": out[0].is_pdf,
                  "error": out[0].metric.get("error"),
                  "texts": sorted(c.text for c in out[0].text_cells),
                  "table_html": out[0].table_html,
                  "read_pdf": [t.data for t in tables]}))
"""


def test_digital_lane_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _DIGITAL_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["is_pdf"] and res["error"] is None
    assert res["texts"] == sorted(["A page of vector text.", "h1", "h2",
                                   "h3", "a", "b", "c"])
    assert len(res["table_html"]) == 1 and ">h2</td>" in \
        res["table_html"][0]
    assert res["read_pdf"] == [[["h1", "h2", "h3"], ["a", "b", "c"]]]


_BF16_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask
bf16 = dict(dtype="bfloat16")
rng = np.random.default_rng(0)
finite = []
x = torch.from_numpy(rng.standard_normal((1, 64, 64, 3)).astype(np.float32))
for m in ("PP-OCRv4_det", "db_resnet18", "db_resnet50", "db_proxylessnas"):
    t = OcrDetectionTask(model=m, device="cpu", limit_side_len=64, **bf16)
    with torch.no_grad():
        finite.append(bool(torch.isfinite(t.model(x)["prob"]).all()))
for m in ("PP-OCRv4_rec", "CRNN", "ConvNextViT", "LightweightEdge"):
    t = OcrRecognitionTask(model=m, device="cpu", **bf16)
    h = t.model_config.img_height
    with torch.no_grad():
        finite.append(bool(torch.isfinite(t.model(torch.zeros(1, h, 96, 3))).all()))
cls = ClsImagePulcTask("textline_orientation", device="cpu", **bf16)
finite.append(bool(torch.isfinite(cls.probs(torch.full((1, 48, 192, 3), 99.0))).all()))
pico = OcrLayoutTask(device="cpu", img_height=64, img_width=64,
                     neck_channels=32, head_convs=1, **bf16)
pages = np.full((1, 150, 170, 3), 255, np.uint8)
pages[:, 10:140:20, 10:160] = 20
pages[:, 10:141, 10:160:25] = 20
handle, metas = pico.enqueue(pages)
finite.append(len(pico.finish(handle, metas)) == 1)
lore = dict(resolution=(64, 64), max_objs=8, hidden_size=32, head_conv=16,
            tsfm_layers=1, stacking_layers=1, num_heads=4, max_fmp_size=64,
            d_ff=64)
kw = {"Lore": dict(lore, task_type="wireless", **bf16),
      "SLANet": dict(table_max_len=64, hidden_size=32, max_structure_len=8,
                     **bf16),
      "TableMaster": dict(img_size=(64, 64), d_model=32, decoder_layers=2,
                          heads=4, ff_dim=64, max_structure_len=8, **bf16),
      "MtlTabNet": dict(img_size=(64, 64), d_model=32, decoder_layers=2,
                        heads=4, ff_dim=64, max_structure_len=8, **bf16),
      "Lgpma": dict(backbone_depth=18, fpn_channels=32, rpn_pre_topk=32,
                    num_proposals=16, mask_top=8, fc_dim=64, max_side=64,
                    **bf16),
      "CenterNet": dict(resolution=(64, 64), head_conv=16, K=8, MK=16),
      "LineCell": {}}
crops = [np.ascontiguousarray(pages[0, 5:145, 5:165]),
         np.ascontiguousarray(pages[0, 20:100, 30:120])]
html = []
for model, k in kw.items():
    task = OcrTableStructureTask(model=model, device="cpu", **k)
    for r in task.batch_infer(crops) + [task(crops[1])]:
        html.append(OcrTableToHtmlTask()(r, []).startswith("<table"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "finite": all(finite), "n": len(finite),
                  "html": all(html), "results": len(html)}))
"""


def test_bf16_models_and_crop_surface_run_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _BF16_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "finite": True, "n": 10, "html": True,
                   "results": 21}


_SYSTEM_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.ops import cv_host
from pdf_table_tpu_torch.pdfio import PdfDocument, PdfWriter
from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig, OcrSystemTask
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
from pdf_table_tpu_torch.tasks.layout import OcrLayoutTask
from pdf_table_tpu_torch.tasks.preprocess import rotate_image
from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
page = np.full((300, 260, 3), 255, np.uint8)
for y in range(20, 280, 24):
    page[y:y + 10, 20:200] = 40
page[120:240:24, 30:230] = 20
page[120:240, 30:230:40] = 20
page = rotate_image(page, 3.0)
lore = dict(resolution=(64, 64), max_objs=8, hidden_size=32, head_conv=16,
            tsfm_layers=1, stacking_layers=1, num_heads=4, max_fmp_size=64,
            d_ff=64)
system = OcrSystemTask(OcrSystemConfig(), device="cpu")
system._det = OcrDetectionTask(device="cpu", limit_side_len=96, thresh=0.5,
                               box_thresh=0.0)
system._rec = OcrRecognitionTask(device="cpu", width_buckets=(80,))
system._layout = OcrLayoutTask(device="cpu", task_type="table",
                               img_height=64, img_width=64,
                               score_threshold=0.05)
system._tsr = OcrTableStructureTask(model="Lore", task_type="wireless",
                                    device="cpu", **lore)
w = PdfWriter()
p = w.add_page(300, 400)
for k in range(8):
    p.ops.append(f"BT /F1 11 Tf 0 1 -1 0 {60 + 20 * k} 60 Tm "
                 f"(rotated line {k}) Tj ET")
doc = PdfDocument.open(w.tobytes())
outs = system.ocr([{"image": page},
                   {"pdf_page": doc.load_page(0), "pdf_doc": doc}])
summary = OcrSystemTask.timing_summary(outs)
runs = []
for kw in (dict(device_boxes=False), dict(device_crops=False)):
    bp = BatchPipeline(OcrSystemConfig(use_orientation_cls=False),
                       batch_pages=2, device="cpu", **kw)
    for name in ("_det", "_rec", "_layout", "_tsr"):
        setattr(bp.system, name, getattr(system, name))
    runs.append([bool(o.page_html) and "error" not in o.metric
                 for o in bp.run([{"image": page},
                                  {"pdf_page": doc.load_page(0),
                                   "pdf_doc": doc}])])
contours = cv_host.find_contours(cv_host.rgb_to_grey(page) < 128)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "html": [bool(o.page_html) for o in outs],
                  "angle": abs(outs[0].rotate_angle) > 1.0,
                  "stages": "recognition" in summary and "layout" in summary,
                  "runs": runs, "contours": len(contours) > 5}))
"""


def test_per_page_system_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _SYSTEM_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "html": [True, True], "angle": True,
                   "stages": True, "runs": [[True, True], [True, True]],
                   "contours": True}


_SERVING_SCRIPT = r"""
import contextlib, io, json, os, sys, tempfile, threading, http.client
import numpy as np
import torch
torch.set_num_threads(1)
import pdf_table_tpu_torch.cli.main, pdf_table_tpu_torch.serve
import pdf_table_tpu_torch.engine.infer_task, pdf_table_tpu_torch.models.registry
import pdf_table_tpu_torch.tasks.text_task, pdf_table_tpu_torch.tasks.table_task
import pdf_table_tpu_torch.tasks.result_compare, pdf_table_tpu_torch.eval
import pdf_table_tpu_torch.pipeline.ocr_document
import pdf_table_tpu_torch.utils.debug_render, pdf_table_tpu_torch.utils.profiling
import pdf_table_tpu_torch.utils.xlsx_writer, pdf_table_tpu_torch.utils.math_utils
import pdf_table_tpu_torch.utils.file_utils, pdf_table_tpu_torch.utils.time_utils
import pdf_table_tpu_torch.utils.constants, pdf_table_tpu_torch.utils.logging_utils
from pdf_table_tpu_torch.cli.main import main
from pdf_table_tpu_torch.pdfio import PdfWriter
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.serve import ExtractionService, make_server
from pdf_table_tpu_torch.eval import TEDS
td = tempfile.mkdtemp()
w = PdfWriter()
p = w.add_page(300, 240)
p.text(20, 200, "served page")
p.table(20, 160, [80, 80], 24, [["A", "B"], ["1", "2"]])
pdf = os.path.join(td, "doc.pdf")
w.save(pdf)
with contextlib.redirect_stdout(io.StringIO()):
    rc = main(["--file_path_or_url", pdf, "--output_dir", td,
               "--layout_model", "none"], device="cpu")
html = open(os.path.join(td, "doc.html")).read()
cfg = OcrSystemConfig(use_layout=False, use_orientation_cls=False)
svc = ExtractionService(cfg, batch_pages=2, device="cpu")
srv = make_server(svc, "127.0.0.1", 0)
threading.Thread(target=srv.serve_forever, daemon=True).start()
conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                  timeout=300)
conn.request("POST", "/v1/extract?format=xlsx", open(pdf, "rb").read(),
             {"Content-Type": "application/pdf"})
r = conn.getresponse()
served = json.loads(r.read())
srv.shutdown()
svc.close()
teds = TEDS().evaluate(html, html)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "lxml", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "rc": rc, "table": "<table" in html,
                  "status": r.status, "books": len(served["tables"]),
                  "teds": teds}))
"""


def test_cli_and_service_run_without_jax():
    """A tenth fresh interpreter imports every module of the task surface
    and serving, runs the CLI on a digital PDF and the service on one
    request (its tables as xlsx), with neither JAX, flax, cv2, lxml nor
    the JAX package imported."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _SERVING_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "rc": 0, "table": True, "status": 200,
                   "books": 1, "teds": 1.0}


_QUICK_TRAIN_SCRIPT = r"""
import json, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.models.dbnet.model import DBNet
from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig
from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
from pdf_table_tpu_torch.train.losses import ctc_loss
from pdf_table_tpu_torch.train.quick_det import train_quick_detector

def page(rng, size):
    img = np.full((size, size, 3), 255, np.uint8)
    boxes = []
    for y in range(6, size - 10, 14):
        w = int(rng.integers(10, 30))
        img[y:y + 6, 4:4 + w] = 30
        boxes.append([4, y, 4 + w, y + 6])
    return img, boxes

tree, first, last = train_quick_detector(
    DbNetConfig.ppocr(), page, steps=2, size=64, batch_size=2,
    rng=np.random.default_rng(0), device="cpu")
model = CTCRecModel(RecConfig(svtr_scale=0.25, svtr_dims=32, svtr_hidden=48,
                              svtr_heads=4, vocab_size=40))
logits = model(torch.zeros(2, 48, 64, 3))
loss = ctc_loss(logits, torch.tensor([[1, 2, 0], [3, 0, 0]]),
                torch.tensor([[0., 0., 1.], [0., 1., 1.]]))
loss.backward()
# the converter's ONNX route: Paddle-layout initializers in call order
from pdf_table_tpu_torch.convert.__main__ import main
from pdf_table_tpu_torch.convert.onnx_reader import encode_test_onnx
from pdf_table_tpu_torch.convert.onnx_shape_matcher import call_ordered_slots
from pdf_table_tpu_torch.engine.params import init_dbnet, load_params
cfg = DbNetConfig.ppocr()
template = init_dbnet(cfg)
rng = np.random.default_rng(1)
tensors = {}
for coll, path, kind in call_ordered_slots(DBNet(cfg).eval(),
                                           torch.zeros(1, 64, 64, 3)):
    node = template[coll]
    for k in path.split("/"):
        node = node[k]
    a = rng.standard_normal(np.shape(node)).astype(np.float32)
    if kind == "Conv" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif kind == "ConvTranspose" and a.ndim == 4:
        a = a.transpose(2, 3, 0, 1)
    tensors[f"t{len(tensors)}"] = a
d = tempfile.mkdtemp()
with open(os.path.join(d, "model.onnx"), "wb") as f:
    f.write(encode_test_onnx(tensors))
rc = main(["--model", "pp_det", "--checkpoint", os.path.join(d, "model.onnx"),
           "--out", os.path.join(d, "out")])
conv = load_params(os.path.join(d, "out"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "orbax", "cv2", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "params": "thresh" in tree["params"],
                  "finite": bool(np.isfinite([first, last,
                                              float(loss)]).all()),
                  "rc": rc, "converted": sorted(conv) == [
                      "batch_stats", "params"]}))
"""


def test_quick_trainer_ctc_and_converter_run_without_jax():
    """An eleventh fresh interpreter runs ``train_quick_detector`` two
    steps, a ``ctc_loss`` backward and the converter entry point on an
    ONNX file, with neither JAX, flax, optax, orbax, cv2 nor the JAX
    package imported."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _QUICK_TRAIN_SCRIPT],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "params": True, "finite": True, "rc": 0,
                   "converted": True}


_PARALLEL_SCRIPT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from pdf_table_tpu_torch.parallel import (make_mesh, replicate_params,
                                          shard_batch)
from pdf_table_tpu_torch.parallel.multihost import initialize, shard_bounds
from pdf_table_tpu_torch.parallel.pipeline import (gpipe_apply,
                                                   sequential_apply)
from pdf_table_tpu_torch.train.train_step import TrainState, make_train_step
from pdf_table_tpu_torch.train.optim import ClipAdamW, constant_schedule
from pdf_table_tpu_torch.utils.flops import count_flops
from pdf_table_tpu_torch.utils.profiling import stage
from pdf_table_tpu_torch.ops.deform_conv import deform_conv2d
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.models.dbnet.processor import DbNetPostProcessor

assert initialize(device="cpu") == (0, 1)
mesh = make_mesh(device="cpu")
rows, n = shard_batch({"x": np.ones((3, 2), np.float32)}, mesh)
model = torch.nn.Linear(2, 1)
replicate_params(model, mesh)
stack = {"w": torch.ones(1, 2, 2)}
stage_fn = lambda p, x: x @ p["w"]
pp = make_mesh(axis_names=("pp",), device="cpu")
same = torch.equal(gpipe_apply(stage_fn, stack, torch.ones(3, 1, 2), pp),
                   sequential_apply(stage_fn, stack, torch.ones(3, 1, 2)))
opt = ClipAdamW(constant_schedule(1e-2), 1.0)
step = make_train_step(lambda b: model(b["x"]),
                       lambda out, b: {"loss": ((out - b["y"]) ** 2).sum()
                                       / b["y"].numel()},
                       opt, mesh=mesh)
state, losses = step(TrainState.create(model, opt),
                     {"x": torch.ones(2, 2), "y": torch.zeros(2, 1)})
metrics = {}
x = torch.ones(1, 8, 8, 64)
with stage("dcn", metrics):
    n_dcn, _ = count_flops(deform_conv2d, x, torch.zeros(1, 8, 8, 18),
                           torch.ones(1, 8, 8, 9), torch.ones(3, 3, 64, 64))
n_conv, _ = count_flops(torch.nn.functional.conv2d, torch.ones(1, 4, 8, 8),
                        torch.ones(4, 4, 3, 3), padding=1)
yy, xx = np.mgrid[:64, :96]
prob = np.clip(1.2 - np.hypot((yy - 30) / 12.0, (xx - 40) / 25.0), 0,
               0.99).astype(np.float32)
post = DbNetPostProcessor(DbNetConfig.ppocr(return_polygon=True,
                                            thresh=0.6))
out = post(prob, (128, 192))
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "rows": rows["x"].shape[0], "n": n,
                  "bounds": shard_bounds(5, 1, 2), "pp": same,
                  "step": state.step, "finite": bool(torch.isfinite(
                      losses["loss"])),
                  "dcn": n_dcn == 2 * 64 * 9 * 64 * 64, "conv": n_conv,
                  "stage": "dcn" in metrics,
                  "polygon": out["is_polygon"], "polys": len(
                      out["det_polygons"])}))
"""


def test_parallel_flops_and_polygon_run_without_jax():
    """A twelfth fresh interpreter runs the parallel package on a
    one-process gloo group, the FLOP counts with a stage, and DBNet's
    polygon mode, with neither JAX, flax, cv2 nor the JAX package
    imported."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("WORLD_SIZE", None)
    out = subprocess.run([sys.executable, "-c", _PARALLEL_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "rows": 3, "n": 3, "bounds": [3, 5],
                   "pp": True, "step": 1, "finite": True, "dcn": True,
                   "conv": 2 * 64 * 4 * 4 * 9, "stage": True,
                   "polygon": True, "polys": 1}


_TP_SP_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.multiprocessing as mp


def run(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from pdf_table_tpu_torch.engine.params import init_lore
    from pdf_table_tpu_torch.models.lore.config import LoreConfig
    from pdf_table_tpu_torch.parallel import make_mesh
    from pdf_table_tpu_torch.parallel.multihost import initialize
    from pdf_table_tpu_torch.train.lore_trainer import (LoreTrainArgs,
                                                        LoreTrainer)
    import torch.distributed as dist

    initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout=120)
    cfg = LoreConfig(resolution=(64, 64), max_objs=4, hidden_size=32,
                     head_conv=16, tsfm_layers=1, stacking_layers=1,
                     num_heads=4, max_fmp_size=64, d_ff=64)
    mesh = make_mesh(axis_names=("dp", "tp", "sp"),
                     devices=np.arange(4).reshape(1, 2, 2), device="cpu")
    tr = LoreTrainer(cfg, LoreTrainArgs(batch_size=1, save_every=0,
                                        output_dir=out_dir),
                     mesh=mesh, device="cpu")
    tr.init_state(init_lore(cfg, seed=0))
    rng = np.random.default_rng(0)
    hm = np.zeros((1, 16, 16, 2), np.float32)
    hm[:, 4, 4, 0] = 1.0
    batch = {"image": rng.normal(size=(1, 64, 64, 3)).astype(np.float32),
             "hm": hm, "hm_ind": np.zeros((1, 4), np.int64),
             "hm_mask": np.ones((1, 4), np.float32),
             "wh": np.ones((1, 4, 8), np.float32),
             "reg": np.zeros((1, 4, 2), np.float32),
             "logic": np.ones((1, 4, 4), np.float32),
             "gt_dets": np.ones((1, 4, 8), np.float32)}
    loss = tr.train_step(batch)["loss"]
    bad = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "cv2", "pdf_table_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"bad": bad, "finite": bool(np.isfinite(loss)),
                   "sharded": len(tr.state.sharding.dims),
                   "rows": tr.rows is not None}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(run, args=(4, port, sys.argv[1]), nprocs=4)
    print(json.dumps([json.load(open(os.path.join(sys.argv[1],
                                                  f"rank{r}.json")))
                      for r in range(4)]))
"""


def test_tp_sp_step_runs_without_jax(tmp_path):
    """A thirteenth run: four gloo ranks take a LORE train step on a
    (1, 2, 2) mesh, with neither JAX, flax, optax, cv2 nor the JAX
    package imported on any rank."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1",
               PDF_TABLE_TPU_ALLOW_RANDOM_INIT="quiet")
    env.pop("WORLD_SIZE", None)
    script = tmp_path / "tp_sp_step.py"
    script.write_text(_TP_SP_SCRIPT)
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # dla34's level4/5 convs and the two ida_0 DCNs and their upsample
    # are at least 256 wide
    assert res == [{"bad": [], "finite": True, "sharded": 21,
                    "rows": True}] * 4


_SURFACE_SCRIPT = r"""
import importlib, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
import pdf_table_tpu_torch.entity as E
light = sorted(m for m in sys.modules
               if m.startswith("pdf_table_tpu_torch.models"))
exports = json.loads(sys.argv[1])
unresolved = []
for pkg, names in sorted(exports.items()):
    mod = importlib.import_module(pkg)
    unresolved += [pkg + "." + n for n in names if not hasattr(mod, n)]
merged = E.Line.merge_lines([E.Line(E.Point(0, 5), E.Point(4, 5)),
                             E.Line(E.Point(5, 5), E.Point(9, 5))])
segs = E.Line.merge_segments_1d(np.array([[0, 3], [2, 6], [9, 12]]))
ivs = E.LineInterval.merge_all([E.LineInterval(4, 1), E.LineInterval(3, 7)])
cell = E.OcrCell(raw_data=E.OcrCell.from_bbox([1, 2, 3, 4], "t").to_dict())
ev = E.TableEval(units=[E.TableUnit([0, 0, 1, 1], [0, 0, 1, 1])])
from pdf_table_tpu_torch import ops
from pdf_table_tpu_torch.ops.image import pack_images
from pdf_table_tpu_torch.models.picodet import PicoDetConfig
from pdf_table_tpu_torch.models.picodet.processor import device_decode_nms
from pdf_table_tpu_torch.models.docx_layout.processor import poly_iou
from pdf_table_tpu_torch.pdfio import PdfWriter
from pdf_table_tpu_torch.pdfio.render import render_pdf
from pdf_table_tpu_torch.engine import default_backend
from pdf_table_tpu_torch.utils import print_timings, track_infer_time
rng = np.random.default_rng(0)
imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        for h, w in [(40, 60), (80, 30)]]
buf, hw = pack_images(imgs)
pre, valid = ops.batch_resize_pad_normalize(torch.as_tensor(buf),
                                            torch.as_tensor(hw), (48, 48))
rb = ops.resize_bilinear(torch.as_tensor(imgs[0]), (20, 30))
quads = np.array([[[5, 5], [30, 8], [28, 20], [4, 17]]], np.float32)
crops = ops.crop_rotated_boxes(imgs[0], quads, (16, 32), device="cpu")
mats = ops.perspective_matrices(np.stack([ops.order_points_clockwise(q)
                                          for q in quads]), (16, 32))
warped = ops.warp_perspective_batch(torch.as_tensor(imgs[0]),
                                    torch.as_tensor(mats), (16, 32))
boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60.]])
keep = ops.nms_mask(boxes, torch.tensor([0.9, 0.8, 0.7]))
heat = torch.rand(1, 8, 8, 2)
dec = ops.decode_centernet_bbox(heat, torch.rand(1, 8, 8, 2),
                                torch.rand(1, 8, 8, 2), 4)
mask = torch.zeros(8, 8, dtype=torch.bool)
mask[1:3, 1:3] = True
mask[5:7, 4:8] = True
labels = ops.connected_components(mask)
cfg = PicoDetConfig(img_height=64, img_width=64, score_threshold=0.3)
raw = {"scores": [torch.rand(1, (64 // s) ** 2, cfg.num_classes)
                  for s in cfg.strides],
       "boxes": [torch.randn(1, (64 // s) ** 2, 4 * (cfg.reg_max + 1))
                 for s in cfg.strides]}
packed = device_decode_nms(raw, cfg)
w = PdfWriter()
w.add_page(200, 100).rect(10, 10, 50, 30)
pages = render_pdf(w.tobytes(), dpi=36)
buf_t = []
with track_infer_time(buf_t):
    st = print_timings("surface", [0.001])
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "lxml", "pdf_table_tpu"))
print(json.dumps({
    "bad": bad, "light": light, "unresolved": unresolved,
    "packages": len(exports), "merged": len(merged), "segs": segs.tolist(),
    "ivs": [[iv.start, iv.end] for iv in ivs], "cell": list(cell.bbox),
    "axes": ev.axes().tolist(), "pre": list(pre.shape),
    "valid": valid.tolist(), "rb": list(rb.shape), "crops": list(crops.shape),
    "warp": bool(torch.equal(crops, warped)), "keep": keep.tolist(),
    "dec": list(dec[0].shape), "labels": sorted(set(labels.flatten().tolist())),
    "packed": list(packed.shape), "pages": [list(p[1].shape) for p in pages],
    "iou": poly_iou(np.arange(8.0), np.arange(8.0)),
    "backend": default_backend("cpu"), "timed": len(buf_t),
    "count": st["count"]}))
"""


def test_public_surface_resolves_without_jax():
    """A fourteenth fresh interpreter imports the data model (no model
    module comes with it), resolves every export of the JAX package's
    packages through the port's packages of the same paths, and calls the
    entity and ops names of the public surface on the CPU, with neither
    JAX, flax, cv2, lxml nor the JAX package imported."""
    from test_torch_api_surface import JAX_ROOT, PORT, package_exports

    exports = {}
    for init, names in package_exports(JAX_ROOT).items():
        rel = os.path.dirname(init).replace("/", ".")
        exports[PORT + ("." + rel if rel else "")] = names
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _SURFACE_SCRIPT,
                          json.dumps(exports)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {
        "bad": [], "light": [], "unresolved": [], "packages": len(exports),
        "merged": 1, "segs": [[0.0, 6.0], [9.0, 12.0]], "ivs": [[1, 7]],
        "cell": [1.0, 2.0, 3.0, 4.0], "axes": [[0, 0, 1, 1]],
        "pre": [2, 48, 48, 3], "valid": [[32, 48], [48, 18]],
        "rb": [20, 30, 3], "crops": [1, 16, 32, 3], "warp": True,
        "keep": [True, False, True], "dec": [1, 4, 4], "labels": [0, 10, 45],
        "packed": [1, 5, 85, 5], "pages": [[50, 100, 3]],
        "iou": 1.0, "backend": "cpu", "timed": 1, "count": 1.0}



_SCANNED_SCRIPT = r"""
import contextlib, io, json, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from PIL import Image
from pdf_table_tpu_torch import read_pdf
from pdf_table_tpu_torch.cli.main import main
from pdf_table_tpu_torch.pdfio import PdfDocument, PdfWriter, render_page
from pdf_table_tpu_torch.pipeline.batch_runner import BatchPipeline
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
vec = PdfWriter()
grid = vec.add_page(300, 200)
grid.table(20, 180, [80, 80, 80], 30, [["h1", "h2", "h3"], ["a", "b", "c"]])
img = render_page(PdfDocument.open(vec.tobytes()),
                  PdfDocument.open(vec.tobytes()).load_page(0))
buf = io.BytesIO()
Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
w = PdfWriter()
for ocr in (True, False):
    p = w.add_page(300, 200)
    p.image(buf.getvalue(), 0, 0, 300, 200, img.shape[1], img.shape[0])
    if ocr:
        p.ops += [op.replace("BT ", "BT 3 Tr ", 1) for op in grid.ops
                  if op.startswith("BT ")]
td = tempfile.mkdtemp()
pdf = os.path.join(td, "scan.pdf")
w.save(pdf)
doc = PdfDocument.open(pdf)
bp = BatchPipeline(OcrSystemConfig(
    layout_model="none", use_orientation_cls=False, use_textline_cls=False,
    table_structure_model="LineCellPdf"), device="cpu")
bp.system._det = OcrDetectionTask(device="cpu", limit_side_len=64,
                                  thresh=0.45, box_thresh=0.0)
out = bp.run([{"pdf_page": doc.load_page(i), "pdf_doc": doc, "page": i}
              for i in range(2)])
tables = read_pdf(pdf, flavor="lattice", pages="all")
with contextlib.redirect_stdout(io.StringIO()):
    rc = main(["--file_path_or_url", pdf, "--output_dir", td,
               "--layout_model", "none"], device="cpu")
html = open(os.path.join(td, "scan.html")).read()
import hashlib
from pdf_table_tpu_torch.utils.image_io import decode_image
fixtures = os.path.join("tests", "data", "image_decode")
digests = json.load(open(os.path.join(fixtures, "digests.json")))["files"]
decoded = {}
for name, want in sorted(digests.items()):
    rgb = decode_image(open(os.path.join(fixtures, name), "rb").read())
    got = None if rgb is None else {
        "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
        "shape": list(rgb.shape)}
    decoded[name] = got == want
readers = sorted(m for m in sys.modules if m in (
    "pdf_table_tpu_torch.utils.cv_readers",
    "pdf_table_tpu_torch.utils.codec_libs"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "cv2", "lxml", "pdf_table_tpu"))
print(json.dumps({"bad": bad, "errors": [o.metric.get("error") for o in out],
                  "is_pdf": [o.is_pdf for o in out],
                  "equal": bool(np.array_equal(out[0].image, out[1].image)),
                  "ink": bool(np.abs(out[1].image.astype(int) - img).max() < 40),
                  "tables": [len(o.table_html) for o in out],
                  "read_pdf": [t.data for t in tables], "rc": rc,
                  "pages_html": html.count("<!-- page"),
                  "fixtures": sorted(n for n, ok in decoded.items() if ok),
                  "unequal": sorted(n for n, ok in decoded.items() if not ok),
                  "readers": readers}))
"""


def test_scanned_route_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _SCANNED_SCRIPT], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # every committed decode fixture (the port's own readers of GIF, HDR,
    # PNM, PAM, PFM, Sun rasters, TIFF and JPEG 2000 among them) gives its
    # digest of cv2's decode
    with open(os.path.join(root, "tests", "data", "image_decode",
                           "digests.json")) as f:
        names = sorted(json.load(f)["files"])
    assert res.pop("fixtures") == names and res.pop("unequal") == []
    assert res.pop("readers") == ["pdf_table_tpu_torch.utils.codec_libs",
                                  "pdf_table_tpu_torch.utils.cv_readers"]
    # the OCR'd scan reads its invisible text; the other is an image only
    assert res == {"bad": [], "errors": [None, None],
                   "is_pdf": [True, False], "equal": True, "ink": True,
                   "tables": [0, 0],
                   "read_pdf": [[["h1", "h2", "h3"], ["a", "b", "c"]],
                                [["", "", ""], ["", "", ""]]],
                   "rc": 0, "pages_html": 2}
