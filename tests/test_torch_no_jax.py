"""The port runs its slices with nothing of JAX, flax or pdf_table_tpu
imported: a fresh interpreter imports pdf_table_tpu_torch, runs the tiny
wireless and wtw LORE slices on the CPU down to table HTML, the detection
slice (full width, small detector input) down to page quads and the
recognition lane (full width, 0/180 classifier on, an axis-aligned and a
rotated quad) down to texts, and lists what got imported."""

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
