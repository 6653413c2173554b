"""The port's ModelScope DBNets (``db_resnet18``, ``db_resnet50``: ResNet +
the SegDetector FPN; ``db_proxylessnas``: the searched NAS backbone, the
LightSeg sum and head) against the JAX package at full width on the CPU:
the trees equal in shape, the prob maps within 1e-5 of flax's on the
detection lane's own input, and the lane as a whole (the modelscope
normalization through the resize+normalize kernel's plain version, the
2x2 max-pool, uint8 maps and the connected-component boxes) against the
JAX ``BatchPipeline`` detection lane: maps off by at most one grey level
on at most 1e-4 of the pixels, quads equal where the maps are, as
tests/test_torch_detection.py holds PP-OCRv4. ``limit_side_len=128``
keeps the detector input small (128 x 96 for the 1280x960 bucket).

The trees: ``init_dbnet``, BatchNorm statistics calibrated on the lane's
input with the variances doubled (a deep random ReLU stack is chaotic
otherwise, as DLA's and TableMaster's are)."""

import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.pipeline.batch_runner as jbr
import pdf_table_tpu.tasks.detection as jdet
from pdf_table_tpu.models.dbnet import DBNet as JDBNet
from pdf_table_tpu.models.registry import get_config
from pdf_table_tpu.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_dbnet,
                                               scale_batch_variances)
from pdf_table_tpu_torch.models.dbnet.model import DBNet
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask, det_config
from test_torch_detection import _page

torch.set_num_threads(1)

MODELS = ("db_resnet18", "db_resnet50", "db_proxylessnas")
CFG = dict(limit_side_len=128, box_thresh=0.0)
PROB_TOL = 1e-5
OFF_BY_ONE_MAX = 1e-4
VAR_GAIN = 2.0
PAGES = [_page(0, 1224, 950), _page(3, 1100, 900)]


@pytest.fixture(scope="module", params=MODELS)
def setup(request):
    model = request.param
    task = OcrDetectionTask(model=model, device="cpu", **CFG)
    canv = torch.from_numpy(np.stack([
        np.pad(p, ((0, 1280 - p.shape[0]), (0, 960 - p.shape[1]), (0, 0)),
               constant_values=255) for p in PAGES]))
    with torch.no_grad():
        x = task.normalize(canv, task.det_size((1280, 960)))
    v = scale_batch_variances(calibrate_batch_stats(
        DBNet(task.model_config), init_dbnet(task.model_config, 0), x),
        VAR_GAIN)
    return model, v, x.numpy()


def test_configs_match_the_registry():
    for model in MODELS:
        assert vars(det_config(model, **CFG)) == \
            vars(get_config("detection", model, **CFG))
    assert det_config("db_proxylessnas").inner_channels == 64


def test_init_dbnet_has_the_flax_tree(setup):
    model, v, x = setup
    want = jax.eval_shape(JDBNet(get_config("detection", model, **CFG)).init,
                          jax.random.PRNGKey(0), x[:1])
    assert {p: tuple(a.shape) for p, a in tree_leaves(v)} == \
        {p: tuple(a.shape) for p, a in tree_leaves(want)}


def test_prob_matches_flax(setup):
    model, v, x = setup
    want = np.asarray(JDBNet(get_config("detection", model, **CFG)).apply(
        v, x)["prob"])
    net = DBNet(det_config(model, **CFG)).eval()
    load_flax_variables(net, v)
    with torch.no_grad():
        got = net(torch.from_numpy(x))["prob"].numpy()
    assert got.shape == want.shape == x.shape[:3]
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    assert float(want.std()) > 1e-2, "a flat prob map"


def test_lane_matches_jax(setup):
    model, v, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        bp = jbr.BatchPipeline(OcrSystemConfig(use_layout=False,
                                               use_table=False))
        bp.system._det = jdet.OcrDetectionTask(model=model, **CFG)
        bp.system._det.ensure_built()
    task = OcrDetectionTask(model=model, device="cpu", variables=v, **CFG)
    (bucket, g), = jbr.pack_pages(PAGES).items()
    det_hw = jbr.det_input_size(bucket, CFG["limit_side_len"])
    assert det_hw == task.det_size(bucket) == (128, 96)
    jmaps = np.asarray(bp._detect_enqueue(g["images"], g["images"].shape,
                                          det_hw, False))
    with torch.inference_mode():
        tmaps = task.quantize(task.model(task.normalize(
            torch.from_numpy(g["images"]), det_hw))["prob"]).numpy()
    diff = np.abs(tmaps.astype(int) - jmaps.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= OFF_BY_ONE_MAX
    # a threshold at the 80th percentile: some ten to thirty components
    thresh = float(np.percentile(jmaps[0], 80)) / 255.0
    bp.system.det_task.model_config.thresh = thresh
    task.model_config.thresh = thresh
    handle, prob_hw = bp._detect_cc_enqueue(
        g["images"], g["images"].shape, det_hw, False, g["shapes"], bucket)
    want = bp._boxes_finish(np.asarray(handle), g["shapes"], bucket, prob_hw)
    got = task.batch_infer_from_pages(PAGES)
    assert min(len(q) for q in want) >= 3, "too few boxes to compare"
    compared = 0
    for j, (gq, wq) in enumerate(zip(got, want)):
        if not diff[j].any():
            np.testing.assert_array_equal(gq, wq)
            compared += 1
        else:
            assert abs(len(gq) - len(wq)) <= 1
    assert compared, "no page with equal maps"
