"""The token models' crop sampler (pdf_table_tpu_torch/ops/crop_resize.py)
against ``cv2.resize`` (INTER_LINEAR, uint8), which the JAX pre-processors
call on host crops: bit for bit (tolerance 0 grey levels) over upscales,
downscales, the exact 2x downscale (where OpenCV takes its area path) and
one-pixel edges; then the batched device form on windows of a page stack,
and SLANet's and TableMaster's pre-processors (resize, normalize and pad
in their own orders) against the JAX ones on the same images, and the
task's device crops against both."""

import cv2
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.slanet import SLANetConfig as JSLANetConfig
from pdf_table_tpu.models.slanet import SLANetPreProcessor as JSLANetPre
from pdf_table_tpu.models.table_master import \
    TableMasterConfig as JMasterConfig
from pdf_table_tpu.models.table_master import \
    TableMasterPreProcessor as JMasterPre
from pdf_table_tpu_torch.models.slanet.config import SLANetConfig
from pdf_table_tpu_torch.models.slanet.processor import SLANetPreProcessor
from pdf_table_tpu_torch.models.table_master.config import \
    TableMasterConfig
from pdf_table_tpu_torch.models.table_master.processor import \
    TableMasterPreProcessor
from pdf_table_tpu_torch.ops.crop_resize import (crop_resize_u8, crop_taps,
                                                 crop_windows,
                                                 resize_u8_plain)
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask

torch.set_num_threads(1)

# (h, w) -> (nh, nw): up, down, mixed, exact 2x down, 1-px edges, the
# models' own sizes
SIZES = [((37, 53), (91, 130)), ((300, 411), (356, 488)),
         ((500, 333), (488, 325)), ((600, 900), (320, 480)),
         ((120, 80), (480, 320)), ((100, 200), (50, 100)),
         ((64, 64), (32, 32)), ((1, 7), (3, 21)), ((9, 1), (4, 1)),
         ((77, 77), (488, 488)), ((2, 2), (480, 480))]


def _image(h, w, seed=0):
    return np.random.default_rng(seed + h * 1000 + w).integers(
        0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("src,dst", SIZES)
def test_plain_resize_is_cv2(src, dst):
    img = _image(*src)
    want = cv2.resize(img, (dst[1], dst[0])).reshape(*dst, 3)
    np.testing.assert_array_equal(resize_u8_plain(img, *dst), want)


def test_plain_resize_is_cv2_on_random_sizes():
    rng = np.random.default_rng(7)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(1, 160, 2))
        nh, nw = (int(v) for v in rng.integers(1, 260, 2))
        img = _image(h, w, 1)
        want = cv2.resize(img, (nw, nh)).reshape(nh, nw, 3)
        np.testing.assert_array_equal(resize_u8_plain(img, nh, nw), want,
                                      err_msg=str((h, w, nh, nw)))


PAGES = np.stack([_image(260, 300, s) for s in range(3)])
REGIONS = [(0, (10, 20, 200, 150)), (1, (0, 0, 300, 260)),
           (2, (5, 7, 105, 57)), (1, (50, 60, 53, 62)),
           (0, (250.7, 3.2, 400, 259.9))]       # float ends, clipped at W


def test_batched_crops_are_cv2_of_the_windows():
    wins = crop_windows(PAGES.shape[1:3], REGIONS)
    assert wins[-1] == (0, 250, 3, 300, 259)
    out_hw = (488, 488)
    sizes = [SLANetPreProcessor(SLANetConfig()).plan(y2 - y1, x2 - x1)[:2]
             for _, x1, y1, x2, y2 in wins]
    taps = torch.from_numpy(crop_taps(wins, sizes, out_hw))
    got = crop_resize_u8(torch.from_numpy(PAGES), taps, out_hw).numpy()
    for g, (pi, x1, y1, x2, y2), (nh, nw) in zip(got, wins, sizes):
        crop = PAGES[pi][y1:y2, x1:x2]
        np.testing.assert_array_equal(g[:nh, :nw],
                                      cv2.resize(crop, (nw, nh)))
        assert not g[nh:].any() and not g[:, nw:].any()


def test_windows_reject_empty_crops():
    with pytest.raises(ValueError):
        crop_windows((100, 100), [(0, (50, 10, 50, 40))])


@pytest.mark.parametrize("src", [(130, 221), (480, 96), (35, 35)])
def test_slanet_pre_matches_jax(src):
    img = _image(*src, seed=3)
    want = JSLANetPre(JSLANetConfig())(img)
    got = SLANetPreProcessor(SLANetConfig())(img)
    assert got["shape_list"] == want["shape_list"]
    np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("src", [(130, 221), (480, 96), (35, 35)])
def test_table_master_pre_matches_jax(src):
    img = _image(*src, seed=4)
    want = JMasterPre(JMasterConfig())(img)
    got = TableMasterPreProcessor(TableMasterConfig())(img)
    assert got["meta"] == want["meta"]
    np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("model", ["SLANet", "TableMaster"])
def test_task_crops_match_the_host_pre(model):
    """The task's device crops (window, sampler, normalize, pad) equal the
    JAX pre-processor on the host crop, bit for bit."""
    kw = dict(hidden_size=32, max_structure_len=2) if model == "SLANet" \
        else dict(d_model=32, decoder_layers=1, heads=4, ff_dim=64,
                  max_structure_len=2)
    task = OcrTableStructureTask(model=model, device="cpu", **kw)
    jpre = JSLANetPre(JSLANetConfig()) if model == "SLANet" \
        else JMasterPre(JMasterConfig())
    (sub, metas, x), = task.sub_batches(PAGES, REGIONS)
    assert sub == list(range(len(REGIONS)))
    for (pi, x1, y1, x2, y2), meta, xi in zip(
            crop_windows(PAGES.shape[1:3], REGIONS), metas, x):
        want = jpre(PAGES[pi][y1:y2, x1:x2])
        want_meta = want.get("shape_list") or want["meta"]["shape_list"]
        assert meta == want_meta
        np.testing.assert_array_equal(xi.numpy(), want["image"][0])


@pytest.mark.cuda
def test_device_crops_match_the_cpu_on_card():
    """Runs on a machine with the card: python -m pytest -m cuda. Integer
    arithmetic: the card's bytes are the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wins = crop_windows(PAGES.shape[1:3], REGIONS)
    sizes = [(480, 400)] * len(wins)
    taps = torch.from_numpy(crop_taps(wins, sizes, (480, 480)))
    cpu = crop_resize_u8(torch.from_numpy(PAGES), taps, (480, 480))
    dev = crop_resize_u8(torch.from_numpy(PAGES).cuda(), taps.cuda(),
                         (480, 480))
    torch.testing.assert_close(dev.cpu(), cpu, rtol=0, atol=0)
