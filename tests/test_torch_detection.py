"""The detection slice as a whole: the same synthetic pages through the JAX
package's ``BatchPipeline`` detection lane (``_detect_enqueue`` for the
uint8 prob maps, ``_detect_cc_enqueue`` + ``_boxes_finish`` for the quads)
and through the port's ``OcrDetectionTask.batch_infer_from_pages``, on the
same PP-OCRv4 weights at full width (the port on the CPU).
``limit_side_len=128`` keeps the detector input small. The threshold sits
at the 80th percentile of the first page's map, so that random weights
give some ten to thirty components a page (at the median, the pixels
above it join into one page-wide component)."""

import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.pipeline.batch_runner as jbr
import pdf_table_tpu.tasks.detection as jdet
from pdf_table_tpu.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.engine.params import init_dbnet
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.pipeline import batch_runner as tbr
from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask

torch.set_num_threads(1)

CFG = dict(limit_side_len=128, box_thresh=0.0)
# share of u8 map pixels allowed off by one (f32 sums in another order can
# put a prob on the other side of a rounding boundary)
OFF_BY_ONE_MAX = 1e-4


def _page(seed, h, w):
    """Dark word bars on white, as chip_smoke.make_page draws them."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    for y in range(30, h - 30, int(rng.integers(26, 40))):
        x = 40
        while x < w - 200:
            ww = int(rng.integers(60, 160))
            img[y:y + 16, x:x + ww] = rng.integers(20, 60, 3)
            x += ww + 18
    return img


PAGES = [_page(0, 1224, 950), _page(1, 1500, 1100), _page(2, 700, 820)]


@pytest.fixture(scope="module", params=[True, False],
                ids=["half_res", "full_res"])
def lanes(request):
    """(JAX BatchPipeline, port task) on one weight tree, with prob maps
    pooled to half resolution or not."""
    v = init_dbnet(DbNetConfig.ppocr(**CFG), seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        bp = jbr.BatchPipeline(OcrSystemConfig(use_layout=False,
                                               use_table=False),
                               half_res_probs=request.param)
        bp.system._det = jdet.OcrDetectionTask(model="PP-OCRv4_det", **CFG)
        bp.system._det.ensure_built()
    task = OcrDetectionTask(device="cpu", variables=v,
                            half_res_probs=request.param, **CFG)
    return bp, task


def _jax_maps(bp, bucket, g):
    cfg = bp.system.det_task.model_config
    det_hw = jbr.det_input_size(bucket, cfg.limit_side_len)
    return np.asarray(bp._detect_enqueue(g["images"], g["images"].shape,
                                         det_hw, False)), det_hw


def _port_maps(task, bucket, g):
    with torch.inference_mode():
        x = task.normalize(torch.from_numpy(g["images"]),
                           task.det_size(bucket))
        return task.quantize(task.model(x)["prob"]).numpy()


def test_slice_matches_jax(lanes):
    bp, task = lanes
    groups = jbr.pack_pages(PAGES)
    assert sorted(groups) == sorted(tbr.pack_pages(PAGES))
    maps = {b: _jax_maps(bp, b, g) for b, g in groups.items()}
    first = maps[min(groups)][0][0]
    thresh = float(np.percentile(first, 80)) / 255.0
    bp.system.det_task.model_config.thresh = thresh
    task.model_config.thresh = thresh

    want = [None] * len(PAGES)
    equal_maps = set()
    for b, g in groups.items():
        jmaps, det_hw = maps[b]
        tmaps = _port_maps(task, b, g)
        assert tmaps.shape == jmaps.shape
        diff = np.abs(tmaps.astype(int) - jmaps.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= OFF_BY_ONE_MAX
        handle, prob_hw = bp._detect_cc_enqueue(
            g["images"], g["images"].shape, det_hw, False, g["shapes"], b)
        quads = bp._boxes_finish(np.asarray(handle), g["shapes"], b,
                                 prob_hw)
        for j, (i, q) in enumerate(zip(g["indices"], quads)):
            want[i] = q
            if not diff[j].any():
                equal_maps.add(i)

    got = task.batch_infer_from_pages(PAGES)
    assert len(got) == len(PAGES)
    assert min(len(q) for q in want) >= 5, "too few boxes to compare"
    for i, (g_q, w_q) in enumerate(zip(got, want)):
        assert g_q.dtype == np.float32 and g_q.shape[1:] == (4, 2)
        if i in equal_maps:
            np.testing.assert_array_equal(g_q, w_q)
        else:
            assert abs(len(g_q) - len(w_q)) <= 1
    assert equal_maps, "no page with equal maps"


def test_valid_extents_match_jax():
    shapes = [(1224, 950), (700, 820), (1, 1)]
    want = jbr.BatchPipeline._valid_extents(shapes, (1280, 960), (64, 48), 3)
    got = OcrDetectionTask._valid_extents(shapes, (1280, 960), (64, 48))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(500, 400), (1280, 960), (1281, 960),
                                (1600, 1280), (1700, 900), (2048, 1536)])
def test_buckets_and_det_sizes_match_jax(hw):
    assert tbr.pick_page_bucket(*hw) == jbr.pick_page_bucket(*hw)
    b = tbr.pick_page_bucket(*hw)
    for limit in (128, 960, 4000):
        assert tbr.det_input_size(b, limit) == jbr.det_input_size(b, limit)


def test_pack_pages_matches_jax():
    got = tbr.pack_pages(PAGES)
    want = jbr.pack_pages(PAGES)
    assert sorted(got) == sorted(want)
    for b in want:
        assert got[b]["indices"] == want[b]["indices"]
        assert got[b]["shapes"] == want[b]["shapes"]
        np.testing.assert_array_equal(got[b]["images"], want[b]["images"])


def test_oversize_page_raises():
    """An oversize page no longer raises: ``pack_pages`` scales it to fit
    the largest bucket as the JAX package's does (cv2.resize), bit for
    bit."""
    rng = np.random.default_rng(0)
    pages = [rng.integers(0, 256, (2100, 800, 3), dtype=np.uint8),
             rng.integers(0, 256, (4096, 3072, 3), dtype=np.uint8)]
    got = tbr.pack_pages(pages)
    want = jbr.pack_pages(pages)
    assert sorted(got) == sorted(want) == [(2048, 1536)]
    g, w = got[(2048, 1536)], want[(2048, 1536)]
    assert g["shapes"] == w["shapes"] == [(2048, 780), (2048, 1536)]
    np.testing.assert_array_equal(g["images"], w["images"])


def test_runs_on_cuda_by_default(monkeypatch):
    """Without a card the task raises unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OcrDetectionTask(**CFG)


def test_other_models_are_not_ported():
    """db_resnet18 builds in f32 since the ninth slice and in bf16 since
    the twelfth; an unknown name raises, naming the model."""
    assert OcrDetectionTask(model="db_resnet18", device="cpu",
                            **CFG).model_config.backbone == "resnet18"
    task = OcrDetectionTask(model="db_resnet18", device="cpu",
                            dtype="bfloat16")
    assert task.model.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="db_mobilenet"):
        OcrDetectionTask(model="db_mobilenet", device="cpu")
