"""The layout lane as a whole: the same canvas stacks through the JAX
package's ``OcrLayoutTask.batch_enqueue_pages`` + ``batch_finish`` and
through the port's ``OcrLayoutTask.batch_infer_from_pages`` (on the CPU), on
one PicoDet tree at full backbone width with the small input, neck and head
of tests/test_perf_path.py (64x64, neck 32, one head conv), at the three
canvas buckets. The JAX task loads the tree through a monkeypatched
``tasks.layout.load_or_init``.

The resize alone is held to ``jax.image.resize(..., "bilinear")`` within
1e-4 on 0..255: the port applies the same antialiased triangle weights
(``resize_weights``) as two matmuls. Then the cells: the same count, labels
and ``cell_type``, boxes within 1e-3 px of the 64x64 model input (15-25
canvas px a model px: the heads agree to some 1e-6, times the stride 64),
scores within 1e-4, with the device NMS and with the host ``hard_nms``
route (``PDFTABLE_DEVICE_NMS=0``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.layout as jlayout
from pdf_table_tpu_torch.models.picodet.config import PicoDetConfig
from pdf_table_tpu_torch.pipeline.batch_runner import PAGE_BUCKETS
from pdf_table_tpu_torch.tasks.layout import (OcrLayoutTask,
                                              resize_bilinear_aa,
                                              resize_weights)
from test_torch_picodet import normalize, page, picodet_tree

torch.set_num_threads(1)

RESIZE_ATOL = 1e-4
BOX_ATOL = 1e-3       # model-input px
# the inputs differ by f32 sums in another order over up to 32x24 taps, which
# the random net carries to some 5e-5 of a score
SCORE_ATOL = 1e-4
TINY = dict(img_height=64, img_width=64, neck_channels=32, head_convs=1)
# (score_threshold, keep_top_k): bench.py's table arguments, then a deeper
# keep list
THRESHOLDS = [(0.05, 2), (0.3, 12)]


def _stack(bucket, n=2, seed=0):
    """``n`` canvases of one bucket: a page of text strokes padded with
    white, as pack_pages builds them."""
    H, W = bucket
    out = np.full((n, H, W, 3), 255, np.uint8)
    for i in range(n):
        h, w = H - 37 * (i + 1), W - 53 * (i + 1)
        out[i, :h, :w] = page(seed + i, h, w)
    return out


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((1280, 960), (800, 608)), ((1600, 1280), (800, 608)),
    ((2048, 1536), (800, 608)), ((1280, 960), (64, 64)),
    ((480, 368), (800, 608))])
def test_resize_matches_jax_image_resize(src_hw, dst_hw):
    u8 = np.random.default_rng(sum(src_hw)).integers(
        0, 256, (1, *src_hw, 3), dtype=np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(u8, jnp.float32),
                                       (1, *dst_hw, 3), "bilinear"))
    got = resize_bilinear_aa(torch.from_numpy(u8), dst_hw)
    assert tuple(got.shape) == (1, *dst_hw, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL, rtol=0)


def test_resize_weights_rows_are_normalized():
    for n_in, n_out in ((1280, 800), (960, 608), (368, 608)):
        w = resize_weights(n_in, n_out)
        assert w.shape == (n_in, n_out) and w.dtype == np.float32
        np.testing.assert_allclose(w.sum(0), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def tree():
    """Calibrated on two canvases of each bucket at the model's input:
    the stride-32 and -64 maps are 2x2 and 1x1, so a batch of one would
    give their BatchNorm a variance of 0."""
    cfg = PicoDetConfig(task_type="table", **TINY)
    x = np.concatenate([
        resize_bilinear_aa(torch.from_numpy(_stack(b, 2, 5)), (64, 64))
        .numpy() for b in PAGE_BUCKETS])
    return picodet_tree(cfg, normalize(x.round().astype(np.uint8)))


@pytest.fixture(scope="module")
def jtask(tree):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayout, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, tree))
        task = jlayout.OcrLayoutTask(model="picodet", task_type="table",
                                     **TINY)
        task.ensure_built()
    return task


def _cells(cells):
    return [(c.label, c.text, c.cell_type.name, c.bbox, c.score)
            for c in cells]


def _assert_same_cells(got, want, canvas_px):
    assert len(got) == len(want)
    for g_page, w_page in zip(got, want):
        g, w = _cells(g_page), _cells(w_page)
        assert [c[:3] for c in g] == [c[:3] for c in w]
        if g:
            np.testing.assert_allclose([c[3] for c in g], [c[3] for c in w],
                                       atol=BOX_ATOL * canvas_px, rtol=0)
            np.testing.assert_allclose([c[4] for c in g], [c[4] for c in w],
                                       atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("device_nms", [True, False],
                         ids=["device_nms", "host_nms"])
@pytest.mark.parametrize("bucket", PAGE_BUCKETS,
                         ids=["x".join(map(str, b)) for b in PAGE_BUCKETS])
def test_lane_matches_jax(tree, jtask, bucket, device_nms, monkeypatch):
    monkeypatch.setenv("PDFTABLE_DEVICE_NMS", "1" if device_nms else "0")
    pages = _stack(bucket, seed=sum(bucket))
    n_cells = 0
    for thr, keep in THRESHOLDS:
        jtask.model_config.score_threshold = thr
        jtask.model_config.keep_top_k = keep
        jtask._jitted = {k: v for k, v in jtask._jitted.items()
                         if k[0] != "pages_nms"}
        want = jtask.batch_finish(*jtask.batch_enqueue_pages(
            jnp.asarray(pages)))
        task = OcrLayoutTask(device="cpu", variables=tree, task_type="table",
                             score_threshold=thr, keep_top_k=keep, **TINY)
        assert task.device_nms == device_nms
        got = task.batch_infer_from_pages(pages)
        _assert_same_cells(got, want, max(bucket) / min(TINY["img_height"],
                                                        TINY["img_width"]))
        assert all(len(p) <= keep for p in got)
        n_cells += sum(len(p) for p in got)
        for p in got:
            assert all(c.cell_type.name == "TABLE" and c.label == "table"
                       for c in p)
    assert n_cells > 2 * len(pages), "too few layout cells to compare"


def test_resident_tensor_is_not_copied(tree):
    task = OcrLayoutTask(device="cpu", variables=tree, task_type="table",
                         **TINY)
    pages = torch.from_numpy(_stack(PAGE_BUCKETS[0]))
    seen = []
    real = task.preprocess
    task.preprocess = lambda p: (seen.append(p.data_ptr()), real(p))[1]
    handle, metas = task.enqueue(pages)
    assert seen == [pages.data_ptr()]
    # 85 candidates at 64x64 (8x8 + 4x4 + 2x2 + 1), fewer than keep_top_k
    assert tuple(handle.shape) == (2, 1, 85, 5)
    assert metas[0]["org_shape"] == PAGE_BUCKETS[0]
    assert len(task.finish(handle, metas)) == 2


def test_bench_arguments_and_device_policy(monkeypatch):
    task = OcrLayoutTask(model="picodet", device="cpu", task_type="table",
                         score_threshold=0.05, keep_top_k=2, **TINY)
    cfg = task.model_config
    assert (cfg.task_type, cfg.score_threshold, cfg.keep_top_k,
            cfg.num_classes) == ("table", 0.05, 2, 1)
    assert OcrLayoutTask(device="cpu", dtype="bfloat16", **TINY) \
        .model.dtype == torch.bfloat16
    # DocXLayout is ported since the ninth slice
    # (tests/test_torch_docx_layout.py); another name raises, naming the
    # models the port has
    with pytest.raises(NotImplementedError, match="DocXLayout"):
        OcrLayoutTask(model="layoutlmv3", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OcrLayoutTask(**TINY)
