"""The device ops of the public surface, held to the JAX package: from
tests/test_ops.py ``TestResize``, ``TestWarp::test_order_points``,
``TestNms``, ``TestCenterNetDecode`` and ``TestConnectedComponents``, with
``warp_perspective_batch``, ``perspective_matrices``, ``nms_mask`` and
``decode_centernet_bbox`` beside them; tests/test_layout_tsr.py's
``device_decode_nms`` case; DocXLayout's ``poly_iou``; and the native
``render_pdf`` case of tests/test_pdfio.py (its Ghostscript cases are in
tests/test_torch_scanned_pdf.py). Both packages get the same
inputs, made from a seed with numpy.

Tolerances: labels, masks and NMS survivors equal; warps and resizes
within 1e-4 grey levels (the normalized outputs within 1e-4 over
255 * std); the decodes within 1e-5; rasters bit-equal.
"""

from __future__ import annotations

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdf_table_tpu.ops as J
import pdf_table_tpu_torch.ops as T

torch.set_num_threads(1)

GREY = 1e-4
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# --- resize, pad, normalize -------------------------------------------------


def test_resize_bilinear_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
    for out_hw, src_hw in (((64, 96), None), ((20, 31), None),
                           ((50, 70), (30, 41))):
        want = np.asarray(J.resize_bilinear(jnp.asarray(img), out_hw, src_hw))
        got = T.resize_bilinear(_t(img), out_hw, src_hw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=GREY)
    # tests/test_ops.py: within 1.5 of cv2's INTER_LINEAR
    ref = cv2.resize(img.astype(np.float32), (96, 64),
                     interpolation=cv2.INTER_LINEAR)
    assert np.abs(T.resize_bilinear(_t(img), (64, 96)).numpy() - ref).max() \
        < 1.5


def test_normalize_image_matches_jax():
    x = np.random.default_rng(1).uniform(0, 255, (20, 30, 3)) \
        .astype(np.float32)
    want = np.asarray(J.normalize_image(jnp.asarray(x), MEAN, STD))
    np.testing.assert_array_equal(
        T.normalize_image(_t(x), MEAN, STD).numpy(), want)


def test_resize_pad_normalize_keep_ratio():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (100, 50, 3), dtype=np.uint8)
    kw = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
    jo, jv = J.resize_pad_normalize(jnp.asarray(img), (100, 50), (64, 64),
                                    **kw)
    out, valid = T.resize_pad_normalize(_t(img), (100, 50), (64, 64), **kw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=0,
                               atol=GREY / (255 * 0.5))
    out = out.numpy()
    assert out.shape == (64, 64, 3)
    assert tuple(valid.tolist()) == (64, 32)
    assert np.all(out[:, 32:] == 0)
    assert -1.01 <= out[:, :32].min() and out[:, :32].max() <= 1.01


@pytest.mark.parametrize("keep_ratio", [True, False])
def test_batch_pack_and_preprocess(keep_ratio):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in [(40, 60), (80, 30), (64, 64), (37, 53)]]
    from pdf_table_tpu.ops.image import pack_images as jax_pack
    from pdf_table_tpu_torch.ops.image import pack_images

    buf, hw = pack_images(imgs)
    jbuf, jhw = jax_pack(imgs)
    np.testing.assert_array_equal(buf, jbuf)
    np.testing.assert_array_equal(hw, jhw)
    assert buf.shape[0] == 4 and buf.shape[1] % 32 == 0
    for out_hw in ((48, 48), (33, 71)):
        jo, jv = J.batch_resize_pad_normalize(
            jnp.asarray(buf), jnp.asarray(hw), out_hw, keep_ratio=keep_ratio)
        out, valid = T.batch_resize_pad_normalize(
            _t(buf), _t(hw), out_hw, keep_ratio=keep_ratio)
        assert out.shape == (4, *out_hw, 3) and valid.shape == (4, 2)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=0,
                                   atol=GREY / (255 * min(STD)))


# --- warps ------------------------------------------------------------------


def test_order_points_and_matrices_match_jax():
    quad = np.array([[10, 10], [50, 12], [48, 40], [8, 42]], np.float32)
    ordered = T.order_points_clockwise(quad[[2, 0, 3, 1]])
    np.testing.assert_allclose(ordered, quad)
    rng = np.random.default_rng(4)
    quads = rng.uniform(0, 100, (12, 4, 2)).astype(np.float32)
    for q in quads:
        np.testing.assert_array_equal(T.order_points_clockwise(q),
                                      J.order_points_clockwise(q))
    ordered = np.stack([T.order_points_clockwise(q) for q in quads])
    np.testing.assert_array_equal(T.perspective_matrices(ordered, (16, 48)),
                                  J.perspective_matrices(ordered, (16, 48)))
    assert T.perspective_matrices(quads[:0], (16, 48)).shape == (0, 3, 3)


def _quads(rng, n, h, w):
    """Rotated rectangles about random centers, some reaching off the
    image."""
    out = []
    for _ in range(n):
        c = rng.uniform(0, 1, 2) * (w, h)
        size = rng.uniform(8, 40, 2)
        out.append(cv2.boxPoints((tuple(c), tuple(size),
                                  float(rng.uniform(-40, 40)))))
    return np.stack([J.order_points_clockwise(q) for q in out])


def test_warp_perspective_batch_matches_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (60, 90, 3), dtype=np.uint8)
    for out_hw in ((16, 48), (32, 32)):
        mats = J.perspective_matrices(_quads(rng, 10, 60, 90), out_hw)
        want = np.asarray(J.warp_perspective_batch(jnp.asarray(img),
                                                   jnp.asarray(mats), out_hw))
        got = T.warp_perspective_batch(_t(img), _t(mats), out_hw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=GREY)


def test_crop_rotated_boxes_at_one_size_matches_jax():
    """tests/test_ops.py's rotated crop, in a batch of three. XLA on the
    CPU sums the homography's 3-term dot as a chain of fused multiply-adds
    from three crops on and as plain f32 sums for one crop, so JAX's crop
    moves by a coordinate ulp with the batch size (up to 2e-4 grey levels
    on this image). The port always takes the chain, as
    ``warp_crops_from_pages`` does, and its crop does not depend on the
    batch."""
    rng = np.random.default_rng(6)
    img = cv2.GaussianBlur(rng.integers(0, 255, (120, 120, 3),
                                        dtype=np.uint8), (5, 5), 2)
    quad = T.order_points_clockwise(cv2.boxPoints(((60, 60), (60, 30), 25)))
    quads = np.concatenate([quad[None], _quads(rng, 2, 120, 120)])
    got = T.crop_rotated_boxes(img, quads, (30, 60), device="cpu")
    want = np.asarray(J.crop_rotated_boxes(img, quads, (30, 60)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GREY)
    one = T.crop_rotated_boxes(img, quad[None], (30, 60), device="cpu")
    np.testing.assert_array_equal(one.numpy()[0], got.numpy()[0])
    # tests/test_ops.py: the interior agrees with cv2.warpPerspective
    m = cv2.getPerspectiveTransform(quad, np.array(
        [[0, 0], [60, 0], [60, 30], [0, 30]], np.float32))
    ref = cv2.warpPerspective(img.astype(np.float32), m, (60, 30))
    assert np.abs(one.numpy()[0][4:-4, 4:-4] - ref[4:-4, 4:-4]).mean() < 6.0
    empty = T.crop_rotated_boxes(img, np.zeros((0, 4, 2)), (30, 60),
                                 device="cpu")
    assert empty.shape == (0, 30, 60, 3)
    assert T.crop_rotated_boxes(img, np.zeros((0, 4, 2))) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.crop_rotated_boxes(img, quad[None], (30, 60))


# --- NMS --------------------------------------------------------------------


def test_hard_nms_cases():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    for mod in (J, T):
        assert list(mod.hard_nms(boxes, scores, iou_threshold=0.5)[2]) \
            == [0, 2]
        assert list(mod.hard_nms(boxes[[0, 2]], np.array([0.9, 0.05]),
                                 score_threshold=0.1)[2]) == [0]
        assert len(mod.hard_nms(np.zeros((0, 4)), np.zeros((0,)))[2]) == 0


def _boxes(rng, n, span=100.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(2, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("n, iou, thr", [(3, 0.5, 0.0), (40, 0.3, 0.2),
                                         (120, 0.5, 0.0), (60, 0.1, 0.5)])
def test_nms_mask_matches_jax(n, iou, thr):
    rng = np.random.default_rng(n)
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    want = np.asarray(J.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                 iou, thr))
    got = T.nms_mask(_t(boxes), _t(scores), iou, thr).numpy()
    np.testing.assert_array_equal(got, want)
    # the greedy keep set is hard_nms's
    idx = T.hard_nms(boxes, scores, iou, thr)[2]
    np.testing.assert_array_equal(np.flatnonzero(got), np.sort(idx))


# --- CenterNet decode -------------------------------------------------------


def test_heatmap_nms_keeps_peak():
    h = np.zeros((1, 8, 8, 1), np.float32)
    h[0, 3, 3, 0] = 0.9
    h[0, 3, 4, 0] = 0.5
    out = T.heatmap_nms(_t(h)).numpy()
    np.testing.assert_array_equal(out, np.asarray(J.heatmap_nms(
        jnp.asarray(h))))
    assert out[0, 3, 3, 0] == pytest.approx(0.9) and out[0, 3, 4, 0] == 0.0


def test_decode_boxes_4ps_case():
    heat = np.zeros((1, 16, 16, 2), np.float32)
    heat[0, 5, 7, 0] = 0.95
    wh = np.zeros((1, 16, 16, 8), np.float32)
    wh[0, 5, 7] = [3, 2, -3, 2, -3, -2, 3, -2]
    reg = np.zeros((1, 16, 16, 2), np.float32)
    reg[0, 5, 7] = [0.25, 0.5]
    got = T.decode_boxes_4ps(_t(heat), _t(wh), _t(reg), k=4)
    want = J.decode_boxes_4ps(jnp.asarray(heat), jnp.asarray(wh),
                              jnp.asarray(reg), k=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    cx, cy = 7.25, 5.5
    np.testing.assert_allclose(
        got[0].numpy()[0, 0],
        [cx - 3, cy - 2, cx + 3, cy - 2, cx + 3, cy + 2, cx - 3, cy + 2],
        atol=1e-5)


@pytest.mark.parametrize("b, h, w, c, k", [(1, 16, 16, 1, 8),
                                           (2, 24, 20, 3, 32),
                                           (1, 4, 4, 2, 40)])
def test_decode_centernet_bbox_matches_jax(b, h, w, c, k):
    rng = np.random.default_rng(h * w + k)
    # distinct scores: no tie decides the top-k order
    heat = rng.permutation(b * h * w * c).reshape(b, h, w, c) \
        .astype(np.float32) / (b * h * w * c)
    wh = rng.uniform(1, 20, (b, h, w, 2)).astype(np.float32)
    reg = rng.uniform(0, 1, (b, h, w, 2)).astype(np.float32)
    got = T.decode_centernet_bbox(_t(heat), _t(wh), _t(reg), k)
    want = J.decode_centernet_bbox(jnp.asarray(heat), jnp.asarray(wh),
                                   jnp.asarray(reg), k)
    for g, wv in zip(got, want):
        g, wv = g.numpy(), np.asarray(wv)
        assert g.shape == wv.shape
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, wv, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, wv)


# --- connected components ---------------------------------------------------


def _labels(m):
    want = np.asarray(J.connected_components(jnp.asarray(m)))
    got = T.connected_components(_t(m)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


def test_two_blobs():
    m = np.zeros((16, 16), bool)
    m[2:5, 2:6] = True
    m[10:14, 8:12] = True
    labels = _labels(m)
    l1, l2 = labels[3, 3], labels[11, 9]
    assert l1 > 0 and l2 > 0 and l1 != l2
    assert (labels[2:5, 2:6] == l1).all() and (labels[10:14, 8:12] == l2).all()
    assert labels[0, 0] == 0


def test_diagonal_connectivity():
    m = np.zeros((8, 8), bool)
    m[1, 1] = m[2, 2] = True
    labels = _labels(m)
    assert labels[1, 1] == labels[2, 2] > 0


def test_component_boxes():
    m = np.zeros((16, 16), bool)
    m[2:5, 2:6] = True
    m[10:14, 8:12] = True
    scores = np.full((16, 16), 0.8, np.float32)
    got = T.component_boxes(T.connected_components(_t(m)), _t(scores), 8)
    want = J.component_boxes(J.connected_components(jnp.asarray(m)),
                             jnp.asarray(scores), 8)
    valid = got[3].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy()[valid], np.asarray(w)[valid],
                                   atol=1e-6)
    boxes = got[0].numpy()[valid]
    assert {tuple(b) for b in boxes.astype(int).tolist()} \
        == {(2, 2, 6, 5), (8, 10, 12, 14)}
    np.testing.assert_allclose(got[1].numpy()[valid], 0.8, atol=1e-5)


@pytest.mark.parametrize("size, density", [(32, 0.3), (48, 0.55),
                                           (64, 0.6)])
def test_matches_cv2(size, density):
    m = np.random.default_rng(size).uniform(size=(size, size)) > 1 - density
    labels = _labels(m)
    n_ref, _ = cv2.connectedComponents(m.astype(np.uint8), connectivity=8)
    assert len(np.unique(labels[labels > 0])) == n_ref - 1


def test_max_iters_stops_early():
    """A snake that needs many iterations, cut at a budget that is not a
    multiple of the port's check interval."""
    m = np.zeros((24, 24), bool)
    m[1::4, 1:23] = True
    m[1:22, 22] = True
    m[3::8, 1] = True
    m[3::8, 22] = False
    for iters in (5, 21, 4096):
        want = np.asarray(J.connected_components(jnp.asarray(m), iters))
        np.testing.assert_array_equal(
            T.connected_components(_t(m), iters).numpy(), want)


# --- PicoDet's device NMS, DocXLayout's poly IoU ----------------------------


def test_device_decode_nms_matches_jax():
    """tests/test_layout_tsr.py's case on both packages: the fused device
    NMS against JAX's survivors and against the host route."""
    from pdf_table_tpu.models.picodet import PicoDetConfig as JCfg
    from pdf_table_tpu.models.picodet.processor import \
        device_decode_nms as jax_nms
    from pdf_table_tpu_torch.models.picodet import (PicoDetConfig,
                                                    PicoDetPostProcessor)
    from pdf_table_tpu_torch.models.picodet.processor import (
        device_decode_nms, device_decode_topk)

    kw = dict(task_type="en", img_height=64, img_width=64,
              score_threshold=0.3)
    cfg, post = PicoDetConfig(**kw), PicoDetPostProcessor(PicoDetConfig(**kw))
    rng = np.random.default_rng(7)
    raw = {"scores": [], "boxes": []}
    for stride in cfg.strides:
        hw = (64 // stride) ** 2
        raw["scores"].append(rng.uniform(0, 1, (2, hw, cfg.num_classes))
                             .astype(np.float32))
        raw["boxes"].append(rng.normal(0, 2, (2, hw, 4 * (cfg.reg_max + 1)))
                            .astype(np.float32))
    want = np.asarray(jax_nms({k: [jnp.asarray(a) for a in v]
                               for k, v in raw.items()}, JCfg(**kw)))
    traw = {k: [_t(a) for a in v] for k, v in raw.items()}
    got = device_decode_nms(traw, cfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    # 1e-5 of the value: an f32 ulp of a 200-px coordinate is 1.5e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    packed = device_decode_topk(traw, cfg).numpy()
    for i in range(2):
        ref = post.from_candidates(packed[i, :, :4], packed[i, :, 4:],
                                   (64, 64))["bboxs"]
        res = post.from_device_nms(got[i], (64, 64))["bboxs"]
        assert len(res) == len(ref) > 3
        for g, w in zip(res, ref):
            assert (g["label"], g["category_id"]) \
                == (w["label"], w["category_id"])
            np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5)
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=1e-4,
                                       atol=1e-4)


def test_poly_iou_matches_jax():
    from pdf_table_tpu.models.docx_layout.processor import \
        poly_iou as jax_iou
    from pdf_table_tpu_torch.models.docx_layout.processor import (
        pairwise_poly_iou, poly_iou)

    rng = np.random.default_rng(8)
    quads = rng.uniform(0, 50, (16, 8)).astype(np.float32)
    quads[3] = quads[2]
    quads[5, 0::2] = quads[5, 0]          # zero width: IoU 0, not NaN
    pair = pairwise_poly_iou(quads)
    for i in range(len(quads)):
        for j in range(len(quads)):
            got = poly_iou(quads[i], quads[j])
            assert got == jax_iou(quads[i], quads[j])
            assert np.float32(got) == pair[i, j]


# --- render_pdf -------------------------------------------------------------


def _simple_pdf() -> bytes:
    from pdf_table_tpu_torch.pdfio import PdfWriter

    w = PdfWriter()
    p = w.add_page(612, 792)
    p.text(72, 720, "Hello World", size=14)
    p.text(72, 700, "Second line with numbers 12345", size=10)
    p.line(72, 680, 540, 680, lw=1.5)
    p.rect(100, 500, 200, 100, lw=1.0)
    w.add_page(612, 792).text(72, 720, "Page two", size=12)
    return w.tobytes()


def test_render_pdf_auto_is_native_and_bit_equal(monkeypatch):
    from pdf_table_tpu.pdfio.render import render_pdf as jax_render
    from pdf_table_tpu_torch.pdfio.render import render_pdf

    monkeypatch.delenv("PDFTABLE_RENDER_BACKEND", raising=False)
    data = _simple_pdf()
    got, want = render_pdf(data, dpi=72), jax_render(data, dpi=72)
    assert len(got) == 2 and got[0][1].shape == (792, 612, 3)
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    native = render_pdf(data, dpi=72, pages=[1], backend="native")
    assert [i for i, _ in native] == [1]
    np.testing.assert_array_equal(native[0][1], want[1][1])
