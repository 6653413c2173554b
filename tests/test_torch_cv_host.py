"""The port's OpenCV 5.0.0 host geometry (pdf_table_tpu_torch/ops/cv_host.py
and the resizes of ops/crop_resize.py) held to ``cv2`` on this box, on
seeded bitmaps, prob maps, point sets and images.

Held equal, bit for bit: contours point for point and in order;
``convexHull`` indices; ``minAreaRect`` (F16: random point sets, the dark
pixels of seeded text pages, quads grown by ``unclip_quad``) and
``boxPoints``; ``fillPoly`` masks of polygons inside the image and of
polygons that leave it (F18), the masked mean; connected-component labels
and stats; Otsu thresholds and masks, ``findNonZero``,
``getRotationMatrix2D``; uint8 and f32 ``warpAffine`` (F17: scale,
translate and rotate, 1 and 3 channels, borders 0 and 255, the deskew turn
of pages of 900 px and more); uint8 ``warpPerspective`` on random and
turned quads and on the degenerate quads of F8 (500 rectangles at 45
degrees, 2,000 collinear quads), where ``getPerspectiveTransform`` is
bit-equal too (OpenCV's SVD fallback, its Jacobi SVD bit-equal to
``cv2.SVDecomp``), and within 1e-9 elsewhere; the f32 resize (F19: up and
down, 1 and 3 channels, edge runs) and the uint8 grey resize."""

import cv2
import numpy as np
import pytest
import torch

from pdf_table_tpu_torch.ops import cv_host as ch
from pdf_table_tpu_torch.ops.crop_resize import (resize_linear_f32,
                                                 resize_u8_plain)

torch.set_num_threads(1)


def blob_map(seed, h, w, n=14):
    """A 0/1 uint8 map of rotated ellipses, bars and speckles."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(n):
        c = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        ax = (int(rng.integers(1, 30)), int(rng.integers(1, 8)))
        cv2.ellipse(m, c, ax, float(rng.uniform(-30, 30)), 0, 360, 1, -1)
    for _ in range(n // 2):
        x, y = int(rng.integers(0, w - 3)), int(rng.integers(0, h - 3))
        m[y:y + int(rng.integers(1, 6)), x:x + int(rng.integers(1, 40))] = 1
    m[rng.random((h, w)) > 0.985] = 1
    # a ring: a hole border
    cv2.circle(m, (w // 2, h // 2), min(h, w) // 4, 1, 2)
    return m


def prob_map(seed, h, w):
    """A smooth random prob map in [0, 1)."""
    rng = np.random.default_rng(seed)
    small = rng.random((h // 8 + 2, w // 8 + 2)).astype(np.float32)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC) \
        .clip(0, 0.999).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_find_contours_equal_point_for_point_and_in_order(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(20, 140)), int(rng.integers(20, 200))
    maps = [blob_map(seed, h, w), prob_map(seed, h, w) > 0.55,
            (rng.random((h, w)) > 0.5)]
    for m in maps:
        m = np.asarray(m, np.uint8)
        want = cv2.findContours(m * 255, cv2.RETR_LIST,
                                cv2.CHAIN_APPROX_SIMPLE)[0]
        got = ch.find_contours(m)
        assert len(got) == len(want)
        for g, wc in zip(got, want):
            np.testing.assert_array_equal(g, wc)


def test_find_contours_of_empty_and_full_maps():
    assert ch.find_contours(np.zeros((5, 7), np.uint8)) == []
    full = np.ones((5, 7), np.uint8)
    want = cv2.findContours(full, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)[0]
    np.testing.assert_array_equal(ch.find_contours(full)[0], want[0])


def same_rect(got, want):
    """Centre, size and angle equal to the bit."""
    return (got[0] == tuple(want[0]) and got[1] == tuple(want[1])
            and got[2] == want[2])


def text_page(seed, lo=300, hi=901):
    """Word bars of dark greys on white, 300-900 px a side, turned by a
    seeded angle within 8 degrees (cv2)."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
    img = np.full((h, w, 3), 255, np.uint8)
    y = int(rng.integers(10, 40))
    while y < h - 20:
        x = int(rng.integers(10, 40))
        lh = int(rng.integers(6, 14))
        while x < w - 30:
            ww = int(rng.integers(8, 60))
            img[y:y + lh, x:min(x + ww, w - 10)] = int(rng.integers(0, 90))
            x += ww + int(rng.integers(4, 14))
        y += lh + int(rng.integers(8, 24))
    m = cv2.getRotationMatrix2D((w / 2, h / 2), float(rng.uniform(-8, 8)),
                                1.0)
    return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderValue=(255, 255, 255))


@pytest.mark.parametrize("seed", range(4))
def test_min_area_rect_and_box_points(seed):
    rng = np.random.default_rng(seed)
    m = blob_map(seed + 10, 90, 160)
    sets = [c for c in ch.find_contours(m)]
    sets.append(ch.find_nonzero(m))
    sets += [(rng.random((int(rng.integers(3, 30)), 2)) * 100)
             .astype(np.float32) for _ in range(40)]
    sets += [rng.integers(0, 40, (int(rng.integers(1, 12)), 2))
             .astype(np.int32) for _ in range(40)]
    for pts in sets:
        want, got = cv2.minAreaRect(pts), ch.min_area_rect(pts)
        assert same_rect(got, want), (got, want)
        np.testing.assert_array_equal(ch.box_points(want),
                                      cv2.boxPoints(want))


@pytest.mark.parametrize("seeds", [range(0, 10), range(10, 20)])
def test_min_area_rect_of_page_dark_pixels(seeds):
    """F16: the deskew's rectangle, of the dark pixels (``findNonZero`` of
    the Otsu mask) of seeded text pages, and the skew angle that JAX's
    ``estimate_skew_angle`` takes from cv2, equal (the calipers' float
    tie breaks are OpenCV's)."""
    from pdf_table_tpu.tasks.preprocess import estimate_skew_angle as jskew
    from pdf_table_tpu_torch.tasks.preprocess import estimate_skew_angle

    for seed in seeds:
        img = text_page(seed)
        thr = cv2.threshold(cv2.cvtColor(img, cv2.COLOR_RGB2GRAY), 0, 255,
                            cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)[1]
        pts = cv2.findNonZero(thr)
        assert same_rect(ch.min_area_rect(pts), cv2.minAreaRect(pts))
        assert estimate_skew_angle(img) == jskew(img)


def test_min_area_rect_of_unclipped_quads():
    """F16: the rectangles of 3,000 min-area quads grown by the detector's
    ``unclip_quad`` (ratio 1.5), float corners, equal."""
    from pdf_table_tpu_torch.models.dbnet.processor import unclip_quad

    rng = np.random.default_rng(0)
    for _ in range(3000):
        p = (rng.random((4, 2)) * 200).astype(np.float32)
        quad = np.asarray(unclip_quad(cv2.boxPoints(cv2.minAreaRect(p)),
                                      1.5), np.float32).reshape(-1, 2)
        assert same_rect(ch.min_area_rect(quad), cv2.minAreaRect(quad))


@pytest.mark.parametrize("seed", range(3))
def test_convex_hull_indices(seed):
    rng = np.random.default_rng(seed)
    for _ in range(120):
        pts = (rng.random((int(rng.integers(1, 40)), 2)) * 50) \
            .astype(np.float32)
        want = cv2.convexHull(pts, returnPoints=False).ravel()
        np.testing.assert_array_equal(ch.convex_hull(pts), want)


@pytest.mark.parametrize("seed", range(3))
def test_fill_poly_and_masked_mean_inside_the_image(seed):
    rng = np.random.default_rng(seed)
    for t in range(200):
        h, w = int(rng.integers(3, 60)), int(rng.integers(3, 60))
        if t % 2:
            p = (rng.random((6, 2)) * [w - 1, h - 1]).astype(np.float32)
            pts = np.clip(ch.box_points(ch.min_area_rect(p)), 0,
                          [w - 1, h - 1]).astype(np.int32)
        else:
            pts = rng.integers(0, min(h, w),
                               (int(rng.integers(3, 8)), 2)).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, pts.reshape(1, -1, 2), 1)
        got = np.zeros((h, w), np.uint8)
        ch.fill_poly(got, pts, 1)
        np.testing.assert_array_equal(got, want)
        prob = rng.random((h, w)).astype(np.float32)
        assert ch.mean_masked(prob, got) == pytest.approx(
            cv2.mean(prob, want)[0], rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("seed", [5, 6])
def test_fill_poly_leaving_the_image_within_a_pixel_a_row(seed):
    """F18: 1,000 min-area quads a seed (points in [-10, side + 10],
    images 3-80 px) and 200 integer polygons of 3-7 points, self-crossing
    ones too, reaching past the image: equal to ``cv2.fillPoly``."""
    rng = np.random.default_rng(seed)
    for t in range(1200):
        h, w = int(rng.integers(3, 81)), int(rng.integers(3, 81))
        if t < 1000:
            pts = rng.uniform(-10, max(h, w) + 10, (4, 2)).astype(np.float32)
            quad = ch.box_points(ch.min_area_rect(pts)).astype(np.int32)
        else:
            quad = rng.integers(-10, max(h, w) + 10,
                                (int(rng.integers(3, 8)), 2)).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, quad.reshape(1, -1, 2), 1)
        got = np.zeros((h, w), np.uint8)
        ch.fill_poly(got, quad, 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_connected_components_with_stats(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(5, 120)), int(rng.integers(5, 160))
    for m in ((rng.random((h, w)) > 0.6).astype(np.uint8),
              blob_map(seed, h, w), np.zeros((h, w), np.uint8)):
        n, labels, stats, _ = cv2.connectedComponentsWithStats(
            m, connectivity=8)
        gn, glabels, gstats = ch.connected_components_with_stats(m)
        assert gn == n
        np.testing.assert_array_equal(glabels, labels)
        np.testing.assert_array_equal(gstats, stats)


@pytest.mark.parametrize("seed", range(4))
def test_otsu_threshold_and_find_nonzero(seed):
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(5, 90)), int(rng.integers(5, 90)))
    for g in (rng.integers(0, 256, shape).astype(np.uint8),
              np.clip(rng.normal(190, 40, shape), 0, 255).astype(np.uint8)):
        t, thr = cv2.threshold(g, 0, 255,
                               cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
        gt, gthr = ch.threshold_otsu_inv(g)
        assert gt == t
        np.testing.assert_array_equal(gthr, thr)
        np.testing.assert_array_equal(ch.find_nonzero(gthr),
                                      cv2.findNonZero(thr))
    assert ch.find_nonzero(np.zeros((4, 4), np.uint8)).shape == (0, 2)


def test_grey_and_rotation_matrix():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (31, 47, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ch.rgb_to_grey(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    for (w, h), ang in (((123, 77), 2.5), ((960, 1280), -3.7),
                        ((41, 17), 0.31)):
        np.testing.assert_array_equal(
            ch.rotation_matrix_2d((w / 2, h / 2), ang, 1.0),
            cv2.getRotationMatrix2D((w / 2, h / 2), ang, 1.0))


@pytest.mark.parametrize("seed", range(3))
def test_perspective_transform_and_warp(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        H, W = int(rng.integers(30, 120)), int(rng.integers(30, 200))
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        src = np.array([[5, 5], [W - 10, 8], [W - 8, H - 6], [7, H - 9]],
                       np.float32) + rng.normal(0, 3, (4, 2)).astype(
                           np.float32)
        w, h = int(rng.integers(5, 60)), int(rng.integers(5, 40))
        dst = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                       np.float32)
        m = cv2.getPerspectiveTransform(src, dst)
        np.testing.assert_allclose(ch.perspective_transform(src, dst), m,
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(ch.warp_perspective_u8(img, m, (w, h)),
                                      cv2.warpPerspective(img, m, (w, h)))


def test_warp_affine_u8_white_border():
    rng = np.random.default_rng(1)
    for _ in range(20):
        H, W = int(rng.integers(30, 120)), int(rng.integers(30, 200))
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        m = cv2.getRotationMatrix2D((W / 2, H / 2),
                                    float(rng.uniform(-5, 5)), 1.0)
        m[0, 2] += 3.3
        m[1, 2] += 2.1
        want = cv2.warpAffine(img, m, (W + 6, H + 4),
                              flags=cv2.INTER_LINEAR,
                              borderValue=(255, 255, 255))
        np.testing.assert_array_equal(
            ch.warp_affine_u8(img, m, (W + 6, H + 4), border=255), want)


@pytest.mark.parametrize("seed", range(3))
def test_warp_affine_sweep(seed):
    """F17: seeded scale-and-translate and rotate-and-scale warps of uint8
    and f32 images, 1 and 3 channels, borders 0 and 255, output widths on
    and off OpenCV's blocks of 16 columns: equal to ``cv2.warpAffine``."""
    rng = np.random.default_rng(seed)
    for t in range(12):
        H, W = int(rng.integers(20, 300)), int(rng.integers(20, 300))
        shape = (H, W, 3) if t % 3 else (H, W)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        if t % 4 == 0:
            m = cv2.getRotationMatrix2D((W / 2, H / 2),
                                        float(rng.uniform(-10, 10)),
                                        float(rng.uniform(0.5, 2)))
        else:
            s = float(rng.uniform(0.2, 3))
            m = np.array([[s, 0, rng.uniform(-20, 20)],
                          [0, s, rng.uniform(-20, 20)]])
        size = (int(rng.integers(10, 300)), int(rng.integers(10, 300)))
        border = 255.0 if t % 2 else 0.0
        kw = dict(flags=cv2.INTER_LINEAR, borderValue=(border,) * 4)
        np.testing.assert_array_equal(
            ch.warp_affine_u8(img, m, size, border=border),
            cv2.warpAffine(img, m, size, **kw))
        f = img.astype(np.float32) + rng.random(shape).astype(np.float32)
        np.testing.assert_array_equal(
            ch.warp_affine_linear(f, m, size, border=border),
            cv2.warpAffine(f, m, size, **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_deskew_turn_of_pages_equals_jax(seed):
    """F17: the deskew's uint8 turn (white border, a canvas that holds the
    page) of a noise page of at least 900 px and of a text page, by the
    port's ``rotate_image`` and JAX's (cv2), equal."""
    from pdf_table_tpu.tasks.preprocess import rotate_image as jrotate
    from pdf_table_tpu_torch.tasks.preprocess import rotate_image

    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(900, 1300)), int(rng.integers(900, 1300))
    noise = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for img in (noise, text_page(seed + 40)):
        angle = float(rng.uniform(-8, 8))
        np.testing.assert_array_equal(rotate_image(img, angle),
                                      jrotate(img, angle))


@pytest.mark.parametrize("hw,out", [((37, 53), (64, 96)),
                                    ((120, 90), (48, 30)),
                                    ((800, 608), (61, 47))])
def test_resizes(hw, out):
    rng = np.random.default_rng(0)
    f = rng.random(hw + (3,)).astype(np.float32) * 255
    np.testing.assert_array_equal(resize_linear_f32(f, *out),
                                  cv2.resize(f, out[::-1]))
    np.testing.assert_array_equal(resize_linear_f32(f[..., 0], *out),
                                  cv2.resize(f[..., 0], out[::-1]))
    g = rng.integers(0, 256, hw).astype(np.uint8)
    np.testing.assert_array_equal(resize_u8_plain(g, *out),
                                  cv2.resize(g, out[::-1]))


@pytest.mark.parametrize("lo,hi", [(20, 701), (2, 60)])
def test_resize_linear_f32_sweep(lo, hi):
    """F19: 30 seeded f32 resizes (values 0-255), 1 and 3 channels, up and
    down, sides in [lo, hi); the small sides give the edge runs (columns
    left of and beyond the source) of every length: equal to
    ``cv2.resize``."""
    rng = np.random.default_rng(lo)
    for t in range(30):
        H, W, h, w = (int(v) for v in rng.integers(lo, hi, 4))
        shape = (H, W) if t % 3 == 0 else (H, W, 3)
        f = (rng.random(shape) * 255).astype(np.float32)
        np.testing.assert_array_equal(resize_linear_f32(f, h, w),
                                      cv2.resize(f, (w, h)))


# -- degenerate quads (F8) --------------------------------------------------

def crop_size_dst(o):
    """``crop_rotated_boxes``'s destination rectangle for an ordered quad."""
    w = int(round(max(np.linalg.norm(o[0] - o[1]),
                      np.linalg.norm(o[3] - o[2]))))
    h = int(round(max(np.linalg.norm(o[0] - o[3]),
                      np.linalg.norm(o[1] - o[2]))))
    w, h = max(w, 1), max(h, 1)
    return np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                    np.float32)


def degenerate_quads(kind):
    """The two sets on which the port's crops were black (ROADMAP.md Queue
    3, F8), made from seed 0: 500 rectangles of half sides 2-60 px turned
    by exactly 45 degrees about centres in [50, 450)² (the sum / difference
    ordering puts two of their corners on one point, or makes them nearly
    so), or 2,000 quads of four integer points on a line (a start in
    [0, 300)², a step in [-20, 20]², sorted multiples 0-5 of it)."""
    rng = np.random.default_rng(0)
    out = []
    if kind == "rect45":
        r = np.sqrt(0.5)
        turn = np.array([[r, -r], [r, r]])
        for _ in range(500):
            c = rng.uniform(50, 450, 2)
            hw = rng.uniform(2, 60, 2)
            box = np.array([[-hw[0], -hw[1]], [hw[0], -hw[1]],
                            [hw[0], hw[1]], [-hw[0], hw[1]]])
            out.append((box @ turn.T + c).astype(np.float32))
    else:
        for _ in range(2000):
            p0, step = rng.integers(0, 300, 2), rng.integers(-20, 21, 2)
            t = np.sort(rng.integers(0, 6, 4))
            out.append((p0 + t[:, None] * step).astype(np.float32))
    return np.stack(out)


@pytest.mark.parametrize("src,dst", [
    ([(0, 0), (10, 0), (10, 0), (0, 10)], [(0, 0), (20, 0), (20, 5), (0, 5)]),
    ([(0, 0), (1, 1), (2, 2), (3, 3)], [(0, 0), (20, 0), (20, 5), (0, 5)])],
    ids=["two_corners_on_one_point", "collinear"])
def test_perspective_transform_of_a_degenerate_quad_equals_cv2(src, dst):
    src, dst = np.float32(src), np.float32(dst)
    want = cv2.getPerspectiveTransform(src, dst)
    got = ch.perspective_transform(src, dst)
    np.testing.assert_array_equal(got, want)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-12 and got[2, 2] != 1.0


@pytest.mark.parametrize("kind", ["rect45", "collinear"])
def test_degenerate_quads_transform_and_warp_as_cv2(kind):
    """On each set ``perspective_transform`` equals
    ``cv2.getPerspectiveTransform`` bit for bit (the LU where it finds a
    pivot, OpenCV's SVD fallback where it does not), and
    ``warp_perspective_u8`` of that matrix equals ``cv2.warpPerspective``."""
    from pdf_table_tpu_torch.ops.warp import order_points_clockwise_batch

    img = np.random.default_rng(1).integers(0, 256, (520, 520, 3),
                                            dtype=np.uint8)
    singular = 0
    for o in order_points_clockwise_batch(degenerate_quads(kind)):
        dst = crop_size_dst(o)
        want = cv2.getPerspectiveTransform(o, dst)
        got = ch.perspective_transform(o, dst)
        np.testing.assert_array_equal(got, want)
        singular += got[2, 2] != 1.0
        size = int(dst[1, 0]) + 1, int(dst[2, 1]) + 1
        np.testing.assert_array_equal(ch.warp_perspective_u8(img, got, size),
                                      cv2.warpPerspective(img, want, size))
    assert singular >= (300 if kind == "rect45" else 1900)


@pytest.mark.parametrize("seed", range(2))
def test_warp_perspective_bit_equal_on_turned_quads(seed):
    """Quads turned by any angle and jittered, crops of every width (the
    columns after OpenCV's last block of 16 take another rounding), colour
    and grey: bit-equal to ``cv2.warpPerspective``."""
    from pdf_table_tpu_torch.ops.warp import order_points_clockwise_batch

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    for _ in range(60):
        c, hw = rng.uniform(60, 340, 2), rng.uniform(3, 50, 2)
        a = rng.uniform(-np.pi, np.pi)
        turn = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        box = np.array([[-hw[0], -hw[1]], [hw[0], -hw[1]], [hw[0], hw[1]],
                        [-hw[0], hw[1]]]) @ turn.T + c
        o = order_points_clockwise_batch(
            (box + rng.normal(0, 2, (4, 2))).astype(np.float32))[0]
        dst = crop_size_dst(o)
        m = ch.perspective_transform(o, dst)
        size = int(dst[1, 0]) + 1, int(dst[2, 1]) + 1
        for im in (img, img[..., 1]):
            np.testing.assert_array_equal(ch.warp_perspective_u8(im, m, size),
                                          cv2.warpPerspective(im, m, size))


@pytest.mark.parametrize("rank", [9, 7, 6])
def test_jacobi_svd_equals_cv2_svdecomp(rank):
    """``_jacobi_svd_u`` is OpenCV's Jacobi SVD bit for bit, on symmetric
    matrices of full and deficient rank (the zero singular values' vectors
    drawn from OpenCV's RNG)."""
    rng = np.random.default_rng(rank)
    for _ in range(10):
        b = rng.normal(size=(rank, 9))
        s = b.T @ b
        _, u, _ = cv2.SVDecomp(s)
        np.testing.assert_array_equal(
            np.array(ch._jacobi_svd_u(s.tolist())).T, u)


def test_host_geometry_digests_are_cv2s_and_the_ports():
    """The digests that ``chip_smoke.py``'s ``decode`` phase holds the card
    host to (tests/data/image_decode/host_geometry.py) are cv2's outputs
    here, and the port's outputs match them."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "host_geometry", os.path.join(os.path.dirname(__file__), "data",
                                      "image_decode", "host_geometry.py"))
    hg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(hg)
    want = hg.load_digests()
    assert hg.cv2_outputs() == want
    assert hg.port_outputs() == want
