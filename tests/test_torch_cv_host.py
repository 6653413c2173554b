"""The port's OpenCV 5.0.0 host geometry (pdf_table_tpu_torch/ops/cv_host.py
and the resizes of ops/crop_resize.py) held to ``cv2`` on this box, on
seeded bitmaps, prob maps, point sets and images.

Held: contours point for point and in order; ``convexHull`` indices;
``fillPoly`` masks of polygons inside the image, the masked mean,
connected-component labels and stats,
Otsu thresholds and masks, ``findNonZero``, ``getRotationMatrix2D`` and
``boxPoints`` equal; ``minAreaRect`` centre, size and angle within 1e-4
(where the two pick different rectangles, their areas tie within 1e-5 of
each other: OpenCV 5.0's float arithmetic breaks the tie); uint8
``warpAffine`` (border 255) within one grey level on at most 0.1 % of the
pixels; uint8 ``warpPerspective`` within one grey level there and
bit-equal on turned quads and on the degenerate quads of F8 (500
rectangles at 45 degrees, 2,000 collinear quads), where
``getPerspectiveTransform`` is bit-equal too (OpenCV's SVD fallback, its
Jacobi SVD bit-equal to ``cv2.SVDecomp``), and within 1e-9 elsewhere;
f32 resize within 1e-5, uint8 grey resize bit-equal. A polygon that leaves
the image is filled within one pixel a row of ``cv2.fillPoly``
(ROADMAP.md Queue 3)."""

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


def _rect_diff(a, b):
    return max(abs(a[0][0] - b[0][0]), abs(a[0][1] - b[0][1]),
               abs(a[1][0] - b[1][0]), abs(a[1][1] - b[1][1]),
               abs(a[2] - b[2]))


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
    ties = 0
    for pts in sets:
        want, got = cv2.minAreaRect(pts), ch.min_area_rect(pts)
        if _rect_diff(want, got) > 1e-4:
            # a tie of two rectangles' areas, broken by float rounding
            ties += 1
            aw, ag = want[1][0] * want[1][1], got[1][0] * got[1][1]
            assert abs(aw - ag) <= 1e-5 * max(aw, 1.0), (want, got)
        np.testing.assert_array_equal(ch.box_points(want),
                                      cv2.boxPoints(want))
    assert ties <= len(sets) // 20


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


def test_fill_poly_leaving_the_image_within_a_pixel_a_row():
    rng = np.random.default_rng(5)
    for _ in range(300):
        h, w = int(rng.integers(3, 60)), int(rng.integers(3, 60))
        pts = rng.integers(-5, max(h, w) + 5, (4, 2)).astype(np.float32)
        quad = ch.box_points(ch.min_area_rect(pts)).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, quad.reshape(1, -1, 2), 1)
        got = np.zeros((h, w), np.uint8)
        ch.fill_poly(got, quad, 1)
        assert (got != want).sum(axis=1).max(initial=0) <= 1


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
    off = n_px = 0
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
        want = cv2.warpPerspective(img, m, (w, h))
        got = ch.warp_perspective_u8(img, m, (w, h))
        d = np.abs(got.astype(int) - want)
        assert d.max() <= 1
        off += int((d > 0).sum())
        n_px += d.size
    assert off <= 1e-3 * n_px


def test_warp_affine_u8_white_border():
    rng = np.random.default_rng(1)
    off = n_px = 0
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
        got = ch.warp_affine_u8(img, m, (W + 6, H + 4), border=255)
        d = np.abs(got.astype(int) - want)
        assert d.max() <= 1
        off += int((d > 0).sum())
        n_px += d.size
    assert off <= 1e-3 * n_px


@pytest.mark.parametrize("hw,out", [((37, 53), (64, 96)),
                                    ((120, 90), (48, 30)),
                                    ((800, 608), (61, 47))])
def test_resizes(hw, out):
    rng = np.random.default_rng(0)
    f = rng.random(hw + (3,)).astype(np.float32) * 255
    np.testing.assert_allclose(resize_linear_f32(f, *out),
                               cv2.resize(f, out[::-1]), atol=1e-5 * 255,
                               rtol=0)
    np.testing.assert_allclose(resize_linear_f32(f[..., 0], *out),
                               cv2.resize(f[..., 0], out[::-1]),
                               atol=1e-5 * 255, rtol=0)
    g = rng.integers(0, 256, hw).astype(np.uint8)
    np.testing.assert_array_equal(resize_u8_plain(g, *out),
                                  cv2.resize(g, out[::-1]))


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
