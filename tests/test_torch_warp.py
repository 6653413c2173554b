"""The port's crop samplers and their host helpers against the JAX
package's (ops/warp.py) on the same pages and geometry.

Pixel values are 0..255 in f32. Both samplers agree with JAX's to 1e-4
(one f32 rounding of a blend of values up to 255 is 3e-5): the port rounds
the sample coordinates where XLA's fused multiply-adds round them. The two
samplers agree with each other, on axis-aligned quads, to 2e-2 on either
side: their sample coordinates differ by an ulp (1.5e-5 at x = 200), which
moves a blend of 0..255 values by up to 4e-3 (the JAX package's own test
allows 2.0). The host helpers are numpy on both sides and agree
bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.ops import warp as jw
from pdf_table_tpu_torch.ops import warp as tw

torch.set_num_threads(1)

ATOL = 1e-4
RNG = np.random.default_rng(0)
PAGES = RNG.integers(0, 256, (2, 120, 200, 3), dtype=np.uint8)
# in the page, fractional, over the left and bottom edges, at the corner
BOXES = np.array([[10, 20, 150, 42], [5.5, 60.2, 190.1, 81.7],
                  [-3, 100, 80, 125], [100, 5, 199, 27],
                  [0, 0, 200, 120]], np.float32)
PIDX = np.array([0, 1, 1, 0, 1], np.int32)
WIDTHS = np.array([160, 200, 120, 224, 80], np.int32)
OUT_HW = (48, 224)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _quads(boxes):
    return np.stack([[[b[0], b[1]], [b[2], b[1]], [b[2], b[3]],
                      [b[0], b[3]]] for b in boxes]).astype(np.float32)


def _rotated(quads, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], np.float32)
    ctr = quads.mean(1, keepdims=True)
    return ((quads - ctr) @ rot.T + ctr).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {}, {"valid_w": WIDTHS},
    {"dst_w": WIDTHS.astype(np.float32), "valid_w": WIDTHS},
    {"valid_w": WIDTHS, "valid_h": np.array([48, 30, 48, 1, 17], np.int32)},
], ids=["plain", "valid_w", "dst_w", "valid_h"])
def test_resample_matches_jax(kw):
    want = np.asarray(jw.resample_axis_aligned_crops(
        jnp.asarray(PAGES), PIDX, BOXES, OUT_HW, **kw))
    got = tw.resample_axis_aligned_crops(
        _t(PAGES), _t(PIDX), _t(BOXES), OUT_HW,
        **{k: _t(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_resample_also_flipped_matches_jax():
    dst_w = WIDTHS.astype(np.float32)
    want, want_f = (np.asarray(a) for a in jw.resample_axis_aligned_crops(
        jnp.asarray(PAGES), PIDX, BOXES, OUT_HW, dst_w=dst_w,
        valid_w=WIDTHS, also_flipped=True))
    got, got_f = tw.resample_axis_aligned_crops(
        _t(PAGES), _t(PIDX), _t(BOXES), OUT_HW, dst_w=_t(dst_w),
        valid_w=_t(WIDTHS), also_flipped=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=ATOL)
    # the flipped crop is the forward one rotated by 180 degrees inside
    # its own width (up to the rounding of the reversed sample points)
    for i, w in enumerate(WIDTHS):
        np.testing.assert_allclose(
            got_f[i, :, :w].numpy(), got[i, :, :w].flip(0, 1).numpy(),
            rtol=0, atol=2e-2)
        assert not got_f[i, :, w:].any()


def test_also_flipped_rejects_valid_h():
    with pytest.raises(ValueError, match="full-height"):
        tw.resample_axis_aligned_crops(
            _t(PAGES), _t(PIDX), _t(BOXES), OUT_HW, valid_w=_t(WIDTHS),
            valid_h=_t(WIDTHS), also_flipped=True)
    with pytest.raises(ValueError, match="full-height"):
        jw.resample_axis_aligned_crops(
            jnp.asarray(PAGES), PIDX, BOXES, OUT_HW, valid_w=WIDTHS,
            valid_h=WIDTHS, also_flipped=True)


@pytest.mark.parametrize("angle", [0.0, 0.1, -0.35, np.pi],
                         ids=["aligned", "tilted", "tilted_back", "upside"])
@pytest.mark.parametrize("heights", [None, np.array([48, 30, 48, 1, 17])],
                         ids=["full", "heights"])
def test_warp_crops_from_pages_matches_jax(angle, heights):
    qs = jw.order_points_clockwise_batch(_rotated(_quads(BOXES), angle))
    mats = jw.homographies_from_quads_batch(qs, WIDTHS, OUT_HW[0])
    hj = None if heights is None else jnp.asarray(heights, jnp.int32)
    ht = None if heights is None else _t(heights.astype(np.int32))
    want = np.asarray(jw.warp_crops_from_pages(
        jnp.asarray(PAGES), PIDX, mats, WIDTHS, OUT_HW, heights=hj))
    got = tw.warp_crops_from_pages(_t(PAGES), _t(PIDX), _t(mats),
                                   _t(WIDTHS), OUT_HW, heights=ht)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.max() > 100
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_routes_agree_on_axis_aligned_quads():
    """The homography sampler on axis-aligned quads gives the axis-aligned
    sampler's crops, as in the JAX package."""
    qs = tw.order_points_clockwise_batch(_quads(BOXES))
    assert tw.quads_axis_aligned(qs).all()
    mats = tw.homographies_from_quads_batch(qs, WIDTHS, OUT_HW[0])
    a = tw.warp_crops_from_pages(_t(PAGES), _t(PIDX), _t(mats), _t(WIDTHS),
                                 OUT_HW).numpy()
    b = tw.resample_axis_aligned_crops(
        _t(PAGES), _t(PIDX), _t(BOXES), OUT_HW,
        dst_w=_t(WIDTHS.astype(np.float32)), valid_w=_t(WIDTHS)).numpy()
    ja = np.asarray(jw.warp_crops_from_pages(jnp.asarray(PAGES), PIDX, mats,
                                             WIDTHS, OUT_HW))
    jb = np.asarray(jw.resample_axis_aligned_crops(
        jnp.asarray(PAGES), PIDX, BOXES, OUT_HW,
        dst_w=WIDTHS.astype(np.float32), valid_w=WIDTHS))
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-2)
    np.testing.assert_allclose(ja, jb, rtol=0, atol=2e-2)


def test_host_helpers_equal_jax_bitwise():
    rng = np.random.default_rng(1)
    quads = np.concatenate([
        _quads(BOXES), _rotated(_quads(BOXES), 0.2),
        _rotated(_quads(BOXES), -1.0),
        rng.uniform(0, 200, (6, 4, 2)).astype(np.float32)])
    shuffled = quads[:, rng.permutation(4)]
    for q in (quads, shuffled):
        want = jw.order_points_clockwise_batch(q)
        got = tw.order_points_clockwise_batch(q)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tw.quads_axis_aligned(got),
                                      jw.quads_axis_aligned(want))
        for eps in (0.0, 2.0):
            np.testing.assert_array_equal(tw.quads_axis_aligned(got, eps),
                                          jw.quads_axis_aligned(want, eps))
        w = rng.integers(1, 640, len(q)).astype(np.int32)
        for dst_w, dst_h in ((w, 48), (192.0, 48.0)):
            a = tw.homographies_from_quads_batch(got, dst_w, dst_h)
            b = jw.homographies_from_quads_batch(want, dst_w, dst_h)
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert tw.quads_axis_aligned(tw.order_points_clockwise_batch(
        _quads(BOXES))).all()
    assert not tw.quads_axis_aligned(tw.order_points_clockwise_batch(
        _rotated(_quads(BOXES), 0.2))).any()


def test_host_helpers_take_no_quads():
    empty = np.zeros((0, 4, 2), np.float32)
    assert tw.order_points_clockwise_batch(empty).shape == (0, 4, 2)
    assert tw.homographies_from_quads_batch(empty, 10, 10).shape == (0, 3, 3)
    assert tw.quads_axis_aligned(empty).shape == (0,)
