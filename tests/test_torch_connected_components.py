"""The port's device connected components against the JAX package's on the
same maps: ``connected_components_scan`` labels equal, and the
``batch_component_boxes_u8`` packed rows equal in boxes, areas and slot
order (the 64 largest label ids, descending), with the mean-prob column
within 1e-6 relative: both sides sum it in f32, in another order (a few
ulps apart on components of thousands of pixels). Random maps, bars,
staircases, partial ``valid_hw``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the module, not the package's export of the same name (the function)
tcc = importlib.import_module("pdf_table_tpu_torch.ops.connected_components")
jcc = importlib.import_module("pdf_table_tpu.ops.connected_components")

torch.set_num_threads(1)

MEAN_RTOL = 1e-6


def _random(seed, shape=(37, 53), p=0.5):
    return np.random.default_rng(seed).random(shape) < p


def _bars():
    m = np.zeros((30, 40), bool)
    m[2, 1:39] = True            # a full-width rule
    m[5:25, 3] = True            # a column rule
    m[10:12, 10:30] = True       # a thick bar
    m[20, 20] = m[21, 21] = m[22, 20] = True   # diagonal touches
    return m


def _staircase(steps=6):
    """A staircase whose pixels reach the component's min only through
    many alternations of row and column runs."""
    m = np.zeros((4 * steps + 2, 4 * steps + 2), bool)
    for s in range(steps):
        m[4 * s + 1, 4 * s + 1:4 * s + 5] = True
        m[4 * s + 1:4 * s + 5, 4 * s + 4] = True
    return m[::-1].copy()


MASKS = {"random_sparse": lambda: _random(0, p=0.3),
         "random_dense": lambda: _random(1, p=0.6),
         "bars": _bars, "staircase": _staircase,
         "empty": lambda: np.zeros((8, 9), bool),
         "full": lambda: np.ones((8, 9), bool)}


@pytest.mark.parametrize("iters", [1, 4, 8])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_scan_labels_equal(name, iters):
    m = MASKS[name]()
    want = np.asarray(jcc.connected_components_scan(jnp.asarray(m),
                                                    num_iters=iters))
    got = tcc.connected_components_scan(torch.from_numpy(m), iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_batched_is_per_map():
    ms = np.stack([_random(s, (20, 24)) for s in range(3)])
    got = tcc.connected_components_scan(torch.from_numpy(ms), 4).numpy()
    for i, m in enumerate(ms):
        want = np.asarray(jcc.connected_components_scan(jnp.asarray(m),
                                                        num_iters=4))
        np.testing.assert_array_equal(got[i], want)


def _smooth_probs(seed, n, h, w):
    """u8 maps with blobs: random noise box-blurred, spread over 0..255."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, h + 4, w + 4))
    k = sum(x[:, dy:dy + h, dx:dx + w] for dy in range(5) for dx in range(5))
    k = (k - k.min()) / (k.max() - k.min())
    return np.round(k * 255).astype(np.uint8)


def _assert_rows_equal(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 5]],
                                  want[..., [0, 1, 2, 3, 5]])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=MEAN_RTOL,
                               atol=0)


CASES = {
    # name: (probs, thresh_u8, valid_hw, max_components, iters)
    "random_full_extent": (lambda: _random(3, (2, 48, 64)).astype(np.uint8)
                           * 200, 100, [[48, 64], [48, 64]], 64, 4),
    "smooth_partial_extent": (lambda: _smooth_probs(4, 3, 48, 64), 128,
                              [[48, 64], [31, 41], [17, 64]], 64, 4),
    "smooth_few_slots": (lambda: _smooth_probs(5, 2, 40, 56), 120,
                         [[40, 56], [40, 33]], 8, 8),
    "odd_sizes": (lambda: _smooth_probs(6, 2, 33, 47), 110,
                  [[33, 47], [20, 25]], 64, 4),
    "bars": (lambda: (_bars()[None].repeat(2, 0) * 230).astype(np.uint8),
             100, [[30, 40], [12, 40]], 64, 4),
    "nothing_above": (lambda: np.full((1, 16, 16), 50, np.uint8), 100,
                      [[16, 16]], 64, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_rows_equal(name):
    make, thr, valid, k, iters = CASES[name]
    probs = make()
    valid = np.asarray(valid, np.int32)
    want = np.asarray(jcc.batch_component_boxes_u8(
        jnp.asarray(probs), thr, jnp.asarray(valid), k, iters))
    got = tcc.batch_component_boxes_u8(torch.from_numpy(probs), thr,
                                       torch.from_numpy(valid), k, iters)
    assert got.dtype == torch.float32
    _assert_rows_equal(got.numpy(), want)


def test_component_boxes_equal():
    m = _random(7, (24, 30), p=0.4)
    labels = np.array(jcc.connected_components_scan(jnp.asarray(m),
                                                     num_iters=8))
    scores = np.random.default_rng(8).random((24, 30)).astype(np.float32)
    want = [np.asarray(a) for a in jcc.component_boxes(
        jnp.asarray(labels), jnp.asarray(scores), 16)]
    got = [a[0].numpy() for a in tcc.component_boxes(
        torch.from_numpy(labels)[None], torch.from_numpy(scores)[None], 16)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=MEAN_RTOL, atol=0)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
