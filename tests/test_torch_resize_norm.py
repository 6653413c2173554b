"""The port's resize + normalize (K3) against the JAX package: the plain
PyTorch version against ``resize_normalize_xla`` (both f32, atol 1e-5)
and against the interpret-mode Pallas kernel (bf16 operands inside it),
at downscale, upscale, ``in_size == 1``, ragged sizes and both norm
styles. The kernel itself runs only on a card (``-m cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.ops.pallas.resize_norm import (_resize_matrix,
                                                  resize_normalize_pallas,
                                                  resize_normalize_xla)
from pdf_table_tpu_torch.ops.kernels import launch_counts
from pdf_table_tpu_torch.ops.resize_norm import (resize_matrix,
                                                 resize_normalize,
                                                 resize_normalize_plain,
                                                 resize_taps)
from pdf_table_tpu_torch.tasks.detection import NORM

torch.set_num_threads(1)

# (N, H, W) -> (Ho, Wo)
SHAPES = [
    ((2, 40, 56), (32, 24)),      # downscale
    ((1, 12, 10), (30, 27)),      # upscale, ragged
    ((2, 1, 9), (8, 16)),         # in_size == 1 on one axis
    ((1, 37, 53), (37, 53)),      # same size
    ((3, 64, 48), (48, 36)),      # a page bucket's 4:3, cut small
]


def _canvas(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (*shape, 3)).astype(np.uint8)


def _jax_input(u8, style):
    """What the JAX detection program feeds resize_normalize_xla."""
    x = jnp.asarray(u8).astype(jnp.float32)
    return x[..., ::-1] if style == "modelscope" else x / 255.0


@pytest.mark.parametrize("style", ["imagenet", "modelscope"])
@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_plain_matches_xla(case, style):
    shape, out_hw = SHAPES[case]
    u8 = _canvas(shape, case)
    norm = NORM[style]
    want = np.asarray(resize_normalize_xla(_jax_input(u8, style), out_hw,
                                           norm["mean"], norm["std"]))
    got = resize_normalize_plain(torch.from_numpy(u8), out_hw, **norm)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[0], *out_hw, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("style", ["imagenet", "modelscope"])
@pytest.mark.parametrize("case", [0, 1, 4])
def test_plain_matches_pallas_interpret(case, style):
    """The Pallas kernel rounds the image, the weights and its row pass to
    bf16 (2^-9 relative each); four such roundings of values up to
    ``vmax`` bound the difference, over the smallest std."""
    shape, out_hw = SHAPES[case]
    u8 = _canvas(shape, 10 + case)
    norm = NORM[style]
    want = np.asarray(resize_normalize_pallas(
        _jax_input(u8, style), out_hw, jnp.asarray(norm["mean"]),
        jnp.asarray(norm["std"]), interpret=True))
    got = resize_normalize_plain(torch.from_numpy(u8), out_hw, **norm)
    vmax = 255.0 * norm["scale"]
    tol = 4 * 2.0 ** -9 * vmax / min(norm["std"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("out_size,in_size",
                         [(32, 100), (100, 32), (7, 1), (720, 960),
                          (960, 1280), (33, 33)])
def test_taps_are_the_matrix_nonzeros(out_size, in_size):
    """The kernel's tap tables rebuild the JAX package's dense matrix."""
    taps, frac = resize_taps(out_size, in_size)
    dense = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(dense, (rows, taps[:, 0]), 1.0 - frac)
    np.add.at(dense, (rows, taps[:, 1]), frac)
    want = _resize_matrix(out_size, in_size)
    np.testing.assert_array_equal(resize_matrix(out_size, in_size), want)
    np.testing.assert_allclose(dense, want, rtol=0, atol=1e-7)
    assert (taps[:, 1] - taps[:, 0] <= 1).all()
    assert (taps >= 0).all() and (taps < in_size).all()


def test_wrapper_on_cpu_is_the_plain_version():
    u8 = torch.from_numpy(_canvas((1, 20, 30), 3))
    n0 = launch_counts["resize_normalize"]
    got = resize_normalize(u8, (16, 24), **NORM["imagenet"])
    want = resize_normalize_plain(u8, (16, 24), **NORM["imagenet"])
    assert torch.equal(got, want)
    assert launch_counts["resize_normalize"] == n0


def test_wrapper_takes_uint8_only():
    x = torch.zeros((1, 8, 8, 3), dtype=torch.float32)
    with pytest.raises(TypeError, match="uint8"):
        resize_normalize(x, (4, 4), **NORM["imagenet"])


def test_wrapper_refuses_other_devices():
    u8 = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resize_normalize(u8, (4, 4), **NORM["imagenet"])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs on a machine with the card: python -m pytest -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case, (shape, out_hw) in enumerate(SHAPES):
        for style in ("imagenet", "modelscope"):
            u8 = torch.from_numpy(_canvas(shape, case)).cuda()
            n0 = launch_counts["resize_normalize"]
            got = resize_normalize(u8, out_hw, **NORM[style])
            torch.cuda.synchronize()
            assert launch_counts["resize_normalize"] == n0 + 1
            want = resize_normalize_plain(u8, out_hw, **NORM[style])
            assert float((got - want).abs().max()) <= 1e-5
