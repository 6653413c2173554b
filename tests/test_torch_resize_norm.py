"""The port's resize + normalize (K3) against the JAX package: the plain
PyTorch version against ``resize_normalize_xla`` (both f32, atol 1e-5)
and against the interpret-mode Pallas kernel (bf16 operands inside it),
at downscale, upscale, ``in_size == 1``, ragged sizes and both norm
styles. The kernel itself runs only on a card (``-m cuda``), both of its
bodies; the rule that picks between them is a pure function of the shape
and is held here."""

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
                                                 resize_taps, vector_tile)
from pdf_table_tpu_torch.ops.resize_norm import (VEC_PIXELS, VEC_ROWS,
                                                 VEC_SMEM_MAX, kernel_route)
from pdf_table_tpu_torch.tasks.detection import NORM

torch.set_num_threads(1)

# (N, H, W) -> (Ho, Wo)
SHAPES = [
    ((2, 40, 56), (32, 24)),      # downscale
    ((1, 12, 10), (30, 27)),      # upscale, ragged
    ((2, 1, 9), (8, 16)),         # in_size == 1 on one axis
    ((1, 37, 53), (37, 53)),      # same size
    ((3, 64, 48), (48, 36)),      # a page bucket's 4:3, cut small
    ((3, 96, 208), (50, 132)),    # ragged tiles in rows and columns
    ((2, 24, 32), (40, 64)),      # upscale with 16-byte rows
    ((1, 1, 16), (8, 16)),        # in_size == 1, 16-byte rows
]
# which of SHAPES the kernel's vector body takes (the others: the scalar)
VECTOR_SHAPES = {4, 5, 6, 7}


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


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_kernel_route_by_shape(case):
    (_, H, W), (Ho, Wo) = SHAPES[case]
    want = "vector" if case in VECTOR_SHAPES else "scalar"
    assert kernel_route(H, W, Ho, Wo) == want


@pytest.mark.parametrize("hw,det,route", [
    ((1280, 960), (960, 720), "vector"),    # the three page buckets
    ((1600, 1280), (960, 768), "vector"),
    ((2048, 1536), (960, 720), "vector"),
    ((1280, 960), (960, 718), "scalar"),    # Wo % 4 != 0
    ((1280, 952), (960, 720), "scalar"),    # canvas rows off 16 bytes
    ((480, 360), (960, 720), "scalar"),     # 1080-byte rows
    ((8192, 8192), (960, 720), "scalar"),   # the tile's span is too wide
])
def test_vector_tile_rule(hw, det, route):
    """The vector body's tile: the widest source span of any tile of
    VEC_ROWS x VEC_PIXELS outputs, from the tap tables."""
    tile = vector_tile(*hw, *det)
    assert kernel_route(*hw, *det) == route
    assert (tile is not None) == (route == "vector")
    if tile is None:
        return
    pitch, rows = tile
    assert pitch % 16 == 0 and pitch * rows <= VEC_SMEM_MAX
    ytaps, _ = resize_taps(det[0], hw[0])
    xtaps, _ = resize_taps(det[1], hw[1])
    for o0 in range(0, det[0], VEC_ROWS):
        o1 = min(o0 + VEC_ROWS, det[0]) - 1
        assert ytaps[o1, 1] - ytaps[o0, 0] + 1 <= rows
    for p0 in range(0, det[1], VEC_PIXELS):
        p1 = min(p0 + VEC_PIXELS, det[1]) - 1
        lo = xtaps[p0, 0] * 3 // 16 * 16
        hi = -(-(xtaps[p1, 1] * 3 + 3) // 16) * 16
        # the tile's own span fits the pitch and stays inside its row
        assert hi - lo <= pitch and hi <= hw[1] * 3


def test_route_argument_is_checked():
    u8 = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown resize_normalize route"):
        resize_normalize(u8, (4, 4), route="fast", **NORM["imagenet"])
    # on the CPU the plain version runs whichever body is named
    assert resize_normalize(u8, (4, 4), route="scalar",
                            **NORM["imagenet"]).shape == (1, 4, 4, 3)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs on a machine with the card: python -m pytest -m cuda. Every
    shape through the scalar body, and through the vector body where it
    takes the shape; the default route is the shape rule's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case, (shape, out_hw) in enumerate(SHAPES):
        routes = [None, "scalar"] + (["vector"] if case in VECTOR_SHAPES
                                     else [])
        for style in ("imagenet", "modelscope"):
            u8 = torch.from_numpy(_canvas(shape, case)).cuda()
            want = resize_normalize_plain(u8, out_hw, **NORM[style])
            for route in routes:
                n0 = launch_counts["resize_normalize"]
                got = resize_normalize(u8, out_hw, route=route,
                                       **NORM[style])
                torch.cuda.synchronize()
                assert launch_counts["resize_normalize"] == n0 + 1
                assert float((got - want).abs().max()) <= 1e-5
        if case not in VECTOR_SHAPES:
            with pytest.raises(ValueError, match="vector body"):
                resize_normalize(u8, out_hw, route="vector",
                                 **NORM["imagenet"])
