"""The port's deform conv (pdf_table_tpu_torch/ops/deform_conv.py) against
the JAX package: its f32 XLA path, the numpy reference, and in bf16 the
tap-major Pallas kernel run in interpret mode and a column built in numpy.
Inputs come from numpy with a fixed seed; offsets are fractional and reach
outside the image."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pdf_table_tpu.ops import deform_conv as jdc
from pdf_table_tpu_torch.ops import deform_conv as tdc
from pdf_table_tpu_torch.ops.kernels import launch_counts

torch.set_num_threads(1)

# (B, H, W, Cin, Cout, stride, padding, dilation)
CASES = [
    (2, 9, 7, 32, 16, (1, 1), (1, 1), (1, 1)),
    (1, 12, 10, 64, 24, (1, 1), (1, 1), (1, 1)),
    (2, 10, 9, 32, 8, (2, 2), (1, 1), (1, 1)),
    (1, 11, 11, 32, 8, (1, 1), (2, 2), (2, 2)),
]


def _inputs(B, H, W, C, Co, stride, padding, dilation, seed=0,
            off_scale=2.5):
    Ho = (H + 2 * padding[0] - dilation[0] * 2 - 1) // stride[0] + 1
    Wo = (W + 2 * padding[1] - dilation[1] * 2 - 1) // stride[1] + 1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = (rng.standard_normal((B, Ho, Wo, 18)) * off_scale) \
        .astype(np.float32)
    mask = rng.random((B, Ho, Wo, 9)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(Co).astype(np.float32)
    return x, off, mask, w, b


def _plain(x, off, mask, w, b, stride, padding, dilation, dtype=None):
    xt = torch.from_numpy(x)
    wt = torch.from_numpy(w)
    if dtype is not None:
        xt, wt = xt.to(dtype), wt.to(dtype)
    return tdc.deform_conv2d_plain(
        xt, torch.from_numpy(off), torch.from_numpy(mask), wt,
        torch.from_numpy(b), stride, padding, dilation).numpy()


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_f32(case):
    *shape, stride, padding, dilation = case
    x, off, mask, w, b = _inputs(*shape, stride, padding, dilation)
    want = np.asarray(jdc.deform_conv2d(x, off, mask, w, b, stride=stride,
                                        padding=padding, dilation=dilation))
    got = _plain(x, off, mask, w, b, stride, padding, dilation)
    assert got.shape == want.shape
    # f32 on both sides; only the summation order differs
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_numpy_reference(case):
    *shape, stride, padding, dilation = case
    x, off, mask, w, b = _inputs(*shape, stride, padding, dilation, seed=1)
    want = jdc.deform_conv2d_reference_numpy(x, off, mask, w, b, stride,
                                             padding, dilation)
    got = _plain(x, off, mask, w, b, stride, padding, dilation)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed,cin,cout", [(0, 32, 16), (3, 32, 40)])
def test_plain_bf16_matches_pallas_tap_kernel(monkeypatch, seed, cin, cout):
    """JAX deform_conv2d forced through the tap branch, its Pallas kernel
    run in interpret mode (as tests/test_deform_blend.py does): HW = 256 is
    one 256-row tile and 4*Cin = 128."""
    import jax.experimental.pallas as pl

    from pdf_table_tpu.ops.pallas import deform_blend as dbm

    B, H, W = 2, 16, 16
    x, off, mask, w, b = _inputs(B, H, W, cin, cout, (1, 1), (1, 1), (1, 1),
                                 seed=seed, off_scale=1.5)
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    monkeypatch.setattr(dbm, "blend_tap_supported", lambda *a, **k: 256)
    jdc.deform_conv2d.clear_cache()
    try:
        want = np.asarray(jdc.deform_conv2d(
            jnp.asarray(x, jnp.bfloat16), off, mask,
            jnp.asarray(w, jnp.bfloat16), b))
    finally:
        jdc.deform_conv2d.clear_cache()
    got = _plain(x, off, mask, w, b, (1, 1), (1, 1), (1, 1),
                 dtype=torch.bfloat16)
    # the TPU kernel rounds each corner's product to bf16 before its bf16
    # matmul; the plain version blends in f32 and rounds the column once
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) / scale < 2e-2


@pytest.mark.parametrize("case", CASES)
def test_plain_bf16_matches_jax_f32(case):
    """bf16 x and W through the plain version (the tap kernel's column
    rounding) against JAX's f32 XLA path on the same bf16-valued inputs:
    the one rounding of each blended column (2^-9 relative) spread over a
    9*Cin-deep f32 contraction."""
    *shape, stride, padding, dilation = case
    x, off, mask, w, b = _inputs(*shape, stride, padding, dilation, seed=2)
    x, w = _bf16_values(x), _bf16_values(w)
    want = np.asarray(jdc.deform_conv2d(x, off, mask, w, b, stride=stride,
                                        padding=padding, dilation=dilation))
    got = _plain(x, off, mask, w, b, stride, padding, dilation,
                 dtype=torch.bfloat16)
    assert float(np.abs(got - want).max()) / float(np.abs(want).max()) < 1e-2


def _bf16_values(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _numpy_bf16_column_dcn(x, off, mask, w, b):
    """3x3 DCNv2 at stride, padding and dilation 1 in numpy: per tap the
    four corners blended in f32 (weights ((lerp_y * lerp_x) * in_bounds) *
    mask, corners in the order (0,0), (0,1), (1,0), (1,1)), the column
    rounded once to bf16, then contracted in f32."""
    B, H, W, C = x.shape
    Co = w.shape[-1]
    f32 = np.float32
    out = np.zeros((B * H * W, Co), f32)
    bi = np.arange(B)[:, None, None]
    for t in range(9):
        ky, kx = divmod(t, 3)
        sy = (np.arange(H, dtype=f32) - 1 + ky)[None, :, None] \
            + off[..., 2 * t]
        sx = (np.arange(W, dtype=f32) - 1 + kx)[None, None, :] \
            + off[..., 2 * t + 1]
        y0, x0 = np.floor(sy), np.floor(sx)
        wy, wx = sy - y0, sx - x0
        col = np.zeros((B, H, W, C), f32)
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            yy = y0.astype(np.int64) + dy
            xx = x0.astype(np.int64) + dx
            ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            ly = wy if dy else f32(1) - wy
            lx = wx if dx else f32(1) - wx
            wq = (ly * lx) * ok * mask[..., t]
            g = x[bi, yy.clip(0, H - 1), xx.clip(0, W - 1)]
            col = col + g * wq[..., None]
        out += _bf16_values(col).reshape(-1, C) @ w[ky, kx]
    return out.reshape(B, H, W, Co) + b


@pytest.mark.parametrize("seed,cin,cout", [(4, 32, 16), (5, 64, 24)])
def test_plain_bf16_is_a_bf16_column_contracted_in_f32(seed, cin, cout):
    """The plain version for bf16 x against the column built independently
    in numpy: the same f32 blend in the same order, so the same bf16
    column; only the f32 contraction's summation order differs. A column
    left unrounded, or rounded per corner, differs by ~1e-3."""
    x, off, mask, w, b = _inputs(2, 9, 11, cin, cout, (1, 1), (1, 1),
                                 (1, 1), seed=seed)
    x, w = _bf16_values(x), _bf16_values(w)
    want = _numpy_bf16_column_dcn(x, off, mask, w, b)
    got = _plain(x, off, mask, w, b, (1, 1), (1, 1), (1, 1),
                 dtype=torch.bfloat16)
    assert float(np.abs(got - want).max()) / float(np.abs(want).max()) < 1e-5


def test_kernel_tiling():
    """The bf16 body's tiling at the slices' shapes (B = 8): 128-pixel
    blocks over all of Cout where they cover the 132 SMs; the deep levels
    take 64-pixel blocks and split Cout in halves."""
    tiling = tdc.kernel_tiling
    assert tiling(8 * 192 * 192, 64, False) == (64, 2, 1)
    assert tiling(8 * 48 * 48, 256, False) == (256, 2, 1)
    assert tiling(8 * 24 * 24, 256, False) == (128, 1, 2)
    assert tiling(8 * 32 * 32, 256, False) == (128, 1, 2)
    assert tiling(8 * 256 * 256, 64, True) == (64, 2, 1)
    assert tiling(8 * 256 * 256, 256, True) == (256, 1, 1)
    assert tiling(1000, 72, True) == (64, 1, 2)
    for flat_kc in (False, True):
        for n_tile in (64, 128, 256):
            for wgs in (1, 2):
                fits = tdc._smem_bytes(flat_kc, n_tile, wgs) <= tdc.MAX_SMEM
                assert fits or (flat_kc and n_tile == 256 and wgs == 2)


def test_wrapper_on_cpu_is_the_plain_version():
    x, off, mask, w, b = _inputs(1, 8, 8, 32, 8, (1, 1), (1, 1), (1, 1))
    before = dict(launch_counts)
    got = tdc.deform_conv2d(*(torch.from_numpy(a)
                              for a in (x, off, mask, w, b))).numpy()
    want = _plain(x, off, mask, w, b, (1, 1), (1, 1), (1, 1))
    np.testing.assert_array_equal(got, want)
    assert dict(launch_counts) == before


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdc.deform_conv2d(x, torch.zeros(1, 4, 4, 18, device="meta"),
                          torch.zeros(1, 4, 4, 9, device="meta"),
                          torch.zeros(3, 3, 32, 8, device="meta"))


# the f32 body against deform_conv2d_3xtf32_plain: the same split
# operands, f32 sums in another order (tensor-core groups of 8 summed per
# K step, torch's matmul), each some 3e-7 of max |out| from exact at the
# LORE depths
TF32_TOL = 2e-6
# (B, H, W, Cin, Cout) of the f32 body: a 64-wide tile on 128-pixel blocks,
# a 256 tile (two warpgroups) in three tap groups, Cout split in nine tap
# groups, a Cout no tile divides
F32_CARD_SHAPES = [(8, 48, 48, 64, 64), (8, 24, 24, 512, 256),
                   (1, 16, 16, 64, 300), (1, 9, 11, 32, 7)]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs on a machine with the card: python -m pytest -m cuda. Both
    modes of the kernel, bf16, and the tap mode's f32 body, at a shape
    ragged in pixels with Cout = 72 (two Cout splits); the f32 body also at
    F32_CARD_SHAPES, against deform_conv2d_3xtf32_plain and, with an f64
    evaluation of the same columns, no more than twice the plain f32
    version's error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x, off, mask, w, b = _inputs(2, 20, 18, 64, 72, (1, 1), (1, 1), (1, 1),
                                 off_scale=3.0)
    rest = [torch.from_numpy(a).to(dev) for a in (off, mask)]
    bt = torch.from_numpy(b).to(dev)
    # the same operands on both sides, summed in f32 in another order
    for fn, plain, dtype, name in (
            (tdc.deform_conv2d_tap, tdc.deform_conv2d_plain, torch.bfloat16,
             "deform_conv2d"),
            (tdc.deform_conv2d_tap, tdc.deform_conv2d_plain, torch.float32,
             "deform_conv2d"),
            (tdc.deform_conv2d_chunked, tdc.deform_conv2d_chunked_plain,
             torch.bfloat16, "deform_conv2d_flat_kc")):
        xt = torch.from_numpy(x).to(dev, dtype)
        wt = torch.from_numpy(w).to(dev, dtype)
        before = launch_counts[name]
        got = fn(xt, *rest, wt, bt)
        torch.cuda.synchronize()
        assert launch_counts[name] == before + 1
        want = plain(xt, *rest, wt, bt)
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-4, (name, dtype, err)
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in F32_CARD_SHAPES:
        ts = [torch.from_numpy(a).to(dev) for a in _inputs(
            *shape, (1, 1), (1, 1), (1, 1), off_scale=3.0)]
        got = tdc.deform_conv2d_tap(*ts).double()
        plain = tdc.deform_conv2d_plain(*ts).double()
        cin, cout = shape[3:]
        ref = sum(col.double() @ ts[3].reshape(9, cin, cout)[t].double()
                  for t, col in enumerate(tdc.tap_columns(
                      *ts[:3], (3, 3)))).reshape(got.shape) + ts[4].double()
        scale = float(ref.abs().max())

        def rel(a, b):
            return float((a - b).abs().max()) / scale

        assert rel(got, plain) < 1e-4, shape
        assert rel(got, tdc.deform_conv2d_3xtf32_plain(*ts).double()) \
            < TF32_TOL, shape
        assert rel(got, ref) <= 2 * rel(plain, ref), shape
