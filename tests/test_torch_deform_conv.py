"""The port's deform conv (pdf_table_tpu_torch/ops/deform_conv.py) against
the JAX package: its f32 XLA path, the numpy reference, and in bf16 the
tap-major Pallas kernel run in interpret mode. Inputs come from numpy with a
fixed seed; offsets are fractional and reach outside the image."""

import jax.numpy as jnp
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
    # the TPU kernel rounds the blended corners to bf16 before its bf16
    # matmul; the plain version blends and contracts in f32
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) / scale < 2e-2


def test_wrapper_on_cpu_is_the_plain_version():
    x, off, mask, w, b = _inputs(1, 8, 8, 32, 8, (1, 1), (1, 1), (1, 1))
    before = launch_counts["deform_conv2d"]
    got = tdc.deform_conv2d(*(torch.from_numpy(a)
                              for a in (x, off, mask, w, b))).numpy()
    want = _plain(x, off, mask, w, b, (1, 1), (1, 1), (1, 1))
    np.testing.assert_array_equal(got, want)
    assert launch_counts["deform_conv2d"] == before


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 4, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdc.deform_conv2d(x, torch.zeros(1, 4, 4, 18, device="meta"),
                          torch.zeros(1, 4, 4, 9, device="meta"),
                          torch.zeros(3, 3, 32, 8, device="meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs on a machine with the card: python -m pytest -m cuda."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the same operands on both sides, summed in f32 in another order
    for dtype, tol in ((torch.bfloat16, 1e-4), (torch.float32, 1e-4)):
        x, off, mask, w, b = _inputs(2, 20, 18, 64, 72, (1, 1), (1, 1),
                                     (1, 1), off_scale=3.0)
        dev = torch.device("cuda")
        xt = torch.from_numpy(x).to(dev, dtype)
        wt = torch.from_numpy(w).to(dev, dtype)
        rest = [torch.from_numpy(a).to(dev) for a in (off, mask)]
        bt = torch.from_numpy(b).to(dev)
        before = launch_counts["deform_conv2d"]
        got = tdc.deform_conv2d(xt, *rest, wt, bt)
        torch.cuda.synchronize()
        assert launch_counts["deform_conv2d"] == before + 1
        want = tdc.deform_conv2d_plain(xt, *rest, wt, bt)
        err = float((got - want).abs().max() / want.abs().max())
        assert err < tol, (dtype, err)
