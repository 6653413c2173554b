"""The deform conv's gradients in the port
(pdf_table_tpu_torch/ops/deform_conv.py): ``deform_conv2d_backward_plain``
against autograd of the plain versions and against ``jax.grad`` of the JAX
package's deform_conv2d (f32, its XLA path on the CPU), at a stride-1 and a
stride-2 shape with samples outside the image; and
``DeformConv2dFunction``'s plumbing on the CPU, its launch replaced by the
plain version (the kernel runs only on the card; the ``cuda`` test holds
it there)."""

import jax
import numpy as np
import pytest
import torch

from pdf_table_tpu.ops import deform_conv as jdc
from pdf_table_tpu_torch.models.lore.dla import DeformConvBlock
from pdf_table_tpu_torch.ops import deform_conv as tdc
from pdf_table_tpu_torch.ops.kernels import launch_counts

torch.set_num_threads(1)

# (B, H, W, Cin, Cout, stride, padding, dilation); offsets of 2.5 px spread
# put samples outside the image
CASES = {
    "stride1": (2, 9, 7, 32, 16, (1, 1), (1, 1), (1, 1)),
    "stride2": (2, 10, 9, 32, 8, (2, 2), (1, 1), (1, 1)),
}
NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")
# f32 on both sides; the sums run in another order. Relative to each
# gradient's largest magnitude.
REL_TOL = 1e-5
# bf16: autograd of the plain versions accumulates dx in bf16 (the gather's
# adjoint adds bf16 rows) and the flat-kc dweight sums corners rounded to
# bf16 one by one; the backward accumulates in f32 and rounds once
BF16_REL_TOL = 3e-2
# bf16 on dyadic inputs against f64 autograd of deform_conv2d_rounded: the
# rounded values agree exactly, the rest is f32 round-off. dx comes back in
# bf16: within bf16's unit roundoff of the f64 value (plus round-off near
# zero), which a correct rounding never exceeds.
ROUNDED_REL_TOL = 1e-6
BF16_ROUNDOFF = 2.0 ** -8


def _inputs(case, seed=0):
    B, H, W, C, Co, stride, padding, dilation = CASES[case]
    Ho = (H + 2 * padding[0] - dilation[0] * 2 - 1) // stride[0] + 1
    Wo = (W + 2 * padding[1] - dilation[1] * 2 - 1) // stride[1] + 1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = (rng.standard_normal((B, Ho, Wo, 18)) * 2.5).astype(np.float32)
    mask = rng.random((B, Ho, Wo, 9)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(Co).astype(np.float32)
    gout = rng.standard_normal((B, Ho, Wo, Co)).astype(np.float32)
    return (x, off, mask, w, b), gout, (stride, padding, dilation)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-12)


def _autograd(fn, arrays, gout, geo, dtype=torch.float32):
    ts = [torch.from_numpy(a) for a in arrays]
    ts[0], ts[3] = ts[0].to(dtype), ts[3].to(dtype)
    for t in ts:
        t.requires_grad_()
    out = fn(*ts, *geo)
    return torch.autograd.grad(out, ts, torch.from_numpy(gout))


def _backward(arrays, gout, geo, dtype=torch.float32, flat_kc=False):
    ts = [None if a is None else torch.from_numpy(a) for a in arrays]
    ts[0], ts[3] = ts[0].to(dtype), ts[3].to(dtype)
    return tdc.deform_conv2d_backward_plain(torch.from_numpy(gout), *ts,
                                           *geo, flat_kc=flat_kc)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_autograd_of_plain(case):
    arrays, gout, geo = _inputs(case)
    got = _backward(arrays, gout, geo)
    want = _autograd(tdc.deform_conv2d_plain, arrays, gout, geo)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        assert _rel(g.numpy(), w.numpy()) < REL_TOL, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_grad(case):
    arrays, gout, geo = _inputs(case, seed=1)
    stride, padding, dilation = geo

    def f(x, off, mask, w, b):
        return jdc.deform_conv2d(x, off, mask, w, b, stride=stride,
                                 padding=padding, dilation=dilation)

    _, vjp = jax.vjp(f, *arrays)
    want = vjp(gout)
    got = _backward(arrays, gout, geo)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w) < REL_TOL, name


@pytest.mark.parametrize("flat_kc", [False, True], ids=["tap", "flat_kc"])
def test_backward_bf16_matches_autograd_of_plain(flat_kc):
    """bf16 x and W: the tap mode's backward against autograd of the plain
    version (the column rounded once), the flat-kc mode's against autograd
    of the plain chunked version (each corner's product rounded)."""
    arrays, gout, geo = _inputs("stride1", seed=2)
    plain = tdc.deform_conv2d_chunked_plain if flat_kc \
        else tdc.deform_conv2d_plain
    got = _backward(arrays, gout, geo, torch.bfloat16, flat_kc)
    want = _autograd(plain, arrays, gout, geo, torch.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        assert _rel(g.float().numpy(), w.float().numpy()) < BF16_REL_TOL, \
            name


def _dyadic_inputs(case, seed):
    """Values on coarse binary grids: x in 1/16 steps within +-2, W in 1/64
    within +-1/2, offsets in 1/8 px within +-2.5, the mask in 1/16, dout in
    1/8 within +-1. Every value the backward rounds to bf16 (the column,
    dcol = dout @ W[t]^T, the corner weights, products and their gradients)
    is then a sum that f32 holds exactly, so f64 rounds it the same way."""
    B, H, W, C, Co, stride, padding, dilation = CASES[case]
    Ho = (H + 2 * padding[0] - dilation[0] * 2 - 1) // stride[0] + 1
    Wo = (W + 2 * padding[1] - dilation[1] * 2 - 1) // stride[1] + 1
    rng = np.random.default_rng(seed)

    def grid(shape, lo, hi, step):
        return (rng.integers(lo, hi + 1, shape) * step).astype(np.float32)

    arrays = (grid((B, H, W, C), -32, 32, 1 / 16),
              grid((B, Ho, Wo, 18), -20, 20, 1 / 8),
              grid((B, Ho, Wo, 9), 0, 16, 1 / 16),
              grid((3, 3, C, Co), -32, 32, 1 / 64),
              rng.standard_normal(Co).astype(np.float32))
    return arrays, grid((B, Ho, Wo, Co), -8, 8, 1 / 8), \
        (stride, padding, dilation)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("flat_kc", [False, True], ids=["tap", "flat_kc"])
def test_backward_bf16_rounding_points(flat_kc, case):
    """The bf16 backward rounds where it says it does: against f64 autograd
    of deform_conv2d_rounded (the column rounded for K1; each corner weight
    and product for K2; autograd rounds dcol and the corner weights'
    gradients at those casts) on dyadic inputs, to f32 round-off. The
    weight goes in as f32 holding its bf16 values, so that dW comes back
    before its final bf16 rounding; dx comes back bf16. The reference's
    forward is the plain version's."""
    arrays, gout, geo = _dyadic_inputs(case, seed=5)
    ts = [torch.from_numpy(a).double().requires_grad_() for a in arrays]
    ref_out = tdc.deform_conv2d_rounded(*ts, *geo, flat_kc=flat_kc)
    want = torch.autograd.grad(ref_out, ts, torch.from_numpy(gout).double())
    x, off, mask, w, b = (torch.from_numpy(a) for a in arrays)
    plain = tdc.deform_conv2d_chunked_plain if flat_kc \
        else tdc.deform_conv2d_plain
    fwd = plain(x.bfloat16(), off, mask, w.bfloat16(), b, *geo)
    assert _rel(fwd.numpy(), ref_out.detach().numpy()) < ROUNDED_REL_TOL
    got = tdc.deform_conv2d_backward_plain(
        torch.from_numpy(gout), x.bfloat16(), off, mask, w, b, *geo,
        flat_kc=flat_kc)
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    for name, g, r in zip(NAMES[1:], got[1:], want[1:]):
        assert _rel(g.numpy(), r.numpy()) < ROUNDED_REL_TOL, name
    dx, ref = got[0].double(), want[0]
    assert bool(((dx - ref).abs() <= BF16_ROUNDOFF * ref.abs()
                 + ROUNDED_REL_TOL * ref.abs().max()).all())


def test_backward_without_bias():
    arrays, gout, geo = _inputs("stride1")
    got = _backward(arrays[:4] + (None,), gout, geo)
    assert got[4] is None
    want = _backward(arrays, gout, geo)
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)


@pytest.fixture
def plain_launch(monkeypatch):
    """The Function's launch replaced by the plain version of its mode,
    counted, so that its forward and backward run on CPU tensors."""
    calls = []

    def launch(flat_kc, x, offset, mask, weight, bias, stride, padding,
               dilation):
        calls.append(flat_kc)
        plain = tdc.deform_conv2d_chunked_plain if flat_kc \
            else tdc.deform_conv2d_plain
        return plain(x, offset, mask, weight, bias, stride, padding,
                     dilation)

    monkeypatch.setattr(tdc, "_launch", launch)
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_gradients(plain_launch, case):
    """DeformConv2dFunction: forward through the launch, backward through
    deform_conv2d_backward_plain; the gradient arrives permuted, as from
    the DCN block, and is made contiguous."""
    arrays, gout, geo = _inputs(case, seed=3)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = tdc.DeformConv2dFunction.apply(*ts, *geo, False)
    assert out.grad_fn is not None and plain_launch == [False]
    g_nchw = torch.from_numpy(gout).permute(0, 3, 1, 2).contiguous()
    got = torch.autograd.grad(out.permute(0, 3, 1, 2), ts, g_nchw)
    want = _autograd(tdc.deform_conv2d_plain, arrays, gout, geo)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), w.numpy()) < REL_TOL, name


def test_run_takes_the_function_under_grad_mode(plain_launch, monkeypatch):
    """On a card's tensor both wrappers go through the Function every time:
    a graph under grad mode, none under no_grad or inference_mode, the
    same arithmetic and one launch each way."""
    monkeypatch.setattr(tdc, "_device_type", lambda x: "cuda")
    arrays, _, geo = _inputs("stride1")
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    for fn, flat_kc in ((tdc.deform_conv2d_tap, False),
                        (tdc.deform_conv2d_chunked, True)):
        out = fn(*ts, *geo)
        assert "DeformConv2dFunction" in type(out.grad_fn).__name__
        with torch.no_grad():
            nograd = fn(*ts, *geo)
        with torch.inference_mode():
            inference = fn(*[t.detach() for t in ts], *geo)
        assert nograd.grad_fn is None and not nograd.requires_grad
        assert torch.equal(out.detach(), nograd)
        assert torch.equal(out.detach(), inference)
        assert plain_launch[-3:] == [flat_kc] * 3
    assert len(plain_launch) == 6


def test_cpu_wrapper_is_differentiable_plain():
    """On CPU tensors deform_conv2d stays the plain version, which autograd
    differentiates; no launch is counted."""
    arrays, gout, geo = _inputs("stride2")
    before = dict(launch_counts)
    got = _autograd(tdc.deform_conv2d, arrays, gout, geo)
    want = _autograd(tdc.deform_conv2d_plain, arrays, gout, geo)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert dict(launch_counts) == before


def test_block_gradient_reaches_the_offset_conv(plain_launch, monkeypatch):
    """Through the Function (the block's own deform_conv2d, as on a card's
    tensor), a loss behind the DCN block reaches the DCN weight and bias,
    the offset/mask conv and the block's input."""
    monkeypatch.setattr(tdc, "_device_type", lambda x: "cuda")
    torch.manual_seed(0)
    block = DeformConvBlock(32, 16)
    torch.nn.init.normal_(block.weight, std=0.1)
    torch.nn.init.normal_(block.conv_offset_mask.weight, std=0.1)
    x = torch.randn(2, 32, 6, 5).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    block(x).square().sum().backward()
    assert plain_launch == [False]
    for t in (x, block.weight, block.bias, block.conv_offset_mask.weight,
              block.conv_offset_mask.bias, block.bn.weight):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)


@pytest.mark.cuda
def test_function_gradients_on_card():
    """Runs on a machine with the card: python -m pytest -m cuda. The
    kernel's tap mode (f32 and bf16) and flat-kc mode (bf16) made
    differentiable, against autograd of their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    B, H, W, C, Co = 2, 20, 18, 64, 72
    arrays = [rng.standard_normal((B, H, W, C)).astype(np.float32),
              (rng.standard_normal((B, H, W, 18)) * 3).astype(np.float32),
              rng.random((B, H, W, 9)).astype(np.float32),
              (rng.standard_normal((3, 3, C, Co)) * 0.1).astype(np.float32),
              rng.standard_normal(Co).astype(np.float32)]
    gout = torch.from_numpy(
        rng.standard_normal((B, H, W, Co)).astype(np.float32)).to(dev)
    for fn, plain, dtype, tol, name in (
            (tdc.deform_conv2d_tap, tdc.deform_conv2d_plain, torch.float32,
             1e-4, "deform_conv2d"),
            (tdc.deform_conv2d_tap, tdc.deform_conv2d_plain, torch.bfloat16,
             BF16_REL_TOL, "deform_conv2d"),
            (tdc.deform_conv2d_chunked, tdc.deform_conv2d_chunked_plain,
             torch.bfloat16, BF16_REL_TOL, "deform_conv2d_flat_kc")):
        grads = []
        for f in (fn, plain):
            ts = [torch.from_numpy(a).to(dev) for a in arrays]
            ts[0], ts[3] = ts[0].to(dtype), ts[3].to(dtype)
            for t in ts:
                t.requires_grad_()
            before = launch_counts[name]
            out = f(*ts)
            assert launch_counts[name] == before + (f is fn)
            grads.append(torch.autograd.grad(out, ts, gout))
        for n, g, w in zip(NAMES, *grads):
            err = float((g.float() - w.float()).abs().max()
                        / w.float().abs().max())
            assert err < tol, (name, dtype, n, err)
