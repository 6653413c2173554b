"""The DCN kernel's f32 body on the CPU: its rounding (split_tf32), its
plain twin deform_conv2d_3xtf32_plain against the JAX package's f32 XLA
deform conv and against an f64 evaluation of the same columns, and its
tiling and shared-memory arithmetic (pdf_table_tpu_torch/ops/deform_conv.py).
Inputs come from numpy with a fixed seed."""

import numpy as np
import pytest
import torch

from pdf_table_tpu.ops import deform_conv as jdc
from pdf_table_tpu_torch.ops import deform_conv as tdc

torch.set_num_threads(1)

# (B, H, W, Cin, Cout, stride, padding, dilation): test_torch_deform_conv's
# CASES, then the f32 body's edges: Cout = 72 (a ragged channel tile),
# pixels ragged against the 64-pixel tiles, stride 2
CASES = [
    (2, 9, 7, 32, 16, (1, 1), (1, 1), (1, 1)),
    (1, 12, 10, 64, 24, (1, 1), (1, 1), (1, 1)),
    (2, 10, 9, 32, 8, (2, 2), (1, 1), (1, 1)),
    (1, 11, 11, 32, 8, (1, 1), (2, 2), (2, 2)),
    (2, 9, 11, 32, 72, (1, 1), (1, 1), (1, 1)),
    (1, 13, 9, 32, 72, (2, 2), (1, 1), (1, 1)),
]
TF32_LOW = 0x1FFF        # the 13 mantissa bits tf32 drops


def _inputs(B, H, W, C, Co, stride, padding, dilation, seed=0):
    Ho, Wo = tdc._out_hw(H, W, 3, 3, stride, padding, dilation)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = (rng.standard_normal((B, Ho, Wo, 18)) * 2.5).astype(np.float32)
    mask = rng.random((B, Ho, Wo, 9)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(Co).astype(np.float32)
    return x, off, mask, w, b


def _edge_values() -> np.ndarray:
    """Random values over many binades, subnormals, +-0, powers of two,
    ties and values one ulp either side of a tie, both signs."""
    rng = np.random.default_rng(7)
    vals = [rng.standard_normal(2000)
            * np.exp2(rng.integers(-60, 60, 2000)),
            np.exp2(np.arange(-149, 128, dtype=np.float64)),
            [0.0, 1.4e-45, 3e-42, 1e-40, 1.1754942e-38, 1.1754944e-38]]
    mant = rng.integers(0, 1 << 10, 200, dtype=np.int64) << 13
    expo = rng.integers(1, 254, 200, dtype=np.int64) << 23
    base = mant | expo                              # tf32 values
    for low in (0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x0001):
        vals.append((base | low).astype(np.uint32).view(np.float32))
    sub = rng.integers(1, 1 << 23, 200, dtype=np.int64)   # subnormals
    vals.append(sub.astype(np.uint32).view(np.float32))
    v = np.concatenate([np.asarray(a, np.float64).ravel() for a in vals])
    v = np.concatenate([v, -v]).astype(np.float32)
    return v[np.abs(v) < 3.0e38]                    # no rounding to inf


def _rna_reference(v: np.ndarray) -> np.ndarray:
    """tf32 round to nearest, ties away from zero, in f64: 10 mantissa
    bits, the subnormal spacing 2^-136."""
    a = np.abs(v.astype(np.float64))
    _, e = np.frexp(np.where(a > 0, a, 1.0))       # a = m * 2^e, m in [.5, 1)
    ulp = np.exp2(np.maximum(e - 11, -136).astype(np.float64))
    return (np.sign(v) * np.floor(a / ulp + 0.5) * ulp).astype(np.float32)


def test_split_tf32_rounds_to_nearest_ties_away():
    v = _edge_values()
    hi, lo = tdc.split_tf32(torch.from_numpy(v))
    for part in (hi, lo):
        assert int((part.view(torch.int32) & TF32_LOW).abs().max()) == 0
    np.testing.assert_array_equal(hi.numpy(), _rna_reference(v))
    np.testing.assert_array_equal(
        lo.numpy(), _rna_reference((v - hi.numpy()).astype(np.float32)))
    # a tie rounds away from zero, one ulp under it towards zero
    bits = v.view(np.uint32) & TF32_LOW
    tie, under = bits == 0x1000, bits == 0x0FFF
    assert tie.sum() >= 400 and under.sum() >= 400
    assert np.all(np.abs(hi.numpy()[tie]) > np.abs(v[tie]))
    assert np.all(np.abs(hi.numpy()[under]) < np.abs(v[under]))


def test_split_tf32_reproduces_x():
    v = _edge_values()
    hi, lo = tdc.split_tf32(torch.from_numpy(v))
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - v)
    # 2^-21 relative; below the normal range tf32's spacing is 2^-136,
    # so lo keeps x to half of it
    bound = np.maximum(np.abs(v.astype(np.float64)) * 2.0 ** -21,
                       2.0 ** -137)
    assert np.all(err <= bound)
    assert np.array_equal(hi.numpy()[v == 0], v[v == 0])
    # hi alone drops up to 2^-11: the lo term is what makes it f32-class
    assert float((np.abs(hi.numpy() - v)
                  / np.maximum(np.abs(v), 1e-30)).max()) > 2.0 ** -13


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_plain_matches_jax_f32(case):
    *shape, stride, padding, dilation = case
    x, off, mask, w, b = _inputs(*shape, stride, padding, dilation)
    want = np.asarray(jdc.deform_conv2d(x, off, mask, w, b, stride=stride,
                                        padding=padding, dilation=dilation))
    got = tdc.deform_conv2d_3xtf32_plain(
        *(torch.from_numpy(a) for a in (x, off, mask, w, b)), stride,
        padding, dilation).numpy()
    assert got.shape == want.shape
    # f32-class on both sides (the 3xTF32 split against XLA's f32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _f64_of_columns(x, off, mask, w, b, geo):
    """The DCN in f64 on the plain version's f32 columns."""
    Cin, Cout = w.shape[2:]
    wmat = w.reshape(9, Cin, Cout).double()
    out = sum(col.double() @ wmat[t] for t, col in enumerate(
        tdc.tap_columns(x, off, mask, (3, 3), *geo)))
    return out + b.double()


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_plain_is_f32_class(case):
    """Against an f64 evaluation of the same columns, the 3xTF32 sum's
    error is at most twice the plain f32 version's; a single TF32 product
    (the lo terms dropped) misses that bound by orders of magnitude."""
    *shape, stride, padding, dilation = case
    geo = (stride, padding, dilation)
    ts = [torch.from_numpy(a)
          for a in _inputs(*shape, stride, padding, dilation, seed=3)]
    ref = _f64_of_columns(*ts, geo).reshape(-1)
    scale = float(ref.abs().max())

    def err(out):
        return float((out.double().reshape(-1) - ref).abs().max()) / scale

    e32 = err(tdc.deform_conv2d_plain(*ts, *geo))
    e3 = err(tdc.deform_conv2d_3xtf32_plain(*ts, *geo))
    x, off, mask, w, b = ts
    w_hi, _ = tdc.split_tf32(w.reshape(9, *w.shape[2:]))
    one = sum(tdc.split_tf32(col)[0] @ w_hi[t] for t, col in enumerate(
        tdc.tap_columns(x, off, mask, (3, 3), *geo))) + b
    assert e3 <= 2 * e32, (e3, e32)
    assert err(one) > 2 * e32 and err(one) > 1e-5, (err(one), e32)


def test_kernel_tiling_f32():
    """The f32 body's tiling at the slices' shapes (B = 8): 128-pixel
    blocks on all of a 64- or 128-wide Cout, two warpgroups on 64 pixels
    for 256; the deep, small levels in tap groups (a third of the taps, or
    one each) rather than narrower tiles."""
    tiling = tdc.kernel_tiling_f32
    P = 8
    # 768^2 wireless crops
    assert tiling(P * 192 * 192, 64, 64) == (64, 2, 1, 9)
    assert tiling(P * 96 * 96, 128, 128) == (128, 2, 1, 9)
    assert tiling(P * 48 * 48, 256, 256) == (256, 1, 1, 9)
    assert tiling(P * 24 * 24, 256, 512) == (256, 1, 1, 3)
    # 384^2 bucket: deep levels under one block an SM
    assert tiling(P * 24 * 24, 64, 256) == (64, 1, 1, 3)
    assert tiling(P * 12 * 12, 256, 512) == (256, 1, 1, 1)
    # 1024^2 (wtw, Cycle-CenterNet)
    assert tiling(P * 256 * 256, 64, 64) == (64, 2, 1, 9)
    assert tiling(P * 64 * 64, 256, 256) == (256, 1, 1, 9)
    assert tiling(P * 32 * 32, 256, 512) == (256, 1, 1, 3)
    # small and odd shapes: Cout split, narrower tiles as the bf16 body
    assert tiling(2 * 20 * 18, 72, 64) == (64, 1, 2, 1)
    assert tiling(256, 300, 64) == (64, 1, 5, 1)


@pytest.mark.parametrize("cin", [32, 64, 128, 256, 512, 1024])
def test_kernel_tiling_f32_fits(cin):
    """Every tiling the f32 body can be given fits in shared memory and
    has at most two warpgroups; a tap group is at most 72 K steps deep
    wherever one tap is."""
    for p in (1, 63, 64, 65, 1000, 4608, 8448, 16896, 18432, 73728, 295000):
        for cout in (1, 7, 8, 64, 72, 128, 130, 256, 300, 512):
            n_tile, wgs, nsplit, tg = tdc.kernel_tiling_f32(p, cout, cin)
            assert n_tile in (64, 128, 256) and wgs in (1, 2)
            assert wgs * (2 if n_tile == 256 else 1) <= 2
            assert nsplit * n_tile >= cout > (nsplit - 1) * n_tile
            assert tdc._smem_bytes_f32(n_tile, wgs) <= tdc.MAX_SMEM
            assert tg in (1, 3, 9)
            assert tg == 1 or tg * cin // 32 <= tdc.MAX_CHAIN_F32
    for n_tile in (64, 128, 256):
        for wgs in (1, 2):
            assert tdc._smem_bytes_f32(n_tile, wgs) <= tdc.MAX_SMEM


def test_check_refuses_what_the_f32_body_cannot_take():
    x = torch.zeros(1, 6, 6, 48)
    off, mask = torch.zeros(1, 6, 6, 18), torch.zeros(1, 6, 6, 9)
    with pytest.raises(ValueError, match="Cin % 32"):
        tdc._check(x, off, mask, torch.zeros(3, 3, 48, 8), None, 6, 6)
    tdc._check(x[..., :32].contiguous(), off, mask,
               torch.zeros(3, 3, 32, 7), None, 6, 6)
