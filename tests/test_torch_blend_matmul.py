"""The flat-kc DCNv2 back half's plain version
(pdf_table_tpu_torch/ops/blend_matmul.py) and the deform conv's flat-kc
route (ops/deform_conv.py: the kernel's flat-kc mode and its plain chunked
twin) against the JAX package: blend_matmul_xla, the Pallas kernel in
interpret mode, JAX deform_conv2d forced through its chunk branch, and the
route JAX chooses on a TPU. Inputs come from numpy with fixed seeds."""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.ops import deform_conv as jdc
from pdf_table_tpu.ops.pallas import deform_blend as dbm
from pdf_table_tpu_torch.ops import deform_conv as tdc
from pdf_table_tpu_torch.ops.blend_matmul import blend_matmul_plain
from pdf_table_tpu_torch.ops.kernels import launch_counts

torch.set_num_threads(1)

# K2 plain version against blend_matmul_xla: the same bf16 roundings of the
# blended product; only the f32 summation order differs. Relative to the
# output's largest magnitude.
K2_TOL = 1e-5
# the chunked route against JAX's chunk branch: the sample points, w4 and
# the bf16 rows are the same operations in the same order on both sides, so
# only the f32 summation order differs (4.6e-7 at these seeds; a bf16 w4 on
# a rounding boundary that an f32 ulp tipped would show as ~1e-3). Relative
# to the output's largest magnitude.
CHUNK_TOL = 1e-5


def _k2_inputs(np_, t, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    kc = t * 4 * cin
    g2 = rng.standard_normal((np_, kc)).astype(np.float32)
    w4 = rng.random((np_, t * 4)).astype(np.float32)
    wrep = (rng.standard_normal((kc, cout)) * 0.1).astype(np.float32)
    return [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in (g2, w4, wrep)]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


K2_CASES = [(cin, t, cout) for cin in (32, 64) for t in (1, 5, 9)
            for cout in (16, 64)]


@pytest.mark.parametrize("cin,t,cout", K2_CASES)
def test_plain_matches_blend_matmul_xla(cin, t, cout):
    g2, w4, wrep = _k2_inputs(512, t, cin, cout, seed=t)
    exp = dbm.expand_matrix(t * 4, cin)
    want = np.asarray(dbm.blend_matmul_xla(
        jnp.asarray(g2, jnp.bfloat16), jnp.asarray(w4, jnp.bfloat16), exp,
        jnp.asarray(wrep, jnp.bfloat16)))
    got = blend_matmul_plain(_bf16(g2), _bf16(w4), _bf16(wrep), cin)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= K2_TOL


@pytest.mark.parametrize("cin,t,cout", [(32, 1, 16), (64, 5, 64),
                                        (32, 9, 64), (64, 9, 16)])
def test_plain_matches_pallas_kernel(interpret, cin, t, cout):
    """The TPU kernel in interpret mode, as tests/test_deform_blend.py
    runs it: it rounds the blended product to bf16 as the plain version
    does."""
    g2, w4, wrep = _k2_inputs(512, t, cin, cout, seed=10 + t)
    want = np.asarray(dbm._blend_matmul_fwd_impl(
        jnp.asarray(g2, jnp.bfloat16), jnp.asarray(w4, jnp.bfloat16),
        dbm.expand_matrix(t * 4, cin), jnp.asarray(wrep, jnp.bfloat16)))
    got = blend_matmul_plain(_bf16(g2), _bf16(w4), _bf16(wrep), cin).numpy()
    assert _rel(got, want) <= K2_TOL


def test_wrapper_on_cpu_is_the_plain_version():
    """The flat-kc entry on CPU tensors is the plain chunked version, and
    launches nothing."""
    x, off, mask, w, b = _dcn_inputs(2, 16, 8, 32, 16, seed=5)
    ts = [torch.from_numpy(a) for a in (x, off, mask, w, b)]
    ts[0], ts[3] = ts[0].bfloat16(), ts[3].bfloat16()
    before = dict(launch_counts)
    got = tdc.deform_conv2d_chunked(*ts)
    assert torch.equal(got, tdc.deform_conv2d_chunked_plain(*ts))
    assert dict(launch_counts) == before


def test_wrapper_refuses_other_devices():
    z = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdc.deform_conv2d_chunked(
            z, torch.zeros(1, 4, 4, 18, device="meta"),
            torch.zeros(1, 4, 4, 9, device="meta"),
            torch.zeros(3, 3, 64, 16, dtype=torch.bfloat16, device="meta"))


# ---------------------------------------------------------------------------
# the chunked route
# ---------------------------------------------------------------------------


def _dcn_inputs(B, H, W, C, Co, seed):
    rng = np.random.default_rng(seed)
    x = np.array(jnp.asarray(rng.standard_normal((B, H, W, C)),
                             jnp.bfloat16).astype(jnp.float32))
    off = (rng.standard_normal((B, H, W, 18)) * 1.5).astype(np.float32)
    mask = rng.random((B, H, W, 9)).astype(np.float32)
    w = np.array(jnp.asarray(rng.standard_normal((3, 3, C, Co)) * 0.1,
                             jnp.bfloat16).astype(jnp.float32))
    b = rng.standard_normal(Co).astype(np.float32)
    return x, off, mask, w, b


def _port_chunked(x, off, mask, w, b, tap_chunk=None):
    return tdc.deform_conv2d_chunked_plain(
        _bf16(x), torch.from_numpy(off), torch.from_numpy(mask), _bf16(w),
        torch.from_numpy(b), tap_chunk=tap_chunk).numpy()


@pytest.mark.parametrize("seed,B,H,W,C,Co", [(3, 2, 16, 8, 32, 16),
                                             (4, 1, 16, 16, 64, 64)])
def test_chunked_matches_jax_chunk_branch(monkeypatch, interpret, seed, B,
                                          H, W, C, Co):
    """JAX deform_conv2d through its chunk branch in one chunk, the flat-kc
    kernel in interpret mode (Np = 256, kc = 9*4*Cin)."""
    x, off, mask, w, b = _dcn_inputs(B, H, W, C, Co, seed)
    monkeypatch.setattr(dbm, "blend_matmul_supported", lambda *a, **k: True)
    jdc.deform_conv2d.clear_cache()
    try:
        want = np.asarray(jdc.deform_conv2d(
            jnp.asarray(x, jnp.bfloat16), off, mask,
            jnp.asarray(w, jnp.bfloat16), b))
    finally:
        jdc.deform_conv2d.clear_cache()
    got = _port_chunked(x, off, mask, w, b)
    assert got.shape == want.shape
    assert _rel(got, want) <= CHUNK_TOL


@pytest.mark.parametrize("tap_chunk", [1, 4, 5])
def test_chunks_sum_to_one_chunk(tap_chunk):
    """Several chunks against the port's single chunk: the same bf16 rows
    and w4, the chunk sums added in f32."""
    x, off, mask, w, b = _dcn_inputs(2, 16, 8, 32, 16, seed=6)
    want = _port_chunked(x, off, mask, w, b, tap_chunk=9)
    got = _port_chunked(x, off, mask, w, b, tap_chunk=tap_chunk)
    assert _rel(got, want) <= K2_TOL


def test_chunked_is_the_plain_dcn_up_to_bf16_rows():
    """Against the f32 plain version: the chunked route rounds w4 and the
    blended product to bf16 (2^-9 relative each)."""
    x, off, mask, w, b = _dcn_inputs(2, 12, 10, 64, 24, seed=7)
    got = _port_chunked(x, off, mask, w, b, tap_chunk=5)
    want = tdc.deform_conv2d_plain(
        *(torch.from_numpy(a) for a in (x, off, mask, w, b))).numpy()
    assert _rel(got, want) <= 1e-2


def test_dispatcher_on_cpu_is_the_plain_version():
    """On the CPU the JAX package and the port both run the f32 form at
    every shape, whatever the TPU route."""
    x, off, mask, w, b = _dcn_inputs(1, 8, 8, 64, 16, seed=8)
    ts = [torch.from_numpy(a) for a in (x, off, mask, w, b)]
    before = dict(launch_counts)
    got = tdc.deform_conv2d(*ts)
    assert torch.equal(got, tdc.deform_conv2d_plain(*ts))
    assert dict(launch_counts) == before


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def _jax_route(monkeypatch, B, H, W, Cin, Cout, dtype):
    """What JAX deform_conv2d runs on a TPU at this shape, traced
    abstractly with the kernels replaced by recorders."""
    seen = []

    def tap(g, w4, e4, wt, b, hw, tile):
        seen.append("tap")
        return jnp.zeros((b * hw, wt.shape[2]), jnp.float32)

    def flat(g2, w4, exp, wrep):
        seen.append("blend_matmul")
        return jnp.zeros((g2.shape[0], wrep.shape[1]), jnp.float32)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(dbm, "blend_matmul_tap", tap)
    monkeypatch.setattr(dbm, "blend_matmul", flat)
    jdc.deform_conv2d.clear_cache()
    try:
        jax.eval_shape(
            jdc.deform_conv2d,
            jax.ShapeDtypeStruct((B, H, W, Cin), dtype),
            jax.ShapeDtypeStruct((B, H, W, 18), jnp.float32),
            jax.ShapeDtypeStruct((B, H, W, 9), jnp.float32),
            jax.ShapeDtypeStruct((3, 3, Cin, Cout), dtype))
    finally:
        jdc.deform_conv2d.clear_cache()
    if not seen:
        return "xla"
    if seen == ["tap"]:
        return "tap"
    assert set(seen) == {"blend_matmul"}, seen
    return "blend_matmul"


# every LORE DCN level (fmap side at crop/4 .. crop/32, Cin -> Cout) at the
# crop sizes and sub-batches the task runs, f32, and shapes off the grid
LORE_LEVELS = [(4, 64, 64), (8, 128, 64), (8, 128, 128), (16, 256, 128),
               (16, 256, 256), (16, 256, 64), (32, 512, 256)]
ROUTE_CASES = [(b, crop // s, ci, co, "bfloat16")
               for b, crop in ((8, 1024), (8, 768), (32, 512), (64, 384))
               for s, ci, co in LORE_LEVELS]
ROUTE_CASES += [(8, 256, 64, 64, "float32"), (8, 128, 128, 64, "float32"),
                (3, 255, 64, 64, "bfloat16"), (9, 192, 64, 64, "bfloat16"),
                (1, 20, 64, 64, "bfloat16"), (12, 257, 32, 64, "bfloat16")]


@pytest.mark.parametrize("b,side,cin,cout,dtype", ROUTE_CASES)
def test_route_is_what_jax_runs_on_a_tpu(monkeypatch, b, side, cin, cout,
                                         dtype):
    want = _jax_route(monkeypatch, b, side, side, cin, cout,
                      getattr(jnp, dtype))
    got = tdc.flat_kc_route(b, side, side, cin, 9, cout,
                            getattr(torch, dtype))
    # the port runs K1 wherever JAX runs its tap kernel or XLA
    assert got == (want == "blend_matmul")


def test_wtw_sub_batch_routes():
    """1024^2 x 8 in bf16: the five stride-4 DCNs (Cin 64) take the
    flat-kc kernel in chunks of 5 + 4 taps, every other level K1."""
    routes = [tdc.flat_kc_route(8, 1024 // s, 1024 // s, ci, 9, co,
                                torch.bfloat16) for s, ci, co in LORE_LEVELS]
    assert routes == [True] + [False] * 6
    assert tdc.tap_chunk_size(8, 256, 256, 64, 9, torch.bfloat16) == 5
    # the wireless slice (768^2 x 8) stays on K1 at every level
    assert not any(tdc.flat_kc_route(8, 768 // s, 768 // s, ci, 9, co,
                                     torch.bfloat16)
                   for s, ci, co in LORE_LEVELS)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs on a machine with the card: python -m pytest -m cuda. Both
    modes of the deform-conv kernel on the same bf16 inputs: the flat-kc
    mode against the plain chunked version (the same bf16 products, summed
    in f32 in another order) and the tap mode against the plain version;
    shapes ragged in pixels, Cout 72 (two Cout splits) and 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for B, H, W, C, Co in ((1, 25, 40, 64, 72), (2, 32, 32, 128, 64)):
        x, off, mask, w, b = (torch.from_numpy(a).to(dev) for a in
                              _dcn_inputs(B, H, W, C, Co, seed=9))
        x, w = x.bfloat16(), w.bfloat16()
        for fn, plain, name in (
                (tdc.deform_conv2d_chunked, tdc.deform_conv2d_chunked_plain,
                 "deform_conv2d_flat_kc"),
                (tdc.deform_conv2d_tap, tdc.deform_conv2d_plain,
                 "deform_conv2d")):
            before = launch_counts[name]
            got = fn(x, off, mask, w, b)
            torch.cuda.synchronize()
            assert launch_counts[name] == before + 1
            want = plain(x, off, mask, w, b)
            err = float((got - want).abs().max() / want.abs().max())
            assert err < 1e-4, (name, B, H, W, C, Co, err)
