"""The port's FLOP counts (utils/flops.py) against the JAX package's jaxpr
walk (pdf_table_tpu/utils/flops.py), and the port's ``stage``
(utils/profiling.py).

The cases of tests/test_flops.py with its expected numbers (the scan as a
10-step loop, which the eager port counts step by step; the Pallas DCN
body as the DCN's model count, which JAX's Pallas walk exceeds by its
corner expansion; the tracked program as a plain count, since the port
has no program registry). Then each forward's count against JAX's
``fn_flops`` on the CPU: PP-OCRv4 detection, PicoDet and PP-OCRv4
recognition at full width, the tiny wireless LORE with its deform convs.
They agree except for the transposed convs, which JAX counts over the
lhs-dilated input and the port over its input: JAX's count is the port's
with each transposed conv's count scaled by its output's spatial size
over its input's, exactly. In LORE, JAX's walk also counts the 1x1
``project`` conv of each DLA-34 parent tree, traced but never used (XLA
drops it), which the port does not run: those are added from their
shapes."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from pdf_table_tpu.models.dbnet.config import DbNetConfig as JDbNetConfig
from pdf_table_tpu.models.dbnet.model import DBNet as JDBNet
from pdf_table_tpu.models.lore import LoreModel as JLoreModel
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.models.picodet.config import PicoDetConfig as JPicoCfg
from pdf_table_tpu.models.picodet.model import PicoDet as JPicoDet
from pdf_table_tpu.models.rec_ctc.config import RecConfig as JRecConfig
from pdf_table_tpu.models.rec_ctc.model import CTCRecModel as JCTCRecModel
from pdf_table_tpu.ops.deform_conv import deform_conv2d as jdeform_conv2d
from pdf_table_tpu.utils.flops import fn_flops
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.models.dbnet.model import DBNet
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.dla import Tree
from pdf_table_tpu_torch.models.lore.model import LoreModel
from pdf_table_tpu_torch.models.picodet.config import PicoDetConfig
from pdf_table_tpu_torch.models.picodet.model import PicoDet
from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig
from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
from pdf_table_tpu_torch.ops.deform_conv import (dcn_flops, deform_conv2d,
                                                 deform_conv2d_chunked_plain,
                                                 deform_conv2d_plain)
from pdf_table_tpu_torch.utils import flops
from pdf_table_tpu_torch.utils.flops import count_flops
from pdf_table_tpu_torch.utils.profiling import stage

torch.set_num_threads(1)

LORE_TINY = dict(resolution=(64, 64), max_objs=8, hidden_size=32,
                 head_conv=16, tsfm_layers=1, stacking_layers=1, num_heads=4,
                 max_fmp_size=64, d_ff=64)


# -- tests/test_flops.py's cases -------------------------------------------------

def test_matmul():
    n, _ = count_flops(lambda x, y: x @ y, torch.ones(64, 128),
                       torch.ones(128, 32))
    assert n == 2 * 64 * 128 * 32


def test_batched_dot():
    n, _ = count_flops(torch.matmul, torch.ones(4, 8, 16),
                       torch.ones(4, 16, 8))
    assert n == 2 * 4 * 8 * 8 * 16


def test_conv():
    x, w = torch.ones(2, 8, 16, 16), torch.ones(4, 8, 3, 3)
    n, _ = count_flops(F.conv2d, x, w, padding=1)
    assert n == 2 * (2 * 16 * 16 * 4) * 8 * 9


def test_grouped_conv():
    x, w = torch.ones(1, 16, 8, 8), torch.ones(16, 1, 3, 3)
    n, _ = count_flops(F.conv2d, x, w, padding=1, groups=16)
    assert n == 2 * (1 * 8 * 8 * 16) * 1 * 9


def test_loop_counts_every_step():
    """JAX multiplies a scan body by its length; the eager port runs the
    ten steps and counts each."""
    def f(x):
        c = x
        for _ in range(10):
            c = c @ x
        return c

    n, _ = count_flops(f, torch.ones(32, 32))
    assert n == 10 * 2 * 32 * 32 * 32


def test_nested_call_and_elementwise_free():
    def inner(x):
        return torch.relu(x @ x + 1.0)

    n, _ = count_flops(lambda x: inner(x) * 2.0, torch.ones(16, 16))
    assert n == 2 * 16 ** 3


def test_dcn_counts_model_flops_on_every_route():
    """The DCN of tests/test_flops.py's Pallas case (np 512, 36·Cin = 1152,
    Cout 64): the port counts one product over K·Cin per output on every
    route, JAX's CPU route's figure; JAX's Pallas walk counts the body's
    4·Cin contraction per tap plus the corner weights' expansion."""
    rng = np.random.default_rng(0)
    B, H, W, cin, cout = 2, 16, 16, 32, 64
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    off = rng.standard_normal((B, H, W, 18)).astype(np.float32)
    mask = rng.random((B, H, W, 9)).astype(np.float32)
    w = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, off, mask, w)]
    model = 2 * B * H * W * 9 * cin * cout
    for fn in (deform_conv2d, deform_conv2d_plain,
               deform_conv2d_chunked_plain):
        assert count_flops(fn, *t)[0] == model, fn.__name__
    assert dcn_flops(*t) == model
    np_, kc, co = 512, 1152, 64
    pallas = 2 * np_ * kc * co + 2 * np_ * 128 * kc
    assert (np_, kc, co) == (B * H * W, 36 * cin, cout)
    assert model == (pallas - 2 * np_ * 128 * kc) // 4
    jax_cpu = fn_flops(lambda *a: jdeform_conv2d(*a),
                       *[jax.ShapeDtypeStruct(a.shape, jnp.float32)
                         for a in (x, off, mask, w)])
    assert jax_cpu == model


def test_plain_count_of_a_program():
    """tests/test_flops.py's tracked program, as a plain count: the port has
    no program registry (it runs eagerly)."""
    x = torch.ones(8, 8)
    n, out = count_flops(lambda a: a @ a, x)
    np.testing.assert_allclose(out.numpy(), np.full((8, 8), 8.0))
    assert n == 2 * 8 ** 3


def test_count_outside_a_count_is_free():
    assert not flops._active()
    torch.ones(4, 4) @ torch.ones(4, 4)
    n, _ = count_flops(lambda: count_flops(torch.mm, torch.ones(2, 3),
                                           torch.ones(3, 4))[0])
    assert n == 2 * 2 * 3 * 4


def test_peak_flops_by_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.peak_flops(torch.bfloat16) == 989.4e12
    assert flops.peak_flops("tf32") == 494.7e12
    assert flops.peak_flops(torch.float32) == 66.9e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    with pytest.raises(KeyError, match="Some Other Card"):
        flops.peak_flops(torch.bfloat16)


def test_stage_times_and_marks_the_trace():
    from torch.profiler import ProfilerActivity, profile

    metrics = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stage("lane_under_test", metrics):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with stage("lane_under_test", metrics):
            pass
    assert metrics["lane_under_test"] > 0
    names = [e.key for e in prof.key_averages()]
    assert "lane_under_test" in names
    with stage("unrecorded"):
        pass


# -- whole forwards against JAX ---------------------------------------------------

class _TransposedConvs(TorchDispatchMode):
    """Each transposed conv's count and its output/input spatial ratio."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket == torch.ops.aten.convolution and args[6]:
            n = flop_registry[func._overloadpacket](*args, **kwargs,
                                                    out_val=out)
            ratio = Fraction(int(np.prod(out.shape[2:])),
                             int(np.prod(args[0].shape[2:])))
            self.seen.append((int(n), ratio))
        return out


def _port_count(fn, *args):
    with _TransposedConvs() as mode:
        with torch.no_grad():
            n, _ = count_flops(fn, *args)
    return n, mode.seen


def _held(port, seen, jax_n, unused=0):
    transposed = sum(n for n, _ in seen)
    scaled = sum(n * r for n, r in seen)
    assert port - transposed + scaled + unused == jax_n, (
        port, transposed, scaled, unused, jax_n)


def _jax_count(module, x_shape, method=None):
    x = jax.ShapeDtypeStruct(x_shape, jnp.float32)
    v = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                           jnp.zeros(x_shape)))
    if method is None:
        return fn_flops(lambda v, x: module.apply(v, x), v, x)
    return fn_flops(lambda v, x: module.apply(v, x, method=method), v, x)


def test_ppocr_det_forward_equals_jax():
    shape = (1, 96, 128, 3)
    port, seen = _port_count(DBNet(DbNetConfig.ppocr()).eval(),
                             torch.zeros(shape))
    assert seen, "the DB head's transposed convs"
    _held(port, seen, _jax_count(JDBNet(JDbNetConfig.ppocr()), shape))


def test_picodet_forward_equals_jax():
    shape = (1, 128, 96, 3)
    cfg = dict(task_type="table", img_height=128, img_width=96)
    port, seen = _port_count(PicoDet(PicoDetConfig(**cfg)).eval(),
                             torch.zeros(shape))
    assert not seen
    _held(port, seen, _jax_count(JPicoDet(JPicoCfg(**cfg)), shape))


def test_ppocr_rec_forward_equals_jax():
    shape = (2, 48, 160, 3)
    port, seen = _port_count(CTCRecModel(RecConfig()).eval(),
                             torch.zeros(shape))
    assert not seen
    _held(port, seen, _jax_count(JCTCRecModel(JRecConfig()), shape))


def test_lore_forward_equals_jax_with_its_dcns():
    shape = (2, 64, 64, 3)
    model = LoreModel(LoreConfig.wireless(**LORE_TINY)).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape)
                         .astype(np.float32))
    unused = []

    def parent_project(tree, args):
        B, _, H, W = args[0].shape
        w = tree.project.conv.weight
        unused.append(2 * B * (H // tree.stride) * (W // tree.stride)
                      * w.shape[0] * w.shape[1])

    for m in model.modules():
        if isinstance(m, Tree) and m.levels > 1 and m.project is not None:
            m.register_forward_pre_hook(parent_project)
    port, seen = _port_count(model.forward_packed, x)
    assert seen, "the DLA up-path's transposed convs"
    assert len(unused) == 2
    _held(port, seen, _jax_count(JLoreModel(JLoreConfig.wireless(**LORE_TINY)),
                                 shape), sum(unused))
    dcns = [m for m in model.modules() if hasattr(m, "dcn")]
    assert dcns
    with torch.no_grad():
        plain = LoreModel(LoreConfig.wireless(**LORE_TINY), plain_dcn=True)
        plain.load_state_dict(model.state_dict())
        assert count_flops(plain.eval().forward_packed, x)[0] == port


def test_counts_under_inference_mode():
    """The tasks run their models under ``torch.inference_mode``, where the
    mode meets composite ops (conv2d, linear, matmul) undecomposed: the
    count is the same as outside it."""
    model = DBNet(DbNetConfig.ppocr()).eval()
    x = torch.zeros(1, 64, 96, 3)
    with torch.no_grad():
        want, _ = count_flops(model, x)
    with torch.inference_mode():
        got, _ = count_flops(model, x)
    assert got == want > 0
