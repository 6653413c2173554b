"""The port's DBNet (PP-OCRv4 detector) against the JAX package's flax
modules on the same weights, moved through the weight bridge: one
``BinarizeHead`` (which settles the transposed-conv orientation) and the
whole ``DBNet``, f32 on the CPU, atol 1e-5. Weights: the port's seeded
init with BatchNorm statistics and biases perturbed, so that no layer is
an identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models import layers as jlayers
from pdf_table_tpu.models.dbnet.config import DbNetConfig as JDbNetConfig
from pdf_table_tpu.models.dbnet.model import BinarizeHead as JBinarizeHead
from pdf_table_tpu.models.dbnet.model import DBNet as JDBNet
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import _set, init_dbnet
from pdf_table_tpu_torch.models import layers
from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
from pdf_table_tpu_torch.models.dbnet.model import BinarizeHead, DBNet
from test_torch_dtype_policy import assert_bf16_rule

torch.set_num_threads(1)

ATOL = 1e-5


def _perturb(tree, seed):
    """Seeded noise on every bias and BatchNorm leaf (kernels keep their
    values): scale and var in [0.5, 1.5], bias and mean N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, a in tree_leaves(tree):
        a = np.asarray(a, np.float32)
        if path[-1] in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif path[-1] in ("bias", "mean"):
            a = (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        _set(out, path, a)
    return out


def _fill(tree, seed):
    """A flax tree's shapes, filled from numpy: kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, a in tree_leaves(tree):
        shape = np.shape(a)
        if path[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            a = np.zeros(shape)
        _set(out, path, np.asarray(a, np.float32))
    return _perturb(out, seed + 1)


def test_binarize_head_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
    jhead = JBinarizeHead(inner=16)
    shapes = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = _fill(shapes, seed=1)
    want = np.asarray(jhead.apply(v, jnp.asarray(x)))
    head = BinarizeHead(16, 16).eval()
    load_flax_variables(head, v)
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 24, 36)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_dbnet_matches_flax(hw):
    v = _perturb(init_dbnet(DbNetConfig.ppocr(inner_channels=16), seed=0),
                 seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(JDBNet(JDbNetConfig.ppocr(inner_channels=16)).apply(
        v, jnp.asarray(x))["prob"])
    model = DBNet(DbNetConfig.ppocr(inner_channels=16)).eval()
    load_flax_variables(model, v)
    with torch.no_grad():
        got = model(torch.from_numpy(x))["prob"].numpy()
    assert got.shape == want.shape == (2, *hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_init_tree_matches_flax_init():
    """init_dbnet gives the paths and shapes of the flax DBNet's init at
    full width, so the bridge takes either tree."""
    jv = jax.eval_shape(lambda: JDBNet(JDbNetConfig.ppocr()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    tv = init_dbnet(DbNetConfig.ppocr(), seed=0)
    for col in ("params", "batch_stats"):
        a = {p: tuple(x.shape) for p, x in tree_leaves(jv[col])}
        b = {p: np.shape(x) for p, x in tree_leaves(tv[col])}
        assert a == b


@pytest.mark.parametrize("name", ["hardswish", "hardsigmoid", "relu6"])
def test_activations_match_flax(name):
    x = np.linspace(-5, 5, 101, dtype=np.float32)
    want = np.asarray(jlayers.ACTS[name](jnp.asarray(x)))
    got = layers.ACTS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_make_divisible_matches_jax():
    for v in np.arange(0.5, 800, 3.7):
        assert layers.make_divisible(v) == jlayers.make_divisible(v)


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50",
                                      "proxylessnas", "mobilenetv3"])
def test_other_backbones_are_not_ported(backbone):
    """Every backbone builds in f32 (the ModelScope ones since the ninth
    slice, tests/test_torch_dbnet_backbones.py) and in bf16 (against JAX:
    tests/test_torch_bf16_dbnet.py) with flax's weight rule, and its bf16
    prob map is f32."""
    assert DBNet(DbNetConfig.ppocr(backbone=backbone)).config.backbone \
        == backbone
    net = DBNet(DbNetConfig.ppocr(backbone=backbone, inner_channels=64,
                                  dtype="bfloat16")).eval()
    assert_bf16_rule(net)
    x = np.random.default_rng(3).standard_normal((1, 64, 32, 3))
    # oneDNN's bf16 conv2d returns NaN now and then at resnet18's 4x2
    # layer4 input, whatever the data (tools/repro_onednn_bf16_conv.py):
    # the CPU forward runs on PyTorch's own conv
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        prob = net(torch.from_numpy(x.astype(np.float32)))["prob"]
    assert prob.dtype == torch.float32 and prob.shape == (1, 64, 32)
    assert torch.isfinite(prob).all()
