"""The port's PP-OCRv4 recognizer against the JAX package's flax modules on
the same weights, moved through the weight bridge: one ``SVTRBlock``, the
``SVTRLCNetBackbone`` and the whole ``CTCRecModel`` (logits), f32 on the
CPU. Weights: the port's seeded init with norm scales and biases
perturbed, so that no layer is an identity, and BatchNorm statistics
calibrated on a sample batch, so that the logits depend on the input (with
the init's 0/1 statistics the signal dies out on the way and every crop
gives the same logits). Tolerance 1e-4 absolute on logits of order 1:
both sides compute in f32 and sum their convolutions and matmuls in
another order through some 40 layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.rec_ctc.config import RecConfig as JRecConfig
from pdf_table_tpu.models.rec_ctc.model import CTCRecModel as JCTCRecModel
from pdf_table_tpu.models.rec_ctc.model import SVTRBlock as JSVTRBlock
from pdf_table_tpu.models.rec_ctc.model import \
    SVTRLCNetBackbone as JSVTRLCNetBackbone
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import (_set, calibrate_batch_stats,
                                               init_rec)
from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig
from pdf_table_tpu_torch.models.rec_ctc.model import (MV1_ENHANCE_CFG,
                                                      CTCRecModel, SVTRBlock,
                                                      SVTRLCNetBackbone)

from test_torch_dtype_policy import assert_bf16_rule

torch.set_num_threads(1)

ATOL = 1e-4
# full width, and a narrow variant with two blocks of other sizes
VARIANTS = {
    "full": {},
    "narrow": dict(svtr_scale=0.25, svtr_dims=32, svtr_hidden=48,
                   svtr_heads=4, vocab_size=40),
}


def perturb(tree, seed):
    """Seeded noise on every bias and norm leaf (kernels keep their
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


def rec_tree(cfg, seed=0):
    """Seeded, perturbed, calibrated on 4 random crops."""
    v = perturb(init_rec(cfg, seed=seed), seed=seed + 1)
    return calibrate_batch_stats(CTCRecModel(cfg), v,
                                 torch.from_numpy(_crops(99, n=4)))


def _crops(seed, n=2, h=48, w=160):
    """Normalized crops in [-1, 1], NHWC."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)


def test_svtr_block_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, 120)).astype(np.float32)
    jblock = JSVTRBlock(dim=120, heads=8)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    v = {}
    for path, a in tree_leaves(shapes):
        fan_in = a.shape[0]
        _set(v, path, (rng.standard_normal(a.shape) / np.sqrt(fan_in))
             .astype(np.float32))
    v = perturb(v, 1)
    want = np.asarray(jblock.apply(v, jnp.asarray(x)))
    block = SVTRBlock(120, 8).eval()
    load_flax_variables(block, v)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_backbone_matches_flax(name):
    kw = VARIANTS[name]
    cfg = RecConfig(**kw)
    v = rec_tree(cfg)
    bv = {"params": v["params"]["backbone"],
          "batch_stats": v["batch_stats"]["backbone"]}
    x = _crops(2)
    jb = JSVTRLCNetBackbone(scale=cfg.svtr_scale, dims=cfg.svtr_dims,
                            hidden=cfg.svtr_hidden, depth=cfg.svtr_depth,
                            heads=cfg.svtr_heads)
    want = np.asarray(jb.apply(bv, jnp.asarray(x)))
    backbone = SVTRLCNetBackbone(
        scale=cfg.svtr_scale, dims=cfg.svtr_dims, hidden=cfg.svtr_hidden,
        depth=cfg.svtr_depth, heads=cfg.svtr_heads).eval()
    load_flax_variables(backbone, bv)
    with torch.no_grad():
        got = backbone(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 160 // 8, cfg.svtr_dims)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_ctc_rec_model_logits_match_flax(name):
    kw = VARIANTS[name]
    cfg = RecConfig(**kw)
    v = rec_tree(cfg)
    x = _crops(3)
    want = np.asarray(JCTCRecModel(JRecConfig(**kw)).apply(v, jnp.asarray(x)))
    model = CTCRecModel(cfg).eval()
    load_flax_variables(model, v)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 20, cfg.vocab_size)
    assert float(np.abs(want).max()) > 0.5, "logits too small to compare"
    assert float(np.abs(want[0] - want[1]).max()) > 0.5, \
        "logits do not depend on the input"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_other_heights_take_the_mean_over_rows():
    """At 96 px the backbone leaves two rows, which the mean folds."""
    cfg = RecConfig(**VARIANTS["narrow"])
    v = rec_tree(cfg)
    x = _crops(4, n=1, h=96, w=64)
    want = np.asarray(JCTCRecModel(JRecConfig(**VARIANTS["narrow"]))
                      .apply(v, jnp.asarray(x)))
    model = CTCRecModel(cfg).eval()
    load_flax_variables(model, v)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_tree_matches_flax_init(name):
    """init_rec gives the paths and shapes of the flax model's init, so
    the bridge takes either tree."""
    kw = VARIANTS[name]
    jv = jax.eval_shape(lambda: JCTCRecModel(JRecConfig(**kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 48, 80, 3))))
    tv = init_rec(RecConfig(**kw), seed=0)
    for col in ("params", "batch_stats"):
        a = {p: tuple(x.shape) for p, x in tree_leaves(jv[col])}
        b = {p: np.shape(x) for p, x in tree_leaves(tv[col])}
        assert a == b


def test_bridge_refuses_a_tree_that_does_not_match():
    cfg = RecConfig(**VARIANTS["narrow"])
    model = CTCRecModel(cfg)
    v = init_rec(cfg, seed=0)
    extra = perturb(v, 0)
    extra["params"]["backbone"]["svtr_block0"]["gamma"] = np.ones(3)
    with pytest.raises(KeyError, match="gamma"):
        load_flax_variables(model, extra)
    missing = perturb(v, 0)
    del missing["params"]["backbone"]["svtr_norm"]["scale"]
    with pytest.raises(KeyError, match="svtr_norm.weight"):
        load_flax_variables(model, missing)


def test_block_table_and_config_match_jax():
    from pdf_table_tpu.models.rec_ctc import model as jmodel

    assert MV1_ENHANCE_CFG == jmodel.MV1_ENHANCE_CFG
    for make in ("__call__", "crnn", "convnext_vit"):
        a = RecConfig() if make == "__call__" else getattr(RecConfig, make)()
        b = JRecConfig() if make == "__call__" \
            else getattr(JRecConfig, make)()
        assert vars(a) == vars(b)


@pytest.mark.parametrize("backbone", ["crnn", "convnext_vit",
                                      "lightweight_edge", "svtr_lcnet"])
def test_other_backbones_are_not_ported(backbone):
    """Every backbone builds in f32 since the ninth slice
    (tests/test_torch_rec_backbones.py) and in bf16 (against JAX:
    tests/test_torch_bf16_rec.py) with flax's weight rule (ConvNext's
    ``gamma`` f32), and its bf16 logits are f32."""
    assert CTCRecModel(RecConfig(backbone=backbone)).config.backbone \
        == backbone
    net = CTCRecModel(RecConfig(backbone=backbone, dtype="bfloat16")).eval()
    assert_bf16_rule(net)
    h = 48 if backbone == "svtr_lcnet" else 32
    x = np.random.default_rng(3).uniform(-1, 1, (1, h, 64, 3))
    with torch.no_grad():
        logits = net(torch.from_numpy(x.astype(np.float32)))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
