"""The port's ResNet family (pdf_table_tpu_torch/models/layers.py) and
LORE's ResNet-18 detector against the JAX package on flax trees moved
through the weight bridge, on the CPU: BasicBlock, Bottleneck, ResNet-18
and ResNet-50 within 1e-5 relative; the SAME-padded transposed conv at odd
and even sizes; LORE ``backbone="resnet18"`` heads within 1e-5 and its
task's cells and HTML equal to JAX's task on the same crops."""

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

import pdf_table_tpu.models.layers as jl
import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.lore import LoreModel as JLoreModel
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.tasks.table_to_html import \
    OcrTableToHtmlTask as JTableToHtml
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import calibrate_batch_stats, init_lore
from pdf_table_tpu_torch.models import layers as tl
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.detector import (ResNetDetector,
                                                      conv_transpose_same)
from pdf_table_tpu_torch.models.lore.model import LoreModel
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from pdf_table_tpu_torch.tasks.table_to_html import OcrTableToHtmlTask

torch.set_num_threads(1)

REL_TOL = 1e-5
TINY = dict(resolution=(64, 64), max_objs=8, hidden_size=32, head_conv=16,
            tsfm_layers=1, stacking_layers=1, num_heads=4, max_fmp_size=64,
            d_ff=64, vis_thresh=0.1, backbone="resnet18")


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / scale < tol


def _stats(v, seed=3):
    """``v`` with seeded BatchNorm statistics, scales and biases, every
    variance at least 2 (the random residual stack stays tame)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, a in tree_leaves(v):
        a = np.asarray(a, np.float32)
        if path[-1] == "mean":
            a = rng.standard_normal(a.shape) * 0.2
        elif path[-1] == "var":
            a = rng.uniform(2.0, 4.0, a.shape)
        elif path[-1] == "scale":
            a = rng.uniform(0.5, 1.0, a.shape)
        elif path[-1] == "bias" and "bn" in path[-2]:
            a = rng.standard_normal(a.shape) * 0.1
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(a, np.float32)
    return out


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _run_both(jmod, tmod, x):
    v = _stats(jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), x)))
    want = jmod.apply(v, x)
    load_flax_variables(tmod.eval(), v)
    with torch.no_grad():
        got = tmod(_nchw(x))
    return got, want


@pytest.mark.parametrize("block,in_ch,features,stride", [
    ("BasicBlock", 16, 16, (1, 1)), ("BasicBlock", 16, 32, (2, 2)),
    ("Bottleneck", 64, 16, (1, 1)), ("Bottleneck", 32, 16, (2, 2))])
def test_blocks_match_flax(block, in_ch, features, stride):
    x = np.random.default_rng(0).standard_normal(
        (2, 11, 14, in_ch)).astype(np.float32)
    got, want = _run_both(getattr(jl, block)(features, stride),
                          getattr(tl, block)(in_ch, features, stride), x)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("depth,hw", [(18, (70, 61)), (50, (64, 64))])
def test_resnet_matches_flax(depth, hw):
    x = np.random.default_rng(1).standard_normal(
        (1,) + hw + (3,)).astype(np.float32)
    got, want = _run_both(jl.ResNet(depth), tl.ResNet(depth), x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w)


@pytest.mark.parametrize("k,s,hw", [(4, 2, (5, 5)), (4, 2, (6, 9)),
                                    (2, 2, (7, 4))])
def test_conv_transpose_same_matches_flax(k, s, hw):
    """flax's ``nn.ConvTranspose`` (SAME, no kernel flip) against the
    torch transposed conv that the bridge loads it into."""
    x = np.random.default_rng(2).standard_normal(
        (2,) + hw + (3,)).astype(np.float32)
    jmod = fnn.ConvTranspose(5, (k, k), strides=(s, s))
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), x))
    v["params"]["bias"] = np.arange(5, dtype=np.float32)
    want = np.asarray(jmod.apply(v, x))
    tmod = torch.nn.Module()
    tmod.up = conv_transpose_same(3, 5, k, s)
    load_flax_variables(tmod, {"params": {"up": v["params"]}})
    with torch.no_grad():
        got = tmod.up(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, hw[0] * s, hw[1] * s, 5)
    _close(got, want)


@pytest.fixture(scope="module")
def lore_tree():
    """init_lore's resnet18 tree with BatchNorm statistics calibrated on
    the crops (variances doubled) and cell-friendly head biases."""
    cfg = LoreConfig.wireless(**TINY)
    x = np.random.default_rng(4).uniform(-2, 2, (2, 64, 64, 3)) \
        .astype(np.float32)
    net = LoreModel(cfg).eval()
    net.forward = net.heads
    v = calibrate_batch_stats(net, init_lore(cfg, seed=0),
                              torch.from_numpy(x))
    for path, a in tree_leaves(v["batch_stats"]):
        if path[-1] == "var":
            a *= 2.0
    heads = v["params"]["detector"]["heads"]
    heads["hm_out"]["bias"] = np.array([0.0, -2.19], np.float32)
    heads["wh_out"]["bias"] = np.array(
        [1.5, 1.5, -1.5, 1.5, -1.5, -1.5, 1.5, -1.5], np.float32)
    return v, x


def test_init_lore_resnet18_has_the_flax_tree(lore_tree):
    v, x = lore_tree
    jm = JLoreModel(JLoreConfig.wireless(**TINY))
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x[:1])
    assert {p: tuple(a.shape) for p, a in tree_leaves(v)} == \
        {p: tuple(a.shape) for p, a in tree_leaves(want)}


def test_lore_resnet18_heads_match_flax(lore_tree):
    v, x = lore_tree
    jm = JLoreModel(JLoreConfig.wireless(**TINY))
    want = jm.apply(v, x, method=lambda m, x: m.detector(x, train=False))
    tm = LoreModel(LoreConfig.wireless(**TINY)).eval()
    load_flax_variables(tm, v)
    assert isinstance(tm.detector, ResNetDetector)
    with torch.no_grad():
        got = tm.heads(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in got:
        _close(got[k].numpy(), want[k])


def test_lore_resnet18_task_matches_jax(lore_tree):
    v, _ = lore_tree
    pages = np.full((2, 120, 110, 3), 255, np.uint8)
    pages[:, ::15] = 30
    pages[:, :, ::20] = 30
    pages[1, 30:60, 20:70] = (200, 40, 90)
    regions = [(0, (5, 8, 100, 110)), (1, (0, 0, 110, 120)),
               (1, (20, 30, 60, 70))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, v))
        jtask = jts.OcrTableStructureTask(
            model="Lore", config=JLoreConfig.wireless(**TINY))
        want = jtask.batch_infer_from_pages(pages, regions)
    ttask = OcrTableStructureTask(model="Lore",
                                  config=LoreConfig.wireless(**TINY),
                                  device="cpu", variables=v)
    got = ttask.batch_infer_from_pages(pages, regions)
    n_cells = 0
    for g, w in zip(got, want):
        assert len(g["cells"]) == len(w["cells"])
        for gc, wc in zip(g["cells"], w["cells"]):
            assert gc["logic"] == wc["logic"]
            # crop px: the heads agree to 1e-5 of their largest value, and
            # a feature-map px is up to 7.5 crop px here
            np.testing.assert_allclose(gc["bbox"], wc["bbox"], atol=1e-2)
        n_cells += len(g["cells"])
        assert OcrTableToHtmlTask()(g, []) == JTableToHtml()(w, [])
    assert n_cells > 0
