"""The port's LORE model (pdf_table_tpu_torch/models/lore) against the JAX
package on one flax-initialized tree moved through the weight bridge, at a
tiny config on the CPU. Every DCN's conv_offset_mask carries seeded noise,
so the deform convs sample fractional and out-of-bounds points."""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models.lore import LoreModel as JLoreModel
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.models.lore.model import \
    gather_corner_features as j_gather_corners
from pdf_table_tpu.ops import centernet as jcn
from pdf_table_tpu.ops.warp import \
    resample_axis_aligned_crops as j_resample
from pdf_table_tpu_torch.convert.flax_bridge import (flax_to_state_dict,
                                                     load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import (init_lore,
                                               perturb_conv_offset_mask)
from pdf_table_tpu_torch.models.layers import BatchNorm
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.models.lore.dla import DeformConvBlock
from pdf_table_tpu_torch.models.lore.model import (LoreModel,
                                                   gather_corner_features)
from pdf_table_tpu_torch.ops import centernet as tcn
from pdf_table_tpu_torch.ops.deform_conv import deform_conv2d_plain
from pdf_table_tpu_torch.ops.warp import resample_axis_aligned_crops

torch.set_num_threads(1)

TINY = dict(resolution=(64, 64), max_objs=8, hidden_size=32, head_conv=16,
            tsfm_layers=1, stacking_layers=1, num_heads=4, max_fmp_size=64,
            d_ff=64, vis_thresh=0.1)
# f32 on both sides; only summation order differs. Tolerance relative to
# the largest magnitude of each output.
REL_TOL = 1e-4
# scores closer than this are treated as tied when ordering valid slots
SCORE_TOL = 1e-5
# bf16 detector against the JAX bf16 detector: both round activations to
# bf16 after every layer, in another order, and the roundings spread
# through ~40 layers (the JAX f32 and bf16 heads differ by 1.7e-2 here).
# Relative to each head's largest magnitude.
BF16_REL_TOL = 4e-2


@pytest.fixture(scope="module")
def models():
    jm = JLoreModel(JLoreConfig.wireless(**TINY))
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    v = perturb_conv_offset_mask(jax.tree.map(np.asarray, v), seed=1)
    tm = LoreModel(LoreConfig.wireless(**TINY)).eval()
    load_flax_variables(tm, v)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)) \
        .astype(np.float32)
    return jm, v, tm, x


def _bn_perturbed(v, seed=7):
    """Copy of ``v`` with seeded BatchNorm statistics, scales and biases
    (the init's 0/1 statistics and zero biases would hide their
    precision)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        out = {}
        for k, a in tree.items():
            if isinstance(a, dict):
                out[k] = walk(a, path + (k,))
                continue
            a = np.asarray(a, np.float32)
            if path[-1] == "bn" or k in ("mean", "var"):
                if k == "mean":
                    a = rng.standard_normal(a.shape)
                elif k == "var":
                    a = rng.uniform(0.5, 2.0, a.shape)
                elif k == "scale":
                    a = rng.uniform(0.5, 1.5, a.shape)
                else:
                    a = rng.standard_normal(a.shape) * 0.5
            out[k] = np.asarray(a, np.float32)
        return out

    return walk(v, ())


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) / scale < tol


def _valid_sorted(dets, scores, valid):
    """Valid slots of one image as rows [score, dets...] ordered by
    (-score, dets), with scores within SCORE_TOL counted as tied."""
    rows = np.concatenate([scores[valid][:, None], dets[valid]], axis=1)
    key = np.round(-rows[:, 0] / SCORE_TOL)
    order = np.lexsort(tuple(rows[:, 1:].T[::-1]) + (key,))
    return rows[order]


def test_init_lore_has_the_flax_tree(models):
    _, v, _, _ = models
    want = {p: a.shape for p, a in tree_leaves(v)}
    got = {p: a.shape for p, a in tree_leaves(
        init_lore(LoreConfig.wireless(**TINY), seed=0))}
    assert got == want


def test_bridge_layouts():
    tree = {"params": {
        "c": {"kernel": np.arange(2 * 3 * 4 * 5, dtype=np.float32)
              .reshape(2, 3, 4, 5)},
        "d": {"kernel": np.ones((3, 7), np.float32),
              "bias": np.zeros(7, np.float32)},
        "bn": {"scale": np.ones(4), "bias": np.zeros(4)},
        "dcn": {"weight": np.ones((3, 3, 4, 6))},
        "e": {"embedding": np.ones((9, 2))}},
        "batch_stats": {"bn": {"mean": np.zeros(4), "var": np.ones(4)}}}
    sd = flax_to_state_dict(tree)
    assert tuple(sd["c.weight"].shape) == (5, 4, 2, 3)
    assert float(sd["c.weight"][1, 2, 0, 1]) == \
        float(tree["params"]["c"]["kernel"][0, 1, 2, 1])
    assert tuple(sd["d.weight"].shape) == (7, 3)
    assert tuple(sd["dcn.weight"].shape) == (3, 3, 4, 6)
    assert tuple(sd["e.weight"].shape) == (9, 2)
    assert set(sd) >= {"bn.weight", "bn.bias", "bn.running_mean",
                       "bn.running_var"}


def test_offsets_are_perturbed(models):
    _, v, _, _ = models
    om = v["params"]["detector"]["ida_up"]["node_1"]["conv_offset_mask"]
    assert float(np.abs(om["bias"][:18]).max()) > 1.0
    assert float(np.abs(om["kernel"]).max()) > 0.0


def test_detector_heads_match(models):
    jm, v, tm, x = models
    want = jm.apply(v, x, method=lambda m, x: m.detector(x, train=False))
    with torch.no_grad():
        got = tm.detector(torch.from_numpy(x).permute(0, 3, 1, 2)
                          .contiguous(memory_format=torch.channels_last))
    assert set(got) == {"hm", "wh", "reg", "ax", "cr", "st"}
    for k in got:
        _close(got[k].permute(0, 2, 3, 1).numpy(), want[k])


@pytest.fixture(scope="module")
def bf16_models(models):
    jm, v, _, x = models
    v = _bn_perturbed(v)
    cfg = dict(TINY, dtype="bfloat16")
    tm = LoreModel(LoreConfig.wireless(**cfg)).eval()
    load_flax_variables(tm, v)
    return JLoreModel(JLoreConfig.wireless(**cfg)), v, tm, x


def test_bf16_model_keeps_norms_and_dcn_bias_f32(bf16_models):
    _, _, tm, _ = bf16_models
    assert tm.processor.stacker is not None
    for name, mod in tm.named_modules():
        own = dict(mod.named_parameters(recurse=False),
                   **dict(mod.named_buffers(recurse=False)))
        if isinstance(mod, BatchNorm) or name.startswith("processor"):
            want = {k: torch.float32 for k in own}
        elif isinstance(mod, DeformConvBlock):
            want = {"weight": torch.bfloat16, "bias": torch.float32}
        else:
            want = {k: torch.bfloat16 for k in own}
        assert {k: t.dtype for k, t in own.items()} == want, name


def test_bf16_batch_norm_matches_flax(bf16_models):
    """A DCN block's BatchNorm of the bf16 model on a bf16 input with large
    means: flax subtracts the f32 mean, scales and shifts in f32 and rounds
    once, so both sides agree to one bf16 rounding. f32 statistics rounded
    to bf16 would miss by about 2 %."""
    _, v, tm, _ = bf16_models
    bn = copy.deepcopy(tm.detector.dla_up.ida_0.node_1.bn)
    p = v["params"]["detector"]["dla_up"]["ida_0"]["node_1"]["bn"]
    st = dict(v["batch_stats"]["detector"]["dla_up"]["ida_0"]["node_1"]["bn"])
    rng = np.random.default_rng(8)
    c = st["mean"].shape[0]
    st["mean"] = rng.uniform(8.0, 12.0, c).astype(np.float32)
    bn.running_mean.copy_(torch.from_numpy(st["mean"]))
    x = (st["mean"] + rng.standard_normal((2, 5, 6, c))).astype(np.float32)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5, dtype=jnp.bfloat16).apply(
        {"params": p, "batch_stats": st}, x16)
    with torch.no_grad():
        got = bn(torch.from_numpy(np.array(x16.astype(jnp.float32)))
                 .to(torch.bfloat16).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want.astype(jnp.float32)), rtol=2 ** -7, atol=1e-6)


def test_bf16_detector_heads_match(bf16_models):
    jm, v, tm, x = bf16_models
    want = jm.apply(v, x, method=lambda m, x: m.detector(x, train=False))
    with torch.no_grad():
        got = tm.heads(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == torch.float32
        _close(got[k].numpy(), want[k], BF16_REL_TOL)


def test_plain_dcn_is_set_on_every_deform_conv():
    tm = LoreModel(LoreConfig.wireless(**TINY), plain_dcn=True)
    dcns = [m.dcn for m in tm.modules() if isinstance(m, DeformConvBlock)]
    assert len(dcns) == 16
    assert all(f is deform_conv2d_plain for f in dcns)


def test_features_and_logical_match(models):
    jm, v, tm, x = models
    jf = jm.apply(v, x, method=JLoreModel.features)
    with torch.no_grad():
        tf = tm.features(torch.from_numpy(x))
    valid = np.asarray(jf["valid"])
    np.testing.assert_array_equal(tf["valid"].numpy(), valid)
    assert valid.any(), "the tiny config should yield valid slots"
    for b in range(x.shape[0]):
        _close(_valid_sorted(tf["dets"][b].numpy(), tf["scores"][b].numpy(),
                             valid[b]),
               _valid_sorted(np.asarray(jf["dets"][b]),
                             np.asarray(jf["scores"][b]), valid[b]))
    # the regressor on the same (JAX) features and dets
    feat, dets = np.array(jf["feat"]), np.array(jf["dets"])
    jl, js = jm.apply(v, feat, dets, method=JLoreModel.logical)
    with torch.no_grad():
        tl, ts = tm.logical(torch.from_numpy(feat), torch.from_numpy(dets))
    _close(tl.numpy(), jl)
    _close(ts.numpy(), js)


def test_decode_boxes_4ps_on_fixed_heatmaps():
    rng = np.random.default_rng(4)
    b, h, w = 2, 12, 10
    heat = rng.random((b, h, w, 1)).astype(np.float32)
    heat[0, 3:5, 3:5, 0] = 0.97          # a plateau: exact ties
    heat[1, 0, :, 0] = 0.5
    wh = rng.standard_normal((b, h, w, 8)).astype(np.float32)
    reg = rng.random((b, h, w, 2)).astype(np.float32)
    for k in (5, 20, h * w + 7):          # the last pads with -inf
        want = jcn.decode_boxes_4ps(heat, wh, reg, k)
        got = tcn.decode_boxes_4ps(torch.from_numpy(heat),
                                   torch.from_numpy(wh),
                                   torch.from_numpy(reg), k)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_gather_corner_features_rounds_half_to_even():
    rng = np.random.default_rng(5)
    cr = rng.standard_normal((1, 6, 7, 3)).astype(np.float32)
    dets = np.array([[[0.5, 1.5, 2.5, 3.5, -0.5, 6.5, 9.0, 2.49]]],
                    np.float32)
    want = j_gather_corners(cr, dets)
    got = gather_corner_features(torch.from_numpy(cr),
                                 torch.from_numpy(dets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resample_axis_aligned_crops_matches():
    rng = np.random.default_rng(6)
    pages = rng.integers(0, 256, (2, 40, 30, 3), dtype=np.uint8)
    page_idx = np.array([0, 1, 1], np.int32)
    boxes = np.array([[2, 3, 27, 28], [-4, 10, 30, 44], [5.5, 0, 12, 6.5]],
                     np.float32)
    vw = np.array([24, 16, 24], np.int32)
    vh = np.array([24, 24, 10], np.int32)
    want = j_resample(jnp.asarray(pages), page_idx, boxes, (24, 24),
                      valid_w=vw, valid_h=vh)
    got = resample_axis_aligned_crops(
        torch.from_numpy(pages), torch.from_numpy(page_idx).long(),
        torch.from_numpy(boxes), (24, 24),
        valid_w=torch.from_numpy(vw).long(),
        valid_h=torch.from_numpy(vh).long())
    # pixel values 0..255 in f32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
