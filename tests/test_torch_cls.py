"""The port's PP-LCNet 0/180 textline classifier against the JAX package's
flax module on the same weights, moved through the weight bridge: class
probabilities at the published width (scale 0.25, 48x192), f32 on the CPU,
1e-5 absolute (softmax outputs in [0, 1]; both sides compute in f32 and
sum their convolutions in another order). Weights: the port's seeded
init, norm scales and biases perturbed, BatchNorm statistics calibrated on
a sample batch so that the probabilities depend on the input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.models import layers as jlayers
from pdf_table_tpu.models.cls.config import ClsPulcConfig as JClsPulcConfig
from pdf_table_tpu.models.cls.model import NET_CONFIG as JNET_CONFIG
from pdf_table_tpu.models.cls.model import \
    PPLCNetClassifier as JPPLCNetClassifier
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import calibrate_batch_stats, init_cls
from pdf_table_tpu_torch.models import layers
from pdf_table_tpu_torch.models.cls.config import PULC_LABELS, ClsPulcConfig
from pdf_table_tpu_torch.models.cls.model import (NET_CONFIG,
                                                  PPLCNetClassifier)
from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
from test_torch_dtype_policy import assert_bf16_rule
from test_torch_rec_model import perturb

torch.set_num_threads(1)

ATOL = 1e-5
TASK = "textline_orientation"


def _images(seed, n=3, hw=(48, 192)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, (n, *hw, 3)).astype(np.float32)


def cls_tree(cfg, seed=0):
    v = perturb(init_cls(cfg, seed=seed), seed=seed + 1)
    return calibrate_batch_stats(PPLCNetClassifier(cfg), v,
                                 torch.from_numpy(_images(99, n=4)))


@pytest.mark.parametrize("kw", [{}, dict(scale=0.5, class_expand=64),
                                dict(use_last_conv=False)],
                         ids=["published", "wider", "no_last_conv"])
def test_probs_match_flax(kw):
    cfg = ClsPulcConfig.for_task(TASK, **kw)
    v = cls_tree(cfg)
    x = _images(2)
    want = np.asarray(JPPLCNetClassifier(JClsPulcConfig.for_task(TASK, **kw))
                      .apply(v, jnp.asarray(x)))
    model = PPLCNetClassifier(cfg).eval()
    load_flax_variables(model, v)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (3, 2)
    assert float(np.abs(want[0] - want[1]).max()) > 1e-3, \
        "probabilities do not depend on the input"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_task_normalizes_and_classifies():
    """The task's ``probs`` takes 0..255 crops: imagenet normalize, then
    the module."""
    cfg = ClsPulcConfig.for_task(TASK)
    v = cls_tree(cfg)
    rng = np.random.default_rng(3)
    crops = rng.uniform(0, 255, (2, 48, 192, 3)).astype(np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    want = np.asarray(JPPLCNetClassifier(JClsPulcConfig.for_task(TASK)).apply(
        v, (jnp.asarray(crops) / 255.0 - mean) / std))
    task = ClsImagePulcTask(TASK, device="cpu", variables=v)
    got = task.probs(torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_init_tree_matches_flax_init():
    jv = jax.eval_shape(
        lambda: JPPLCNetClassifier(JClsPulcConfig.for_task(TASK)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 48, 192, 3))))
    tv = init_cls(ClsPulcConfig.for_task(TASK), seed=0)
    for col in ("params", "batch_stats"):
        a = {p: tuple(x.shape) for p, x in tree_leaves(jv[col])}
        b = {p: np.shape(x) for p, x in tree_leaves(tv[col])}
        assert a == b


@pytest.mark.parametrize("task_type", list(PULC_LABELS))
def test_configs_match_jax(task_type):
    a = ClsPulcConfig.for_task(task_type)
    b = JClsPulcConfig.for_task(task_type)
    assert vars(a) == vars(b)
    assert a.labels == b.labels and a.class_num == b.class_num
    assert NET_CONFIG == JNET_CONFIG


@pytest.mark.parametrize("name", ["swish", "silu", "sigmoid"])
def test_activations_match_flax(name):
    x = np.linspace(-6, 6, 121, dtype=np.float32)
    want = np.asarray(jlayers.ACTS[name](jnp.asarray(x)))
    got = layers.ACTS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride,k,se", [((2, 1), 5, False),
                                         ((1, 2), 5, True),
                                         ((2, 2), 3, False)])
def test_depthwise_separable_matches_flax(stride, k, se):
    """Strided 5x5 depthwise convs keep the symmetric k // 2 padding."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 14, 8)).astype(np.float32)
    jmod = jlayers.DepthwiseSeparable(12, (k, k), stride, use_se=se)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    from pdf_table_tpu_torch.engine.params import _set

    v = {}
    for path, a in tree_leaves(shapes):
        _set(v, path, (rng.standard_normal(a.shape) * 0.3)
             .astype(np.float32))
    v = perturb(v, 5)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    mod = layers.DepthwiseSeparable(8, 12, (k, k), stride, use_se=se).eval()
    load_flax_variables(mod, v)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)) \
            .permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClsImagePulcTask(TASK)


@pytest.mark.parametrize("task_type", ["text_image_orientation",
                                       "table_attribute"])
def test_other_tasks_are_not_ported(task_type):
    """The other task types were refused until the per-page system ported
    them; they build now, with their config's classes (their outputs are
    held to JAX's in tests/test_torch_host_paths.py)."""
    task = ClsImagePulcTask(task_type, device="cpu")
    assert task.model_config.task_type == task_type
    assert task.model.fc.out_features == len(PULC_LABELS[task_type])


def test_a_bf16_config_raises_naming_the_roadmap_item():
    """The classifier builds in bf16 when asked (against JAX:
    tests/test_torch_bf16_tsr.py), with flax's weight rule and f32
    probabilities; it stays f32 by default, as JAX builds its config
    directly."""
    task = ClsImagePulcTask(TASK, device="cpu", dtype="bfloat16")
    assert_bf16_rule(task.model)
    assert ClsImagePulcTask(TASK, device="cpu").model_config.dtype \
        == "float32"
    net = PPLCNetClassifier(ClsPulcConfig.for_task(TASK, dtype="bfloat16"))
    x = np.random.default_rng(3).standard_normal((2, 48, 192, 3))
    with torch.no_grad():
        probs = net.eval()(torch.from_numpy(x.astype(np.float32)))
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-6)
