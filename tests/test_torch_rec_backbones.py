"""The port's ModelScope recognizers (``CRNN``: grey, VGG stack, two
bidirectional LSTMs; ``ConvNextViT``: ConvNext stages + 12 ViT layers over
300 px chunks; ``LightweightEdge``: the searched NAS plan) against the JAX
package at full width on the CPU: the trees equal in shape (flax's LSTM
cells fused into ``nn.LSTM`` by the weight bridge), the logits within
1e-4 of flax's, and the recognition lane as a whole against the JAX
package's fused device lane (``BatchPipeline._recognize_all_device``),
with the 0/180 classifier (CRNN and LightweightEdge without it too;
ConvNextViT's in tests/test_torch_rec_convnext_lane.py), on
the canvases and quads of tests/test_torch_recognition.py (axis-aligned
and rotated): the packed ids and keep masks equal, confidences within
1e-5, texts equal.
ConvNextViT's lane warps every crop to 804 px, cuts three 300 px chunks
48 px apart and joins their logits (3 x 75 steps) before the decode.

The trees: ``init_rec`` with the biases and norms perturbed, the CTC
head's kernel x 0.2 (CRNN's x 5 and its bias zeroed), ConvNext's
``gamma`` at 0.1 (1e-6 at init, which would leave its blocks out),
BatchNorm statistics calibrated on strips of the canvases."""

import functools

import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.pipeline.batch_runner as jbr
import pdf_table_tpu.tasks.cls_pulc as jcls
import pdf_table_tpu.tasks.recognition as jrec
from pdf_table_tpu.models.rec_ctc import CTCRecModel as JRec
from pdf_table_tpu.models.registry import get_config
from pdf_table_tpu.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import calibrate_batch_stats, init_rec
from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask
from pdf_table_tpu_torch.tasks.recognition import (OcrRecognitionTask,
                                                   rec_config)
from test_torch_rec_model import perturb
from test_torch_recognition import CANVASES, QUADS, TASK, _jax_packed
from test_torch_recognition import trees  # noqa: F401

torch.set_num_threads(1)

MODELS = ("CRNN", "ConvNextViT", "LightweightEdge")
LOGIT_TOL = 1e-4
CONF_ATOL = 1e-5
GAMMA = 0.1
# the CTC head's kernel gain, and whether its bias is zeroed: the two
# LSTMs squash CRNN's features to some 1e-2, under the perturbed biases
HEAD = {"CRNN": (5.0, True), "ConvNextViT": (0.2, False),
        "LightweightEdge": (0.2, False)}


def strips(model):
    """32 px strips of the canvases, normalized as the lane normalizes:
    ConvNextViT grey chunk-width strips / 255, the others RGB / 127.5 - 1,
    NHWC."""
    s = np.concatenate([CANVASES[:, y:y + 32, :300] for y in (0, 40, 90)])
    s = torch.from_numpy(s).float()
    if model == "ConvNextViT":
        return (0.299 * s[..., 0] + 0.587 * s[..., 1]
                + 0.114 * s[..., 2])[..., None] / 255.0
    return s / 127.5 - 1.0


@functools.lru_cache(maxsize=None)
def build(model):
    """(tree, the calibration strips as NHWC numpy) of ``model``."""
    cfg = rec_config(model=model)
    v = perturb(init_rec(cfg, seed=0), seed=1)
    gain, zero_bias = HEAD[model]
    v["params"]["ctc_head"]["kernel"] *= gain
    if zero_bias:
        v["params"]["ctc_head"]["bias"][:] = 0.0
    for path, a in tree_leaves(v):
        if path[-1] == "gamma":
            a[...] = GAMMA
    x = strips(model)
    v = calibrate_batch_stats(CTCRecModel(cfg), v, x)
    return v, x.numpy()


def test_configs_match_the_registry():
    for model in MODELS:
        assert vars(rec_config(model=model)) == \
            vars(get_config("recognition", model))
        assert vars(rec_config(lang="korean", model=model)) == \
            vars(get_config("recognition", model, lang="korean"))


@pytest.mark.parametrize("model", MODELS)
def test_init_rec_has_the_flax_tree(model):
    v, x = build(model)
    want = jax.eval_shape(JRec(get_config("recognition", model)).init,
                          jax.random.PRNGKey(0), x[:1])
    assert {p: tuple(a.shape) for p, a in tree_leaves(v)} == \
        {p: tuple(a.shape) for p, a in tree_leaves(want)}


@pytest.mark.parametrize("model", MODELS)
def test_logits_match_flax(model):
    v, x = build(model)
    want = np.asarray(JRec(get_config("recognition", model)).apply(v, x))
    net = CTCRecModel(rec_config(model=model)).eval()
    load_flax_variables(net, v)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (len(x), x.shape[2] // 4, 97)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    assert float(want.std(axis=0).mean()) > 1e-2, "logits ignore the input"


def _jax_lane(model, rec_v, cls_v):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrec, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, rec_v))
        mp.setattr(jcls, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, cls_v))
        bp = jbr.BatchPipeline(OcrSystemConfig(
            use_layout=False, use_table=False,
            use_textline_cls=cls_v is not None))
        bp.system._rec = jrec.OcrRecognitionTask(model=model)
        bp.system._rec.ensure_built()
        if cls_v is not None:
            bp.system._line_cls = jcls.ClsImagePulcTask(task_type=TASK)
            bp.system._line_cls.ensure_built()
    return bp


# every recognizer with the classifier, CRNN and LightweightEdge without
# it too (ConvNextViT's lane without it is held in
# tests/test_torch_rec_convnext_lane.py, to keep this file near a minute)
@pytest.mark.parametrize("model,use_cls", [
    ("CRNN", False), ("CRNN", True), ("ConvNextViT", True),
    ("LightweightEdge", False), ("LightweightEdge", True)])
def test_lane_matches_jax(model, use_cls, trees):  # noqa: F811
    v, _ = build(model)
    cls_v = None
    if use_cls:
        cls_v = jax.tree.map(np.array, trees[1])
        # some crops flip: the 180 class lifted
        cls_v["params"]["fc"]["bias"] += np.array([-1.0, 1.0], np.float32)
    want_t, want_s, want_p = _jax_packed(_jax_lane(model, v, cls_v),
                                         CANVASES, QUADS)
    cls_task = None if cls_v is None else \
        ClsImagePulcTask(TASK, device="cpu", variables=cls_v)
    task = OcrRecognitionTask(model=model, device="cpu", variables=v,
                              cls_task=cls_task)
    groups = task.plan(QUADS)
    width = 804 if model == "ConvNextViT" else 640
    assert {g["bucket"] for g in groups} == {width}
    pages = torch.from_numpy(CANVASES)
    got_p = [task.enqueue(pages, g).numpy()[:g["n"]] for g in groups]
    assert len(got_p) == len(want_p)
    steps = 3 * 75 if model == "ConvNextViT" else width // 4
    for got, want in zip(got_p, want_p):
        assert got.shape == want.shape == (len(got), 2 * steps + 1)
        np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
        assert np.abs(got[:, -1] - want[:, -1]).max() <= CONF_ATOL * 1e6
    got_t, got_s = task.batch_infer_from_pages(CANVASES, QUADS)
    assert got_t == want_t
    for a, b in zip(got_s, want_s):
        np.testing.assert_allclose(a, b, rtol=0, atol=CONF_ATOL)
    texts = [t for page in got_t for t in page]
    assert len(set(texts)) > len(texts) // 2, "texts ignore the crops"
