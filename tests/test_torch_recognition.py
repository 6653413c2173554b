"""The recognition lane as a whole: the same page canvases and text quads
through the JAX package's fused device recognition
(``BatchPipeline._recognize_all_device``) and through the port's
``OcrRecognitionTask.batch_infer_from_pages`` (on the CPU), on the same
PP-OCRv4 recognizer and 0/180 classifier weights at full width. The JAX
tasks load the trees through a monkeypatched ``load_or_init``. The trees
are seeded, with BatchNorm statistics calibrated on strips of the test
pages, so that texts and orientation probabilities depend on the crop.

Held: the packed decode (ids and keep masks equal, confidences within
1e-5: the two f32 forwards differ by some 1e-5 in the logits, which moves
a mean of softmax maxima by less), the texts, and the scores, with and
without the classifier, on axis-aligned and rotated quads, with one width
bucket and with per-width groups. Seeded weights put the logits near ties
only by accident; the seeds below have none (an ``argmax`` that tips shows
as unequal ids)."""

import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.pipeline.batch_runner as jbr
import pdf_table_tpu.tasks.cls_pulc as jcls
import pdf_table_tpu.tasks.recognition as jrec
from pdf_table_tpu.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_cls, init_rec)
from pdf_table_tpu_torch.models.cls.config import ClsPulcConfig
from pdf_table_tpu_torch.models.cls.model import PPLCNetClassifier
from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig
from pdf_table_tpu_torch.models.rec_ctc.model import CTCRecModel
from pdf_table_tpu_torch.tasks.cls_pulc import (CLS_MEAN, CLS_STD,
                                                ClsImagePulcTask)
from pdf_table_tpu_torch.tasks.recognition import (FLIP_THRESH,
                                                   OcrRecognitionTask,
                                                   rec_config, unpack_rec)
from test_torch_rec_model import perturb

torch.set_num_threads(1)

CONF_ATOL = 1e-5
TASK = "textline_orientation"


def _page(seed, h, w):
    """Text-like strokes: dark bars of random gray on white."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 255, np.uint8)
    for y in range(8, h - 8, 6):
        x = 6
        while x < w - 20:
            ww = int(rng.integers(4, 18))
            img[y:y + 3, x:x + ww] = rng.integers(0, 160, 3)
            x += ww + int(rng.integers(2, 8))
    return img


def _rect(x1, y1, x2, y2):
    return [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]


def _tilt(quad, angle):
    q = np.asarray(quad, np.float32)
    c, s = np.cos(angle), np.sin(angle)
    ctr = q.mean(0, keepdims=True)
    return ((q - ctr) @ np.array([[c, -s], [s, c]], np.float32).T + ctr)


CANVASES = np.stack([_page(0, 160, 320), _page(1, 160, 320)])
# page 0: axis-aligned rects (one over the page's edge) and a tilted quad;
# page 1: a rect given from another corner, two tilted quads, a tiny rect
QUADS = [
    np.array([_rect(10, 8, 150, 30), _rect(20.5, 40.2, 300.3, 62.9),
              _rect(-4, 100, 90, 118), _tilt(_rect(60, 70, 260, 92), 0.08)],
             np.float32),
    np.array([np.roll(_rect(30, 20, 200, 40), 2, axis=0),
              _tilt(_rect(40, 60, 280, 84), -0.15),
              _tilt(_rect(100, 105, 220, 125), 0.3),
              _rect(5, 140, 9, 150)], np.float32),
]


@pytest.fixture(scope="module")
def trees():
    strips = torch.from_numpy(np.concatenate(
        [CANVASES[:, y:y + 48, :192] for y in (0, 50, 100)])).float()
    rec_v = perturb(init_rec(RecConfig(), seed=0), seed=1)
    rec_v["params"]["ctc_head"]["kernel"] *= 0.2
    rec_v = calibrate_batch_stats(CTCRecModel(RecConfig()), rec_v,
                                  strips / 127.5 - 1.0)
    ccfg = ClsPulcConfig.for_task(TASK)
    cls_v = perturb(init_cls(ccfg, seed=2), seed=3)
    cls_v = calibrate_batch_stats(
        PPLCNetClassifier(ccfg), cls_v,
        (strips / 255.0 - torch.tensor(CLS_MEAN)) / torch.tensor(CLS_STD))
    return rec_v, cls_v


def _jax_lane(rec_v, cls_v):
    """A BatchPipeline whose rec task (and cls task, where ``cls_v``) hold
    the given trees."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrec, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, rec_v))
        mp.setattr(jcls, "load_or_init",
                   lambda *a, **k: jax.tree.map(np.asarray, cls_v))
        bp = jbr.BatchPipeline(OcrSystemConfig(
            use_layout=False, use_table=False,
            use_textline_cls=cls_v is not None))
        bp.system._rec = jrec.OcrRecognitionTask(model="PP-OCRv4_rec")
        bp.system._rec.ensure_built()
        if cls_v is not None:
            bp.system._line_cls = jcls.ClsImagePulcTask(task_type=TASK)
            bp.system._line_cls.ensure_built()
    return bp


def _port_lane(rec_v, cls_v, **kw):
    cls_task = None if cls_v is None else \
        ClsImagePulcTask(TASK, device="cpu", variables=cls_v)
    return OcrRecognitionTask(device="cpu", variables=rec_v,
                              cls_task=cls_task, **kw)


def _jax_packed(bp, canvases, quads):
    """(texts, scores, packed rows per group) of the JAX lane: the packed
    arrays are caught on their way into ``unpack_rec``."""
    caught = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrec, "unpack_rec",
                   lambda packed, n: (caught.append(np.asarray(packed)[:n]),
                                      jrec_unpack(packed, n))[1])
        texts, scores = bp._recognize_all_device(canvases, quads)
    return texts, scores, caught


jrec_unpack = jrec.unpack_rec


def _port_packed(task, canvases, quads):
    groups = task.plan(quads)
    pages = torch.from_numpy(canvases)
    return groups, [task.enqueue(pages, g).numpy()[:g["n"]] for g in groups]


def _compare(bp, task, canvases=CANVASES, quads=QUADS):
    want_t, want_s, want_p = _jax_packed(bp, canvases, quads)
    groups, got_p = _port_packed(task, canvases, quads)
    assert len(got_p) == len(want_p)
    for got, want in zip(got_p, want_p):
        assert got.shape == want.shape and got.dtype == np.int32
        np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
        assert np.abs(got[:, -1] - want[:, -1]).max() <= CONF_ATOL * 1e6
    got_t, got_s = task.batch_infer_from_pages(canvases, quads)
    assert got_t == want_t
    assert [len(t) for t in got_t] == [len(q) for q in quads]
    for a, b in zip(got_s, want_s):
        np.testing.assert_allclose(a, b, rtol=0, atol=CONF_ATOL)
    assert all(isinstance(t, str) and t for page in got_t for t in page)
    return groups, got_p


def test_lane_without_cls_matches_jax(trees):
    rec_v, _ = trees
    groups, packed = _compare(_jax_lane(rec_v, None),
                              _port_lane(rec_v, None))
    # one width bucket, split by sampler: 5 axis-aligned, 3 rotated
    assert [(g["bucket"], g["aa"], g["n"]) for g in groups] == \
        [(640, False, 3), (640, True, 5)]
    assert packed[0].shape == (3, 2 * 80 + 1)


def _shift_for_mixed_flips(task, canvases, quads):
    """A shift of the classifier's 180 logit that puts ``FLIP_THRESH`` in
    the widest gap between the crops' margins, so that some crops flip,
    some do not, and none sits near the threshold."""
    margins = []
    pages = torch.from_numpy(canvases)
    with torch.inference_mode():
        for g in task.plan(quads):
            _, _, cls_in = task.cut(pages, g, task.upload(g))
            p = task.cls_task.probs(cls_in)[:g["n"], 1].double()
            margins += torch.log(p / (1 - p)).tolist()
    m = np.sort(np.asarray(margins))
    i = int(np.argmax(np.diff(m)))
    assert m[i + 1] - m[i] > 1e-3
    return float(np.log(FLIP_THRESH / (1 - FLIP_THRESH))
                 - (m[i] + m[i + 1]) / 2), i + 1


@pytest.mark.parametrize("flips", ["as_seeded", "all", "mixed"])
def test_lane_with_cls_matches_jax(trees, flips):
    rec_v, cls_v = trees
    cls_v = jax.tree.map(np.array, cls_v)
    bias = cls_v["params"]["fc"]["bias"]
    expect = None
    if flips == "all":
        bias += np.array([-4.0, 4.0], np.float32)
        expect = 8
    elif flips == "mixed":
        shift, below = _shift_for_mixed_flips(
            _port_lane(rec_v, cls_v), CANVASES, QUADS)
        bias[1] += shift
        expect = 8 - below
    task = _port_lane(rec_v, cls_v)
    _compare(_jax_lane(rec_v, cls_v), task)
    pages = torch.from_numpy(CANVASES)
    flipped = 0
    with torch.inference_mode():
        for g in task.plan(QUADS):
            crops, rot, cls_in = task.cut(pages, g, task.upload(g))
            out = task.orient(crops, rot, cls_in)[:g["n"]]
            flipped += int((out != crops[:g["n"]]).flatten(1).any(1).sum())
    if expect is not None:
        assert flipped == expect
        assert flips == "all" or 0 < flipped < 8


def test_per_width_groups_match_jax(trees):
    """``single_rec_bucket=False``: crops group by their own width
    bucket."""
    rec_v, _ = trees
    quads = [QUADS[0][:3], np.array([_rect(30, 20, 70, 40)], np.float32)]
    bp = _jax_lane(rec_v, None)
    bp.single_rec_bucket = False
    task = _port_lane(rec_v, None, single_rec_bucket=False)
    groups, _ = _compare(bp, task, quads=quads)
    assert [(g["bucket"], g["n"]) for g in groups] == \
        [(160, 1), (320, 2), (640, 1)]


def test_plan_geometry():
    task = _port_lane(init_rec(RecConfig(), 0), None)
    groups = task.plan(QUADS)
    aa = next(g for g in groups if g["aa"])
    # padded to the batch bucket with 1 px boxes on page 0
    assert aa["mats"].shape == (8, 4) and aa["n"] == 5
    np.testing.assert_array_equal(aa["mats"][5:], [[0, 0, 1, 1]] * 3)
    np.testing.assert_array_equal(aa["widths"][5:], 1)
    np.testing.assert_array_equal(aa["idxs"], [0, 1, 2, 4, 7])
    np.testing.assert_array_equal(aa["pidx"][:5], [0, 0, 0, 1, 1])
    # the first rect is 140 x 22: 48 / 22 * 140 = 305 px at the model's height
    assert aa["widths"][0] == 305
    rot = next(g for g in groups if not g["aa"])
    assert rot["mats"].shape == (4, 3, 3)
    np.testing.assert_array_equal(rot["mats"][3], np.eye(3))
    assert task.plan([np.zeros((0, 4, 2)), []]) == []


def test_empty_pages_and_bad_input(trees):
    task = _port_lane(trees[0], None)
    texts, scores = task.batch_infer_from_pages(
        CANVASES, [np.zeros((0, 4, 2), np.float32), []])
    assert texts == [[], []] and scores == [[], []]
    with pytest.raises(ValueError, match="uint8"):
        task.batch_infer_from_pages(CANVASES.astype(np.float32), QUADS)
    with pytest.raises(ValueError, match="quad lists"):
        task.batch_infer_from_pages(CANVASES, QUADS[:1])


def test_takes_a_tensor_of_canvases(trees):
    task = _port_lane(trees[0], None)
    quads = [QUADS[0][:2], []]
    a = task.batch_infer_from_pages(CANVASES, quads)
    b = task.batch_infer_from_pages(torch.from_numpy(CANVASES), quads)
    assert a == b


def test_unpack_rec_matches_jax():
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 97, (6, 2 * 20 + 1)).astype(np.int32)
    packed[:, 20:40] = rng.integers(0, 2, (6, 20))
    packed[:, -1] = rng.integers(0, 10 ** 6, 6)
    for a, b in zip(unpack_rec(packed, 4), jrec.unpack_rec(packed, 4)):
        np.testing.assert_array_equal(a, b)


def test_rec_config_matches_registry():
    from pdf_table_tpu.models.registry import get_config

    assert vars(rec_config()) == vars(get_config("recognition",
                                                 "PP-OCRv4_rec"))
    assert vars(rec_config(lang="korean")) == vars(
        get_config("recognition", "PP-OCRv4_rec", lang="korean"))


def test_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OcrRecognitionTask()


def test_other_models_are_not_ported():
    """CRNN builds in f32 since the ninth slice and in bf16 since the
    twelfth; an unknown name raises, naming the model."""
    assert OcrRecognitionTask(model="CRNN", device="cpu") \
        .model_config.backbone == "crnn"
    task = OcrRecognitionTask(model="CRNN", device="cpu", dtype="bfloat16")
    assert task.model.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="SVTR_v2"):
        OcrRecognitionTask(model="SVTR_v2", device="cpu")
