"""SLANet in the port against the JAX package on the CPU, on the same flax
tree: the vocab, the post-processor, the model at the tiny config of
tests/test_slanet.py (64x64, hidden 32, T 8) and at full trunk and head
width (488x488, LCNet 1.0, neck 96, hidden 256) with T 16, and the task's
``__call__`` and ``batch_infer_from_pages`` (the JAX task loads the tree
through a monkeypatched ``tasks.table_structure.load_or_init``).

The trees: ``init_slanet``, BatchNorm scales 0.2 and statistics calibrated
on the inputs (``set_batch_norm_scale`` + ``calibrate_batch_stats``, as
for PicoDet, whose LCNet this is: at scale 1 the random stack is chaotic),
and the structure generator's last matrix times STRUCT_GAIN: on random
weights the 50 probabilities are otherwise all near 1/50, so that the
top two of most steps lie within 1e-4 (a near-tie at step 1); the argmax
is the same at any gain.

Tolerances: under ``teacher_tokens`` every step's probabilities and locs
within 1e-5. Greedy decode feeds the argmax back, so a round-off flip at
a near-tie changes every later token: greedy ids (and their
probabilities and locs, within 1e-5) are compared up to the first step
where JAX's top-1/top-2 gap is under 10x the tolerance; the assertion
names that step and the compared prefix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.slanet import SLANet as JSLANet
from pdf_table_tpu.models.slanet import SLANetConfig as JSLANetConfig
from pdf_table_tpu.models.slanet import SLANetPostProcessor as JPost
from pdf_table_tpu.models.slanet import StructureVocab as JVocab
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine.params import (calibrate_batch_stats,
                                               init_slanet,
                                               set_batch_norm_scale)
from pdf_table_tpu_torch.models.slanet.config import SLANetConfig
from pdf_table_tpu_torch.models.slanet.model import SLANet
from pdf_table_tpu_torch.models.slanet.processor import SLANetPostProcessor
from pdf_table_tpu_torch.models.slanet.vocab import (STRUCTURE_TOKENS,
                                                     StructureVocab)
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from test_torch_dtype_policy import assert_bf16_rule

torch.set_num_threads(1)

TOL = 1e-5
TIE_GAP = 10 * TOL
TINY = dict(table_max_len=64, hidden_size=32, max_structure_len=8)
FULL = dict(max_structure_len=16)
LOC_PX_TOL = 1e-3
STRUCT_GAIN = 30.0


def near_tie_step(probs: np.ndarray) -> int:
    """First step whose top-1/top-2 probability gap is under TIE_GAP
    (the length when none is)."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    close = np.nonzero(top2[:, 1] - top2[:, 0] < TIE_GAP)[0]
    return int(close[0]) if len(close) else len(probs)


def assert_greedy_equal(got: dict, want: dict, min_prefix: int = 1) -> list:
    """Greedy ids equal, probabilities and locs within TOL, up to each
    crop's first near-tie in ``want``; returns the compared prefixes."""
    prefixes = []
    wp, gp = np.asarray(want["structure_probs"]), got["structure_probs"]
    for b in range(len(wp)):
        t = near_tie_step(wp[b])
        prefixes.append(t)
        ids_w, ids_g = wp[b, :t].argmax(-1), gp[b, :t].argmax(-1)
        assert (ids_w == ids_g).all(), (
            f"crop {b}: greedy ids differ before the first near-tie at "
            f"step {t} (compared prefix {t}): {ids_g} vs {ids_w}")
        for k in ("structure_probs", "loc_preds"):
            np.testing.assert_allclose(
                got[k][b, :t], np.asarray(want[k])[b, :t], atol=TOL, rtol=0,
                err_msg=f"{k}, crop {b}, prefix {t} (near-tie at step {t})")
    assert min(prefixes) >= min_prefix, f"compared prefixes {prefixes}"
    return prefixes


def slanet_tree(cfg: SLANetConfig, x: np.ndarray, seed: int = 0):
    """Seeded, BatchNorm scale 0.2, statistics calibrated on ``x``, the
    structure logits spread by STRUCT_GAIN."""
    model = SLANet(cfg)
    model.forward = model.encode
    tree = calibrate_batch_stats(
        model, set_batch_norm_scale(init_slanet(cfg, seed), 0.2),
        torch.from_numpy(x))
    tree["params"]["head"]["fc_struct1"] *= STRUCT_GAIN
    return tree


def _inputs(size, n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _run_both(kw, x, teacher=None):
    cfg = SLANetConfig(**kw)
    tree = slanet_tree(cfg, x)
    model = SLANet(cfg).eval()
    load_flax_variables(model, tree)
    with torch.no_grad():
        got = model(torch.from_numpy(x), teacher_tokens=None if teacher
                    is None else torch.from_numpy(teacher))
    got = {k: v.numpy() for k, v in got.items()}
    want = JSLANet(JSLANetConfig(**kw)).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x), train=False,
        teacher_tokens=None if teacher is None else jnp.asarray(teacher))
    return got, {k: np.asarray(v) for k, v in want.items()}, tree


def test_vocab_matches_jax(tmp_path):
    v, jv = StructureVocab(), JVocab()
    assert v.tokens == jv.tokens and len(v) == len(jv) == 50
    assert (v.sos_id, v.eos_id) == (jv.sos_id, jv.eos_id) == (0, 49)
    assert v.token_to_id["<td></td>"] == jv.token_to_id["<td></td>"] == 7
    assert all(v.is_td(t) == jv.is_td(t) for t in v.tokens + ["<td>"])
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = rng.integers(0, len(v), 12).tolist()
        assert v.decode(ids) == jv.decode(ids)
    p = tmp_path / "dict.txt"
    p.write_text("<tr>\n</tr>\n<td>\n</td>\n\n<td")
    for merge in (True, False):
        assert StructureVocab.from_dict_file(str(p), merge).tokens == \
            JVocab.from_dict_file(str(p), merge).tokens
    assert STRUCTURE_TOKENS[:10] == JVocab().tokens[1:11]


def test_postprocessor_matches_jax():
    v = StructureVocab()
    cases = []
    seq = ["<tr>", "<td></td>", "<td></td>", "</tr>"]
    probs = np.zeros((8, len(v)), np.float32)
    for t, tok in enumerate(seq):
        probs[t, v.token_to_id[tok]] = 1.0
    probs[len(seq), v.eos_id] = 1.0
    probs[len(seq) + 1:, v.token_to_id["<tr>"]] = 1.0
    cases.append((probs, np.full((8, 8), 0.5, np.float32)))
    rng = np.random.default_rng(1)
    for _ in range(6):
        p = rng.random((20, len(v))).astype(np.float32)
        p[rng.integers(0, 20), v.eos_id] = 9.0      # an eos somewhere
        p[0, v.eos_id] = 10.0 * rng.integers(0, 2)  # sometimes at step 0
        cases.append((p, rng.random((20, 8)).astype(np.float32)))
    for probs, locs in cases:
        raw = {"structure_probs": probs[None], "loc_preds": locs[None]}
        shape = (100, 200, 2.44, 2.44, 0, 244)
        got = SLANetPostProcessor(SLANetConfig())(raw, shape)
        want = JPost(JSLANetConfig())(raw, shape)
        assert got == want


@pytest.mark.parametrize("kw,size", [(TINY, 64), (FULL, 488)],
                         ids=["tiny", "full_width"])
def test_tree_matches_flax_init(kw, size):
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JSLANet(JSLANetConfig(**kw)).init(
        jax.random.PRNGKey(0), x))
    want = {p: tuple(a.shape) for p, a in tree_leaves(shapes)}
    got = {p: np.shape(a) for p, a in
           tree_leaves(init_slanet(SLANetConfig(**kw)))}
    assert got == want


@pytest.mark.parametrize("kw,size,n", [(TINY, 64, 3), (FULL, 488, 2)],
                         ids=["tiny", "full_width"])
def test_teacher_forced_matches_flax(kw, size, n):
    x = _inputs(size, n)
    T = kw["max_structure_len"]
    teacher = np.random.default_rng(5).integers(0, 50, (n, T))
    got, want, _ = _run_both(kw, x, teacher)
    for k in ("structure_probs", "loc_preds"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("kw,size,n", [(TINY, 64, 3), (FULL, 488, 2)],
                         ids=["tiny", "full_width"])
def test_greedy_matches_flax(kw, size, n):
    got, want, _ = _run_both(kw, _inputs(size, n, seed=1))
    assert got["structure_probs"].shape == want["structure_probs"].shape
    assert_greedy_equal(got, want, min_prefix=2)


def test_teacher_tokens_shift_right_from_sos():
    """Step 0 sees sos (id 0); a teacher-forced run on a greedy run's own
    ids (shifted) reproduces it."""
    cfg = SLANetConfig(**TINY)
    x = _inputs(64, 3, seed=2)
    model = SLANet(cfg).eval()
    load_flax_variables(model, slanet_tree(cfg, x))
    with torch.no_grad():
        greedy = model(torch.from_numpy(x))
        ids = greedy["structure_probs"].argmax(-1)
        forced = model(torch.from_numpy(x), teacher_tokens=ids)
    torch.testing.assert_close(forced["structure_probs"],
                               greedy["structure_probs"], atol=TOL, rtol=0)


# -- the task ---------------------------------------------------------------

PAGES = np.stack([np.random.default_rng(s).integers(
    0, 256, (150, 170, 3), dtype=np.uint8) for s in range(2)])
REGIONS = [(0, (10, 20, 160, 120)), (1, (0, 0, 170, 150)),
           (0, (40, 5, 90, 140))]


def _jax_task(tree, monkeypatch, **kw):
    monkeypatch.setattr(jts, "load_or_init",
                        lambda *a, **k: jax.tree.map(np.asarray, tree))
    task = jts.OcrTableStructureTask(model="SLANet", **kw)
    task.ensure_built()
    return task


def _capture(monkeypatch, cls, name, key):
    """Record what ``cls.name`` receives first (the raw model output)."""
    seen = []
    real = getattr(cls, name)

    def spy(self, raw, meta):
        seen.append(np.asarray(key(raw)))
        return real(self, raw, meta)

    monkeypatch.setattr(cls, name, spy)
    return seen


def assert_results_equal(got_res, want_res, got_raw, want_raw):
    """Per crop: up to JAX's first near-tie, the tokens equal and the cells
    within LOC_PX_TOL; with no near-tie the whole result."""
    V = want_raw[0].shape[-1]
    for g, w, gr, wr in zip(got_res, want_res, got_raw, want_raw):
        t = near_tie_step(wr[0])
        assert g["type"] == w["type"]
        if t < len(wr[0]):
            np.testing.assert_array_equal(gr[0, :t, :V].argmax(-1),
                                          wr[0, :t].argmax(-1),
                                          err_msg=f"near-tie at step {t}")
            continue
        assert g["structure_tokens"] == w["structure_tokens"]
        assert len(g["cells"]) == len(w["cells"])
        for a, b in zip(g["cells"], w["cells"]):
            np.testing.assert_allclose(a["bbox"], b["bbox"],
                                       atol=LOC_PX_TOL, rtol=0)
        assert abs(g["score"] - w["score"]) <= TOL


@pytest.fixture(scope="module")
def task_tree():
    """Calibrated on the task's own inputs for REGIONS."""
    task = OcrTableStructureTask(model="SLANet", device="cpu", **TINY)
    (_, _, x), = task.sub_batches(PAGES, REGIONS)
    return slanet_tree(task.model_config, x.numpy())


def test_task_batch_infer_from_pages_matches_jax(task_tree, monkeypatch):
    want_raw = _capture(monkeypatch, jts.OcrTableStructureTask,
                        "_postprocess", lambda r: r["structure_probs"])
    jtask = _jax_task(task_tree, monkeypatch, **TINY)
    want = jtask.batch_infer_from_pages(PAGES, REGIONS)
    got_raw = _capture(monkeypatch, OcrTableStructureTask, "_post_one",
                       lambda r: r)
    task = OcrTableStructureTask(model="SLANet", device="cpu",
                                 variables=task_tree, batch_size=2, **TINY)
    got = task.batch_infer_from_pages(torch.from_numpy(PAGES), REGIONS)
    assert len(got) == len(want) == len(REGIONS)
    assert all(r["type"] == "slanet" for r in got)
    assert sum(len(r["structure_tokens"]) for r in got) > 0
    assert_results_equal(got, want, got_raw, want_raw)


def test_task_call_matches_jax(task_tree, monkeypatch):
    want_raw = _capture(monkeypatch, jts.OcrTableStructureTask,
                        "_postprocess", lambda r: r["structure_probs"])
    jtask = _jax_task(task_tree, monkeypatch, **TINY)
    img = PAGES[1][10:140, 5:150]
    want = jtask(img)
    got_raw = _capture(monkeypatch, OcrTableStructureTask, "_post_one",
                       lambda r: r)
    got = OcrTableStructureTask(model="SLANet", device="cpu",
                                variables=task_tree, **TINY)(img)
    assert_results_equal([got], [want], got_raw, want_raw)


def test_task_rejects_bf16():
    """The SLANet task builds in bf16 (against JAX:
    tests/test_torch_bf16_tsr.py): the backbone and neck with flax's
    weight rule, the attention-GRU head f32, as in JAX."""
    task = OcrTableStructureTask(model="SLANet", device="cpu",
                                 dtype="bfloat16", **TINY)
    assert task.model_config.dtype == "bfloat16"
    assert_bf16_rule(task.model, f32=("head",))
