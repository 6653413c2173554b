"""The port's data-parallel paths on a 2-rank gloo group, against its own
meshless runs and the JAX package's:

- ``BatchPipeline(mesh=)`` on five pages (the runner, trees and shaped
  tasks of tests/test_torch_pipeline.py with the 0/180 classifier; ranks
  0 and 1 run pages 0-2 and 3-4) equals, page by page, the port's
  meshless run (a ``BatchPipeline`` without a mesh on rank 0's tasks, all
  five pages) and JAX's ``BatchPipeline(mesh=)`` on a 2-device dp mesh:
  quads and texts equal, scores within 1e-5, layout cells equal (boxes
  within 1e-3 px of the model input, scores within 1e-4), table and page
  HTML byte-equal;
- the dp ``ExtractionService`` (rank 0 batching, rank 1 in
  ``serve_worker``) answers a PNG page and a two-page digital PDF as the
  meshless service does;
- the dp LORE step (the tiny dla34 config of tests/test_torch_lore_train.py,
  a global batch of four tables with different counts of cells, two rows a
  rank) equals JAX's one-device trainer step on the global batch: losses
  within 1e-5, Adam's first moments (the clipped gradient) within 1e-4 of
  each leaf's largest magnitude, the parameters within 2 lr, both ranks
  bit-equal. The per-rank means of the batch's halves differ from the
  global loss, so a step that averaged them would fail.

The group runs in fresh interpreters that import no JAX
(tests/torch_dist_worker.py), while this process runs the JAX side."""

from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pdf_table_tpu.pipeline.batch_runner as jbr
import pdf_table_tpu.tasks.cls_pulc as jcls
import pdf_table_tpu.tasks.detection as jdet
import pdf_table_tpu.tasks.layout as jlayout
import pdf_table_tpu.tasks.recognition as jrec
import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu.models.lore.config import LoreConfig as JLoreConfig
from pdf_table_tpu.pipeline.system import OcrSystemConfig as JSystemConfig
from pdf_table_tpu.train import lore_trainer as jtrainer
from pdf_table_tpu.train.train_step import TrainState as JTrainState
from pdf_table_tpu_torch import serve
from pdf_table_tpu_torch.convert.flax_bridge import (state_dict_to_flax,
                                                     tree_leaves)
from pdf_table_tpu_torch.models.lore.config import LoreConfig
from pdf_table_tpu_torch.pipeline import batch_runner as tbr
from pdf_table_tpu_torch.pipeline.system import OcrSystemConfig
from pdf_table_tpu_torch.train.lore_trainer import LoreTrainArgs, LoreTrainer
from test_torch_lore_train import TINY as LORE_TRAIN_TINY
from test_torch_lore_train import _close, _tables, _tree
from test_torch_pipeline import (DET, DET_BENCH, LAYOUT, LAYOUT_BENCH, LINES,
                                 LORE_TINY, PAGES, REC, _inject_lines, _page,
                                 add_lines, build_trees, port_pipeline)
from test_torch_serve import _digital_pdf_bytes, _png, same_answer
from torch_dist_worker import Group, page_summary
from torch_dist_worker import add_lines as worker_add_lines

torch.set_num_threads(1)

RUN_PAGES = PAGES + [_page(3, 1200, 940), _page(4, 1000, 800)]
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-4
TEXT_SCORE_ATOL = 1e-5
LR = 1e-3
STEP_LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
KEY_BIAS_ABS = 1e-7


def _train_args(tmp):
    return dict(learning_rate=LR, lr_schedule="constant", batch_size=4,
                grad_clip=1.0, weight_decay=1e-2, save_every=0,
                log_every=100, output_dir=str(tmp))


def _payloads():
    return [("image", _png(RUN_PAGES[0])),
            ("pdf", _digital_pdf_bytes(2))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything both sides need, and the group, started here so that it
    runs beside this process's JAX work; ``ranks()`` waits for its
    results."""
    tmp = tmp_path_factory.mktemp("dp")
    trees = build_trees()
    batch = _tables(4, seed=3)
    tree = _tree(batch)
    inputs = {"trees": trees, "pages": RUN_PAGES,
              "kw": {"det": dict(DET, **DET_BENCH),
                     "layout": dict(LAYOUT_BENCH, **LAYOUT), "rec": REC,
                     "lore": LORE_TINY, "lines": LINES},
              "payloads": _payloads(), "lore_tiny": LORE_TRAIN_TINY,
              "train_args": _train_args(tmp), "lore_tree": tree,
              "train_batch": batch}
    group = Group("runner", 2, inputs, str(tmp))
    # JAX's trainer step compiles on a thread of its own, beside the
    # meshed runner's programs (XLA compiles without the interpreter lock)
    pool = ThreadPoolExecutor(1)
    jax_step = pool.submit(_jax_step, batch, tree, tmp)
    done = []

    def ranks():
        if not done:
            done.append(group.results())
        return done[0]

    yield {"trees": trees, "batch": batch, "tree": tree, "tmp": tmp,
           "ranks": ranks, "jax_step": jax_step}
    pool.shutdown()
    ranks()


def _jax_tasks(trees, mesh):
    with pytest.MonkeyPatch.context() as mp:
        as_np = (lambda t: lambda *a, **k: jax.tree.map(np.asarray, t))
        mp.setattr(jdet, "load_or_init", as_np(trees["det"]))
        mp.setattr(jlayout, "load_or_init", as_np(trees["layout"]))
        mp.setattr(jrec, "load_or_init", as_np(trees["rec"]))
        mp.setattr(jcls, "load_or_init", as_np(trees["cls"]))
        mp.setattr(jts, "load_or_init", as_np(trees["lore"]))
        tasks = {
            "_det": jdet.OcrDetectionTask(model="PP-OCRv4_det", mesh=mesh,
                                          **DET, **DET_BENCH),
            "_layout": jlayout.OcrLayoutTask(model="picodet", mesh=mesh,
                                             **LAYOUT_BENCH, **LAYOUT),
            "_rec": jrec.OcrRecognitionTask(model="PP-OCRv4_rec", mesh=mesh,
                                            **REC),
            "_tsr": jts.OcrTableStructureTask(
                model="Lore", task_type="wireless", mesh=mesh,
                config=JLoreConfig.wireless(**LORE_TINY)),
            "_line_cls": jcls.ClsImagePulcTask(
                task_type="textline_orientation", mesh=mesh)}
        for t in tasks.values():
            t.ensure_built()
    return tasks


@pytest.fixture(scope="module")
def runs(world):
    """(the 2-rank pages, the meshless port's, JAX's on a 2-device mesh),
    each a page summary list."""
    pages = [{"image": p, "page": i} for i, p in enumerate(RUN_PAGES)]
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), axis_names=("dp",))
    cfg = JSystemConfig(use_layout=True, use_table=True,
                        use_orientation_cls=False, use_textline_cls=True)
    jbp = jbr.BatchPipeline(cfg, mesh=mesh, batch_pages=2, device_crops=True,
                            upload_codec="rgb")
    for name, t in _jax_tasks(world["trees"], mesh).items():
        setattr(jbp.system, name, t)
    _inject_lines(jbp)
    jax_pages = [page_summary(o) for o in jbp.run(pages)]
    ranks = world["ranks"]()
    return ranks, ranks[0]["solo"], jax_pages


def _same_page(got, want, text_scores=TEXT_SCORE_ATOL):
    assert got["metric"] == want["metric"] == {}
    assert got["page"] == want["page"]
    assert got["image_shape"] == want["image_shape"]
    np.testing.assert_array_equal(got["quads"], want["quads"])
    assert got["texts"] == want["texts"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=text_scores)
    assert got["layout"] == want["layout"]
    canvas_px = max(tbr.pick_page_bucket(*got["image_shape"])) / 64
    np.testing.assert_allclose(got["layout_boxes"], want["layout_boxes"],
                               rtol=0, atol=BOX_ATOL * canvas_px)
    np.testing.assert_allclose(got["layout_scores"], want["layout_scores"],
                               rtol=0, atol=SCORE_ATOL)
    assert got["table_html"] == want["table_html"]
    assert got["page_html"] == want["page_html"]


def test_the_workers_line_grid_is_the_pipeline_tests():
    shapes = [(1224, 950), (700, 500)]
    quads = [np.zeros((2, 4, 2), np.float32), np.ones((0, 4, 2))]
    for a, b in zip(worker_add_lines(quads, shapes, LINES),
                    add_lines(quads, shapes)):
        np.testing.assert_array_equal(a, b)


def test_dp_runner_equals_the_meshless_port(runs):
    ranks, solo, _ = runs
    for res in ranks:
        assert not res["jax_imported"] and not res["pdf_table_tpu_imported"]
        assert len(res["pages"]) == len(solo) == len(RUN_PAGES)
        for got, want in zip(res["pages"], solo):
            _same_page(got, want)
    # each rank ran its own contiguous shard
    assert [r["own_stats_pages"] for r in ranks] == [3.0, 2.0]
    assert sum(len(p["table_html"]) for p in solo) >= len(RUN_PAGES)


def test_dp_runner_equals_jax_on_a_dp_mesh(runs):
    ranks, _, jax_pages = runs
    assert len(jax_pages) == len(RUN_PAGES)
    for got, want in zip(ranks[0]["pages"], jax_pages):
        _same_page(got, want)


def _jax_step(batch, v, tmp):
    """JAX's one-device trainer step on the global batch, started from
    ``v``: (its metrics, its trainer)."""
    with mock.patch("pdf_table_tpu.engine.params.init_params",
                    lambda *a, **k: v):
        jt = jtrainer.LoreTrainer(JLoreConfig.wtw(**LORE_TRAIN_TINY),
                                  jtrainer.LoreTrainArgs(**_train_args(tmp)))
        jt.init_state(batch)
    jt.state = JTrainState.create(jax.tree.map(np.asarray, v), jt.tx)
    return jt.train_step(batch), jt


def test_dp_lore_step_equals_jaxs_one_device_step(world):
    batch, v = world["batch"], world["tree"]
    want, jt = world["jax_step"].result()
    ranks = world["ranks"]()
    for res in ranks:
        for k in want:
            _close(res["step"][k], want[k], STEP_LOSS_TOL)
    for k in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][k],
                                      ranks[1]["params"][k])
    adam = jt.state.opt_state[1][0]
    got_mu = state_dict_to_flax(
        {k: torch.from_numpy(a) for k, a in ranks[0]["mu"].items()},
        {"params": v["params"]})["params"]
    want_mu = dict(tree_leaves(jax.tree.map(np.asarray, adam.mu)))
    for path, g in tree_leaves(got_mu):
        if path[-2:] == ("k_linear", "bias"):
            assert float(g.abs().max()) < KEY_BIAS_ABS
            assert float(np.abs(want_mu[path]).max()) < KEY_BIAS_ABS
        elif np.abs(want_mu[path]).max():
            _close(g.numpy(), want_mu[path], GRAD_TOL)
        else:
            assert not g.abs().max(), path
    got_p = dict(tree_leaves(state_dict_to_flax(
        {k: torch.from_numpy(a) for k, a in ranks[0]["params"].items()},
        {"params": v["params"]})["params"]))
    want_p = dict(tree_leaves(jax.tree.map(np.asarray, jt.state.params)))
    for path, w in want_p.items():
        assert float(np.abs(got_p[path].numpy() - w).max()) <= 2 * LR, path


def test_dp_service_equals_the_meshless_service(world):
    svc = serve.ExtractionService(OcrSystemConfig(), batch_pages=4,
                                  max_wait_ms=50.0, device="cpu")
    svc.pipeline = port_pipeline(world["trees"], True)
    try:
        want = [svc.submit(kind, payload) for kind, payload in _payloads()]
    finally:
        svc.close()
    got = world["ranks"]()[0]["served"]
    assert "served" not in world["ranks"]()[1]
    assert [len(g["pages"]) for g in got] == [1, 2]
    for g, w in zip(got, want):
        same_answer((200, g), (200, w))


def test_the_batch_halves_differ_from_the_global_mean(world):
    """The trap the dp step avoids: the LORE loss divides by counts over
    the batch, and this batch's halves hold different counts, so the mean
    of the halves' losses is not the global batch's loss."""
    batch, v, tmp = world["batch"], world["tree"], world["tmp"]
    tr = LoreTrainer(LoreConfig.wtw(**LORE_TRAIN_TINY),
                     LoreTrainArgs(**_train_args(tmp)), device="cpu")
    tr.init_state(v)

    def loss(rows):
        b = tr.to_device({k: a[rows] for k, a in batch.items()})
        with torch.no_grad():
            return float(tr.loss(tr.apply(b), b)["loss"])

    whole = loss(slice(0, 4))
    halves = (loss(slice(0, 2)) + loss(slice(2, 4))) / 2
    assert abs(halves - whole) > 1e-3 * abs(whole)
    assert batch["hm_mask"][:2].sum() != batch["hm_mask"][2:].sum()
    _close(world["ranks"]()[0]["step"]["loss"], whole, STEP_LOSS_TOL)
