"""TableMaster and MtlTabNet in the port against the JAX package on the
CPU, continued from tests/test_torch_table_master.py (trees and
tolerances as there): the MtlTabNet tree (its cell branch's parameters
load both ways), the cell decode ``_decode_cells`` at a tiny config, and
the task's ``__call__`` and ``batch_infer_from_pages`` for "TableMaster"
and "MtlTabNet" (the JAX task loads the tree through a monkeypatched
``tasks.table_structure.load_or_init``)."""

import jax
import numpy as np
import pytest
import torch

import pdf_table_tpu.tasks.table_structure as jts
from pdf_table_tpu_torch.convert.flax_bridge import (load_flax_variables,
                                                     state_dict_to_flax,
                                                     tree_leaves)
from pdf_table_tpu_torch.models.table_master.config import \
    TableMasterConfig
from pdf_table_tpu_torch.models.table_master.model import TableMaster
from pdf_table_tpu_torch.tasks.table_structure import OcrTableStructureTask
from test_torch_dtype_policy import assert_bf16_rule
from test_torch_slanet import (STRUCT_GAIN, _capture, assert_greedy_equal,
                               assert_results_equal)
from test_torch_table_master import (MTL_TINY, _inputs, _jax, _port,
                                     jax_positions, master_tree)

torch.set_num_threads(1)

assert jax_positions        # the autouse fixture, for this module too


def test_mtl_tabnet_tree_round_trip():
    """The MtlTabNet tree (cell branch included) loads into the port's
    model, comes back out of its state_dict leaf for leaf, and gives the
    structure outputs of JAX's."""
    cfg = TableMasterConfig(**MTL_TINY)
    x = _inputs((64, 64), 2, seed=3)
    tree = master_tree(cfg, x)
    model = TableMaster(cfg)
    load_flax_variables(model, tree)
    assert "cell_embed" in dict(model.named_parameters())
    back = state_dict_to_flax(model.state_dict(), tree)
    for (p, a), (q, b) in zip(tree_leaves(tree), tree_leaves(back)):
        assert p == q
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    got = _port(cfg, tree, x)
    want = _jax(MTL_TINY, tree, x)
    assert set(got) == set(want) == {"structure_probs", "loc_preds"}
    assert_greedy_equal(got, want)


def test_decode_cells_matches_jax():
    """The MtlTabNet cell branch at a tiny config: the slots, their
    validity and the greedy cell ids, with td ids that the greedy
    structure decode emits."""
    x = _inputs((64, 64), 2, seed=4)
    base = TableMasterConfig(**MTL_TINY)
    tree = master_tree(base, x)
    probe = _port(base, tree, x)["structure_probs"].argmax(-1)
    td = tuple(int(t) for t in np.unique(probe)[:2])
    kw = dict(MTL_TINY, td_token_ids=td)
    tree["params"]["fc_cell"] *= STRUCT_GAIN
    got = _port(TableMasterConfig(**kw), tree, x, decode_cells=True)
    want = _jax(kw, tree, x, decode_cells=True)
    assert_greedy_equal(got, want)
    np.testing.assert_array_equal(got["cell_valid"], want["cell_valid"])
    assert got["cell_valid"].any()
    assert got["cell_eos_id"] == int(want["cell_eos_id"]) == 279
    np.testing.assert_array_equal(got["cell_ids"], want["cell_ids"])


# -- the task ---------------------------------------------------------------

PAGES = np.stack([np.random.default_rng(s).integers(
    0, 256, (150, 170, 3), dtype=np.uint8) for s in range(2)])
REGIONS = [(0, (10, 20, 160, 120)), (1, (0, 0, 170, 150)),
           (0, (40, 5, 90, 140))]
TASK_KW = dict(img_size=(64, 64), d_model=32, decoder_layers=2, heads=4,
               ff_dim=64, max_structure_len=10)


@pytest.fixture(scope="module", params=["TableMaster", "MtlTabNet"])
def task_case(request):
    """The model name and its tree, calibrated on the task's own inputs
    for REGIONS."""
    task = OcrTableStructureTask(model=request.param, device="cpu",
                                 **TASK_KW)
    (_, _, x), = task.sub_batches(PAGES, REGIONS)
    return request.param, master_tree(task.model_config, x.numpy())


def _jax_task(model, tree, monkeypatch):
    monkeypatch.setattr(jts, "load_or_init",
                        lambda *a, **k: jax.tree.map(np.asarray, tree))
    task = jts.OcrTableStructureTask(model=model, **TASK_KW)
    task.ensure_built()
    return task


def test_task_batch_infer_from_pages_matches_jax(task_case, monkeypatch):
    model, tree = task_case
    want_raw = _capture(monkeypatch, jts.OcrTableStructureTask,
                        "_postprocess", lambda r: r["structure_probs"])
    want = _jax_task(model, tree, monkeypatch).batch_infer_from_pages(
        PAGES, REGIONS)
    got_raw = _capture(monkeypatch, OcrTableStructureTask, "_post_one",
                       lambda r: r)
    task = OcrTableStructureTask(model=model, device="cpu", variables=tree,
                                 batch_size=2, **TASK_KW)
    assert task.model_config.variant == ("mtl_tabnet" if model ==
                                         "MtlTabNet" else "table_master")
    got = task.batch_infer_from_pages(torch.from_numpy(PAGES), REGIONS)
    assert len(got) == len(want) == len(REGIONS)
    assert all(r["type"] == "master" for r in got)
    assert sum(len(r["structure_tokens"]) for r in got) > 0
    assert_results_equal(got, want, got_raw, want_raw)


def test_task_call_matches_jax(task_case, monkeypatch):
    model, tree = task_case
    want_raw = _capture(monkeypatch, jts.OcrTableStructureTask,
                        "_postprocess", lambda r: r["structure_probs"])
    img = PAGES[1][10:140, 5:150]
    want = _jax_task(model, tree, monkeypatch)(img)
    got_raw = _capture(monkeypatch, OcrTableStructureTask, "_post_one",
                       lambda r: r)
    got = OcrTableStructureTask(model=model, device="cpu", variables=tree,
                                **TASK_KW)(img)
    assert_results_equal([got], [want], got_raw, want_raw)


def test_task_rejects_bf16():
    """The TableMaster and MtlTabNet tasks build in bf16 (against JAX:
    tests/test_torch_bf16_tsr.py): the encoder with flax's weight rule,
    the decoder, its memory projection and the cell branch f32, as in
    JAX."""
    for model in ("TableMaster", "MtlTabNet"):
        task = OcrTableStructureTask(model=model, device="cpu",
                                     dtype="bfloat16", **TASK_KW)
        # "": the decoder's flat parameters, the model's own
        f32 = [""] + [n for n, _ in task.model.named_children()
                      if n != "encoder"]
        assert_bf16_rule(task.model, f32=f32)
