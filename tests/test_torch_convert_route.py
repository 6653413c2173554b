"""The port's ONNX route, converter entry point, hub resolution and the
tasks' load-or-init, against the JAX package on the CPU.

- The ONNX route on the Paddle-style initializers of tests/helpers_onnx.py
  for every model that takes ONNX weights (PP-OCRv4 det, PP-LCNet, SVTR-
  LCNet, PicoDet, SLANet): the readers agree, the port's
  ``call_ordered_slots`` (forward hooks on the port's module) equals JAX's
  (an abstract flax init), and the matched trees are bit-equal.
- ``python -m pdf_table_tpu_torch.convert`` on a state dict and an ONNX
  file written to a temporary directory.
- The hub's name resolution, and its download with the client mocked.
- Load-or-init: a task built without ``variables`` restores the converted
  tree from the cache directory, and warns when there is none."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.convert import hub as jhub
from pdf_table_tpu.convert import onnx_reader as jonnx
from pdf_table_tpu.convert import onnx_shape_matcher as jmatcher
from pdf_table_tpu_torch.convert import db_pp_convert as pdbpp
from pdf_table_tpu_torch.convert import hub as phub
from pdf_table_tpu_torch.convert import onnx_reader as ponnx
from pdf_table_tpu_torch.convert import onnx_shape_matcher as pmatcher
from pdf_table_tpu_torch.convert import torch_to_flax as pt2f
from pdf_table_tpu_torch.convert.flax_bridge import (flax_to_state_dict,
                                                     transposed_modules,
                                                     tree_leaves)
from pdf_table_tpu_torch.engine import params as P
from test_torch_convert import PICODET, _jax_template, _leaf, _slanet_kw

torch.set_num_threads(1)


def _onnx_case(name):
    """(onnx bytes, JAX model and sample, port model and sample)."""
    from helpers_onnx import paddle_style_onnx_bytes

    if name == "db_pp":
        from pdf_table_tpu.models.dbnet import DBNet, DbNetConfig
        from pdf_table_tpu_torch.models.dbnet.config import \
            DbNetConfig as PCfg
        from pdf_table_tpu_torch.models.dbnet.model import DBNet as PDBNet
        from tests.test_db_pp_convert import TorchDBPP
        from tests.test_pplcnet_convert import randomize_torch

        tm, shape = randomize_torch(TorchDBPP()).eval(), (1, 64, 64, 3)
        return (tm, shape, DBNet(DbNetConfig.ppocr()),
                PDBNet(PCfg.ppocr()).eval())
    if name == "pplcnet":
        from pdf_table_tpu.models.cls import ClsPulcConfig, PPLCNetClassifier
        from pdf_table_tpu_torch.models.cls.config import \
            ClsPulcConfig as PCfg
        from pdf_table_tpu_torch.models.cls.model import \
            PPLCNetClassifier as PCls
        from tests.test_pplcnet_convert import TorchPPLCNet, randomize_torch

        t = "text_image_orientation"
        return (randomize_torch(TorchPPLCNet()).eval(), (1, 64, 96, 3),
                PPLCNetClassifier(ClsPulcConfig(task_type=t)),
                PCls(PCfg(task_type=t)).eval())
    if name == "svtr_lcnet":
        from pdf_table_tpu.models.rec_ctc import CTCRecModel, RecConfig
        from pdf_table_tpu_torch.models.rec_ctc.config import \
            RecConfig as PCfg
        from pdf_table_tpu_torch.models.rec_ctc.model import \
            CTCRecModel as PRec
        from tests.test_pplcnet_convert import randomize_torch
        from tests.test_svtr_convert import TorchSVTRLCNet

        kw = dict(backbone="svtr_lcnet", vocab_size=97)
        return (randomize_torch(TorchSVTRLCNet()).eval(), (1, 48, 96, 3),
                CTCRecModel(RecConfig(**kw)), PRec(PCfg(**kw)).eval())
    if name == "picodet":
        from pdf_table_tpu.models.picodet import PicoDet, PicoDetConfig
        from pdf_table_tpu_torch.models.picodet.config import \
            PicoDetConfig as PCfg
        from pdf_table_tpu_torch.models.picodet.model import \
            PicoDet as PPico
        from tests.test_picodet_convert import TorchPicoDet
        from tests.test_pplcnet_convert import randomize_torch

        return (randomize_torch(TorchPicoDet(0.5, 64, 2, 5, 7)).eval(),
                (1, 64, 64, 3), PicoDet(PicoDetConfig(**PICODET)),
                PPico(PCfg(**PICODET)).eval())
    from pdf_table_tpu.models.slanet import SLANet, SLANetConfig
    from pdf_table_tpu.models.slanet.vocab import StructureVocab
    from pdf_table_tpu_torch.models.slanet.config import \
        SLANetConfig as PCfg
    from pdf_table_tpu_torch.models.slanet.model import SLANet as PSLANet
    from tests.test_pplcnet_convert import randomize_torch
    from tests.test_slanet_convert import TorchSLANet

    vocab = len(StructureVocab())
    return (randomize_torch(TorchSLANet(0.25, 32, 32, vocab, 8, 6)).eval(),
            (2, 64, 64, 3), SLANet(SLANetConfig(**_slanet_kw())),
            PSLANet(PCfg(**_slanet_kw())).eval())


ONNX_MODELS = ["db_pp", "pplcnet", "svtr_lcnet", "picodet", "slanet"]


@pytest.mark.parametrize("name", ONNX_MODELS)
def test_onnx_route_matches_jax(name):
    from helpers_onnx import paddle_style_onnx_bytes

    tm, shape, jmodel, pmodel = _onnx_case(name)
    nchw = (shape[0], shape[3], shape[1], shape[2])
    data = paddle_style_onnx_bytes(tm, torch.zeros(nchw))
    jt, pt = jonnx.read_onnx_initializers(data), \
        ponnx.read_onnx_initializers(data)
    assert list(pt) == list(jt)
    for k in jt:
        np.testing.assert_array_equal(pt[k], jt[k])
    jslots = jmatcher.call_ordered_slots(jmodel, jnp.zeros(shape))
    pslots = pmatcher.call_ordered_slots(pmodel, torch.zeros(shape))
    assert pslots == [tuple(s) for s in jslots]
    jv = _jax_template(jmodel, shape)
    pv = copy.deepcopy(jv)
    jrep = jmatcher.match_by_shape_with_stats(jt, jv, jslots)
    prep = pmatcher.match_by_shape_with_stats(pt, pv, pslots)
    assert prep.ok and prep.mapped == jrep.mapped
    assert prep.missing == jrep.missing
    for path, a in tree_leaves(pv):
        np.testing.assert_array_equal(a, _leaf(jv, path), err_msg=str(path))


def test_match_by_shape_and_flat_order_match_jax():
    """The plain ordered shape matcher and the interleaved tree order
    (no slot list) on the PP-LCNet template."""
    tm, shape, jmodel, _ = _onnx_case("pplcnet")
    from helpers_onnx import paddle_style_onnx_bytes

    t = jonnx.read_onnx_initializers(paddle_style_onnx_bytes(
        tm, torch.zeros(shape[0], shape[3], shape[1], shape[2])))
    jv = _jax_template(jmodel, shape)
    assert [s[:2] for s in pmatcher.execution_ordered_slots(jv)] == \
        [s[:2] for s in jmatcher.execution_ordered_slots(jv)]
    pv, jv2 = copy.deepcopy(jv), copy.deepcopy(jv)
    jrep = jmatcher.match_by_shape_with_stats(t, jv2)
    prep = pmatcher.match_by_shape_with_stats(t, pv)
    assert prep.mapped == jrep.mapped and prep.missing == jrep.missing
    pp, jp = copy.deepcopy(jv["params"]), copy.deepcopy(jv["params"])
    assert pmatcher.match_by_shape(t, pp).mapped == \
        jmatcher.match_by_shape(t, jp).mapped


# -- the entry point, the hub, load-or-init -----------------------------------


def test_entry_point_writes_the_tree_and_sidecars(tmp_path, monkeypatch):
    """``--model pp_det --checkpoint sd.pth`` writes the converted tree
    where the detection task's load-or-init reads it; an ONNX checkpoint
    goes through the shape matcher; sidecar dicts are copied."""
    from pdf_table_tpu_torch.convert.__main__ import main, spec
    from tests.test_db_pp_convert import TorchDBPP
    from tests.test_pplcnet_convert import randomize_torch

    monkeypatch.setenv("PDFTABLE_MODEL_CACHE_DIR", str(tmp_path / "cache"))
    from pdf_table_tpu_torch.utils import constants

    monkeypatch.setattr(constants.Constants, "MODEL_CACHE_DIR",
                        str(tmp_path / "cache"))
    tm = randomize_torch(TorchDBPP()).eval()
    ck = tmp_path / "ck"
    ck.mkdir()
    torch.save(tm.state_dict(), ck / "model.pth")
    (ck / "en_dict.txt").write_text("a\nb\n")
    assert main(["--model", "pp_det", "--checkpoint",
                 str(ck / "model.pth")]) == 0
    s = spec("pp_det")
    out = s.out_dir
    assert out == str(tmp_path / "cache" / "detection" / "PP-OCRv4_det")
    assert sorted(os.listdir(out)) == ["en_dict.txt", P.CKPT_FILE]
    tree = P.load_params(out)
    want = s.template()
    rep = pdbpp.convert_db_pp(pt2f.TorchTensorSource(tm.state_dict()), want)
    assert rep.ok
    for path, a in tree_leaves(want):
        np.testing.assert_array_equal(_leaf(tree, path), a)

    from helpers_onnx import paddle_style_onnx_bytes

    (ck / "model.onnx").write_bytes(
        paddle_style_onnx_bytes(tm, torch.zeros(1, 3, 64, 64)))
    assert main(["--model", "pp_det", "--checkpoint", str(ck / "model.onnx"),
                 "--out", str(tmp_path / "onnx_out")]) == 0
    onnx_tree = P.load_params(tmp_path / "onnx_out")
    for path, a in tree_leaves(want):
        np.testing.assert_array_equal(_leaf(onnx_tree, path), a)


def test_entry_point_knows_jax_model_names():
    from pdf_table_tpu_torch.convert.__main__ import MODELS, spec

    for name in MODELS:
        s = spec(name)
        assert s.template()["params"]
    with pytest.raises(SystemExit):
        spec("no_such_model")


@pytest.mark.parametrize("model,variant", [
    ("pp_det", ""), ("pp_det", "ch"), ("pp_rec", "japan"),
    ("db_resnet18", ""), ("lore_wtw", ""), ("slanet", "")])
@pytest.mark.parametrize("modelscope", ["0", "1"])
def test_hub_resolution_matches_jax(model, variant, modelscope, monkeypatch):
    monkeypatch.setenv("PDFTABLE_USE_MODELSCOPE_HUB", modelscope)
    try:
        want = jhub.resolve_hub_id(model, variant)
    except KeyError as e:
        with pytest.raises(KeyError):
            phub.resolve_hub_id(model, variant)
        return
    assert phub.resolve_hub_id(model, variant) == want
    assert phub.HUB_MODEL_IDS == jhub.HUB_MODEL_IDS


def test_hub_download_fails_with_an_actionable_message(monkeypatch,
                                                       tmp_path):
    """The hub client is replaced by one that fails as an offline client
    does; a missing client raises too. Nothing is fetched."""
    import sys
    import types

    fake = types.ModuleType("huggingface_hub")

    def offline(repo_id, cache_dir=None):
        raise OSError("network is unreachable")

    fake.snapshot_download = offline
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    monkeypatch.setenv("PDFTABLE_USE_MODELSCOPE_HUB", "0")
    with pytest.raises(RuntimeError, match="--checkpoint"):
        phub.download_snapshot("org/repo")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        phub.download_snapshot("org/repo")
    (tmp_path / "model_best.pth").write_bytes(b"")
    (tmp_path / "processor_best.pth").write_bytes(b"")
    assert phub.find_checkpoint(str(tmp_path)) == \
        jhub.find_checkpoint(str(tmp_path))


@pytest.fixture
def cache(tmp_path, monkeypatch):
    from pdf_table_tpu_torch.utils import constants

    monkeypatch.setattr(constants.Constants, "MODEL_CACHE_DIR",
                        str(tmp_path))
    warned = []
    monkeypatch.setattr(P.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    return tmp_path, warned


def test_tasks_load_a_converted_tree(cache):
    """The detection task (PP-OCRv4 det) and the LORE task (wireless)
    built without ``variables`` take the tree saved in their
    ``weights_dir``, and say nothing."""
    from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig
    from pdf_table_tpu_torch.models.lore.config import LoreConfig
    from pdf_table_tpu_torch.tasks.detection import OcrDetectionTask
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    root, warned = cache
    det_tree = P.init_dbnet(DbNetConfig.ppocr(), seed=5)
    P.save_params(det_tree, root / "detection" / "PP-OCRv4_det")
    tiny = dict(resolution=(64, 64), max_objs=8, hidden_size=32,
                head_conv=16, tsfm_layers=1, stacking_layers=1, num_heads=4,
                max_fmp_size=64, d_ff=64)
    lore_tree = P.init_lore(LoreConfig.wireless(**tiny), seed=6)
    P.save_params(lore_tree, root / "table_structure" / "Lore_wireless")
    det = OcrDetectionTask(device="cpu")
    tsr = OcrTableStructureTask(model="Lore", task_type="wireless",
                                config=LoreConfig.wireless(**tiny),
                                device="cpu")
    for task, tree in ((det, det_tree), (tsr, lore_tree)):
        sd = task.model.state_dict()
        want = flax_to_state_dict(tree, transposed_modules(task.model))
        assert set(want) == set(sd)
        for k, v in want.items():
            np.testing.assert_array_equal(sd[k].numpy(), v.numpy(),
                                          err_msg=k)
    assert warned == []


def test_tasks_warn_on_random_weights(cache, monkeypatch):
    from pdf_table_tpu_torch.tasks.cls_pulc import ClsImagePulcTask

    root, warned = cache
    monkeypatch.setenv("PDF_TABLE_TPU_ALLOW_RANDOM_INIT", "")
    ClsImagePulcTask("textline_orientation", device="cpu")
    assert len(warned) == 1 and "RANDOM" in warned[0]
    assert os.path.join("cls", "PPLCNet_textline_orientation") in warned[0]
    monkeypatch.setenv("PDF_TABLE_TPU_ALLOW_RANDOM_INIT", "quiet")
    ClsImagePulcTask("textline_orientation", device="cpu")
    assert len(warned) == 1
    # a file that does not load is reported and replaced by the init
    bad = root / "cls" / "PPLCNet_textline_orientation"
    bad.mkdir(parents=True)
    (bad / P.CKPT_FILE).write_bytes(b"not a tree")
    ClsImagePulcTask("textline_orientation", device="cpu")
    assert len(warned) == 2 and "restore failed" in warned[1]


def _jax_cache(root, monkeypatch):
    from pdf_table_tpu.utils.constants import Constants as JConstants

    monkeypatch.setattr(JConstants, "MODEL_CACHE_DIR", str(root))
    monkeypatch.setenv("PDFTABLE_DICT_DIR", str(root / "none"))


def test_recognition_reads_the_dict_beside_converted_weights(cache,
                                                             monkeypatch):
    """A converted ``ch`` recognizer decodes with the dict file in its
    weights directory, as JAX's task does; without that file the
    constructor raises on both sides, where without converted weights both
    fall back to the provisional charset."""
    from pdf_table_tpu.tasks.recognition import \
        OcrRecognitionTask as JRecTask
    from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig
    from pdf_table_tpu_torch.tasks.recognition import OcrRecognitionTask

    root, _ = cache
    _jax_cache(root, monkeypatch)
    kw = dict(charset_name="ch", vocab_size=5)
    wdir = root / "recognition" / "PP-OCRv4_rec_ch"
    tree = P.init_rec(RecConfig(**kw), seed=3)
    P.save_params(tree, wdir)
    (wdir / "ppocr_keys_v1.txt").write_text("的\n一\n是\n",
                                            encoding="utf-8")
    task = OcrRecognitionTask(device="cpu", **kw)
    assert task.charset.decode_ids([1, 2, 3]) == "的一是" == \
        JRecTask(**kw).charset.decode_ids([1, 2, 3])
    sd = task.model.state_dict()
    for k, v in flax_to_state_dict(tree, transposed_modules(
            task.model)).items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    (wdir / "ppocr_keys_v1.txt").unlink()
    with pytest.raises((RuntimeError, ValueError)):
        OcrRecognitionTask(device="cpu", **kw)
    (wdir / "checkpoint").mkdir()     # what JAX's task takes for a tree
    with pytest.raises((RuntimeError, ValueError)):
        JRecTask(**kw)
    (wdir / P.CKPT_FILE).unlink()
    (wdir / "checkpoint").rmdir()
    assert OcrRecognitionTask(device="cpu", **kw).charset.generic_fallback
    assert JRecTask(**kw).charset.generic_fallback


@pytest.mark.parametrize("model,fname", [
    ("SLANet", "table_structure_dict.txt"),
    ("TableMaster", "structure_alphabet.txt")])
def test_token_models_read_the_sidecar_dict(cache, monkeypatch, model,
                                            fname):
    """SLANet and TableMaster decode with the structure dict that the
    converter copies beside their weights (the built-in tokens in reverse
    order here, so that every id moves), as JAX's tasks do; a config that
    names its own dict keeps it."""
    from pdf_table_tpu.tasks.table_structure import \
        OcrTableStructureTask as JTask
    from pdf_table_tpu_torch.models.slanet.vocab import StructureVocab
    from pdf_table_tpu_torch.models.table_master.vocab import \
        MasterStructureVocab
    from pdf_table_tpu_torch.tasks.table_structure import \
        OcrTableStructureTask

    root, _ = cache
    _jax_cache(root, monkeypatch)
    if model == "SLANet":
        builtin = StructureVocab().tokens[1:-1]
        kw = dict(table_max_len=64, hidden_size=32, max_structure_len=6)
    else:
        builtin = MasterStructureVocab().tokens[:-4]
        kw = dict(img_size=(64, 64), d_model=32, decoder_layers=2, heads=4,
                  ff_dim=64, max_structure_len=6)
    wdir = root / "table_structure" / model
    wdir.mkdir(parents=True)
    path = wdir / fname
    path.write_text("\n".join(builtin[::-1]) + "\n", encoding="utf-8")
    task = OcrTableStructureTask(model=model, device="cpu", **kw)
    want = JTask(model=model, **kw).post.vocab.tokens
    assert task.model_config.dict_path == str(path)
    assert task.post.vocab.tokens == want
    assert want != (StructureVocab() if model == "SLANet"
                    else MasterStructureVocab()).tokens
    own = root / "own.txt"
    own.write_text("\n".join(builtin) + "\n", encoding="utf-8")
    task = OcrTableStructureTask(model=model, device="cpu",
                                 dict_path=str(own), **kw)
    assert task.model_config.dict_path == str(own)
