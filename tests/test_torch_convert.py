"""The port's converters against the JAX package's on the CPU, on the
reference-shaped torch modules that JAX's converter tests build (imported
read-only from tests/test_*_convert.py and tests/test_lgpma.py) and on the
Paddle-style ONNX initializers of tests/helpers_onnx.py.

Each name map runs on the same source from the same zero template shaped
like JAX's init (``jax.eval_shape``). Held: the port's own seeded template
(engine/params.py::init_*) has JAX's paths and shapes, the reports are
equal (every mapped name, path and shape, the missing and mis-shaped
ones), the sources' unused names are equal, and the trees are bit-equal.
The ONNX route, the entry point, the hub and the tasks' load-or-init are
held in tests/test_torch_convert_route.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdf_table_tpu.convert import centernet_convert as jcenternet
from pdf_table_tpu.convert import convnext_convert as jconvnext
from pdf_table_tpu.convert import crnn_convert as jcrnn
from pdf_table_tpu.convert import db_pp_convert as jdbpp
from pdf_table_tpu.convert import dbnas_convert as jdbnas
from pdf_table_tpu.convert import dbnet_convert as jdbnet
from pdf_table_tpu.convert import lgpma_convert as jlgpma
from pdf_table_tpu.convert import lore_convert as jlore
from pdf_table_tpu.convert import lwe_convert as jlwe
from pdf_table_tpu.convert import master_convert as jmaster
from pdf_table_tpu.convert import picodet_convert as jpicodet
from pdf_table_tpu.convert import pplcnet_convert as jpplcnet
from pdf_table_tpu.convert import slanet_convert as jslanet
from pdf_table_tpu.convert import svtr_convert as jsvtr
from pdf_table_tpu.convert import torch_to_flax as jt2f
from pdf_table_tpu_torch.convert import centernet_convert as pcenternet
from pdf_table_tpu_torch.convert import convnext_convert as pconvnext
from pdf_table_tpu_torch.convert import crnn_convert as pcrnn
from pdf_table_tpu_torch.convert import db_pp_convert as pdbpp
from pdf_table_tpu_torch.convert import dbnas_convert as pdbnas
from pdf_table_tpu_torch.convert import dbnet_convert as pdbnet
from pdf_table_tpu_torch.convert import lgpma_convert as plgpma
from pdf_table_tpu_torch.convert import lore_convert as plore
from pdf_table_tpu_torch.convert import lwe_convert as plwe
from pdf_table_tpu_torch.convert import master_convert as pmaster
from pdf_table_tpu_torch.convert import picodet_convert as ppicodet
from pdf_table_tpu_torch.convert import pplcnet_convert as ppplcnet
from pdf_table_tpu_torch.convert import slanet_convert as pslanet
from pdf_table_tpu_torch.convert import svtr_convert as psvtr
from pdf_table_tpu_torch.convert import torch_to_flax as pt2f
from pdf_table_tpu_torch.convert.flax_bridge import tree_leaves
from pdf_table_tpu_torch.engine import params as P

torch.set_num_threads(1)


def _jax_template(model, shape, *extra):
    """Zero leaves in the structure of JAX's init."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(shape), *extra))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))


def _paths(tree):
    return {p: np.shape(a) for p, a in tree_leaves(tree)}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


# -- the cases: (torch state dict, JAX model + sample, port template, maps)


def _dbnet():
    from pdf_table_tpu.models.dbnet import DBNet, DbNetConfig
    from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig as PCfg
    from tests.test_dbnet_convert import build_reference_dbnet18

    kw = dict(backbone="resnet18", inner_channels=256)
    return (build_reference_dbnet18(inner=256).state_dict(),
            _jax_template(DBNet(DbNetConfig(**kw)), (1, 64, 64, 3)),
            P.init_dbnet(PCfg(**kw)),
            lambda s, v: jdbnet.convert_dbnet(s, v, depth=18),
            lambda s, v: pdbnet.convert_dbnet(s, v, depth=18))


def _dbnas():
    from pdf_table_tpu.models.dbnet import DBNet, DbNetConfig
    from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig as PCfg
    from tests.test_dbnas_convert import build_torch_dbnas

    kw = dict(backbone="proxylessnas", inner_channels=64)
    return (build_torch_dbnas().state_dict(),
            _jax_template(DBNet(DbNetConfig(**kw)), (1, 64, 64, 3)),
            P.init_dbnet(PCfg(**kw)), jdbnas.convert_dbnas,
            pdbnas.convert_dbnas)


def _db_pp():
    from pdf_table_tpu.models.dbnet import DBNet, DbNetConfig
    from pdf_table_tpu_torch.models.dbnet.config import DbNetConfig as PCfg
    from tests.test_db_pp_convert import TorchDBPP
    from tests.test_pplcnet_convert import randomize_torch

    return (randomize_torch(TorchDBPP()).state_dict(),
            _jax_template(DBNet(DbNetConfig.ppocr()), (1, 64, 64, 3)),
            P.init_dbnet(PCfg.ppocr()), jdbpp.convert_db_pp,
            pdbpp.convert_db_pp)


def _pplcnet():
    from pdf_table_tpu.models.cls import ClsPulcConfig, PPLCNetClassifier
    from pdf_table_tpu_torch.models.cls.config import \
        ClsPulcConfig as PCfg
    from tests.test_pplcnet_convert import TorchPPLCNet, randomize_torch

    t = "text_image_orientation"
    return (randomize_torch(TorchPPLCNet()).state_dict(),
            _jax_template(PPLCNetClassifier(ClsPulcConfig(task_type=t)),
                          (2, 64, 96, 3)),
            P.init_cls(PCfg(task_type=t)), jpplcnet.convert_pplcnet,
            ppplcnet.convert_pplcnet)


def _svtr():
    from pdf_table_tpu.models.rec_ctc import CTCRecModel, RecConfig
    from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig as PCfg
    from tests.test_pplcnet_convert import randomize_torch
    from tests.test_svtr_convert import TorchSVTRLCNet

    kw = dict(backbone="svtr_lcnet", vocab_size=97)
    return (randomize_torch(TorchSVTRLCNet()).state_dict(),
            _jax_template(CTCRecModel(RecConfig(**kw)), (1, 48, 96, 3)),
            P.init_rec(PCfg(**kw)), jsvtr.convert_svtr_lcnet,
            psvtr.convert_svtr_lcnet)


def _crnn():
    from pdf_table_tpu.models.rec_ctc import CTCRecModel, RecConfig
    from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig as PCfg
    from tests.test_crnn_convert import build_reference_crnn

    kw = dict(vocab_size=37, hidden_size=256)
    return (build_reference_crnn(vocab=37).state_dict(),
            _jax_template(CTCRecModel(RecConfig.crnn(**kw)), (1, 32, 48, 3)),
            P.init_rec(PCfg.crnn(**kw)), jcrnn.convert_crnn,
            pcrnn.convert_crnn)


def _convnext():
    from pdf_table_tpu.models.rec_ctc import CTCRecModel, RecConfig
    from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig as PCfg
    from tests import test_convnext_convert as T

    torch.manual_seed(0)
    tm = T.build_torch_mirror().eval()
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if "layernorm" in name or "layer_scale" in name:
                p.add_(torch.randn_like(p) * 0.05)
    kw = dict(vocab_size=T.V, convnext_depths=T.DEPTHS,
              convnext_hidden=T.HIDDEN, vit_dim=T.VDIM,
              vit_layers=T.VLAYERS, vit_heads=T.VHEADS,
              vit_pos_len=T.TOKENS, img_width=T.W, width_buckets=(T.W,))
    return (dict(tm.state_dict()),
            _jax_template(CTCRecModel(RecConfig.convnext_vit(**kw)),
                          (2, T.H, T.W, 1)),
            P.init_rec(PCfg.convnext_vit(**kw)),
            lambda s, v: jconvnext.convert_convnext_vit(s, v,
                                                        depths=T.DEPTHS),
            lambda s, v: pconvnext.convert_convnext_vit(s, v,
                                                        depths=T.DEPTHS))


def _lwe():
    from pdf_table_tpu.models.rec_ctc import CTCRecModel, RecConfig
    from pdf_table_tpu_torch.models.rec_ctc.config import RecConfig as PCfg
    from tests.test_lwe_convert import build_torch_lwe

    kw = dict(backbone="lightweight_edge", vocab_size=7644, img_height=32)
    return (build_torch_lwe().state_dict(),
            _jax_template(CTCRecModel(RecConfig(**kw)), (1, 32, 64, 3)),
            P.init_rec(PCfg(**kw)), jlwe.convert_lightweight_edge,
            plwe.convert_lightweight_edge)


PICODET = dict(task_type="en", lcnet_scale=0.5, neck_channels=64,
               head_convs=2)


def _picodet():
    from pdf_table_tpu.models.picodet import PicoDet, PicoDetConfig
    from pdf_table_tpu_torch.models.picodet.config import \
        PicoDetConfig as PCfg
    from tests.test_picodet_convert import TorchPicoDet
    from tests.test_pplcnet_convert import randomize_torch

    return (randomize_torch(TorchPicoDet(0.5, 64, 2, 5, 7)).state_dict(),
            _jax_template(PicoDet(PicoDetConfig(**PICODET)), (1, 64, 64, 3)),
            P.init_picodet(PCfg(**PICODET)),
            lambda s, v: jpicodet.convert_picodet(s, v, num_levels=4,
                                                  head_convs=2),
            lambda s, v: ppicodet.convert_picodet(s, v, num_levels=4,
                                                  head_convs=2))


def _slanet_kw():
    return dict(table_max_len=64, hidden_size=32, max_structure_len=6,
                lcnet_scale=0.25, neck_channels=32)


def _slanet():
    from pdf_table_tpu.models.slanet import SLANet, SLANetConfig
    from pdf_table_tpu.models.slanet.vocab import StructureVocab
    from pdf_table_tpu_torch.models.slanet.config import \
        SLANetConfig as PCfg
    from tests.test_pplcnet_convert import randomize_torch
    from tests.test_slanet_convert import TorchSLANet

    vocab = len(StructureVocab())
    return (randomize_torch(TorchSLANet(0.25, 32, 32, vocab, 8, 6))
            .state_dict(),
            _jax_template(SLANet(SLANetConfig(**_slanet_kw())),
                          (2, 64, 64, 3)),
            P.init_slanet(PCfg(**_slanet_kw())), jslanet.convert_slanet,
            pslanet.convert_slanet)


def _lore_detector():
    from pdf_table_tpu.models.lore import LoreConfig, LoreModel
    from pdf_table_tpu_torch.models.lore.config import LoreConfig as PCfg
    from tests.test_lore_convert import TDLASeg

    kw = dict(backbone="dla34", resolution=(64, 64), max_objs=8,
              hidden_size=256, head_conv=256, tsfm_layers=1,
              stacking_layers=1)
    return (TDLASeg(hidden=256, head_conv=256).state_dict(),
            _jax_template(LoreModel(LoreConfig(**kw)), (1, 64, 64, 3)),
            P.init_lore(PCfg(**kw)),
            lambda s, v: jlore.convert_lore_detector(s, v, hidden_size=256),
            lambda s, v: plore.convert_lore_detector(s, v, hidden_size=256))


def _lore_processor():
    from pdf_table_tpu.models.lore import LoreConfig, LoreModel
    from pdf_table_tpu_torch.models.lore.config import LoreConfig as PCfg
    from tests.test_lore_convert import TProcessor

    kw = dict(backbone="dla34", resolution=(64, 64), max_objs=8,
              hidden_size=32, head_conv=16, tsfm_layers=1,
              stacking_layers=1, num_heads=4, max_fmp_size=64, d_ff=64)
    return (TProcessor(hidden=32, layers=1, heads=4, d_ff=64).state_dict(),
            _jax_template(LoreModel(LoreConfig(**kw)), (1, 64, 64, 3)),
            P.init_lore(PCfg(**kw)),
            lambda s, v: jlore.convert_lore_processor(
                s, v, tsfm_layers=1, stacking_layers=1),
            lambda s, v: plore.convert_lore_processor(
                s, v, tsfm_layers=1, stacking_layers=1))


def _master():
    from pdf_table_tpu.models.table_master import (TableMaster,
                                                   TableMasterConfig)
    from pdf_table_tpu_torch.models.table_master.config import \
        TableMasterConfig as PCfg
    from tests import test_master_convert as T

    torch.manual_seed(0)
    tm = T.TTableMaster().eval()
    T._randomize_bn(tm)
    kw = dict(img_size=(32, 32), d_model=T.D, decoder_layers=T.N,
              heads=T.HEADS, ff_dim=T.FF, max_structure_len=T.T,
              vocab_size=T.V)
    return (dict(tm.state_dict()),
            _jax_template(TableMaster(TableMasterConfig(**kw)),
                          (1, 32, 32, 3)),
            P.init_table_master(PCfg(**kw)),
            lambda s, v: jmaster.convert_table_master(s, v, n_layers=T.N),
            lambda s, v: pmaster.convert_table_master(s, v, n_layers=T.N))


def _docx():
    from pdf_table_tpu.models.docx_layout import (DocXLayoutConfig,
                                                  DocXLayoutModel)
    from pdf_table_tpu_torch.models.docx_layout.config import \
        DocXLayoutConfig as PCfg
    from tests.test_lore_convert import build_dla_centernet_torch

    heads = {"cls": 4, "ftype": 3, "hm": 11, "hm_sub": 2, "reg": 2,
             "wh": 8}
    kw = dict(resolution=(64, 64), head_conv=16)
    return (build_dla_centernet_torch(heads, head_conv=16).state_dict(),
            _jax_template(DocXLayoutModel(DocXLayoutConfig(**kw)),
                          (1, 64, 64, 3)),
            P.init_docx_layout(PCfg(**kw)), jcenternet.convert_docx_layout,
            pcenternet.convert_docx_layout)


def _centernet():
    from pdf_table_tpu.models.center_net import (CenterNetConfig,
                                                 CycleCenterNet)
    from pdf_table_tpu_torch.models.center_net.config import \
        CenterNetConfig as PCfg
    from tests.test_lore_convert import build_dla_centernet_torch

    heads = {"hm": 2, "v2c": 8, "c2v": 8, "reg": 2}
    kw = dict(resolution=(64, 64), head_conv=16, K=4, MK=8)
    return (build_dla_centernet_torch(heads, head_conv=16).state_dict(),
            _jax_template(CycleCenterNet(CenterNetConfig(**kw)),
                          (1, 64, 64, 3)),
            P.init_centernet(PCfg(**kw)),
            jcenternet.convert_cycle_centernet,
            pcenternet.convert_cycle_centernet)


def _lgpma():
    from pdf_table_tpu.models.lgpma import LGPMA, LgpmaConfig
    from pdf_table_tpu_torch.models.lgpma.config import LgpmaConfig as PCfg
    from tests.test_lgpma import TestLgpmaConvert

    kw = dict(rpn_pre_topk=16, num_proposals=16, mask_top=4)
    return (TestLgpmaConvert()._torch_replica().state_dict(),
            _jax_template(LGPMA(LgpmaConfig(**kw)), (1, 64, 64, 3)),
            P.init_lgpma(PCfg(**kw)), jlgpma.convert_lgpma,
            plgpma.convert_lgpma)


CASES = {"dbnet_resnet18": _dbnet, "dbnas": _dbnas, "db_pp": _db_pp,
         "pplcnet": _pplcnet, "svtr_lcnet": _svtr, "crnn": _crnn,
         "convnext_vit": _convnext, "lightweight_edge": _lwe,
         "picodet": _picodet, "slanet": _slanet,
         "lore_detector": _lore_detector, "lore_processor": _lore_processor,
         "table_master": _master, "docx_layout": _docx,
         "cycle_centernet": _centernet, "lgpma": _lgpma}


@pytest.mark.parametrize("name", list(CASES))
def test_name_map_matches_jax(name):
    """The port's template has JAX's paths and shapes; from the same zero
    template the two maps give bit-equal trees and equal reports."""
    state, jv, pv, jconv, pconv = CASES[name]()
    assert _paths(pv) == _paths(jv)
    pv = jax.tree.map(np.zeros_like, jv)
    jsrc, psrc = jt2f.TorchTensorSource(state), pt2f.TorchTensorSource(state)
    jrep, prep = jconv(jsrc, jv), pconv(psrc, pv)
    assert prep.ok and prep.mapped
    assert (prep.mapped, prep.missing, prep.shape_errors) == \
        (jrep.mapped, jrep.missing, jrep.shape_errors)
    assert psrc.unused() == jsrc.unused()
    for path, a in tree_leaves(pv):
        want = _leaf(jv, path)
        assert a.dtype == want.dtype, path
        np.testing.assert_array_equal(a, want, err_msg=str(path))
