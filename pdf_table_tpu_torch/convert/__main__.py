"""Convert reference checkpoints (torch .pt/.pth or Paddle-exported .onnx)
to the port's flax-layout trees (the counterpart of
tools/convert_weights.py, with the same model names).

Usage:
  python -m pdf_table_tpu_torch.convert --model <name> --checkpoint <file>
      [--out d]
  python -m pdf_table_tpu_torch.convert --model <name> --from-hub
      [--variant ch]

The template of each model is the port's seeded init
(engine/params.py::init_*): the maps fill its leaves and check their
shapes. A ``.onnx`` checkpoint goes through the ordered shape matcher
(convert/onnx_shape_matcher.py), its slots in the order the port's module
calls them; review the printed report. The tree is written with
engine/params.py::save_params into models/registry.py::weights_dir (or
``--out``), where the tasks' load-or-init finds it; dict / alphabet / label
sidecar files next to the checkpoint are copied beside it.

Models:
  db_resnet18 db_resnet50 db_proxylessnas pp_det    detection
  pp_rec crnn convnext_vit lightweight_edge         recognition
  slanet lore_<wtw|wireless> table_master mtl_tabnet
  cycle_centernet lgpma                             table structure
  picodet docx_layout                               layout
  pplcnet_<task_type>                               classifiers
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..engine import params as P
from ..models.registry import build_config, weights_dir


class Spec:
    """One model name: where its weights go, its template tree, its
    module (for the ONNX route) and its name map."""

    def __init__(self, task: str, reg_name: str, lang: str, cfg: Any,
                 init: Callable[[Any], Dict[str, Any]],
                 build: Callable[[Any], torch.nn.Module],
                 sample_shape: Tuple[int, ...], convert: Callable):
        self.task, self.reg_name, self.lang = task, reg_name, lang
        self.cfg, self.init, self.build = cfg, init, build
        self.sample_shape, self.convert = sample_shape, convert
        self.checkpoint: Optional[str] = None

    @property
    def out_dir(self) -> str:
        return weights_dir(self.task, self.reg_name, self.lang)

    def template(self) -> Dict[str, Any]:
        return self.init(self.cfg)


def _lore_convert(spec: Spec) -> Callable:
    from .lore_convert import convert_lore_detector, convert_lore_processor
    from .torch_to_flax import TorchTensorSource

    def conv(src, variables):
        cfg = spec.cfg
        rep = convert_lore_detector(src, variables, cfg.hidden_size)
        # the processor may live in the same checkpoint, or in a sibling
        # processor_best.pth
        proc_src = src
        if not any("tsfm_axis" in k for k in src.keys()):
            proc_src = TorchTensorSource(
                spec.checkpoint.replace("model_best", "processor_best"))
        rep2 = convert_lore_processor(proc_src, variables, cfg.tsfm_layers,
                                      cfg.stacking_layers)
        rep.mapped += rep2.mapped
        rep.missing += rep2.missing
        rep.shape_errors += rep2.shape_errors
        return rep
    return conv


def spec(name: str) -> Spec:
    """The :class:`Spec` of a converter model name."""
    if name in ("db_resnet18", "db_resnet50", "db_proxylessnas", "pp_det"):
        from ..models.dbnet.model import DBNet
        from .dbnet_convert import convert_dbnet

        reg = "PP-OCRv4_det" if name == "pp_det" else name
        cfg = build_config("detection", reg)
        if name == "pp_det":
            from .db_pp_convert import convert_db_pp as conv
        elif name == "db_proxylessnas":
            from .dbnas_convert import convert_dbnas as conv
        else:
            def conv(s, v, _d=int(name[-2:])):
                return convert_dbnet(s, v, depth=_d)
        return Spec("detection", reg, "", cfg, P.init_dbnet, DBNet,
                    (1, 64, 64, 3), conv)

    if name in ("pp_rec", "crnn", "convnext_vit", "lightweight_edge"):
        from ..models.rec_ctc.config import RecConfig
        from ..models.rec_ctc.model import CTCRecModel

        if name == "pp_rec":
            from .svtr_convert import convert_svtr_lcnet as conv
            reg, cfg, shape = "PP-OCRv4_rec", build_config(
                "recognition", "PP-OCRv4_rec"), (1, 48, 320, 3)
        elif name == "crnn":
            from .crnn_convert import convert_crnn as conv
            # the reference vocab: 7644 entries (modeling_crnn.py:90)
            reg, cfg, shape = "CRNN", RecConfig.crnn(
                vocab_size=7644, hidden_size=256), (1, 32, 48, 3)
        elif name == "convnext_vit":
            from .convnext_convert import convert_convnext_vit as conv
            reg, cfg, shape = "ConvNextViT", RecConfig.convnext_vit(
                vocab_size=7644), (1, 32, 300, 1)
        else:
            from .lwe_convert import convert_lightweight_edge as conv
            reg, cfg, shape = "LightweightEdge", build_config(
                "recognition", "LightweightEdge", vocab_size=7644), \
                (1, 32, 64, 3)
        return Spec("recognition", reg, "", cfg, P.init_rec, CTCRecModel,
                    shape, conv)

    if name == "slanet":
        from ..models.slanet.model import SLANet
        from .slanet_convert import convert_slanet

        cfg = build_config("table_structure", "SLANet")
        return Spec("table_structure", "SLANet", "", cfg, P.init_slanet,
                    SLANet, (1, cfg.table_max_len, cfg.table_max_len, 3),
                    convert_slanet)

    if name == "picodet":
        from ..models.picodet.model import PicoDet
        from .picodet_convert import convert_picodet

        cfg = build_config("layout", "picodet")

        def conv(s, v, _cfg=cfg):
            return convert_picodet(s, v, num_levels=len(_cfg.strides),
                                   head_convs=_cfg.head_convs)
        return Spec("layout", "picodet", "", cfg, P.init_picodet, PicoDet,
                    (1, 128, 128, 3), conv)

    if name.startswith("pplcnet"):
        from ..models.cls.config import ClsPulcConfig
        from ..models.cls.model import PPLCNetClassifier
        from .pplcnet_convert import convert_pplcnet

        task_type = name.split("_", 1)[1] if "_" in name \
            else "text_image_orientation"
        cfg = ClsPulcConfig.for_task(task_type)
        return Spec("cls", "PPLCNet", task_type, cfg, P.init_cls,
                    PPLCNetClassifier, (1, *cfg.img_size, 3),
                    convert_pplcnet)

    if name.startswith("lore"):
        from ..models.lore.model import LoreModel

        task_type = name.split("_", 1)[1] if "_" in name else "wtw"
        cfg = build_config("table_structure", "Lore", task_type=task_type)
        s = Spec("table_structure", "Lore", task_type, cfg, P.init_lore,
                 LoreModel, (1, *cfg.resolution, 3), None)
        s.convert = _lore_convert(s)
        return s

    if name in ("table_master", "mtl_tabnet"):
        from ..models.table_master.config import TableMasterConfig
        from ..models.table_master.model import TableMaster
        from .master_convert import convert_table_master

        # the PubTabNet structure alphabet + unknown/sos/eos/pad -> 43; the
        # cell textline alphabet -> 281; td tag ids 2='<td></td>', 8='<td'
        kw = dict(cell_vocab_size=281, td_token_ids=(2, 8)) \
            if name == "mtl_tabnet" else {}
        cfg = TableMasterConfig(variant=name, vocab_size=43, **kw)
        reg = "MtlTabNet" if name == "mtl_tabnet" else "TableMaster"

        def conv(s, v, _n=cfg.decoder_layers):
            return convert_table_master(s, v, n_layers=_n)
        return Spec("table_structure", reg, "", cfg, P.init_table_master,
                    TableMaster, (1, *cfg.img_size, 3), conv)

    if name == "docx_layout":
        from ..models.docx_layout.config import DocXLayoutConfig
        from ..models.docx_layout.model import DocXLayoutModel
        from .centernet_convert import convert_docx_layout

        return Spec("layout", "DocXLayout", "", DocXLayoutConfig(),
                    P.init_docx_layout, DocXLayoutModel, (1, 768, 768, 3),
                    convert_docx_layout)

    if name == "cycle_centernet":
        from ..models.center_net.config import CenterNetConfig
        from ..models.center_net.model import CycleCenterNet
        from .centernet_convert import convert_cycle_centernet

        return Spec("table_structure", "CenterNet", "", CenterNetConfig(),
                    P.init_centernet, CycleCenterNet, (1, 1024, 1024, 3),
                    convert_cycle_centernet)

    if name == "lgpma":
        from ..models.lgpma.config import LgpmaConfig
        from ..models.lgpma.model import LGPMA
        from .lgpma_convert import convert_lgpma

        return Spec("table_structure", "Lgpma", "", LgpmaConfig(),
                    P.init_lgpma, LGPMA, (1, 64, 64, 3), convert_lgpma)

    raise SystemExit(f"no converter for {name!r}; see the module docstring")


MODELS = ("db_resnet18", "db_resnet50", "db_proxylessnas", "pp_det",
          "pp_rec", "crnn", "convnext_vit", "lightweight_edge", "slanet",
          "picodet", "pplcnet_text_image_orientation",
          "pplcnet_textline_orientation", "lore_wtw", "lore_wireless",
          "table_master", "mtl_tabnet", "docx_layout", "cycle_centernet",
          "lgpma")


def convert_checkpoint(s: Spec, checkpoint: str,
                       log: Callable[[str], None] = print):
    """(variables, report): the template filled from ``checkpoint``."""
    variables = s.template()
    s.checkpoint = checkpoint
    if checkpoint.endswith(".onnx"):
        from .onnx_reader import read_onnx_initializers
        from .onnx_shape_matcher import (call_ordered_slots,
                                         match_by_shape_with_stats)

        tensors = read_onnx_initializers(checkpoint)
        # Paddle exports serialize initializers in graph order: the slots
        # in the order the module calls them, statistics interleaved
        slots = call_ordered_slots(s.build(s.cfg).eval(),
                                   torch.zeros(s.sample_shape))
        rep = match_by_shape_with_stats(tensors, variables, slots)
        log(f"onnx ordered-shape match: {rep.summary()} "
            f"({len(tensors)} initializers, {len(slots)} slots)")
    else:
        from .torch_to_flax import TorchTensorSource

        src = TorchTensorSource(checkpoint)
        rep = s.convert(src, variables)
        log(f"conversion: {rep.summary()}")
        unused = [u for u in src.unused() if "num_batches" not in u]
        if unused:
            log(f"UNUSED source tensors ({len(unused)}): {unused[:10]}")
    return variables, rep


def copy_sidecars(checkpoint: str, out_dir: str,
                  log: Callable[[str], None] = print) -> List[str]:
    """Copy the dict / keys / alphabet / label txt files beside the
    checkpoint into ``out_dir`` (decode reads them from the weights
    directory first)."""
    copied = []
    src_dir = os.path.dirname(os.path.abspath(checkpoint))
    for pth in sorted(glob.glob(os.path.join(src_dir, "*.txt"))):
        base = os.path.basename(pth).lower()
        if any(k in base for k in ("dict", "keys", "alphabet", "label")):
            shutil.copy(pth, out_dir)
            copied.append(os.path.basename(pth))
            log(f"copied sidecar {os.path.basename(pth)}")
    return copied


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m pdf_table_tpu_torch.convert")
    p.add_argument("--model", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--from-hub", action="store_true", dest="from_hub",
                   help="resolve + download the checkpoint from the hub "
                        "(HF; ModelScope with PDFTABLE_USE_MODELSCOPE_HUB=1)")
    p.add_argument("--variant", default="",
                   help="lang/task_type hub variant (e.g. ch, en, table)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if bool(args.checkpoint) == bool(args.from_hub):
        p.error("pass exactly one of --checkpoint or --from-hub")

    if args.from_hub:
        from .hub import download_snapshot, find_checkpoint, resolve_hub_id

        repo_id = resolve_hub_id(args.model, args.variant)
        print(f"hub: {args.model}"
              + (f"[{args.variant}]" if args.variant else "")
              + f" -> {repo_id}")
        snap = download_snapshot(repo_id)
        args.checkpoint = find_checkpoint(snap)
        print("snapshot:", snap, "-> checkpoint:", args.checkpoint)

    s = spec(args.model)
    variables, rep = convert_checkpoint(s, args.checkpoint)
    if not rep.ok:
        print("MISSING:", rep.missing[:10])
        print("SHAPE:", rep.shape_errors[:10])
        return 1
    out_dir = args.out or s.out_dir
    P.save_params(variables, out_dir)
    print("saved to", out_dir)
    copy_sidecars(args.checkpoint, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
