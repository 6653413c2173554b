"""PP-OCR DB detector (MobileNetV3 + RSE-FPN + DB head) -> flax params (a copy
of pdf_table_tpu/convert/db_pp_convert.py: numpy only, the same flax-layout
trees).

The reference runs this as a PaddleOCR ONNX graph
(model/db_pp/processor_ocr_db_pp.py; registry `db_pp` rows). Source names
follow the PaddleOCR module tree (det_mobilenet_v3 / db_fpn / det_db_head),
i.e. what a paddle->torch state-dict port produces:

  backbone.conv.{conv,bn}                      stem
  backbone.stages.{s}.{j}.{expand_conv,bottleneck_conv,linear_conv}.{conv,bn}
      stage split at stride-2 blocks: s0=blocks0-2, s1=3-5, s2=6-11,
      s3=12-14 (+ trailing 1x1 ConvBNLayer ``stages.3.3.{conv,bn}``);
      SE absent (PP-OCRv3 det student: disable_se=True)
  neck.ins_conv.{i}.{in_conv, se_block.conv1, se_block.conv2}   RSE 1x1
  neck.inp_conv.{i}.{...}                                       RSE 3x3
  head.binarize.{conv1, conv_bn1, conv2, conv_bn2, conv3}
  head.thresh.{...}                    (train checkpoints only; optional)

Flax tree: models/dbnet DBNet(config=DbNetConfig.ppocr()).
"""

from __future__ import annotations

from typing import Any, Dict, List

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_conv,
                            convert_conv_transpose)

# flax block index -> (stage, index-in-stage); 15 inverted residuals
_STAGE_OF = ([(0, j) for j in range(3)] + [(1, j) for j in range(3)]
             + [(2, j) for j in range(6)] + [(3, j) for j in range(3)])


def _rse_layer(tree: Dict, src: TorchTensorSource, fname: str, tprefix: str,
               rep: ConversionReport) -> None:
    rep.check_assign(tree, [fname, "conv", "kernel"],
                     convert_conv(src.get(f"{tprefix}.in_conv.weight")),
                     f"{tprefix}.in_conv")
    for fl, tl in (("fc1", "conv1"), ("fc2", "conv2")):
        rep.check_assign(tree, [fname, "se", fl, "kernel"],
                         convert_conv(src.get(f"{tprefix}.se_block.{tl}.weight")),
                         f"{tprefix}.se_block.{tl}")
        rep.check_assign(tree, [fname, "se", fl, "bias"],
                         src.get(f"{tprefix}.se_block.{tl}.bias"),
                         f"{tprefix}.se_block.{tl}")


def _db_head(tree: Dict, stats: Dict, src: TorchTensorSource, tprefix: str,
             rep: ConversionReport) -> None:
    assign_conv_bn(tree, ["conv"], src, f"{tprefix}.conv1",
                   f"{tprefix}.conv_bn1", rep, stats)
    for fl, tl, bn in (("up1", "conv2", "conv_bn2"), ("up2", "conv3", None)):
        rep.check_assign(tree, [fl, "kernel"],
                         convert_conv_transpose(
                             src.get(f"{tprefix}.{tl}.weight")).copy(),
                         f"{tprefix}.{tl}")
        rep.check_assign(tree, [fl, "bias"], src.get(f"{tprefix}.{tl}.bias"),
                         f"{tprefix}.{tl}")
        if bn is not None:
            rep.check_assign(tree, ["bn1", "scale"],
                             src.get(f"{tprefix}.{bn}.weight"), bn)
            rep.check_assign(tree, ["bn1", "bias"],
                             src.get(f"{tprefix}.{bn}.bias"), bn)
            rep.check_assign(stats, ["bn1", "mean"],
                             src.get(f"{tprefix}.{bn}.running_mean"), bn)
            rep.check_assign(stats, ["bn1", "var"],
                             src.get(f"{tprefix}.{bn}.running_var"), bn)


def convert_db_pp(src: TorchTensorSource, variables: Dict[str, Any],
                  ) -> ConversionReport:
    """Mutates ``variables`` (params + batch_stats) in place."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    rep = ConversionReport()

    bb, bs = params["backbone"], stats.get("backbone", {})
    assign_conv_bn(bb, ["stem"], src, "backbone.conv.conv",
                   "backbone.conv.bn", rep, bs)
    for i, (s, j) in enumerate(_STAGE_OF):
        t = f"backbone.stages.{s}.{j}"
        for fl, tl in (("expand", "expand_conv"), ("dw", "bottleneck_conv"),
                       ("project", "linear_conv")):
            assign_conv_bn(bb, [f"block{i}", fl], src, f"{t}.{tl}.conv",
                           f"{t}.{tl}.bn", rep, bs)
    assign_conv_bn(bb, ["last_conv"], src, "backbone.stages.3.3.conv",
                   "backbone.stages.3.3.bn", rep, bs)

    nk = params["neck"]
    for i, lvl in enumerate((2, 3, 4, 5)):
        _rse_layer(nk, src, f"in{lvl}", f"neck.ins_conv.{i}", rep)
        _rse_layer(nk, src, f"out{lvl}", f"neck.inp_conv.{i}", rep)

    _db_head(params["binarize"], stats.get("binarize", {}), src,
             "head.binarize", rep)
    if "thresh" in params and "head.thresh.conv1.weight" in src:
        _db_head(params["thresh"], stats.get("thresh", {}), src,
                 "head.thresh", rep)
    return rep
