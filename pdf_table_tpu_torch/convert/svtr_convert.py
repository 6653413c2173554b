"""PP-OCRv3 rec (SVTR-LCNet) torch checkpoint -> flax params (a copy of
pdf_table_tpu/convert/svtr_convert.py: numpy only, the same flax-layout
trees).

The reference runs this model as a PaddleOCR ONNX export
(model/ocr_rec_pp/). Source names follow the PaddleOCR module tree as a
torch port produces it (rec_mv1_enhance MobileNetV1Enhance + rnn.py
EncoderWithSVTR + CTCHead):

  backbone.conv1.{conv,bn}
  backbone.blocks.{i}.{dw,se,pw}.{conv,bn}   (se = biased conv1/conv2)
  neck.conv1/conv2/conv3/conv4/conv1x1.{conv,bn}
  neck.svtr_block.{i}.{norm1,qkv,proj,norm2,fc1,fc2}
  neck.norm                                   (final LayerNorm)
  head.fc                                     (CTC projection)

Flax tree: models/rec_ctc CTCRecModel(backbone="svtr_lcnet") — backbone
submodule names conv1/block{i}/svtr_* (model.py SVTRLCNetBackbone),
ctc_head Dense.
"""

from __future__ import annotations

from typing import Any, Dict

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_conv, convert_dense)


def _ln(tree: Dict, src: TorchTensorSource, fpath, tprefix: str,
        rep: ConversionReport) -> None:
    rep.check_assign(tree, fpath + ["scale"], src.get(f"{tprefix}.weight"),
                     tprefix)
    rep.check_assign(tree, fpath + ["bias"], src.get(f"{tprefix}.bias"),
                     tprefix)


def _dense(tree: Dict, src: TorchTensorSource, fpath, tprefix: str,
           rep: ConversionReport) -> None:
    rep.check_assign(tree, fpath + ["kernel"],
                     convert_dense(src.get(f"{tprefix}.weight")), tprefix)
    if f"{tprefix}.bias" in src:
        rep.check_assign(tree, fpath + ["bias"], src.get(f"{tprefix}.bias"),
                         tprefix)


def convert_svtr_lcnet(src: TorchTensorSource, variables: Dict[str, Any],
                       depth: int = 2) -> ConversionReport:
    """Mutates ``variables`` (params + batch_stats) in place."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    rep = ConversionReport()

    bb, bs = params["backbone"], stats.get("backbone", {})
    assign_conv_bn(bb, ["conv1"], src, "backbone.conv1.conv",
                   "backbone.conv1.bn", rep, bs)
    n_blocks = sum(1 for k in bb if k.startswith("block"))
    for i in range(n_blocks):
        has_se = f"backbone.blocks.{i}.se.conv1.weight" in src
        # flax DepthwiseSeparable subtree {dw, se?, pw} under block{i};
        # reference names dw_conv/se/pw_conv -> mirror uses dw/se/pw
        t = f"backbone.blocks.{i}"
        assign_conv_bn(bb, [f"block{i}", "dw"], src, f"{t}.dw.conv",
                       f"{t}.dw.bn", rep, bs)
        if has_se:
            for fl, tl in (("fc1", "conv1"), ("fc2", "conv2")):
                rep.check_assign(bb, [f"block{i}", "se", fl, "kernel"],
                                 convert_conv(src.get(f"{t}.se.{tl}.weight")),
                                 f"{t}.se.{tl}")
                rep.check_assign(bb, [f"block{i}", "se", fl, "bias"],
                                 src.get(f"{t}.se.{tl}.bias"), f"{t}.se.{tl}")
        assign_conv_bn(bb, [f"block{i}", "pw"], src, f"{t}.pw.conv",
                       f"{t}.pw.bn", rep, bs)

    for fl, tl in (("svtr_conv1", "conv1"), ("svtr_conv2", "conv2"),
                   ("svtr_conv3", "conv3"), ("svtr_conv4", "conv4"),
                   ("svtr_conv1x1", "conv1x1")):
        assign_conv_bn(bb, [fl], src, f"neck.{tl}.conv", f"neck.{tl}.bn",
                       rep, bs)
    for i in range(depth):
        blk = f"neck.svtr_block.{i}"
        fb = f"svtr_block{i}"
        _ln(bb, src, [fb, "norm1"], f"{blk}.norm1", rep)
        _dense(bb, src, [fb, "qkv"], f"{blk}.qkv", rep)
        _dense(bb, src, [fb, "proj"], f"{blk}.proj", rep)
        _ln(bb, src, [fb, "norm2"], f"{blk}.norm2", rep)
        _dense(bb, src, [fb, "fc1"], f"{blk}.fc1", rep)
        _dense(bb, src, [fb, "fc2"], f"{blk}.fc2", rep)
    _ln(bb, src, ["svtr_norm"], "neck.norm", rep)

    # CTC projection
    rep.check_assign(params, ["ctc_head", "kernel"],
                     convert_dense(src.get("head.fc.weight")), "head.fc")
    rep.check_assign(params, ["ctc_head", "bias"], src.get("head.fc.bias"),
                     "head.fc")
    return rep
