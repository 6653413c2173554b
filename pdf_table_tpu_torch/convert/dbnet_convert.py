"""DBNet (ModelScope resnet18/50) torch checkpoint -> flax params (a copy of
pdf_table_tpu/convert/dbnet_convert.py: numpy only, the same flax-layout
trees).

Source layout (reference model/db_net/dbnet.py DBModel:715): torchvision
ResNet names under ``backbone.`` (conv1/bn1/layer{1-4}.{j}.conv{1,2}/
bn{1,2}/downsample.{0,1}) and SegDetector under ``decoder.`` (in2..in5 1x1
convs, out2..out5 3x3 convs, binarize = [conv, bn, relu, deconv, bn, relu,
deconv, sigmoid] indices 0/1/3/4/6).

Target: models/dbnet DBNet(backbone=resnetN) flax tree:
backbone: stem{conv,bn}, layer{i}_{j}: conv1/conv2/down (ConvBNAct);
neck(FPN): in2..in5, out2..out5 (nn.Conv); binarize: conv{conv,bn}, up1,
bn1, up2.
"""

from __future__ import annotations

from typing import Any, Dict

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_conv,
                            convert_conv_transpose)


def convert_dbnet(src: TorchTensorSource, variables: Dict[str, Any],
                  depth: int = 18) -> ConversionReport:
    """Mutates ``variables`` ({'params', 'batch_stats'}) in place; returns
    the per-layer report."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    rep = ConversionReport()

    # -- backbone -------------------------------------------------------------
    assign_conv_bn(params["backbone"], ["stem"], src,
                   "backbone.conv1", "backbone.bn1", rep,
                   stats.get("backbone"))
    layers = (2, 2, 2, 2) if depth == 18 else (3, 4, 6, 3)
    for i, n in enumerate(layers):
        for j in range(n):
            t = f"backbone.layer{i + 1}.{j}"
            f = f"layer{i + 1}_{j}"
            assign_conv_bn(params["backbone"], [f, "conv1"], src,
                           f"{t}.conv1", f"{t}.bn1", rep,
                           stats.get("backbone"))
            assign_conv_bn(params["backbone"], [f, "conv2"], src,
                           f"{t}.conv2", f"{t}.bn2", rep,
                           stats.get("backbone"))
            if f"{t}.downsample.0.weight" in src:
                assign_conv_bn(params["backbone"], [f, "down"], src,
                               f"{t}.downsample.0", f"{t}.downsample.1", rep,
                               stats.get("backbone"))

    # -- neck (SegDetector laterals/outs) --------------------------------------
    for lvl in (2, 3, 4, 5):
        rep.check_assign(params["neck"], [f"in{lvl}", "kernel"],
                         convert_conv(src.get(f"decoder.in{lvl}.weight")),
                         f"decoder.in{lvl}")
        # out5..out3 are Sequential(conv, upsample) -> .0; out2 is bare conv
        tname = f"decoder.out{lvl}.0" if lvl > 2 else "decoder.out2"
        rep.check_assign(params["neck"], [f"out{lvl}", "kernel"],
                         convert_conv(src.get(f"{tname}.weight")),
                         tname)

    # -- binarize head ----------------------------------------------------------
    b = params["binarize"]
    bs = stats.get("binarize", {})
    assign_conv_bn(b, ["conv"], src, "decoder.binarize.0",
                   "decoder.binarize.1", rep, bs)
    rep.check_assign(b, ["up1", "kernel"],
                     convert_conv_transpose(
                         src.get("decoder.binarize.3.weight")).copy(),
                     "decoder.binarize.3")
    if "decoder.binarize.3.bias" in src:
        rep.check_assign(b, ["up1", "bias"],
                         src.get("decoder.binarize.3.bias"),
                         "decoder.binarize.3")
    for fl, tn in (("scale", "weight"), ("bias", "bias")):
        rep.check_assign(b, ["bn1", fl],
                         src.get(f"decoder.binarize.4.{tn}"),
                         "decoder.binarize.4")
    for fl, tn in (("mean", "running_mean"), ("var", "running_var")):
        rep.check_assign(bs, ["bn1", fl],
                         src.get(f"decoder.binarize.4.{tn}"),
                         "decoder.binarize.4")
    rep.check_assign(b, ["up2", "kernel"],
                     convert_conv_transpose(
                         src.get("decoder.binarize.6.weight")).copy(),
                     "decoder.binarize.6")
    if "decoder.binarize.6.bias" in src:
        rep.check_assign(b, ["up2", "bias"],
                         src.get("decoder.binarize.6.bias"),
                         "decoder.binarize.6")
    return rep
