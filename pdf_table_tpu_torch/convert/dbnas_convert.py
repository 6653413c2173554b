"""DBNas (proxylessNAS detector) torch checkpoint -> flax (a copy of
pdf_table_tpu/convert/dbnas_convert.py: numpy only, the same flax-layout
trees).

Source layout (reference DBNasModel, model/db_net/dbnet.py:693-713 +
proxyless.py CompactDetBackbone): ``backbone.first_conv.{0,1}`` (conv/bn +
parameterless ReLU), ``backbone.blocks.{i}.mobile_inverted_conv.*``
following the searched conv_op_ids plan (DBNAS_PLAN), and the
LightSegDetector decoder: ``decoder.in{2..5}`` 1x1 laterals,
``decoder.binarize.{0,1,3,4,6}`` (DwPwConv / BN / DwPwConvTranspose x2)
and ``decoder.thresh.{0,1,3,4,6}`` (conv / BN / ConvTranspose x2).

Target: models/dbnet DBNet(backbone='proxylessnas').
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..models.dbnet.model import DBNAS_PLAN
from .lwe_convert import convert_nas_blocks
from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            convert_conv, convert_conv_transpose)


def _dwpw(params: Dict, stats: Dict, path: list, src, t: str,
          rep: ConversionReport) -> None:
    """torch DwPwConv {depthwise, bn1, pointwise} -> flax DwPwConv."""
    rep.check_assign(params, path + ["depthwise", "kernel"],
                     convert_conv(src.get(f"{t}.depthwise.weight")),
                     f"{t}.depthwise")
    if f"{t}.depthwise.bias" in src:
        rep.check_assign(params, path + ["depthwise", "bias"],
                         src.get(f"{t}.depthwise.bias"), f"{t}.depthwise")
    for leaf, tn in (("scale", "weight"), ("bias", "bias")):
        rep.check_assign(params, path + ["bn1", leaf],
                         src.get(f"{t}.bn1.{tn}"), f"{t}.bn1")
    rep.check_assign(stats, path + ["bn1", "mean"],
                     src.get(f"{t}.bn1.running_mean"), f"{t}.bn1")
    rep.check_assign(stats, path + ["bn1", "var"],
                     src.get(f"{t}.bn1.running_var"), f"{t}.bn1")
    rep.check_assign(params, path + ["pointwise", "kernel"],
                     convert_conv(src.get(f"{t}.pointwise.weight")),
                     f"{t}.pointwise")
    if f"{t}.pointwise.bias" in src:
        rep.check_assign(params, path + ["pointwise", "bias"],
                         src.get(f"{t}.pointwise.bias"), f"{t}.pointwise")


def _dwpw_t(params: Dict, stats: Dict, path: list, src, t: str,
            rep: ConversionReport) -> None:
    """torch DwPwConvTranspose -> flax DwPwConvTranspose: the grouped
    deconv weight (C, 1, 2, 2) becomes the per-channel (2, 2, C) kernel."""
    w = src.get(f"{t}.depthwise.weight")          # (C, 1, 2, 2)
    rep.check_assign(params, path + ["depthwise_kernel"],
                     np.transpose(w[:, 0], (1, 2, 0)), f"{t}.depthwise")
    rep.check_assign(params, path + ["depthwise_bias"],
                     src.get(f"{t}.depthwise.bias"), f"{t}.depthwise")
    for leaf, tn in (("scale", "weight"), ("bias", "bias")):
        rep.check_assign(params, path + ["bn1", leaf],
                         src.get(f"{t}.bn1.{tn}"), f"{t}.bn1")
    rep.check_assign(stats, path + ["bn1", "mean"],
                     src.get(f"{t}.bn1.running_mean"), f"{t}.bn1")
    rep.check_assign(stats, path + ["bn1", "var"],
                     src.get(f"{t}.bn1.running_var"), f"{t}.bn1")
    rep.check_assign(params, path + ["pointwise", "kernel"],
                     convert_conv(src.get(f"{t}.pointwise.weight")),
                     f"{t}.pointwise")
    rep.check_assign(params, path + ["pointwise", "bias"],
                     src.get(f"{t}.pointwise.bias"), f"{t}.pointwise")


def _bn(params: Dict, stats: Dict, path: list, src, t: str,
        rep: ConversionReport) -> None:
    rep.check_assign(params, path + ["scale"], src.get(f"{t}.weight"), t)
    rep.check_assign(params, path + ["bias"], src.get(f"{t}.bias"), t)
    rep.check_assign(stats, path + ["mean"], src.get(f"{t}.running_mean"), t)
    rep.check_assign(stats, path + ["var"], src.get(f"{t}.running_var"), t)


def convert_dbnas(src: TorchTensorSource,
                  variables: Dict[str, Any]) -> ConversionReport:
    """Mutates ``variables`` in place; returns the per-layer report."""
    rep = ConversionReport()
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    bb, bs = params["backbone"], stats.get("backbone", {})

    t = "backbone.first_conv"
    rep.check_assign(bb, ["first_conv", "conv", "kernel"],
                     convert_conv(src.get(f"{t}.0.weight")), f"{t}.0")
    _bn(bb["first_conv"], bs.get("first_conv", {}), ["bn"], src, f"{t}.1",
        rep)

    convert_nas_blocks(src, bb, bs, DBNAS_PLAN, "backbone.blocks", rep)

    # decoder laterals
    for lvl in (2, 3, 4, 5):
        rep.check_assign(params["neck"], [f"in{lvl}", "kernel"],
                         convert_conv(src.get(f"decoder.in{lvl}.weight")),
                         f"decoder.in{lvl}")

    # binarize head: [DwPwConv, BN, ReLU, DwPwConvT, BN, ReLU, DwPwConvT]
    bh, bhs = params["binarize"], stats.get("binarize", {})
    _dwpw(bh, bhs, ["dwpw"], src, "decoder.binarize.0", rep)
    _bn(bh, bhs, ["bn_a"], src, "decoder.binarize.1", rep)
    _dwpw_t(bh, bhs, ["up1"], src, "decoder.binarize.3", rep)
    _bn(bh, bhs, ["bn_b"], src, "decoder.binarize.4", rep)
    _dwpw_t(bh, bhs, ["up2"], src, "decoder.binarize.6", rep)

    # thresh head: [Conv, BN, ReLU, ConvT, BN, ReLU, ConvT]
    if "decoder.thresh.0.weight" in src and "thresh" in params:
        th, ths = params["thresh"], stats.get("thresh", {})
        rep.check_assign(th, ["conv", "kernel"],
                         convert_conv(src.get("decoder.thresh.0.weight")),
                         "decoder.thresh.0")
        _bn(th, ths, ["bn_a"], src, "decoder.thresh.1", rep)
        for idx, name in ((3, "up1"), (6, "up2")):
            t = f"decoder.thresh.{idx}"
            rep.check_assign(th, [name, "kernel"],
                             convert_conv_transpose(src.get(f"{t}.weight")),
                             t)
            rep.check_assign(th, [name, "bias"], src.get(f"{t}.bias"), t)
    return rep
