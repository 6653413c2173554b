"""LGPMA mmcv/mmdet checkpoint -> flax params (a copy of
pdf_table_tpu/convert/lgpma_convert.py: numpy only, the same flax-layout
trees).

Source layout (reference model/table/lgpma: mmcv checkpoint loaded by
checkpoint.py:127 — a dict with 'state_dict' and optional 'module.'
prefixes): torchvision-style ResNet-50 under ``backbone.``, FPN under
``neck.lateral_convs.{i}.conv`` / ``neck.fpn_convs.{i}.conv``, RPN under
``rpn_head.rpn_conv/rpn_cls/rpn_reg``, RoI heads under
``roi_head.bbox_head.shared_fcs.{0,1}/fc_cls/fc_reg`` and
``roi_head.mask_head.convs.{i}.conv/upsample/conv_logits``, global branch
under ``global_seg_head.*`` (gpma_mask_head.py ConvModule -> .conv).

Target: models/lgpma LGPMA flax tree (mmdet-structure rebuild).
"""

from __future__ import annotations

from typing import Any, Dict

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_conv,
                            convert_conv_transpose, convert_dense)


def convert_lgpma(src: TorchTensorSource,
                  variables: Dict[str, Any]) -> ConversionReport:
    """Mutates ``variables`` ({'params', 'batch_stats'}) in place."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    rep = ConversionReport()

    # -- backbone: torchvision resnet50 ------------------------------------
    bb = params["backbone"]
    bs = stats.get("backbone")
    assign_conv_bn(bb, ["stem"], src, "backbone.conv1", "backbone.bn1",
                   rep, bs)
    for i, n in enumerate((3, 4, 6, 3)):
        for j in range(n):
            t = f"backbone.layer{i + 1}.{j}"
            f = f"layer{i + 1}_{j}"
            for k in (1, 2, 3):
                assign_conv_bn(bb, [f, f"conv{k}"], src,
                               f"{t}.conv{k}", f"{t}.bn{k}", rep, bs)
            if f"{t}.downsample.0.weight" in src:
                assign_conv_bn(bb, [f, "down"], src, f"{t}.downsample.0",
                               f"{t}.downsample.1", rep, bs)

    # -- neck: FPN laterals + output convs ----------------------------------
    neck = params["neck"]
    for i in range(4):
        for tname, fname in ((f"neck.lateral_convs.{i}.conv", f"lateral{i}"),
                             (f"neck.fpn_convs.{i}.conv", f"fpn{i}")):
            rep.check_assign(neck, [fname, "kernel"],
                             convert_conv(src.get(f"{tname}.weight")), tname)
            if f"{tname}.bias" in src:
                rep.check_assign(neck, [fname, "bias"],
                                 src.get(f"{tname}.bias"), tname)

    # -- rpn head ------------------------------------------------------------
    rpn = params["rpn_head"]
    for tname, fname in (("rpn_head.rpn_conv", "rpn_conv"),
                         ("rpn_head.rpn_cls", "rpn_cls"),
                         ("rpn_head.rpn_reg", "rpn_reg")):
        rep.check_assign(rpn, [fname, "kernel"],
                         convert_conv(src.get(f"{tname}.weight")), tname)
        rep.check_assign(rpn, [fname, "bias"], src.get(f"{tname}.bias"),
                         tname)

    # -- bbox head -----------------------------------------------------------
    bh = params["bbox_head"]
    for ti, fname in ((0, "fc1"), (1, "fc2")):
        t = f"roi_head.bbox_head.shared_fcs.{ti}"
        rep.check_assign(bh, [fname, "kernel"],
                         convert_dense(src.get(f"{t}.weight")), t)
        rep.check_assign(bh, [fname, "bias"], src.get(f"{t}.bias"), t)
    for tname, fname in (("roi_head.bbox_head.fc_cls", "fc_cls"),
                         ("roi_head.bbox_head.fc_reg", "fc_reg")):
        rep.check_assign(bh, [fname, "kernel"],
                         convert_dense(src.get(f"{tname}.weight")), tname)
        rep.check_assign(bh, [fname, "bias"], src.get(f"{tname}.bias"),
                         tname)

    # -- lpma mask head -------------------------------------------------------
    mh = params["mask_head"]
    for i in range(4):
        t = f"roi_head.mask_head.convs.{i}.conv"
        rep.check_assign(mh, [f"conv{i}", "kernel"],
                         convert_conv(src.get(f"{t}.weight")), t)
        if f"{t}.bias" in src:
            rep.check_assign(mh, [f"conv{i}", "bias"],
                             src.get(f"{t}.bias"), t)
    t = "roi_head.mask_head.upsample"
    rep.check_assign(mh, ["upsample", "kernel"],
                     convert_conv_transpose(src.get(f"{t}.weight")), t)
    rep.check_assign(mh, ["upsample", "bias"], src.get(f"{t}.bias"), t)
    t = "roi_head.mask_head.conv_logits"
    rep.check_assign(mh, ["conv_logits", "kernel"],
                     convert_conv(src.get(f"{t}.weight")), t)
    rep.check_assign(mh, ["conv_logits", "bias"], src.get(f"{t}.bias"), t)

    # -- gpma global head -----------------------------------------------------
    gh = params["global_seg_head"]
    for tname, fname in (("global_seg_head.P4_conv.conv", "P4_conv"),
                         ("global_seg_head.P4_1x7_conv.conv", "P4_1x7_conv"),
                         ("global_seg_head.channel4_1x7_conv.conv",
                          "channel4_1x7_conv"),
                         ("global_seg_head.rpn4.conv", "rpn4"),
                         ("global_seg_head.conv_logits_seg",
                          "conv_logits_seg"),
                         ("global_seg_head.conv_logits_reg",
                          "conv_logits_reg")):
        rep.check_assign(gh, [fname, "kernel"],
                         convert_conv(src.get(f"{tname}.weight")), tname)
        if f"{tname}.bias" in src:
            rep.check_assign(gh, [fname, "bias"], src.get(f"{tname}.bias"),
                             tname)
    return rep
