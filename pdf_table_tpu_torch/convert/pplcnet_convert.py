"""PP-LCNet (PULC classifier) torch checkpoint -> flax params (a copy of
pdf_table_tpu/convert/pplcnet_convert.py: numpy only, the same flax-layout
trees).

The reference runs PULC classifiers as torch PPLCNet
(model/ocr_pdf/cls_image_pulc_task.py:31 ``_predictor_type="pytorch"``;
network model/cls/cls_pp_lcnet.py:164). Source module names:
``conv1.{conv,bn}``, ``blocks{2..6}.{i}.{dw_conv,se,pw_conv}`` with
``se.{conv1,conv2}`` biased 1x1 convs, ``last_conv`` (bias-free 1x1) and
``fc``. Flax tree (models/cls/model.py): ``stem``, ``blocks{b}_{l}``
(``dw``/``se``/``pw``), ``last_conv``, ``fc``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_conv, convert_dense)

# (kernel, in_c, out_c, stride, se) per block — reference
# cls_pp_lcnet.py NET_CONFIG (:55-66); only counts per stage matter here.
_STAGE_SIZES = {2: 1, 3: 2, 4: 2, 5: 6, 6: 2}


def _se_paths(stage: int, i: int) -> bool:
    return stage == 6  # blocks6 blocks use SE in PPLCNet


def assign_depthwise_separable(tree: Dict, stats: Dict, src: TorchTensorSource,
                               flax_name: str, torch_prefix: str,
                               rep: ConversionReport,
                               has_se: bool = False) -> None:
    """Map one reference DepthwiseSeparable (dw_conv [+se] pw_conv) onto the
    flax DepthwiseSeparable subtree {dw, se?, pw}."""
    assign_conv_bn(tree, [flax_name, "dw"], src, f"{torch_prefix}.dw_conv.conv",
                   f"{torch_prefix}.dw_conv.bn", rep, stats)
    if has_se:
        for fl, tl in (("fc1", "conv1"), ("fc2", "conv2")):
            w = convert_conv(src.get(f"{torch_prefix}.se.{tl}.weight"))
            rep.check_assign(tree, [flax_name, "se", fl, "kernel"], w,
                             f"{torch_prefix}.se.{tl}")
            rep.check_assign(tree, [flax_name, "se", fl, "bias"],
                             src.get(f"{torch_prefix}.se.{tl}.bias"),
                             f"{torch_prefix}.se.{tl}")
    assign_conv_bn(tree, [flax_name, "pw"], src, f"{torch_prefix}.pw_conv.conv",
                   f"{torch_prefix}.pw_conv.bn", rep, stats)


def convert_pplcnet(src: TorchTensorSource, variables: Dict[str, Any],
                    ) -> ConversionReport:
    """Mutates ``variables`` (params + batch_stats) in place."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    rep = ConversionReport()

    assign_conv_bn(params, ["stem"], src, "conv1.conv", "conv1.bn", rep, stats)
    for stage, n in _STAGE_SIZES.items():
        for i in range(n):
            assign_depthwise_separable(
                params, stats, src, f"blocks{stage}_{i}",
                f"blocks{stage}.{i}", rep, has_se=_se_paths(stage, i))
    if "last_conv" in params:
        rep.check_assign(params, ["last_conv", "kernel"],
                         convert_conv(src.get("last_conv.weight")),
                         "last_conv")
    rep.check_assign(params, ["fc", "kernel"],
                     convert_dense(src.get("fc.weight")), "fc")
    rep.check_assign(params, ["fc", "bias"], src.get("fc.bias"), "fc")
    return rep
