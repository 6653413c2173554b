"""PicoDet torch checkpoint -> flax params (a copy of
pdf_table_tpu/convert/picodet_convert.py: numpy only, the same flax-layout
trees).

Source layout = the reference torch network (model/picodet/):
  backbone (lcnet.py:159): ``conv1.{conv,bn}``,
    ``blocks{2..6}.{i}.{dw_conv,se,pw_conv}`` (se.conv1/conv2 biased 1x1).
  neck (csp_pan.py:233): ``conv_t.convs.{i}``, ``top_down_blocks.{i}`` /
    ``bottom_up_blocks.{i}`` CSPLayers (``main_conv``/``short_conv``/
    ``final_conv`` ConvBNLayers + ``blocks.{j}`` DarknetBottleneck with
    ``conv1`` ConvBNLayer and ``conv2`` DPModule {dwconv,bn1,pwconv,bn2}),
    ``downsamples.{i}`` DPModules, ``first_top_conv``/``second_top_conv``.
  head (pico_head.py:966 share_cls_reg=True): ``conv_feat.cls_conv_dw{s}_{i}``
    / ``cls_conv_pw{s}_{i}`` ConvNormLayers {conv,norm}, ``head_cls{s}``
    biased 1x1.

Flax tree: models/picodet/model.py (same structure, NHWC).
"""

from __future__ import annotations

from typing import Any, Dict, List

from .pplcnet_convert import _STAGE_SIZES
from .torch_to_flax import ConversionReport, TorchTensorSource, convert_conv


def _conv_bn(tree: Dict, stats: Dict, src: TorchTensorSource,
             fpath: List[str], tconv: str, tbn: str,
             rep: ConversionReport) -> None:
    w = convert_conv(src.get(f"{tconv}.weight"))
    rep.check_assign(tree, fpath + ["conv", "kernel"], w, tconv)
    if f"{tconv}.bias" in src:
        rep.check_assign(tree, fpath + ["conv", "bias"],
                         src.get(f"{tconv}.bias"), tconv)
    rep.check_assign(tree, fpath + ["bn", "scale"],
                     src.get(f"{tbn}.weight"), tbn)
    rep.check_assign(tree, fpath + ["bn", "bias"], src.get(f"{tbn}.bias"), tbn)
    rep.check_assign(stats, fpath + ["bn", "mean"],
                     src.get(f"{tbn}.running_mean"), tbn)
    rep.check_assign(stats, fpath + ["bn", "var"],
                     src.get(f"{tbn}.running_var"), tbn)


def _dp_module(tree: Dict, stats: Dict, src: TorchTensorSource,
               fname: List[str], tprefix: str, rep: ConversionReport) -> None:
    _conv_bn(tree, stats, src, fname + ["dw"], f"{tprefix}.dwconv",
             f"{tprefix}.bn1", rep)
    _conv_bn(tree, stats, src, fname + ["pw"], f"{tprefix}.pwconv",
             f"{tprefix}.bn2", rep)


def _csp_layer(tree: Dict, stats: Dict, src: TorchTensorSource,
               fname: str, tprefix: str, rep: ConversionReport,
               num_blocks: int = 1) -> None:
    for part in ("main_conv", "short_conv", "final_conv"):
        _conv_bn(tree, stats, src, [fname, part], f"{tprefix}.{part}.conv",
                 f"{tprefix}.{part}.bn", rep)
    for j in range(num_blocks):
        _conv_bn(tree, stats, src, [fname, f"block{j}", "conv1"],
                 f"{tprefix}.blocks.{j}.conv1.conv",
                 f"{tprefix}.blocks.{j}.conv1.bn", rep)
        _dp_module(tree, stats, src, [fname, f"block{j}", "conv2"],
                   f"{tprefix}.blocks.{j}.conv2", rep)


def convert_picodet(src: TorchTensorSource, variables: Dict[str, Any],
                    num_levels: int = 4, head_convs: int = 4,
                    ) -> ConversionReport:
    """Mutates ``variables`` (params + batch_stats) in place."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    rep = ConversionReport()

    # --- backbone (LCNet) ---
    bb, bs = params["backbone"], stats.get("backbone", {})
    _conv_bn(bb, bs, src, ["conv1"], "backbone.conv1.conv",
             "backbone.conv1.bn", rep)
    for stage, n in _STAGE_SIZES.items():
        for i in range(n):
            t = f"backbone.blocks{stage}.{i}"
            f = f"blocks{stage}_{i}"
            _conv_bn(bb, bs, src, [f, "dw"], f"{t}.dw_conv.conv",
                     f"{t}.dw_conv.bn", rep)
            if stage == 6:
                for fl, tl in (("se_fc1", "conv1"), ("se_fc2", "conv2")):
                    w = convert_conv(src.get(f"{t}.se.{tl}.weight"))
                    rep.check_assign(bb, [f, fl, "kernel"], w, f"{t}.se.{tl}")
                    rep.check_assign(bb, [f, fl, "bias"],
                                     src.get(f"{t}.se.{tl}.bias"),
                                     f"{t}.se.{tl}")
            _conv_bn(bb, bs, src, [f, "pw"], f"{t}.pw_conv.conv",
                     f"{t}.pw_conv.bn", rep)

    # --- neck (CSPPAN) ---
    nk, ns = params["neck"], stats.get("neck", {})
    for i in range(3):
        _conv_bn(nk, ns, src, [f"conv_t{i}"], f"neck.conv_t.convs.{i}.conv",
                 f"neck.conv_t.convs.{i}.bn", rep)
    for i in range(2):
        _csp_layer(nk, ns, src, f"top_down{i}", f"neck.top_down_blocks.{i}",
                   rep)
        _dp_module(nk, ns, src, [f"downsample{i}"], f"neck.downsamples.{i}",
                   rep)
        _csp_layer(nk, ns, src, f"bottom_up{i}", f"neck.bottom_up_blocks.{i}",
                   rep)
    if num_levels == 4:
        _dp_module(nk, ns, src, ["first_top_conv"], "neck.first_top_conv",
                   rep)
        _dp_module(nk, ns, src, ["second_top_conv"], "neck.second_top_conv",
                   rep)

    # --- head ---
    hd, hs = params["head"], stats.get("head", {})
    for s in range(num_levels):
        for i in range(head_convs):
            for kind in ("dw", "pw"):
                t = f"head.conv_feat.cls_conv_{kind}{s}_{i}"
                _conv_bn(hd, hs, src, [f"cls_conv_{kind}{s}_{i}"],
                         f"{t}.conv", f"{t}.norm", rep)
        w = convert_conv(src.get(f"head.head_cls{s}.weight"))
        rep.check_assign(hd, [f"head_cls{s}", "kernel"], w,
                         f"head.head_cls{s}")
        rep.check_assign(hd, [f"head_cls{s}", "bias"],
                         src.get(f"head.head_cls{s}.bias"),
                         f"head.head_cls{s}")
    return rep
