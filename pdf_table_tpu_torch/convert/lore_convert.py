"""LORE torch checkpoint -> flax params (a copy of
pdf_table_tpu/convert/lore_convert.py: numpy only, the same flax-layout
trees).

Source layouts (reference modeling_lore.py:98-118): either a combined
``pytorch_model.pt`` with 'model' (detector) + 'processor' keys, or the
pair model_best.pth / processor_best.pth. Detector names follow DLASeg
(lore_dla_34.py:140): ``base.*`` DLA-34 (base_layer/level0..5 with
tree1, tree2, root, project), ``dla_up.ida_{i}.*`` / ``ida_up.*`` DeformConv
(conv.weight, conv.conv_offset_mask, actf.0 bn) + grouped-deconv ``up_{k}``,
and per-head Sequentials ``hm.0/hm.2`` etc. Processor names follow
LoreProcessModel (lore_processor.py:399).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_conv, convert_dense)

DLA34_LEVELS = {"level2": 1, "level3": 2, "level4": 2, "level5": 1}


def _assign_dense(tree, path, src, tname, rep, transpose=True):
    w = src.get(f"{tname}.weight")
    rep.check_assign(tree, path + ["kernel"],
                     convert_dense(w) if transpose else w, tname)
    if f"{tname}.bias" in src:
        rep.check_assign(tree, path + ["bias"], src.get(f"{tname}.bias"),
                         tname)


def _assign_block(tree, stats, fpath, src, tprefix, rep):
    """DlaBasicBlock: conv1/bn1/conv2/bn2."""
    assign_conv_bn(tree, fpath + ["conv1"], src, f"{tprefix}.conv1",
                   f"{tprefix}.bn1", rep, stats)
    assign_conv_bn(tree, fpath + ["conv2"], src, f"{tprefix}.conv2",
                   f"{tprefix}.bn2", rep, stats)


def _assign_tree(tree, stats, fpath, src, tprefix, levels, rep):
    if f"{tprefix}.project.0.weight" in src:
        assign_conv_bn(tree, fpath + ["project"], src,
                       f"{tprefix}.project.0", f"{tprefix}.project.1", rep,
                       stats)
    if levels == 1:
        _assign_block(tree, stats, fpath + ["tree1"], src,
                      f"{tprefix}.tree1", rep)
        _assign_block(tree, stats, fpath + ["tree2"], src,
                      f"{tprefix}.tree2", rep)
        # root conv has its own naming (root.conv / root.bn)
        rep.check_assign(tree, fpath + ["root", "conv", "kernel"],
                         convert_conv(src.get(f"{tprefix}.root.conv.weight")),
                         f"{tprefix}.root.conv")
        for fl, tn in (("scale", "weight"), ("bias", "bias")):
            rep.check_assign(tree, fpath + ["root", "bn", fl],
                             src.get(f"{tprefix}.root.bn.{tn}"),
                             f"{tprefix}.root.bn")
        if stats is not None:
            for fl, tn in (("mean", "running_mean"), ("var", "running_var")):
                rep.check_assign(stats, fpath + ["root", "bn", fl],
                                 src.get(f"{tprefix}.root.bn.{tn}"),
                                 f"{tprefix}.root.bn")
    else:
        _assign_tree(tree, stats, fpath + ["tree1"], src,
                     f"{tprefix}.tree1", levels - 1, rep)
        _assign_tree(tree, stats, fpath + ["tree2"], src,
                     f"{tprefix}.tree2", levels - 1, rep)


def _assign_deform(tree, stats, fpath, src, tprefix, rep):
    """DeformConvBlock: conv_offset_mask, weight/bias (DCN), bn
    (torch: conv.conv_offset_mask, conv.weight/bias, actf.0)."""
    rep.check_assign(tree, fpath + ["conv_offset_mask", "kernel"],
                     convert_conv(src.get(
                         f"{tprefix}.conv.conv_offset_mask.weight")),
                     f"{tprefix}.conv.conv_offset_mask")
    rep.check_assign(tree, fpath + ["conv_offset_mask", "bias"],
                     src.get(f"{tprefix}.conv.conv_offset_mask.bias"),
                     f"{tprefix}.conv.conv_offset_mask")
    rep.check_assign(tree, fpath + ["weight"],
                     convert_conv(src.get(f"{tprefix}.conv.weight")),
                     f"{tprefix}.conv")
    rep.check_assign(tree, fpath + ["bias"],
                     src.get(f"{tprefix}.conv.bias"), f"{tprefix}.conv")
    for fl, tn in (("scale", "weight"), ("bias", "bias")):
        rep.check_assign(tree, fpath + ["bn", fl],
                         src.get(f"{tprefix}.actf.0.{tn}"),
                         f"{tprefix}.actf.0")
    if stats is not None:
        for fl, tn in (("mean", "running_mean"), ("var", "running_var")):
            rep.check_assign(stats, fpath + ["bn", fl],
                             src.get(f"{tprefix}.actf.0.{tn}"),
                             f"{tprefix}.actf.0")


def _assign_up(tree, fpath, src, tname, rep):
    """Grouped deconv (C, 1, k, k) -> DepthwiseUpsample (k, k, 1, C)."""
    w = src.get(f"{tname}.weight")
    rep.check_assign(tree, fpath + ["kernel"],
                     np.transpose(w[:, 0], (1, 2, 0))[:, :, None, :],
                     tname)


def _assign_ida(tree, stats, fpath, src, tprefix, n_proj, rep):
    for k in range(1, n_proj + 1):
        _assign_deform(tree, stats, fpath + [f"proj_{k}"], src,
                       f"{tprefix}.proj_{k}", rep)
        _assign_deform(tree, stats, fpath + [f"node_{k}"], src,
                       f"{tprefix}.node_{k}", rep)
        _assign_up(tree, fpath + [f"up_{k}"], src, f"{tprefix}.up_{k}", rep)


def convert_lore_detector(src: TorchTensorSource, variables: Dict[str, Any],
                          hidden_size: int = 256) -> ConversionReport:
    """Detector half (DLASegDetector). Mutates variables in place."""
    params = variables["params"]["detector"]
    stats = variables.get("batch_stats", {}).get("detector", {})
    rep = ConversionReport()

    base = params["base"]
    bstats = stats.get("base")
    assign_conv_bn(base, ["base"], src, "base.base_layer.0",
                   "base.base_layer.1", rep, bstats)
    assign_conv_bn(base, ["level0"], src, "base.level0.0",
                   "base.level0.1", rep, bstats)
    assign_conv_bn(base, ["level1"], src, "base.level1.0",
                   "base.level1.1", rep, bstats)
    for lvl, depth in DLA34_LEVELS.items():
        _assign_tree(base, bstats, [lvl], src, f"base.{lvl}", depth, rep)

    # DLAUp: ida_0 (1 proj), ida_1 (2), ida_2 (3)
    for i in range(3):
        _assign_ida(params["dla_up"], stats.get("dla_up"), [f"ida_{i}"],
                    src, f"dla_up.ida_{i}", i + 1, rep)
    _assign_ida(params["ida_up"], stats.get("ida_up"), [], src, "ida_up",
                2, rep)

    heads = params["heads"]
    for head in ("hm", "st", "wh", "ax", "cr", "reg"):
        for tidx, fname in ((0, f"{head}_conv"), (2, f"{head}_out")):
            tname = f"{head}.{tidx}"
            rep.check_assign(heads, [fname, "kernel"],
                             convert_conv(src.get(f"{tname}.weight")), tname)
            rep.check_assign(heads, [fname, "bias"],
                             src.get(f"{tname}.bias"), tname)
    return rep


def convert_lore_processor(src: TorchTensorSource,
                           variables: Dict[str, Any],
                           tsfm_layers: int = 4,
                           stacking_layers: int = 4) -> ConversionReport:
    """Processor half (LoreProcessor). ``variables`` may hold the full
    LoreModel tree or a standalone LoreProcessor tree."""
    params = variables["params"]
    if "processor" in params:
        params = params["processor"]
    rep = ConversionReport()
    for emb in ("x_position_embeddings", "y_position_embeddings"):
        rep.check_assign(params, [emb, "embedding"],
                         src.get(f"{emb}.weight"), emb)

    def tsfm(tree, tprefix, n_layers):
        _assign_dense(tree, ["linear"], src, f"{tprefix}.linear", rep)
        for i in range(n_layers):
            lp = ["layer_" + str(i)]
            tl = f"{tprefix}.encoder.layers.{i}"
            for norm in ("norm_1", "norm_2"):
                rep.check_assign(tree, lp + [norm, "alpha"],
                                 src.get(f"{tl}.{norm}.alpha"), tl)
                rep.check_assign(tree, lp + [norm, "bias"],
                                 src.get(f"{tl}.{norm}.bias"), tl)
            for lin in ("q_linear", "k_linear", "v_linear", "out"):
                _assign_dense(tree, lp + ["attn", lin], src,
                              f"{tl}.attn.{lin}", rep)
            _assign_dense(tree, lp + ["ff_linear_1"], src,
                          f"{tl}.ff.linear_1", rep)
            _assign_dense(tree, lp + ["ff_linear_2"], src,
                          f"{tl}.ff.linear_2", rep)
        _assign_dense(tree, ["decoder", "linear_0"], src,
                      f"{tprefix}.decoder.linear.0", rep)
        _assign_dense(tree, ["decoder", "linear_2"], src,
                      f"{tprefix}.decoder.linear.2", rep)

    tsfm(params["tsfm_axis"], "tsfm_axis", tsfm_layers)
    if "stacker" in params:
        _assign_dense(params["stacker"], ["logi_encoder_0"], src,
                      "stacker.logi_encoder.0", rep)
        _assign_dense(params["stacker"], ["logi_encoder_2"], src,
                      "stacker.logi_encoder.2", rep)
        tsfm(params["stacker"]["tsfm"], "stacker.tsfm", stacking_layers)
    return rep
