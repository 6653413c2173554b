"""LightweightEdge (ModelScope NAS recognizer) torch checkpoint -> flax (a copy
of pdf_table_tpu/convert/lwe_convert.py: numpy only, the same flax-layout
trees).

Source layout (reference model/ocr_rec_lightweightedge/
modeling_rec_lightweightedge.py:19 + nas_block/proxyless.py): the searched
plnas_linear_mix_se backbone under ``our_nas_model.`` — ``first_conv.{0,1,2}``
(conv/bn/PReLU) and ``blocks.{i}.mobile_inverted_conv.*`` where the op per
block follows the conv_op_ids plan (MBConv: inverted_bottleneck/depth_conv/
point_conv triplets; MixConv: mix_conv.{j} branches; LinearMixConv:
mix_conv.{j} + act; RepConv: rep_conv.{j} + act; SE: fc1/fc2) — plus the
``head`` Linear(128, 7644) mapping onto the flax ctc_head.

Target: models/rec_ctc CTCRecModel(backbone='lightweight_edge') whose
LWE_PLAN mirrors the same op sequence.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..models.rec_ctc.model import LWE_PLAN
from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            convert_conv, convert_dense)


def _assign_cba(tree: Dict, stats: Dict, prefix: list, src, tname: str,
                rep: ConversionReport, act: bool = True) -> None:
    """torch Sequential(conv, bn[, act]) -> flax _ConvBNPReLU subtree."""
    rep.check_assign(tree, prefix + ["conv", "kernel"],
                     convert_conv(src.get(f"{tname}.conv.weight")),
                     f"{tname}.conv")
    rep.check_assign(tree, prefix + ["bn", "scale"],
                     src.get(f"{tname}.bn.weight"), f"{tname}.bn")
    rep.check_assign(tree, prefix + ["bn", "bias"],
                     src.get(f"{tname}.bn.bias"), f"{tname}.bn")
    if stats is not None:
        rep.check_assign(stats, prefix + ["bn", "mean"],
                         src.get(f"{tname}.bn.running_mean"), f"{tname}.bn")
        rep.check_assign(stats, prefix + ["bn", "var"],
                         src.get(f"{tname}.bn.running_var"), f"{tname}.bn")
    if act:
        rep.check_assign(tree, prefix + ["act", "negative_slope"],
                         src.get(f"{tname}.act.weight").reshape(()),
                         f"{tname}.act")


def convert_nas_blocks(src: TorchTensorSource, params: Dict, stats: Dict,
                       plan, torch_prefix: str,
                       rep: ConversionReport) -> None:
    """Walk a proxyless-searched block plan (LWE_PLAN / DBNAS_PLAN layout)
    mapping ``{torch_prefix}.{i}.mobile_inverted_conv.*`` onto
    ``block{i}`` flax subtrees."""
    for i, spec in enumerate(plan):
        kind = spec[0]
        if kind == "zero":
            continue
        t = f"{torch_prefix}.{i}.mobile_inverted_conv"
        f = f"block{i}"
        if kind == "se":
            for fc in ("fc1", "fc2"):
                rep.check_assign(params, [f, fc, "kernel"],
                                 convert_conv(src.get(f"{t}.{fc}.weight")),
                                 f"{t}.{fc}")
                rep.check_assign(params, [f, fc, "bias"],
                                 src.get(f"{t}.{fc}.bias"), f"{t}.{fc}")
            continue
        kind, kernels = spec[0], spec[1]
        if kind == "mb":
            if f"{t}.inverted_bottleneck.conv.weight" in src:
                _assign_cba(params, stats, [f, "inverted_bottleneck"], src,
                            f"{t}.inverted_bottleneck", rep)
            _assign_cba(params, stats, [f, "depth_conv"], src,
                        f"{t}.depth_conv", rep)
            _assign_cba(params, stats, [f, "point_conv"], src,
                        f"{t}.point_conv", rep, act=False)
        elif kind == "mix":
            _assign_cba(params, stats, [f, "inverted_bottleneck"], src,
                        f"{t}.inverted_bottleneck", rep)
            for j in range(len(kernels)):
                _assign_cba(params, stats, [f, f"mix_conv_{j}"], src,
                            f"{t}.mix_conv.{j}", rep)
            _assign_cba(params, stats, [f, "point_conv"], src,
                        f"{t}.point_conv", rep, act=False)
        elif kind == "linmix":
            for j in range(len(kernels)):
                _assign_cba(params, stats, [f, f"mix_conv_{j}"], src,
                            f"{t}.mix_conv.{j}", rep)
            rep.check_assign(params, [f, "act", "negative_slope"],
                             src.get(f"{t}.act.weight").reshape(()),
                             f"{t}.act")
            _assign_cba(params, stats, [f, "point_conv"], src,
                        f"{t}.point_conv", rep, act=False)
        elif kind == "rep":
            _assign_cba(params, stats, [f, "inverted_bottleneck"], src,
                        f"{t}.inverted_bottleneck", rep)
            for j in range(len(kernels)):
                _assign_cba(params, stats, [f, f"rep_conv_{j}"], src,
                            f"{t}.rep_conv.{j}", rep, act=False)
            rep.check_assign(params, [f, "act", "negative_slope"],
                             src.get(f"{t}.act.weight").reshape(()),
                             f"{t}.act")
            _assign_cba(params, stats, [f, "point_conv"], src,
                        f"{t}.point_conv", rep, act=False)


def convert_lightweight_edge(src: TorchTensorSource,
                             variables: Dict[str, Any]) -> ConversionReport:
    """Mutates ``variables`` in place; returns the per-layer report."""
    rep = ConversionReport()
    params = variables["params"]["backbone"]
    stats = variables.get("batch_stats", {}).get("backbone", {})

    # first_conv: Sequential indices 0/1/2
    t = "our_nas_model.first_conv"
    rep.check_assign(params, ["first_conv", "conv", "kernel"],
                     convert_conv(src.get(f"{t}.0.weight")), f"{t}.0")
    rep.check_assign(params, ["first_conv", "bn", "scale"],
                     src.get(f"{t}.1.weight"), f"{t}.1")
    rep.check_assign(params, ["first_conv", "bn", "bias"],
                     src.get(f"{t}.1.bias"), f"{t}.1")
    rep.check_assign(stats, ["first_conv", "bn", "mean"],
                     src.get(f"{t}.1.running_mean"), f"{t}.1")
    rep.check_assign(stats, ["first_conv", "bn", "var"],
                     src.get(f"{t}.1.running_var"), f"{t}.1")
    rep.check_assign(params, ["first_conv", "act", "negative_slope"],
                     src.get(f"{t}.2.weight").reshape(()), f"{t}.2")

    convert_nas_blocks(src, params, stats, LWE_PLAN,
                       "our_nas_model.blocks", rep)

    # head -> ctc_head
    rep.check_assign(variables["params"], ["ctc_head", "kernel"],
                     convert_dense(src.get("head.weight")), "head")
    rep.check_assign(variables["params"], ["ctc_head", "bias"],
                     src.get("head.bias"), "head")
    return rep
