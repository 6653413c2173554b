"""DLA-CenterNet family checkpoint conversion (DocXLayout, Cycle-CenterNet) (a
copy of pdf_table_tpu/convert/centernet_convert.py: numpy only, the same
flax-layout trees).

Both reference models are DLA-34 + DLAUp/IDAUp + per-head Sequentials
(docx_layout/model_dla.py:226, center_net/modeling_centernet.py:274) with
the same torch naming as LORE's DLASeg — this reuses the LORE converter
pieces against the shared DLACenterNet flax trunk
(models/centernet_base.py).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

from .lore_convert import DLA34_LEVELS, _assign_ida, _assign_tree
from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_conv)


def convert_dla_centernet(src: TorchTensorSource, trunk: Dict[str, Any],
                          trunk_stats: Dict[str, Any],
                          heads: Sequence[str],
                          tprefix: str = "") -> ConversionReport:
    """trunk/trunk_stats: params/batch_stats subtree of DLACenterNet
    ({'base','dla_up','ida_up','heads'}); heads: head names (hm, wh, ...);
    tprefix: torch name prefix ('' or e.g. 'model.')."""
    rep = ConversionReport()
    t = lambda n: f"{tprefix}{n}"

    base = trunk["base"]
    bstats = (trunk_stats or {}).get("base")
    assign_conv_bn(base, ["base"], src, t("base.base_layer.0"),
                   t("base.base_layer.1"), rep, bstats)
    assign_conv_bn(base, ["level0"], src, t("base.level0.0"),
                   t("base.level0.1"), rep, bstats)
    assign_conv_bn(base, ["level1"], src, t("base.level1.0"),
                   t("base.level1.1"), rep, bstats)
    for lvl, depth in DLA34_LEVELS.items():
        _assign_tree(base, bstats, [lvl], src, t(f"base.{lvl}"), depth, rep)

    for i in range(3):
        _assign_ida(trunk["dla_up"], (trunk_stats or {}).get("dla_up"),
                    [f"ida_{i}"], src, t(f"dla_up.ida_{i}"), i + 1, rep)
    _assign_ida(trunk["ida_up"], (trunk_stats or {}).get("ida_up"), [],
                src, t("ida_up"), 2, rep)

    hp = trunk["heads"]
    for head in heads:
        for tidx, fname in ((0, f"{head}_conv"), (2, f"{head}_out")):
            tname = t(f"{head}.{tidx}")
            rep.check_assign(hp, [fname, "kernel"],
                             convert_conv(src.get(f"{tname}.weight")), tname)
            rep.check_assign(hp, [fname, "bias"],
                             src.get(f"{tname}.bias"), tname)
    return rep


def convert_docx_layout(src: TorchTensorSource, variables: Dict[str, Any],
                        tprefix: str = "") -> ConversionReport:
    return convert_dla_centernet(
        src, variables["params"]["dla"],
        variables.get("batch_stats", {}).get("dla", {}),
        heads=("cls", "ftype", "hm", "hm_sub", "reg", "wh"),
        tprefix=tprefix)


def convert_cycle_centernet(src: TorchTensorSource,
                            variables: Dict[str, Any],
                            tprefix: str = "") -> ConversionReport:
    return convert_dla_centernet(
        src, variables["params"]["trunk"],
        variables.get("batch_stats", {}).get("trunk", {}),
        heads=("hm", "v2c", "c2v", "reg"),
        tprefix=tprefix)
