"""SLANet torch checkpoint -> flax params (a copy of
pdf_table_tpu/convert/slanet_convert.py: numpy only, the same flax-layout
trees).

The reference runs SLANet as a PaddleOCR ONNX export
(model/slanet/configuration_slanet.py:64-65). Source names follow the
PaddleOCR module tree as a torch port produces it:

  backbone.conv1 / backbone.blocks{2..6}.{i}   PPLCNet (see pplcnet_convert)
  neck.conv_t.convs.{i} / neck.top_down_blocks.{i} / neck.downsamples.{i}
      / neck.bottom_up_blocks.{i}              CSPPAN (see picodet_convert)
  head.structure_attention_cell.{i2h,h2h,score,rnn}
  head.structure_generator.{0,1}
  head.loc_generator.{0,1}

Flax tree: models/slanet SLANet — backbone/neck share the picodet modules;
head params are flat (model.py SLAHead). Torch GRUCell gate rows are
(r, z, c) — the same order the flax head splits, so the fused matrices
transpose straight across.
"""

from __future__ import annotations

from typing import Any, Dict

from .picodet_convert import _conv_bn, _csp_layer, _dp_module
from .pplcnet_convert import _STAGE_SIZES
from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            convert_conv, convert_dense)


def convert_slanet(src: TorchTensorSource, variables: Dict[str, Any],
                   ) -> ConversionReport:
    """Mutates ``variables`` (params + batch_stats) in place."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    rep = ConversionReport()

    # --- backbone (PPLCNet, all 5 stages kept) ---
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

    # --- neck (4-level CSPPAN, no extra level) ---
    nk, ns = params["neck"], stats.get("neck", {})
    for i in range(4):
        _conv_bn(nk, ns, src, [f"conv_t{i}"], f"neck.conv_t.convs.{i}.conv",
                 f"neck.conv_t.convs.{i}.bn", rep)
    for i in range(3):
        _csp_layer(nk, ns, src, f"top_down{i}", f"neck.top_down_blocks.{i}",
                   rep)
        _dp_module(nk, ns, src, [f"downsample{i}"], f"neck.downsamples.{i}",
                   rep)
        _csp_layer(nk, ns, src, f"bottom_up{i}", f"neck.bottom_up_blocks.{i}",
                   rep)

    # --- head (SLAHead) ---
    hd = params["head"]
    cell = "head.structure_attention_cell"
    rep.check_assign(hd, ["attn_i2h"],
                     convert_dense(src.get(f"{cell}.i2h.weight")),
                     f"{cell}.i2h")
    rep.check_assign(hd, ["attn_h2h"],
                     convert_dense(src.get(f"{cell}.h2h.weight")),
                     f"{cell}.h2h")
    rep.check_assign(hd, ["attn_h2h_b"], src.get(f"{cell}.h2h.bias"),
                     f"{cell}.h2h")
    rep.check_assign(hd, ["attn_score"],
                     convert_dense(src.get(f"{cell}.score.weight")),
                     f"{cell}.score")
    rep.check_assign(hd, ["gru_w_ih"],
                     convert_dense(src.get(f"{cell}.rnn.weight_ih")),
                     f"{cell}.rnn")
    rep.check_assign(hd, ["gru_b_ih"], src.get(f"{cell}.rnn.bias_ih"),
                     f"{cell}.rnn")
    rep.check_assign(hd, ["gru_w_hh"],
                     convert_dense(src.get(f"{cell}.rnn.weight_hh")),
                     f"{cell}.rnn")
    rep.check_assign(hd, ["gru_b_hh"], src.get(f"{cell}.rnn.bias_hh"),
                     f"{cell}.rnn")
    for fl, tl in (("fc_struct", "structure_generator"),
                   ("fc_loc", "loc_generator")):
        for j in range(2):
            rep.check_assign(hd, [f"{fl}{j}"],
                             convert_dense(src.get(f"head.{tl}.{j}.weight")),
                             f"head.{tl}.{j}")
            rep.check_assign(hd, [f"{fl}{j}_b"],
                             src.get(f"head.{tl}.{j}.bias"),
                             f"head.{tl}.{j}")
    return rep
