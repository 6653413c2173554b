"""TableMaster / MtlTabNet checkpoint conversion (a copy of
pdf_table_tpu/convert/master_convert.py: numpy only, the same flax-layout
trees).

Maps the reference's mmocr-style state dict (model/table/mtl_tabnet/
table_master.py: attributes ``backbone`` = TableResNetExtra
(table_resnet_extra.py:205) and ``decoder`` = TableMasterDecoder
(master_decoder.py:532); the ``encoder`` is a parameter-free
PositionalEncoding) onto the flax TableMaster
(models/table_master/model.py).

Torch naming handled:
  backbone.conv{1..6}/bn{1..6}, backbone.layer{1..4}.{i}.conv1/bn1/conv2/
  bn2[.downsample.0/.1][.context_block.conv_mask/.channel_add_conv.{0,1,3}]
  decoder.layers.{i}. / decoder.cls_layer.0. / decoder.bbox_layer.0.
      self_attn.linears.{0..3}, src_attn.linears.{0..3},
      feed_forward.w_1/w_2, sublayer.{0,1,2}.norm
  decoder.norm, decoder.embedding.lut, decoder.cls_fc, decoder.bbox_fc.0
"""

from __future__ import annotations

from typing import Any, Dict

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            assign_conv_bn, convert_dense)

# flax block name -> (torch layer, index, has_gcb, has_downsample)
ENCODER_BLOCKS = (
    [("layer1_0", "layer1", 0, False, True)]
    + [(f"layer2_{i}", "layer2", i, True, False) for i in range(2)]
    + [(f"layer3_{i}", "layer3", i, True, i == 0) for i in range(5)]
    + [(f"layer4_{i}", "layer4", i, True, False) for i in range(3)]
)


def _assign_context(tree: Dict, prefix: list, src: TorchTensorSource,
                    tname: str, rep: ConversionReport) -> None:
    """GCB ContextBlock (table_resnet_extra.py:38): conv_mask +
    channel_add_conv = [conv1x1, LayerNorm([planes,1,1]), ReLU, conv1x1]."""
    from .torch_to_flax import convert_conv

    rep.check_assign(tree, prefix + ["conv_mask", "kernel"],
                     convert_conv(src.get(f"{tname}.conv_mask.weight")),
                     tname)
    rep.check_assign(tree, prefix + ["conv_mask", "bias"],
                     src.get(f"{tname}.conv_mask.bias"), tname)
    ca = f"{tname}.channel_add_conv"
    rep.check_assign(tree, prefix + ["ca_conv1", "kernel"],
                     convert_conv(src.get(f"{ca}.0.weight")), ca)
    rep.check_assign(tree, prefix + ["ca_conv1", "bias"],
                     src.get(f"{ca}.0.bias"), ca)
    rep.check_assign(tree, prefix + ["ca_ln", "scale"],
                     src.get(f"{ca}.1.weight").reshape(-1), ca)
    rep.check_assign(tree, prefix + ["ca_ln", "bias"],
                     src.get(f"{ca}.1.bias").reshape(-1), ca)
    rep.check_assign(tree, prefix + ["ca_conv2", "kernel"],
                     convert_conv(src.get(f"{ca}.3.weight")), ca)
    rep.check_assign(tree, prefix + ["ca_conv2", "bias"],
                     src.get(f"{ca}.3.bias"), ca)


def convert_master_encoder(src: TorchTensorSource, enc: Dict[str, Any],
                           enc_stats: Dict[str, Any], tprefix: str,
                           rep: ConversionReport) -> None:
    t = lambda n: f"{tprefix}backbone.{n}"
    for i in range(1, 7):
        assign_conv_bn(enc, [f"c{i}"], src, t(f"conv{i}"), t(f"bn{i}"),
                       rep, enc_stats)
    for fname, tlayer, ti, gcb, down in ENCODER_BLOCKS:
        tb = t(f"{tlayer}.{ti}")
        block = enc[fname]
        bstats = (enc_stats or {}).get(fname)
        assign_conv_bn(block, ["conv1"], src, f"{tb}.conv1", f"{tb}.bn1",
                       rep, bstats)
        assign_conv_bn(block, ["conv2"], src, f"{tb}.conv2", f"{tb}.bn2",
                       rep, bstats)
        if down:
            assign_conv_bn(block, ["down"], src, f"{tb}.downsample.0",
                           f"{tb}.downsample.1", rep, bstats)
        if gcb:
            _assign_context(block["context"], [], src,
                            f"{tb}.context_block", rep)


def _assign_decoder_layer(src: TorchTensorSource, params: Dict[str, Any],
                          fname: str, tname: str,
                          rep: ConversionReport) -> None:
    """One DecoderLayer -> the flax explicit-param group ``{fname}_*``."""
    pairs = [("q", "self_attn.linears.0"), ("k", "self_attn.linears.1"),
             ("v", "self_attn.linears.2"), ("o", "self_attn.linears.3"),
             ("cq", "src_attn.linears.0"), ("ck", "src_attn.linears.1"),
             ("cv", "src_attn.linears.2"), ("co", "src_attn.linears.3"),
             ("ff1", "feed_forward.w_1"), ("ff2", "feed_forward.w_2")]
    for fk, tk in pairs:
        rep.check_assign(params, [f"{fname}_{fk}"],
                         convert_dense(src.get(f"{tname}.{tk}.weight")),
                         f"{tname}.{tk}")
        rep.check_assign(params, [f"{fname}_{fk}b"],
                         src.get(f"{tname}.{tk}.bias"), f"{tname}.{tk}")
    for i in (1, 2, 3):
        ln = f"{tname}.sublayer.{i - 1}.norm"
        rep.check_assign(params, [f"{fname}_ln{i}s"], src.get(f"{ln}.weight"),
                         ln)
        rep.check_assign(params, [f"{fname}_ln{i}b"], src.get(f"{ln}.bias"),
                         ln)


def convert_table_master(src: TorchTensorSource, variables: Dict[str, Any],
                         n_layers: int = 3,
                         tprefix: str = "") -> ConversionReport:
    """Full TableMaster checkpoint -> flax variables (in place)."""
    rep = ConversionReport()
    params = variables["params"]
    convert_master_encoder(src, params["encoder"],
                           variables.get("batch_stats", {}).get("encoder"),
                           tprefix, rep)
    t = lambda n: f"{tprefix}decoder.{n}"
    for i in range(n_layers - 1):
        _assign_decoder_layer(src, params, f"l{i}", t(f"layers.{i}"), rep)
    _assign_decoder_layer(src, params, "cls", t("cls_layer.0"), rep)
    _assign_decoder_layer(src, params, "bbox", t("bbox_layer.0"), rep)
    rep.check_assign(params, ["fnorm_s"], src.get(t("norm.weight")),
                     t("norm"))
    rep.check_assign(params, ["fnorm_b"], src.get(t("norm.bias")), t("norm"))
    rep.check_assign(params, ["token_embed"],
                     src.get(t("embedding.lut.weight")), t("embedding.lut"))
    rep.check_assign(params, ["fc_cls"],
                     convert_dense(src.get(t("cls_fc.weight"))), t("cls_fc"))
    rep.check_assign(params, ["fc_cls_b"], src.get(t("cls_fc.bias")),
                     t("cls_fc"))
    rep.check_assign(params, ["fc_loc"],
                     convert_dense(src.get(t("bbox_fc.0.weight"))),
                     t("bbox_fc.0"))
    rep.check_assign(params, ["fc_loc_b"], src.get(t("bbox_fc.0.bias")),
                     t("bbox_fc.0"))
    if "cell_embed" in params:      # MtlTabNet cell-content branch
        _assign_decoder_layer(src, params, "cell", t("cell_layer.0"), rep)
        rep.check_assign(params, ["cell_embed"],
                         src.get(t("embedding_cell.lut.weight")),
                         t("embedding_cell.lut"))
        rep.check_assign(params, ["cell_in"],
                         convert_dense(src.get(t("cell_input_fc.weight"))),
                         t("cell_input_fc"))
        rep.check_assign(params, ["cell_in_b"],
                         src.get(t("cell_input_fc.bias")),
                         t("cell_input_fc"))
        rep.check_assign(params, ["fc_cell"],
                         convert_dense(src.get(t("cell_fc.weight"))),
                         t("cell_fc"))
        rep.check_assign(params, ["fc_cell_b"], src.get(t("cell_fc.bias")),
                         t("cell_fc"))
    return rep
