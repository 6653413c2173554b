"""ConvNextViT recognizer checkpoint conversion (a copy of
pdf_table_tpu/convert/convnext_convert.py: numpy only, the same flax-layout
trees).

Maps the reference ConvNextViT state dict (model/convnext_vit/
modeling_convnext_vit.py:20: ``cnn_model`` = modified HF ConvNextModel
with (2,1)-stride stage downsampling, ``vitstr`` = ViTForSTR) onto the
flax CTCRecModel(backbone="convnext_vit") tree (models/rec_ctc/model.py).

Handled torch naming (HF transformers):
  cnn_model.embeddings.patch_embeddings[.projection].{weight,bias},
  cnn_model.embeddings.layernorm
  cnn_model.encoder.stages.{s}.downsampling_layer.{0,1} (s>0)
  cnn_model.encoder.stages.{s}.layers.{i}.{dwconv,layernorm,pwconv1,
      pwconv2,layer_scale_parameter}
  vitstr.vit.embeddings.position_embeddings (cls row sliced off,
      modeling_vit.py:71), .patch_embeddings.projection (1x1 conv -> dense)
  vitstr.vit.encoder.layer.{i}.attention.attention.{query,key,value},
      .attention.output.dense, .layernorm_before/.layernorm_after,
      .intermediate.dense, .output.dense
  vitstr.vit.layernorm, vitstr.classifier -> ctc_head
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from .torch_to_flax import (ConversionReport, TorchTensorSource,
                            convert_conv, convert_dense)


def _linear(src, params, fpath, tname, rep):
    rep.check_assign(params, fpath + ["kernel"],
                     convert_dense(src.get(f"{tname}.weight")), tname)
    rep.check_assign(params, fpath + ["bias"], src.get(f"{tname}.bias"),
                     tname)


def _lnorm(src, params, fpath, tname, rep):
    rep.check_assign(params, fpath + ["scale"],
                     src.get(f"{tname}.weight").reshape(-1), tname)
    rep.check_assign(params, fpath + ["bias"],
                     src.get(f"{tname}.bias").reshape(-1), tname)


def convert_convnext_vit(src: TorchTensorSource,
                         variables: Dict[str, Any],
                         depths: Sequence[int] = (3, 3, 8, 3),
                         tprefix: str = "") -> ConversionReport:
    rep = ConversionReport()
    params = variables["params"]
    bb = params["backbone"]
    t = lambda n: f"{tprefix}{n}"

    # -- ConvNext encoder ----------------------------------------------------
    emb = t("cnn_model.embeddings.patch_embeddings")
    if f"{emb}.projection.weight" in src:   # older transformers naming
        emb = f"{emb}.projection"
    rep.check_assign(bb, ["patch_conv", "kernel"],
                     convert_conv(src.get(f"{emb}.weight")), emb)
    rep.check_assign(bb, ["patch_conv", "bias"], src.get(f"{emb}.bias"), emb)
    _lnorm(src, bb, ["patch_ln"], t("cnn_model.embeddings.layernorm"), rep)
    for si, depth in enumerate(depths):
        ts = t(f"cnn_model.encoder.stages.{si}")
        if si > 0:
            _lnorm(src, bb, [f"s{si}_down_ln"],
                   f"{ts}.downsampling_layer.0", rep)
            rep.check_assign(
                bb, [f"s{si}_down", "kernel"],
                convert_conv(src.get(f"{ts}.downsampling_layer.1.weight")),
                ts)
            rep.check_assign(bb, [f"s{si}_down", "bias"],
                             src.get(f"{ts}.downsampling_layer.1.bias"), ts)
        for li in range(depth):
            tb = f"{ts}.layers.{li}"
            blk = bb[f"s{si}_b{li}"]
            rep.check_assign(blk, ["dwconv", "kernel"],
                             convert_conv(src.get(f"{tb}.dwconv.weight")),
                             tb)
            rep.check_assign(blk, ["dwconv", "bias"],
                             src.get(f"{tb}.dwconv.bias"), tb)
            _lnorm(src, blk, ["ln"], f"{tb}.layernorm", rep)
            _linear(src, blk, ["pw1"], f"{tb}.pwconv1", rep)
            _linear(src, blk, ["pw2"], f"{tb}.pwconv2", rep)
            rep.check_assign(blk, ["gamma"],
                             src.get(f"{tb}.layer_scale_parameter"), tb)

    # -- ViT -----------------------------------------------------------------
    tv = t("vitstr.vit")
    proj = src.get(f"{tv}.embeddings.patch_embeddings.projection.weight")
    rep.check_assign(bb, ["proj", "kernel"],
                     proj.reshape(proj.shape[0], proj.shape[1]).T,
                     f"{tv}.embeddings.patch_embeddings.projection")
    rep.check_assign(
        bb, ["proj", "bias"],
        src.get(f"{tv}.embeddings.patch_embeddings.projection.bias"), tv)
    pos = src.get(f"{tv}.embeddings.position_embeddings")
    rep.check_assign(bb, ["pos_embed"], pos[:, 1:, :],
                     f"{tv}.embeddings.position_embeddings")
    i = 0
    while f"{tv}.encoder.layer.{i}.layernorm_before.weight" in src:
        tl = f"{tv}.encoder.layer.{i}"
        vl = bb[f"vit{i}"]
        _lnorm(src, vl, ["ln1"], f"{tl}.layernorm_before", rep)
        _linear(src, vl, ["q"], f"{tl}.attention.attention.query", rep)
        _linear(src, vl, ["k"], f"{tl}.attention.attention.key", rep)
        _linear(src, vl, ["v"], f"{tl}.attention.attention.value", rep)
        _linear(src, vl, ["attn_out"], f"{tl}.attention.output.dense", rep)
        _lnorm(src, vl, ["ln2"], f"{tl}.layernorm_after", rep)
        _linear(src, vl, ["fc1"], f"{tl}.intermediate.dense", rep)
        _linear(src, vl, ["fc2"], f"{tl}.output.dense", rep)
        i += 1
    _lnorm(src, bb, ["vit_ln"], f"{tv}.layernorm", rep)
    _linear(src, params, ["ctc_head"], t("vitstr.classifier"), rep)
    return rep
