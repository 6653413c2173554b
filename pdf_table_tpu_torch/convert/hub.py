"""Hub-weights resolution: converter model name -> hub repo id -> local
snapshot, closing the reference's name->weights chain (a copy of
pdf_table_tpu/convert/hub.py).

The reference maps (provider x task x model x lang) to HF/ModelScope repo
ids in TABLE_MODEL_DICT (model/ocr_pdf/ocr_table_model_config.py:16-347)
and fetches them with snapshot_download (utils/common_utils.py:465-497),
switching hubs via PDFTABLE_USE_MODELSCOPE_HUB (utils/constant.py:44).
Here the table is keyed by the CONVERTER names that
``python -m pdf_table_tpu_torch.convert`` understands, since the port's
weights always pass through a converter; ``--from-hub --model <model>``
there = download -> convert -> sidecar dicts, one command.

Offline, download_snapshot raises a clear error instead of hanging — the
resolution logic itself is covered by mock tests
(tests/test_torch_convert.py).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Tuple

# converter name (optionally lang/task_type-keyed) -> (hf repo id,
# modelscope repo id or None). Verbatim ids from
# ocr_table_model_config.py:16-347 (including the reference's
# 'recognitoin' typo in the LightweightEdge id).
HUB_MODEL_IDS: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {
    "db_resnet18": {"": (
        "cycloneboy/cv_resnet18_ocr-detection-db-line-level_damo",
        "damo/cv_resnet18_ocr-detection-db-line-level_damo")},
    "db_proxylessnas": {"": (
        "cycloneboy/cv_proxylessnas_ocr-detection-db-line-level_damo",
        "damo/cv_proxylessnas_ocr-detection-db-line-level_damo")},
    "pp_det": {
        "": ("cycloneboy/en_PP-OCRv3_det_infer", None),
        "ch": ("cycloneboy/ch_PP-OCRv4_det_infer", None),
        "ch_server": ("cycloneboy/ch_PP-OCRv4_det_server_infer", None),
        "en": ("cycloneboy/en_PP-OCRv3_det_infer", None),
        "ml": ("cycloneboy/Multilingual_PP-OCRv3_det_infer", None),
        "table_en": ("cycloneboy/en_ppocr_mobile_v2.0_table_det_infer",
                     None),
    },
    "pp_rec": {
        "": ("cycloneboy/en_PP-OCRv4_rec_infer", None),
        "ch": ("cycloneboy/ch_PP-OCRv4_rec_infer", None),
        "ch_server": ("cycloneboy/ch_PP-OCRv4_rec_server_infer", None),
        "en": ("cycloneboy/en_PP-OCRv4_rec_infer", None),
        "korean": ("cycloneboy/korean_PP-OCRv4_rec_infer", None),
        "japan": ("cycloneboy/japan_PP-OCRv4_rec_infer", None),
        "chinese_cht": ("cycloneboy/chinese_cht_PP-OCRv3_rec_infer", None),
        "ta": ("cycloneboy/ta_PP-OCRv4_rec_infer", None),
        "te": ("cycloneboy/te_PP-OCRv4_rec_infer", None),
        "ka": ("cycloneboy/ka_PP-OCRv4_rec_infer", None),
        "latin": ("cycloneboy/latin_PP-OCRv3_rec_infer", None),
        "arabic": ("cycloneboy/arabic_PP-OCRv4_rec_infer", None),
        "cyrillic": ("cycloneboy/cyrillic_PP-OCRv3_rec_infer", None),
        "devanagari": ("cycloneboy/devanagari_PP-OCRv4_rec_infer", None),
        "table_en": ("cycloneboy/en_ppocr_mobile_v2.0_table_rec_infer",
                     None),
    },
    "crnn": {"": ("cycloneboy/cv_crnn_ocr-recognition-general_damo",
                  "damo/cv_crnn_ocr-recognition-general_damo")},
    "lightweight_edge": {"": (
        "cycloneboy/cv_LightweightEdge_ocr-recognitoin-general_damo",
        "damo/cv_LightweightEdge_ocr-recognitoin-general_damo")},
    "convnext_vit": {
        "": ("cycloneboy/cv_convnextTiny_ocr-recognition-general_damo",
             None),
        "general": (
            "cycloneboy/cv_convnextTiny_ocr-recognition-general_damo",
            None),
        "handwritten": (
            "cycloneboy/cv_convnextTiny_ocr-recognition-handwritten_damo",
            None),
        "document": (
            "cycloneboy/cv_convnextTiny_ocr-recognition-document_damo",
            None),
        "licenseplate": (
            "cycloneboy/cv_convnextTiny_ocr-recognition-licenseplate_damo",
            None),
        "scene": (
            "cycloneboy/cv_convnextTiny_ocr-recognition-scene_damo", None),
    },
    "slanet": {
        "": ("cycloneboy/en_ppstructure_mobile_v2.0_SLANet_infer", None),
        "ch": ("cycloneboy/ch_ppstructure_mobile_v2.0_SLANet_infer", None),
        "en": ("cycloneboy/en_ppstructure_mobile_v2.0_SLANet_infer", None),
    },
    "picodet": {
        "": ("cycloneboy/picodet_lcnet_x1_0_fgd_layout_table_infer", None),
        "ch": ("cycloneboy/picodet_lcnet_x1_0_fgd_layout_cdla_infer", None),
        "en": ("cycloneboy/picodet_lcnet_x1_0_fgd_layout_infer", None),
        "table": ("cycloneboy/picodet_lcnet_x1_0_fgd_layout_table_infer",
                  None),
    },
    "pplcnet_table_attribute": {"": (
        "cycloneboy/cv_cls_pulc_table_attribute", None)},
    "pplcnet_text_image_orientation": {"": (
        "cycloneboy/cv_cls_pulc_text_image_orientation", None)},
    "pplcnet_textline_orientation": {"": (
        "cycloneboy/cv_cls_pulc_textline_orientation", None)},
    "pplcnet_language_classification": {"": (
        "cycloneboy/cv_cls_pulc_language_classification", None)},
    "lore_wtw": {"": (
        "cycloneboy/cv_dla34-transformer_table-structure-recognition_lore_wtw",
        None)},
    "lore_wireless": {"": (
        "cycloneboy/cv_resnet-transformer_table-structure-recognition_lore_wireless",
        "damo/cv_resnet-transformer_table-structure-recognition_lore")},
    "lore_ptn": {"": (
        "cycloneboy/cv_dla34-transformer_table-structure-recognition_lore_ptn",
        None)},
    "table_master": {"": (
        "cycloneboy/en_table_structure_tablemaster_pubtabnet", None)},
    "mtl_tabnet": {
        "": ("cycloneboy/en_table_structure_mtltabnet_pubtabnet", None),
        "PubTabNet": ("cycloneboy/en_table_structure_mtltabnet_pubtabnet",
                      None),
        "FinTabNet": ("cycloneboy/en_table_structure_mtltabnet_fintabnet",
                      None),
    },
    "docx_layout": {"": (
        "cycloneboy/cv_dla34_layout-analysis_docxlayout_general", None)},
    "cycle_centernet": {"": (
        "cycloneboy/cv_dla34_table-structure-recognition_cycle-centernet",
        "iic/cv_dla34_table-structure-recognition_cycle-centernet")},
    "lgpma": {"": (
        "cycloneboy/en_table_structure_lgpma_pubtabnet", None)},
}

# checkpoint filename preference inside a snapshot (reference snapshots
# ship one of these; model_best/processor_best is the LORE layout)
_CKPT_PATTERNS = ("model_best.pth", "pytorch_model.pt", "pytorch_model.bin",
                  "*.pth", "*.pt", "*.bin", "model.onnx", "*.onnx")


def resolve_hub_id(model: str, variant: str = "") -> str:
    """Converter model name (+ lang/task_type variant) -> hub repo id.

    Honors PDFTABLE_USE_MODELSCOPE_HUB=1 (reference constant.py:44):
    prefer the ModelScope id when one exists, else the HF id.
    """
    if model not in HUB_MODEL_IDS:
        known = ", ".join(sorted(HUB_MODEL_IDS))
        raise KeyError(f"no hub mapping for model {model!r}; known: {known}")
    variants = HUB_MODEL_IDS[model]
    if variant not in variants:
        if "" in variants and not variant:
            variant = ""
        else:
            raise KeyError(
                f"model {model!r} has no variant {variant!r}; "
                f"known: {sorted(k for k in variants if k)}")
    hf_id, ms_id = variants[variant]
    use_ms = os.environ.get("PDFTABLE_USE_MODELSCOPE_HUB", "0") == "1"
    return (ms_id or hf_id) if use_ms else hf_id


def download_snapshot(repo_id: str, cache_dir: Optional[str] = None) -> str:
    """snapshot_download analog (common_utils.py:465-497). Returns the
    local snapshot dir; raises RuntimeError with an actionable message
    when the hub client is missing or the network is unavailable."""
    use_ms = os.environ.get("PDFTABLE_USE_MODELSCOPE_HUB", "0") == "1"
    try:
        if use_ms:
            from modelscope.hub.snapshot_download import \
                snapshot_download  # type: ignore
            return snapshot_download(repo_id, cache_dir=cache_dir)
        from huggingface_hub import snapshot_download  # type: ignore
        return snapshot_download(repo_id, cache_dir=cache_dir)
    except ImportError as e:
        hub = "modelscope" if use_ms else "huggingface_hub"
        raise RuntimeError(
            f"downloading {repo_id!r} needs the {hub} package; install it "
            f"or download the snapshot manually and pass --checkpoint "
            f"<file>") from e
    except Exception as e:  # network / auth / missing repo
        raise RuntimeError(
            f"could not download {repo_id!r} ({type(e).__name__}: {e}); "
            f"if offline, fetch the snapshot elsewhere and pass "
            f"--checkpoint <file>") from e


def find_checkpoint(snapshot_dir: str) -> str:
    """Pick the checkpoint file out of a snapshot directory."""
    for pat in _CKPT_PATTERNS:
        hits = sorted(glob.glob(os.path.join(snapshot_dir, pat)))
        # LORE ships model_best + processor_best; the converter derives
        # the processor path itself, so prefer model_best
        hits = [h for h in hits if "processor_best" not in h] or hits
        if hits:
            return hits[0]
    raise FileNotFoundError(
        f"no checkpoint (.pth/.pt/.bin/.onnx) found in {snapshot_dir!r}")
