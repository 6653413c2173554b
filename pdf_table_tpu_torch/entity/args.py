"""CLI, model and data argument dataclasses (counterpart of
pdf_table_tpu/entity/args.py): the same flag surface, so that
``pdftable --file_path_or_url ... --detect_model ...`` runs unchanged on
the port. ``device_mesh`` is declared and read by nothing, as in the JAX
CLI: a data-parallel run goes through ``BatchPipeline(mesh=)`` or the
service's ``--mesh``."""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional


@dataclass
class PdfTableCliArguments:
    output_dir: str = field(
        default="outputs",
        metadata={"help": "The output directory"})
    file_path_or_url: str = field(
        default="",
        metadata={"help": "file path or url"})
    lang: Optional[str] = field(
        default="en",
        metadata={"help": "ocr recognition language"})
    debug: bool = field(
        default=False,
        metadata={"help": "debug mode"})
    pages: Optional[str] = field(
        default="all",
        metadata={"help": "pages to process: '1,3,4', '1,4-end', or 'all'"})
    html_page_merge_sep: Optional[str] = field(
        default="@@@@@@",
        metadata={"help": "separator between per-page HTML results"})
    detect_model: Optional[str] = field(
        default="PP-OCRv4",
        metadata={"help": "ocr detect model: PP-OCRv4, PP-OCRv3, resnet18, resnet50, proxylessnas"})
    detect_db_thresh: float = field(
        default=0.2,
        metadata={"help": "db threshold"})
    recognizer_model: Optional[str] = field(
        default="PP-OCRv4",
        metadata={"help": "ocr recognize model: PP-OCRv4, PP-OCRv3, PP-Table, ConvNextViT, CRNN, LightweightEdge"})
    recognizer_task_type: Optional[str] = field(
        default="document",
        metadata={"help": "ConvNextViT task type: general, handwritten, document, licenseplate, scene"})
    table_structure_model: Optional[str] = field(
        default="Lore",
        metadata={"help": "TSR model: CenterNet, SLANet, Lore, Lgpma, MtlTabNet, TableMaster, LineCell"})
    table_structure_task_type: Optional[str] = field(
        default="wtw",
        metadata={"help": "TSR task type: ptn, wtw, wireless, fin"})
    layout_model: Optional[str] = field(
        default="picodet",
        metadata={"help": "layout model: picodet, DocXLayout"})
    # batching and device control; the defaults keep the reference CLI's
    # behaviour
    batch_pages: int = field(
        default=1,
        metadata={"help": "pages processed concurrently on device"})
    device_mesh: Optional[str] = field(
        default=None,
        metadata={"help": "data-parallel mesh spec, e.g. 'dp=8'"})
    profile_dir: Optional[str] = field(
        default=None,
        metadata={"help": "write a device trace (torch.profiler, Chrome JSON) here"})


@dataclass
class ModelArguments:
    """LORE-TSR training hyperparameters (reference common_entity.py:16-122)."""
    model_name_or_path: str = field(default="lore")
    backbone: str = field(default="dla34", metadata={"help": "dla34 | resnet18"})
    input_h: int = field(default=768)
    input_w: int = field(default=768)
    down_ratio: int = field(default=4)
    max_objs: int = field(default=300)
    max_cors: int = field(default=1200)
    num_classes: int = field(default=2)
    head_conv: int = field(default=256)
    hidden_size: int = field(default=256)
    tsfm_layers: int = field(default=4)
    num_heads: int = field(default=8)
    att_dropout: float = field(default=0.1)
    stacking_layers: int = field(default=4)
    # loss weights
    hm_weight: float = field(default=1.0)
    wh_weight: float = field(default=1.0)
    off_weight: float = field(default=0.1)
    st_weight: float = field(default=1.0)
    ax_weight: float = field(default=1.0)
    sax_weight: float = field(default=1.0)
    # optimization
    learning_rate: float = field(default=1e-4)
    lr_schedule: str = field(default="step", metadata={"help": "step | poly | cosine"})
    lr_step: str = field(default="70,90")
    warmup_steps: int = field(default=0)
    use_bf16: bool = field(default=True)


@dataclass
class DataTrainingArguments:
    dataset_name: str = field(default="wtw")
    dataset_dir: str = field(default="")
    train_split: str = field(default="train")
    eval_split: str = field(default="test")
    max_train_samples: Optional[int] = field(default=None)
    max_eval_samples: Optional[int] = field(default=None)
    num_workers: int = field(default=4)
    lang: str = field(default="en", metadata={"help": "Language type of the dataset"})


def parse_cli_args(argv=None) -> PdfTableCliArguments:
    """Parse ``PdfTableCliArguments`` from argv (HfArgumentParser-compatible
    flag names, implemented with stdlib argparse to stay dependency-light)."""
    import argparse

    parser = argparse.ArgumentParser(prog="pdftable",
                                     description="PDF table extraction")
    for f in fields(PdfTableCliArguments):
        name = "--" + f.name
        help_text = f.metadata.get("help", "") if f.metadata else ""
        if f.type in (bool, "bool") or isinstance(f.default, bool):
            parser.add_argument(name, action="store_true" if not f.default else "store_false",
                                help=help_text)
        elif isinstance(f.default, int):
            parser.add_argument(name, type=int, default=f.default, help=help_text)
        elif isinstance(f.default, float):
            parser.add_argument(name, type=float, default=f.default, help=help_text)
        else:
            parser.add_argument(name, type=str, default=f.default, help=help_text)
    ns = parser.parse_args(argv)
    return PdfTableCliArguments(**vars(ns))
