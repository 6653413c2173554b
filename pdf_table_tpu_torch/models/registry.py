"""Model registry (counterpart of pdf_table_tpu/models/registry.py):
(task, name) -> config factory, the one table of model names of the port.

``build_config`` makes a registered config as named; ``get_config`` first
applies the JAX registry's dtype rule (``models/registry.py:43-51`` there)
through engine/device.py, which owns it (``with_default_dtype``: where the
caller names no ``dtype``, ``PDFTABLE_COMPUTE_DTYPE``, bf16 unless set, on
a card; f32 on the CPU). ``device`` is taken as ``resolve_device`` takes
it: ``None`` means the card, and raises without one. The tasks' name
tables (``tasks/detection.py::det_config``,
``tasks/recognition.py::rec_config``, ``tasks/table_structure.py::
lore_config`` and the layout task's choice of config) delegate here.

An unknown name raises :class:`UnknownModel`, a ``KeyError`` as in JAX
and a ``NotImplementedError`` as the port's tasks raise it, naming the
names the task has. ``weights_dir`` is the directory that converted
weights of an entry take under ``Constants.MODEL_CACHE_DIR``; the port
loads flax-layout trees passed as ``variables`` and fetches nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from ..utils.constants import Constants

_REGISTRY: Dict[Tuple[str, str], Callable[..., Any]] = {}

TASKS = ("detection", "recognition", "layout", "table_structure", "cls")


@dataclass(frozen=True)
class ModelKey:
    """A model's full key, as the JAX registry declares it."""
    task: str            # one of TASKS
    name: str            # e.g. "PP-OCRv4_det" / "db_resnet18" / "LoreModel"
    task_type: str = ""  # e.g. "general" / "table" / "wtw"
    lang: str = "en"


class UnknownModel(KeyError, NotImplementedError):
    """A (task, name) the registry does not hold."""

    def __str__(self) -> str:
        return str(self.args[0])


def register(task: str, name: str):
    def deco(factory):
        _REGISTRY[(task, name)] = factory
        return factory
    return deco


def _factory(task: str, name: str) -> Callable[..., Any]:
    key = (task, name)
    if key not in _REGISTRY:
        raise UnknownModel(f"no model {name!r} for task {task!r}; known: "
                           f"{list_models(task)}")
    return _REGISTRY[key]


def build_config(task: str, name: str, **kwargs):
    """The config of a registered (task, name), with ``kwargs`` as given."""
    return _factory(task, name)(**kwargs)


def get_config(task: str, name: str, device=None, **kwargs):
    """``build_config`` with the dtype rule applied where ``kwargs`` name
    no ``dtype``."""
    from ..engine.device import resolve_device, with_default_dtype

    factory = _factory(task, name)
    return factory(**with_default_dtype(kwargs, resolve_device(device)))


def list_models(task: Optional[str] = None):
    return sorted(n for (t, n) in _REGISTRY if task is None or t == task)


def weights_dir(task: str, name: str, lang: str = "") -> str:
    """Directory for converted weights of a registry entry."""
    leaf = f"{name}_{lang}" if lang else name
    return os.path.join(Constants.MODEL_CACHE_DIR, task, leaf)


# -- registrations ------------------------------------------------------------

@register("detection", "db_resnet18")
def _db_r18(**kw):
    from .dbnet.config import DbNetConfig
    return DbNetConfig(backbone="resnet18", **kw)


@register("detection", "db_resnet50")
def _db_r50(**kw):
    from .dbnet.config import DbNetConfig
    return DbNetConfig(backbone="resnet50", **kw)


@register("detection", "db_proxylessnas")
def _db_nas(**kw):
    from .dbnet.config import DbNetConfig
    kw.setdefault("inner_channels", 64)
    return DbNetConfig(backbone="proxylessnas", **kw)


@register("detection", "PP-OCRv4_det")
def _db_pp(**kw):
    from .dbnet.config import DbNetConfig
    return DbNetConfig.ppocr(**kw)


@register("recognition", "PP-OCRv4_rec")
def _rec_pp(**kw):
    """lang-keyed: the charset comes from the lang's dict file and the
    vocab size follows it."""
    from .rec_ctc.charset import resolve_charset
    from .rec_ctc.config import RecConfig

    lang = kw.pop("lang", "en")
    if lang != "en" and "charset_name" not in kw:
        kw["charset_name"] = lang
        kw.setdefault("vocab_size", len(resolve_charset(lang)))
    return RecConfig(backbone="svtr_lcnet", **kw)


@register("recognition", "CRNN")
def _rec_crnn(**kw):
    from .rec_ctc.config import RecConfig
    kw.pop("lang", None)   # ModelScope's CRNN ships its own vocab
    return RecConfig.crnn(**kw)


@register("recognition", "ConvNextViT")
def _rec_cnv(**kw):
    from .rec_ctc.config import RecConfig
    kw.pop("lang", None)
    return RecConfig.convnext_vit(**kw)


@register("recognition", "LightweightEdge")
def _rec_lwe(**kw):
    from .rec_ctc.config import RecConfig
    kw.pop("lang", None)
    base = dict(backbone="lightweight_edge", img_channels=3, img_height=32,
                img_width=320)
    base.update(kw)
    return RecConfig(**base)


@register("layout", "DocXLayout")
def _layout_docx(**kw):
    from .docx_layout.config import DocXLayoutConfig
    kw.pop("task_type", None)
    return DocXLayoutConfig(**kw)


@register("layout", "picodet")
def _layout_picodet(**kw):
    from .picodet.config import PicoDetConfig
    return PicoDetConfig(**kw)


@register("table_structure", "SLANet")
def _tsr_slanet(**kw):
    from .slanet.config import SLANetConfig
    return SLANetConfig(**kw)


@register("table_structure", "Lore")
def _tsr_lore(task_type: str = "wtw", **kw):
    from .lore.config import LoreConfig
    if task_type == "wtw":
        return LoreConfig.wtw(**kw)
    if task_type == "wireless":
        return LoreConfig.wireless(**kw)
    return LoreConfig(task_type=task_type, **kw)


@register("table_structure", "CenterNet")
def _tsr_centernet(**kw):
    from .center_net.config import CenterNetConfig
    return CenterNetConfig(**kw)


@register("table_structure", "Lgpma")
def _tsr_lgpma(**kw):
    from .lgpma.config import LgpmaConfig
    return LgpmaConfig(**kw)


@register("table_structure", "TableMaster")
def _tsr_master(**kw):
    from .table_master.config import TableMasterConfig
    kw.setdefault("variant", "table_master")
    return TableMasterConfig(**kw)


@register("table_structure", "MtlTabNet")
def _tsr_mtl(**kw):
    from .table_master.config import TableMasterConfig
    kw.setdefault("variant", "mtl_tabnet")
    return TableMasterConfig(**kw)


@register("cls", "PPLCNet")
def _cls_pplcnet(task_type: str = "text_image_orientation", **kw):
    from .cls.config import ClsPulcConfig
    return ClsPulcConfig.for_task(task_type, **kw)
