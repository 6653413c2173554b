"""DocXLayout: the DLA-34 CenterNet layout detector (counterpart of
pdf_table_tpu/models/docx_layout).

The JAX package's exports, name for name, each resolved at its first
use."""

from ..._lazy import lazy_exports

_EXPORTS = {
    "DocXLayoutConfig": ".config",
    "DocXLayoutModel": ".model",
    "DocXLayoutPreProcessor": ".processor",
    "DocXLayoutPostProcessor": ".processor",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
