"""Per-page and batched pipelines (counterpart of pdf_table_tpu/pipeline).

The JAX package's exports, name for name, each resolved at its first
use."""

from .._lazy import lazy_exports

_EXPORTS = {
    "OcrSystemModelOutput": ".output",
    "OcrSystemConfig": ".system",
    "OcrSystemTask": ".system",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
