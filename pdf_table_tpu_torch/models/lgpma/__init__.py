"""LGPMA (counterpart of pdf_table_tpu/models/lgpma).

The JAX package's exports, name for name, each resolved at its first
use."""

from ..._lazy import lazy_exports

_EXPORTS = {
    "LgpmaConfig": ".config",
    "LGPMA": ".model",
    "LgpmaPreProcessor": ".processor",
    "LgpmaPostProcessor": ".processor",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
