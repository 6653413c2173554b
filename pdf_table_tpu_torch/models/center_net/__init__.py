"""Cycle-CenterNet (counterpart of pdf_table_tpu/models/center_net).

The JAX package's exports, name for name, each resolved at its first
use."""

from ..._lazy import lazy_exports

_EXPORTS = {
    "CenterNetConfig": ".config",
    "CycleCenterNet": ".model",
    "CenterNetPreProcessor": ".processor",
    "CenterNetPostProcessor": ".processor",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
