"""The PULC PP-LCNet classifiers (counterpart of pdf_table_tpu/models/cls).

The JAX package's exports, name for name, each resolved at its first
use."""

from ..._lazy import lazy_exports

_EXPORTS = {
    "PULC_LABELS": ".config",
    "ClsPulcConfig": ".config",
    "PPLCNetClassifier": ".model",
    "PulcPreProcessor": ".processor",
    "PulcPostProcessor": ".processor",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
