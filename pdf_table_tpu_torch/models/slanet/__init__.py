"""SLANet (counterpart of pdf_table_tpu/models/slanet).

The JAX package's exports, name for name, each resolved at its first
use."""

from ..._lazy import lazy_exports

_EXPORTS = {
    "SLANetConfig": ".config",
    "SLANet": ".model",
    "SLANetPreProcessor": ".processor",
    "SLANetPostProcessor": ".processor",
    "STRUCTURE_TOKENS": ".vocab",
    "StructureVocab": ".vocab",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
