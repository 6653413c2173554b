"""TableMaster and MtlTabNet (counterpart of
pdf_table_tpu/models/table_master).

The JAX package's exports, name for name, each resolved at its first
use."""

from ..._lazy import lazy_exports

_EXPORTS = {
    "TableMasterConfig": ".config",
    "TableMaster": ".model",
    "TableMasterPreProcessor": ".processor",
    "TableMasterPostProcessor": ".processor",
    "MasterStructureVocab": ".vocab",
    "load_pubtabnet_structure_alphabet": ".vocab",
    "load_pubtabnet_textline_alphabet": ".vocab",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
