"""The CTC text recognizers (counterpart of pdf_table_tpu/models/rec_ctc).

The JAX package's exports, name for name, each resolved at its first
use."""

from ..._lazy import lazy_exports

_EXPORTS = {
    "RecConfig": ".config",
    "Charset": ".charset",
    "default_en_charset": ".charset",
    "CTCRecModel": ".model",
    "RecPreProcessor": ".processor",
    "RecPostProcessor": ".processor",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
