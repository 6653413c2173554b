"""Inference tasks (counterpart of pdf_table_tpu/tasks): host preprocess,
the model on the task's device, host postprocess.

The JAX package's exports, name for name, each resolved at its first
use."""

from .._lazy import lazy_exports

_EXPORTS = {
    "OcrDetectionTask": ".detection",
    "OcrRecognitionTask": ".recognition",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
