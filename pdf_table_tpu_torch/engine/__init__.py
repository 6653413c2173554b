"""The task engine (counterpart of pdf_table_tpu/engine): the task base
class, the batch buckets, the device and dtype policy, the weights.

The JAX package's exports, name for name, each resolved at its first
use."""

from .._lazy import lazy_exports

_EXPORTS = {
    "InferTask": ".infer_task",
    "TaskConfig": ".infer_task",
    "bucket_batch_size": ".buckets",
    "BUCKET_SIZES": ".buckets",
    "default_backend": ".device",
    "compute_dtype": ".device",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
