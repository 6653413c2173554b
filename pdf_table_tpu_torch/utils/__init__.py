"""Helpers of the port (counterpart of pdf_table_tpu/utils).

The JAX package's exports, name for name, each resolved at its first
use."""

from .._lazy import lazy_exports

_EXPORTS = {
    "Constants": ".constants",
    "logger": ".logging_utils",
    "get_logger": ".logging_utils",
    "FileUtils": ".file_utils",
    "MathUtils": ".math_utils",
    "TimeUtils": ".time_utils",
    "print_timings": ".benchmark_utils",
    "track_infer_time": ".benchmark_utils",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
