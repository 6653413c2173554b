"""Latency statistics (counterpart of ``timing_stats`` in
pdf_table_tpu/utils/benchmark_utils.py): mean, sd, min, max, median, p95,
p99 and count of a list of milliseconds."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def timing_stats(timings_ms: List[float]) -> Dict[str, float]:
    arr = np.asarray(timings_ms, dtype=np.float64)
    if arr.size == 0:
        return {k: 0.0 for k in
                ("mean", "sd", "min", "max", "median", "p95", "p99", "count")}
    return {
        "count": float(arr.size),
        "mean": float(arr.mean()),
        "sd": float(arr.std()),
        "min": float(arr.min()),
        "max": float(arr.max()),
        "median": float(np.percentile(arr, 50)),
        "p95": float(np.percentile(arr, 95)),
        "p99": float(np.percentile(arr, 99)),
    }
