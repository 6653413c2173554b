"""Latency statistics (counterpart of pdf_table_tpu/utils/benchmark_utils.py):
mean, sd, min, max, median, p95, p99 and count of a list of milliseconds,
in the reference's ``print_timings`` schema, and a context manager that
times its body."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

import numpy as np

from .logging_utils import logger


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


def print_timings(name: str, timings: List[float]) -> Dict[str, float]:
    """``timings`` in seconds; logs their statistics in ms and returns
    them."""
    st = timing_stats([t * 1000.0 for t in timings])
    logger.info(
        "[%s] n=%d mean=%.2fms sd=%.2f min=%.2f max=%.2f median=%.2f "
        "p95=%.2f p99=%.2f", name, int(st["count"]), st["mean"], st["sd"],
        st["min"], st["max"], st["median"], st["p95"], st["p99"])
    return st


@contextmanager
def track_infer_time(buffer: List[float]):
    """Append the elapsed wall-clock seconds of the body to ``buffer``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        buffer.append(time.perf_counter() - start)
