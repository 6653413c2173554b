"""Device tracing (counterpart of ``device_trace`` in
pdf_table_tpu/utils/profiling.py): a ``torch.profiler`` trace of a block,
CPU and, on a card, CUDA activity, exported as Chrome trace JSON into a
directory. The rest of the JAX module (stage annotations, lane tracing,
the program registry) is ROADMAP.md Queue 1 item 14.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

from .logging_utils import logger


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace around a block, written to
    ``trace_dir/trace_<time>_<pid>.json``; a no-op when ``trace_dir`` is
    falsy."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(
            trace_dir,
            f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        logger.info("device trace written to %s", path)
