"""Time helpers (counterpart of pdf_table_tpu/utils/time_utils.py)."""

from __future__ import annotations

import time
from datetime import datetime


class TimeUtils:

    @staticmethod
    def now() -> float:
        return time.time()

    @staticmethod
    def now_str(fmt: str = "%Y-%m-%d %H:%M:%S") -> str:
        return datetime.now().strftime(fmt)

    @staticmethod
    def now_tag(fmt: str = "%Y%m%d_%H%M%S") -> str:
        return datetime.now().strftime(fmt)

    @staticmethod
    def elapsed_ms(start: float) -> float:
        return (time.time() - start) * 1000.0
