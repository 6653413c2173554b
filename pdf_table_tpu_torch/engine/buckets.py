"""Batch-size buckets shared by the tasks (as in
pdf_table_tpu/engine/infer_task.py): padded sub-batches keep the set of
shapes small while wasting less than 2x padding in the worst case."""

from __future__ import annotations

from typing import Sequence

BUCKET_SIZES = (1, 2, 4, 8, 16, 32, 64, 128)


def bucket_batch_size(n: int, buckets: Sequence[int] = BUCKET_SIZES) -> int:
    """The smallest bucket that holds ``n``; beyond the largest, the next
    multiple of it."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]
