"""Evaluation (counterpart of pdf_table_tpu/eval): the WTW table-structure
metrics and TEDS."""

from .table_metric import TableWtwMetric, pair_match
from .teds import TEDS

__all__ = ["TableWtwMetric", "pair_match", "TEDS"]
