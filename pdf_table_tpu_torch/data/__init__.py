"""Datasets and target generation (counterpart of pdf_table_tpu/data/)."""

from .det_targets import make_db_targets
from .wtw import WtwDataset, draw_gaussian, gaussian_radius, make_lore_targets

__all__ = ["WtwDataset", "gaussian_radius", "draw_gaussian",
           "make_lore_targets", "make_db_targets"]
