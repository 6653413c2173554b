"""Training (counterpart of pdf_table_tpu/train/): the LORE trainer, the
DBNet quick trainer (``quick_det.py``), the losses (the LORE primitives,
the DB loss, ``ctc_loss``) and the train step."""

from .losses import ctc_loss, db_loss, focal_loss, reg_l1_loss
from .train_step import TrainState, make_train_step

__all__ = ["ctc_loss", "db_loss", "focal_loss", "reg_l1_loss", "TrainState",
           "make_train_step"]
