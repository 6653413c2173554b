"""Training (counterpart of pdf_table_tpu/train/): the LORE trainer, its
losses and the train step. The DBNet and recognizer losses are not ported
yet."""

from .losses import focal_loss, reg_l1_loss
from .train_step import TrainState, make_train_step

__all__ = ["focal_loss", "reg_l1_loss", "TrainState", "make_train_step"]
