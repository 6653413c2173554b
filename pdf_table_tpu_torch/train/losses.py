"""Loss primitives of the LORE trainer (counterpart of
pdf_table_tpu/train/losses.py): the CenterNet focal loss and the masked L1
over gathered regression targets. The DBNet loss and the CTC loss belong
to trainers not ported yet."""

from __future__ import annotations

import torch


def focal_loss(pred: torch.Tensor, gt: torch.Tensor, alpha: float = 2.0,
               beta: float = 4.0, eps: float = 1e-6) -> torch.Tensor:
    """CenterNet focal loss on gaussian heatmaps: positives where ``gt`` is
    1, the rest weighted by ``(1 - gt) ** beta``, over the positive
    count (at least 1)."""
    pred = pred.clamp(eps, 1.0 - eps)
    pos = gt >= 1.0 - 1e-6
    neg_weights = torch.pow(1.0 - gt, beta)
    pos_loss = torch.log(pred) * torch.pow(1 - pred, alpha)
    neg_loss = torch.log(1 - pred) * torch.pow(pred, alpha) * neg_weights
    n_pos = pos.sum().to(pred.dtype).clamp_min(1.0)
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    return -(torch.where(pos, pos_loss, zero).sum()
             + torch.where(~pos, neg_loss, zero).sum()) / n_pos


def reg_l1_loss(pred: torch.Tensor, gt: torch.Tensor, ind_mask: torch.Tensor,
                eps: float = 1e-4) -> torch.Tensor:
    """L1 over gathered regression targets with a validity mask (one value
    a slot, or one an element)."""
    m = ind_mask[..., None] if ind_mask.dim() == pred.dim() - 1 else ind_mask
    return (torch.abs(pred - gt) * m).sum() / (m.sum() + eps)
