"""Loss primitives (counterpart of pdf_table_tpu/train/losses.py).

* :func:`db_loss`: balanced BCE on the prob map + L1 on the threshold map
  + dice on the approximate binary map, the DBNet quick trainer's loss
  (train/quick_det.py);
* :func:`ctc_loss`: the recognizers' CTC loss, batch mean;
* :func:`focal_loss` / :func:`reg_l1_loss`: the CenterNet primitives of the
  LORE loss (train/lore_loss.py).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def balanced_bce(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 negative_ratio: float = 3.0, eps: float = 1e-6
                 ) -> torch.Tensor:
    """OHEM-balanced BCE: every positive plus the hardest ``n_neg``
    negatives, ``n_neg = min(#neg, int32(negative_ratio * n_pos))``
    (truncated, in f32), over ``n_pos + n_neg`` (at least 1). The
    negatives are chosen as JAX does, by a descending sort of the masked
    losses and a rank mask, so the count never leaves the device; only the
    chosen negatives get a gradient."""
    pred = pred.clamp(eps, 1.0 - eps)
    bce = -(gt * torch.log(pred) + (1 - gt) * torch.log(1 - pred))
    pos = (gt > 0.5) & (mask > 0.5)
    neg = (gt <= 0.5) & (mask > 0.5)
    n_pos = pos.sum()
    n_neg = torch.minimum(
        neg.sum(), (negative_ratio * n_pos.float()).to(torch.int32))
    zero = torch.zeros((), dtype=bce.dtype, device=bce.device)
    pos_loss = torch.where(pos, bce, zero).sum()
    neg_losses = torch.where(neg, bce, torch.full_like(bce, -torch.inf))
    sorted_neg = torch.sort(neg_losses.reshape(-1), descending=True).values
    ranks = torch.arange(sorted_neg.shape[0], device=bce.device)
    keep = (ranks < n_neg) & torch.isfinite(sorted_neg)
    neg_loss = torch.where(keep, sorted_neg, zero).sum()
    denom = torch.clamp_min(n_pos + n_neg, 1).to(pred.dtype)
    return (pos_loss + neg_loss) / denom


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    inter = (pred * gt * mask).sum()
    union = (pred * mask).sum() + (gt * mask).sum() + eps
    return 1.0 - 2.0 * inter / union


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    return (torch.abs(pred - gt) * mask).sum() / (mask.sum() + eps)


def db_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            l1_scale: float = 10.0, bce_scale: float = 5.0
            ) -> Dict[str, torch.Tensor]:
    """outputs: {"prob", "thresh", "binary"}; batch: {"gt", "gt_mask",
    "thresh_map", "thresh_mask"}, all (B, H, W)."""
    bce = balanced_bce(outputs["prob"], batch["gt"], batch["gt_mask"])
    l1 = masked_l1(outputs["thresh"], batch["thresh_map"],
                   batch["thresh_mask"])
    dice = dice_loss(outputs["binary"], batch["gt"], batch["gt_mask"])
    total = dice + l1_scale * l1 + bce_scale * bce
    return {"loss": total, "bce": bce, "l1": l1, "dice": dice}


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0
             ) -> torch.Tensor:
    """Mean CTC loss over the batch, as ``optax.ctc_loss`` computes it:
    ``logits`` (B, T, C) go through ``log_softmax`` here; ``labels`` (B, S)
    with ``label_paddings`` (B, S), 1.0 marking padding; each sequence's
    negative log-likelihood is not divided by its label length.

    An infeasible alignment (T shorter than the labels with the blanks
    their repeats need) costs ``inf`` here, and so does the batch mean;
    optax stays finite there (its log-epsilon is -1e5)."""
    B, T, _ = logits.shape
    logp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    target_lengths = (1 - label_paddings).sum(dim=1).round().long()
    input_lengths = torch.full((B,), T, dtype=torch.long,
                               device=logits.device)
    per = F.ctc_loss(logp, labels.long(), input_lengths, target_lengths,
                     blank=blank_id, reduction="none")
    return per.mean()


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def focal_loss(pred: torch.Tensor, gt: torch.Tensor, alpha: float = 2.0,
               beta: float = 4.0, eps: float = 1e-6,
               batch_sum=_same) -> torch.Tensor:
    """CenterNet focal loss on gaussian heatmaps: positives where ``gt`` is
    1, the rest weighted by ``(1 - gt) ** beta``, over the positive
    count (at least 1). ``batch_sum`` makes the count the global batch's
    (train/train_step.py::dp_batch_sum)."""
    pred = pred.clamp(eps, 1.0 - eps)
    pos = gt >= 1.0 - 1e-6
    neg_weights = torch.pow(1.0 - gt, beta)
    pos_loss = torch.log(pred) * torch.pow(1 - pred, alpha)
    neg_loss = torch.log(1 - pred) * torch.pow(pred, alpha) * neg_weights
    n_pos = batch_sum(pos.sum().to(pred.dtype)).clamp_min(1.0)
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    return -(torch.where(pos, pos_loss, zero).sum()
             + torch.where(~pos, neg_loss, zero).sum()) / n_pos


def reg_l1_loss(pred: torch.Tensor, gt: torch.Tensor, ind_mask: torch.Tensor,
                eps: float = 1e-4) -> torch.Tensor:
    """L1 over gathered regression targets with a validity mask (one value
    a slot, or one an element)."""
    m = ind_mask[..., None] if ind_mask.dim() == pred.dim() - 1 else ind_mask
    return (torch.abs(pred - gt) * m).sum() / (m.sum() + eps)
