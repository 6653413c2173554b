"""LORE training loss (counterpart of pdf_table_tpu/train/lore_loss.py):
CenterNet focal on the heatmaps, L1 on the gathered wh / reg targets,
axis L1 over 4 * n_valid on the base and stacked logical predictions;
loss = hm + wh + 0.1 * off + 2 * ax (+ 2 * sax with stacking, + st with
the cycle-pairing loss).

Every term divides by a count over the batch. ``batch_sum`` (default: the
identity) is applied to each such count, so that in a data-parallel step
each process's loss is its rows' share of the global batch's loss
(train/train_step.py::dp_batch_sum)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .losses import _same, focal_loss


def gather_map_at(feat_map: torch.Tensor, ind: torch.Tensor
                  ) -> torch.Tensor:
    """feat_map (B, H, W, D), ind (B, M) into the flat H*W -> (B, M, D)."""
    B, H, W, D = feat_map.shape
    flat = feat_map.reshape(B, H * W, D)
    return torch.gather(flat, 1, ind[:, :, None].expand(-1, -1, D))


def reg_l1(feat_map: torch.Tensor, ind: torch.Tensor, mask: torch.Tensor,
           target: torch.Tensor, eps: float = 1e-4,
           batch_sum=_same) -> torch.Tensor:
    """L1 over the predictions gathered at ``ind``, masked by slot."""
    pred = gather_map_at(feat_map, ind)
    m = mask[:, :, None].expand(pred.shape).to(pred.dtype)
    return torch.abs(pred * m - target * m).sum() / (batch_sum(m.sum())
                                                     + eps)


def axis_loss(logi: torch.Tensor, mask: torch.Tensor, target: torch.Tensor,
              eps: float = 1e-4, batch_sum=_same) -> torch.Tensor:
    """L1 / (4 * n_valid)."""
    m = mask[:, :, None].to(logi.dtype)
    return torch.abs(logi * m - target * m).sum() \
        / (4 * (batch_sum(m.sum()) + eps))


def pair_loss(wh_map: torch.Tensor, st_map: torch.Tensor,
              batch: Dict[str, torch.Tensor],
              eps: float = 1e-4, batch_sum=_same) -> Dict[str, torch.Tensor]:
    """Cycle-pairing loss: wh (centre -> corner vectors at ``hm_ind``) and
    st (corner -> centre vectors at ``mk_ind``), each element weighted by
    ``1 - exp(-3.14 * min(delta^2, 1))`` with ``delta`` the relative
    consistency error, plus direct st supervision on the valid corner
    slots. ``ctr_cro_ind`` maps each cell corner to its corner slot."""
    pred1 = gather_map_at(wh_map, batch["hm_ind"])        # (B, M, 8)
    pred2 = gather_map_at(st_map, batch["mk_ind"])        # (B, 4M, 8)
    target1 = batch["wh"]
    target2 = batch["st"]
    B, M = batch["hm_ind"].shape
    mask = batch["hm_mask"][:, :, None].expand(pred1.shape).to(pred1.dtype)

    # per cell: the (dy, dx) each of its 4 corners predicts for it
    p2 = pred2.reshape(B, 4 * pred2.shape[1], 2)
    t2 = target2.reshape(B, 4 * target2.shape[1], 2)
    idx = batch["ctr_cro_ind"][:, :, None].long().expand(-1, -1, 2)
    p2g = torch.gather(p2, 1, idx).reshape(B, M, 8)
    t2g = torch.gather(t2, 1, idx).reshape(B, M, 8)

    delta = (torch.abs(pred1 - target1) + torch.abs(p2g - t2g)) \
        / (torch.abs(target1) + eps)
    delta = torch.clamp_max(delta * delta, 1.0)
    weight = 1.0 - torch.exp(-3.14 * delta)

    denom = batch_sum(mask.sum()) + eps
    loss1 = (torch.abs(pred1 - target1) * mask * weight).sum() / denom
    loss2 = (torch.abs(p2g - t2g) * mask * weight).sum() / denom
    m2 = batch["mk_mask"][:, :, None].expand(pred2.shape).to(pred2.dtype)
    loss3 = (torch.abs(pred2 - target2) * m2).sum() / denom
    return {"wh_l": loss1, "st_l": 0.5 * loss2 + 0.2 * loss3}


def lore_loss(outputs: Dict[str, Any], batch: Dict[str, torch.Tensor],
              hm_weight: float = 1.0, wh_weight: float = 1.0,
              off_weight: float = 0.1, wiz_stacking: bool = True,
              wiz_pairloss: bool = False,
              batch_sum=_same) -> Dict[str, torch.Tensor]:
    """outputs: ``LoreModel.train_forward``'s; batch targets: hm (B, H, W,
    2), hm_ind / hm_mask (B, M), wh (B, M, 8), reg (B, M, 2), logic (B, M,
    4); with ``wiz_pairloss`` also mk_ind / mk_mask / st / ctr_cro_ind,
    and with ``corner_reg_ind`` the corner offsets joined to the centre
    ones. Returns every term and ``loss``."""
    heads = outputs["heads"]
    hm = outputs["hm"]
    if wiz_pairloss and "mk_ind" in batch:
        # both channels supervised + cycle-pairing
        hm_l = focal_loss(hm, batch["hm"], batch_sum=batch_sum)
        pl = pair_loss(heads["wh"], heads["st"], batch, batch_sum=batch_sum)
        wh_l, st_l = pl["wh_l"], pl["st_l"]
    else:
        # the centre channel only
        hm_l = focal_loss(hm[..., 0], batch["hm"][..., 0],
                          batch_sum=batch_sum)
        wh_l = reg_l1(heads["wh"], batch["hm_ind"], batch["hm_mask"],
                      batch["wh"], batch_sum=batch_sum)
        st_l = None
    if "corner_reg_ind" in batch:
        # centres and corners share one reg vector of 5M slots,
        # normalized together
        pc = gather_map_at(heads["reg"], batch["hm_ind"])
        pk = gather_map_at(heads["reg"], batch["corner_reg_ind"])
        mc = batch["hm_mask"][:, :, None]
        mk = batch["corner_reg_mask"][:, :, None]
        num = (torch.abs(pc - batch["reg"]) * mc).sum() \
            + (torch.abs(pk - batch["corner_reg"]) * mk).sum()
        off_l = num / (batch_sum(mc.sum() * 2 + mk.sum() * 2) + 1e-4)
    else:
        off_l = reg_l1(heads["reg"], batch["hm_ind"], batch["hm_mask"],
                       batch["reg"], batch_sum=batch_sum)
    ax_l = axis_loss(outputs["logi"], batch["hm_mask"], batch["logic"],
                     batch_sum=batch_sum)
    total = hm_weight * hm_l + wh_weight * wh_l + off_weight * off_l \
        + 2.0 * ax_l
    losses = {"hm_l": hm_l, "wh_l": wh_l, "off_l": off_l, "ax_l": ax_l}
    if st_l is not None:
        total = total + st_l
        losses["st_l"] = st_l
    if wiz_stacking:
        sax_l = axis_loss(outputs["stacked_logi"], batch["hm_mask"],
                          batch["logic"], batch_sum=batch_sum)
        total = total + 2.0 * sax_l
        losses["sax_l"] = sax_l
    losses["loss"] = total
    return losses
