"""Training losses for multi-person pose.

Counterpart of ``centerpose_tpu/losses.py``, with its normalisations
copied exactly: the focal loss divides by the number of gaussian peaks
(with the reference's branch when there is none); the masked L1 losses
divide by (mask.sum + 1e-4); the joint regression L1 is weighted per
coordinate by ``hps_mask``.  Sigmoid outputs are clamped to
[1e-4, 1 - 1e-4] before the focal log terms.  Every reduction runs in
float32 whatever the model's compute dtype.  Maps are NHWC.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from centerpose_tpu_torch.ops.nms import gather_feat_hw


def sigmoid_clamped(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid in float32, clamped to [eps, 1 - eps]."""
    return torch.sigmoid(x).float().clamp(eps, 1.0 - eps)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss.  pred [B,H,W,C] probabilities
    (already clamped), gt gaussian targets with exactly 1.0 at peaks:
    -(sum (1-p)^2 log p at peaks + sum (1-gt)^4 p^2 log(1-p) elsewhere)
    / num_pos, or -neg_sum when there is no peak."""
    pred = pred.float()
    gt = gt.float()
    pos_mask = (gt == 1.0).float()
    neg_mask = 1.0 - pos_mask
    neg_weights = torch.pow(1.0 - gt, 4.0)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2.0) * pos_mask
    neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, 2.0) * neg_weights
                * neg_mask)
    num_pos = pos_mask.sum()
    pos_sum = pos_loss.sum()
    neg_sum = neg_loss.sum()
    return torch.where(num_pos > 0,
                       -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0),
                       -neg_sum)


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """Masked L1 at sparse object indices.  output [B,H,W,C], mask [B,K],
    ind [B,K], target [B,K,C]; the mask broadcasts over channels."""
    pred = gather_feat_hw(output, ind.long()).float()
    m = mask.float()[:, :, None].expand_as(pred)
    loss = (torch.abs(pred - target.float()) * m).sum()
    return loss / (m.sum() + 1e-4)


def reg_weighted_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                         ind: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Per-coordinate weighted L1 of the joint regression: mask [B,K,C]."""
    pred = gather_feat_hw(output, ind.long()).float()
    m = mask.float()
    loss = (torch.abs(pred - target.float()) * m).sum()
    return loss / (m.sum() + 1e-4)


def dense_reg_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """Dense variant of the joint regression loss (``loss.dense_hp``)."""
    m = mask.float()
    loss = (torch.abs(output.float() - target) * m).sum()
    return loss / (m.sum() + 1e-4)


def multi_pose_loss(outputs: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor],
                    cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss and per-head loss stats, from the raw head
    outputs (logits for hm/hm_hp, NHWC) and the encoded targets."""
    lc = cfg.loss
    hm_loss = focal_loss(sigmoid_clamped(outputs["hm"]), batch["hm"])
    if lc.dense_hp:
        hp_loss = dense_reg_l1_loss(outputs["hps"], batch["dense_hps_mask"],
                                    batch["dense_hps"])
    else:
        hp_loss = reg_weighted_l1_loss(outputs["hps"], batch["hps_mask"],
                                       batch["ind"], batch["hps"])
    wh_loss = reg_l1_loss(outputs["wh"], batch["reg_mask"], batch["ind"],
                          batch["wh"])
    zero = torch.zeros((), dtype=torch.float32, device=hm_loss.device)
    off_loss = hm_hp_loss = hp_offset_loss = zero
    if lc.reg_offset:
        off_loss = reg_l1_loss(outputs["reg"], batch["reg_mask"],
                               batch["ind"], batch["reg"])
    if lc.hm_hp:
        hm_hp_loss = focal_loss(sigmoid_clamped(outputs["hm_hp"]),
                                batch["hm_hp"])
    if lc.reg_hp_offset:
        hp_offset_loss = reg_l1_loss(outputs["hp_offset"], batch["hp_mask"],
                                     batch["hp_ind"], batch["hp_offset"])
    total = (lc.hm_weight * hm_loss + lc.wh_weight * wh_loss
             + lc.off_weight * off_loss + lc.hp_weight * hp_loss
             + lc.hm_hp_weight * hm_hp_loss + lc.off_weight * hp_offset_loss)
    stats = {"loss": total, "hm_loss": hm_loss, "hp_loss": hp_loss,
             "hm_hp_loss": hm_hp_loss, "wh_loss": wh_loss,
             "off_loss": off_loss, "hp_offset_loss": hp_offset_loss}
    return total, stats
