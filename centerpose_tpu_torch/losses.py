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
from centerpose_tpu_torch.parallel.mesh import all_reduce_sum, group_size


def sigmoid_clamped(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid in float32, clamped to [eps, 1 - eps]."""
    return torch.sigmoid(x).float().clamp(eps, 1.0 - eps)


def _focal_parts(pred: torch.Tensor, gt: torch.Tensor):
    """(sum of the peak terms, sum of the other terms, peak count) of the
    focal loss, each a float32 scalar."""
    pred = pred.float()
    gt = gt.float()
    pos_mask = (gt == 1.0).float()
    neg_mask = 1.0 - pos_mask
    neg_weights = torch.pow(1.0 - gt, 4.0)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2.0) * pos_mask
    neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, 2.0) * neg_weights
                * neg_mask)
    return pos_loss.sum(), neg_loss.sum(), pos_mask.sum()


def _focal(pos_sum, neg_sum, num_pos):
    return torch.where(num_pos > 0,
                       -(pos_sum + neg_sum) / torch.clamp(num_pos, min=1.0),
                       -neg_sum)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss.  pred [B,H,W,C] probabilities
    (already clamped), gt gaussian targets with exactly 1.0 at peaks:
    -(sum (1-p)^2 log p at peaks + sum (1-gt)^4 p^2 log(1-p) elsewhere)
    / num_pos, or -neg_sum when there is no peak."""
    return _focal(*_focal_parts(pred, gt))


def _l1_parts(pred: torch.Tensor, mask: torch.Tensor,
              target: torch.Tensor):
    """(masked L1 sum, mask sum) of ``pred`` against ``target``."""
    m = mask.float()
    return (torch.abs(pred.float() - target.float()) * m).sum(), m.sum()


def _l1(loss_sum, mask_sum):
    return loss_sum / (mask_sum + 1e-4)


def _reg_parts(output, mask, ind, target):
    """``_l1_parts`` at sparse object indices, the mask [B,K] broadcast
    over channels."""
    pred = gather_feat_hw(output, ind.long())
    return _l1_parts(pred, mask.float()[:, :, None].expand_as(pred), target)


def reg_l1_loss(output: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """Masked L1 at sparse object indices.  output [B,H,W,C], mask [B,K],
    ind [B,K], target [B,K,C]; the mask broadcasts over channels."""
    return _l1(*_reg_parts(output, mask, ind, target))


def reg_weighted_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                         ind: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    """Per-coordinate weighted L1 of the joint regression: mask [B,K,C]."""
    return _l1(*_l1_parts(gather_feat_hw(output, ind.long()), mask, target))


def dense_reg_l1_loss(output: torch.Tensor, mask: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """Dense variant of the joint regression loss (``loss.dense_hp``)."""
    return _l1(*_l1_parts(output, mask, target))


# the loss terms and their weights (attributes of cfg.loss), in the order
# the total adds them (hp_offset_loss weighted by off_weight, as the
# reference's), and the terms in the order of the stats
_TERMS = (("hm_loss", "hm_weight"), ("wh_loss", "wh_weight"),
          ("off_loss", "off_weight"), ("hp_loss", "hp_weight"),
          ("hm_hp_loss", "hm_hp_weight"), ("hp_offset_loss", "off_weight"))
_STATS = ("hm_loss", "hp_loss", "hm_hp_loss", "wh_loss", "off_loss",
          "hp_offset_loss")


def _loss_parts(outputs, batch, cfg) -> Dict[str, tuple]:
    """Each enabled term's sums: (peak sum, other sum, peak count) for the
    focal terms, (L1 sum, mask sum) for the L1 terms."""
    lc = cfg.loss
    parts = {"hm_loss": _focal_parts(sigmoid_clamped(outputs["hm"]),
                                     batch["hm"])}
    if lc.dense_hp:
        parts["hp_loss"] = _l1_parts(outputs["hps"], batch["dense_hps_mask"],
                                     batch["dense_hps"])
    else:
        parts["hp_loss"] = _l1_parts(
            gather_feat_hw(outputs["hps"], batch["ind"].long()),
            batch["hps_mask"], batch["hps"])
    if lc.hm_hp:
        parts["hm_hp_loss"] = _focal_parts(sigmoid_clamped(outputs["hm_hp"]),
                                           batch["hm_hp"])
    parts["wh_loss"] = _reg_parts(outputs["wh"], batch["reg_mask"],
                                  batch["ind"], batch["wh"])
    if lc.reg_offset:
        parts["off_loss"] = _reg_parts(outputs["reg"], batch["reg_mask"],
                                       batch["ind"], batch["reg"])
    if lc.reg_hp_offset:
        parts["hp_offset_loss"] = _reg_parts(
            outputs["hp_offset"], batch["hp_mask"], batch["hp_ind"],
            batch["hp_offset"])
    return parts


def _term(part):
    return _focal(*part) if len(part) == 3 else _l1(*part)


def multi_pose_loss(outputs: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor],
                    cfg, group=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total weighted loss and per-head loss stats, from the raw head
    outputs (logits for hm/hm_hp, NHWC) and the encoded targets.

    ``group``: a process group whose ranks each hold a shard of the batch
    (data-parallel training), or None.  Its loss is then the global
    batch's, as the reference's one SPMD step computes it: the sums of
    every term, the normalizers among them, are all-reduced at once (one
    float32 tensor, no gradient), so each term divides by its global peak
    count or mask sum and the focal terms take the no-peak branch on the
    global count.  The stats are the global loss and terms, the same on
    every rank.  The loss returned for the backward is this rank's share
    scaled by the world size W, ``W * (this rank's sums) / (global
    normalizer)``: the ranks' mean of it is the global loss, so the
    data-parallel average of the ranks' gradients is its gradient."""
    lc = cfg.loss
    parts = _loss_parts(outputs, batch, cfg)
    device = parts["hm_loss"][0].device
    zero = torch.zeros((), dtype=torch.float32, device=device)
    world = group_size(group)
    if world == 1:
        terms = own = {k: _term(p) for k, p in parts.items()}
    else:
        with torch.no_grad():
            flat = all_reduce_sum(torch.stack(
                [t.detach() for p in parts.values() for t in p]), group)
        terms, own, i = {}, {}, 0
        for k, p in parts.items():
            g = flat[i:i + len(p)]
            i += len(p)
            terms[k] = _term(g.unbind())
            # the normalizers global, the numerators this rank's
            own[k] = world * (_focal(p[0], p[1], g[2]) if len(p) == 3
                              else _l1(p[0], g[1]))
    terms = {k: terms.get(k, zero) for k, _ in _TERMS}
    own = {k: own.get(k, zero) for k, _ in _TERMS}

    def weighted(t):
        return sum(getattr(lc, w) * t[k] for k, w in _TERMS)

    total = weighted(own)
    stats = {"loss": total if world == 1 else weighted(terms).detach(),
             **{k: terms[k] for k in _STATS}}
    return total, stats
