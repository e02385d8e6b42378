"""Multi-pose decode, counterpart of ``centerpose_tpu/ops/decode.py``:
3x3 max-pool NMS -> top-K centers -> gather joints / offsets / sizes ->
snap each regressed joint to the nearest confident joint-heatmap peak inside
the person box.  Fixed shapes, on the device of its inputs.

Output: [B, K, 40] = bbox(4) + score(1) + joints(2J) + class(1), in
output-grid units.
"""

from __future__ import annotations

from typing import Optional

import torch

from centerpose_tpu_torch.ops.nms import (gather_feat_hw, heat_nms, topk,
                                          topk_channel)


def multi_pose_decode(heat: torch.Tensor, wh: torch.Tensor, kps: torch.Tensor,
                      reg: Optional[torch.Tensor] = None,
                      hm_hp: Optional[torch.Tensor] = None,
                      hp_offset: Optional[torch.Tensor] = None,
                      k: int = 100, hm_hp_thresh: float = 0.1) -> torch.Tensor:
    """All inputs NHWC: heat [B,H,W,1] (sigmoid-ed), wh [B,H,W,2],
    kps [B,H,W,2J] (x, y per joint), reg [B,H,W,2], hm_hp [B,H,W,J]
    (sigmoid-ed), hp_offset [B,H,W,2]."""
    num_joints = kps.shape[-1] // 2
    heat = heat_nms(heat)
    scores, inds, clses, ys, xs = topk(heat, k)

    kps = gather_feat_hw(kps, inds).clone()  # [B, K, 2J]
    kps[..., 0::2] += xs[:, :, None]
    kps[..., 1::2] += ys[:, :, None]

    if reg is not None:
        r = gather_feat_hw(reg, inds)
        xs = xs + r[..., 0]
        ys = ys + r[..., 1]
    else:
        xs = xs + 0.5
        ys = ys + 0.5

    whk = gather_feat_hw(wh, inds)
    bboxes = torch.stack([xs - whk[..., 0] / 2, ys - whk[..., 1] / 2,
                          xs + whk[..., 0] / 2, ys + whk[..., 1] / 2], dim=2)

    if hm_hp is not None:
        kps = _snap_to_peaks(kps, bboxes, hm_hp, hp_offset, k, num_joints,
                             hm_hp_thresh)
    return torch.cat([bboxes, scores[:, :, None], kps,
                      clses.float()[:, :, None]], dim=2)


def _snap_to_peaks(kps, bboxes, hm_hp, hp_offset, k, num_joints, thresh):
    """Replace regressed joints by nearby confident hm_hp peaks."""
    b = kps.shape[0]
    kps_j = kps.reshape(b, k, num_joints, 2).permute(0, 2, 1, 3)  # [B,J,K,2]

    hm_hp = heat_nms(hm_hp)
    hm_score, hm_inds, hm_ys, hm_xs = topk_channel(hm_hp, k)  # [B, J, K]
    if hp_offset is not None:
        off = gather_feat_hw(hp_offset, hm_inds.reshape(b, num_joints * k))
        off = off.reshape(b, num_joints, k, 2)
        hm_xs = hm_xs + off[..., 0]
        hm_ys = hm_ys + off[..., 1]
    else:
        hm_xs = hm_xs + 0.5
        hm_ys = hm_ys + 0.5

    # Low-score peaks become unmatchable (-10000 sentinel).
    conf = (hm_score > thresh).float()
    hm_score = (1.0 - conf) * -1.0 + conf * hm_score
    hm_xs = (1.0 - conf) * -10000.0 + conf * hm_xs
    hm_ys = (1.0 - conf) * -10000.0 + conf * hm_ys
    hm_kps = torch.stack([hm_xs, hm_ys], dim=-1)  # [B, J, K, 2]

    diff = kps_j[:, :, :, None, :] - hm_kps[:, :, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # [B, J, K, K]
    min_dist, min_ind = torch.min(dist, dim=3)

    sel_score = torch.gather(hm_score, 2, min_ind)[..., None]
    sel_kps = torch.gather(hm_kps, 2, min_ind[..., None].expand(-1, -1, -1, 2))
    min_dist_e = min_dist[..., None]

    l = bboxes[:, None, :, 0:1]
    t = bboxes[:, None, :, 1:2]
    r = bboxes[:, None, :, 2:3]
    d = bboxes[:, None, :, 3:4]
    reject = ((sel_kps[..., 0:1] < l) | (sel_kps[..., 0:1] > r)
              | (sel_kps[..., 1:2] < t) | (sel_kps[..., 1:2] > d)
              | (sel_score < thresh)
              | (min_dist_e > 0.3 * torch.maximum(d - t, r - l)))
    snapped = torch.where(reject, kps_j, sel_kps)  # [B, J, K, 2]
    return snapped.permute(0, 2, 1, 3).reshape(b, k, num_joints * 2)
