"""Plain float32 reference of the training step: the compact wire's
decode, the forward in train mode (BatchNorm on the batch's statistics),
the CenterNet multi-pose loss, the backward by autograd (TF32 off), and
Adam.

``steps`` runs the first steps from the snapshot's weights on the given
batches and returns what the training check compares: each step's loss,
the norm of each leaf's first gradient, and the norm of each leaf's
change after the last step.  It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import judge, nets

GRAY = (0.299, 0.587, 0.114)
# loss weights (hm, wh, reg offset, joints, joint heatmaps, joint offset)
WEIGHTS = {"hm": 1.0, "wh": 0.1, "reg": 1.0, "hps": 1.0, "hm_hp": 1.0,
           "hp_offset": 1.0}
ADAM = {"lr": 1.25e-4, "b1": 0.9, "b2": 0.999, "eps": 1e-8}


def unpack(batch: Dict[str, np.ndarray], mean, std, device,
           dtype=torch.float32):
    """The wire's arrays as ``dtype`` tensors on ``device``: the uint8 image
    scaled to [0, 1], its colour augmentation replayed from ``aug``
    (``A x + c_gs gs + c_mean mean(gs) + pca``, gs the image's greyscale)
    and normalised; float16 targets widened."""
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in batch.items()}
    x = b.pop("input").to(dtype) / 255.0
    aug = b.pop("aug").to(dtype)
    gs = x @ torch.tensor(GRAY, device=device, dtype=dtype)
    gm = gs.mean((1, 2))
    x = (aug[:, 0, None, None, None] * x
         + aug[:, 1, None, None, None] * gs[..., None]
         + aug[:, 2, None, None, None] * gm[:, None, None, None]
         + aug[:, None, None, 3:6])
    b["input"] = (x - torch.tensor(mean, device=device, dtype=dtype)) \
        / torch.tensor(std, device=device, dtype=dtype)
    for k, v in b.items():
        if v.dtype == torch.float16:
            b[k] = v.to(dtype)
    return b


def _focal(pred, gt):
    pos = (gt == 1.0).float()
    pos_loss = (torch.log(pred) * (1 - pred) ** 2 * pos).sum()
    neg_loss = (torch.log(1 - pred) * pred ** 2 * (1 - gt) ** 4
                * (1 - pos)).sum()
    n = pos.sum()
    return torch.where(n > 0, -(pos_loss + neg_loss) / n.clamp_min(1.0),
                       -neg_loss)


def _gather(m, ind):
    n, h, w, c = m.shape
    return torch.gather(m.reshape(n, h * w, c), 1,
                        ind.long()[..., None].expand(-1, -1, c))


def _l1(pred, mask, target):
    return (torch.abs(pred - target) * mask).sum() / (mask.sum() + 1e-4)


def loss(out: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    """The weighted multi-pose loss of head logits ``out`` against the
    targets ``b``: focal losses on the clamped-sigmoid heatmaps, masked L1
    on the joints, sizes and offsets at their sparse indices."""
    sig = {k: torch.sigmoid(out[k]).clamp(1e-4, 1 - 1e-4)
           for k in ("hm", "hm_hp")}
    rm = b["reg_mask"][..., None]
    terms = {
        "hm": _focal(sig["hm"], b["hm"]),
        "hm_hp": _focal(sig["hm_hp"], b["hm_hp"]),
        "hps": _l1(_gather(out["hps"], b["ind"]), b["hps_mask"], b["hps"]),
        "wh": _l1(_gather(out["wh"], b["ind"]), rm.expand(-1, -1, 2),
                  b["wh"]),
        "reg": _l1(_gather(out["reg"], b["ind"]), rm.expand(-1, -1, 2),
                   b["reg"]),
        "hp_offset": _l1(_gather(out["hp_offset"], b["hp_ind"]),
                         b["hp_mask"][..., None].expand(-1, -1, 2),
                         b["hp_offset"]),
    }
    return sum(WEIGHTS[k] * v for k, v in terms.items())


def steps(cfg: dict, snapshot: str, batches: Sequence[Dict[str, np.ndarray]],
          device, numerics: str = "f32", dtype=torch.float32) -> dict:
    """``len(batches)`` training steps from the snapshot: {"loss": [per
    step], "grad": {leaf: norm of its first gradient}, "delta": {leaf:
    norm of its change after the last step}}; leaves by snapshot key.
    A leaf no loss term reaches gets no gradient and no update.
    ``dtype``: float32, or float64 to read how far float32's rounding
    alone moves these numbers."""
    p = nets.Params(snapshot, device, trainable=True, dtype=dtype)
    nx = nets.Numerics(numerics, train=True)
    leaves = p.leaves()
    start = {k: v.detach().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    out: dict = {"loss": [], "grad": {}, "delta": {}}
    lr, b1, b2, eps = ADAM["lr"], ADAM["b1"], ADAM["b2"], ADAM["eps"]
    for t, batch in enumerate(batches, 1):
        b = unpack(batch, cfg["mean"], cfg["std"], device, dtype)
        with nets.tf32(False):
            heads = nets.forward(cfg["arch"], nx, p, b["input"],
                                 judge.HEADS, cfg["dcn_r"])
            total = loss(heads, b)
            grads = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        out["loss"].append(float(total.detach()))
        del heads, total, b
        with torch.no_grad():
            for (k, leaf), g in zip(leaves.items(), grads):
                if g is None:
                    continue
                if t == 1:
                    out["grad"][k] = float(g.norm())
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k] / (1 - b2 ** t)).sqrt().add_(eps)
                leaf.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        del grads
    with torch.no_grad():
        for k, leaf in leaves.items():
            out["delta"][k] = float((leaf - start[k]).norm())
    return out


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keys: List[str], floor: float) -> float:
    """max over ``keys`` of |prog - ref| / max(ref, ``floor``): the gap
    between the two norms of the worst leaf, against the leaf's reference
    norm or ``floor`` (the median leaf's) where that is larger; 0 where
    ``keys`` is empty (a network with no DCN site)."""
    return max((abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys),
               default=0.0)
