"""The serving check: each row the program served, judged by the reference.

The program serves, per frame, K rows of 40 numbers in output-grid units:
box (x1, y1, x2, y2), score, 17 joints (x, y), class.  The rows are the
decode of the network's heads: the 3x3 max-pool NMS of the centre
heatmap, its top K cells by score, at each cell the box from the
regressed offset and size, and each joint the cell plus its regressed
displacement or, where a confident keypoint-heatmap peak lies near it
inside the box, that peak's cell plus its own regressed offset.

The reference computes the same heads in float32 (``nets.py``) from the
same frames and weights (``serve_maps``: normalisation, the optional flip
test and its merge, the clamped sigmoid) and reads each served row back:
it finds the cell whose reference centre and score lie nearest the
row's, and measures how far the row lies from what the reference says
at that cell.  A row is not matched against the reference's own top K by
rank: two peaks a rounding apart may change places in a ranking.  Which
cells were served is judged apart (``peak``, ``missed``, ``order``).

``tie`` is the cell's limits on ``score``, ``box`` and ``joint``: two
readings that lie within them are a tie that rounding may break either
way (which cell of a ridge is the maximum, whether a joint at the edge
of its box snaps to a peak).

``gaps`` returns, over all the rows given (grid units, scores absolute):

* ``score``: |served score - reference heatmap at the row's cell|, or
  |served score| where that is less (a cell the NMS suppressed serves 0);
* ``box``: the largest |served - reference| box coordinate there, over 1
  plus the reference box's longer side (the regressed size rounds in
  proportion to itself);
* ``joint``: the largest distance (max-norm) from a served joint to where
  the reference's decode puts it at the row's cell: its regressed joint
  (the distance over 1 plus the displacement's size), or, where the
  reference snaps it, the peak it snaps to (a cell of that peak's ridge
  that scores within the tie, at the reference's offset); where the
  reference's choice is a tie, the nearer of the two;
* ``peak``: over the rows that score above the tie, the largest amount by
  which the reference's 3x3 maximum around the row's cell exceeds the
  reference heatmap at the cell: every served row sits at a local maximum;
* ``missed``: over the reference's local maxima of each frame, the largest
  shortfall of the best served score on a maximum's ridge (the cells
  joined to it through cells that score within the tie of it) below the
  maximum's score, or of the frame's lowest served score where that is
  less: every peak that scores above a served row is served;
* ``order``: the largest rise of the served scores from one row to the
  next (the rows come in descending order of score);
* ``label``: the largest |class| (the one class is 0).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import nets

# joint pairs that swap under a horizontal flip (COCO order)
FLIP_IDX = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
            (15, 16))
SIGMOID_EPS = 1e-4
# a keypoint-heatmap peak above this score may take a joint (the decode's
# hm_hp_thresh)
HP_THRESH = 0.1
HEADS = {"hm": 1, "wh": 2, "hps": 34, "reg": 2, "hm_hp": 17, "hp_offset": 2}


def _perm(n: int):
    perm = list(range(n))
    for a, b in FLIP_IDX:
        perm[a], perm[b] = perm[b], perm[a]
    return perm


def _sig(x):
    return torch.sigmoid(x).clamp(SIGMOID_EPS, 1.0 - SIGMOID_EPS)


def serve_maps(cfg: Dict, nx: nets.Numerics, p: nets.Params,
               frames: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The merged head maps [N, H, W, C] of uint8 NHWC ``frames`` on the
    device, for the configuration file ``cfg``: normalised by its
    ``mean`` and ``std``, flipped and merged where ``flip_test`` is set,
    the two heatmaps through the clamped sigmoid."""
    mean = torch.tensor(cfg["mean"], device=frames.device)
    std = torch.tensor(cfg["std"], device=frames.device)
    x = (frames.float() / 255.0 - mean) / std
    flip = cfg["flip_test"]
    if flip:
        x = torch.cat([x, x.flip(2)], 0)
    out = nets.forward(cfg["arch"], nx, p, x, HEADS, cfg["dcn_r"])
    hm, hm_hp = _sig(out["hm"]), _sig(out["hm_hp"])
    wh, hps = out["wh"], out["hps"]
    reg, hp_off = out["reg"], out["hp_offset"]
    if flip:
        n = frames.shape[0]
        hm = (hm[:n] + hm[n:].flip(2)) / 2
        wh = (wh[:n] + wh[n:].flip(2)) / 2
        f = hps[n:].flip(2)
        f = f.reshape(*f.shape[:3], 17, 2).clone()
        f[..., 0] *= -1
        hps = (hps[:n] + f[:, :, :, _perm(17)].reshape(hps[n:].shape)) / 2
        hm_hp = (hm_hp[:n] + hm_hp[n:].flip(2)[..., _perm(17)]) / 2
        reg, hp_off = reg[:n], hp_off[:n]
    return {"hm": hm, "wh": wh, "hps": hps, "reg": reg, "hm_hp": hm_hp,
            "hp_offset": hp_off}


def _at(m: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """m [N, H, W, C] at cells (iy, ix) [N, ...] -> [N, ..., C]."""
    n, h, w, c = m.shape
    flat = m.reshape(n, h * w, c)
    idx = (iy * w + ix).reshape(n, -1)
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
    return out.reshape(*iy.shape, c)


def _cells(v: torch.Tensor, size: int):
    """The candidate cells floor(v) - 2 .. floor(v) + 1 of coordinates v,
    clipped to the grid: [..., 4]."""
    base = torch.floor(v).long()[..., None] + torch.arange(-2, 2,
                                                           device=v.device)
    return base.clamp(0, size - 1)


def _score_gap(served: torch.Tensor, heat: torch.Tensor) -> torch.Tensor:
    """How far a served score lies from the reference's heatmap at its
    cell, or from 0: the decode serves a cell that is no local maximum
    with score 0 (the max-pool NMS zeroes it) where fewer than K cells
    are maxima; which cell is a maximum ``peak`` and ``missed`` judge."""
    return torch.minimum((served - heat).abs(), served.abs())


def gaps(rows: torch.Tensor, maps: Dict[str, torch.Tensor],
         tie: Dict[str, float], detail: Dict | None = None
         ) -> Dict[str, float]:
    """The gaps of served ``rows`` [N, K, 40] (float32, on the maps'
    device) from the reference's ``maps`` of the same frames, with the
    cell's limits ``tie``.  ``detail``: a dict that receives where the
    widest ``missed`` and ``joint`` gaps lie."""
    n, k, _ = rows.shape
    hm = maps["hm"]
    _, h, w, _ = hm.shape
    bad = ~torch.isfinite(rows)
    rows = torch.nan_to_num(rows, nan=1e9, posinf=1e9, neginf=-1e9)
    x1, y1, x2, y2 = rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    # the cell whose reference centre and score lie nearest the row's
    # (two cells may regress one centre; their scores tell them apart)
    iy = _cells(cy, h)[..., :, None].expand(n, k, 4, 4)
    ix = _cells(cx, w)[..., None, :].expand(n, k, 4, 4)
    reg = _at(maps["reg"], iy, ix)
    dist = torch.maximum((cx[..., None, None] - ix - reg[..., 0]).abs(),
                         (cy[..., None, None] - iy - reg[..., 1]).abs())
    dist = dist + _score_gap(rows[..., 4, None, None], _at(hm, iy, ix)[..., 0])
    best = dist.reshape(n, k, 16).argmin(-1, keepdim=True)
    iy = iy.reshape(n, k, 16).gather(2, best)[..., 0]
    ix = ix.reshape(n, k, 16).gather(2, best)[..., 0]
    score = _at(hm, iy, ix)[..., 0]
    wh = _at(maps["wh"], iy, ix)
    rg = _at(maps["reg"], iy, ix)
    rcx, rcy = ix + rg[..., 0], iy + rg[..., 1]
    ref_box = torch.stack([rcx - wh[..., 0] / 2, rcy - wh[..., 1] / 2,
                           rcx + wh[..., 0] / 2, rcy + wh[..., 1] / 2], -1)
    kps = rows[..., 5:39].reshape(n, k, 17, 2)
    d_joint = _joint_gaps(kps, maps, iy, ix, ref_box, tie, detail)
    # selection: every row that scores above the tie sits at a reference
    # local maximum, up to a tie
    hmax = _maxpool(hm)
    peak = torch.where(rows[..., 4] > tie["score"],
                       _at(hmax, iy, ix)[..., 0] - score, 0.0)
    # missed peaks: each reference maximum has to be served by a row on its
    # ridge that scores as high.  The program's heat lies within the score
    # tie of the reference's, so the cells that the program's NMS climbs
    # through from the reference's peak to its own maximum all score within
    # the tie of the peak in the reference: its row lies on the ridge.  A
    # peak with no such row counts by how far it scores above the best row
    # on its ridge, or above the frame's lowest served score where that is
    # less.
    floor = rows[..., 4].amin(1, keepdim=True)
    peaks = _nms(hm).reshape(n, h * w)
    p_score, p_ind = torch.topk(peaks, min(2 * k, h * w), dim=1)
    # a peak at or under the frame's lowest served score is owed no row
    keep = max(int((p_score > floor).sum(1).max()), 1)
    p_score, p_ind = p_score[:, :keep], p_ind[:, :keep]
    py, px = p_ind // w, p_ind % w
    ridge = _ridges(hm[..., 0], p_ind, p_score - tie["score"])
    on = ridge.reshape(n, -1, h * w).gather(
        2, (iy * w + ix)[:, None, :].expand(-1, p_ind.shape[1], -1))
    best = torch.where(on, rows[:, None, :, 4],
                       torch.full_like(on, -1.0, dtype=rows.dtype))
    missed = torch.minimum(p_score - best.amax(-1),
                           p_score - floor).clamp_min(0.0)
    if detail is not None:
        i = int(missed.argmax())
        f, j = divmod(i, missed.shape[1])
        cheb = torch.maximum((py[f, j] - iy[f]).abs(), (px[f, j] - ix[f]).abs())
        r = int(cheb.argmin())
        detail.update(frame=f, peak=(int(py[f, j]), int(px[f, j])),
                      peak_score=float(p_score[f, j]), floor=float(floor[f]),
                      nearest_row=r, nearest_cells=int(cheb[r]),
                      nearest_cell=(int(iy[f, r]), int(ix[f, r])),
                      nearest_score=float(rows[f, r, 4]))
    # box sizes and coordinates round in proportion to the box's size
    size = 1 + wh.abs().amax(-1, keepdim=True)
    out = {"score": _score_gap(rows[..., 4], score).amax(),
           "box": ((rows[..., :4] - ref_box).abs() / size).amax(),
           "joint": d_joint.amax(),
           "peak": peak.amax(),
           "missed": missed.amax(),
           "order": (rows[:, 1:, 4] - rows[:, :-1, 4]).clamp_min(0.0).amax(),
           "label": rows[..., 39].abs().amax()}
    res = {name: float(v) for name, v in out.items()}
    if bool(bad.any()):
        res = {name: float("inf") for name in res}
    return res


def _ridges(hm: torch.Tensor, ind: torch.Tensor, low: torch.Tensor
            ) -> torch.Tensor:
    """[N, P, H, W]: for each peak ``ind`` [N, P] (flat cells) of the maps
    hm [N, H, W], the cells joined to it through cells (8-neighbours) that
    score at least its ``low`` [N, P]."""
    n, h, w = hm.shape
    p = ind.shape[1]
    above = (hm[:, None] >= low[..., None, None]).float()
    m = torch.zeros(n, p, h * w, dtype=hm.dtype, device=hm.device)
    m.scatter_(2, ind[..., None], 1.0)
    m = m.reshape(n, p, h, w)
    for _ in range(h * w):
        grown = F.max_pool2d(m.reshape(n * p, 1, h, w), 3, 1, 1).reshape(
            n, p, h, w) * above
        if torch.equal(grown, m):
            break
        m = grown
    return m > 0


def _joint_gaps(kps: torch.Tensor, maps: Dict[str, torch.Tensor],
                iy: torch.Tensor, ix: torch.Tensor, box: torch.Tensor,
                tie: Dict[str, float], detail: Dict | None = None
                ) -> torch.Tensor:
    """[N, K, 17]: how far each served joint ``kps`` [N, K, 17, 2] lies
    from where the reference's decode puts it for the row at cell (iy,
    ix) with the reference's ``box`` there (see ``gaps``).  ``detail``:
    a dict that receives the reference's reading of the widest gap."""
    n, k = iy.shape
    _, h, w, _ = maps["hm"].shape
    hps = _at(maps["hps"], iy, ix).reshape(n, k, 17, 2)
    size = 1 + hps.abs().amax(-1)  # [N, K, 17]
    regressed = hps + torch.stack([ix, iy], -1)[:, :, None, :]
    # the regression's rounding grows with the displacement's size
    d_reg = (kps - regressed).abs().amax(-1) / size
    # the reference's peaks of each joint as the decode takes them: the
    # top K of the NMS'd keypoint heatmap, at the cell plus its offset
    hp = maps["hm_hp"]
    p_score, p_ind = _topk(_nms(hp).permute(0, 3, 1, 2).reshape(
        n, 17, h * w), k)  # [N, 17, P]
    off = _at(maps["hp_offset"], p_ind // w, p_ind % w)
    pos = torch.stack([(p_ind % w) + off[..., 0],
                       (p_ind // w) + off[..., 1]], -1)  # [N, 17, P, 2]
    rj = regressed.permute(0, 2, 1, 3)  # [N, 17, K, 2]
    dist = (rj[:, :, :, None] - pos[:, :, None]).square().sum(-1).sqrt()
    inf = torch.full_like(dist, float("inf"))
    ts = tie["score"]
    strict = torch.where((p_score > HP_THRESH)[:, :, None], dist, inf)
    loose = torch.where((p_score > HP_THRESH - ts)[:, :, None], dist, inf)
    two = strict.topk(2, -1, largest=False)
    dmin, arg = two.values[..., 0], two.indices[..., 0]  # [N, 17, K]
    sel = torch.gather(pos, 2, arg[..., None].expand(-1, -1, -1, 2))
    sel_ind = torch.gather(p_ind, 2, arg)
    sel_score = torch.gather(p_score, 2, arg)
    l, t = box[..., 0][:, None], box[..., 1][:, None]
    r, d = box[..., 2][:, None], box[..., 3][:, None]
    side = torch.maximum(d - t, r - l)
    # how far the program's box and regressed joint may round
    tol = (tie["joint"] * size.permute(0, 2, 1)
           + tie["box"] * (1 + side.abs()))
    inside = torch.minimum(torch.minimum(sel[..., 0] - l, r - sel[..., 0]),
                           torch.minimum(sel[..., 1] - t, d - sel[..., 1]))
    reach = 0.3 * side - dmin
    found = torch.isfinite(dmin)
    snap = found & (inside >= 0) & (reach >= 0)
    # the cells next to each served joint that may carry the peak it
    # snapped to: a local maximum of the joint's heatmap up to a tie,
    # above the threshold up to a tie, on the chosen peak's ridge or about
    # as near the regressed joint as it
    kj = kps.permute(0, 2, 1, 3)  # [N, 17, K, 2]
    jy = _cells(kj[..., 1], h)[..., :, None].expand(n, 17, k, 4, 4)
    jx = _cells(kj[..., 0], w)[..., None, :].expand(n, 17, k, 4, 4)
    chan = torch.arange(17, device=kps.device)[None, :, None, None, None]
    heat = _at(hp, jy, jx).gather(-1, chan.expand(n, 17, k, 4, 4)[..., None])
    hmax = _at(_maxpool(hp), jy, jx).gather(
        -1, chan.expand(n, 17, k, 4, 4)[..., None])
    qoff = _at(maps["hp_offset"], jy, jx)
    qx, qy = jx + qoff[..., 0], jy + qoff[..., 1]
    ridge = torch.maximum((jy - (sel_ind // w)[..., None, None]).abs(),
                          (jx - (sel_ind % w)[..., None, None]).abs()) <= 2
    as_near = ((rj[..., 0, None, None] - qx).square()
               + (rj[..., 1, None, None] - qy).square()).sqrt() \
        <= (dmin + 2 * tol)[..., None, None]
    near_peak = ((heat[..., 0] >= hmax[..., 0] - ts)
                 & (heat[..., 0] > HP_THRESH - ts))
    ok = near_peak & (ridge | as_near)
    # a tie: the box's edge or the reach within rounding of the peak, the
    # peak's score within rounding of the threshold, a second peak about
    # as near, or a peak just under the threshold nearer, or the served
    # joint on a near-peak off the chosen one's ridge about as near
    tied = (found & ((inside.abs() <= tol) | (reach.abs() <= tol)
                     | (sel_score - HP_THRESH <= ts)
                     | (two.values[..., 1] - dmin <= 2 * tol))) \
        | (loose.amin(-1) < dmin) \
        | (near_peak & ~ridge & as_near).flatten(-2).any(-1)
    d_q = torch.maximum((kj[..., 0, None, None] - qx).abs(),
                        (kj[..., 1, None, None] - qy).abs())
    d_sel = (kj - sel).abs().amax(-1)  # the chosen peak itself
    d_peak = torch.minimum(
        d_sel, torch.where(ok, d_q, torch.full_like(d_q, float("inf"))
                           ).flatten(-2).amin(-1)).permute(0, 2, 1)
    snap, tied = snap.permute(0, 2, 1), tied.permute(0, 2, 1)
    gap = torch.where(tied, torch.minimum(d_reg, d_peak),
                      torch.where(snap, d_peak, d_reg))
    if detail is not None:
        f, r, j = (int(v) for v in torch.unravel_index(gap.argmax(),
                                                       gap.shape))
        detail["joint"] = {
            "frame": f, "row": r, "joint": j, "cell": (int(iy[f, r]),
                                                      int(ix[f, r])),
            "served": kps[f, r, j].tolist(),
            "regressed": regressed[f, r, j].tolist(),
            "peak": sel[f, j, r].tolist(), "peak_score": float(
                sel_score[f, j, r]), "d_reg": float(d_reg[f, r, j]),
            "d_peak": float(d_peak[f, r, j]), "snap": bool(snap[f, r, j]),
            "tied": bool(tied[f, r, j]), "inside": float(inside[f, j, r]),
            "reach": float(reach[f, j, r]), "tol": float(tol[f, j, r]),
            "second": float(two.values[f, j, r, 1] - dmin[f, j, r]),
            "box": box[f, r].tolist()}
    return gap


def _topk(x: torch.Tensor, k: int):
    """Stable descending top ``k`` of the last axis (ties: lower index)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _maxpool(m: torch.Tensor) -> torch.Tensor:
    """The 3x3 maximum around each cell of m [N, H, W, C]."""
    return F.max_pool2d(m.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)


def _nms(m: torch.Tensor) -> torch.Tensor:
    return m * (_maxpool(m) == m).to(m.dtype)


def decode(maps: Dict[str, torch.Tensor], k: int = 100,
           thresh: float = HP_THRESH) -> torch.Tensor:
    """The rows [N, K, 40] that the multi-pose decode serves from ``maps``
    (as ``serve_maps`` gives them): 3x3 max-pool NMS of the centre heatmap,
    its top K cells, each cell's box from the regressed offset and size,
    each joint the cell plus its regressed displacement, replaced by the
    nearest of the joint's top-K keypoint-heatmap peaks (its cell plus the
    regressed peak offset) where that peak scores over ``thresh``, lies in
    the box and is nearer than 0.3 of the box's longer side.  Used where
    the reference is put in the program's place (the controls)."""
    hm = _nms(maps["hm"])
    n, h, w, _ = hm.shape
    scores, inds = _topk(hm.reshape(n, h * w), k)
    ys, xs = (inds // w).float(), (inds % w).float()

    def at(m, idx):
        return torch.gather(m.reshape(n, h * w, m.shape[-1]), 1,
                            idx[..., None].expand(-1, -1, m.shape[-1]))

    kps = at(maps["hps"], inds).reshape(n, k, 17, 2)
    kps = kps + torch.stack([xs, ys], -1)[:, :, None, :]
    reg = at(maps["reg"], inds)
    cx, cy = xs + reg[..., 0], ys + reg[..., 1]
    wh = at(maps["wh"], inds)
    box = torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                       cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], -1)
    hp = _nms(maps["hm_hp"]).permute(0, 3, 1, 2).reshape(n, 17, h * w)
    hp_score, hp_ind = _topk(hp, k)  # [N, 17, K]
    off = at(maps["hp_offset"], hp_ind.reshape(n, 17 * k)).reshape(
        n, 17, k, 2)
    px = (hp_ind % w).float() + off[..., 0]
    py = (hp_ind // w).float() + off[..., 1]
    conf = hp_score > thresh
    px = torch.where(conf, px, torch.full_like(px, -10000.0))
    py = torch.where(conf, py, torch.full_like(py, -10000.0))
    hp_score = torch.where(conf, hp_score, torch.full_like(hp_score, -1.0))
    peaks = torch.stack([px, py], -1)  # [N, 17, K, 2]
    kj = kps.permute(0, 2, 1, 3)  # [N, 17, K, 2]
    dist = (kj[:, :, :, None] - peaks[:, :, None]).square().sum(-1).sqrt()
    dmin, arg = dist.min(3)
    sel = torch.gather(peaks, 2, arg[..., None].expand(-1, -1, -1, 2))
    sel_score = torch.gather(hp_score, 2, arg)
    l, t = box[..., 0][:, None], box[..., 1][:, None]
    r, d = box[..., 2][:, None], box[..., 3][:, None]
    reject = ((sel[..., 0] < l) | (sel[..., 0] > r) | (sel[..., 1] < t)
              | (sel[..., 1] > d) | (sel_score < thresh)
              | (dmin > 0.3 * torch.maximum(d - t, r - l)))
    kj = torch.where(reject[..., None], kj, sel)
    kps = kj.permute(0, 2, 1, 3).reshape(n, k, 34)
    return torch.cat([box, scores[..., None], kps,
                      torch.zeros_like(scores)[..., None]], -1)
