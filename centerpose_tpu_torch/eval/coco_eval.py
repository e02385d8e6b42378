"""COCO-protocol detection evaluation (pure numpy, no pycocotools).

Counterpart of ``centerpose_tpu/eval/coco_eval.py``, copied so that the
port runs without the JAX package; results equal the reference's on the
same annotations and detections.  It follows the published ``COCOeval``
protocol for both iou types:

- **keypoints**: OKS(det, gt) = mean over labeled joints of
  exp(-d_i^2 / (2 s^2 k_i^2)), k_i = 2*sigma_i (COCO per-joint constants),
  s^2 = gt area.  For gts with zero labeled joints (crowds et al.) the
  protocol substitutes a bbox-proximity distance (distance outside the gt box
  expanded by 2x in every direction) so detections overlapping such regions
  can still *match-and-be-ignored* rather than count as false positives.
- **bbox**: IoU; against crowd gts the denominator is the detection area
  alone (intersection-over-det, the crowd-region semantics).

Shared protocol machinery (identical across iou types): per-image greedy
matching of score-sorted detections to ignore-sorted ground truths at each
threshold (matched-to-ignored detections are ignored; unmatched detections
whose own area falls outside the area range are ignored); 101-point
interpolated AP over thresholds .5:.05:.95; area ranges and maxDets per iou
type (keypoints: all/medium/large, maxDets=20; bbox: all/small/medium/large,
maxDets=1/10/100); the standard 10-number keypoint summary and 12-number
bbox summary.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# OKS per-joint sigmas (the COCO keypoint evaluation constants).
OKS_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035,
        0.079, 0.079, 0.072, 0.072, 0.062,
        0.062, 0.107, 0.107, 0.087, 0.087,
        0.089, 0.089,
    ],
    dtype=np.float32,
)

OKS_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)

KEYPOINT_AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e10),
}
BBOX_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e10),
}
KEYPOINT_MAX_DETS = (20,)
BBOX_MAX_DETS = (1, 10, 100)


def compute_oks(
    det_kps: np.ndarray,
    gt_kps: np.ndarray,
    gt_area: float,
    gt_bbox: Optional[Sequence[float]] = None,
) -> float:
    """OKS of one detection vs one gt.

    det_kps: [17, 2+] predicted (x, y); gt_kps: [17, 3] with visibility.
    When the gt has no labeled joints (crowds), distance is measured from the
    gt bbox expanded by 2x (the protocol's proximity rule) if a bbox is given.
    """
    v = gt_kps[:, 2]
    labeled = v > 0
    k = 2 * OKS_SIGMAS
    denom = 2.0 * (gt_area + np.spacing(1)) * k ** 2
    xd, yd = det_kps[:, 0], det_kps[:, 1]
    if labeled.sum() > 0:
        d2 = (xd - gt_kps[:, 0]) ** 2 + (yd - gt_kps[:, 1]) ** 2
        e = d2 / denom
        return float(np.mean(np.exp(-e[labeled])))
    if gt_bbox is None:
        return 0.0
    bx, by, bw, bh = [float(t) for t in gt_bbox]
    x0, x1 = bx - bw, bx + 2 * bw
    y0, y1 = by - bh, by + 2 * bh
    z = np.zeros(17)
    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
    e = (dx ** 2 + dy ** 2) / denom
    return float(np.mean(np.exp(-e)))


def bbox_iou(det_box: Sequence[float], gt_box: Sequence[float], crowd: bool) -> float:
    """IoU of two xywh boxes; intersection-over-det-area against crowds."""
    dx, dy, dw, dh = [float(t) for t in det_box]
    gx, gy, gw, gh = [float(t) for t in gt_box]
    iw = min(dx + dw, gx + gw) - max(dx, gx)
    ih = min(dy + dh, gy + gh) - max(dy, gy)
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    union = dw * dh if crowd else dw * dh + gw * gh - inter
    return inter / union if union > 0 else 0.0


def _det_area(d: dict, iou_type: str) -> float:
    """Detection area for the area-range ignore rule.

    The protocol's result loader derives this per iou type: keypoint results
    always get the tight keypoint-extent bbox area (any provided bbox is
    ignored); bbox results get the bbox area.
    """
    if iou_type == "keypoints":
        kp = np.asarray(d["keypoints"], np.float64).reshape(-1, 3)
        x, y = kp[:, 0], kp[:, 1]
        return float((x.max() - x.min()) * (y.max() - y.min()))
    if "area" in d:
        return float(d["area"])
    return float(d["bbox"][2]) * float(d["bbox"][3])


def oks_matrix(dets: List[dict], gts: List[dict]) -> np.ndarray:
    """[n_det, n_gt] OKS matrix for one image (dets in given order)."""
    m = np.zeros((len(dets), len(gts)), np.float64)
    for j, g in enumerate(gts):
        gk = np.asarray(g["keypoints"], np.float64).reshape(17, 3)
        area = float(g.get("area", 1.0))
        bbox = g.get("bbox")
        for i, d in enumerate(dets):
            dk = np.asarray(d["keypoints"], np.float64).reshape(17, -1)
            m[i, j] = compute_oks(dk, gk, area, bbox)
    return m


def iou_matrix_bbox(dets: List[dict], gts: List[dict]) -> np.ndarray:
    m = np.zeros((len(dets), len(gts)), np.float64)
    for j, g in enumerate(gts):
        crowd = bool(g.get("iscrowd", 0))
        for i, d in enumerate(dets):
            m[i, j] = bbox_iou(d["bbox"], g["bbox"], crowd)
    return m


class COCOProtocolEval:
    """Greedy-match + accumulate evaluator following the COCOeval protocol.

    gts: list of gt ann dicts (image_id, area, iscrowd, keypoints[51] and/or
    bbox xywh, optional num_keypoints / ignore); dts: list of det dicts
    (image_id, score, keypoints and/or bbox).
    """

    def __init__(
        self,
        gts: List[dict],
        dts: List[dict],
        iou_type: str = "keypoints",
        thresholds: np.ndarray = OKS_THRESHOLDS,
        area_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
        max_dets: Optional[Sequence[int]] = None,
    ):
        assert iou_type in ("keypoints", "bbox"), iou_type
        self.iou_type = iou_type
        self.thresholds = np.asarray(thresholds, np.float64)
        self.area_ranges = dict(
            area_ranges
            if area_ranges is not None
            else (KEYPOINT_AREA_RANGES if iou_type == "keypoints" else BBOX_AREA_RANGES)
        )
        self.max_dets = tuple(
            max_dets
            if max_dets is not None
            else (KEYPOINT_MAX_DETS if iou_type == "keypoints" else BBOX_MAX_DETS)
        )
        self.img_ids = sorted(
            {g["image_id"] for g in gts} | {d["image_id"] for d in dts}
        )
        self.gts_by_img: Dict[int, List[dict]] = {i: [] for i in self.img_ids}
        self.dts_by_img: Dict[int, List[dict]] = {i: [] for i in self.img_ids}
        for g in gts:
            self.gts_by_img[g["image_id"]].append(g)
        for d in dts:
            self.dts_by_img[d["image_id"]].append(d)
        # per-image: dets score-sorted (stable) and capped at max(max_dets);
        # the IoU/OKS matrix is computed once per image and re-sliced per
        # area range.
        self._dts_sorted: Dict[int, List[dict]] = {}
        self._ious: Dict[int, np.ndarray] = {}
        cap = max(self.max_dets)
        for i in self.img_ids:
            order = np.argsort(
                [-d["score"] for d in self.dts_by_img[i]], kind="mergesort"
            )
            dts_i = [self.dts_by_img[i][j] for j in order[:cap]]
            self._dts_sorted[i] = dts_i
            gts_i = self.gts_by_img[i]
            if dts_i and gts_i:
                self._ious[i] = (
                    oks_matrix(dts_i, gts_i)
                    if iou_type == "keypoints"
                    else iou_matrix_bbox(dts_i, gts_i)
                )
            else:
                self._ious[i] = np.zeros((len(dts_i), len(gts_i)))

    def _gt_ignore_base(self, g: dict) -> bool:
        """Ignore independent of area range: explicit flag, crowd, or (for
        keypoints) zero labeled joints."""
        ig = bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0))
        if self.iou_type == "keypoints":
            if "num_keypoints" in g:
                ig = ig or g["num_keypoints"] == 0
            else:
                kp = np.asarray(g["keypoints"]).reshape(-1, 3)
                ig = ig or (kp[:, 2] > 0).sum() == 0
        return ig

    def _evaluate_img(self, img_id, area_rng) -> Optional[dict]:
        gts = self.gts_by_img[img_id]
        dts = self._dts_sorted[img_id]
        if not gts and not dts:
            return None
        gt_ig = np.array(
            [
                self._gt_ignore_base(g)
                or not (area_rng[0] <= g.get("area", 0.0) <= area_rng[1])
                for g in gts
            ],
            bool,
        )
        # sort gts: unignored first (stable), and reorder the iou columns
        order = np.argsort(gt_ig, kind="stable")
        gts = [gts[i] for i in order]
        gt_ig = gt_ig[order]
        ious = self._ious[img_id][:, order] if len(gts) else self._ious[img_id]

        t_count = len(self.thresholds)
        gt_m = np.full((t_count, len(gts)), -1, np.int64)
        dt_m = np.full((t_count, len(dts)), -1, np.int64)
        dt_ig = np.zeros((t_count, len(dts)), bool)
        iscrowd = [bool(g.get("iscrowd", 0)) for g in gts]
        for ti, t in enumerate(self.thresholds):
            for di in range(len(dts)):
                best_iou = min(t, 1 - 1e-10)
                best_g = -1
                for gi in range(len(gts)):
                    # already matched to this gt, and it is not a crowd
                    if gt_m[ti, gi] >= 0 and not iscrowd[gi]:
                        continue
                    # gts sorted by ignore: once we hold a real match and
                    # reach ignored gts, stop (protocol break rule)
                    if best_g > -1 and not gt_ig[best_g] and gt_ig[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ig[ti, di] = gt_ig[best_g]
                dt_m[ti, di] = best_g
                gt_m[ti, best_g] = di
        # unmatched detections whose own area is outside the range are
        # ignored (the protocol's det-side area rule; det area = bbox area
        # or keypoint-extent bbox)
        dt_out = np.array(
            [
                not (area_rng[0] <= _det_area(d, self.iou_type) <= area_rng[1])
                for d in dts
            ],
            bool,
        )
        dt_ig = dt_ig | ((dt_m < 0) & dt_out[None, :])
        return {
            "scores": np.array([d["score"] for d in dts]),
            "dt_m": dt_m,
            "dt_ig": dt_ig,
            "gt_ig": gt_ig,
            "n_gt": int((~gt_ig).sum()),
        }

    def accumulate(self) -> Dict[str, np.ndarray]:
        """precision[T, R, A, M] and recall[T, A, M] (A area ranges, M maxDets)."""
        t_count = len(self.thresholds)
        a_names = list(self.area_ranges)
        m_list = list(self.max_dets)
        precision = -np.ones(
            (t_count, len(RECALL_POINTS), len(a_names), len(m_list))
        )
        recall = -np.ones((t_count, len(a_names), len(m_list)))
        for ai, a_name in enumerate(a_names):
            rng = self.area_ranges[a_name]
            evals = [self._evaluate_img(i, rng) for i in self.img_ids]
            evals = [e for e in evals if e is not None]
            if not evals:
                continue
            n_gt = sum(e["n_gt"] for e in evals)
            if n_gt == 0:
                continue
            for mi, max_det in enumerate(m_list):
                scores = np.concatenate([e["scores"][:max_det] for e in evals])
                order = np.argsort(-scores, kind="mergesort")
                dt_m = np.concatenate(
                    [e["dt_m"][:, :max_det] for e in evals], axis=1
                )[:, order]
                dt_ig = np.concatenate(
                    [e["dt_ig"][:, :max_det] for e in evals], axis=1
                )[:, order]
                tps = (dt_m >= 0) & ~dt_ig
                fps = (dt_m < 0) & ~dt_ig
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(t_count):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    rc = tp / n_gt
                    pr = tp / (tp + fp + np.spacing(1))
                    recall[ti, ai, mi] = rc[-1] if len(rc) else 0.0
                    # monotone precision envelope
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, RECALL_POINTS, side="left")
                    q = np.zeros(len(RECALL_POINTS))
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti, :, ai, mi] = q
        return {"precision": precision, "recall": recall}

    # ------------------------------------------------------------------
    # summaries
    # ------------------------------------------------------------------
    def _stat(self, acc, use_ap, thr=None, area="all", max_det=None):
        a_names = list(self.area_ranges)
        ai = a_names.index(area)
        mi = (
            len(self.max_dets) - 1
            if max_det is None
            else list(self.max_dets).index(max_det)
        )
        if use_ap:
            s = acc["precision"][:, :, ai, mi]
        else:
            s = acc["recall"][:, ai, mi]
        if thr is not None:
            ti = int(np.argmin(np.abs(self.thresholds - thr)))
            s = s[ti : ti + 1]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def summarize(self, acc=None) -> Dict[str, float]:
        if acc is None:
            acc = self.accumulate()
        st = self._stat
        if self.iou_type == "keypoints":
            return {
                "AP": st(acc, True),
                "AP50": st(acc, True, 0.5),
                "AP75": st(acc, True, 0.75),
                "APm": st(acc, True, area="medium"),
                "APl": st(acc, True, area="large"),
                "AR": st(acc, False),
                "AR50": st(acc, False, 0.5),
                "AR75": st(acc, False, 0.75),
                "ARm": st(acc, False, area="medium"),
                "ARl": st(acc, False, area="large"),
            }
        return {
            "AP": st(acc, True),
            "AP50": st(acc, True, 0.5),
            "AP75": st(acc, True, 0.75),
            "APs": st(acc, True, area="small"),
            "APm": st(acc, True, area="medium"),
            "APl": st(acc, True, area="large"),
            "AR1": st(acc, False, max_det=self.max_dets[0]),
            "AR10": st(acc, False, max_det=self.max_dets[1])
            if len(self.max_dets) > 1
            else st(acc, False),
            "AR100": st(acc, False),
            "ARs": st(acc, False, area="small"),
            "ARm": st(acc, False, area="medium"),
            "ARl": st(acc, False, area="large"),
        }


class KeypointEval(COCOProtocolEval):
    """The keypoint-protocol evaluator."""

    def __init__(self, gts: List[dict], dts: List[dict]):
        super().__init__(gts, dts, iou_type="keypoints")


def summarize_keypoints(acc: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The 10 keypoint stats of an ``accumulate()`` result, precision
    ``[T, R, A, M]`` and recall ``[T, A, M]``, or the older layouts without
    the max-detections axis (``[T, R, A]``, ``[T, A]``)."""
    precision, recall = acc["precision"], acc["recall"]
    if precision.ndim == 3:
        precision = precision[..., None]
        recall = recall[..., None]
    return COCOProtocolEval([], [], iou_type="keypoints").summarize(
        {"precision": precision, "recall": recall})


def evaluate_keypoints(gts: List[dict], dts: List[dict]) -> Dict[str, float]:
    """One-call keypoint evaluation: annotations + detections -> 10 stats."""
    return COCOProtocolEval(gts, dts, iou_type="keypoints").summarize()


def evaluate_bboxes(gts: List[dict], dts: List[dict]) -> Dict[str, float]:
    """One-call bbox evaluation (the second ``COCOeval`` pass of a COCO
    keypoint evaluation)."""
    return COCOProtocolEval(gts, dts, iou_type="bbox").summarize()
