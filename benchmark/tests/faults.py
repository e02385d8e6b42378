"""Faults planted in the program's timed path, each of which a cell's check
has to find: in the serving decode (the rows it selects and the joints
it snaps) and in the DCN backward's weight gradient.  Used by the tests
here and by ``calibrate.py``, which reads them at a cell's own size."""

from __future__ import annotations

import contextlib

import torch

# a detection is shown from this score on (the configurations'
# test.vis_thresh)
SHOWN = 0.3


def no_nms(orig):
    """A decode that ranks every cell of the centre heatmap, with no
    max-pool NMS: the neighbours of each person push the low peaks out."""
    def broken(heat, *args, **kw):
        from centerpose_tpu_torch.ops import decode

        nms = decode.heat_nms
        decode.heat_nms = (lambda h, kernel=3:
                           h if h is heat else nms(h, kernel))
        try:
            return orig(heat, *args, **kw)
        finally:
            decode.heat_nms = nms
    return broken


def low_dropped(orig):
    """A top K cut at the shown score: the rows below it come back as
    zeros."""
    def broken(*args, **kw):
        rows = orig(*args, **kw)
        return torch.where(rows[..., 4:5] < SHOWN, torch.zeros_like(rows),
                           rows)
    return broken


def low_reordered(orig):
    """A top K whose rows below the shown score come in reverse order."""
    def broken(*args, **kw):
        rows = orig(*args, **kw)
        k = rows.shape[1]
        high = (rows[..., 4] >= SHOWN).sum(1, keepdim=True)
        j = torch.arange(k, device=rows.device)[None]
        idx = torch.where(j < high, j, k - 1 - (j - high))
        return rows.gather(1, idx[..., None].expand_as(rows))
    return broken


def no_snap(orig):
    """A decode that never snaps a joint to a keypoint-heatmap peak."""
    def broken(heat, wh, kps, reg=None, hm_hp=None, hp_offset=None, k=100,
               hm_hp_thresh=0.1):
        return orig(heat, wh, kps, reg, None, hp_offset, k=k,
                    hm_hp_thresh=hm_hp_thresh)
    return broken


DECODE = {"no_nms": no_nms, "low_dropped": low_dropped,
          "low_reordered": low_reordered, "no_snap": no_snap}


@contextlib.contextmanager
def decode_fault(name: str):
    """The serving engine's decode (``inference/detector``'s
    ``multi_pose_decode``) replaced by the fault ``name`` inside."""
    from centerpose_tpu_torch.inference import detector

    orig = detector.multi_pose_decode
    detector.multi_pose_decode = DECODE[name](orig)
    try:
        yield
    finally:
        detector.multi_pose_decode = orig


@contextlib.contextmanager
def dcn_weight_grad_half():
    """The DCN backward's weight and bias gradients summed over the first
    half of the batch alone (its other gradients whole), inside."""
    from centerpose_tpu_torch.ops import dcn_cuda

    orig = dcn_cuda.dcn_v2_backward

    def broken(x, offset, mask, weight, ct, max_dy, edge_grad=1.0):
        out = orig(x, offset, mask, weight, ct, max_dy, edge_grad)
        h = len(x) // 2
        half = orig(x[:h], offset[:h], mask[:h], weight, ct[:h], max_dy,
                    edge_grad)
        broken.calls += 1
        return (*out[:3], half[3], half[4])
    broken.calls = 0
    # the launch counters the kernel's wrapper keeps on the function
    broken.launches = orig.launches
    broken.launches_by_site = orig.launches_by_site
    dcn_cuda.dcn_v2_backward = broken
    try:
        yield broken
    finally:
        dcn_cuda.dcn_v2_backward = orig


@contextlib.contextmanager
def dcn_through_operator():
    """DLA's DCN sites call the operator ``centerpose::dcn_v2`` on the CPU
    too, with gradients on, as a CUDA tensor does: its gradient then comes
    from ``dcn_v2_backward`` (there the plain version), where
    ``dcn_weight_grad_half`` plants its fault.  Inside."""
    from centerpose_tpu_torch.models import dla
    from centerpose_tpu_torch.ops import dcn_cuda

    orig = dla.dcn_v2

    def through(x, offset, mask, weight, bias, max_dy, edge_grad=1.0):
        return dcn_cuda.dcn_v2_op(x, offset, mask, weight, bias,
                                  None if max_dy is None else float(max_dy),
                                  float(edge_grad))
    dla.dcn_v2 = through
    try:
        yield
    finally:
        dla.dcn_v2 = orig
