// Native soft-NMS over 39-dim pose detections.
//
// A copy of centerpose_tpu/native/soft_nms.cpp (same code, same C ABI) for
// the PyTorch port: greedy pick-max with linear / gaussian / hard score
// decay on [N, 39] rows (bbox4 + score + 34 kps).  Semantics match the
// numpy body in centerpose_tpu_torch/ops/soft_nms.py, the fallback.
//
// Exposed C ABI (ctypes):
//   int soft_nms_39(float* dets, int n, float sigma, float nt, float thresh,
//                   int method, int* keep_out);
// Mutates dets[:, 4] scores in place; writes pick order into keep_out;
// returns the number of kept rows.

#include <cmath>
#include <cstdint>

namespace {

inline float iou(const float* a, const float* b) {
  float area_a = (a[2] > a[0] ? a[2] - a[0] : 0.f) *
                 (a[3] > a[1] ? a[3] - a[1] : 0.f);
  float area_b = (b[2] > b[0] ? b[2] - b[0] : 0.f) *
                 (b[3] > b[1] ? b[3] - b[1] : 0.f);
  float ix1 = a[0] > b[0] ? a[0] : b[0];
  float iy1 = a[1] > b[1] ? a[1] : b[1];
  float ix2 = a[2] < b[2] ? a[2] : b[2];
  float iy2 = a[3] < b[3] ? a[3] : b[3];
  float iw = ix2 - ix1 > 0.f ? ix2 - ix1 : 0.f;
  float ih = iy2 - iy1 > 0.f ? iy2 - iy1 : 0.f;
  float inter = iw * ih;
  float uni = area_a + area_b - inter;
  return uni > 0.f ? inter / uni : 0.f;
}

}  // namespace

extern "C" {

int soft_nms_39(float* dets, int n, float sigma, float nt, float thresh,
                int method, int* keep_out) {
  constexpr int D = 39;
  int n_keep = 0;
  // alive[i]: not yet picked nor suppressed below thresh
  // (n is <= topk * n_scales ~ a few hundred; O(n^2) is fine)
  bool* alive = new bool[n];
  for (int i = 0; i < n; ++i) alive[i] = true;

  for (;;) {
    int best = -1;
    float best_score = -1.f;
    for (int i = 0; i < n; ++i) {
      if (alive[i] && dets[i * D + 4] > best_score) {
        best_score = dets[i * D + 4];
        best = i;
      }
    }
    if (best < 0 || best_score <= thresh) break;
    keep_out[n_keep++] = best;
    alive[best] = false;

    const float* bbox = dets + best * D;
    for (int i = 0; i < n; ++i) {
      if (!alive[i]) continue;
      float v = iou(bbox, dets + i * D);
      float decay;
      if (method == 1) {  // linear
        decay = v > nt ? 1.f - v : 1.f;
      } else if (method == 2) {  // gaussian
        decay = std::exp(-(v * v) / sigma);
      } else {  // hard
        decay = v <= nt ? 1.f : 0.f;
      }
      dets[i * D + 4] *= decay;
      if (dets[i * D + 4] <= thresh) alive[i] = false;
    }
  }
  delete[] alive;
  return n_keep;
}

}  // extern "C"
