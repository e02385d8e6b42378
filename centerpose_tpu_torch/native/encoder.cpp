// Native GT-encoder hot loop: per-object target fill + gaussian splatting.
//
// A copy of centerpose_tpu/native/encoder.cpp (same code, same C ABI) for
// the PyTorch port.  centerpose_tpu_torch/data/encode.py computes the
// transformed geometry in numpy and calls this through ctypes
// (centerpose_tpu_torch/native/__init__.py); the same file holds the
// numpy fallback, which also handles dense_hp.
//
// Semantics mirror encode.py + ops/image.py exactly:
//   - gaussian_radius: CornerNet 3-case quadratic, min_overlap fixed 0.7
//   - draw_umich_gaussian: sigma = diameter/6, eps-cutoff, max-composite
//   - visibility==0 person: hm center := 0.9999, reg_mask := 0
//
// Layouts (all float32 / int32, C-contiguous):
//   bboxes   [K, 4]  output-grid xyxy, already affine-warped + clipped
//   joints   [K, J, 2] output-grid joint coords (rot-aware transform)
//   vis      [K, J]  int32 visibility (>0 == labeled)
//   hm       [R, R]        (channel-last [R,R,1] is the same buffer)
//   hm_hp    [R, R, J]     channel-last; per-joint writes stride by J
//   wh/reg   [K, 2]   hps [K, 2J]  hps_mask [K, 2J]
//   ind/reg_mask [K]  hp_offset [K*J, 2]  hp_ind/hp_mask [K*J]

#include <cmath>
#include <cstdint>
#include <limits>

namespace {

constexpr double kEps = 2.220446049250313e-16;  // np.finfo(float64).eps

double gaussian_radius(double height, double width, double min_overlap) {
  double a1 = 1.0, b1 = height + width;
  double c1 = width * height * (1.0 - min_overlap) / (1.0 + min_overlap);
  double sq1 = std::sqrt(b1 * b1 - 4.0 * a1 * c1);
  double r1 = (b1 + sq1) / 2.0;

  double a2 = 4.0, b2 = 2.0 * (height + width);
  double c2 = (1.0 - min_overlap) * width * height;
  double sq2 = std::sqrt(b2 * b2 - 4.0 * a2 * c2);
  double r2 = (b2 + sq2) / 2.0;

  double a3 = 4.0 * min_overlap;
  double b3 = -2.0 * min_overlap * (height + width);
  double c3 = (min_overlap - 1.0) * width * height;
  double sq3 = std::sqrt(b3 * b3 - 4.0 * a3 * c3);
  double r3 = (b3 + sq3) / 2.0;

  double r = r1 < r2 ? r1 : r2;
  return r < r3 ? r : r3;
}

// Max-composite an unnormalized gaussian of integer `radius` at integer
// (cx, cy) into a strided 2D plane (row stride `row_stride`, element stride
// `elem_stride` floats).  Matches ops/image.py draw_umich_gaussian.
void draw_gaussian(float* plane, int height, int width, int row_stride,
                   int elem_stride, int cx, int cy, int radius, float k) {
  int diameter = 2 * radius + 1;
  double sigma = diameter / 6.0;
  double denom = 2.0 * sigma * sigma;

  int left = cx < radius ? cx : radius;
  int right = (width - cx) < (radius + 1) ? (width - cx) : (radius + 1);
  int top = cy < radius ? cy : radius;
  int bottom = (height - cy) < (radius + 1) ? (height - cy) : (radius + 1);
  if (right <= -left || bottom <= -top) return;

  for (int dy = -top; dy < bottom; ++dy) {
    float* row = plane + (cy + dy) * row_stride;
    for (int dx = -left; dx < right; ++dx) {
      double g = std::exp(-(double(dx) * dx + double(dy) * dy) / denom);
      if (g < kEps) g = 0.0;  // numpy eps-cutoff (max of patch is 1.0)
      float gv = float(g * k);
      float* cell = row + (cx + dx) * elem_stride;
      if (gv > *cell) *cell = gv;
    }
  }
}

}  // namespace

extern "C" {

// Returns the number of objects actually encoded.
int encode_targets(
    const float* bboxes, const float* joints, const int32_t* vis,
    int num_objs, int num_joints, int out_res, int rot_nonzero,
    float* hm, float* hm_hp, float* wh, float* hps, float* reg,
    int32_t* ind, float* reg_mask, float* hps_mask, float* hp_offset,
    int32_t* hp_ind, float* hp_mask) {
  const int R = out_res;
  const int J = num_joints;
  int encoded = 0;

  for (int k = 0; k < num_objs; ++k) {
    const float* bbox = bboxes + k * 4;
    float bw = bbox[2] - bbox[0];
    float bh = bbox[3] - bbox[1];
    if ((bh <= 0.f || bw <= 0.f) && !rot_nonzero) continue;
    ++encoded;

    int radius = int(gaussian_radius(std::ceil(double(bh)),
                                     std::ceil(double(bw)), 0.7));
    if (radius < 0) radius = 0;
    float ctx = (bbox[0] + bbox[2]) * 0.5f;
    float cty = (bbox[1] + bbox[3]) * 0.5f;
    int cix = int(ctx);  // matches numpy float->int32 truncation (coords >= 0)
    int ciy = int(cty);

    wh[k * 2 + 0] = bw;
    wh[k * 2 + 1] = bh;
    ind[k] = ciy * R + cix;
    reg[k * 2 + 0] = ctx - cix;
    reg[k * 2 + 1] = cty - ciy;
    reg_mask[k] = 1.f;

    int num_vis = 0;
    for (int j = 0; j < J; ++j) num_vis += vis[k * J + j] > 0;
    if (num_vis == 0) {
      // Unannotated person: suppress the focal negative at its center but
      // don't regress to it (encode.py "crowd"-ish branch).
      float* cell = hm + ciy * R + cix;
      if (0.9999f > *cell) *cell = 0.9999f;
      reg_mask[k] = 0.f;
    }

    for (int j = 0; j < J; ++j) {
      if (vis[k * J + j] <= 0) continue;
      float px = joints[(k * J + j) * 2 + 0];
      float py = joints[(k * J + j) * 2 + 1];
      if (!(px >= 0.f && px < float(R) && py >= 0.f && py < float(R))) continue;
      hps[k * 2 * J + j * 2 + 0] = px - cix;
      hps[k * 2 * J + j * 2 + 1] = py - ciy;
      hps_mask[k * 2 * J + j * 2 + 0] = 1.f;
      hps_mask[k * 2 * J + j * 2 + 1] = 1.f;
      int pix = int(px), piy = int(py);
      hp_offset[(k * J + j) * 2 + 0] = px - pix;
      hp_offset[(k * J + j) * 2 + 1] = py - piy;
      hp_ind[k * J + j] = piy * R + pix;
      hp_mask[k * J + j] = 1.f;
      draw_gaussian(hm_hp + j, R, R, R * J, J, pix, piy, radius, 1.f);
    }
    draw_gaussian(hm, R, R, R, 1, cix, ciy, radius, 1.f);
  }
  return encoded;
}

}  // extern "C"
