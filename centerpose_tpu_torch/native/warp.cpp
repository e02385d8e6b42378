// Native bilinear affine warp of a uint8 HWC image, with cv2 5.0's
// float32 arithmetic (ops/image.py: warp_affine documents it, and is the
// device path and the fallback): bit-equal to cv2.warpAffine with
// INTER_LINEAR and a constant 0 border.
//
// Every multiply-add that cv2 fuses is an explicit std::fmaf (exact), and
// the library is compiled in ISO C++ mode without -march, where g++ fuses
// nothing else (-ffp-contract=off is the ISO default), so the separate
// products and sums round as cv2's do.
//
//   src [h, w, c] uint8, m [6] float32: the destination -> source map
//   (cv2's closed-form inverse, rounded to float32), lanes: cv2's vector
//   width (the row's last ow mod lanes pixels take its scalar path),
//   dst [oh, ow, c] uint8.

#include <cmath>
#include <cstdint>

extern "C" void warp_affine_u8(const uint8_t* src, int h, int w, int c,
                               const float* m, int lanes, uint8_t* dst,
                               int oh, int ow) {
  const int t0 = ow / lanes * lanes;
  for (int y = 0; y < oh; ++y) {
    const float fy = static_cast<float>(y);
    const float mx = m[1] * fy, my = m[4] * fy;
    const float rx = mx + m[2], ry = my + m[5];
    for (int x = 0; x < ow; ++x) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < t0) {  // cv2's vectors
        sx = std::fmaf(m[0], fx, rx);
        sy = std::fmaf(m[3], fx, ry);
      } else {       // its scalar tail
        sx = std::fmaf(fx, m[0], mx) + m[2];
        sy = std::fmaf(fx, m[3], my) + m[5];
      }
      const float fx0 = std::floor(sx), fy0 = std::floor(sy);
      const float a = sx - fx0, b = sy - fy0;
      // corners far outside read the border alike: clamp before casting
      const long x0 = static_cast<long>(std::fmax(std::fmin(fx0, w + 1.0f), -2.0f));
      const long y0 = static_cast<long>(std::fmax(std::fmin(fy0, h + 1.0f), -2.0f));
      const bool in_x0 = x0 >= 0 && x0 < w, in_x1 = x0 + 1 >= 0 && x0 + 1 < w;
      const bool in_y0 = y0 >= 0 && y0 < h, in_y1 = y0 + 1 >= 0 && y0 + 1 < h;
      uint8_t* out = dst + (static_cast<long>(y) * ow + x) * c;
      for (int k = 0; k < c; ++k) {
        auto tap = [&](bool ok, long yy, long xx) -> float {
          return ok ? static_cast<float>(src[(yy * w + xx) * c + k]) : 0.0f;
        };
        const float p00 = tap(in_y0 && in_x0, y0, x0);
        const float p01 = tap(in_y0 && in_x1, y0, x0 + 1);
        const float p10 = tap(in_y1 && in_x0, y0 + 1, x0);
        const float p11 = tap(in_y1 && in_x1, y0 + 1, x0 + 1);
        const float v0 = std::fmaf(a, p01 - p00, p00);
        const float v1 = std::fmaf(a, p11 - p10, p10);
        const float v = std::fmaf(b, v1 - v0, v0);
        const long r = std::lrint(v);  // to the nearest, half to even
        out[k] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
      }
    }
  }
}
