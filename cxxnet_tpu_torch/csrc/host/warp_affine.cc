/*!
 * warp_affine.cc — the geometric augmenter's bicubic affine warp.
 *
 * The arithmetic is pinned, and spelled out again in numpy by
 * cxxnet_tpu_torch/io/warp.py warp_affine_ref, which holds this file bit
 * for bit:
 *
 *  - the source coordinate of output pixel (x, y) in float32, from the
 *    float32 inverse map [a b c; d e f]: X = a*x + (b*y + c),
 *    Y = d*x + (e*y + f), each product and sum rounded to float32 (the
 *    library is built with -ffp-contract=off, so no fused multiply-add);
 *  - x0 = floor(X), the fraction X - x0 (exact in float32) widened to
 *    double, and Keys' cubic weights with A = -0.75 in double;
 *  - the 4x4 window at (x0 - 1 .. x0 + 2, y0 - 1 .. y0 + 2), a tap outside
 *    the image taking the fill value, summed in double along each window
 *    row (left to right) and then over the rows (top to bottom);
 *  - one rounding, half to even, then a clamp to 0..255; a pixel whose
 *    whole window lies outside the image takes the fill value.
 *
 * This is OpenCV 5.0's warpAffine(INTER_CUBIC, BORDER_CONSTANT) on 8-bit
 * images to within a rounding: it computes in floating point, not on
 * OpenCV 4's fixed-point grid, and tests/test_torch_warp.py states how
 * many values part from it.
 */
#include "cxn_host.h"

#include <cmath>

namespace {

inline void keys_weights(double t, double *w) {
  const double A = -0.75;
  double t1 = t + 1.0, u = 1.0 - t;
  w[0] = ((A * t1 - 5.0 * A) * t1 + 8.0 * A) * t1 - 4.0 * A;
  w[1] = ((A + 2.0) * t - (A + 3.0)) * t * t + 1.0;
  w[2] = ((A + 2.0) * u - (A + 3.0)) * u * u + 1.0;
  w[3] = 1.0 - w[0] - w[1] - w[2];
}

}  // namespace

extern "C" void cxn_warp_affine_u8(const uint8_t *src, int64_t h, int64_t w,
                                   int64_t c, const float *inv, uint8_t *dst,
                                   int64_t out_h, int64_t out_w, int fill) {
  const float a = inv[0], b = inv[1], cc = inv[2];
  const float d = inv[3], e = inv[4], f = inv[5];
  const double fillv = double(fill);
  for (int64_t y = 0; y < out_h; ++y) {
    const float fy = float(y);
    const float bx = b * fy + cc;
    const float by = e * fy + f;
    for (int64_t x = 0; x < out_w; ++x) {
      const float fx = float(x);
      const float X = a * fx + bx;
      const float Y = d * fx + by;
      uint8_t *op = dst + (y * out_w + x) * c;
      const float flx = std::floor(X), fly = std::floor(Y);
      // far outside (or not a number): the fill value
      if (!(flx > -8.0f && flx < float(w) + 8.0f && fly > -8.0f &&
            fly < float(h) + 8.0f)) {
        for (int64_t ch = 0; ch < c; ++ch) op[ch] = uint8_t(fill);
        continue;
      }
      const int64_t x0 = int64_t(flx), y0 = int64_t(fly);
      if (x0 + 2 < 0 || x0 - 1 >= w || y0 + 2 < 0 || y0 - 1 >= h) {
        for (int64_t ch = 0; ch < c; ++ch) op[ch] = uint8_t(fill);
        continue;
      }
      double wx[4], wy[4];
      keys_weights(double(X - flx), wx);
      keys_weights(double(Y - fly), wy);
      for (int64_t ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int j = 0; j < 4; ++j) {
          const int64_t yy = y0 - 1 + j;
          double row = 0.0;
          for (int i = 0; i < 4; ++i) {
            const int64_t xx = x0 - 1 + i;
            const double v = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                                 ? double(src[(yy * w + xx) * c + ch])
                                 : fillv;
            row = row + wx[i] * v;
          }
          acc = acc + wy[j] * row;
        }
        double r = std::nearbyint(acc);
        op[ch] = uint8_t(r < 0.0 ? 0.0 : (r > 255.0 ? 255.0 : r));
      }
    }
  }
}
