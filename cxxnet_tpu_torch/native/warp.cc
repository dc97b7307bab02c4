// The affine warp and the bilinear resize of the port's augmenter, without
// OpenCV.
//
// The JAX package asks cv2 for both (cxxnet_tpu/io/augment.py): warpAffine
// with INTER_LINEAR and BORDER_CONSTANT for the rotation, shear, aspect and
// scale jitter, and resize with INTER_LINEAR for the upscale of an image
// smaller than the crop. Here, over float32 HWC images with C channels:
//
// * cxn_warp_affine: dst(x, y) = bilinear src at M^-1 (x, y), where M^-1 is
//   the inverse of the 2x3 forward matrix as invertAffineTransform computes
//   it, in double; the source coordinates are then taken in float (the row's
//   part M1 y + M2 first, then M0 x added), as OpenCV 5's float warp does. A
//   neighbour outside the image reads `fill` (BORDER_CONSTANT).
// * cxn_resize_linear: half-pixel centres, sx = (dx + 0.5) * (w / ow) - 0.5
//   in double rounded to float, the edge clamped (a tap past it gets weight
//   0), a horizontal then a vertical pass in float, as OpenCV's resize.
//
// The plain versions (warp_affine_plain, resize_linear_plain in
// cxxnet_tpu_torch/io/augment.py) do the same float operations in the same
// order in numpy. A plain C interface loaded with ctypes (which releases the
// GIL during the call); no state, thread-safe.
//
// Built at first use by cxxnet_tpu_torch/ops/_build.py (load_host):
//   g++ -O3 -fPIC -shared -std=c++17 -o <build>/libwarp-<hash>.so warp.cc

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// The inverse of the forward 2x3 matrix `m` into `inv` (OpenCV's
// invertAffineTransform: a singular matrix inverts to zeros).
void cxn_invert_affine(const double* m, double* inv) {
  double d = m[0] * m[4] - m[1] * m[3];
  d = d != 0.0 ? 1.0 / d : 0.0;
  const double a11 = m[4] * d, a22 = m[0] * d;
  const double a12 = -m[1] * d, a21 = -m[3] * d;
  inv[0] = a11;
  inv[1] = a12;
  inv[2] = -a11 * m[2] - a12 * m[5];
  inv[3] = a21;
  inv[4] = a22;
  inv[5] = -a21 * m[2] - a22 * m[5];
}

// dst (oh, ow, c) = src (h, w, c) warped by the forward matrix `m` (2x3,
// row-major).
int cxn_warp_affine(const float* src, int h, int w, int c, float* dst,
                    int oh, int ow, const double* m, float fill) {
  if (h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return -1;
  double inv[6];
  cxn_invert_affine(m, inv);
  float mf[6];
  for (int i = 0; i < 6; ++i) mf[i] = static_cast<float>(inv[i]);
  for (int y = 0; y < oh; ++y) {
    const float fy_ = static_cast<float>(y);
    const float bx = mf[1] * fy_ + mf[2];
    const float by = mf[4] * fy_ + mf[5];
    float* orow = dst + static_cast<long>(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      const float fx_ = static_cast<float>(x);
      const float sx = mf[0] * fx_ + bx;
      const float sy = mf[3] * fx_ + by;
      const float x0f = std::floor(sx), y0f = std::floor(sy);
      const float ax = sx - x0f, ay = sy - y0f;
      const float bx1 = 1.0f - ax, by1 = 1.0f - ay;
      // taps far outside the image all read fill; keep the index in range
      const long x0 = x0f < -2.0f ? -2
                      : (x0f > w + 1.0f ? w + 1 : static_cast<long>(x0f));
      const long y0 = y0f < -2.0f ? -2
                      : (y0f > h + 1.0f ? h + 1 : static_cast<long>(y0f));
      const bool in_x0 = x0 >= 0 && x0 < w, in_x1 = x0 + 1 >= 0 && x0 + 1 < w;
      const bool in_y0 = y0 >= 0 && y0 < h, in_y1 = y0 + 1 >= 0 && y0 + 1 < h;
      const long i00 = (y0 * w + x0) * c, i10 = i00 + static_cast<long>(w) * c;
      float* o = orow + static_cast<long>(x) * c;
      for (int k = 0; k < c; ++k) {
        const float p00 = in_y0 && in_x0 ? src[i00 + k] : fill;
        const float p01 = in_y0 && in_x1 ? src[i00 + c + k] : fill;
        const float p10 = in_y1 && in_x0 ? src[i10 + k] : fill;
        const float p11 = in_y1 && in_x1 ? src[i10 + c + k] : fill;
        o[k] = by1 * (bx1 * p00 + ax * p01) + ay * (bx1 * p10 + ax * p11);
      }
    }
  }
  return 0;
}

namespace {

// Taps and weights of one axis: n_out half-pixel centres over n_in.
void linear_taps(int n_in, int n_out, std::vector<int>& i0,
                 std::vector<int>& i1, std::vector<float>& a) {
  const double scale = 1.0 / (static_cast<double>(n_out) / n_in);
  i0.resize(n_out);
  i1.resize(n_out);
  a.resize(n_out);
  for (int d = 0; d < n_out; ++d) {
    const float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    float frac = f - static_cast<float>(s);
    if (s < 0) {
      frac = 0.0f;
      s = 0;
    }
    if (s >= n_in - 1) {
      frac = 0.0f;
      s = n_in - 1;
    }
    i0[d] = s;
    i1[d] = s + 1 < n_in ? s + 1 : n_in - 1;
    a[d] = frac;
  }
}

}  // namespace

// dst (oh, ow, c) = src (h, w, c) resized with INTER_LINEAR.
int cxn_resize_linear(const float* src, int h, int w, int c, float* dst,
                      int oh, int ow) {
  if (h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return -1;
  std::vector<int> x0, x1, y0, y1;
  std::vector<float> ax, ay;
  linear_taps(w, ow, x0, x1, ax);
  linear_taps(h, oh, y0, y1, ay);
  std::vector<float> r0(static_cast<size_t>(ow) * c),
      r1(static_cast<size_t>(ow) * c);
  for (int y = 0; y < oh; ++y) {
    const float* s0 = src + static_cast<long>(y0[y]) * w * c;
    const float* s1 = src + static_cast<long>(y1[y]) * w * c;
    for (int x = 0; x < ow; ++x) {
      const float a1 = ax[x], a0 = 1.0f - a1;
      for (int k = 0; k < c; ++k) {
        r0[x * c + k] = s0[x0[x] * c + k] * a0 + s0[x1[x] * c + k] * a1;
        r1[x * c + k] = s1[x0[x] * c + k] * a0 + s1[x1[x] * c + k] * a1;
      }
    }
    const float b1 = ay[y], b0 = 1.0f - b1;
    float* o = dst + static_cast<long>(y) * ow * c;
    for (int i = 0; i < ow * c; ++i) o[i] = r0[i] * b0 + r1[i] * b1;
  }
  return 0;
}

}  // extern "C"
