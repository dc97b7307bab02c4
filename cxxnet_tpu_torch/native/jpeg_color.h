// libjpeg's chroma upsampling and YCbCr -> RGB conversion, for the JPEG
// decoders of the port's image pipeline.
//
// libjpeg (and so cv2, PIL and the JAX package) decodes a subsampled JPEG to
// RGB with "fancy" upsampling: each output chroma sample is the triangle
// filter 3/4 nearer + 1/4 farther input sample in each subsampled direction
// (jdsample.c: h2v1_fancy_upsample, h2v2_fancy_upsample, with their biases
// 1/2 and 8/7 alternating), the edge samples replicated, and plain
// replication where a plane is 2 samples wide or less; then the fixed-point
// YCbCr -> RGB of jdcolor.c (16 fraction bits). nvJPEG's own RGB output
// upsamples chroma by replication, which reads about 1 level away on average
// from libjpeg's on noisy chroma; nvjpeg.cc takes nvJPEG's planar YCbCr and
// finishes here, so the card's pixels are libjpeg's up to the IDCT's
// rounding. decode.cc exports the same code over libjpeg's own planes, which
// is how the CPU tests hold it bit-equal to libjpeg's RGB.
//
// Four-component files (CMYK, or YCCK: Adobe transform 2) come out as the
// JAX package gives them: its libjpeg call asks for RGB, which libjpeg
// refuses for four components, so it falls through to cv2, which decodes to
// libjpeg's JCS_CMYK (YCCK converted by jdcolor.c's ycck_cmyk_convert, the
// planes upsampled as above) and then applies OpenCV's subtractive
// conversion (imgcodecs' icvCvt_CMYK2BGR_8u_C4C3R and _CMYK2Gray_8u_C4C1R):
// cmyk_to_pixels. planes4_to_cmyk is libjpeg's half over four raw planes
// (nvJPEG's NVJPEG_OUTPUT_UNCHANGED on the card), adobe_transform the
// marker that tells CMYK from YCCK.
//
// Header only, plain C++; included by decode.cc and nvjpeg.cc.

#ifndef CXXNET_TPU_TORCH_NATIVE_JPEG_COLOR_H_
#define CXXNET_TPU_TORCH_NATIVE_JPEG_COLOR_H_

#include <cstdint>
#include <vector>

namespace cxn_jpeg {

// One output row of a plane upsampled 2x horizontally (w outputs from dw
// inputs), from the row's per-column sums `sum` already weighted for the
// vertical filter: h2v2 passes 3 * near + far (then >> 4), h2v1 passes the
// samples themselves (then >> 2).
inline void fancy_row_h2(const int* sum, int dw, int w, bool v2,
                         uint8_t* out) {
  std::vector<uint8_t> row(static_cast<size_t>(2) * dw);
  uint8_t* o = row.data();
  if (v2) {
    int this_s = sum[0], last_s, next_s;
    next_s = dw > 1 ? sum[1] : sum[0];
    *o++ = static_cast<uint8_t>((this_s * 4 + 8) >> 4);
    *o++ = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
    last_s = this_s;
    this_s = next_s;
    for (int c = 2; c < dw; ++c) {
      next_s = sum[c];
      *o++ = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
      last_s = this_s;
      this_s = next_s;
    }
    *o++ = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
    *o++ = static_cast<uint8_t>((this_s * 4 + 7) >> 4);
  } else {
    int v = sum[0];
    *o++ = static_cast<uint8_t>(v);
    *o++ = static_cast<uint8_t>((v * 3 + sum[1] + 2) >> 2);
    for (int c = 1; c < dw - 1; ++c) {
      v = sum[c] * 3;
      *o++ = static_cast<uint8_t>((v + sum[c - 1] + 1) >> 2);
      *o++ = static_cast<uint8_t>((v + sum[c + 1] + 2) >> 2);
    }
    v = sum[dw - 1];
    *o++ = static_cast<uint8_t>((v * 3 + sum[dw - 2] + 1) >> 2);
    *o++ = static_cast<uint8_t>(v);
  }
  for (int x = 0; x < w; ++x) out[x] = row[x];
}

// A chroma plane (dw x dh, row pitch `pitch`) upsampled by hf x vf (each 1
// or 2; vf 2 only with hf 2) to w x h as libjpeg does.
inline void upsample(const uint8_t* in, int dw, int dh, int pitch, int hf,
                     int vf, uint8_t* out, int w, int h) {
  const bool fancy = dw > 2;
  std::vector<int> sum(dw);
  for (int y = 0; y < h; ++y) {
    const int r = vf == 2 ? y / 2 : y;
    const uint8_t* near = in + static_cast<long>(r) * pitch;
    uint8_t* o = out + static_cast<long>(y) * w;
    if (hf == 1) {
      for (int x = 0; x < w; ++x) o[x] = near[x];
      continue;
    }
    if (!fancy) {                      // replication in both directions
      for (int x = 0; x < w; ++x) o[x] = near[x / 2];
      continue;
    }
    if (vf == 2) {
      // the row above for even outputs, below for odd, edges replicated
      int rf = (y % 2 == 0) ? r - 1 : r + 1;
      rf = rf < 0 ? 0 : (rf >= dh ? dh - 1 : rf);
      const uint8_t* far = in + static_cast<long>(rf) * pitch;
      for (int c = 0; c < dw; ++c) sum[c] = near[c] * 3 + far[c];
      fancy_row_h2(sum.data(), dw, w, true, o);
    } else {
      for (int c = 0; c < dw; ++c) sum[c] = near[c];
      fancy_row_h2(sum.data(), dw, w, false, o);
    }
  }
}

// jdcolor.c's YCbCr -> RGB over full-size planes into HWC uint8.
inline void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                       long n, uint8_t* out) {
  constexpr int kBits = 16;
  constexpr int64_t kHalf = int64_t{1} << (kBits - 1);
  auto fix = [](double v) {
    return static_cast<int64_t>(v * (int64_t{1} << kBits) + 0.5);
  };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  auto clamp = [](int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  for (long i = 0; i < n; ++i) {
    const int yy = y[i];
    out[3 * i] = clamp(yy + cr_r[cr[i]]);
    out[3 * i + 1] = clamp(yy + static_cast<int>((cb_g[cb[i]] + cr_g[cr[i]])
                                                 >> kBits));
    out[3 * i + 2] = clamp(yy + cb_b[cb[i]]);
  }
}

// Full-size RGB from the three planes of a YCbCr JPEG: Y (w x h, pitch
// y_pitch) and Cb, Cr (cw x ch, pitch c_pitch, subsampled by hf x vf).
inline void planes_to_rgb(const uint8_t* y, int y_pitch, const uint8_t* cb,
                          const uint8_t* cr, int cw, int ch, int c_pitch,
                          int hf, int vf, int w, int h, uint8_t* out) {
  const size_t n = static_cast<size_t>(w) * h;
  std::vector<uint8_t> yp(n), cbp(n), crp(n);
  for (int r = 0; r < h; ++r)
    for (int x = 0; x < w; ++x)
      yp[static_cast<size_t>(r) * w + x] = y[static_cast<long>(r) * y_pitch + x];
  upsample(cb, cw, ch, c_pitch, hf, vf, cbp.data(), w, h);
  upsample(cr, cw, ch, c_pitch, hf, vf, crp.data(), w, h);
  ycc_to_rgb(yp.data(), cbp.data(), crp.data(), static_cast<long>(n), out);
}

// The transform flag of a JPEG's Adobe APP14 marker (0: RGB or CMYK, 1:
// YCbCr, 2: YCCK), or -1 without one; markers are read up to the first SOS.
// libjpeg takes a four-component file as YCCK when the flag is not 0 and as
// CMYK when it is 0 or there is no marker (jdapimin.c).
inline int adobe_transform(const uint8_t* buf, long len) {
  long pos = 2;                                    // after SOI
  while (pos + 4 <= len) {
    if (buf[pos] != 0xFF) return -1;
    const int marker = buf[pos + 1];
    if (marker == 0xFF) { ++pos; continue; }       // fill byte
    if (marker == 0xDA || marker == 0xD9) return -1;   // SOS, EOI
    const long seg = (static_cast<long>(buf[pos + 2]) << 8) | buf[pos + 3];
    if (seg < 2 || pos + 2 + seg > len) return -1;
    const uint8_t* d = buf + pos + 4;
    if (marker == 0xEE && seg >= 14 && d[0] == 'A' && d[1] == 'd' &&
        d[2] == 'o' && d[3] == 'b' && d[4] == 'e')
      return d[11];
    pos += 2 + seg;
  }
  return -1;
}

// Interleaved CMYK (w x h x 4) from the four planes of a four-component
// JPEG as stored: plane i is pw[i] x ph[i] with row pitch pitch[i],
// subsampled by hf[i] x vf[i] (each 1 or 2, vf 2 only with hf 2), each
// upsampled as libjpeg does; a YCCK file's first three planes are Y, Cb,
// Cr, turned into C, M, Y as libjpeg's ycck_cmyk_convert does (255 minus
// the YCbCr -> RGB of jdcolor.c), K as it is.
inline void planes4_to_cmyk(const uint8_t* const* planes, const int* pw,
                            const int* ph, const int* pitch, const int* hf,
                            const int* vf, bool ycck, int w, int h,
                            uint8_t* cmyk) {
  const size_t n = static_cast<size_t>(w) * h;
  std::vector<uint8_t> full(4 * n);
  for (int i = 0; i < 4; ++i)
    upsample(planes[i], pw[i], ph[i], pitch[i], hf[i], vf[i],
             full.data() + i * n, w, h);
  std::vector<uint8_t> rgb;
  if (ycck) {
    rgb.resize(3 * n);
    ycc_to_rgb(full.data(), full.data() + n, full.data() + 2 * n,
               static_cast<long>(n), rgb.data());
  }
  for (size_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c)
      cmyk[4 * i + c] = ycck ? static_cast<uint8_t>(255 - rgb[3 * i + c])
                             : full[c * n + i];
    cmyk[4 * i + 3] = full[3 * n + i];
  }
}

// OpenCV's subtractive CMYK -> RGB (want_c 3) or luma (want_c 1) over n
// interleaved CMYK pixels: each of C, M, Y becomes k - ((255 - v) * k >> 8)
// (R, G, B), and luma is (1868 B + 9617 G + 4899 R + 2^13) >> 14.
inline void cmyk_to_pixels(const uint8_t* cmyk, long n, int want_c,
                           uint8_t* out) {
  for (long i = 0; i < n; ++i) {
    const int k = cmyk[4 * i + 3];
    const int r = k - (((255 - cmyk[4 * i]) * k) >> 8);
    const int g = k - (((255 - cmyk[4 * i + 1]) * k) >> 8);
    const int b = k - (((255 - cmyk[4 * i + 2]) * k) >> 8);
    if (want_c == 3) {
      out[3 * i] = static_cast<uint8_t>(r);
      out[3 * i + 1] = static_cast<uint8_t>(g);
      out[3 * i + 2] = static_cast<uint8_t>(b);
    } else {
      out[i] = static_cast<uint8_t>((b * 1868 + g * 9617 + r * 4899 +
                                     (1 << 13)) >> 14);
    }
  }
}

}  // namespace cxn_jpeg

#endif  // CXXNET_TPU_TORCH_NATIVE_JPEG_COLOR_H_
