// JPEG decode through libjpeg, for the port's image pipeline.
//
// The port's copy of the JPEG part of cxxnet_tpu/native/decode.cc: the same
// libjpeg calls and output colour spaces (JCS_RGB, or JCS_GRAYSCALE for one
// channel), so on the same libjpeg the pixels are bit-equal to the JAX
// package's native decoder. A plain C interface loaded with ctypes (which
// releases the GIL during the call, so a thread pool decodes in parallel);
// every entry point is thread-safe. A four-component file (CMYK, or YCCK) is
// decoded to JCS_CMYK and finished by jpeg_color.h's cmyk_to_pixels: the
// pixels of the JAX package's cv2 fallback, which answers for such files.
//
// Besides, cxn_jpeg_planes reads a YCbCr file's component planes as stored
// (libjpeg's raw data output) and cxn_jpeg_planes_to_rgb finishes them with
// jpeg_color.h's copy of libjpeg's upsampling and colour conversion, the code
// that nvjpeg.cc runs over nvJPEG's planes: the CPU tests hold the two
// together bit for bit with libjpeg's own RGB.
//
// Built at first use by cxxnet_tpu_torch/ops/_build.py (load_host):
//   g++ -O3 -fPIC -shared -std=c++17 -o <build>/libdecode-<hash>.so decode.cc -ljpeg

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

#include "jpeg_color.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* mgr = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(mgr->jump, 1);
}

void silent_output(j_common_ptr) {}

}  // namespace

extern "C" {

// Dimensions of a JPEG. Returns 0 on success, -1 if it is not one.
int cxn_jpeg_dims(const uint8_t* buf, long len, int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.output_message = silent_output;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  *c = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode a JPEG into `out` (row-major HWC uint8), which holds
// out_h * out_w * want_c bytes (dims from cxn_jpeg_dims). want_c: 3 = RGB,
// 1 = gray. A four-component file (CMYK or YCCK) is decoded to libjpeg's
// JCS_CMYK and converted by jpeg_color.h's cmyk_to_pixels (OpenCV's
// conversion, which the JAX package reaches for such files). Returns 0 on
// success, -1 on a decode error, -2 on a size that is not the one given.
int cxn_jpeg_decode(const uint8_t* buf, long len, int want_c, uint8_t* out,
                    int out_h, int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  std::vector<uint8_t> cmyk;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.output_message = silent_output;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  const bool four = cinfo.num_components == 4;
  cinfo.out_color_space = four ? JCS_CMYK
                               : (want_c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w ||
      static_cast<int>(cinfo.output_components) != (four ? 4 : want_c)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  if (four) cmyk.resize(static_cast<size_t>(out_h) * out_w * 4);
  const int stride = out_w * (four ? 4 : want_c);
  uint8_t* dst = four ? cmyk.data() : out;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + static_cast<long>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (four)
    cxn_jpeg::cmyk_to_pixels(cmyk.data(), static_cast<long>(out_h) * out_w,
                             want_c, out);
  return 0;
}

// The three component planes of a YCbCr JPEG as stored: Y into `y` (h x w),
// Cb and Cr into `cb`, `cr` (dims[2] x dims[3] each, the subsampled size
// libjpeg computes). Called first with y == nullptr to get dims = {h, w,
// c_h, c_w}. Returns 0, -1 on a decode error, -3 for a file that is not
// three components with the chroma sampled alike.
int cxn_jpeg_planes(const uint8_t* buf, long len, uint8_t* y, uint8_t* cb,
                    uint8_t* cr, int* dims) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.output_message = silent_output;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components != 3 ||
      cinfo.comp_info[1].h_samp_factor != cinfo.comp_info[2].h_samp_factor ||
      cinfo.comp_info[1].v_samp_factor != cinfo.comp_info[2].v_samp_factor) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  dims[0] = cinfo.image_height;
  dims[1] = cinfo.image_width;
  dims[2] = cinfo.comp_info[1].downsampled_height;
  dims[3] = cinfo.comp_info[1].downsampled_width;
  if (y == nullptr) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  uint8_t* planes[3] = {y, cb, cr};
  std::vector<std::vector<uint8_t>> store(3);
  std::vector<std::vector<JSAMPROW>> rows(3);
  JSAMPARRAY bufs[3];
  for (int c = 0; c < 3; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    const int nrow = comp.v_samp_factor * DCTSIZE;
    const int width = comp.width_in_blocks * DCTSIZE;
    store[c].resize(static_cast<size_t>(nrow) * width);
    rows[c].resize(nrow);
    for (int r = 0; r < nrow; ++r) rows[c][r] = store[c].data() + r * width;
    bufs[c] = rows[c].data();
  }
  const int step = cinfo.max_v_samp_factor * DCTSIZE;
  for (int imcu = 0; cinfo.output_scanline < cinfo.output_height; ++imcu) {
    jpeg_read_raw_data(&cinfo, bufs, step);
    for (int c = 0; c < 3; ++c) {
      const jpeg_component_info& comp = cinfo.comp_info[c];
      const int nrow = comp.v_samp_factor * DCTSIZE;
      const int dh = comp.downsampled_height, dw = comp.downsampled_width;
      for (int r = 0; r < nrow && imcu * nrow + r < dh; ++r)
        std::memcpy(planes[c] + static_cast<long>(imcu * nrow + r) * dw,
                    rows[c][r], static_cast<size_t>(dw));
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// RGB (h x w x 3) from planes as cxn_jpeg_planes gives them, chroma
// subsampled by hf x vf, through jpeg_color.h.
void cxn_jpeg_planes_to_rgb(const uint8_t* y, const uint8_t* cb,
                            const uint8_t* cr, int h, int w, int ch, int cw,
                            int hf, int vf, uint8_t* out) {
  cxn_jpeg::planes_to_rgb(y, w, cb, cr, cw, ch, cw, hf, vf, w, h, out);
}

// A four-component JPEG decoded the way nvjpeg.cc finishes nvJPEG's
// NVJPEG_OUTPUT_UNCHANGED planes: libjpeg's raw component planes, then
// jpeg_color.h's planes4_to_cmyk (YCCK by the Adobe marker) and
// cmyk_to_pixels, into `out` (out_h x out_w x want_c). The CPU tests hold it
// bit-equal to cxn_jpeg_decode's JCS_CMYK route. Returns 0, -1 on a decode
// error, -2 on another size, -3 for a file that is not four components
// with each plane full size or halved (h2v1, h2v2).
int cxn_jpeg_decode4_planar(const uint8_t* buf, long len, int want_c,
                            uint8_t* out, int out_h, int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  std::vector<std::vector<uint8_t>> store(4), planes(4);
  std::vector<std::vector<JSAMPROW>> rows(4);
  std::vector<uint8_t> cmyk;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  err.pub.output_message = silent_output;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components != 4) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  int pw[4], ph[4], hf[4], vf[4];
  for (int c = 0; c < 4; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    hf[c] = cinfo.max_h_samp_factor / comp.h_samp_factor;
    vf[c] = cinfo.max_v_samp_factor / comp.v_samp_factor;
    if (hf[c] * comp.h_samp_factor != cinfo.max_h_samp_factor ||
        vf[c] * comp.v_samp_factor != cinfo.max_v_samp_factor ||
        hf[c] > 2 || vf[c] > hf[c]) {
      jpeg_destroy_decompress(&cinfo);
      return -3;
    }
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  JSAMPARRAY bufs[4];
  for (int c = 0; c < 4; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    pw[c] = comp.downsampled_width;
    ph[c] = comp.downsampled_height;
    planes[c].resize(static_cast<size_t>(pw[c]) * ph[c]);
    const int nrow = comp.v_samp_factor * DCTSIZE;
    const int width = comp.width_in_blocks * DCTSIZE;
    store[c].resize(static_cast<size_t>(nrow) * width);
    rows[c].resize(nrow);
    for (int r = 0; r < nrow; ++r) rows[c][r] = store[c].data() + r * width;
    bufs[c] = rows[c].data();
  }
  const int step = cinfo.max_v_samp_factor * DCTSIZE;
  for (int imcu = 0; cinfo.output_scanline < cinfo.output_height; ++imcu) {
    jpeg_read_raw_data(&cinfo, bufs, step);
    for (int c = 0; c < 4; ++c) {
      const int nrow = cinfo.comp_info[c].v_samp_factor * DCTSIZE;
      for (int r = 0; r < nrow && imcu * nrow + r < ph[c]; ++r)
        std::memcpy(planes[c].data() + static_cast<long>(imcu * nrow + r) *
                        pw[c], rows[c][r], static_cast<size_t>(pw[c]));
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  const uint8_t* ptrs[4] = {planes[0].data(), planes[1].data(),
                            planes[2].data(), planes[3].data()};
  const bool ycck = cxn_jpeg::adobe_transform(buf, len) > 0;
  cmyk.resize(static_cast<size_t>(out_h) * out_w * 4);
  cxn_jpeg::planes4_to_cmyk(ptrs, pw, ph, pw, hf, vf, ycck, out_w, out_h,
                            cmyk.data());
  cxn_jpeg::cmyk_to_pixels(cmyk.data(), static_cast<long>(out_h) * out_w,
                           want_c, out);
  return 0;
}

}  // extern "C"
