// JPEG decode through libjpeg, for the port's image pipeline.
//
// The port's copy of the JPEG part of cxxnet_tpu/native/decode.cc: the same
// libjpeg calls and output colour spaces (JCS_RGB, or JCS_GRAYSCALE for one
// channel), so on the same libjpeg the pixels are bit-equal to the JAX
// package's native decoder. A plain C interface loaded with ctypes (which
// releases the GIL during the call, so a thread pool decodes in parallel);
// every entry point is thread-safe.
//
// Built at first use by cxxnet_tpu_torch/ops/_build.py (load_host):
//   g++ -O3 -fPIC -shared -std=c++17 -o <build>/libdecode-<hash>.so decode.cc -ljpeg

#include <csetjmp>
#include <cstdint>
#include <cstdio>

#include <jpeglib.h>

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
// 1 = gray. Returns 0 on success, -1 on a decode error, -2 on a size that
// is not the one given.
int cxn_jpeg_decode(const uint8_t* buf, long len, int want_c, uint8_t* out,
                    int out_h, int out_w) {
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
  cinfo.out_color_space = (want_c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w ||
      static_cast<int>(cinfo.output_components) != want_c) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  const int stride = out_w * want_c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
