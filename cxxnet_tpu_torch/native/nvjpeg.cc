// JPEG decode on the card through nvJPEG, for the port's image pipeline.
//
// The JAX package decodes JPEG through libjpeg (cxxnet_tpu/native/decode.cc);
// the card's machine has no libjpeg, but the CUDA toolkit carries nvJPEG.
// This is host C++ against nvjpeg.h and the CUDA runtime: it decodes one
// image at a time on the card with nvJPEG's default backend (which takes
// baseline and progressive files), copies the pixels back to host memory and
// returns them as HWC uint8, so the pipeline's contract (decode_image gives a
// numpy array) does not change. Output colour spaces are libjpeg's:
// NVJPEG_OUTPUT_Y for one channel (libjpeg's JCS_GRAYSCALE, the Y plane); a
// grey JPEG asked for three channels has its Y replicated, as libjpeg does.
// For three channels of a 4:4:4, 4:2:2 or 4:2:0 file nvJPEG gives its planes
// (NVJPEG_OUTPUT_YUV) and jpeg_color.h finishes them on the host with
// libjpeg's fancy chroma upsampling and fixed-point colour conversion:
// nvJPEG's own NVJPEG_OUTPUT_RGBI replicates chroma and rounds its colour
// conversion otherwise, and read max 9-11, mean 1.04-1.18 levels from
// libjpeg on the test fixture's 4:2:0 and 4:2:2 files (max 3, mean 0.51 from
// libjpeg without fancy upsampling). Other subsamplings (4:4:0, 4:1:1) take
// NVJPEG_OUTPUT_RGBI. A four-component file (CMYK, or YCCK by its Adobe
// marker) is decoded to its four planes as stored (NVJPEG_OUTPUT_UNCHANGED;
// nvJPEG's own CMYK conversion stays off) and finished by jpeg_color.h as
// the JAX package's cv2 fallback decodes it (planes4_to_cmyk, then OpenCV's
// cmyk_to_pixels); a plane subsampled otherwise than 2x2 or 2x1 is refused
// (kComponents), as is any other number of components.
//
// One Decoder a decode thread: nvjpegJpegState_t is not thread-safe, so each
// thread has its own state, its own non-blocking stream (the legacy default
// stream would serialize with the training step) and its own device and
// pinned buffers, which grow when an image needs more and are never freed
// between images (a cudaFree in the middle of a step would stall the card).
// The nvjpegHandle_t is thread-safe and shared by the decoders of a device.
// Every call sets the decoder's device first, so a pool thread may call it.
//
// A plain C interface loaded with ctypes (which releases the GIL during the
// call). Errors: an nvjpegStatus_t (1..), or kCudaError + a cudaError_t.
//
// Built at first use by cxxnet_tpu_torch/ops/_build.py (load_host):
//   g++ -O3 -fPIC -shared -std=c++17 -o <build>/libnvjpeg-<hash>.so nvjpeg.cc \
//       -I$CUDA_HOME/include -L$CUDA_HOME/lib64 -Wl,-rpath,$CUDA_HOME/lib64 \
//       -lnvjpeg -lcudart

#include <cstdint>
#include <cstring>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include "jpeg_color.h"

namespace {

constexpr int kCudaError = 1000;
constexpr int kComponents = 1001;   // not 1, 3 or 4 finishable components
constexpr int kShape = 1002;        // dims differ from those given

struct Decoder {
  int device;
  nvjpegHandle_t handle;
  nvjpegJpegState_t state;
  cudaStream_t stream;
  unsigned char* dev_buf;
  unsigned char* host_buf;
  size_t cap;
};

#define CXN_CUDA(expr)                                   \
  do {                                                   \
    cudaError_t e_ = (expr);                             \
    if (e_ != cudaSuccess) return kCudaError + (int)e_;  \
  } while (0)

#define CXN_NVJPEG(expr)                                 \
  do {                                                   \
    nvjpegStatus_t s_ = (expr);                          \
    if (s_ != NVJPEG_STATUS_SUCCESS) return (int)s_;     \
  } while (0)

// Room for `bytes` in both buffers, grown to the next MiB past it.
int reserve(Decoder* d, size_t bytes) {
  if (bytes <= d->cap) return 0;
  const size_t cap = (bytes + (1u << 20) - 1) & ~static_cast<size_t>((1u << 20) - 1);
  if (d->dev_buf != nullptr) {
    CXN_CUDA(cudaStreamSynchronize(d->stream));
    CXN_CUDA(cudaFree(d->dev_buf));
    d->dev_buf = nullptr;
  }
  if (d->host_buf != nullptr) {
    CXN_CUDA(cudaFreeHost(d->host_buf));
    d->host_buf = nullptr;
  }
  d->cap = 0;
  CXN_CUDA(cudaMalloc(&d->dev_buf, cap));
  CXN_CUDA(cudaMallocHost(&d->host_buf, cap));
  d->cap = cap;
  return 0;
}

// A four-component file's planes (NVJPEG_OUTPUT_UNCHANGED, plane i of
// widths[i] x heights[i]) finished on the host by jpeg_color.h into `out`.
int decode4(Decoder* d, const unsigned char* buf, long len, int want_c,
            unsigned char* out, const int* widths, const int* heights) {
  const int w = widths[0], h = heights[0];
  int hf[4], vf[4];
  size_t off[5] = {0};
  for (int i = 0; i < 4; ++i) {
    // a plane is full size or halved (rounded up) in each direction
    hf[i] = widths[i] == w ? 1 : (widths[i] == (w + 1) / 2 ? 2 : 0);
    vf[i] = heights[i] == h ? 1 : (heights[i] == (h + 1) / 2 ? 2 : 0);
    if (hf[i] == 0 || vf[i] == 0 || vf[i] > hf[i]) return kComponents;
    off[i + 1] = off[i] + static_cast<size_t>(widths[i]) * heights[i];
  }
  int rc = reserve(d, off[4]);
  if (rc != 0) return rc;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  for (int i = 0; i < 4; ++i) {
    img.channel[i] = d->dev_buf + off[i];
    img.pitch[i] = static_cast<unsigned int>(widths[i]);
  }
  CXN_NVJPEG(nvjpegDecode(d->handle, d->state, buf, static_cast<size_t>(len),
                          NVJPEG_OUTPUT_UNCHANGED, &img, d->stream));
  CXN_CUDA(cudaMemcpyAsync(d->host_buf, d->dev_buf, off[4],
                           cudaMemcpyDeviceToHost, d->stream));
  CXN_CUDA(cudaStreamSynchronize(d->stream));
  const unsigned char* planes[4];
  for (int i = 0; i < 4; ++i) planes[i] = d->host_buf + off[i];
  std::vector<unsigned char> cmyk(static_cast<size_t>(w) * h * 4);
  cxn_jpeg::planes4_to_cmyk(planes, widths, heights, widths, hf, vf,
                            cxn_jpeg::adobe_transform(buf, len) > 0, w, h,
                            cmyk.data());
  cxn_jpeg::cmyk_to_pixels(cmyk.data(), static_cast<long>(w) * h, want_c,
                           out);
  return 0;
}

}  // namespace

extern "C" {

// A shared nvJPEG handle for `device` (default backend), into *out.
int cxn_nvjpeg_handle(int device, void** out) {
  CXN_CUDA(cudaSetDevice(device));
  nvjpegHandle_t h = nullptr;
  CXN_NVJPEG(nvjpegCreateSimple(&h));
  *out = h;
  return 0;
}

// One thread's decoder on `device` over the shared `handle`, into *out.
int cxn_nvjpeg_create(int device, void* handle, void** out) {
  CXN_CUDA(cudaSetDevice(device));
  Decoder* d = new Decoder();
  d->device = device;
  d->handle = static_cast<nvjpegHandle_t>(handle);
  d->state = nullptr;
  d->stream = nullptr;
  d->dev_buf = nullptr;
  d->host_buf = nullptr;
  d->cap = 0;
  nvjpegStatus_t s = nvjpegJpegStateCreate(d->handle, &d->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    delete d;
    return static_cast<int>(s);
  }
  cudaError_t e = cudaStreamCreateWithFlags(&d->stream,
                                            cudaStreamNonBlocking);
  if (e != cudaSuccess) {
    nvjpegJpegStateDestroy(d->state);
    delete d;
    return kCudaError + static_cast<int>(e);
  }
  *out = d;
  return 0;
}

// Free a decoder (its state, stream and buffers).
int cxn_nvjpeg_destroy(void* ctx) {
  Decoder* d = static_cast<Decoder*>(ctx);
  if (d == nullptr) return 0;
  cudaSetDevice(d->device);
  if (d->stream != nullptr) cudaStreamSynchronize(d->stream);
  if (d->dev_buf != nullptr) cudaFree(d->dev_buf);
  if (d->host_buf != nullptr) cudaFreeHost(d->host_buf);
  if (d->state != nullptr) nvjpegJpegStateDestroy(d->state);
  if (d->stream != nullptr) cudaStreamDestroy(d->stream);
  delete d;
  return 0;
}

// Height, width and number of components of a JPEG.
int cxn_nvjpeg_info(void* ctx, const unsigned char* buf, long len, int* h,
                    int* w, int* ncomp) {
  Decoder* d = static_cast<Decoder*>(ctx);
  int nc = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  CXN_NVJPEG(nvjpegGetImageInfo(d->handle, buf, static_cast<size_t>(len),
                                &nc, &css, widths, heights));
  *h = heights[0];
  *w = widths[0];
  *ncomp = nc;
  return 0;
}

// Decode a JPEG into `out` (row-major HWC uint8 of out_h * out_w * want_c
// bytes; want_c 3 = RGB, 1 = gray) on the decoder's device and stream.
int cxn_nvjpeg_decode(void* ctx, const unsigned char* buf, long len,
                      int want_c, unsigned char* out, int out_h, int out_w) {
  Decoder* d = static_cast<Decoder*>(ctx);
  if (want_c != 1 && want_c != 3) return NVJPEG_STATUS_INVALID_PARAMETER;
  CXN_CUDA(cudaSetDevice(d->device));
  int nc = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  CXN_NVJPEG(nvjpegGetImageInfo(d->handle, buf, static_cast<size_t>(len),
                                &nc, &css, widths, heights));
  if (nc != 1 && nc != 3 && nc != 4) return kComponents;
  if (heights[0] != out_h || widths[0] != out_w) return kShape;
  if (nc == 4) return decode4(d, buf, len, want_c, out, widths, heights);
  // a grey file is decoded as its Y plane and replicated on the host; a
  // 4:4:4, 4:2:2 or 4:2:0 colour file as its planes, finished on the host
  const bool y_only = want_c == 1 || nc == 1;
  int hf = 0, vf = 0;
  if (!y_only) {
    if (css == NVJPEG_CSS_444) { hf = 1; vf = 1; }
    else if (css == NVJPEG_CSS_422) { hf = 2; vf = 1; }
    else if (css == NVJPEG_CSS_420) { hf = 2; vf = 2; }
  }
  const bool planar = hf != 0;
  const size_t y_bytes = static_cast<size_t>(out_w) * out_h;
  const int cw = planar ? widths[1] : 0, ch = planar ? heights[1] : 0;
  size_t bytes;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  nvjpegOutputFormat_t fmt;
  if (y_only) {
    bytes = y_bytes;
    fmt = NVJPEG_OUTPUT_Y;
  } else if (planar) {
    bytes = y_bytes + 2 * static_cast<size_t>(cw) * ch;
    fmt = NVJPEG_OUTPUT_YUV;
  } else {
    bytes = 3 * y_bytes;
    fmt = NVJPEG_OUTPUT_RGBI;
  }
  int rc = reserve(d, bytes);
  if (rc != 0) return rc;
  img.channel[0] = d->dev_buf;
  img.pitch[0] = static_cast<unsigned int>(fmt == NVJPEG_OUTPUT_RGBI
                                               ? 3 * out_w : out_w);
  if (planar) {
    img.channel[1] = d->dev_buf + y_bytes;
    img.channel[2] = d->dev_buf + y_bytes + static_cast<size_t>(cw) * ch;
    img.pitch[1] = img.pitch[2] = static_cast<unsigned int>(cw);
  }
  CXN_NVJPEG(nvjpegDecode(d->handle, d->state, buf, static_cast<size_t>(len),
                          fmt, &img, d->stream));
  CXN_CUDA(cudaMemcpyAsync(d->host_buf, d->dev_buf, bytes,
                           cudaMemcpyDeviceToHost, d->stream));
  CXN_CUDA(cudaStreamSynchronize(d->stream));
  const unsigned char* hb = d->host_buf;
  if (planar) {
    const unsigned char* cb = hb + y_bytes;
    cxn_jpeg::planes_to_rgb(hb, out_w, cb, cb + static_cast<size_t>(cw) * ch,
                            cw, ch, cw, hf, vf, out_w, out_h, out);
  } else if (!y_only || want_c == 1) {
    std::memcpy(out, hb, bytes);
  } else {                       // grey file, three channels asked for
    for (size_t i = 0; i < y_bytes; ++i) {
      out[3 * i] = hb[i];
      out[3 * i + 1] = hb[i];
      out[3 * i + 2] = hb[i];
    }
  }
  return 0;
}

// The CUDA runtime's message for an error code this library returned.
const char* cxn_nvjpeg_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code - kCudaError));
}

}  // extern "C"
