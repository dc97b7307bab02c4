// PNG pixel reconstruction for the port's image pipeline.
//
// C over the bytes that Python's zlib.decompress inflated from a PNG's IDAT
// chunks, so it needs neither zlib's nor libpng's headers and builds wherever
// g++ does. It undoes the five row filters, de-interlaces Adam7, reads bit
// depths 1, 2, 4, 8 and 16 of every colour type, looks palette entries up and
// drops alpha. The pixels are those of OpenCV's imdecode (libpng): a 16-bit
// sample keeps its high byte, a sub-8-bit gray sample is scaled to 0..255
// (v * 255 / (2^depth - 1)), palette indices past the palette read black.
// One channel from a colour image is PIL's ITU-R 601-2 luma in its fixed
// point, (19595 R + 38470 G + 7471 B + 2^15) >> 16.
//
// A plain C interface loaded with ctypes, which releases the GIL during the
// call, so the iterator's decode threads run it in parallel; it keeps no
// state and is thread-safe.
//
// Built at first use by cxxnet_tpu_torch/ops/_build.py (load_host):
//   g++ -O3 -fPIC -shared -std=c++17 -o <build>/libpng-<hash>.so png.cc

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Pass {
  int x0, y0, dx, dy;
};

const Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                        {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                        {0, 1, 1, 2}};
const Pass kWhole = {0, 0, 1, 1};

int channels_of(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool depth_allowed(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Undo one row's filter in place: `cur` holds the filtered bytes, `prev` the
// reconstructed row above (zeros for a pass's first row). Returns false on an
// unknown filter type.
bool unfilter_row(int ftype, uint8_t* cur, const uint8_t* prev, long stride,
                  int bpp) {
  switch (ftype) {
    case 0:
      return true;
    case 1:
      for (long i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
      return true;
    case 2:
      for (long i = 0; i < stride; ++i) cur[i] += prev[i];
      return true;
    case 3:
      for (long i = 0; i < bpp && i < stride; ++i) cur[i] += prev[i] >> 1;
      for (long i = bpp; i < stride; ++i)
        cur[i] += static_cast<uint8_t>((cur[i - bpp] + prev[i]) >> 1);
      return true;
    case 4:
      for (long i = 0; i < bpp && i < stride; ++i) cur[i] += prev[i];
      for (long i = bpp; i < stride; ++i)
        cur[i] += paeth(cur[i - bpp], prev[i], prev[i - bpp]);
      return true;
    default:
      return false;
  }
}

inline uint8_t luma(uint8_t r, uint8_t g, uint8_t b) {
  return static_cast<uint8_t>((19595u * r + 38470u * g + 7471u * b + 0x8000u)
                              >> 16);
}

}  // namespace

extern "C" {

// Bytes of inflated image data a PNG of this header needs (the filter byte
// of every row of every pass included); -1 for a header the decoder does not
// take.
long cxn_png_raw_size(int w, int h, int depth, int ctype, int interlace) {
  if (w <= 0 || h <= 0 || !depth_allowed(ctype, depth) || interlace < 0 ||
      interlace > 1)
    return -1;
  const long bits = static_cast<long>(channels_of(ctype)) * depth;
  long total = 0;
  const int npass = interlace ? 7 : 1;
  for (int p = 0; p < npass; ++p) {
    const Pass ps = interlace ? kAdam7[p] : kWhole;
    const long pw = (w - ps.x0 + ps.dx - 1) / ps.dx;
    const long ph = (h - ps.y0 + ps.dy - 1) / ps.dy;
    if (pw <= 0 || ph <= 0) continue;
    total += ph * (1 + (pw * bits + 7) / 8);
  }
  return total;
}

// Reconstruct the pixels of a PNG into `out` (row-major HWC uint8 of
// h * w * want_c bytes; want_c 3 = RGB, 1 = gray or luma). `raw` is the
// inflated IDAT stream, `plte` the PLTE chunk's bytes (plte_len of them, a
// multiple of 3; may be empty unless ctype is 3). Returns 0 on success, -1
// for a header it does not take, -2 for data shorter than the header needs,
// -3 for an unknown row filter, -4 for a palette image without a palette.
int cxn_png_decode(const uint8_t* raw, long raw_len, int w, int h, int depth,
                   int ctype, int interlace, const uint8_t* plte,
                   int plte_len, int want_c, uint8_t* out) {
  const long need = cxn_png_raw_size(w, h, depth, ctype, interlace);
  if (need < 0 || (want_c != 1 && want_c != 3)) return -1;
  if (raw_len < need) return -2;
  if (ctype == 3 && plte_len < 3) return -4;
  const int ch = channels_of(ctype);
  const long bits = static_cast<long>(ch) * depth;
  const int bpp = bits >= 8 ? static_cast<int>(bits / 8) : 1;
  const int mask = depth >= 8 ? 255 : (1 << depth) - 1;
  const int gray_scale = depth >= 8 ? 1 : 255 / mask;
  uint8_t pal[256 * 3];
  std::memset(pal, 0, sizeof(pal));
  if (ctype == 3) {
    const int n = plte_len / 3 < 256 ? plte_len / 3 : 256;
    std::memcpy(pal, plte, static_cast<size_t>(n) * 3);
  }
  const long full_stride = (static_cast<long>(w) * bits + 7) / 8;
  std::vector<uint8_t> rows(2 * static_cast<size_t>(full_stride));
  const int npass = interlace ? 7 : 1;
  const uint8_t* src = raw;
  for (int p = 0; p < npass; ++p) {
    const Pass ps = interlace ? kAdam7[p] : kWhole;
    const long pw = (w - ps.x0 + ps.dx - 1) / ps.dx;
    const long ph = (h - ps.y0 + ps.dy - 1) / ps.dy;
    if (pw <= 0 || ph <= 0) continue;
    const long stride = (pw * bits + 7) / 8;
    uint8_t* prev = rows.data();
    uint8_t* cur = rows.data() + full_stride;
    std::memset(prev, 0, static_cast<size_t>(stride));
    for (long r = 0; r < ph; ++r) {
      const int ftype = *src++;
      std::memcpy(cur, src, static_cast<size_t>(stride));
      src += stride;
      if (!unfilter_row(ftype, cur, prev, stride, bpp)) return -3;
      uint8_t* orow = out + ((ps.y0 + r * ps.dy) * static_cast<long>(w)) *
                                want_c;
      for (long x = 0; x < pw; ++x) {
        uint8_t s[4];
        if (depth == 16) {
          for (int c = 0; c < ch; ++c) s[c] = cur[(x * ch + c) * 2];
        } else if (depth == 8) {
          for (int c = 0; c < ch; ++c) s[c] = cur[x * ch + c];
        } else {               // one channel: gray or palette index
          const long bit = x * depth;
          const int v = (cur[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
          s[0] = static_cast<uint8_t>(ctype == 0 ? v * gray_scale : v);
        }
        uint8_t r8, g8, b8;
        bool gray = false;
        if (ctype == 3) {
          r8 = pal[s[0] * 3];
          g8 = pal[s[0] * 3 + 1];
          b8 = pal[s[0] * 3 + 2];
        } else if (ctype == 0 || ctype == 4) {
          r8 = g8 = b8 = s[0];
          gray = true;
        } else {
          r8 = s[0];
          g8 = s[1];
          b8 = s[2];
        }
        uint8_t* o = orow + (ps.x0 + x * ps.dx) * want_c;
        if (want_c == 3) {
          o[0] = r8;
          o[1] = g8;
          o[2] = b8;
        } else {
          o[0] = gray ? r8 : luma(r8, g8, b8);
        }
      }
      uint8_t* t = prev;
      prev = cur;
      cur = t;
    }
  }
  return 0;
}

}  // extern "C"
