// Writes a YCCK JPEG (Adobe transform 2) from raw interleaved CMYK, for the
// JPEG fixture of the decoders' tests (tests/torch_jpeg_fixture.py), which
// PIL cannot write. libjpeg's defaults for YCCK sample Y and K 2x2 and Cb,
// Cr 1x1.
//   g++ -O2 -o ycck_writer torch_ycck_writer.cc -ljpeg
//   ycck_writer <height> <width> <quality> <cmyk.raw> <out.jpg>

#include <cstdio>
#include <cstdlib>
#include <vector>

#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const int h = std::atoi(argv[1]), w = std::atoi(argv[2]);
  const int quality = std::atoi(argv[3]);
  std::vector<unsigned char> px(static_cast<size_t>(h) * w * 4);
  FILE* in = std::fopen(argv[4], "rb");
  if (in == nullptr || std::fread(px.data(), 1, px.size(), in) != px.size())
    return 3;
  std::fclose(in);
  FILE* out = std::fopen(argv[5], "wb");
  if (out == nullptr) return 4;
  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 4;
  cinfo.in_color_space = JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  jpeg_set_colorspace(&cinfo, JCS_YCCK);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = px.data() + static_cast<size_t>(cinfo.next_scanline) * w * 4;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(out);
  return 0;
}
