// Native BMP serializer and heat-map colorizer.
//
// A copy of stencil_tpu/native/bmp.cpp: the blue->green->red colorizer and
// the hand-rolled BITMAPFILEHEADER/BITMAPINFOHEADER writer behind the
// CLI's --dump-image. It runs on the host. It is compiled with g++ on
// first use (stencil_tpu_torch/_build.py) and loaded with ctypes by
// stencil_tpu_torch/utils/image.py, whose pure-Python writer stays the
// fallback; tests/test_torch_image.py holds the two byte for byte.
//
// Exported ABI (C):
//   stencil_bmp_write(path, rgb_hwc_u8, h, w) -> 0 ok / nonzero errno-ish
//   stencil_colorize(values_f64, n, vmin, vmax, rgb_out_u8)
//       blue->green->red ramp over [vmin, vmax], 3 bytes per value.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

void put_u16(uint8_t* p, uint16_t v) {
  p[0] = static_cast<uint8_t>(v & 0xff);
  p[1] = static_cast<uint8_t>(v >> 8);
}

void put_u32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v & 0xff);
  p[1] = static_cast<uint8_t>((v >> 8) & 0xff);
  p[2] = static_cast<uint8_t>((v >> 16) & 0xff);
  p[3] = static_cast<uint8_t>((v >> 24) & 0xff);
}

}  // namespace

extern "C" {

// rgb: (h, w, 3) row-major, top-down, RGB order. Emits a 24-bit
// uncompressed BMP (bottom-up rows, BGR, 4-byte row padding) — the same
// wire format as the reference writer.
int stencil_bmp_write(const char* path, const uint8_t* rgb, int64_t h,
                      int64_t w) {
  if (h <= 0 || w <= 0) return 22;  // EINVAL
  const int64_t row_bytes = w * 3;
  const int64_t pad = (4 - (row_bytes % 4)) % 4;
  const int64_t image_size = (row_bytes + pad) * h;
  const uint32_t data_offset = 14 + 40;
  const uint32_t file_size = static_cast<uint32_t>(data_offset + image_size);

  uint8_t header[54];
  std::memset(header, 0, sizeof(header));
  header[0] = 'B';
  header[1] = 'M';
  put_u32(header + 2, file_size);
  put_u32(header + 10, data_offset);
  put_u32(header + 14, 40);                          // BITMAPINFOHEADER
  put_u32(header + 18, static_cast<uint32_t>(w));
  put_u32(header + 22, static_cast<uint32_t>(h));
  put_u16(header + 26, 1);                           // planes
  put_u16(header + 28, 24);                          // bpp
  put_u32(header + 34, static_cast<uint32_t>(image_size));
  put_u32(header + 38, 2835);                        // 72 DPI
  put_u32(header + 42, 2835);

  std::FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  if (std::fwrite(header, 1, sizeof(header), f) != sizeof(header)) {
    std::fclose(f);
    return 2;
  }
  std::vector<uint8_t> row(static_cast<size_t>(row_bytes + pad), 0);
  // bottom-up rows, BGR channel order
  for (int64_t y = h - 1; y >= 0; --y) {
    const uint8_t* src = rgb + y * row_bytes;
    for (int64_t x = 0; x < w; ++x) {
      row[static_cast<size_t>(3 * x) + 0] = src[3 * x + 2];
      row[static_cast<size_t>(3 * x) + 1] = src[3 * x + 1];
      row[static_cast<size_t>(3 * x) + 2] = src[3 * x + 0];
    }
    if (std::fwrite(row.data(), 1, row.size(), f) != row.size()) {
      std::fclose(f);
      return 2;
    }
  }
  return std::fclose(f) == 0 ? 0 : 3;
}

// The reference's exact 4-segment piecewise ramp (stencil.cpp:162-183):
// blue -> cyan (v=0.25) -> green -> yellow -> red, channels TRUNCATED to
// u8 like its static_cast<unsigned char>. Values normalized to
// [vmin, vmax] and clamped (the reference asserts v <= 1 instead).
// Bit-for-bit identical to utils.image.colorize (cross-checked in tests).
void stencil_colorize(const double* values, int64_t n, double vmin,
                      double vmax, uint8_t* rgb_out) {
  const double span = (vmax > vmin) ? (vmax - vmin) : 1.0;
  for (int64_t i = 0; i < n; ++i) {
    double v = (values[i] - vmin) / span;
    if (v < 0.0) v = 0.0;
    if (v > 1.0) v = 1.0;
    uint8_t r, g, b;
    if (v < 0.25) {
      r = 0;
      g = static_cast<uint8_t>(4.0 * v * 255.0);
      b = 255;
    } else if (v < 0.5) {
      r = 0;
      g = 255;
      b = static_cast<uint8_t>((1.0 + 4.0 * (0.25 - v)) * 255.0);
    } else if (v < 0.75) {
      r = static_cast<uint8_t>(4.0 * (v - 0.5) * 255.0);
      g = 255;
      b = 0;
    } else {
      r = 255;
      g = static_cast<uint8_t>((1.0 + 4.0 * (0.75 - v)) * 255.0);
      b = 0;
    }
    rgb_out[3 * i + 0] = r;
    rgb_out[3 * i + 1] = g;
    rgb_out[3 * i + 2] = b;
  }
}

}  // extern "C"
