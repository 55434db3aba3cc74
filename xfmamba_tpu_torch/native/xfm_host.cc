// Host-side kernels of the port's data path, bound with ctypes by
// xfmamba_tpu_torch/native/__init__.py (built with g++ at first use).
//
// normalize_u8_f32: the port's copy of xfmamba_tpu/native/xfm_host.cc's
// u8 -> normalised float32 pack.
// png_unfilter: undoes the PNG row filters (None, Sub, Up, Average, Paeth;
// PNG spec section 9) of a whole image in one call.
// png_adam7: the same for an Adam7-interlaced image, pass by pass, with each
// pass's pixels put in place in the whole image's rows (PNG spec 8.2).
// png_unpack: samples of 1, 2 or 4 bits to one byte each, as they are or
// scaled to 0-255 (libpng's png_do_expand for gray).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// dst = (src/255 - mean) / std, elementwise over n values.
void normalize_u8_f32(const uint8_t* src, float* dst, int64_t n,
                      float mean, float stdv) {
  const float scale = 1.0f / (255.0f * stdv);
  const float shift = -mean / stdv;
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    for (int j = 0; j < 8; ++j)
      dst[i + j] = (float)src[i + j] * scale + shift;
  }
  for (; i < n; ++i) dst[i] = (float)src[i] * scale + shift;
}

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// `src`: `height` rows of one filter-type byte and `rowbytes` filtered
// bytes (the inflated IDAT stream); `dst`: height * rowbytes raw bytes.
// `bpp`: bytes per complete pixel, at least 1.  Returns 0, or 1 + the row
// whose filter type is not 0-4.
int64_t png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
                     int64_t rowbytes, int bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + y * rowbytes;
    const uint8_t* up = y ? out - rowbytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(out, in, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = up ? up[i] : 0;
          out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          out[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// The seven passes: (first row, first column, row step, column step).
static const int kAdam7[7][4] = {{0, 0, 8, 8}, {0, 4, 8, 8}, {4, 0, 8, 4}, {0, 2, 4, 4},
                                 {2, 0, 4, 2}, {0, 1, 2, 2}, {1, 0, 2, 1}};

// `src`: the inflated stream of an interlaced image (each nonempty pass's
// rows, a filter-type byte and its packed row bytes each); `dst`: height
// rows of ceil(width * bits / 8) bytes, pixels packed as in a plain image.
// `bits`: bits per pixel (1, 2, 4, 8, 16, 24, 32, 48 or 64).  Returns 0,
// -1 when `src` is short, or 1 + the index (over all passes' rows) of the
// row whose filter type is not 0-4.
int64_t png_adam7(const uint8_t* src, int64_t n, uint8_t* dst, int64_t width, int64_t height,
                  int bits) {
  const int64_t rowbytes = (width * bits + 7) / 8;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  std::memset(dst, 0, (size_t)(rowbytes * height));
  int64_t row_index = 0, pos = 0;
  for (const auto& p : kAdam7) {
    const int64_t pw = width > p[1] ? (width - p[1] + p[3] - 1) / p[3] : 0;
    const int64_t ph = height > p[0] ? (height - p[0] + p[2] - 1) / p[2] : 0;
    if (pw == 0 || ph == 0) continue;
    const int64_t prb = (pw * bits + 7) / 8;
    if (pos + ph * (prb + 1) > n) return -1;
    uint8_t* rows = (uint8_t*)std::malloc((size_t)(ph * prb));
    const int64_t bad = png_unfilter(src + pos, rows, ph, prb, bpp);
    if (bad) {
      std::free(rows);
      return row_index + bad;
    }
    for (int64_t y = 0; y < ph; ++y) {
      const uint8_t* in = rows + y * prb;
      uint8_t* out = dst + (p[0] + y * p[2]) * rowbytes;
      for (int64_t x = 0; x < pw; ++x) {
        const int64_t ox = p[1] + x * p[3];
        if (bits >= 8) {
          std::memcpy(out + ox * bpp, in + x * bpp, bpp);
        } else {
          const int v = (in[(x * bits) >> 3] >> (8 - bits - ((x * bits) & 7))) & ((1 << bits) - 1);
          out[(ox * bits) >> 3] |= (uint8_t)(v << (8 - bits - ((ox * bits) & 7)));
        }
      }
    }
    std::free(rows);
    pos += ph * (prb + 1);
    row_index += ph;
  }
  return 0;
}

// `src`: height rows of `rowbytes` bytes of `depth`-bit samples (1, 2 or
// 4), most significant first; `dst`: height x width bytes.  With `scale`,
// each sample v becomes v * 255 / (2^depth - 1).
void png_unpack(const uint8_t* src, uint8_t* dst, int64_t height, int64_t width,
                int64_t rowbytes, int depth, int scale) {
  const int mask = (1 << depth) - 1, mul = scale ? 255 / mask : 1;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * rowbytes;
    uint8_t* out = dst + y * width;
    for (int64_t x = 0; x < width; ++x) {
      const int64_t b = x * depth;
      out[x] = (uint8_t)(((in[b >> 3] >> (8 - depth - (b & 7))) & mask) * mul);
    }
  }
}

}  // extern "C"
