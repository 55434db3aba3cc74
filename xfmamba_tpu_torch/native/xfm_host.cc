// Host-side kernels of the port's data path, bound with ctypes by
// xfmamba_tpu_torch/native/__init__.py (built with g++ at first use).
//
// normalize_u8_f32: the port's copy of xfmamba_tpu/native/xfm_host.cc's
// u8 -> normalised float32 pack.
// png_unfilter: undoes the PNG row filters (None, Sub, Up, Average, Paeth;
// PNG spec section 9) of a whole image in one call.

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

}  // extern "C"
