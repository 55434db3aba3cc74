// The run-length loops of the port's BMP and Sun raster readers
// (xfmamba_tpu_torch/data/bmp.py, data/sunras.py), bound with ctypes by
// native/__init__.py, so the GIL is released while they run.
//
// bmp_rle_cv2: OpenCV's BmpDecoder::readData for RLE8 / RLE4 into 8-bit
// gray (grfmt_bmp.cpp): runs and absolute runs may not pass the end of a
// row; end of line, end of bitmap and delta all *fill* with palette entry
// 0 (end of bitmap: the rest of the image, delta: dx + dy * width pixels)
// rather than skip; a row ended by a run needs no end of line.
// bmp_rle_pil: Pillow's BmpRleDecoder (BmpImagePlugin.py), which pads rows
// with zeros, clips runs at the row's end, reads a delta's bytes twice and
// aligns absolute runs to the file's even offsets.
// sunras_rle: the byte-encoded Sun raster (RT_BYTE_ENCODED) expansion.

#include <cstdint>
#include <cstring>

extern "C" {

// Returns 0 when every row was decoded, 1 when a run passes a row's end
// (cv2 stops and reads nothing), 2 when the data ends first (cv2's stream
// throws).  `out` holds `height` rows of `width` in decoding order (the
// first row decoded first).
int bmp_rle_cv2(const uint8_t* file, int64_t size, int64_t pos, int rle4, const uint8_t* gray,
                int64_t width, int64_t height, uint8_t* out) {
  int64_t x = 0, y = 0;
  int line_end_flag = 0;
  auto byte = [&](int& v) -> bool {
    if (pos >= size) return false;
    v = file[pos++];
    return true;
  };
  // FillUniGray: `count` pixels of `clr` from (x, y), wrapping rows
  auto fill = [&](int64_t count, uint8_t clr) {
    do {
      int64_t end = x + count < width ? x + count : width;
      count -= end - x;
      for (; x < end; ++x) out[y * width + x] = clr;
      if (x >= width) {
        x = 0;
        if (++y >= height) break;
      }
    } while (count > 0);
  };
  for (;;) {
    int len, code;
    if (!byte(len) || !byte(code)) return 2;
    if (len != 0) {                              // encoded run
      if (x + len > width) return 1;
      if (rle4) {
        uint8_t c[2] = {gray[code >> 4], gray[code & 15]};
        int t = 0;
        int64_t end = x + len;
        do {
          out[y * width + x] = c[t];
          t ^= 1;
        } while (++x < end);
      } else {
        int64_t prev_y = y;
        fill(len, gray[code]);
        line_end_flag = (int)(y - prev_y);
        if (y >= height) break;
      }
    } else if (code > 2) {                       // absolute run
      if (x + code > width) return 1;
      int64_t sz = rle4 ? ((((code + 1) >> 1) + 1) & ~1) : ((code + 1) & ~1);
      if (pos + sz > size) return 2;
      const uint8_t* src = file + pos;
      pos += sz;
      for (int i = 0; i < code; ++i) {
        int v = rle4 ? ((src[i >> 1] >> ((i & 1) ? 0 : 4)) & 15) : src[i];
        out[y * width + x + i] = gray[v];
      }
      x += code;
      if (!rle4) line_end_flag = 0;
    } else {                                     // end of line, of bitmap, delta
      int64_t x_shift = width - x, y_shift = height - y;
      if (rle4 || code || !line_end_flag || x_shift < width) {
        if (code == 2) {
          int dx, dy;
          if (!byte(dx) || !byte(dy)) return 2;
          x_shift = dx;
          y_shift = dy;
        }
        if (code != 0) x_shift += y_shift * width;
        if (y >= height) break;
        fill(x_shift, gray[0]);
        if (y >= height) break;
      }
      line_end_flag = 0;
      if (y >= height) break;
    }
  }
  return 0;
}

// Returns the number of pixels Pillow's decoder produced (at most
// `capacity` are stored), or -1 where it raises (a delta cut short).
int64_t bmp_rle_pil(const uint8_t* file, int64_t size, int64_t pos, int rle4, int64_t width,
                    int64_t height, uint8_t* out, int64_t capacity) {
  const int64_t dest = width * height;
  int64_t n = 0, x = 0;
  auto put = [&](uint8_t v) {
    if (n < capacity) out[n] = v;
    ++n;
  };
  while (n < dest) {
    if (pos + 2 > size) break;
    int pixels = file[pos], b = file[pos + 1];
    pos += 2;
    if (pixels) {
      int64_t count = pixels;
      if (x + count > width) count = width - x > 0 ? width - x : 0;
      for (int64_t i = 0; i < count; ++i) put(rle4 ? ((i % 2 == 0) ? (b >> 4) : (b & 15)) : b);
      x += count;
    } else if (b == 0) {
      while (n % width) put(0);
      x = 0;
    } else if (b == 1) {
      break;
    } else if (b == 2) {
      if (pos + 2 > size) break;
      pos += 2;                                  // read, then read again
      if (pos + 2 > size) return -1;             // unpacking too few bytes raises
      int right = file[pos], up = file[pos + 1];
      pos += 2;
      for (int64_t i = 0; i < right + up * width; ++i) put(0);
      x = n % width;
    } else {
      int64_t count = rle4 ? b / 2 : b;
      int64_t got = size - pos < count ? size - pos : count;
      for (int64_t i = 0; i < got; ++i) {
        int v = file[pos + i];
        if (rle4) {
          put((uint8_t)(v >> 4));
          put((uint8_t)(v & 15));
        } else {
          put((uint8_t)v);
        }
      }
      pos += got;
      if (got < count) break;
      x += b;
      if (pos % 2) ++pos;
    }
  }
  return n;
}

// RT_BYTE_ENCODED: 0x80 n v is n + 1 copies of v (0x80 0 a literal 0x80),
// any other byte itself.  Returns the bytes written (at most `capacity`).
int64_t sunras_rle(const uint8_t* src, int64_t n, uint8_t* out, int64_t capacity) {
  int64_t i = 0, k = 0;
  while (i < n && k < capacity) {
    uint8_t c = src[i++];
    if (c != 0x80) {
      out[k++] = c;
      continue;
    }
    if (i >= n) break;
    int count = src[i++];
    if (count == 0) {
      out[k++] = 0x80;
      continue;
    }
    if (i >= n) break;
    uint8_t v = src[i++];
    for (int j = 0; j <= count && k < capacity; ++j) out[k++] = v;
  }
  return k;
}

}  // extern "C"
