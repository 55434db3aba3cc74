// Baseline JPEG scan decoding for xfmamba_tpu_torch/data/jpeg.py, which
// parses the markers and calls `jpeg_scan` once per scan (ctypes, so the
// GIL is released while it runs).
//
// The entropy decode follows the JPEG spec (ITU T.81, F.2.2) as libjpeg's
// jdhuff.c does it, and the reconstruction is libjpeg's "islow" integer
// IDCT (jidctint.c: 13-bit constants, two passes of 2 extra bits,
// DESCALE rounding, and the post-IDCT range-limit table of jdmaster.c), so
// the luma plane equals what libjpeg gives cv2.imread(IMREAD_GRAYSCALE)
// bit for bit.  Only the scan's target component is reconstructed; the
// others are decoded to keep the bit stream in step and dropped.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kLook = 9;  // bits resolved by one table lookup

// zigzag position -> natural (row-major) position, with 16 extra entries of
// 63 so that a corrupt run past the block lands on the last coefficient, as
// in libjpeg (jpeg_natural_order)
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Status : int64_t {
  kBadTable = -1,      // a Huffman table that is not a prefix code
  kBadCode = -2,       // a bit pattern that no code of the table starts
  kPastData = -3,      // the scan needs bits past its end: truncated or corrupt
  kBadRestart = -4,    // a restart marker missing or out of order
  kNoMarker = -5,      // the file ends inside the scan's data
};

struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  int32_t nsym;
  uint8_t vals[256];
  uint16_t look[1 << kLook];  // (length << 8) | symbol, 0 for longer codes
};

bool build_huff(const uint8_t* counts, const uint8_t* vals, bool is_dc, Huff* h) {
  int size[257], code[257], n = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) {
      if (n >= 256) return false;
      size[n++] = l;
    }
  size[n] = 0;
  h->nsym = n;
  for (int i = 0; is_dc && i < n; ++i)
    if (vals[i] > 15) return false;
  int c = 0, si = n ? size[0] : 0, p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1 << si)) return false;  // no code may be all ones
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      h->valoffset[l] = p - code[p];
      p += counts[l - 1];
      h->maxcode[l] = code[p - 1];
    } else {
      h->maxcode[l] = -1;
      h->valoffset[l] = 0;
    }
  }
  h->maxcode[17] = 0x7fffffff;
  std::memcpy(h->vals, vals, n);
  std::memset(h->look, 0, sizeof h->look);
  p = 0;
  for (int l = 1; l <= kLook; ++l)
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      const int first = code[p] << (kLook - l);
      for (int k = 0; k < (1 << (kLook - l)); ++k)
        h->look[first + k] = (uint16_t)((l << 8) | vals[p]);
    }
  return true;
}

// Bits of the entropy-coded segment, 0xFF00 unstuffed.  At a marker (or the
// end of the data) it feeds zero bits and counts them: consuming one of
// them means the scan ran past its data.
struct Bits {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf;
  int cnt, fake;
  bool at_marker;

  void fill() {
    while (cnt <= 56) {
      uint32_t c = 0;
      if (!at_marker && pos < n) {
        c = d[pos];
        if (c == 0xFF) {
          if (pos + 1 < n && d[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;  // pos stays on the marker (or its fill bytes)
            c = 0;
            fake += 8;
          }
        } else {
          ++pos;
        }
      } else {
        fake += 8;
      }
      buf = (buf << 8) | c;
      cnt += 8;
    }
  }
  int peek(int k) const { return (int)((buf >> (cnt - k)) & ((1u << k) - 1)); }
  bool skip(int k) {
    cnt -= k;
    return cnt >= fake;
  }
  int get(int k, bool* ok) {
    fill();
    const int v = peek(k);
    *ok &= skip(k);
    return v;
  }
  void reset() {
    buf = 0;
    cnt = fake = 0;
  }
};

// one Huffman symbol, or a negative status
inline int decode(Bits& b, const Huff& h) {
  b.fill();
  const int v = h.look[b.peek(kLook)];
  if (v >> 8) return b.skip(v >> 8) ? (v & 0xFF) : (int)kPastData;
  int l = kLook + 1;
  int code = b.peek(l);
  while (code > h.maxcode[l]) {
    if (++l > 16) return (int)kBadCode;
    code = b.peek(l);
  }
  const int idx = code + h.valoffset[l];
  if (idx < 0 || idx >= h.nsym) return (int)kBadCode;
  return b.skip(l) ? h.vals[idx] : (int)kPastData;
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// one block's coefficients (natural order) into `coef`, or skipped when it
// is null; returns 0 or a negative status
int decode_block(Bits& b, const Huff& dc, const Huff& ac, int* pred, int16_t* coef) {
  bool ok = true;
  int s = decode(b, dc);
  if (s < 0) return s;
  if (s) *pred += extend(b.get(s, &ok), s);
  if (coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    coef[0] = (int16_t)*pred;
  }
  for (int k = 1; k < 64;) {
    const int rs = decode(b, ac);
    if (rs < 0) return rs;
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      const int v = extend(b.get(s, &ok), s);
      if (coef) coef[kNatural[k]] = (int16_t)v;
      ++k;
    } else {
      if (r != 15) break;
      k += 16;
    }
  }
  return ok ? 0 : (int)kPastData;
}

// jidctint.c's constants: round(x * 2^13)
constexpr int32_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;
constexpr int kConstBits = 13, kPass1Bits = 2;

inline int32_t descale(int64_t x, int n) { return (int32_t)((x + (int64_t(1) << (n - 1))) >> n); }

// the even (t10-t13) and odd (t0-t3) parts of one 1-D pass of jidctint.c
struct Halves {
  int64_t t10, t11, t12, t13, t0, t1, t2, t3;
};

inline Halves butterfly(int64_t i0, int64_t i1, int64_t i2, int64_t i3, int64_t i4,
                        int64_t i5, int64_t i6, int64_t i7) {
  Halves o;
  int64_t z1 = (i2 + i6) * F0_541196100;
  const int64_t e2 = z1 + i6 * -F1_847759065;
  const int64_t e3 = z1 + i2 * F0_765366865;
  const int64_t e0 = (i0 + i4) * (1 << kConstBits);
  const int64_t e1 = (i0 - i4) * (1 << kConstBits);
  o.t10 = e0 + e3;
  o.t13 = e0 - e3;
  o.t11 = e1 + e2;
  o.t12 = e1 - e2;
  int64_t t0 = i7, t1 = i5, t2 = i3, t3 = i1;
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * F1_175875602;
  t0 *= F0_298631336;
  t1 *= F2_053119869;
  t2 *= F3_072711026;
  t3 *= F1_501321110;
  z1 *= -F0_899976223;
  z2 *= -F2_562915447;
  z3 *= -F1_961570560;
  z4 *= -F0_390180644;
  z3 += z5;
  z4 += z5;
  o.t0 = t0 + z1 + z3;
  o.t1 = t1 + z2 + z4;
  o.t2 = t2 + z2 + z3;
  o.t3 = t3 + z1 + z4;
  return o;
}

// libjpeg's range limit after the IDCT: the 10 low bits of the descaled
// value as a signed number, plus 128, clamped to 0..255
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; ++v) {
      const int x = (v < 512 ? v : v - 1024) + 128;
      t[v] = (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
    }
  }
};
const RangeLimit kLimit;

void idct_islow(const int16_t* coef, const int32_t* q, uint8_t* out, int64_t stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int32_t* qc = q + c;
    if (!(in[8] | in[16] | in[24] | in[32] | in[40] | in[48] | in[56])) {
      const int32_t dc = (in[0] * qc[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    const Halves h = butterfly(in[0] * qc[0], in[8] * qc[8], in[16] * qc[16], in[24] * qc[24],
                               in[32] * qc[32], in[40] * qc[40], in[48] * qc[48],
                               in[56] * qc[56]);
    constexpr int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = descale(h.t10 + h.t3, n);
    ws[7 * 8 + c] = descale(h.t10 - h.t3, n);
    ws[1 * 8 + c] = descale(h.t11 + h.t2, n);
    ws[6 * 8 + c] = descale(h.t11 - h.t2, n);
    ws[2 * 8 + c] = descale(h.t12 + h.t1, n);
    ws[5 * 8 + c] = descale(h.t12 - h.t1, n);
    ws[3 * 8 + c] = descale(h.t13 + h.t0, n);
    ws[4 * 8 + c] = descale(h.t13 - h.t0, n);
  }
  constexpr int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      std::memset(o, kLimit.t[descale(w[0], kPass1Bits + 3) & 1023], 8);
      continue;
    }
    const Halves h = butterfly(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7]);
    o[0] = kLimit.t[descale(h.t10 + h.t3, n) & 1023];
    o[7] = kLimit.t[descale(h.t10 - h.t3, n) & 1023];
    o[1] = kLimit.t[descale(h.t11 + h.t2, n) & 1023];
    o[6] = kLimit.t[descale(h.t11 - h.t2, n) & 1023];
    o[2] = kLimit.t[descale(h.t12 + h.t1, n) & 1023];
    o[5] = kLimit.t[descale(h.t12 - h.t1, n) & 1023];
    o[3] = kLimit.t[descale(h.t13 + h.t0, n) & 1023];
    o[4] = kLimit.t[descale(h.t13 - h.t0, n) & 1023];
  }
}

// moves `pos` past a restart marker RSTn (fill bytes allowed before it)
bool take_restart(Bits& b, int n) {
  int64_t p = b.pos;
  while (p + 1 < b.n && b.d[p] == 0xFF && b.d[p + 1] == 0xFF) ++p;
  if (p + 1 >= b.n || b.d[p] != 0xFF || b.d[p + 1] != 0xD0 + n) return false;
  b.pos = p + 2;
  b.at_marker = false;
  b.reset();
  return true;
}

}  // namespace

extern "C" {

// Decode one sequential Huffman scan whose entropy-coded data starts at
// data[pos].  `comps`: per scan component (h, v, DC table, AC table); one
// component means a non-interleaved scan of mcus_x * mcus_y blocks,
// several an interleaved one of mcus_x * mcus_y MCUs of h * v blocks each.
// `tables`: 8 tables of 16 code counts then 256 symbols (DC 0-3, AC 0-3).
// Component `target` of the scan (or none, -1) is dequantised with
// `quant` (natural order) and its 8 x 8 blocks written into `plane`, block
// (row, col) at plane[8 row * stride + 8 col].  Returns the offset of the
// marker that ends the scan, or a negative Status.
int64_t jpeg_scan(const uint8_t* data, int64_t n, int64_t pos, int ncomp, const int32_t* comps,
                  const uint8_t* tables, int64_t mcus_x, int64_t mcus_y,
                  int64_t restart_interval, int target, const int32_t* quant, uint8_t* plane,
                  int64_t stride) {
  static thread_local Huff dc[4], ac[4];
  bool built[8] = {false};
  for (int c = 0; c < ncomp; ++c)
    for (int k = 0; k < 2; ++k) {
      const int t = comps[4 * c + 2 + k] + 4 * k;
      if (built[t]) continue;
      if (!build_huff(tables + t * 272, tables + t * 272 + 16, !k, k ? &ac[t - 4] : &dc[t]))
        return kBadTable;
      built[t] = true;
    }
  Bits b{data, n, pos, 0, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  int16_t coef[64];
  const int64_t total = mcus_x * mcus_y;
  int next_rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      if (!take_restart(b, next_rst)) return kBadRestart;
      next_rst = (next_rst + 1) & 7;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    const int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* cp = comps + 4 * c;
      const int h = ncomp == 1 ? 1 : cp[0], v = ncomp == 1 ? 1 : cp[1];
      for (int by = 0; by < v; ++by)
        for (int bx = 0; bx < h; ++bx) {
          int16_t* dst = c == target ? coef : nullptr;
          const int st = decode_block(b, dc[cp[2]], ac[cp[3]], &pred[c], dst);
          if (st) return st;
          if (dst)
            idct_islow(coef, quant,
                       plane + (my * v + by) * 8 * stride + (mx * h + bx) * 8, stride);
        }
    }
  }
  // the marker after the scan: past the padding bits of the last byte
  int64_t p = b.pos;
  while (p + 1 < n) {
    if (data[p] == 0xFF && data[p + 1] != 0x00) return p;
    p += data[p] == 0xFF ? 2 : 1;
  }
  return kNoMarker;
}

}  // extern "C"
