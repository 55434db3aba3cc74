// TIFF strip and tile decoding for xfmamba_tpu_torch/data/tiff.py, byte
// for byte what libtiff 4.7 (the build cv2 and PIL carry) leaves in the
// buffer of a TIFFReadEncodedStrip / TIFFReadEncodedTile call, including on
// cut and corrupt data.  Bound with ctypes by native/__init__.py, so the
// GIL is released while it runs.
//
// `tiff_decode_chunks` decodes any number of strips or tiles in one call:
// for each, the fill step (tif_read.c's TIFFFillStrip: a byte count of 0 or
// one running past the end of the file fails; counts over 1 MiB are cut to
// ten times the decoded size plus 4096; FillOrder 2 reverses the bits),
// then the codec (tif_dumpmode.c, tif_lzw.c with the old-style codes of
// LZW_COMPAT, tif_packbits.c, tif_zip.c through the system zlib, loaded
// with dlopen, tif_fax3.c for CCITT RLE, Group 3 1D/2D and Group 4), then,
// only where the codec succeeded, the predictor (tif_predict.c: horizontal
// differencing at 8, 16, 32 and 64 bits, the floating-point predictor) and
// the byte swap of a file in the other byte order.  A failed codec leaves
// what it decoded, zeros after it (the buffer libtiff allocates is zeroed),
// and no predictor or swap.  Each chunk's status: 0 decoded, 1 the codec
// failed, 2 the fill failed (nothing decoded).

#include <dlfcn.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---- LZW (tif_lzw.c) ----------------------------------------------------

constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kClear = 256, kEOI = 257, kFirst = 258;
constexpr int kCSize = (1 << kBitsMax) - 1 + 1024;   // MAXCODE(BITS_MAX) + 1024 (LZW_COMPAT)

struct Code {
  int next;          // index of the prefix entry, -1 for none
  uint16_t length;   // string length including this one
  uint8_t value;     // last character
  uint8_t firstchar;
};

struct LzwTable {
  std::vector<Code> tab;
  LzwTable() : tab(kCSize + 1) {
    // slot 0 is the "entry before the table" that the decoder's first
    // previous-code points at; the codes start at slot 1
    for (int c = 0; c < 256; ++c) tab[c + 1] = Code{-1, 1, (uint8_t)c, (uint8_t)c};
    tab[0] = Code{-1, 0, 0, 0};
    for (int c = kClear; c < kCSize; ++c) tab[c + 1] = Code{-1, 0, 0, 0};
  }
  Code& at(int code) { return tab[code + 1]; }
};

// The new-style decoder (MSB-first codes, the code width grows one code
// early; the first code must be Clear).  Returns 1 on success, 0 on
// failure; `op` gets `occ` bytes.
int lzw_decode(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ) {
  LzwTable t;
  uint64_t bitsleft = (uint64_t)cc * 8;
  uint64_t nextdata = 0;
  int nextbits = 0;
  int nbits = kBitsMin;
  int nbitsmask = (1 << kBitsMin) - 1;
  int free_ent = kFirst;
  int maxcode = nbitsmask - 1;
  int oldcode = -1;                     // the slot before the table
  int64_t pos = 0;
  auto get = [&](int& code) -> bool {
    while (nextbits < nbits) {
      if (bitsleft < 8) return false;
      nextdata = (nextdata << 8) | bp[pos++];
      nextbits += 8;
      bitsleft -= 8;
    }
    nextbits -= nbits;
    code = (int)((nextdata >> nextbits) & (uint64_t)nbitsmask);
    return true;
  };
  auto grow = [&]() {
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
      if (free_ent >= kCSize) free_ent = kCSize - 1;
    }
  };
  auto error = [&]() {
    std::memset(op, 0, (size_t)occ);
    return 0;
  };
  bool first = true;
  while (occ > 0) {
    int code;
    if (!get(code)) return error();     // not terminated with EOI
    if (first && code != kClear) return error();   // a strip must start with Clear
    first = false;
    if (code == kEOI) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = kBitsMin;
      nbitsmask = (1 << kBitsMin) - 1;
      maxcode = nbitsmask - 1;
      do {
        if (!get(code)) return error();
      } while (code == kClear);
      if (code == kEOI) break;
      if (code > kEOI) return error();  // using a code not yet in the table
      *op++ = (uint8_t)code;
      --occ;
      oldcode = code;
      continue;
    }
    Code& old = t.at(oldcode);
    if (code < 256) {
      Code& e = t.at(free_ent);
      e.next = oldcode;
      e.firstchar = old.firstchar;
      e.length = (uint16_t)(old.length + 1);
      e.value = (uint8_t)code;
      grow();
      oldcode = code;
      *op++ = (uint8_t)code;
      --occ;
      continue;
    }
    if (code > free_ent) return error();
    {
      Code& e = t.at(free_ent);
      e.value = code == free_ent ? old.firstchar : t.at(code).firstchar;
      e.next = oldcode;
      e.firstchar = old.firstchar;
      e.length = (uint16_t)(old.length + 1);
    }
    grow();
    oldcode = code;
    int len = t.at(code).length;
    if (len > occ) {
      // the string does not fit: its first `occ` characters
      int c = code;
      while (t.at(c).length > occ) c = t.at(c).next;
      for (int64_t i = occ - 1; i >= 0; --i) {
        op[i] = t.at(c).value;
        c = t.at(c).next;
      }
      op += occ;
      occ = 0;
      break;
    }
    int c = code;
    for (int i = len - 1; i >= 0; --i) {
      op[i] = t.at(c).value;
      c = t.at(c).next;
    }
    op += len;
    occ -= len;
  }
  return occ > 0 ? 0 : 1;               // "Not enough data at scanline"
}

// The old-style decoder (LSB-first codes, no early change).
int lzw_decode_compat(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ) {
  LzwTable t;
  uint64_t bitsleft = (uint64_t)cc * 8;
  uint64_t nextdata = 0;
  int nextbits = 0;
  int nbits = kBitsMin;
  int nbitsmask = (1 << kBitsMin) - 1;
  int free_ent = kFirst;
  int maxcode = nbitsmask;
  int oldcode = -1;
  int64_t pos = 0;
  auto get = [&](int& code) {
    if (bitsleft < (uint64_t)nbits) {
      code = kEOI;                      // not terminated with EOI: a warning
      return;
    }
    nextdata |= (uint64_t)bp[pos++] << nextbits;
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata |= (uint64_t)bp[pos++] << nextbits;
      nextbits += 8;
    }
    code = (int)(nextdata & (uint64_t)nbitsmask);
    nextdata >>= nbits;
    nextbits -= nbits;
    bitsleft -= nbits;
  };
  while (occ > 0) {
    int code;
    get(code);
    if (code == kEOI) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int c = kFirst; c < kCSize; ++c) t.at(c) = Code{-1, 0, 0, 0};
        nbits = kBitsMin;
        nbitsmask = (1 << kBitsMin) - 1;
        maxcode = nbitsmask;
        get(code);
      } while (code == kClear);
      if (code == kEOI) break;
      if (code > kClear) return 0;      // corrupted LZW table
      *op++ = (uint8_t)code;
      --occ;
      oldcode = code;
      continue;
    }
    if (free_ent >= kCSize) return 0;
    {
      Code& e = t.at(free_ent);
      Code& prev = t.at(oldcode);
      e.next = oldcode;
      e.firstchar = prev.firstchar;
      e.length = (uint16_t)(prev.length + 1);
      e.value = code < free_ent ? t.at(code).firstchar : e.firstchar;
    }
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask;
    }
    oldcode = code;
    if (code >= 256) {
      int len = t.at(code).length;
      if (len == 0) return 0;           // wrong length of decoded string
      if (len > occ) {
        int c = code;
        while (t.at(c).length > occ) c = t.at(c).next;
        for (int64_t i = occ - 1; i >= 0; --i) {
          op[i] = t.at(c).value;
          c = t.at(c).next;
        }
        op += occ;
        occ = 0;
        break;
      }
      int c = code;
      int i = len;
      while (c >= -1 && i > 0) {
        op[--i] = t.at(c).value;
        c = t.at(c).next;
        if (c < 0) break;
      }
      op += len;
      occ -= len;
    } else {
      *op++ = (uint8_t)code;
      --occ;
    }
  }
  return occ > 0 ? 0 : 1;
}

// ---- PackBits (tif_packbits.c) -------------------------------------------

int packbits_decode(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ) {
  while (cc > 0 && occ > 0) {
    int n = (int8_t)*bp++;
    --cc;
    if (n < 0) {
      if (n == -128) continue;
      int64_t run = -n + 1;
      if (occ < run) run = occ;
      if (cc == 0) break;
      occ -= run;
      uint8_t b = *bp++;
      --cc;
      std::memset(op, b, (size_t)run);
      op += run;
    } else {
      int64_t lit = n + 1;
      if (occ < lit) lit = occ;
      if (cc < lit) break;
      std::memcpy(op, bp, (size_t)lit);
      op += lit;
      occ -= lit;
      bp += lit;
      cc -= lit;
    }
  }
  if (occ > 0) {
    std::memset(op, 0, (size_t)occ);
    return 0;
  }
  return 1;
}

// ---- Deflate (tif_zip.c over zlib) ---------------------------------------

struct ZStream {          // zlib's z_stream on LP64
  const uint8_t* next_in;
  unsigned avail_in;
  unsigned long total_in;
  uint8_t* next_out;
  unsigned avail_out;
  unsigned long total_out;
  const char* msg;
  void* state;
  void* zalloc;
  void* zfree;
  void* opaque;
  int data_type;
  unsigned long adler;
  unsigned long reserved;
};
using InflateInit = int (*)(ZStream*, const char*, int);
using Inflate = int (*)(ZStream*, int);
using InflateEnd = int (*)(ZStream*);

struct Zlib {
  InflateInit init = nullptr;
  Inflate inflate = nullptr;
  InflateEnd end = nullptr;
  Zlib() {
    void* h = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL);
    if (!h) return;
    init = (InflateInit)dlsym(h, "inflateInit_");
    inflate = (Inflate)dlsym(h, "inflate");
    end = (InflateEnd)dlsym(h, "inflateEnd");
  }
  bool ok() const { return init && inflate && end; }
};

const Zlib& zlib() {
  static const Zlib z;
  return z;
}

int zip_decode(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ) {
  const Zlib& z = zlib();
  ZStream s;
  std::memset(&s, 0, sizeof s);
  if (z.init(&s, "1.2.13", (int)sizeof s) != 0) return 0;
  s.next_in = bp;
  s.next_out = op;
  int ret = 1;
  do {
    unsigned in_before = cc <= 0xFFFFFFFF ? (unsigned)cc : 0xFFFFFFFFu;
    unsigned out_before = occ < 0xFFFFFFFF ? (unsigned)occ : 0xFFFFFFFFu;
    s.avail_in = in_before;
    s.avail_out = out_before;
    int state = z.inflate(&s, 1 /* Z_PARTIAL_FLUSH */);
    cc -= in_before - s.avail_in;
    occ -= out_before - s.avail_out;
    if (state == 1 /* Z_STREAM_END */) break;
    if (state != 0) {                   // Z_DATA_ERROR or any other error
      ret = 0;
      break;
    }
  } while (occ > 0);
  if (ret && occ != 0) {
    std::memset(s.next_out, 0, (size_t)occ);
    ret = 0;
  }
  z.end(&s);
  return ret;
}

// ---- CCITT (tif_fax3.c, tif_fax3.h) ------------------------------------

int fax_decode(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ, int64_t width,
               int mode, int options, int fill_order);

// ---- predictors (tif_predict.c) --------------------------------------------

template <typename T>
void hor_acc(uint8_t* row, int64_t bytes, int stride) {
  T* w = reinterpret_cast<T*>(row);
  int64_t n = bytes / (int64_t)sizeof(T);
  for (int64_t i = stride; i < n; ++i) w[i] = (T)(w[i] + w[i - stride]);
}

template <typename T>
void swab(uint8_t* p, int64_t bytes) {
  const int k = (int)sizeof(T);
  for (int64_t i = 0; i + k <= bytes; i += k) std::reverse(p + i, p + i + k);
}

void fp_acc(uint8_t* row, int64_t bytes, int stride, int bps) {
  for (int64_t i = stride; i < bytes; ++i) row[i] = (uint8_t)(row[i] + row[i - stride]);
  std::vector<uint8_t> tmp(row, row + bytes);
  int64_t wc = bytes / bps;
  for (int64_t c = 0; c < wc; ++c)
    for (int b = 0; b < bps; ++b) row[bps * c + b] = tmp[(int64_t)(bps - b - 1) * wc + c];
}

enum Codec { kNone = 1, kCcittRle = 2, kFax3 = 3, kFax4 = 4, kLzw = 5, kZip = 8,
             kCcittRleW = 32771, kPackBits = 32773, kZipOld = 32946 };

// One codec call on one chunk's raw bytes (already bit-reversed where the
// fill order asks): returns 1 when it decoded all `occ` bytes.
int tiff_codec(int codec, const uint8_t* src, int64_t cc, uint8_t* dst, int64_t occ,
               int64_t width, int fax_options, int fill_order) {
  switch (codec) {
    case kNone:
      if (cc < occ) return 0;
      std::memcpy(dst, src, (size_t)occ);
      return 1;
    case kLzw:
      if (cc >= 2 && src[0] == 0 && (src[1] & 1)) return lzw_decode_compat(src, cc, dst, occ);
      return lzw_decode(src, cc, dst, occ);
    case kPackBits:
      return packbits_decode(src, cc, dst, occ);
    case kZip:
    case kZipOld:
      return zip_decode(src, cc, dst, occ);
    case kCcittRle:
    case kCcittRleW:
    case kFax3:
    case kFax4:
      return fax_decode(src, cc, dst, occ, width, codec, fax_options, fill_order);
    default:
      return 0;
  }
}

}  // namespace

extern "C" {

// Decode `n` chunks of the file `file` (`size` bytes).  Chunk i: raw bytes
// at offsets[i], counts[i] of them; wants[i] decoded bytes into
// out + out_offsets[i], in rows of `row_bytes`.  predictor 2 works on
// samples of `sample_bytes` a `stride` apart, 3 on floats of `sample_bytes`;
// `swap` swaps each sample's bytes after a successful decode (a file in the
// other byte order).  status[i]: 0 decoded, 1 the codec failed, 2 the fill
// failed.  Returns 0, or -1 if the codec needs zlib and it cannot be loaded.
int64_t tiff_decode_chunks(const uint8_t* file, int64_t size, int64_t n, const int64_t* offsets,
                           const int64_t* counts, const int64_t* wants, uint8_t* out,
                           const int64_t* out_offsets, int codec, int predictor,
                           int sample_bytes, int stride, int64_t row_bytes, int swap,
                           int reverse_bits, int64_t width, int fax_options, int8_t* status) {
  static uint8_t reverse[256];
  static bool reverse_ready = false;
  if (!reverse_ready) {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b) r |= ((i >> b) & 1) << (7 - b);
      reverse[i] = (uint8_t)r;
    }
    reverse_ready = true;
  }
  if ((codec == kZip || codec == kZipOld) && !zlib().ok()) return -1;
  std::vector<uint8_t> flipped;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* dst = out + out_offsets[i];
    int64_t occ = wants[i];
    uint64_t count = (uint64_t)counts[i];
    uint64_t offset = (uint64_t)offsets[i];
    if (count > 1024 * 1024 && occ != 0 && (count - 4096) / 10 > (uint64_t)occ)
      count = (uint64_t)occ * 10 + 4096;
    if (count == 0 || count > (uint64_t)size || offset > (uint64_t)size - count) {
      status[i] = 2;
      continue;
    }
    const uint8_t* src = file + offset;
    // fax decoders reverse bits themselves (TIFF_NOBITREV)
    bool fax = codec == kCcittRle || codec == kCcittRleW || codec == kFax3 || codec == kFax4;
    if (reverse_bits && !fax) {
      flipped.assign(src, src + count);
      for (auto& b : flipped) b = reverse[b];
      src = flipped.data();
    }
    int ok = tiff_codec(codec, src, (int64_t)count, dst, occ, width, fax_options,
                        reverse_bits ? 2 : 1);
    status[i] = ok ? 0 : 1;
    if (!ok) continue;
    if (predictor == 2 && row_bytes > 0) {
      for (int64_t r = 0; r + row_bytes <= occ; r += row_bytes) {
        uint8_t* row = dst + r;
        switch (sample_bytes) {
          case 1: hor_acc<uint8_t>(row, row_bytes, stride); break;
          case 2:
            if (swap) swab<uint16_t>(row, row_bytes);
            hor_acc<uint16_t>(row, row_bytes, stride);
            break;
          case 4:
            if (swap) swab<uint32_t>(row, row_bytes);
            hor_acc<uint32_t>(row, row_bytes, stride);
            break;
          case 8:
            if (swap) swab<uint64_t>(row, row_bytes);
            hor_acc<uint64_t>(row, row_bytes, stride);
            break;
        }
      }
    } else if (predictor == 3 && row_bytes > 0) {
      for (int64_t r = 0; r + row_bytes <= occ; r += row_bytes)
        fp_acc(dst + r, row_bytes, stride, sample_bytes);
    } else if (swap) {
      switch (sample_bytes) {
        case 2: swab<uint16_t>(dst, occ); break;
        case 4: swab<uint32_t>(dst, occ); break;
        case 8: swab<uint64_t>(dst, occ); break;
      }
    }
  }
  return 0;
}

}  // extern "C"

namespace {

// ---- CCITT (tif_fax3.c, tif_fax3.h, mkg3states.c) ---------------------------

enum FaxState { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
                S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

// (code as written in T.4, most significant bit first; length; run)
struct Code2 {
  const char* bits;
  int run;
};

const Code2 kTermW[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5},
    {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11},
    {"001000", 12}, {"000011", 13}, {"110100", 14}, {"110101", 15}, {"101010", 16},
    {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36},
    {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46},
    {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63}, {nullptr, 0}};
const Code2 kMakeUpW[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320},
    {"00110111", 384}, {"01100100", 448}, {"01100101", 512}, {"01101000", 576},
    {"01100111", 640}, {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088},
    {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728}, {nullptr, 0}};
const Code2 kTermB[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5}, {"0010", 6},
    {"00011", 7}, {"000101", 8}, {"000100", 9}, {"0000100", 10}, {"0000101", 11},
    {"0000111", 12}, {"00000100", 13}, {"00000111", 14}, {"000011000", 15},
    {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63},
    {nullptr, 0}};
const Code2 kMakeUpB[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448},
    {"0000001101100", 512}, {"0000001101101", 576}, {"0000001001010", 640},
    {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}, {nullptr, 0}};
const Code2 kMakeUp[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}, {nullptr, 0}};
const Code2 kPass[] = {{"0001", 0}, {nullptr, 0}};
const Code2 kHoriz[] = {{"001", 0}, {nullptr, 0}};
const Code2 kV0[] = {{"1", 0}, {nullptr, 0}};
const Code2 kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}, {nullptr, 0}};
const Code2 kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}, {nullptr, 0}};
const Code2 kExt[] = {{"0000001", 0}, {nullptr, 0}};
const Code2 kEOLV[] = {{"0000000", 0}, {nullptr, 0}};
const Code2 kEOLH[] = {{"00000000000", 0}, {nullptr, 0}};

// mkg3states' FillTable: the codes are looked up least significant bit
// first, so each code fills every index whose low `width` bits are the
// code's bits reversed.
void fill_table(TabEnt* t, int size, const Code2* p, int state) {
  for (; p->bits; ++p) {
    int width = (int)std::strlen(p->bits), code = 0;
    for (int i = 0; i < width; ++i) code |= (p->bits[i] - '0') << i;
    for (int c = code; c < (1 << size); c += 1 << width) t[c] = TabEnt{(uint8_t)state,
                                                                       (uint8_t)width,
                                                                       (uint32_t)p->run};
  }
}

struct FaxTables {
  TabEnt main[128], white[4096], black[8192];
  FaxTables() {
    fill_table(main, 7, kPass, S_Pass);
    fill_table(main, 7, kHoriz, S_Horiz);
    fill_table(main, 7, kV0, S_V0);
    fill_table(main, 7, kVR, S_VR);
    fill_table(main, 7, kVL, S_VL);
    fill_table(main, 7, kExt, S_Ext);
    fill_table(main, 7, kEOLV, S_EOL);
    fill_table(white, 12, kMakeUpW, S_MakeUpW);
    fill_table(white, 12, kMakeUp, S_MakeUp);
    fill_table(white, 12, kTermW, S_TermW);
    fill_table(white, 12, kEOLH, S_EOL);
    fill_table(black, 13, kMakeUpB, S_MakeUpB);
    fill_table(black, 13, kMakeUp, S_MakeUp);
    fill_table(black, 13, kTermB, S_TermB);
    fill_table(black, 13, kEOLH, S_EOL);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables t;
  return t;
}

// _TIFFFax3fillruns: alternate white (0) and black (1) runs into a row.
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; ++k) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      for (uint32_t i = x; i < x + run; ++i) {
        if (k)
          buf[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
        else
          buf[i >> 3] &= (uint8_t)~(0x80 >> (i & 7));
      }
      x += run;
    }
  }
}

struct Fax {
  const uint8_t* cp;
  const uint8_t* ep;
  bool reverse;            // FillOrder 1: the reversal table (bits taken LSB first)
  uint32_t acc = 0;
  int avail = 0;
  uint8_t rev[256];

  Fax(const uint8_t* b, int64_t n, int fill_order) : cp(b), ep(b + n), reverse(fill_order != 2) {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int k = 0; k < 8; ++k) r |= ((i >> k) & 1) << (7 - k);
      rev[i] = (uint8_t)(reverse ? r : i);
    }
  }
  // NeedBits16 / NeedBits8: false at the end of the data with no bits left
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)rev[*cp++] << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= (uint32_t)rev[*cp++] << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= (uint32_t)rev[*cp++] << avail;
        avail += 8;
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
};

// One strip or tile of CCITT data: returns 1 on success, 0 on failure.
int fax_decode(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ, int64_t width,
               int codec, int options, int fill_order) {
  const FaxTables& T = fax_tables();
  const uint32_t lastx = (uint32_t)width;
  const int64_t rowbytes = (width + 7) / 8;
  if (rowbytes == 0 || occ % rowbytes) return 0;
  const bool two_d_g3 = codec == kFax3 && (options & 1);
  const bool ref = codec == kFax4 || two_d_g3;
  uint32_t nruns = ((lastx + 1 + 31) / 32) * 32;
  if (ref) nruns *= 2;
  std::vector<uint32_t> runs((size_t)nruns * 2, 0);
  uint32_t* curruns = runs.data();
  uint32_t* refruns = ref ? runs.data() + nruns : nullptr;
  if (ref) {
    refruns[0] = lastx;
    refruns[1] = 0;
  }
  Fax f(bp, cc, fill_order);
  int eolcnt = 0;
  int64_t line = 0;

  for (; occ > 0; op += rowbytes, occ -= rowbytes, ++line) {
    int64_t a0 = 0;
    int64_t run_length = 0;
    uint32_t* thisrun = curruns;
    uint32_t* pa = thisrun;
    uint32_t* pb = nullptr;
    int64_t b1 = 0;
    bool eof = false;

    auto setvalue = [&](int64_t x) -> bool {
      if (pa >= thisrun + nruns) return false;
      *pa++ = (uint32_t)(run_length + x);
      a0 += x;
      run_length = 0;
      return true;
    };
    auto cleanup = [&]() -> bool {
      if (run_length && !setvalue(0)) return false;
      if (a0 != (int64_t)lastx) {
        while (a0 > (int64_t)lastx && pa > thisrun) a0 -= *--pa;
        if (a0 < (int64_t)lastx) {
          if (a0 < 0) a0 = 0;
          if ((pa - thisrun) & 1)
            if (!setvalue(0)) return false;
          if (!setvalue(lastx - a0)) return false;
        } else if (a0 > (int64_t)lastx) {
          if (!setvalue(lastx) || !setvalue(0)) return false;
        }
      }
      return true;
    };
    // SYNC_EOL; false at the end of the data
    auto sync_eol = [&]() -> bool {
      if (eolcnt == 0) {
        for (;;) {
          if (!f.need16(11)) return false;
          if (f.get(11) == 0) break;
          f.clr(1);
        }
      }
      for (;;) {
        if (!f.need8(8)) return false;
        if (f.get(8)) break;
        f.clr(8);
      }
      while (f.get(1) == 0) f.clr(1);
      f.clr(1);
      eolcnt = 0;
      return true;
    };
    // EXPAND1D: 0 row done, 1 end of data, -1 run overflow
    auto expand1d = [&]() -> int {
      for (;;) {
        for (;;) {                                   // white
          if (!f.need16(12)) return 1;
          const TabEnt& e = T.white[f.get(12)];
          f.clr(e.width);
          if (e.state == S_EOL) {
            eolcnt = 1;
            return 0;
          }
          if (e.state == S_TermW) {
            if (!setvalue(e.param)) return -1;
            break;
          }
          if (e.state == S_MakeUpW || e.state == S_MakeUp) {
            a0 += e.param;
            run_length += e.param;
            continue;
          }
          return 0;                                   // unexpected code
        }
        if (a0 >= (int64_t)lastx) return 0;
        for (;;) {                                   // black
          if (!f.need16(13)) return 1;
          const TabEnt& e = T.black[f.get(13)];
          f.clr(e.width);
          if (e.state == S_EOL) {
            eolcnt = 1;
            return 0;
          }
          if (e.state == S_TermB) {
            if (!setvalue(e.param)) return -1;
            break;
          }
          if (e.state == S_MakeUpB || e.state == S_MakeUp) {
            a0 += e.param;
            run_length += e.param;
            continue;
          }
          return 0;
        }
        if (a0 >= (int64_t)lastx) return 0;
        if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
      }
    };
    auto check_b1 = [&]() -> bool {
      if (pa != thisrun)
        while (b1 <= a0 && b1 < (int64_t)lastx) {
          if (pb + 1 >= refruns + nruns) return false;
          b1 += pb[0] + pb[1];
          pb += 2;
        }
      return true;
    };
    // EXPAND2D: 0 row done, 1 end of data, -1 overflow
    auto expand2d = [&]() -> int {
      while (a0 < (int64_t)lastx) {
        if (pa >= thisrun + nruns) return -1;
        if (!f.need8(7)) return 1;
        const TabEnt& e = T.main[f.get(7)];
        f.clr(e.width);
        switch (e.state) {
          case S_Pass:
            if (!check_b1()) return -1;
            if (pb + 1 >= refruns + nruns) return -1;
            b1 += *pb++;
            run_length += b1 - a0;
            a0 = b1;
            b1 += *pb++;
            break;
          case S_Horiz: {
            bool black_first = (pa - thisrun) & 1;
            for (int half = 0; half < 2; ++half) {
              bool black = black_first != (half == 1);
              for (;;) {
                if (!f.need16(black ? 13 : 12)) return 1;
                const TabEnt& h = black ? T.black[f.get(13)] : T.white[f.get(12)];
                f.clr(h.width);
                if (h.state == (black ? S_TermB : S_TermW)) {
                  if (!setvalue(h.param)) return -1;
                  break;
                }
                if (h.state == (black ? S_MakeUpB : S_MakeUpW) || h.state == S_MakeUp) {
                  a0 += h.param;
                  run_length += h.param;
                  continue;
                }
                return 2;                            // unexpected: end the row
              }
            }
            if (!check_b1()) return -1;
            break;
          }
          case S_V0:
            if (!check_b1()) return -1;
            if (!setvalue(b1 - a0)) return -1;
            if (pb >= refruns + nruns) return -1;
            b1 += *pb++;
            break;
          case S_VR:
            if (!check_b1()) return -1;
            if (!setvalue(b1 - a0 + e.param)) return -1;
            if (pb >= refruns + nruns) return -1;
            b1 += *pb++;
            break;
          case S_VL:
            if (!check_b1()) return -1;
            if (b1 < (int64_t)(a0 + e.param)) return 2;
            if (!setvalue(b1 - a0 - e.param)) return -1;
            b1 -= *--pb;
            break;
          case S_Ext:
            *pa++ = (uint32_t)(lastx - a0);
            return 2;
          case S_EOL:
            *pa++ = (uint32_t)(lastx - a0);
            if (!f.need8(4)) return 1;
            f.clr(4);
            eolcnt = 1;
            return 2;
          default:
            return 2;
        }
      }
      if (run_length) {
        if (run_length + a0 < (int64_t)lastx) {
          if (!f.need8(1)) return 1;
          if (!f.get(1)) return 2;                   // badMain2d
          f.clr(1);
        }
        if (!setvalue(0)) return -1;
      }
      return 2;
    };

    if (codec == kCcittRle || codec == kCcittRleW) {
      int r = expand1d();
      if (r < 0 || !cleanup()) return 0;
      fill_runs(op, thisrun, pa, lastx);
      if (r == 1) return 0;
      if (codec == kCcittRle) {
        f.clr(f.avail - (f.avail & ~7));
      } else {
        f.clr(f.avail - (f.avail & ~15));
        if (f.avail == 0 && ((f.cp - bp) & 1)) ++f.cp;
      }
      continue;
    }
    if (codec == kFax3) {
      if (!sync_eol()) {
        eof = true;
      } else if (two_d_g3) {
        if (!f.need8(1)) {
          eof = true;
        } else {
          int is1d = (int)f.get(1);
          f.clr(1);
          pb = refruns;
          b1 = *pb++;
          int r = is1d ? expand1d() : expand2d();
          if (r < 0) return 0;
          if (r == 1) {
            cleanup();
            fill_runs(op, thisrun, pa, lastx);
            return line != 0 ? 1 : 0;
          }
          if (!cleanup()) return 0;
          fill_runs(op, thisrun, pa, lastx);
          if (pa < thisrun + nruns) setvalue(0);
          std::swap(curruns, refruns);
          continue;
        }
      } else {
        int r = expand1d();
        if (r < 0) return 0;
        if (r == 1) {
          cleanup();
          fill_runs(op, thisrun, pa, lastx);
          return line != 0 ? 1 : 0;
        }
        if (!cleanup()) return 0;
        fill_runs(op, thisrun, pa, lastx);
        continue;
      }
      // end of data before the row's EOL
      cleanup();
      fill_runs(op, thisrun, pa, lastx);
      return line != 0 ? 1 : 0;
    }
    // Group 4
    pb = refruns;
    b1 = *pb++;
    int r = expand2d();
    if (r < 0) return 0;
    if (r == 2 && !cleanup()) return 0;
    if (r == 1) {
      cleanup();
      eof = true;
    }
    if (eof || eolcnt) {
      // EOFG4: fill this row and stop; success if a row was done before
      fill_runs(op, thisrun, pa, lastx);
      return line != 0 ? 1 : 0;
    }
    fill_runs(op, thisrun, pa, lastx);
    setvalue(0);
    std::swap(curruns, refruns);
  }
  return 1;
}

}  // namespace
