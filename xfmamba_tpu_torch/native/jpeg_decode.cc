// JPEG decoding to 8-bit gray for xfmamba_tpu_torch/data/jpeg.py, bit for
// bit what cv2.imread(path, IMREAD_GRAYSCALE) gives (OpenCV over
// libjpeg-turbo 3, reading through libjpeg's stdio source).  One call,
// `jpeg_decode_gray`, reads the whole file; it is bound with ctypes, so the
// GIL is released while it runs.
//
// The structure follows libjpeg-turbo's decoder module by module:
//   - the source: the file's bytes, then FF D9 (a fake EOI marker) without
//     end, as jdatasrc.c's stdio source feeds a truncated file;
//   - jdmarker.c: markers, tables (DHT, DQT, DRI, DAC), APP0 (JFIF) and
//     APP14 (Adobe), restart markers with resync_to_restart's recovery;
//   - jdinput.c: frame setup at the first SOS, per-scan setup, quantisation
//     tables latched at a component's first scan;
//   - jdhuff.c / jdphuff.c / jdlhuff.c: sequential, progressive and
//     lossless Huffman decoding, with the bit reader that stuffs zeros at a
//     marker and leaves the rest of a segment's MCUs untouched once the data
//     ran out; a bad code decodes as 0;
//   - jdarith.c: the QM decoder (Annex D) with its statistics, sequential and
//     progressive;
//   - jdcoefct.c: coefficients kept for the whole image, then the IDCT, with
//     block smoothing (libjpeg-turbo >= 2.1's 5 x 5 neighbourhood) where a
//     progressive file leaves coefficients inexact;
//   - jidctint.c's islow IDCT as libjpeg-turbo's x86 SIMD code computes it
//     (16-bit dequantisation and sums, saturating packs), which is what it
//     runs on an x86 host;
//   - jdlossls.c: the lossless predictors, point transform and restarts;
//   - jdsample.c: fancy (triangle) upsampling h2v1, h1v2, h2v2, else
//     replication; jdcolor.c: YCbCr -> gray (luma), RGB -> gray, YCCK ->
//     CMYK; and OpenCV's CMYK -> gray (imgcodecs utils.cpp).
// What libjpeg refuses (or cv2 cannot read), this refuses with a message
// naming the format.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{buf};
}

// zigzag -> natural order, 16 extra entries for corrupt runs past the block
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Annex K.3's tables, which libjpeg-turbo's sequential Huffman decoder
// uses for slots 0 and 1 when a file defines none (jstdhuff.c)
const char* const kStdTables[4][2] = {
    {"00010501010101010100000000000000", "000102030405060708090a0b"},
    {"00030101010101010101010000000000", "000102030405060708090a0b"},
    {"0002010303020403050504040000017d",
     "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
     "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a"
     "838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2"
     "d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"},
    {"00020102040403040705040400010277",
     "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718"
     "191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a"
     "82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9ca"
     "d2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"}};

int hexval(char c) { return c <= '9' ? c - '0' : c - 'a' + 10; }

// jaricom.c's jpeg_aritab (entry 113: the fixed 0.5 estimate)
constexpr uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

enum Marker {
  SOF0 = 0xC0, SOF1, SOF2, SOF3, DHT, SOF5, SOF6, SOF7, JPG, SOF9, SOF10, SOF11, DAC, SOF13,
  SOF14, SOF15, RST0 = 0xD0, RST7 = 0xD7, SOI = 0xD8, EOI = 0xD9, SOS = 0xDA, DQT = 0xDB,
  DNL = 0xDC, DRI = 0xDD, APP0 = 0xE0, APP14 = 0xEE, APP15 = 0xEF, COM = 0xFE, TEM = 0x01
};

// The file, then FF D9 repeated: what libjpeg's stdio source gives a
// decoder that reads past the end of a truncated file.
struct Source {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;
  int byte() {
    const int64_t p = pos++;
    if (p < n) return d[p];
    if (p - n > (int64_t(1) << 28)) fail("corrupt JPEG (reads far past the end of the data)");
    return ((p - n) & 1) ? 0xD9 : 0xFF;
  }
  int word() {
    const int a = byte();
    return (a << 8) | byte();
  }
  void skip(int64_t k) {
    if (k > 0) pos += k;
  }
};

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_nb[256];
  uint8_t look_sym[256];
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, index = 0, dc_tbl = 0, ac_tbl = 0;
  int64_t wb = 0, hb = 0;  // width and height in blocks (samples, lossless)
  int64_t dw = 0, dh = 0;  // downsampled width and height in samples
  int64_t bw = 0, bh = 0;  // allocated block grid, padded to whole MCUs
  bool latched = false;
  uint16_t q[64] = {0};
  std::vector<int16_t> coef;     // bh * bw * 64, natural order
  std::vector<int32_t> diff;     // lossless: differences of the current iMCU row
  std::vector<uint16_t> samp;    // lossless: undifferenced samples, bh * bw
  int coef_bits[64];
  int prev_bits[64];
  bool needed = true;
  int mcu_w = 1, mcu_h = 1, last_col_width = 1, last_row_height = 1;
  int lossless_first = 1;        // the next row undifferences as a first row
  int pt = 0;                    // lossless: the point transform of its scan
};

// jidctint.c's islow IDCT as libjpeg-turbo's SSE2 / AVX2 code computes it:
// dequantisation keeps the low 16 bits (pmullw), in0 +/- in4 and the odd
// part's z3 / z4 sums wrap at 16 bits (paddw), products and the rest are
// 32-bit (pmaddwd), each pass saturates to 16 bits (packssdw), and the
// output saturates to -128..127 before the +128 (packsswb, paddb).
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int16_t w16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int16_t sat16(int32_t x) { return (int16_t)std::min(32767, std::max(-32768, x)); }
inline uint32_t u32(int64_t x) { return (uint32_t)x; }
inline int32_t add32(int32_t a, int32_t b) { return (int32_t)(u32(a) + u32(b)); }
inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)(u32(a) - u32(b)); }
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {
  return (int32_t)(u32((int64_t)a * ca) + u32((int64_t)b * cb));
}

void idct_pass(const int16_t in[8], int32_t out[8]) {
  const int16_t z2 = in[2], z3 = in[6];
  const int32_t tmp3 = madd(z2, F0541 + F0765, z3, F0541);
  const int32_t tmp2 = madd(z2, F0541, z3, F0541 - F1847);
  const int32_t tmp0 = (int32_t)((uint32_t)(int32_t)w16(in[0] + in[4]) << 13);
  const int32_t tmp1 = (int32_t)((uint32_t)(int32_t)w16(in[0] - in[4]) << 13);
  const int32_t t10 = add32(tmp0, tmp3), t13 = sub32(tmp0, tmp3);
  const int32_t t11 = add32(tmp1, tmp2), t12 = sub32(tmp1, tmp2);
  const int16_t i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
  const int16_t s3 = w16(i7 + i3), s4 = w16(i5 + i1);
  const int32_t z3o = madd(s3, F1175 - F1961, s4, F1175);
  const int32_t z4o = madd(s3, F1175, s4, F1175 - F0390);
  const int32_t o0 = add32(madd(i7, F0298 - F0899, i1, -F0899), z3o);
  const int32_t o3 = add32(madd(i7, -F0899, i1, F1501 - F0899), z4o);
  const int32_t o1 = add32(madd(i5, F2053 - F2562, i3, -F2562), z4o);
  const int32_t o2 = add32(madd(i5, -F2562, i3, F3072 - F2562), z3o);
  out[0] = add32(t10, o3);
  out[7] = sub32(t10, o3);
  out[1] = add32(t11, o2);
  out[6] = sub32(t11, o2);
  out[2] = add32(t12, o1);
  out[5] = sub32(t12, o1);
  out[3] = add32(t13, o0);
  out[4] = sub32(t13, o0);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int64_t stride) {
  int16_t dq[64];
  bool ac_zero = true;
  for (int i = 0; i < 64; ++i) {
    dq[i] = w16((int32_t)coef[i] * (int16_t)q[i]);
    if (i >= 8 && dq[i]) ac_zero = false;
  }
  int16_t ws[64];
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = w16((int32_t)dq[c] * 4);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t col[8];
      int32_t o[8];
      for (int r = 0; r < 8; ++r) col[r] = dq[r * 8 + c];
      idct_pass(col, o);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = sat16(add32(o[r], 1 << 10) >> 11);
    }
  }
  for (int r = 0; r < 8; ++r) {
    int32_t o[8];
    idct_pass(ws + r * 8, o);
    uint8_t* dst = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = sat16(add32(o[c], 1 << 17) >> 18);
      dst[c] = (uint8_t)(std::min(127, std::max(-128, v)) + 128);
    }
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* d, int64_t n) : src_{d, n} {}
  std::vector<uint8_t> run(int64_t* height, int64_t* width);

 private:
  Source src_;
  int unread_ = 0;
  bool saw_soi_ = false, saw_sof_ = false, progressive_ = false, lossless_ = false,
       arith_ = false, jfif_ = false, adobe_ = false;
  int sof_ = 0, adobe_transform_ = 0, precision_ = 8, restart_interval_ = 0;
  int64_t height_ = 0, width_ = 0;
  std::vector<Comp> comps_;
  bool qdef_[4] = {false, false, false, false};
  uint16_t qt_[4][64];
  HuffSpec dht_[2][4];
  uint8_t dc_l_[16], dc_u_[16], ac_k_[16];
  int next_restart_ = 0;
  int discarded_ = 0;
  // scan state
  int ncur_ = 0, ss_ = 0, se_ = 0, ah_ = 0, al_ = 0, input_scan_ = 0;
  Comp* cur_[4] = {nullptr, nullptr, nullptr, nullptr};
  int hmax_ = 1, vmax_ = 1, unit_ = 8;
  int64_t mcus_per_row_ = 0, mcu_rows_ = 0, total_imcu_rows_ = 0;
  int blocks_in_mcu_ = 0, membership_[10];
  bool multiple_scans_ = false;
  int64_t last_good_imcu_ = 0;  // the last iMCU row a scan decoded with data
  bool eoi_ = false;
  // entropy state
  uint64_t buf_ = 0;
  int bits_ = 0;
  bool insufficient_ = false;
  int restarts_to_go_ = 0;
  int last_dc_[4] = {0, 0, 0, 0};
  int eobrun_ = 0;
  Derived tbl_[2][4];
  // arithmetic coder
  int64_t ac_c_ = 0, ac_a_ = 0;
  int ac_ct_ = 0;
  uint8_t dc_stats_[16][64], ac_stats_[16][256], fixed_bin_[1];
  int dc_context_[4] = {0, 0, 0, 0};

  // jdmarker.c
  void first_marker();
  void next_marker();
  int read_markers();
  void get_sof();
  void get_sos();
  void get_dht();
  void get_dqt();
  void get_dri();
  void get_dac();
  void get_app();
  void skip_variable();
  bool read_restart_marker();
  void resync_to_restart(int desired);
  // jdinput.c
  void initial_setup();
  void start_scan();
  void decode_scan();
  // entropy decoders
  void make_derived(int kind, int slot);
  void fill(int nbits);
  int get_bits(int n);
  int huff_decode(const Derived& t);
  int huff_slow(const Derived& t, int l);
  void huff_restart();
  void decode_mcu_sequential(int64_t mcu_x, int64_t mcu_y);
  void decode_mcu_progressive(int64_t mcu_x, int64_t mcu_y);
  int16_t* block_of(int b, int64_t mcu_x, int64_t mcu_y, Comp** comp);
  void arith_restart();
  int arith_decode(uint8_t* st);
  void decode_mcu_arith(int64_t mcu_x, int64_t mcu_y);
  void lossless_scan();
  // output
  std::vector<uint8_t> plane(Comp& c);
  bool smoothing_ok(int latch[][10], int prev_latch[][10]);
  void smooth_plane(Comp& c, const int* bits, const int* prev_bits, uint8_t* out, int64_t stride);
  std::vector<uint8_t> upsample(const Comp& c, const std::vector<uint8_t>& p);
};

// ---------------------------------------------------------------------------
// Markers (jdmarker.c)
// ---------------------------------------------------------------------------

void Decoder::first_marker() {
  const int c = src_.byte(), c2 = src_.byte();
  if (c != 0xFF || c2 != SOI) fail("not a JPEG file (no SOI marker)");
  unread_ = c2;
}

void Decoder::next_marker() {
  for (;;) {
    int c = src_.byte();
    while (c != 0xFF) {
      ++discarded_;
      c = src_.byte();
    }
    do c = src_.byte();
    while (c == 0xFF);
    if (c != 0) {
      unread_ = c;
      discarded_ = 0;
      return;
    }
    discarded_ += 2;
  }
}

// Returns SOS or EOI.
int Decoder::read_markers() {
  for (;;) {
    if (unread_ == 0) {
      if (!saw_soi_)
        first_marker();
      else
        next_marker();
    }
    const int m = unread_;
    switch (m) {
      case SOI:
        if (saw_soi_) fail("corrupt JPEG (a second SOI marker)");
        saw_soi_ = true;
        std::memset(dc_l_, 0, sizeof dc_l_);
        std::memset(dc_u_, 1, sizeof dc_u_);
        std::memset(ac_k_, 5, sizeof ac_k_);
        restart_interval_ = 0;
        break;
      case SOF0: case SOF1: case SOF2: case SOF3: case SOF9: case SOF10: case SOF11:
        sof_ = m;
        get_sof();
        break;
      case SOF5: case SOF6: case SOF7: case JPG: case SOF13: case SOF14: case SOF15:
        fail("unsupported JPEG format: %s", m == JPG ? "JPG extension (SOF marker 0xC8)"
                                            : m == SOF5 || m == SOF13
                                                ? "hierarchical (differential sequential)"
                                            : m == SOF6 || m == SOF14
                                                ? "hierarchical (differential progressive)"
                                                : "hierarchical (differential lossless)");
      case SOS:
        get_sos();
        unread_ = 0;
        return SOS;
      case EOI:
        unread_ = 0;
        return EOI;
      case DAC: get_dac(); break;
      case DHT: get_dht(); break;
      case DQT: get_dqt(); break;
      case DRI: get_dri(); break;
      case COM: skip_variable(); break;
      case DNL: skip_variable(); break;
      case TEM: break;
      default:
        if (m >= APP0 && m <= APP15) {
          if (m == APP0 || m == APP14)
            get_app();
          else
            skip_variable();
        } else if (m >= RST0 && m <= RST7) {
          // a parameterless marker outside a scan: ignored
        } else {
          fail("corrupt JPEG (unknown marker 0x%02X)", m);
        }
    }
    unread_ = 0;
  }
}

void Decoder::get_sof() {
  if (saw_sof_) fail("corrupt JPEG (a second frame header)");
  progressive_ = sof_ == SOF2 || sof_ == SOF10;
  lossless_ = sof_ == SOF3 || sof_ == SOF11;
  arith_ = sof_ >= SOF9;
  const int length = src_.word();
  precision_ = src_.byte();
  height_ = src_.word();
  width_ = src_.word();
  const int n = src_.byte();
  if (height_ == 0)
    fail("unsupported JPEG format: height given by a DNL marker (a frame height of 0)");
  if (width_ == 0 || n == 0) fail("corrupt JPEG (an empty frame)");
  if (length - 8 != n * 3) fail("corrupt JPEG (frame header length)");
  comps_.assign(n, Comp());
  for (int ci = 0; ci < n; ++ci) {
    Comp& c = comps_[ci];
    c.index = ci;
    c.id = src_.byte();
    for (int pi = ci - 1; pi >= 0; --pi) {
      if (c.id == comps_[pi].id) {
        c.id = comps_[0].id;
        for (int k = 1; k < ci; ++k) c.id = std::max(c.id, comps_[k].id);
        ++c.id;
        break;
      }
    }
    const int hv = src_.byte();
    c.h = (hv >> 4) & 15;
    c.v = hv & 15;
    c.tq = src_.byte();
  }
  saw_sof_ = true;
}

void Decoder::get_sos() {
  if (!saw_sof_) fail("corrupt JPEG (a scan before the frame header)");
  const int length = src_.word();
  const int n = src_.byte();
  if (length != n * 2 + 6 || n > 4 || (n == 0 && !progressive_))
    fail("corrupt JPEG (scan header length)");
  ncur_ = n;
  for (int i = 0; i < 4; ++i) cur_[i] = nullptr;
  for (int i = 0; i < n; ++i) {
    int cc = src_.byte();
    const int c = src_.byte();
    for (int pi = i - 1; pi >= 0; --pi) {
      if (cur_[pi]->id == cc) {
        cc = cur_[0]->id;
        for (int k = 1; k < i; ++k) cc = std::max(cc, cur_[k]->id);
        ++cc;
        break;
      }
    }
    Comp* found = nullptr;
    for (int ci = 0; ci < (int)comps_.size(); ++ci) {
      bool taken = false;
      for (int k = 0; k < i; ++k) taken |= cur_[k] == &comps_[ci];
      if (comps_[ci].id == cc && !taken) {
        found = &comps_[ci];
        break;
      }
    }
    if (!found) fail("corrupt JPEG (a scan of an undeclared component %d)", cc);
    cur_[i] = found;
    found->dc_tbl = (c >> 4) & 15;
    found->ac_tbl = c & 15;
  }
  ss_ = src_.byte();
  se_ = src_.byte();
  const int a = src_.byte();
  ah_ = (a >> 4) & 15;
  al_ = a & 15;
  next_restart_ = 0;
  if (n) ++input_scan_;
}

void Decoder::get_dht() {
  int length = src_.word() - 2;
  while (length > 16) {
    const int index = src_.byte();
    uint8_t bits[17] = {0};
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      bits[i] = (uint8_t)src_.byte();
      count += bits[i];
    }
    length -= 17;
    if (count > 256 || count > length) fail("corrupt JPEG (bad Huffman table)");
    uint8_t vals[256] = {0};
    for (int i = 0; i < count; ++i) vals[i] = (uint8_t)src_.byte();
    length -= count;
    const int kind = (index & 0x10) ? 1 : 0;
    const int slot = kind ? index - 0x10 : index;
    if (slot < 0 || slot >= 4) fail("corrupt JPEG (Huffman table index %d)", index);
    HuffSpec& h = dht_[kind][slot];
    h.defined = true;
    std::memcpy(h.bits, bits, sizeof bits);
    std::memcpy(h.vals, vals, sizeof vals);
  }
  if (length != 0) fail("corrupt JPEG (DHT segment length)");
}

void Decoder::get_dqt() {
  int length = src_.word() - 2;
  while (length > 0) {
    --length;
    const int n = src_.byte();
    const int prec = n >> 4, slot = n & 15;
    if (slot >= 4) fail("corrupt JPEG (quantisation table index %d)", slot);
    for (int i = 0; i < 64; ++i)
      qt_[slot][kNatural[i]] = (uint16_t)(prec ? src_.word() : src_.byte());
    qdef_[slot] = true;
    length -= 64;
    if (prec) length -= 64;
  }
  if (length != 0) fail("corrupt JPEG (DQT segment length)");
}

void Decoder::get_dri() {
  if (src_.word() != 4) fail("corrupt JPEG (DRI segment length)");
  restart_interval_ = src_.word();
}

void Decoder::get_dac() {
  int length = src_.word() - 2;
  while (length > 0) {
    const int index = src_.byte(), val = src_.byte();
    length -= 2;
    if (index >= 32) fail("corrupt JPEG (DAC table index %d)", index);
    if (index >= 16) {
      ac_k_[index - 16] = (uint8_t)val;
    } else {
      dc_l_[index] = (uint8_t)(val & 15);
      dc_u_[index] = (uint8_t)(val >> 4);
      if (dc_l_[index] > dc_u_[index]) fail("corrupt JPEG (DAC conditioning bounds)");
    }
  }
  if (length != 0) fail("corrupt JPEG (DAC segment length)");
}

void Decoder::get_app() {
  int64_t length = src_.word() - 2;
  const int numtoread = length >= 14 ? 14 : length > 0 ? (int)length : 0;
  uint8_t b[14];
  for (int i = 0; i < numtoread; ++i) b[i] = (uint8_t)src_.byte();
  length -= numtoread;
  if (unread_ == APP0) {
    if (numtoread >= 14 && !std::memcmp(b, "JFIF\0", 5)) jfif_ = true;
  } else if (numtoread >= 12 && !std::memcmp(b, "Adobe", 5)) {
    adobe_ = true;
    adobe_transform_ = b[11];
  }
  src_.skip(length);
}

void Decoder::skip_variable() { src_.skip(src_.word() - 2); }

bool Decoder::read_restart_marker() {
  if (unread_ == 0) next_marker();
  if (unread_ == RST0 + next_restart_)
    unread_ = 0;
  else
    resync_to_restart(next_restart_);
  next_restart_ = (next_restart_ + 1) & 7;
  return true;
}

// jdmarker.c's jpeg_resync_to_restart
void Decoder::resync_to_restart(int desired) {
  int marker = unread_;
  for (;;) {
    int action;
    if (marker < SOF0)
      action = 2;
    else if (marker < RST0 || marker > RST7)
      action = 3;
    else if (marker == RST0 + ((desired + 1) & 7) || marker == RST0 + ((desired + 2) & 7))
      action = 3;
    else if (marker == RST0 + ((desired - 1) & 7) || marker == RST0 + ((desired - 2) & 7))
      action = 2;
    else
      action = 1;
    if (action == 1) {
      unread_ = 0;
      return;
    }
    if (action == 3) return;
    next_marker();
    marker = unread_;
  }
}

// ---------------------------------------------------------------------------
// Frame and scan setup (jdinput.c)
// ---------------------------------------------------------------------------

void Decoder::initial_setup() {
  if (height_ > 65500 || width_ > 65500) fail("unsupported JPEG format: larger than 65500 pixels");
  if (lossless_) {
    if (precision_ < 2 || precision_ > 16)
      fail("corrupt JPEG (%d-bit lossless samples)", precision_);
  } else if (precision_ != 8 && precision_ != 12) {
    fail("corrupt JPEG (%d-bit samples)", precision_);
  }
  if (comps_.size() > 10) fail("corrupt JPEG (%d components)", (int)comps_.size());
  hmax_ = vmax_ = 1;
  for (const Comp& c : comps_) {
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
      fail("corrupt JPEG (sampling factors %dx%d)", c.h, c.v);
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  unit_ = lossless_ ? 1 : 8;
  const int64_t mx = (width_ + hmax_ * unit_ - 1) / (hmax_ * unit_);
  const int64_t my = (height_ + vmax_ * unit_ - 1) / (vmax_ * unit_);
  total_imcu_rows_ = my;
  for (Comp& c : comps_) {
    c.wb = (width_ * c.h + hmax_ * unit_ - 1) / (hmax_ * unit_);
    c.hb = (height_ * c.v + vmax_ * unit_ - 1) / (vmax_ * unit_);
    c.dw = (width_ * c.h + hmax_ - 1) / hmax_;
    c.dh = (height_ * c.v + vmax_ - 1) / vmax_;
    c.bw = mx * c.h;
    c.bh = my * c.v;
    for (int k = 0; k < 64; ++k) c.coef_bits[k] = c.prev_bits[k] = -1;
  }
  multiple_scans_ = ncur_ < (int)comps_.size() || progressive_;
}

void Decoder::start_scan() {
  // per_scan_setup
  if (ncur_ == 1) {
    Comp* c = cur_[0];
    mcus_per_row_ = c->wb;
    mcu_rows_ = c->hb;
    c->mcu_w = c->mcu_h = 1;
    c->last_col_width = 1;
    const int t = (int)(c->hb % c->v);
    c->last_row_height = t ? t : c->v;
    blocks_in_mcu_ = 1;
    membership_[0] = 0;
  } else {
    mcus_per_row_ = (width_ + hmax_ * unit_ - 1) / (hmax_ * unit_);
    mcu_rows_ = (height_ + vmax_ * unit_ - 1) / (vmax_ * unit_);
    blocks_in_mcu_ = 0;
    for (int ci = 0; ci < ncur_; ++ci) {
      Comp* c = cur_[ci];
      c->mcu_w = c->h;
      c->mcu_h = c->v;
      int t = (int)(c->wb % c->h);
      c->last_col_width = t ? t : c->h;
      t = (int)(c->hb % c->v);
      c->last_row_height = t ? t : c->v;
      const int blocks = c->h * c->v;
      if (blocks_in_mcu_ + blocks > 10) fail("corrupt JPEG (more than 10 blocks in an MCU)");
      for (int k = 0; k < blocks; ++k) membership_[blocks_in_mcu_++] = ci;
    }
  }
  // latch_quant_tables
  if (!lossless_) {
    for (int ci = 0; ci < ncur_; ++ci) {
      Comp* c = cur_[ci];
      if (c->latched) continue;
      if (c->tq >= 4 || !qdef_[c->tq])
        fail("corrupt JPEG (quantisation table %d is not defined)", c->tq);
      std::memcpy(c->q, qt_[c->tq], sizeof c->q);
      c->latched = true;
    }
  }
  // the entropy decoder's start_pass
  if (lossless_) {
    if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= precision_)
      fail("corrupt JPEG (lossless scan parameters Ss=%d Se=%d Ah=%d Al=%d)", ss_, se_, ah_,
           al_);
    if (restart_interval_ % mcus_per_row_)
      fail("corrupt JPEG (a lossless restart interval of %d MCUs in rows of %d)",
           restart_interval_, (int)mcus_per_row_);
  } else if (progressive_) {
    bool bad = false;
    if (ss_ == 0) {
      if (se_ != 0) bad = true;
    } else {
      if (ss_ > se_ || se_ > 63) bad = true;
      if (ncur_ != 1) bad = true;
    }
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad)
      fail("corrupt JPEG (progressive scan parameters Ss=%d Se=%d Ah=%d Al=%d)", ss_, se_, ah_,
           al_);
    for (int ci = 0; ci < ncur_; ++ci) {
      Comp* c = cur_[ci];
      for (int k = std::min(ss_, 1); k <= std::max(se_, 9); ++k)
        c->prev_bits[k] = input_scan_ > 1 ? c->coef_bits[k] : 0;
      for (int k = ss_; k <= se_; ++k) c->coef_bits[k] = al_;
    }
  }
  if (!arith_) {
    for (int ci = 0; ci < ncur_; ++ci) {
      Comp* c = cur_[ci];
      if (lossless_ || !progressive_) {
        make_derived(0, c->dc_tbl);
        if (!lossless_) make_derived(1, c->ac_tbl);
      } else if (ss_ == 0) {
        if (ah_ == 0) make_derived(0, c->dc_tbl);
      } else {
        make_derived(1, c->ac_tbl);
      }
      last_dc_[ci] = 0;
    }
    bits_ = 0;
    buf_ = 0;
    insufficient_ = false;
    eobrun_ = 0;
  } else {
    for (int ci = 0; ci < ncur_; ++ci) {
      Comp* c = cur_[ci];
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        std::memset(dc_stats_[c->dc_tbl], 0, 64);
        last_dc_[ci] = 0;
        dc_context_[ci] = 0;
      }
      if (!progressive_ || ss_) std::memset(ac_stats_[c->ac_tbl], 0, 256);
    }
    ac_c_ = 0;
    ac_a_ = 0;
    ac_ct_ = -16;
    insufficient_ = false;
  }
  restarts_to_go_ = restart_interval_;
}

// ---------------------------------------------------------------------------
// Huffman decoding (jdhuff.c, jdphuff.c, jdlhuff.c)
// ---------------------------------------------------------------------------

void Decoder::make_derived(int kind, int slot) {
  if (slot < 0 || slot >= 4) fail("corrupt JPEG (Huffman table %d)", slot);
  const uint8_t* bits;
  const uint8_t* vals;
  uint8_t std_bits[17], std_vals[256];
  if (dht_[kind][slot].defined) {
    bits = dht_[kind][slot].bits;
    vals = dht_[kind][slot].vals;
  } else {
    // jinit_huff_decoder's standard tables; the progressive and lossless
    // decoders have none
    if (slot > 1 || progressive_ || lossless_)
      fail("corrupt JPEG (Huffman table %d is not defined)", slot);
    const char* const* t = kStdTables[kind * 2 + slot];
    std::memset(std_bits, 0, sizeof std_bits);
    std::memset(std_vals, 0, sizeof std_vals);
    for (int i = 0; i < 16; ++i)
      std_bits[i + 1] = (uint8_t)(hexval(t[0][2 * i]) * 16 + hexval(t[0][2 * i + 1]));
    for (int i = 0; t[1][2 * i]; ++i)
      std_vals[i] = (uint8_t)(hexval(t[1][2 * i]) * 16 + hexval(t[1][2 * i + 1]));
    bits = std_bits;
    vals = std_vals;
  }
  Derived& d = tbl_[kind][slot];
  char size[257];
  unsigned code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    const int i = bits[l];
    if (p + i > 256) fail("corrupt JPEG (bad Huffman table)");
    for (int k = 0; k < i; ++k) size[p++] = (char)l;
  }
  size[p] = 0;
  const int nsym = p;
  unsigned code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code_of[p++] = code;
      ++code;
    }
    if (code >= (1u << si)) fail("corrupt JPEG (bad Huffman table)");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      d.valoffset[l] = p - (int32_t)code_of[p];
      p += bits[l];
      d.maxcode[l] = (int32_t)code_of[p - 1];
    } else {
      d.maxcode[l] = -1;
      d.valoffset[l] = 0;
    }
  }
  d.valoffset[17] = 0;
  d.maxcode[17] = 0xFFFFF;
  std::memcpy(d.vals, vals, 256);
  std::memset(d.look_nb, 0, sizeof d.look_nb);
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= bits[l]; ++i, ++p) {
      int look = (int)(code_of[p] << (8 - l));
      for (int c = 1 << (8 - l); c > 0; --c, ++look) {
        d.look_nb[look] = (uint8_t)l;
        d.look_sym[look] = vals[p];
      }
    }
  }
  if (kind == 0) {
    for (int i = 0; i < nsym; ++i)
      if (vals[i] > (lossless_ ? 16 : 15)) fail("corrupt JPEG (bad Huffman table)");
  }
}

constexpr int kMinGetBits = 57;

// jdhuff.c's jpeg_fill_bit_buffer
void Decoder::fill(int nbits) {
  while (bits_ < kMinGetBits) {
    if (unread_) goto no_more;
    {
      int c = src_.byte();
      if (c == 0xFF) {
        do c = src_.byte();
        while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          unread_ = c;
          goto no_more;
        }
      }
      buf_ = (buf_ << 8) | (uint64_t)c;
      bits_ += 8;
    }
  }
  return;
no_more:
  if (nbits > bits_) {
    insufficient_ = true;
    buf_ <<= (kMinGetBits - bits_);
    bits_ = kMinGetBits;
  }
}

inline int Decoder::get_bits(int n) {
  if (bits_ < n) fill(n);
  bits_ -= n;
  return (int)((buf_ >> bits_) & ((1u << n) - 1));
}

int Decoder::huff_slow(const Derived& t, int l) {
  int code = get_bits(l);
  while (code > t.maxcode[l]) {
    code = (code << 1) | get_bits(1);
    ++l;
  }
  if (l > 16) return 0;  // a bad code decodes as 0 (JWRN_HUFF_BAD_CODE)
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int Decoder::huff_decode(const Derived& t) {
  if (bits_ < 8) {
    fill(0);
    if (bits_ < 8) return huff_slow(t, 1);
  }
  const int look = (int)((buf_ >> (bits_ - 8)) & 0xFF);
  const int nb = t.look_nb[look];
  if (nb) {
    bits_ -= nb;
    return t.look_sym[look];
  }
  return huff_slow(t, 9);
}

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

void Decoder::huff_restart() {
  bits_ = 0;
  read_restart_marker();
  for (int ci = 0; ci < 4; ++ci) last_dc_[ci] = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  if (unread_ == 0) insufficient_ = false;
}

int16_t* Decoder::block_of(int b, int64_t mcu_x, int64_t mcu_y, Comp** comp) {
  const int ci = membership_[b];
  Comp* c = cur_[ci];
  *comp = c;
  int64_t by, bx;
  if (ncur_ == 1) {
    by = mcu_y;
    bx = mcu_x;
  } else {
    int k = b;
    while (k > 0 && membership_[k - 1] == ci) --k;
    const int off = b - k;
    by = mcu_y * c->v + off / c->h;
    bx = mcu_x * c->h + off % c->h;
  }
  return c->coef.data() + (by * c->bw + bx) * 64;
}

void Decoder::decode_mcu_sequential(int64_t mcu_x, int64_t mcu_y) {
  if (restart_interval_ && restarts_to_go_ == 0) huff_restart();
  if (!insufficient_) {
    for (int b = 0; b < blocks_in_mcu_; ++b) {
      Comp* c;
      int16_t* blk = block_of(b, mcu_x, mcu_y, &c);
      const int ci = membership_[b];
      int s = huff_decode(tbl_[0][c->dc_tbl]);
      if (s) s = extend(get_bits(s), s);
      if (c->needed) {
        last_dc_[ci] += s;
        blk[0] = (int16_t)last_dc_[ci];
      }
      const Derived& ac = tbl_[1][c->ac_tbl];
      for (int k = 1; k < 64; ++k) {
        s = huff_decode(ac);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          const int v = extend(get_bits(s), s);
          if (c->needed) blk[kNatural[k]] = (int16_t)v;
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }
  if (restart_interval_) --restarts_to_go_;
}

void Decoder::decode_mcu_progressive(int64_t mcu_x, int64_t mcu_y) {
  if (restart_interval_ && restarts_to_go_ == 0) huff_restart();
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  if (ss_ == 0 && ah_ != 0) {  // DC refinement: one bit a block
    for (int b = 0; b < blocks_in_mcu_; ++b) {
      Comp* c;
      int16_t* blk = block_of(b, mcu_x, mcu_y, &c);
      if (get_bits(1)) blk[0] = (int16_t)(blk[0] | p1);
    }
  } else if (!insufficient_) {
    if (ss_ == 0) {  // DC first
      for (int b = 0; b < blocks_in_mcu_; ++b) {
        Comp* c;
        int16_t* blk = block_of(b, mcu_x, mcu_y, &c);
        const int ci = membership_[b];
        int s = huff_decode(tbl_[0][c->dc_tbl]);
        if (s) s = extend(get_bits(s), s);
        const int64_t sum = (int64_t)last_dc_[ci] + s;
        if (sum > INT32_MAX || sum < INT32_MIN) fail("corrupt JPEG (DC coefficient overflow)");
        last_dc_[ci] = (int)sum;
        blk[0] = (int16_t)(uint32_t)((uint32_t)last_dc_[ci] << al_);
      }
    } else if (ah_ == 0) {  // AC first
      if (eobrun_ > 0) {
        --eobrun_;
      } else {
        Comp* c;
        int16_t* blk = block_of(0, mcu_x, mcu_y, &c);
        const Derived& t = tbl_[1][c->ac_tbl];
        for (int k = ss_; k <= se_; ++k) {
          int s = huff_decode(t);
          int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            const int v = extend(get_bits(s), s);
            blk[kNatural[k]] = (int16_t)(uint32_t)((uint32_t)v << al_);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun_ = 1 << r;
            if (r) eobrun_ += get_bits(r);
            --eobrun_;
            break;
          }
        }
      }
    } else {  // AC refinement
      Comp* c;
      int16_t* blk = block_of(0, mcu_x, mcu_y, &c);
      const Derived& t = tbl_[1][c->ac_tbl];
      int k = ss_;
      if (eobrun_ == 0) {
        for (; k <= se_; ++k) {
          int s = huff_decode(t);
          int r = s >> 4;
          s &= 15;
          if (s) {
            s = get_bits(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun_ = 1 << r;
            if (r) eobrun_ += get_bits(r);
            break;
          }
          do {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) {
              if (get_bits(1)) {
                if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
              }
            } else {
              if (--r < 0) break;
            }
            ++k;
          } while (k <= se_);
          if (s) blk[kNatural[k]] = (int16_t)s;
        }
      }
      if (eobrun_ > 0) {
        for (; k <= se_; ++k) {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (get_bits(1)) {
              if ((*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          }
        }
        --eobrun_;
      }
    }
  }
  if (restart_interval_) --restarts_to_go_;
}

// ---------------------------------------------------------------------------
// Arithmetic decoding (jdarith.c)
// ---------------------------------------------------------------------------

int Decoder::arith_decode(uint8_t* st) {
  while (ac_a_ < 0x8000) {
    if (--ac_ct_ < 0) {
      int data;
      if (unread_) {
        data = 0;
      } else {
        data = src_.byte();
        if (data == 0xFF) {
          do data = src_.byte();
          while (data == 0xFF);
          if (data == 0) {
            data = 0xFF;
          } else {
            unread_ = data;
            data = 0;
          }
        }
      }
      ac_c_ = (ac_c_ << 8) | data;
      if ((ac_ct_ += 8) < 0)
        if (++ac_ct_ == 0) ac_a_ = 0x8000;
    }
    ac_a_ <<= 1;
  }
  int sv = *st;
  uint32_t qe = kAritab[sv & 0x7F];
  const int nl = qe & 0xFF;
  qe >>= 8;
  const int nm = qe & 0xFF;
  qe >>= 8;
  int64_t temp = ac_a_ - (int64_t)qe;
  ac_a_ = temp;
  temp <<= ac_ct_;
  if (ac_c_ >= temp) {
    ac_c_ -= temp;
    if (ac_a_ < (int64_t)qe) {
      ac_a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nm);
    } else {
      ac_a_ = qe;
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (ac_a_ < 0x8000) {
    if (ac_a_ < (int64_t)qe) {
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = (uint8_t)((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

void Decoder::arith_restart() {
  read_restart_marker();
  for (int ci = 0; ci < ncur_; ++ci) {
    Comp* c = cur_[ci];
    if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
      std::memset(dc_stats_[c->dc_tbl], 0, 64);
      last_dc_[ci] = 0;
      dc_context_[ci] = 0;
    }
    if (!progressive_ || ss_) std::memset(ac_stats_[c->ac_tbl], 0, 256);
  }
  ac_c_ = 0;
  ac_a_ = 0;
  ac_ct_ = -16;
  restarts_to_go_ = restart_interval_;
}

void Decoder::decode_mcu_arith(int64_t mcu_x, int64_t mcu_y) {
  if (restart_interval_) {
    if (restarts_to_go_ == 0) arith_restart();
    --restarts_to_go_;
  }
  if (ac_ct_ == -1) return;  // an earlier error: decode nothing more
  const bool dc_band = !progressive_ || ss_ == 0;
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  fixed_bin_[0] = 113;
  if (progressive_ && ss_ == 0 && ah_ != 0) {
    for (int b = 0; b < blocks_in_mcu_; ++b) {
      Comp* c;
      int16_t* blk = block_of(b, mcu_x, mcu_y, &c);
      fixed_bin_[0] = 113;
      if (arith_decode(fixed_bin_)) blk[0] = (int16_t)(blk[0] | p1);
    }
    return;
  }
  for (int b = 0; b < blocks_in_mcu_; ++b) {
    Comp* c;
    int16_t* blk = block_of(b, mcu_x, mcu_y, &c);
    const int ci = membership_[b];
    if (dc_band) {
      const int tbl = c->dc_tbl;
      uint8_t* st = dc_stats_[tbl] + dc_context_[ci];
      if (arith_decode(st) == 0) {
        dc_context_[ci] = 0;
      } else {
        const int sign = arith_decode(st + 1);
        st += 2 + sign;
        int m = arith_decode(st);
        if (m != 0) {
          st = dc_stats_[tbl] + 20;
          while (arith_decode(st)) {
            if ((m <<= 1) == 0x8000) {
              ac_ct_ = -1;
              return;
            }
            ++st;
          }
        }
        if (m < (int)((1L << dc_l_[tbl]) >> 1))
          dc_context_[ci] = 0;
        else if (m > (int)((1L << dc_u_[tbl]) >> 1))
          dc_context_[ci] = 12 + sign * 4;
        else
          dc_context_[ci] = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
          if (arith_decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        last_dc_[ci] = (last_dc_[ci] + v) & 0xffff;
      }
      if (progressive_)
        blk[0] = (int16_t)(uint32_t)((uint32_t)last_dc_[ci] << al_);
      else if (c->needed)
        blk[0] = (int16_t)last_dc_[ci];
      if (progressive_) continue;
    }
    const int tbl = c->ac_tbl;
    const int se = progressive_ ? se_ : 63;
    if (progressive_ && ah_ != 0) {  // AC refinement
      int kex;
      for (kex = se; kex > 0; --kex)
        if (blk[kNatural[kex]]) break;
      for (int k = ss_ - 1; k < se;) {
        uint8_t* st = ac_stats_[tbl] + 3 * k;
        if (k >= kex)
          if (arith_decode(st)) break;
        for (;;) {
          int16_t* coef = blk + kNatural[++k];
          if (*coef) {
            if (arith_decode(st + 2)) *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
            break;
          }
          if (arith_decode(st + 1)) {
            fixed_bin_[0] = 113;
            *coef = (int16_t)(arith_decode(fixed_bin_) ? m1 : p1);
            break;
          }
          st += 3;
          if (k >= se) {
            ac_ct_ = -1;
            return;
          }
        }
      }
      continue;
    }
    int k = progressive_ ? ss_ - 1 : 0;
    do {
      uint8_t* st = ac_stats_[tbl] + 3 * k;
      if (arith_decode(st)) break;
      for (;;) {
        ++k;
        if (arith_decode(st + 1)) break;
        st += 3;
        if (k >= se) {
          ac_ct_ = -1;
          return;
        }
      }
      fixed_bin_[0] = 113;
      const int sign = arith_decode(fixed_bin_);
      st += 2;
      int m = arith_decode(st);
      if (m != 0) {
        if (arith_decode(st)) {
          m <<= 1;
          st = ac_stats_[tbl] + (k <= ac_k_[tbl] ? 189 : 217);
          while (arith_decode(st)) {
            if ((m <<= 1) == 0x8000) {
              ac_ct_ = -1;
              return;
            }
            ++st;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      if (progressive_)
        blk[kNatural[k]] = (int16_t)(uint32_t)((uint32_t)v << al_);
      else if (c->needed)
        blk[kNatural[k]] = (int16_t)v;
    } while (k < se);
  }
}

// ---------------------------------------------------------------------------
// Lossless (jdlhuff.c, jddiffct.c, jdlossls.c)
// ---------------------------------------------------------------------------

void Decoder::lossless_scan() {
  const int64_t mcus = mcus_per_row_;
  int restart_rows_to_go = restart_interval_ ? restart_interval_ / (int)mcus : 0;
  const int initial = 1 << (precision_ - al_ - 1);
  for (int ci = 0; ci < ncur_; ++ci) cur_[ci]->lossless_first = 1;
  for (int64_t imcu = 0; imcu < total_imcu_rows_; ++imcu) {
    const bool last = imcu == total_imcu_rows_ - 1;
    const int rows_per =
        ncur_ > 1 ? 1 : (last ? cur_[0]->last_row_height : cur_[0]->v);
    for (int ci = 0; ci < ncur_; ++ci) {
      Comp* c = cur_[ci];
      c->diff.assign((size_t)c->v * c->bw, 0);
    }
    for (int yoff = 0; yoff < rows_per; ++yoff) {
      if (restart_interval_ && restart_rows_to_go == 0) {
        bits_ = 0;
        read_restart_marker();
        if (unread_ == 0) insufficient_ = false;
        for (Comp& c : comps_) c.lossless_first = 1;
        restart_rows_to_go = restart_interval_ / (int)mcus;
      }
      if (insufficient_) {
        for (int ci = 0; ci < ncur_; ++ci) {
          Comp* c = cur_[ci];
          const int rows = ncur_ > 1 ? c->v : 1;
          for (int r = 0; r < rows; ++r)
            std::fill_n(c->diff.begin() + (size_t)(ncur_ > 1 ? r : yoff) * c->bw, c->bw, 0);
        }
        for (Comp& c : comps_) c.lossless_first = 1;
      } else {
        for (int64_t mx = 0; mx < mcus; ++mx) {
          for (int b = 0; b < blocks_in_mcu_; ++b) {
            const int ci = membership_[b];
            Comp* c = cur_[ci];
            int k = b;
            while (k > 0 && membership_[k - 1] == ci) --k;
            const int off = b - k;
            const int64_t row = ncur_ > 1 ? off / c->h : yoff;
            const int64_t col = ncur_ > 1 ? mx * c->h + off % c->h : mx;
            int s = huff_decode(tbl_[0][c->dc_tbl]);
            if (s) {
              if (s == 16)
                s = 32768;
              else
                s = extend(get_bits(s), s);
            }
            c->diff[(size_t)row * c->bw + col] = s;
          }
        }
      }
      if (restart_interval_) --restart_rows_to_go;
    }
    // undifference and scale the rows of this iMCU row
    for (int ci = 0; ci < ncur_; ++ci) {
      Comp* c = cur_[ci];
      const int rows = last ? c->last_row_height : c->v;
      for (int r = 0; r < rows; ++r) {
        const int64_t y = imcu * c->v + r;
        const int32_t* d = c->diff.data() + (size_t)r * c->bw;
        uint16_t* out = c->samp.data() + y * c->bw;
        const uint16_t* prev = y ? out - c->bw : nullptr;
        const int64_t w = c->wb;
        if (c->lossless_first || !prev) {
          int ra = (d[0] + initial) & 0xFFFF;
          out[0] = (uint16_t)ra;
          for (int64_t x = 1; x < w; ++x) {
            ra = (d[x] + ra) & 0xFFFF;
            out[x] = (uint16_t)ra;
          }
          c->lossless_first = 0;
          continue;
        }
        int rb = prev[0];
        int ra = (d[0] + rb) & 0xFFFF;
        out[0] = (uint16_t)ra;
        for (int64_t x = 1; x < w; ++x) {
          const int rc = rb;
          rb = prev[x];
          int pred;
          switch (ss_) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
          ra = (d[x] + pred) & 0xFFFF;
          out[x] = (uint16_t)ra;
        }
      }
    }
  }
  for (int ci = 0; ci < ncur_; ++ci) cur_[ci]->pt = al_;
}

// ---------------------------------------------------------------------------
// Scans
// ---------------------------------------------------------------------------

void Decoder::decode_scan() {
  start_scan();
  if (lossless_) {
    if (arith_) fail("unsupported JPEG format: arithmetic-coded lossless");
    lossless_scan();
    return;
  }
  const int rows_per_imcu = ncur_ > 1 ? 1 : cur_[0]->v;
  for (int64_t my = 0; my < mcu_rows_; ++my) {
    if (my % rows_per_imcu == 0 && !insufficient_) last_good_imcu_ = my / rows_per_imcu;
    for (int64_t mx = 0; mx < mcus_per_row_; ++mx) {
      if (arith_)
        decode_mcu_arith(mx, my);
      else if (progressive_)
        decode_mcu_progressive(mx, my);
      else
        decode_mcu_sequential(mx, my);
    }
  }
}

// ---------------------------------------------------------------------------
// Output: IDCT (with block smoothing), upsampling, colour
// ---------------------------------------------------------------------------

constexpr int kSaved = 10;

bool Decoder::smoothing_ok(int latch[][10], int prev_latch[][10]) {
  if (!progressive_) return false;
  bool useful = false;
  for (size_t ci = 0; ci < comps_.size(); ++ci) {
    const Comp& c = comps_[ci];
    if (!c.latched) return false;
    const uint16_t* q = c.q;
    if (!q[0] || !q[1] || !q[8] || !q[16] || !q[9] || !q[2] || !q[3] || !q[10] || !q[17] ||
        !q[24])
      return false;
    if (c.coef_bits[0] < 0) return false;
    latch[ci][0] = c.coef_bits[0];
    for (int k = 1; k < kSaved; ++k) {
      prev_latch[ci][k] = input_scan_ > 1 ? c.prev_bits[k] : -1;
      latch[ci][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

inline int smooth_pred(int64_t qk, int64_t num, int al) {
  int pred;
  if (num >= 0) {
    pred = (int)(((qk << 7) + num) / (qk << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((qk << 7) - num) / (qk << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

// jdcoefct.c's decompress_smooth_data for one component, all iMCU rows
void Decoder::smooth_plane(Comp& c, const int* cur_bits, const int* prev_bits, uint8_t* out,
                           int64_t stride) {
  const int64_t last_imcu = total_imcu_rows_ - 1;
  const uint16_t* q = c.q;
  const int64_t q00 = q[0], q01 = q[1], q10 = q[8], q20 = q[16], q11 = q[9], q02 = q[2],
                q03 = q[3], q12 = q[10], q21 = q[17], q30 = q[24];
  const int64_t last_col = c.wb - 1;
  int16_t ws[64];
  for (int64_t imcu = 0; imcu <= last_imcu; ++imcu) {
    // rows past the last one the final scan decoded keep the previous
    // scan's accuracy
    const int* coef_bits = imcu > last_good_imcu_ ? prev_bits : cur_bits;
    const bool change_dc = coef_bits[1] == -1 && coef_bits[2] == -1 && coef_bits[3] == -1 &&
                           coef_bits[4] == -1 && coef_bits[5] == -1 && coef_bits[6] == -1 &&
                           coef_bits[7] == -1 && coef_bits[8] == -1 && coef_bits[9] == -1;
    int block_rows = c.v;
    if (imcu == last_imcu) {
      block_rows = (int)(c.hb % c.v);
      if (block_rows == 0) block_rows = c.v;
    }
    for (int br = 0; br < block_rows; ++br) {
      const int64_t row = imcu * c.v + br;
      auto at = [&](int64_t r) { return c.coef.data() + r * c.bw * 64; };
      const int16_t* cur = at(row);
      const int16_t* prev = (br > 0 || imcu > 0) ? at(row - 1) : cur;
      // the neighbour rows libjpeg-turbo 3 takes: clamped at the top; at the
      // bottom the row two below may be a dummy row of the last iMCU row
      const int16_t* prev2 = row > 1 ? at(row - 2) : prev;
      const int16_t* next = (br < block_rows - 1 || imcu < last_imcu) ? at(row + 1) : cur;
      const int16_t* next2 =
          (br < block_rows - 2 || imcu < last_imcu) && row + 2 < c.bh ? at(row + 2) : next;
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14,
          DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = prev2[0];
      DC06 = DC07 = DC08 = DC09 = DC10 = prev[0];
      DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
      DC16 = DC17 = DC18 = DC19 = DC20 = next[0];
      DC21 = DC22 = DC23 = DC24 = DC25 = next2[0];
      for (int64_t bn = 0; bn <= last_col; ++bn) {
        const int64_t o = bn * 64;
        std::memcpy(ws, cur + o, sizeof ws);
        if (bn == 0 && bn < last_col) {
          DC04 = DC05 = prev2[o + 64];
          DC09 = DC10 = prev[o + 64];
          DC14 = DC15 = cur[o + 64];
          DC19 = DC20 = next[o + 64];
          DC24 = DC25 = next2[o + 64];
        }
        if (bn + 1 < last_col) {
          DC05 = prev2[o + 128];
          DC10 = prev[o + 128];
          DC15 = cur[o + 128];
          DC20 = next[o + 128];
          DC25 = next2[o + 128];
        }
        int al;
        int64_t num;
        if ((al = coef_bits[1]) != 0 && ws[1] == 0) {
          num = q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                    13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                                    3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                                    DC21 - DC22 + DC24 + DC25)
                                 : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = (int16_t)smooth_pred(q01, num, al);
        }
        if ((al = coef_bits[2]) != 0 && ws[8] == 0) {
          num = q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                    13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                    13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                    3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                 : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = (int16_t)smooth_pred(q10, num, al);
        }
        if ((al = coef_bits[3]) != 0 && ws[16] == 0) {
          num = q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                    14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                                    DC23)
                                 : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = (int16_t)smooth_pred(q20, num, al);
        }
        if ((al = coef_bits[4]) != 0 && ws[9] == 0) {
          num = q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                    DC21 - DC25)
                                 : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                    DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = (int16_t)smooth_pred(q11, num, al);
        }
        if ((al = coef_bits[5]) != 0 && ws[2] == 0) {
          num = q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                    14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                    2 * DC19)
                                 : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = (int16_t)smooth_pred(q02, num, al);
        }
        if (change_dc) {
          if ((al = coef_bits[6]) != 0 && ws[3] == 0) {
            num = q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = (int16_t)smooth_pred(q03, num, al);
          }
          if ((al = coef_bits[7]) != 0 && ws[10] == 0) {
            num = q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = (int16_t)smooth_pred(q12, num, al);
          }
          if ((al = coef_bits[8]) != 0 && ws[17] == 0) {
            num = q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = (int16_t)smooth_pred(q21, num, al);
          }
          if ((al = coef_bits[9]) != 0 && ws[24] == 0) {
            num = q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = (int16_t)smooth_pred(q30, num, al);
          }
          num = q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                       6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                       152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                       6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                       2 * DC25);
          ws[0] = (int16_t)smooth_pred(q00, num, 0);
        }
        idct_islow(ws, q, out + row * 8 * stride + bn * 8, stride);
        DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
        DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
        DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
        DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
        DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
      }
    }
  }
}

// The component's samples (hb * unit rows of wb * unit), 8 bits.
std::vector<uint8_t> Decoder::plane(Comp& c) {
  const int64_t stride = c.wb * unit_, rows = c.hb * unit_;
  std::vector<uint8_t> out((size_t)(stride * rows), 0);
  if (lossless_) {
    const int al = c.pt;
    if (!c.samp.empty())
      for (int64_t i = 0; i < stride * rows; ++i)
        out[(size_t)i] = (uint8_t)(c.samp[(size_t)((i / stride) * c.bw + i % stride)] << al);
    return out;
  }
  int latch[10][10], prev_latch[10][10];
  if (smoothing_ok(latch, prev_latch)) {
    smooth_plane(c, latch[c.index], prev_latch[c.index], out.data(), stride);
    return out;
  }
  static const uint16_t zero_q[64] = {0};
  const uint16_t* q = c.latched ? c.q : zero_q;
  for (int64_t by = 0; by < c.hb; ++by)
    for (int64_t bx = 0; bx < c.wb; ++bx)
      idct_islow(c.coef.data() + (by * c.bw + bx) * 64, q, out.data() + by * 8 * stride + bx * 8,
                 stride);
  return out;
}

// jdsample.c: the component's samples to width_ x height_
std::vector<uint8_t> Decoder::upsample(const Comp& c, const std::vector<uint8_t>& p) {
  const int64_t W = width_, H = height_, ps = c.wb * unit_, dw = c.dw, dh = c.dh;
  std::vector<uint8_t> out((size_t)(W * H));
  const bool fancy = !lossless_;
  auto in = [&](int64_t y, int64_t x) -> int { return p[(size_t)(y * ps + x)]; };
  auto row_at = [&](int64_t y) { return std::min(std::max(y, int64_t(0)), dh - 1); };
  if (c.h == hmax_ && c.v == vmax_) {
    for (int64_t y = 0; y < H; ++y) std::memcpy(&out[(size_t)(y * W)], &p[(size_t)(y * ps)], W);
  } else if (c.h * 2 == hmax_ && c.v == vmax_ && fancy && dw > 2) {
    for (int64_t y = 0; y < H; ++y) {
      uint8_t* o = &out[(size_t)(y * W)];
      std::vector<uint8_t> row((size_t)(2 * dw));
      row[0] = (uint8_t)in(y, 0);
      row[1] = (uint8_t)((in(y, 0) * 3 + in(y, 1) + 2) >> 2);
      for (int64_t x = 1; x < dw - 1; ++x) {
        const int v3 = in(y, x) * 3;
        row[(size_t)(2 * x)] = (uint8_t)((v3 + in(y, x - 1) + 1) >> 2);
        row[(size_t)(2 * x + 1)] = (uint8_t)((v3 + in(y, x + 1) + 2) >> 2);
      }
      row[(size_t)(2 * dw - 2)] = (uint8_t)((in(y, dw - 1) * 3 + in(y, dw - 2) + 1) >> 2);
      row[(size_t)(2 * dw - 1)] = (uint8_t)in(y, dw - 1);
      std::memcpy(o, row.data(), W);
    }
  } else if (c.h == hmax_ && c.v * 2 == vmax_ && fancy) {
    for (int64_t y = 0; y < H; ++y) {
      const int64_t i = y / 2;
      const int64_t j = row_at((y & 1) ? i + 1 : i - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int64_t x = 0; x < W; ++x)
        out[(size_t)(y * W + x)] = (uint8_t)((in(i, x) * 3 + in(j, x) + bias) >> 2);
    }
  } else if (c.h * 2 == hmax_ && c.v * 2 == vmax_ && fancy && dw > 2) {
    std::vector<int> colsum((size_t)dw);
    std::vector<uint8_t> row((size_t)(2 * dw));
    for (int64_t y = 0; y < H; ++y) {
      const int64_t i = y / 2;
      const int64_t j = row_at((y & 1) ? i + 1 : i - 1);
      for (int64_t x = 0; x < dw; ++x) colsum[(size_t)x] = in(i, x) * 3 + in(j, x);
      int this_ = colsum[0], next = colsum[1], last;
      row[0] = (uint8_t)((this_ * 4 + 8) >> 4);
      row[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
      last = this_;
      this_ = next;
      for (int64_t x = 1; x < dw - 1; ++x) {
        next = colsum[(size_t)(x + 1)];
        row[(size_t)(2 * x)] = (uint8_t)((this_ * 3 + last + 8) >> 4);
        row[(size_t)(2 * x + 1)] = (uint8_t)((this_ * 3 + next + 7) >> 4);
        last = this_;
        this_ = next;
      }
      row[(size_t)(2 * dw - 2)] = (uint8_t)((this_ * 3 + last + 8) >> 4);
      row[(size_t)(2 * dw - 1)] = (uint8_t)((this_ * 4 + 7) >> 4);
      std::memcpy(&out[(size_t)(y * W)], row.data(), W);
    }
  } else if (hmax_ % c.h == 0 && vmax_ % c.v == 0) {
    const int he = hmax_ / c.h, ve = vmax_ / c.v;
    for (int64_t y = 0; y < H; ++y)
      for (int64_t x = 0; x < W; ++x) out[(size_t)(y * W + x)] = (uint8_t)in(y / ve, x / he);
  } else {
    fail("unsupported JPEG format: a component sampled %dx%d in a %dx%d frame (a fractional "
         "upsampling ratio)", c.h, c.v, hmax_, vmax_);
  }
  return out;
}

std::vector<uint8_t> Decoder::run(int64_t* height, int64_t* width) {
  // jpeg_read_header: markers up to the first SOS
  if (read_markers() != SOS) {
    if (saw_sof_) fail("truncated or corrupt JPEG (no scan after the frame header)");
    fail("truncated or corrupt JPEG (no image before the end of the data)");
  }
  while (ncur_ == 0) {  // a pseudo SOS marker
    initial_setup();
    if (read_markers() != SOS) fail("truncated or corrupt JPEG (no scan)");
  }
  initial_setup();
  // default_decompress_parms (jdapimin.c) and cv2's choice of output
  const int n = (int)comps_.size();
  enum Space { GRAY, YCC, RGB, CMYK, YCCK, UNKNOWN } space = UNKNOWN;
  if (n == 1) {
    space = GRAY;
  } else if (n == 3) {
    if (jfif_)
      space = YCC;
    else if (adobe_)
      space = adobe_transform_ == 0 ? RGB : YCC;
    else if (comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66)
      space = RGB;
    else
      space = YCC;
  } else if (n == 4) {
    space = adobe_ ? (adobe_transform_ == 0 ? CMYK : YCCK) : CMYK;
  }
  const char* kind = lossless_ ? (arith_ ? "arithmetic-coded lossless" : "lossless")
                     : progressive_ ? (arith_ ? "arithmetic-coded progressive" : "progressive")
                     : arith_ ? "arithmetic-coded sequential"
                     : sof_ == SOF0 ? "baseline" : "extended sequential";
  if (space == UNKNOWN) fail("unsupported JPEG format: %d components", n);
  if (!lossless_ && precision_ == 12) fail("unsupported JPEG format: 12-bit samples (%s)", kind);
  if (lossless_ && precision_ > 8)
    fail("unsupported JPEG format: %d-bit samples (%s)", precision_, kind);
  if (lossless_ && arith_) fail("unsupported JPEG format: arithmetic-coded lossless");
  for (Comp& c : comps_) c.needed = !(space == YCC && c.index > 0);
  for (Comp& c : comps_) {
    if (!c.needed) continue;
    // jinit_upsampler's refusal, before any data is read
    const bool ok = (c.h == hmax_ && c.v == vmax_) || (hmax_ % c.h == 0 && vmax_ % c.v == 0);
    if (!ok)
      fail("unsupported JPEG format: a component sampled %dx%d in a %dx%d frame (a fractional "
           "upsampling ratio)", c.h, c.v, hmax_, vmax_);
  }
  for (Comp& c : comps_) {
    if (lossless_)
      c.samp.assign((size_t)(c.bw * c.bh), 0);
    else
      c.coef.assign((size_t)(c.bw * c.bh * 64), 0);
  }
  // the scans: one, or (several scans) every scan up to EOI
  for (;;) {
    decode_scan();
    if (!multiple_scans_) break;
    int m;
    for (;;) {
      m = read_markers();
      if (m == SOS && ncur_ == 0) continue;  // a pseudo SOS marker
      break;
    }
    if (m == EOI) break;
  }
  // output
  std::vector<std::vector<uint8_t>> full(n);
  for (Comp& c : comps_)
    if (c.needed) full[c.index] = upsample(c, plane(c));
  const int64_t npx = width_ * height_;
  std::vector<uint8_t> gray((size_t)npx);
  if (space == GRAY || space == YCC) {
    gray = std::move(full[0]);
  } else if (space == RGB) {
    for (int64_t i = 0; i < npx; ++i)
      gray[(size_t)i] = (uint8_t)((19595 * full[0][(size_t)i] + 38470 * full[1][(size_t)i] +
                                   7471 * full[2][(size_t)i] + 32768) >> 16);
  } else {
    // YCCK -> CMYK (jdcolor.c's ycck_cmyk_convert), then OpenCV's
    // icvCvt_CMYK2Gray_8u_C4C1R
    int crr[256], cbb[256];
    int64_t crg[256], cbg[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      crr[i] = (int)((91881 * (int64_t)x + 32768) >> 16);
      cbb[i] = (int)((116130 * (int64_t)x + 32768) >> 16);
      crg[i] = -46802 * (int64_t)x;
      cbg[i] = -22554 * (int64_t)x + 32768;
    }
    auto clamp = [](int v) { return v < 0 ? 0 : v > 255 ? 255 : v; };
    for (int64_t i = 0; i < npx; ++i) {
      int c = full[0][(size_t)i], m = full[1][(size_t)i], y = full[2][(size_t)i];
      const int k = full[3][(size_t)i];
      if (space == YCCK) {
        const int yy = c, cb = m, cr = y;
        c = clamp(255 - (yy + crr[cr]));
        m = clamp(255 - (yy + (int)((cbg[cb] + crg[cr]) >> 16)));
        y = clamp(255 - (yy + cbb[cb]));
      }
      c = k - ((255 - c) * k >> 8);
      m = k - ((255 - m) * k >> 8);
      y = k - ((255 - y) * k >> 8);
      gray[(size_t)i] = (uint8_t)((y * 1868 + m * 9617 + c * 4899 + (1 << 13)) >> 14);
    }
  }
  *height = height_;
  *width = width_;
  return gray;
}

}  // namespace

extern "C" {

// Decode the JPEG file in data[0:n] to gray.  On success returns a malloc'd
// buffer of *height x *width bytes (free it with `xfm_free`); on failure
// returns null with a message in err.
uint8_t* jpeg_decode_gray(const uint8_t* data, int64_t n, int64_t* height, int64_t* width,
                          char* err, int64_t errlen) {
  try {
    Decoder dec(data, n);
    std::vector<uint8_t> gray = dec.run(height, width);
    uint8_t* out = (uint8_t*)std::malloc(gray.size() ? gray.size() : 1);
    if (!out) throw Failure{"out of memory"};
    std::memcpy(out, gray.data(), gray.size());
    return out;
  } catch (const Failure& f) {
    std::snprintf(err, (size_t)errlen, "%s", f.msg.c_str());
  } catch (const std::exception& e) {
    std::snprintf(err, (size_t)errlen, "corrupt JPEG (%s)", e.what());
  }
  return nullptr;
}

void xfm_free(void* p) { std::free(p); }

}  // extern "C"
