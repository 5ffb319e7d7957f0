/*!
 * jpeg_decode.cc — the port's JPEG decoder, with no libjpeg.
 *
 * Decodes 8-bit Huffman-coded JPEG (baseline and extended sequential,
 * SOF0/SOF1, and progressive, SOF2, with spectral selection and successive
 * approximation) with one component (gray, replicated to three planes) or
 * three (YCbCr, or RGB under an Adobe marker with transform 0), sampled
 * 4:4:4, 4:2:2, 4:2:0, 4:4:0 or 4:1:1, to float32 CHW RGB.
 *
 * Its arithmetic is libjpeg-turbo's with its decompression defaults, so
 * the pixels are bit for bit what libjpeg-turbo gives: the islow inverse
 * DCT (jidctint.c, 13-bit fixed point) as its x86 SIMD build computes it,
 * "fancy" triangle upsampling (jdsample.c h2v1 / h1v2 / h2v2, box
 * replication for 4:1:1 and for chroma 2 samples wide or less) with the
 * edge samples replicated, and ycc_rgb_convert's fixed-point tables
 * (jdcolor.c).
 * Entropy data that ends early (at the end of the buffer or at a marker)
 * is treated as libjpeg treats it: the bits run on as zeros through the
 * block being decoded, the later blocks of the restart interval keep zero
 * coefficients, and the call returns an image.
 *
 * Other forms return a CXN_REFUSED_* code so the caller can use another
 * decoder: arithmetic coding, precisions other than 8 bits, lossless and
 * hierarchical frames, four components, other sampling layouts, and a
 * progressive stream cut before its last refinement scan (where libjpeg
 * smooths the blocks of the coarse coefficients). EXIF orientation is not
 * applied.
 */
#include "cxn_host.h"

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag position -> natural position, with libjpeg's 16 guard entries for
// corrupt runs past the end of a block
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the tables of ITU T.81 Annex K.3 that libjpeg-turbo installs when a
// stream defines no Huffman table in slots 0 and 1 (motion JPEG)
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

enum {
  M_SOF0 = 0xc0, M_SOF1 = 0xc1, M_SOF2 = 0xc2, M_SOF3 = 0xc3, M_DHT = 0xc4,
  M_SOF5 = 0xc5, M_SOF6 = 0xc6, M_SOF7 = 0xc7, M_JPG = 0xc8, M_SOF9 = 0xc9,
  M_SOF10 = 0xca, M_SOF11 = 0xcb, M_DAC = 0xcc, M_SOF13 = 0xcd,
  M_SOF14 = 0xce, M_SOF15 = 0xcf, M_RST0 = 0xd0, M_RST7 = 0xd7,
  M_SOI = 0xd8, M_EOI = 0xd9, M_SOS = 0xda, M_DQT = 0xdb, M_DNL = 0xdc,
  M_DRI = 0xdd, M_APP0 = 0xe0, M_APP14 = 0xee, M_APP15 = 0xef,
  M_COM = 0xfe, M_TEM = 0x01
};

// a decode ends by throwing one of these
struct Fail {
  int code;
  std::string what;
};

[[noreturn]] void fail(int code, const std::string &what) {
  throw Fail{code, what};
}

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  // derived (jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  // 8-bit lookahead: (length << 8) | symbol, length 0 = longer code
  uint16_t look[256];

  void set(const uint8_t *b, const uint8_t *v, int nv) {
    present = true;
    std::memcpy(bits, b, 17);
    std::memset(vals, 0, sizeof(vals));
    std::memcpy(vals, v, nv);
  }

  void derive(bool is_dc) {
    char huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int i = bits[l];
      if (p + i > 256) fail(CXN_CORRUPT, "bad Huffman table");
      while (i--) huffsize[p++] = char(l);
    }
    huffsize[p] = 0;
    int numsymbols = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (int(huffsize[p]) == si) {
        huffcode[p++] = code;
        code++;
      }
      if (int64_t(code) >= (int64_t(1) << si))
        fail(CXN_CORRUPT, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - int32_t(huffcode[p]);
        p += bits[l];
        maxcode[l] = int32_t(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        int lookbits = int(huffcode[p]) << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; --ctr)
          look[lookbits++] = uint16_t((l << 8) | vals[p]);
      }
    }
    if (is_dc) {
      for (int i = 0; i < numsymbols; ++i)
        if (vals[i] > 15) fail(CXN_CORRUPT, "bad Huffman table");
    }
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width_in_blocks = 0, height_in_blocks = 0;
  int blocks_w = 0, blocks_h = 0;     // padded to whole MCUs
  int dw = 0, dh = 0;                 // downsampled_width / _height
  std::vector<int16_t> coef;          // blocks_h * blocks_w * 64
  int coef_bits[64];
  bool quant_latched = false;
  int16_t quant[64];                  // ISLOW_MULT_TYPE (short)
  int16_t *block(int by, int bx) {
    return coef.data() + (int64_t(by) * blocks_w + bx) * 64;
  }
};

class Decoder {
 public:
  Decoder(const uint8_t *buf, int64_t size) : buf_(buf), size_(size) {}

  void read_header() {
    if (byte() != 0xFF || byte() != M_SOI)
      fail(CXN_CORRUPT, "not a JPEG stream (no SOI)");
    for (;;) {
      int m = next_marker();
      if (handle_table_marker(m)) continue;
      if (is_sof(m)) {
        read_sof(m);
        return;
      }
      if (m == M_SOS) fail(CXN_CORRUPT, "SOS before SOF");
      if (m == M_EOI) fail(CXN_CORRUPT, "no image in the stream (EOI "
                                        "before SOF)");
      fail(CXN_CORRUPT, "unknown marker 0x" + hex(m));
    }
  }

  int height() const { return height_; }
  int width() const { return width_; }

  void decode(float *out) {
    check_layout();
    bool started = false;
    int m = 0;
    for (;;) {
      if (m == 0) m = next_marker();
      if (m == M_EOI) {
        if (!started) fail(CXN_CORRUPT, "no image in the stream (EOI "
                                        "before SOS)");
        break;
      }
      if (m == M_SOS) {
        if (!started) {
          install_std_tables();
          started = true;
        }
        read_sos();
        decode_scan();
        m = unread_marker_;
        unread_marker_ = 0;
        continue;
      }
      if (handle_table_marker(m)) {
        m = 0;
        continue;
      }
      if (is_sof(m)) fail(CXN_CORRUPT, "a second SOF marker");
      fail(CXN_CORRUPT, "unknown marker 0x" + hex(m));
    }
    if (progressive_ && needs_smoothing())
      fail(CXN_REFUSED_SMOOTHING,
           "progressive JPEG that ends before its last refinement scan "
           "(libjpeg smooths its blocks)");
    output(out);
  }

 private:
  // ---------------------------------------------------------- bytes
  // Reading past the end yields FF D9 FF D9 ...: the fake EOI that
  // libjpeg's memory source inserts at the end of its buffer.
  int byte() {
    int64_t p = pos_++;
    if (p < size_) return buf_[p];
    if (p - size_ > (int64_t(1) << 20))
      fail(CXN_CORRUPT, "runs past the end of the stream");
    return ((p - size_) & 1) ? M_EOI : 0xFF;
  }

  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c next_marker: skip to an FF, swallow fill FFs and stuffed
  // FF 00 pairs
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  static std::string hex(int v) {
    char b[8];
    std::snprintf(b, sizeof(b), "%02x", v & 0xff);
    return b;
  }

  static bool is_sof(int m) {
    return m >= M_SOF0 && m <= M_SOF15 && m != M_DHT && m != M_JPG &&
           m != M_DAC;
  }

  // DHT, DQT, DRI, APPn, COM, DAC, stray RSTn / TEM: true if handled
  bool handle_table_marker(int m) {
    if (m == M_DHT) {
      read_dht();
    } else if (m == M_DQT) {
      read_dqt();
    } else if (m == M_DRI) {
      if (word() != 4) fail(CXN_CORRUPT, "bad DRI length");
      restart_interval_ = word();
    } else if (m >= M_APP0 && m <= M_APP15) {
      read_app(m);
    } else if (m == M_COM || m == M_DAC) {
      skip_segment();
    } else if ((m >= M_RST0 && m <= M_RST7) || m == M_TEM) {
      // parameterless, ignored
    } else {
      return false;
    }
    return true;
  }

  void skip_segment() {
    int len = word() - 2;
    if (len < 0) fail(CXN_CORRUPT, "bad marker length");
    pos_ += len;
  }

  void read_app(int m) {
    int len = word() - 2;
    if (len < 0) fail(CXN_CORRUPT, "bad marker length");
    int64_t start = pos_;
    uint8_t d[14];
    int n = len < 14 ? len : 14;
    for (int i = 0; i < n; ++i) d[i] = uint8_t(byte());
    if (m == M_APP0 && len >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) {
      saw_jfif_ = true;
    } else if (m == M_APP14 && len >= 12 &&
               std::memcmp(d, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = d[11];
    }
    pos_ = start + len;
  }

  void read_dqt() {
    int length = word() - 2;
    while (length > 0) {
      length--;
      int n = byte();
      int prec = n >> 4;
      n &= 0x0F;
      if (n >= 4) fail(CXN_CORRUPT, "bad DQT table index");
      int need = prec ? 128 : 64;
      if (length < need) fail(CXN_CORRUPT, "short quantization table");
      for (int i = 0; i < 64; ++i) {
        int v = prec ? word() : byte();
        qt_[n][kNaturalOrder[i]] = uint16_t(v);
      }
      qt_present_[n] = true;
      length -= need;
    }
    if (length != 0) fail(CXN_CORRUPT, "bad DQT length");
  }

  void read_dht() {
    int length = word() - 2;
    while (length > 16) {
      int index = byte();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = uint8_t(byte());
        count += bits[i];
      }
      length -= 1 + 16;
      if (count > 256 || count > length)
        fail(CXN_CORRUPT, "bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < count; ++i) vals[i] = uint8_t(byte());
      length -= count;
      bool ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index >= 4) fail(CXN_CORRUPT, "bad DHT index");
      (ac ? ac_[index] : dc_[index]).set(bits, vals, count);
    }
    if (length != 0) fail(CXN_CORRUPT, "bad DHT length");
  }

  void install_std_tables() {
    if (!dc_[0].present) dc_[0].set(kDcLumBits, kDcVals, 12);
    if (!ac_[0].present) ac_[0].set(kAcLumBits, kAcLumVals, 162);
    if (!dc_[1].present) dc_[1].set(kDcChromBits, kDcVals, 12);
    if (!ac_[1].present) ac_[1].set(kAcChromBits, kAcChromVals, 162);
  }

  void read_sof(int m) {
    if (m == M_SOF9 || m == M_SOF10 || m == M_SOF11)
      fail(CXN_REFUSED_ARITHMETIC, "arithmetic-coded JPEG");
    if (m == M_SOF3 || m == M_SOF5 || m == M_SOF6 || m == M_SOF7 ||
        m == M_SOF13 || m == M_SOF14 || m == M_SOF15)
      fail(CXN_REFUSED_LOSSLESS, "lossless or hierarchical JPEG");
    progressive_ = (m == M_SOF2);
    int length = word() - 2;
    int precision = byte();
    height_ = word();
    width_ = word();
    ncomp_ = byte();
    length -= 6;
    if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0)
      fail(CXN_CORRUPT, "empty image");
    if (length != ncomp_ * 3) fail(CXN_CORRUPT, "bad SOF length");
    if (precision != 8)
      fail(CXN_REFUSED_PRECISION,
           std::to_string(precision) + "-bit JPEG");
    if (ncomp_ > 10) fail(CXN_CORRUPT, "too many components");
    comps_.resize(ncomp_);
    for (auto &c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail(CXN_CORRUPT, "bad sampling factors");
      if (c.tq > 3) fail(CXN_CORRUPT, "bad quantization table index");
    }
  }

  // the forms this decoder implements; set up the coefficient planes
  void check_layout() {
    if (ncomp_ == 4)
      fail(CXN_REFUSED_CMYK, "four-component (CMYK/YCCK) JPEG");
    if (ncomp_ != 1 && ncomp_ != 3)
      fail(CXN_REFUSED_COMPONENTS,
           std::to_string(ncomp_) + "-component JPEG");
    hmax_ = vmax_ = 1;
    for (auto &c : comps_) {
      hmax_ = c.h > hmax_ ? c.h : hmax_;
      vmax_ = c.v > vmax_ ? c.v : vmax_;
    }
    for (auto &c : comps_) {
      int eh = hmax_ / c.h, ev = vmax_ / c.v;
      bool ok = hmax_ % c.h == 0 && vmax_ % c.v == 0 &&
                ((eh == 1 && ev == 1) || (eh == 2 && ev == 1) ||
                 (eh == 1 && ev == 2) || (eh == 2 && ev == 2) ||
                 (eh == 4 && ev == 1));
      if (!ok)
        fail(CXN_REFUSED_SAMPLING,
             "JPEG sampling layout other than 4:4:4, 4:2:2, 4:2:0, "
             "4:4:0 and 4:1:1");
    }
    mcus_x_ = ceil_div(width_, 8 * hmax_);
    mcus_y_ = ceil_div(height_, 8 * vmax_);
    for (auto &c : comps_) {
      c.width_in_blocks = int(ceil_div(int64_t(width_) * c.h, 8 * hmax_));
      c.height_in_blocks = int(ceil_div(int64_t(height_) * c.v, 8 * vmax_));
      c.dw = int(ceil_div(int64_t(width_) * c.h, hmax_));
      c.dh = int(ceil_div(int64_t(height_) * c.v, vmax_));
      c.blocks_w = mcus_x_ * c.h;
      c.blocks_h = mcus_y_ * c.v;
      c.coef.assign(int64_t(c.blocks_w) * c.blocks_h * 64, 0);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
      std::memset(c.quant, 0, sizeof(c.quant));
    }
  }

  static int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

  // ---------------------------------------------------------- scans
  void read_sos() {
    int length = word();
    int n = byte();
    if (length != n * 2 + 6 || n < 1 || n > 4)
      fail(CXN_CORRUPT, "bad SOS length");
    scan_.clear();
    for (int i = 0; i < n; ++i) {
      int cid = byte();
      int tables = byte();
      int ci = -1;
      for (int k = 0; k < ncomp_; ++k)
        if (comps_[k].id == cid) ci = k;
      if (ci < 0) fail(CXN_CORRUPT, "bad component id in SOS");
      for (auto &s : scan_)
        if (s.ci == ci) fail(CXN_CORRUPT, "component twice in one scan");
      scan_.push_back({ci, tables >> 4, tables & 15});
      if (scan_.back().td > 3 || scan_.back().ta > 3)
        fail(CXN_CORRUPT, "bad Huffman table index in SOS");
    }
    ss_ = byte();
    se_ = byte();
    int a = byte();
    ah_ = a >> 4;
    al_ = a & 15;
    next_restart_ = 0;
    if (progressive_) {
      bool dc = ss_ == 0;
      bool bad = false;
      if (dc) {
        if (se_ != 0) bad = true;
      } else {
        if (ss_ > se_ || se_ >= 64) bad = true;
        if (n != 1) bad = true;
      }
      if (ah_ != 0 && al_ != ah_ - 1) bad = true;
      if (al_ > 13) bad = true;
      if (bad) fail(CXN_CORRUPT, "bad progression parameters");
      for (auto &s : scan_) {
        Component &c = comps_[s.ci];
        for (int k = ss_; k <= se_; ++k) c.coef_bits[k] = al_;
      }
    }
    if (n > 1) {
      int blocks = 0;
      for (auto &s : scan_) blocks += comps_[s.ci].h * comps_[s.ci].v;
      if (blocks > 10) fail(CXN_CORRUPT, "MCU larger than 10 blocks");
    }
    // the quantization table a component uses is the one in effect at
    // the first scan that holds it (jdinput.c latch_quant_tables)
    for (auto &s : scan_) {
      Component &c = comps_[s.ci];
      if (c.quant_latched) continue;
      if (!qt_present_[c.tq]) fail(CXN_CORRUPT, "no quantization table");
      for (int k = 0; k < 64; ++k) c.quant[k] = int16_t(qt_[c.tq][k]);
      c.quant_latched = true;
    }
    // the tables this scan uses
    for (auto &s : scan_) {
      bool need_dc = !progressive_ || (ss_ == 0 && ah_ == 0);
      bool need_ac = !progressive_ || ss_ != 0;
      if (need_dc) {
        if (!dc_[s.td].present) fail(CXN_CORRUPT, "no Huffman table");
        dc_[s.td].derive(true);
      }
      if (need_ac) {
        if (!ac_[s.ta].present) fail(CXN_CORRUPT, "no Huffman table");
        ac_[s.ta].derive(false);
      }
    }
  }

  // bit reader state of the scan (jdhuff.c bitread_*)
  uint64_t acc_ = 0;
  int bits_left_ = 0;
  int unread_marker_ = 0;
  bool insufficient_ = false;
  static const int kMinGetBits = 57;

  void fill(int nbits) {
    if (unread_marker_ == 0) {
      while (bits_left_ < kMinGetBits) {
        int c = byte();
        if (c == 0xFF) {
          do {
            c = byte();
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker_ = c;
            break;
          }
        }
        acc_ = (acc_ << 8) | uint64_t(c);
        bits_left_ += 8;
      }
    }
    if (unread_marker_ != 0 && nbits > bits_left_) {
      // past the end of the segment: the data runs on as zeros
      insufficient_ = true;
      acc_ <<= kMinGetBits - bits_left_;
      bits_left_ = kMinGetBits;
    }
  }

  int get_bits(int n) {
    if (bits_left_ < n) fill(n);
    bits_left_ -= n;
    return int((acc_ >> bits_left_) & ((uint64_t(1) << n) - 1));
  }

  int decode_huff(const HuffTable &t) {
    if (bits_left_ < 8) fill(0);
    if (bits_left_ >= 8) {
      int e = t.look[(acc_ >> (bits_left_ - 8)) & 0xFF];
      if (e >> 8) {
        bits_left_ -= e >> 8;
        return e & 0xFF;
      }
    }
    int l = 1;
    int32_t code = get_bits(1);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      l++;
    }
    if (l > 16) return 0;  // bad code: libjpeg fakes a zero
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  }

  struct ScanComp {
    int ci, td, ta;
  };
  std::vector<ScanComp> scan_;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int last_dc_[4];
  int eobrun_ = 0;
  int restarts_to_go_ = 0;
  int next_restart_ = 0;

  // jdhuff.c process_restart + jdmarker.c read_restart_marker
  void process_restart() {
    bits_left_ = 0;
    acc_ = 0;
    if (unread_marker_ == 0) unread_marker_ = next_marker();
    if (unread_marker_ == M_RST0 + next_restart_) {
      unread_marker_ = 0;
    } else {
      resync_to_restart(next_restart_);
    }
    next_restart_ = (next_restart_ + 1) & 7;
    for (int i = 0; i < 4; ++i) last_dc_[i] = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (unread_marker_ == 0) insufficient_ = false;
  }

  // jdmarker.c jpeg_resync_to_restart
  void resync_to_restart(int desired) {
    int marker = unread_marker_;
    for (;;) {
      int action;
      if (marker < M_SOF0) {
        action = 2;
      } else if (marker < M_RST0 || marker > M_RST7) {
        action = 3;
      } else if (marker == M_RST0 + ((desired + 1) & 7) ||
                 marker == M_RST0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == M_RST0 + ((desired - 1) & 7) ||
                 marker == M_RST0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker_ = 0;
        return;
      }
      if (action == 3) return;
      marker = unread_marker_ = next_marker();
    }
  }

  void decode_scan() {
    acc_ = 0;
    bits_left_ = 0;
    unread_marker_ = 0;
    insufficient_ = false;
    eobrun_ = 0;
    for (int i = 0; i < 4; ++i) last_dc_[i] = 0;
    restarts_to_go_ = restart_interval_;
    if (scan_.size() == 1) {
      Component &c = comps_[scan_[0].ci];
      for (int by = 0; by < c.height_in_blocks; ++by)
        for (int bx = 0; bx < c.width_in_blocks; ++bx) {
          int16_t *blk = c.block(by, bx);
          decode_mcu(&blk, 1);
        }
    } else {
      int16_t *blocks[10];
      for (int my = 0; my < mcus_y_; ++my)
        for (int mx = 0; mx < mcus_x_; ++mx) {
          int n = 0;
          for (auto &s : scan_) {
            Component &c = comps_[s.ci];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x)
                blocks[n++] = c.block(my * c.v + y, mx * c.h + x);
          }
          decode_mcu(blocks, n);
        }
    }
    // the next marker: the one the entropy decoder ran into, or the first
    // after the bytes it read
    if (unread_marker_ == 0) unread_marker_ = next_marker();
  }

  int member(int blkn) const {
    // the scan component of block blkn of an MCU
    if (scan_.size() == 1) return 0;
    int n = 0;
    for (size_t i = 0; i < scan_.size(); ++i) {
      const Component &c = comps_[scan_[i].ci];
      n += c.h * c.v;
      if (blkn < n) return int(i);
    }
    return 0;
  }

  void decode_mcu(int16_t **blocks, int n) {
    if (restart_interval_) {
      if (restarts_to_go_ == 0) process_restart();
    }
    if (!progressive_) {
      if (!insufficient_) {
        for (int b = 0; b < n; ++b) decode_block_sequential(blocks[b],
                                                            member(b));
      }
    } else if (ss_ == 0 && ah_ == 0) {
      if (!insufficient_) {
        for (int b = 0; b < n; ++b) {
          int si = member(b);
          const HuffTable &t = dc_[scan_[si].td];
          int s = decode_huff(t);
          if (s) s = extend(get_bits(s), s);
          s += last_dc_[si];
          last_dc_[si] = s;
          blocks[b][0] = int16_t(uint32_t(s) << al_);
        }
      }
    } else if (ss_ == 0) {
      // DC refinement: not worth checking insufficient_ (zeros change
      // nothing)
      int p1 = 1 << al_;
      for (int b = 0; b < n; ++b)
        if (get_bits(1)) blocks[b][0] = int16_t(blocks[b][0] | p1);
    } else if (ah_ == 0) {
      if (!insufficient_) decode_ac_first(blocks[0], ac_[scan_[0].ta]);
    } else {
      if (!insufficient_) decode_ac_refine(blocks[0], ac_[scan_[0].ta]);
    }
    restarts_to_go_--;
  }

  void decode_block_sequential(int16_t *blk, int si) {
    const HuffTable &dct = dc_[scan_[si].td];
    const HuffTable &act = ac_[scan_[si].ta];
    int s = decode_huff(dct);
    if (s) s = extend(get_bits(s), s);
    s += last_dc_[si];
    last_dc_[si] = s;
    blk[0] = int16_t(s);
    for (int k = 1; k < 64; ++k) {
      int rs = decode_huff(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(get_bits(s), s);
        blk[kNaturalOrder[k]] = int16_t(v);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_ac_first(int16_t *blk, const HuffTable &t) {
    if (eobrun_ > 0) {
      eobrun_--;
      return;
    }
    for (int k = ss_; k <= se_; ++k) {
      int rs = decode_huff(t);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        k += r;
        int v = extend(get_bits(s), s);
        blk[kNaturalOrder[k]] = int16_t(uint32_t(v) << al_);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          eobrun_--;
          break;
        }
      }
    }
  }

  void refine(int16_t *coef, int p1, int m1) {
    if (get_bits(1)) {
      if ((*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1
                                                        : *coef + m1);
    }
  }

  // jdphuff.c decode_mcu_AC_refine
  void decode_ac_refine(int16_t *blk, const HuffTable &t) {
    int p1 = 1 << al_;
    int m1 = -1 * (1 << al_);
    int k = ss_;
    if (eobrun_ == 0) {
      for (; k <= se_; k++) {
        int rs = decode_huff(t);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t *c = blk + kNaturalOrder[k];
          if (*c != 0) {
            refine(c, p1, m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se_);
        if (s) blk[kNaturalOrder[k]] = int16_t(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; k++) {
        int16_t *c = blk + kNaturalOrder[k];
        if (*c != 0) refine(c, p1, m1);
      }
      eobrun_--;
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths the output of a progressive
  // stream whose AC coefficients 1..9 are not all complete
  bool needs_smoothing() const {
    bool useful = false;
    for (const auto &c : comps_) {
      if (!c.quant_latched || c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // ---------------------------------------------------------- output
  // jidctint.c jpeg_idct_islow as libjpeg-turbo's x86 SIMD build runs it
  // (jsimd_idct_islow_sse2 / _avx2), into 8 rows of `stride` at out. For
  // coefficients of a well-formed stream this is the C function's result;
  // for the out-of-range values a damaged stream can give, it keeps the
  // SIMD code's 16-bit arithmetic: dequantization and the sums of two
  // inputs wrap to 16 bits, each pass's output saturates to 16 bits, and
  // the samples saturate to -128..127 before the 128 level shift (where the
  // C code masks into its range-limit table).
  static int16_t wrap16(int32_t v) { return int16_t(uint16_t(uint32_t(v))); }
  static int16_t sat16(int32_t v) {
    return int16_t(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
  }
  static int32_t add32(int32_t a, int32_t b) {
    return int32_t(uint32_t(a) + uint32_t(b));
  }
  static int32_t sub32(int32_t a, int32_t b) {
    return int32_t(uint32_t(a) - uint32_t(b));
  }
  // pmaddwd: a*c + b*d with 16-bit inputs, summed in 32 bits
  static int32_t madd(int16_t a, int32_t c, int16_t b, int32_t d) {
    return int32_t(uint32_t(int32_t(a) * c) + uint32_t(int32_t(b) * d));
  }

  // one 8-point pass over d[0..7] (stride-free), descaled by `shift`
  static void idct8(const int16_t *d, int shift, int32_t *o) {
    const int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    const int CONST_BITS = 13;
    // even part
    int32_t tmp3 = madd(d[2], F0541 + F0765, d[6], F0541);
    int32_t tmp2 = madd(d[2], F0541, d[6], F0541 - F1847);
    int32_t tmp0 = int32_t(uint32_t(int32_t(wrap16(d[0] + d[4])))
                           << CONST_BITS);
    int32_t tmp1 = int32_t(uint32_t(int32_t(wrap16(d[0] - d[4])))
                           << CONST_BITS);
    int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
    int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
    // odd part
    int16_t z3 = wrap16(d[7] + d[3]), z4 = wrap16(d[5] + d[1]);
    int32_t z3p = madd(z3, F1175 - F1961, z4, F1175);
    int32_t z4p = madd(z3, F1175, z4, F1175 - F0390);
    int32_t o0 = add32(madd(d[7], F0298 - F0899, d[1], -F0899), z3p);
    int32_t o3 = add32(madd(d[7], -F0899, d[1], F1501 - F0899), z4p);
    int32_t o1 = add32(madd(d[5], F2053 - F2562, d[3], -F2562), z4p);
    int32_t o2 = add32(madd(d[5], -F2562, d[3], F3072 - F2562), z3p);
    const int32_t rnd = int32_t(1) << (shift - 1);
    o[0] = add32(add32(tmp10, o3), rnd) >> shift;
    o[7] = add32(sub32(tmp10, o3), rnd) >> shift;
    o[1] = add32(add32(tmp11, o2), rnd) >> shift;
    o[6] = add32(sub32(tmp11, o2), rnd) >> shift;
    o[2] = add32(add32(tmp12, o1), rnd) >> shift;
    o[5] = add32(sub32(tmp12, o1), rnd) >> shift;
    o[3] = add32(add32(tmp13, o0), rnd) >> shift;
    o[4] = add32(sub32(tmp13, o0), rnd) >> shift;
  }

  static void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out,
                         int64_t stride) {
    const int PASS1_BITS = 2, CONST_BITS = 13;
    int16_t ws[64];
    bool ac_zero = true;
    for (int k = 8; k < 64 && ac_zero; ++k) ac_zero = in[k] == 0;
    if (ac_zero) {
      for (int col = 0; col < 8; ++col) {
        int16_t dc = wrap16(int32_t(wrap16(int32_t(in[col]) * q[col]))
                            << PASS1_BITS);
        for (int r = 0; r < 8; ++r) ws[8 * r + col] = dc;
      }
    } else {
      for (int col = 0; col < 8; ++col) {
        int16_t d[8];
        for (int r = 0; r < 8; ++r)
          d[r] = wrap16(int32_t(in[8 * r + col]) * q[8 * r + col]);
        int32_t o[8];
        idct8(d, CONST_BITS - PASS1_BITS, o);
        for (int r = 0; r < 8; ++r) ws[8 * r + col] = sat16(o[r]);
      }
    }
    for (int row = 0; row < 8; ++row) {
      int32_t o[8];
      idct8(ws + 8 * row, CONST_BITS + PASS1_BITS + 3, o);
      uint8_t *op = out + row * stride;
      for (int i = 0; i < 8; ++i) {
        int32_t v = sat16(o[i]);
        v = v < -128 ? -128 : (v > 127 ? 127 : v);
        op[i] = uint8_t(v + 128);
      }
    }
  }

  // one component at full resolution (height_ x width_), upsampled as
  // jdsample.c does with do_fancy_upsampling
  std::vector<uint8_t> component_plane(Component &c) {
    const int64_t bw = int64_t(c.width_in_blocks) * 8;
    const int64_t bh = int64_t(c.height_in_blocks) * 8;
    std::vector<uint8_t> ds(bw * bh);
    for (int by = 0; by < c.height_in_blocks; ++by)
      for (int bx = 0; bx < c.width_in_blocks; ++bx)
        idct_islow(c.block(by, bx), c.quant,
                   ds.data() + int64_t(by) * 8 * bw + int64_t(bx) * 8, bw);
    const int eh = hmax_ / c.h, ev = vmax_ / c.v;
    const int64_t W = width_, H = height_;
    if (eh == 1 && ev == 1) {
      if (bw == W) {
        ds.resize(W * H);
        return ds;
      }
      std::vector<uint8_t> out(W * H);
      for (int64_t y = 0; y < H; ++y)
        std::memcpy(&out[y * W], &ds[y * bw], W);
      return out;
    }
    const int dw = c.dw, dh = c.dh;
    // the context rows: above row 0 is row 0, below the last real row is
    // that row (jdmainct.c set_bottom_pointers)
    auto row = [&](int64_t r) -> const uint8_t * {
      if (r < 0) r = 0;
      if (r > dh - 1) r = dh - 1;
      return &ds[r * bw];
    };
    // up to 4 output samples past W for odd widths
    std::vector<uint8_t> out(W * H + 8);
    std::vector<uint8_t> line(size_t(dw) * eh + 8);
    for (int64_t y = 0; y < H; ++y) {
      uint8_t *op = &out[y * W];
      if (eh == 4 || (ev == 1 && eh == 2 && dw <= 2) ||
          (ev == 2 && eh == 2 && dw <= 2)) {
        // int_upsample / h2v1_upsample / h2v2_upsample: replication
        const uint8_t *ip = row(y / ev);
        for (int64_t x = 0; x < W; ++x) op[x] = ip[x / eh];
        continue;
      }
      if (ev == 1) {
        // h2v1_fancy_upsample
        const uint8_t *ip = row(y);
        uint8_t *o = line.data();
        int inv = ip[0];
        *o++ = uint8_t(inv);
        *o++ = uint8_t((inv * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          inv = ip[x] * 3;
          *o++ = uint8_t((inv + ip[x - 1] + 1) >> 2);
          *o++ = uint8_t((inv + ip[x + 1] + 2) >> 2);
        }
        inv = ip[dw - 1];
        *o++ = uint8_t((inv * 3 + ip[dw - 2] + 1) >> 2);
        *o++ = uint8_t(inv);
        std::memcpy(op, line.data(), W);
        continue;
      }
      // ev == 2: the nearer row and the next nearer, above for even
      // output rows, below for odd ones
      const int64_t ir = y / 2;
      const bool below = y & 1;
      const uint8_t *ip0 = row(ir);
      const uint8_t *ip1 = row(below ? ir + 1 : ir - 1);
      if (eh == 1) {
        // h1v2_fancy_upsample
        const int bias = below ? 2 : 1;
        for (int64_t x = 0; x < W; ++x)
          op[x] = uint8_t((ip0[x] * 3 + ip1[x] + bias) >> 2);
        continue;
      }
      // h2v2_fancy_upsample
      uint8_t *o = line.data();
      int thiscol = ip0[0] * 3 + ip1[0];
      int nextcol = ip0[1] * 3 + ip1[1];
      *o++ = uint8_t((thiscol * 4 + 8) >> 4);
      *o++ = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 2; x < dw; ++x) {
        nextcol = ip0[x] * 3 + ip1[x];
        *o++ = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *o++ = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = uint8_t((thiscol * 4 + 7) >> 4);
      std::memcpy(op, line.data(), W);
    }
    out.resize(W * H);
    return out;
  }

  void output(float *out) {
    const int64_t plane = int64_t(width_) * height_;
    if (ncomp_ == 1) {
      std::vector<uint8_t> g = component_plane(comps_[0]);
      for (int64_t i = 0; i < plane; ++i) {
        float v = float(g[i]);
        out[i] = v;
        out[plane + i] = v;
        out[2 * plane + i] = v;
      }
      return;
    }
    std::vector<uint8_t> p0 = component_plane(comps_[0]);
    std::vector<uint8_t> p1 = component_plane(comps_[1]);
    std::vector<uint8_t> p2 = component_plane(comps_[2]);
    bool rgb = false;
    if (saw_jfif_) {
      rgb = false;
    } else if (saw_adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    }
    if (rgb) {
      for (int64_t i = 0; i < plane; ++i) {
        out[i] = float(p0[i]);
        out[plane + i] = float(p1[i]);
        out[2 * plane + i] = float(p2[i]);
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) {
      return int64_t(x * double(int64_t(1) << 16) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); };
    for (int64_t i = 0; i < plane; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[i] = float(clamp(y + cr_r[cr]));
      out[plane + i] =
          float(clamp(y + int((cb_g[cb] + cr_g[cr]) >> SCALEBITS)));
      out[2 * plane + i] = float(clamp(y + cb_b[cb]));
    }
  }

  const uint8_t *buf_;
  int64_t size_;
  int64_t pos_ = 0;

  uint16_t qt_[4][64];
  bool qt_present_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;

  bool progressive_ = false;
  int height_ = 0, width_ = 0, ncomp_ = 0;
  int hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  std::vector<Component> comps_;
};

void put_msg(char *msg, int64_t len, const std::string &what) {
  if (msg == nullptr || len <= 0) return;
  std::snprintf(msg, size_t(len), "%s", what.c_str());
}

}  // namespace

extern "C" int cxn_jpeg_dims(const uint8_t *buf, int64_t size, int64_t *h,
                             int64_t *w, char *msg, int64_t msg_len) {
  try {
    Decoder d(buf, size);
    d.read_header();
    *h = d.height();
    *w = d.width();
    return CXN_OK;
  } catch (const Fail &f) {
    put_msg(msg, msg_len, f.what);
    return f.code;
  } catch (const std::exception &e) {
    put_msg(msg, msg_len, e.what());
    return CXN_CORRUPT;
  }
}

extern "C" int cxn_jpeg_decode_f32(const uint8_t *buf, int64_t size,
                                   float *out, int64_t h, int64_t w,
                                   char *msg, int64_t msg_len) {
  try {
    Decoder d(buf, size);
    d.read_header();
    if (d.height() != h || d.width() != w) {
      put_msg(msg, msg_len, "dimensions differ from the header's");
      return CXN_CORRUPT;
    }
    d.decode(out);
    return CXN_OK;
  } catch (const Fail &f) {
    put_msg(msg, msg_len, f.what);
    return f.code;
  } catch (const std::exception &e) {
    put_msg(msg, msg_len, e.what());
    return CXN_CORRUPT;
  }
}
