// Coefficient extractor: the host half of device-side JPEG decode, written
// without libjpeg.
//
// Counterpart of the JAX package's `native/ldt_decode.cpp` ABI v3
// (`probe_one`, `extract_one`, `ldt_probe_batch`, `ldt_extract_coeffs`),
// which calls libjpeg's `jpeg_read_header` / `jpeg_read_coefficients`. This
// file parses the markers and runs the Huffman decode itself, so it builds
// with a C++ compiler alone (no libjpeg headers or library):
//
//   g++ -O3 -std=c++17 -shared -fPIC -pthread ldt_coeffs.cpp
//
// What it reproduces of libjpeg-turbo 2.1.5 (jdmarker.c, jdinput.c, jdhuff.c,
// jdphuff.c, jdarith.c, jaricom.c, jdcoefct.c), so that every page equals
// libjpeg's integers:
//   * markers SOI, APPn (JFIF in APP0, Adobe in APP14), DQT (8- and 16-bit),
//     SOF0/SOF1/SOF2/SOF9/SOF10 at 8-bit precision, DHT (the standard tables
//     stand in for a missing one, numbers 0 and 1), DAC (the arithmetic
//     conditioning tables, with SOI's defaults L = 0, U = 1, K = 5 and
//     get_dac's errors), SOS, DRI, RSTn, DNL, COM, EOI;
//   * baseline and progressive Huffman scans: DC prediction, AC runs and
//     EOB, spectral selection, successive approximation with EOBRUN and the
//     refinement passes, interleaved MCUs (dummy blocks included in the DC
//     prediction) and single-component scans over the component's own
//     block grid, restart intervals with libjpeg's resynchronisation, 0xFF00
//     stuffing, and the out-of-range run lengths of corrupt data;
//   * sequential and progressive arithmetic-coded scans (jdarith.c): the
//     Qe state machine of Table D.2, the decoder's byte input that supplies
//     zero data once it meets a marker, the DC conditioning contexts and
//     the AC statistics split at K, the statistics and DC context reset at
//     each restart, and the "do nothing until the next restart" state after
//     a magnitude or spectral overflow;
//   * data that ends early: the source repeats a fake EOI, the bit reader
//     pads with zero bits, and the MCUs after the one that ran out stay zero;
//   * the colour space of `default_decompress_parms` and the quant table
//     latched at each component's first scan.
// SOF3, SOF5-7, SOF11, SOF13-15 and precisions other than 8 fail the probe,
// as in libjpeg-turbo 2.1.5.
//
// Canonical page layout (identical to the JAX extractor's):
//   coef_y  : int16 [n, yb_h, yb_w, 64]   natural-order blocks, zero-padded
//   coef_cb : int16 [n, cb_h, cb_w, 64]   (zeros for grayscale)
//   coef_cr : int16 [n, cb_h, cb_w, 64]
//   quant   : int32 [n, 3, 64]            per-component dequant tables
//   geom    : int32 [n, 6]                w, h, yb_w, yb_h, cb_w, cb_h
// Only grayscale and 3-component YCbCr 4:2:0 images are extracted; any
// other layout is flagged in failed[] before it is decoded.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

namespace {

// Zigzag position -> natural index, with 16 extra entries for the run
// lengths of corrupt data that step past the block (as jutils.c has).
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jaricom.c's jpeg_aritab (Table D.2): Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS. The last entry is the fixed 0.5
// estimate that the sign and refinement bits use.
constexpr uint32_t ari(uint32_t qe, uint32_t lps, uint32_t mps,
                       uint32_t sw) {
  return (qe << 16) | (mps << 8) | (sw << 7) | lps;
}
constexpr uint32_t kAriTab[114] = {
    ari(0x5a1d, 1, 1, 1),     ari(0x2586, 14, 2, 0),
    ari(0x1114, 16, 3, 0),    ari(0x080b, 18, 4, 0),
    ari(0x03d8, 20, 5, 0),    ari(0x01da, 23, 6, 0),
    ari(0x00e5, 25, 7, 0),    ari(0x006f, 28, 8, 0),
    ari(0x0036, 30, 9, 0),    ari(0x001a, 33, 10, 0),
    ari(0x000d, 35, 11, 0),   ari(0x0006, 9, 12, 0),
    ari(0x0003, 10, 13, 0),   ari(0x0001, 12, 13, 0),
    ari(0x5a7f, 15, 15, 1),   ari(0x3f25, 36, 16, 0),
    ari(0x2cf2, 38, 17, 0),   ari(0x207c, 39, 18, 0),
    ari(0x17b9, 40, 19, 0),   ari(0x1182, 42, 20, 0),
    ari(0x0cef, 43, 21, 0),   ari(0x09a1, 45, 22, 0),
    ari(0x072f, 46, 23, 0),   ari(0x055c, 48, 24, 0),
    ari(0x0406, 49, 25, 0),   ari(0x0303, 51, 26, 0),
    ari(0x0240, 52, 27, 0),   ari(0x01b1, 54, 28, 0),
    ari(0x0144, 56, 29, 0),   ari(0x00f5, 57, 30, 0),
    ari(0x00b7, 59, 31, 0),   ari(0x008a, 60, 32, 0),
    ari(0x0068, 62, 33, 0),   ari(0x004e, 63, 34, 0),
    ari(0x003b, 32, 35, 0),   ari(0x002c, 33, 9, 0),
    ari(0x5ae1, 37, 37, 1),   ari(0x484c, 64, 38, 0),
    ari(0x3a0d, 65, 39, 0),   ari(0x2ef1, 67, 40, 0),
    ari(0x261f, 68, 41, 0),   ari(0x1f33, 69, 42, 0),
    ari(0x19a8, 70, 43, 0),   ari(0x1518, 72, 44, 0),
    ari(0x1177, 73, 45, 0),   ari(0x0e74, 74, 46, 0),
    ari(0x0bfb, 75, 47, 0),   ari(0x09f8, 77, 48, 0),
    ari(0x0861, 78, 49, 0),   ari(0x0706, 79, 50, 0),
    ari(0x05cd, 48, 51, 0),   ari(0x04de, 50, 52, 0),
    ari(0x040f, 50, 53, 0),   ari(0x0363, 51, 54, 0),
    ari(0x02d4, 52, 55, 0),   ari(0x025c, 53, 56, 0),
    ari(0x01f8, 54, 57, 0),   ari(0x01a4, 55, 58, 0),
    ari(0x0160, 56, 59, 0),   ari(0x0125, 57, 60, 0),
    ari(0x00f6, 58, 61, 0),   ari(0x00cb, 59, 62, 0),
    ari(0x00ab, 61, 63, 0),   ari(0x008f, 61, 32, 0),
    ari(0x5b12, 65, 65, 1),   ari(0x4d04, 80, 66, 0),
    ari(0x412c, 81, 67, 0),   ari(0x37d8, 82, 68, 0),
    ari(0x2fe8, 83, 69, 0),   ari(0x293c, 84, 70, 0),
    ari(0x2379, 86, 71, 0),   ari(0x1edf, 87, 72, 0),
    ari(0x1aa9, 87, 73, 0),   ari(0x174e, 72, 74, 0),
    ari(0x1424, 72, 75, 0),   ari(0x119c, 74, 76, 0),
    ari(0x0f6b, 74, 77, 0),   ari(0x0d51, 75, 78, 0),
    ari(0x0bb6, 77, 79, 0),   ari(0x0a40, 77, 48, 0),
    ari(0x5832, 80, 81, 1),   ari(0x4d1c, 88, 82, 0),
    ari(0x438e, 89, 83, 0),   ari(0x3bdd, 90, 84, 0),
    ari(0x34ee, 91, 85, 0),   ari(0x2eae, 92, 86, 0),
    ari(0x299a, 93, 87, 0),   ari(0x2516, 86, 71, 0),
    ari(0x5570, 88, 89, 1),   ari(0x4ca9, 95, 90, 0),
    ari(0x44d9, 96, 91, 0),   ari(0x3e22, 97, 92, 0),
    ari(0x3824, 99, 93, 0),   ari(0x32b4, 99, 94, 0),
    ari(0x2e17, 93, 86, 0),   ari(0x56a8, 95, 96, 1),
    ari(0x4f46, 101, 97, 0),  ari(0x47e5, 102, 98, 0),
    ari(0x41cf, 103, 99, 0),  ari(0x3c3d, 104, 100, 0),
    ari(0x375e, 99, 93, 0),   ari(0x5231, 105, 102, 0),
    ari(0x4c0f, 106, 103, 0), ari(0x4639, 107, 104, 0),
    ari(0x415e, 103, 99, 0),  ari(0x5627, 105, 106, 1),
    ari(0x50e7, 108, 107, 0), ari(0x4b85, 109, 103, 0),
    ari(0x5597, 110, 109, 0), ari(0x504f, 111, 107, 0),
    ari(0x5a10, 110, 111, 1), ari(0x5522, 112, 109, 0),
    ari(0x59eb, 112, 111, 1), ari(0x5a1d, 113, 113, 0)};

constexpr int kNumArithTbls = 16;
constexpr int kDcStatBins = 64;
constexpr int kAcStatBins = 256;

// The standard tables of Annex K.3 (luminance 0, chrominance 1).
constexpr uint8_t kStdDcBits[2][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kStdAcBits[2][17] = {
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

constexpr int kMaxDimension = 65500;
constexpr int kMaxComponents = 10;
constexpr int kMaxCompsInScan = 4;
constexpr int kMaxBlocksInMcu = 10;

// A fatal error: what libjpeg reports through error_exit.
struct Fail {};

// The input bytes. Past the end it returns a fake EOI marker over and over,
// as libjpeg's memory source does.
struct Source {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  unsigned fake = 0;

  int byte() {
    if (pos < len) return data[pos++];
    return (fake++ & 1) ? 0xD9 : 0xFF;
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long n) {
    while (n-- > 0) byte();
  }
};

// libjpeg's next_marker: skip to the next 0xFF, then any fill 0xFFs; a
// stuffed 0xFF00 is data and is skipped too.
int next_marker(Source& src) {
  for (;;) {
    int c = src.byte();
    while (c != 0xFF) c = src.byte();
    do {
      c = src.byte();
    } while (c == 0xFF);
    if (c != 0) return c;
  }
}

struct HuffSpec {
  bool present = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];  // (length << 8) | symbol; length 9 = not in 8 bits
};

// jpeg_make_d_derived_tbl, with its checks.
void derive(const HuffSpec& spec, bool is_dc, int tblno, HuffTable* out) {
  if (tblno < 0 || tblno >= 4) throw Fail();
  HuffSpec std_spec;
  const HuffSpec* h = &spec;
  if (!spec.present) {
    if (tblno > 1) throw Fail();
    std_spec.present = true;
    if (is_dc) {
      std::memcpy(std_spec.bits, kStdDcBits[tblno], 17);
      for (int i = 0; i < 12; ++i) std_spec.vals[i] = static_cast<uint8_t>(i);
    } else {
      std::memcpy(std_spec.bits, kStdAcBits[tblno], 17);
      std::memcpy(std_spec.vals, kStdAcVals[tblno], 162);
    }
    h = &std_spec;
  }
  char huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = h->bits[l];
    if (p + i > 256) throw Fail();
    while (i--) huffsize[p++] = static_cast<char>(l);
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (static_cast<int64_t>(code) >= (int64_t{1} << si)) throw Fail();
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (h->bits[l]) {
      out->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += h->bits[l];
      out->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      out->maxcode[l] = -1;
    }
  }
  out->valoffset[17] = 0;
  out->maxcode[17] = 0xFFFFF;
  std::memcpy(out->vals, h->vals, 256);
  for (int i = 0; i < 256; ++i) out->look[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= h->bits[l]; ++i, ++p) {
      int lookbits = static_cast<int>(huffcode[p]) << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr)
        out->look[lookbits++] = static_cast<uint16_t>((l << 8) | h->vals[p]);
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; ++i)
      if (h->vals[i] > 15) throw Fail();
  }
}

// The entropy-coded bit stream of one scan. It stops at a marker and from
// there supplies zero bits; consuming a bit that the data did not hold sets
// `insufficient`, which (as in libjpeg) leaves the following MCUs zero
// until a restart marker is found.
struct Bits {
  Source* src;
  uint64_t buf = 0;
  int n = 0;     // bits in buf
  int real = 0;  // of which came from the data (the rest are zero padding)
  int marker = 0;
  bool insufficient = false;

  void fill(int need) {
    while (n <= 48 && marker == 0) {
      int c = src->byte();
      if (c == 0xFF) {
        do {
          c = src->byte();
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker = c;
          break;
        }
      }
      buf = (buf << 8) | static_cast<uint64_t>(c);
      n += 8;
      real += 8;
    }
    while (n < need) {
      buf <<= 8;
      n += 8;
    }
  }
  int peek(int k) {
    if (n < k) fill(k);
    return static_cast<int>((buf >> (n - k)) & ((1u << k) - 1));
  }
  void consume(int k) {
    n -= k;
    if (k > real) {
      insufficient = true;
      real = 0;
    } else {
      real -= k;
    }
  }
  int get(int k) {
    const int v = peek(k);
    consume(k);
    return v;
  }
  void discard() {
    buf = 0;
    n = 0;
    real = 0;
  }
};

inline int decode(Bits& br, const HuffTable& t) {
  const int e = t.look[br.peek(8)];
  const int nb = e >> 8;
  if (nb <= 8) {
    br.consume(nb);
    return e & 0xFF;
  }
  int code = br.get(9);
  int l = 9;
  while (code > t.maxcode[l]) {
    code = (code << 1) | br.get(1);
    ++l;
  }
  if (l > 16) return 0;  // corrupt data: libjpeg fakes a zero
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

// jdarith.c's decoder state and arith_decode: the C and A registers, the
// bit counter (-16 before the first two bytes; -1 marks a scan in error
// until the next restart) and, as cinfo->unread_marker in libjpeg, the
// marker met in the data, after which the decoder reads zero bytes.
struct Arith {
  Source* src;
  int marker = 0;
  int64_t c = 0, a = 0;  // JLONG
  int ct = -16;

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }

  int decode(uint8_t* st) {
    // Renormalization and data input, section D.2.6.
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (marker == 0) {
          data = src->byte();
          if (data == 0xFF) {
            do {
              data = src->byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;  // a stuffed zero byte
            } else {
              marker = data;  // legal here: zero data from now on
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0) {
          if (++ct == 0) a = 0x8000;  // the two initial bytes are in
        }
      }
      a <<= 1;
    }
    // Decode and estimate, sections D.2.4 and D.2.5.
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

inline int16_t to_coef(int v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v & 0xFFFF));
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // real block counts
  int pw = 0, ph = 0;    // padded to the sampling factors
  int dc_tbl = 0, ac_tbl = 0;
  bool latched = false;
  uint16_t quant[64] = {};
  std::vector<int16_t> coef;
  int16_t* block(int row, int col) {
    return coef.data() + (static_cast<size_t>(row) * pw + col) * 64;
  }
};

enum { kReachedSos = 1, kReachedEoi = 2 };

// The entropy decoder a scan takes: sequential, or one of the four
// progressive passes.
enum ScanMode { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

struct Jpeg {
  Source src;
  bool saw_soi = false, saw_sof = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool progressive = false, arith = false;
  int precision = 0, width = 0, height = 0;
  int hmax = 1, vmax = 1;
  std::vector<Component> comp;
  bool qpresent[4] = {};
  uint16_t qtbl[4][64] = {};
  HuffSpec dc_spec[4], ac_spec[4];
  // The arithmetic conditioning tables (DAC), by table number.
  uint8_t arith_dc_L[kNumArithTbls] = {}, arith_dc_U[kNumArithTbls] = {};
  uint8_t arith_ac_K[kNumArithTbls] = {};
  int restart_interval = 0;
  int unread = 0;
  // The current scan.
  int comps_in_scan = 0;
  int scan_comp[kMaxCompsInScan] = {};  // component indices
  int ss = 0, se = 0, ah = 0, al = 0;
  bool multiple_scans = false;

  Jpeg(const uint8_t* data, size_t len) : src{data, len} {}

  void skip_variable() { src.skip(static_cast<long>(src.word()) - 2); }

  void get_app() {
    const int marker = unread;
    long length = static_cast<long>(src.word()) - 2;
    uint8_t b[14];
    const long numtoread = length >= 14 ? 14 : (length > 0 ? length : 0);
    for (long i = 0; i < numtoread; ++i) b[i] = static_cast<uint8_t>(src.byte());
    length -= numtoread;
    if (marker == 0xE0) {
      if (numtoread >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' &&
          b[3] == 'F' && b[4] == 0)
        saw_jfif = true;
    } else if (numtoread >= 12 && b[0] == 'A' && b[1] == 'd' &&
               b[2] == 'o' && b[3] == 'b' && b[4] == 'e') {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    if (length > 0) src.skip(length);
  }

  void get_dqt() {
    long length = static_cast<long>(src.word()) - 2;
    while (length > 0) {
      length--;
      int t = src.byte();
      const int prec = t >> 4;
      t &= 0x0F;
      if (t >= 4) throw Fail();
      qpresent[t] = true;
      for (int i = 0; i < 64; ++i) {
        const int q = prec ? src.word() : src.byte();
        qtbl[t][kNatural[i]] = static_cast<uint16_t>(q);
      }
      length -= 64;
      if (prec) length -= 64;
    }
    if (length != 0) throw Fail();
  }

  void get_dht() {
    long length = static_cast<long>(src.word()) - 2;
    while (length > 16) {
      int index = src.byte();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = static_cast<uint8_t>(src.byte());
        count += bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) throw Fail();
      uint8_t vals[256] = {};
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(src.byte());
      length -= count;
      HuffSpec* spec;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) throw Fail();
        spec = &ac_spec[index];
      } else {
        if (index < 0 || index >= 4) throw Fail();
        spec = &dc_spec[index];
      }
      spec->present = true;
      std::memcpy(spec->bits, bits, 17);
      std::memcpy(spec->vals, vals, 256);
    }
    if (length != 0) throw Fail();
  }

  // jdmarker.c get_dac.
  void get_dac() {
    long length = static_cast<long>(src.word()) - 2;
    while (length > 0) {
      const int index = src.byte();
      const int val = src.byte();
      length -= 2;
      if (index < 0 || index >= 2 * kNumArithTbls) throw Fail();
      if (index >= kNumArithTbls) {
        arith_ac_K[index - kNumArithTbls] = static_cast<uint8_t>(val);
      } else {
        arith_dc_L[index] = static_cast<uint8_t>(val & 0x0F);
        arith_dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) throw Fail();
      }
    }
    if (length != 0) throw Fail();
  }

  void get_dri() {
    if (src.word() != 4) throw Fail();
    restart_interval = src.word();
  }

  void get_sof(bool is_progressive, bool is_arith) {
    long length = src.word();
    precision = src.byte();
    height = src.word();
    width = src.word();
    const int ncomp = src.byte();
    length -= 8;
    if (saw_sof) throw Fail();
    if (height <= 0 || width <= 0 || ncomp <= 0) throw Fail();
    if (length != ncomp * 3) throw Fail();
    comp.assign(ncomp, Component());
    for (auto& c : comp) {
      c.id = src.byte();
      const int s = src.byte();
      c.h = (s >> 4) & 15;
      c.v = s & 15;
      c.tq = src.byte();
    }
    progressive = is_progressive;
    arith = is_arith;
    saw_sof = true;
  }

  void get_sos() {
    if (!saw_sof) throw Fail();
    const int length = src.word();
    const int n = src.byte();
    if (length != n * 2 + 6 || n < 1 || n > kMaxCompsInScan) throw Fail();
    comps_in_scan = n;
    int cur[kMaxCompsInScan] = {-1, -1, -1, -1};
    for (int i = 0; i < n; ++i) {
      const int cc = src.byte();
      const int tables = src.byte();
      const int limit = static_cast<int>(comp.size()) < kMaxCompsInScan
                            ? static_cast<int>(comp.size())
                            : kMaxCompsInScan;
      int found = -1;
      for (int ci = 0; ci < limit; ++ci) {
        // libjpeg's test, slot by component index, kept as it is.
        if (cc == comp[ci].id && cur[ci] < 0) {
          found = ci;
          break;
        }
      }
      if (found < 0) throw Fail();
      cur[i] = found;
      scan_comp[i] = found;
      comp[found].dc_tbl = (tables >> 4) & 15;
      comp[found].ac_tbl = tables & 15;
    }
    ss = src.byte();
    se = src.byte();
    const int a = src.byte();
    ah = (a >> 4) & 15;
    al = a & 15;
  }

  // read_markers: up to and including the next SOS header, or EOI.
  int read_markers() {
    for (;;) {
      if (unread == 0) {
        if (!saw_soi) {
          const int c = src.byte();
          const int c2 = src.byte();
          if (c != 0xFF || c2 != 0xD8) throw Fail();
          unread = 0xD8;
        } else {
          unread = next_marker(src);
        }
      }
      switch (unread) {
        case 0xD8:
          if (saw_soi) throw Fail();
          saw_soi = true;
          for (int i = 0; i < kNumArithTbls; ++i) {
            arith_dc_L[i] = 0;
            arith_dc_U[i] = 1;
            arith_ac_K[i] = 5;
          }
          restart_interval = 0;
          saw_jfif = saw_adobe = false;
          adobe_transform = 0;
          break;
        case 0xC0:
        case 0xC1:
          get_sof(false, false);
          break;
        case 0xC2:
          get_sof(true, false);
          break;
        case 0xC9:
          get_sof(false, true);
          break;
        case 0xCA:
          get_sof(true, true);
          break;
        case 0xDA:
          get_sos();
          unread = 0;
          return kReachedSos;
        case 0xD9:
          unread = 0;
          return kReachedEoi;
        case 0xC4:
          get_dht();
          break;
        case 0xDB:
          get_dqt();
          break;
        case 0xDD:
          get_dri();
          break;
        case 0xCC:
          get_dac();
          break;
        case 0xDC:  // DNL
        case 0xFE:  // COM
          skip_variable();
          break;
        case 0x01:
        case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7:
          break;
        default:
          if (unread == 0xE0 || unread == 0xEE) {
            get_app();
          } else if (unread >= 0xE1 && unread <= 0xEF) {
            skip_variable();
          } else {
            throw Fail();  // SOF3, SOF5-7, SOF11, SOF13-15, JPG, unknown
          }
      }
      unread = 0;
    }
  }

  // jdinput.c initial_setup, at the first SOS.
  void initial_setup() {
    if (height > kMaxDimension || width > kMaxDimension) throw Fail();
    if (precision != 8) throw Fail();
    if (static_cast<int>(comp.size()) > kMaxComponents) throw Fail();
    hmax = vmax = 1;
    for (auto& c : comp) {
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) throw Fail();
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    for (auto& c : comp) {
      c.wib = static_cast<int>(
          (static_cast<int64_t>(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.hib = static_cast<int>(
          (static_cast<int64_t>(height) * c.v + 8 * vmax - 1) / (8 * vmax));
    }
    multiple_scans = comps_in_scan < static_cast<int>(comp.size()) ||
                     progressive;
  }

  // jpeg_read_header: markers up to the first SOS. Returns the colour
  // space's verdict: 1 grayscale, 2 YCbCr, 0 anything else.
  int read_header() {
    if (read_markers() != kReachedSos) throw Fail();  // no image
    initial_setup();
    if (comp.size() == 1) return 1;
    if (comp.size() != 3) return 0;
    if (saw_jfif) return 2;
    if (saw_adobe) return adobe_transform == 0 ? 0 : 2;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return 0;
    return 2;
  }

  bool ycc420() const {
    return comp[0].h == 2 && comp[0].v == 2 && comp[1].h == 1 &&
           comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1;
  }

  void allocate() {
    for (auto& c : comp) {
      c.pw = (c.wib + c.h - 1) / c.h * c.h;
      c.ph = (c.hib + c.v - 1) / c.v * c.v;
      c.coef.assign(static_cast<size_t>(c.pw) * c.ph * 64, 0);
    }
  }

  void latch_quant() {
    for (int i = 0; i < comps_in_scan; ++i) {
      Component& c = comp[scan_comp[i]];
      if (c.latched) continue;
      if (c.tq < 0 || c.tq >= 4 || !qpresent[c.tq]) throw Fail();
      std::memcpy(c.quant, qtbl[c.tq], sizeof(c.quant));
      c.latched = true;
    }
  }

  // jdmarker.c read_restart_marker with the memory source's
  // resync_to_restart; `marker` is the unread marker, if any.
  void read_restart_marker(int& marker, int& next_restart) {
    if (marker == 0) marker = next_marker(src);
    if (marker == 0xD0 + next_restart) {
      marker = 0;
    } else {
      for (;;) {
        const int m = marker;
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((next_restart + 1) & 7) ||
                   m == 0xD0 + ((next_restart + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((next_restart - 1) & 7) ||
                   m == 0xD0 + ((next_restart - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          marker = 0;
          break;
        }
        if (action == 3) break;
        marker = next_marker(src);
      }
    }
    next_restart = (next_restart + 1) & 7;
  }

  // The blocks of MCU (row, col) of the current scan, dummy blocks of the
  // padding included, and the scan component each belongs to.
  int mcu_blocks(bool interleaved, int row, int col, int16_t** blocks,
                 int* member) {
    if (!interleaved) {
      blocks[0] = comp[scan_comp[0]].block(row, col);
      member[0] = 0;
      return 1;
    }
    int nblocks = 0;
    for (int i = 0; i < comps_in_scan; ++i) {
      Component& c = comp[scan_comp[i]];
      for (int y = 0; y < c.v; ++y)
        for (int x = 0; x < c.h; ++x) {
          blocks[nblocks] = c.block(row * c.v + y, col * c.h + x);
          member[nblocks++] = i;
        }
    }
    return nblocks;
  }

  void decode_scan();
  void decode_scan_arith(ScanMode mode, bool interleaved, int mcus_per_row,
                         int mcu_rows);
  void decode_all();
};

void Jpeg::decode_scan() {
  // per_scan_setup
  const bool interleaved = comps_in_scan > 1;
  int mcus_per_row, mcu_rows;
  if (!interleaved) {
    mcus_per_row = comp[scan_comp[0]].wib;
    mcu_rows = comp[scan_comp[0]].hib;
  } else {
    int blocks = 0;
    for (int i = 0; i < comps_in_scan; ++i) {
      const Component& c = comp[scan_comp[i]];
      blocks += c.h * c.v;
    }
    if (blocks > kMaxBlocksInMcu) throw Fail();
    mcus_per_row = (width + 8 * hmax - 1) / (8 * hmax);
    mcu_rows = (height + 8 * vmax - 1) / (8 * vmax);
  }
  latch_quant();

  // The entropy decoder's start_pass: check the scan, build its tables.
  ScanMode mode = kSeq;
  HuffTable dc_tab[kMaxCompsInScan], ac_tab[kMaxCompsInScan];
  if (progressive) {
    const bool dc_band = ss == 0;
    bool bad = false;
    if (dc_band) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se >= 64) bad = true;
      if (comps_in_scan != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) throw Fail();
    mode = dc_band ? (ah == 0 ? kDcFirst : kDcRefine)
                   : (ah == 0 ? kAcFirst : kAcRefine);
  }
  if (arith) {
    decode_scan_arith(mode, interleaved, mcus_per_row, mcu_rows);
    return;
  }
  if (progressive) {
    const bool dc_band = ss == 0;
    for (int i = 0; i < comps_in_scan; ++i) {
      const Component& c = comp[scan_comp[i]];
      if (dc_band) {
        if (ah == 0) derive(dc_spec[c.dc_tbl < 4 ? c.dc_tbl : 0], true,
                            c.dc_tbl, &dc_tab[i]);
      } else {
        derive(ac_spec[c.ac_tbl < 4 ? c.ac_tbl : 0], false, c.ac_tbl,
               &ac_tab[i]);
      }
    }
  } else {
    for (int i = 0; i < comps_in_scan; ++i) {
      const Component& c = comp[scan_comp[i]];
      derive(dc_spec[c.dc_tbl < 4 ? c.dc_tbl : 0], true, c.dc_tbl,
             &dc_tab[i]);
      derive(ac_spec[c.ac_tbl < 4 ? c.ac_tbl : 0], false, c.ac_tbl,
             &ac_tab[i]);
    }
  }

  Bits br{&src};
  int last_dc[kMaxCompsInScan] = {};
  int eobrun = 0;
  int restarts_to_go = restart_interval;
  int next_restart = 0;
  const int p1 = 1 << al;
  const int m1 = static_cast<int>(~0u << al);
  int16_t* blocks[kMaxBlocksInMcu];
  int member[kMaxBlocksInMcu];

  for (int row = 0; row < mcu_rows; ++row) {
    for (int col = 0; col < mcus_per_row; ++col) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          // process_restart + read_restart_marker + resync_to_restart
          br.discard();
          read_restart_marker(br.marker, next_restart);
          for (int& d : last_dc) d = 0;
          eobrun = 0;
          restarts_to_go = restart_interval;
          if (br.marker == 0) br.insufficient = false;
        }
      }
      const int nblocks = mcu_blocks(interleaved, row, col, blocks, member);
      if (!br.insufficient) {
        switch (mode) {
          case kSeq:
            for (int b = 0; b < nblocks; ++b) {
              int16_t* blk = blocks[b];
              const int ci = member[b];
              int s = decode(br, dc_tab[ci]);
              if (s) s = extend(br.get(s), s);
              s = static_cast<int>(static_cast<unsigned>(s) +
                                   static_cast<unsigned>(last_dc[ci]));
              last_dc[ci] = s;
              blk[0] = to_coef(s);
              for (int k = 1; k < 64; ++k) {
                s = decode(br, ac_tab[ci]);
                int r = s >> 4;
                s &= 15;
                if (s) {
                  k += r;
                  s = extend(br.get(s), s);
                  blk[kNatural[k]] = to_coef(s);
                } else {
                  if (r != 15) break;
                  k += 15;
                }
              }
            }
            break;
          case kDcFirst:
            for (int b = 0; b < nblocks; ++b) {
              const int ci = member[b];
              int s = decode(br, dc_tab[ci]);
              if (s) s = extend(br.get(s), s);
              const int last = last_dc[ci];
              if ((last >= 0 && s > INT32_MAX - last) ||
                  (last < 0 && s < INT32_MIN - last))
                throw Fail();
              s += last;
              last_dc[ci] = s;
              blocks[b][0] = to_coef(static_cast<int>(
                  static_cast<unsigned>(s) << al));
            }
            break;
          case kDcRefine:
            for (int b = 0; b < nblocks; ++b)
              if (br.get(1)) blocks[b][0] = to_coef(blocks[b][0] | p1);
            break;
          case kAcFirst:
            if (eobrun > 0) {
              eobrun--;
            } else {
              int16_t* blk = blocks[0];
              for (int k = ss; k <= se; ++k) {
                int s = decode(br, ac_tab[0]);
                int r = s >> 4;
                s &= 15;
                if (s) {
                  k += r;
                  s = extend(br.get(s), s);
                  blk[kNatural[k]] = to_coef(static_cast<int>(
                      static_cast<unsigned>(s) << al));
                } else if (r == 15) {
                  k += 15;
                } else {
                  eobrun = 1 << r;
                  if (r) eobrun += br.get(r);
                  eobrun--;
                  break;
                }
              }
            }
            break;
          case kAcRefine: {
            int16_t* blk = blocks[0];
            int k = ss;
            if (eobrun == 0) {
              for (; k <= se; ++k) {
                int s = decode(br, ac_tab[0]);
                int r = s >> 4;
                s &= 15;
                if (s) {
                  s = br.get(1) ? p1 : m1;
                } else if (r != 15) {
                  eobrun = 1 << r;
                  if (r) eobrun += br.get(r);
                  break;
                }
                do {
                  int16_t* coef = blk + kNatural[k];
                  if (*coef != 0) {
                    if (br.get(1)) {
                      if ((*coef & p1) == 0)
                        *coef = to_coef(*coef >= 0 ? *coef + p1 : *coef + m1);
                    }
                  } else {
                    if (--r < 0) break;
                  }
                  k++;
                } while (k <= se);
                if (s) blk[kNatural[k]] = to_coef(s);
              }
            }
            if (eobrun > 0) {
              for (; k <= se; ++k) {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
                  *coef = to_coef(*coef >= 0 ? *coef + p1 : *coef + m1);
              }
              eobrun--;
            }
            break;
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    }
  }
  unread = br.marker ? br.marker : next_marker(src);
}

// jdarith.c: start_pass, process_restart and the five decode_mcu
// routines over the scan's MCUs.
void Jpeg::decode_scan_arith(ScanMode mode, bool interleaved,
                             int mcus_per_row, int mcu_rows) {
  uint8_t dc_stats[kNumArithTbls][kDcStatBins];
  uint8_t ac_stats[kNumArithTbls][kAcStatBins];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};  // the fixed 0.5 estimate
  int last_dc[kMaxCompsInScan] = {};
  int dc_context[kMaxCompsInScan] = {};
  const bool dc_stats_used = !progressive || (ss == 0 && ah == 0);
  const bool ac_stats_used = !progressive || ss != 0;

  // Zero the statistics this scan uses and the DC predictions (start_pass
  // and process_restart alike); table numbers are 4-bit, below 16.
  auto reset_stats = [&]() {
    for (int i = 0; i < comps_in_scan; ++i) {
      const Component& c = comp[scan_comp[i]];
      if (dc_stats_used) {
        std::memset(dc_stats[c.dc_tbl], 0, kDcStatBins);
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (ac_stats_used) std::memset(ac_stats[c.ac_tbl], 0, kAcStatBins);
    }
  };
  reset_stats();
  Arith ar{&src};
  int restarts_to_go = restart_interval;
  int next_restart = 0;
  const int p1 = 1 << al;
  const int m1 = static_cast<int>(~0u << al);
  int16_t* blocks[kMaxBlocksInMcu];
  int member[kMaxBlocksInMcu];

  // Figures F.19 and F.21-F.24: one DC difference, added to the
  // prediction (kept modulo 2^16).
  auto decode_dc = [&](int ci) {
    const int tbl = comp[scan_comp[ci]].dc_tbl;
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (ar.decode(st) == 0) {
      dc_context[ci] = 0;
      return true;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;  // X1
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;  // magnitude overflow
          return false;
        }
        st += 1;
      }
    }
    if (m < static_cast<int>((1L << arith_dc_L[tbl]) >> 1))
      dc_context[ci] = 0;
    else if (m > static_cast<int>((1L << arith_dc_U[tbl]) >> 1))
      dc_context[ci] = 12 + sign * 4;
    else
      dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[ci] = (last_dc[ci] + v) & 0xffff;
    return true;
  };

  // Figure F.20: the AC coefficients k in [first, last], stored shifted
  // left by `shift`.
  auto decode_ac = [&](int16_t* blk, int tbl, int first, int last,
                       int shift) {
    for (int k = first; k <= last; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > last) {
          ar.ct = -1;  // spectral overflow
          return;
        }
      }
      const int sign = ar.decode(fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0) {
        if (ar.decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) {
              ar.ct = -1;  // magnitude overflow
              return;
            }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] =
          to_coef(static_cast<int>(static_cast<unsigned>(v) << shift));
    }
  };

  for (int row = 0; row < mcu_rows; ++row) {
    for (int col = 0; col < mcus_per_row; ++col) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          read_restart_marker(ar.marker, next_restart);
          reset_stats();
          ar.reset();
          restarts_to_go = restart_interval;
        }
        restarts_to_go--;
      }
      const int nblocks = mcu_blocks(interleaved, row, col, blocks, member);
      // DC refinement alone goes on after an overflow, as in jdarith.c.
      if (ar.ct == -1 && mode != kDcRefine) continue;
      switch (mode) {
        case kSeq:
          for (int b = 0; b < nblocks; ++b) {
            const int ci = member[b];
            if (!decode_dc(ci)) break;
            blocks[b][0] = to_coef(last_dc[ci]);
            decode_ac(blocks[b], comp[scan_comp[ci]].ac_tbl, 1, 63, 0);
            if (ar.ct == -1) break;
          }
          break;
        case kDcFirst:
          for (int b = 0; b < nblocks; ++b) {
            const int ci = member[b];
            if (!decode_dc(ci)) break;
            blocks[b][0] = to_coef(static_cast<int>(
                static_cast<unsigned>(last_dc[ci]) << al));
          }
          break;
        case kDcRefine:
          for (int b = 0; b < nblocks; ++b)
            if (ar.decode(fixed_bin)) blocks[b][0] = to_coef(blocks[b][0] | p1);
          break;
        case kAcFirst:
          decode_ac(blocks[0], comp[scan_comp[0]].ac_tbl, ss, se, al);
          break;
        case kAcRefine: {
          int16_t* blk = blocks[0];
          const int tbl = comp[scan_comp[0]].ac_tbl;
          int kex = se;  // the previous stage's end of block
          for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
          for (int k = ss; k <= se; ++k) {
            uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
            if (k > kex && ar.decode(st)) break;  // EOB
            bool overflow = false;
            for (;;) {
              int16_t* coef = blk + kNatural[k];
              if (*coef) {  // previously nonzero
                if (ar.decode(st + 2))
                  *coef = to_coef(*coef < 0 ? *coef + m1 : *coef + p1);
                break;
              }
              if (ar.decode(st + 1)) {  // newly nonzero
                *coef = to_coef(ar.decode(fixed_bin) ? m1 : p1);
                break;
              }
              st += 3;
              if (++k > se) {
                ar.ct = -1;  // spectral overflow
                overflow = true;
                break;
              }
            }
            if (overflow) break;
          }
          break;
        }
      }
    }
  }
  unread = ar.marker ? ar.marker : next_marker(src);
}

// jpeg_read_coefficients: every scan, up to EOI.
void Jpeg::decode_all() {
  allocate();
  decode_scan();
  for (;;) {
    const int r = read_markers();
    if (r == kReachedEoi) return;
    if (!multiple_scans) throw Fail();  // a second scan where none was due
    decode_scan();
  }
}

// Header-only probe. Returns 0 and fills geom4 = {w, h, ncomp, coeff_ok};
// nonzero (geom4 zeroed) when the header does not parse.
int probe_one(const uint8_t* data, size_t len, int32_t* geom4) {
  try {
    Jpeg j(data, len);
    const int space = j.read_header();
    geom4[0] = j.width;
    geom4[1] = j.height;
    geom4[2] = static_cast<int32_t>(j.comp.size());
    geom4[3] = space == 1 || (space == 2 && j.ycc420());
    return 0;
  } catch (const Fail&) {
    geom4[0] = geom4[1] = geom4[2] = geom4[3] = 0;
    return 1;
  } catch (const std::bad_alloc&) {
    geom4[0] = geom4[1] = geom4[2] = geom4[3] = 0;
    return 1;
  }
}

// Extract one image into its page slot, as the JAX extractor's
// extract_one does (return codes included). Nothing is written unless the
// whole entropy decode succeeded.
int extract_one(const uint8_t* data, size_t len, int yb_h, int yb_w,
                int cb_h, int cb_w, int16_t* coef_y, int16_t* coef_cb,
                int16_t* coef_cr, int32_t* quant, int32_t* geom6) {
  try {
    Jpeg j(data, len);
    const int space = j.read_header();
    const bool gray = space == 1;
    const bool ycc = space == 2 && j.ycc420();
    if (!gray && !ycc) return 2;
    j.decode_all();
    geom6[0] = j.width;
    geom6[1] = j.height;
    for (size_t ci = 0; ci < j.comp.size(); ++ci) {
      Component& c = j.comp[ci];
      const int grid_h = ci == 0 ? yb_h : cb_h;
      const int grid_w = ci == 0 ? yb_w : cb_w;
      if (c.wib > grid_w || c.hib > grid_h) return 4;
      int16_t* page = ci == 0 ? coef_y : (ci == 1 ? coef_cb : coef_cr);
      for (int row = 0; row < c.hib; ++row)
        std::memcpy(page + static_cast<size_t>(row) * grid_w * 64,
                    c.block(row, 0),
                    static_cast<size_t>(c.wib) * 64 * sizeof(int16_t));
      if (ci == 0) {
        geom6[2] = c.wib;
        geom6[3] = c.hib;
      } else if (ci == 1) {
        geom6[4] = c.wib;
        geom6[5] = c.hib;
      }
      const uint16_t* q = c.latched ? c.quant : nullptr;
      if (q == nullptr && c.tq >= 0 && c.tq < 4 && j.qpresent[c.tq])
        q = j.qtbl[c.tq];
      if (q == nullptr) return 5;
      for (int k = 0; k < 64; ++k) quant[ci * 64 + k] = q[k];
    }
    if (gray) {
      geom6[4] = (geom6[2] + 1) / 2;
      geom6[5] = (geom6[3] + 1) / 2;
      for (int k = 0; k < 64; ++k) {
        quant[64 + k] = quant[k];
        quant[128 + k] = quant[k];
      }
    }
    return 0;
  } catch (const Fail&) {
    return 1;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

}  // namespace

extern "C" {

// Header-only probe of n JPEGs: geom[i*4..] = {w, h, ncomp, coeff_ok};
// failed[i] = 1 on unparsable headers. Returns the failure count.
int ldt_probe_batch(const uint8_t** srcs, const size_t* lens, int n,
                    int32_t* geom, uint8_t* failed) {
  int failures = 0;
  for (int i = 0; i < n; ++i) {
    const int rc = probe_one(srcs[i], lens[i], geom + static_cast<size_t>(i) * 4);
    if (failed) failed[i] = rc != 0 ? 1 : 0;
    if (rc != 0) ++failures;
  }
  return failures;
}

// Entropy-decode n JPEGs into canonical coefficient pages (which the caller
// zeroes: padding blocks are never written) on n_threads threads (0 = one
// per hardware thread). Returns the number of failed images; failed[i] is
// set for each.
int ldt_extract_coeffs(const uint8_t** srcs, const size_t* lens, int n,
                       int yb_h, int yb_w, int cb_h, int cb_w,
                       int16_t* coef_y, int16_t* coef_cb, int16_t* coef_cr,
                       int32_t* quant, int32_t* geom, uint8_t* failed,
                       int n_threads) {
  if (n <= 0) return 0;
  const size_t y_page = static_cast<size_t>(yb_h) * yb_w * 64;
  const size_t c_page = static_cast<size_t>(cb_h) * cb_w * 64;
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      const int rc = extract_one(
          srcs[i], lens[i], yb_h, yb_w, cb_h, cb_w, coef_y + i * y_page,
          coef_cb + i * c_page, coef_cr + i * c_page,
          quant + static_cast<size_t>(i) * 192,
          geom + static_cast<size_t>(i) * 6);
      if (failed) failed[i] = rc != 0 ? 1 : 0;
      if (rc != 0) failures.fetch_add(1);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// The threads ldt_extract_coeffs takes for n_threads = 0.
int ldt_coeffs_default_threads() {
  const int t = static_cast<int>(std::thread::hardware_concurrency());
  return t > 0 ? t : 1;
}

// Version tag, checked by the Python binding.
int ldt_coeffs_abi_version() { return 1; }

}  // extern "C"
