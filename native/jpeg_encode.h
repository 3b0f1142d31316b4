// Minimal dependency-free baseline JPEG (JFIF) encoder.
//
// Companion to png_encode.h: RGBA in, complete JPEG byte stream out.
// Baseline sequential DCT, 4:2:0 chroma subsampling, the standard Annex-K
// quantization and Huffman tables (the same defaults every libjpeg build
// ships), libjpeg-style quality scaling.  Built for the frame sinks: the
// MJPEG AVI writer (utils/video.py) and the HTTP live stream, where PNG's
// lossless zlib pass is 5-10x more encode time than a visually lossless
// JPEG at quality ~90.
//
// Multithreaded encode (encode_jpeg with threads > 1) stripes the image
// into bands of whole 16-row MCU rows, one thread per band: a DRI marker
// sets the restart interval to exactly one band's MCU count, each band is
// entropy-coded independently (DC predictors reset, byte-aligned flush —
// precisely the state a restart marker declares), and the bands are joined
// with RST0..7 markers.  Any baseline decoder accepts the stream; at
// threads=1 the output is BIT-IDENTICAL to the original single-threaded
// encoder (no DRI, no markers).
//
// Not implemented (not needed here): progressive scans, arithmetic coding,
// 4:4:4 / grayscale modes, EXIF.

#ifndef FLUIDS_JPEG_ENCODE_H_
#define FLUIDS_JPEG_ENCODE_H_

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace jpegenc {

namespace detail {

// zigzag scan order: zigzag position -> natural (row-major) index
static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1 quantization tables (natural order)
static const uint8_t kQuantLum[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t kQuantChr[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 Huffman specs: 16 code-length counts + symbol values
static const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                       1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t kDcChrVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4,   3,
                                       5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kAcLumVals[162] = {
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
static const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3,   4,
                                       7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t kAcChrVals[162] = {
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

struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];  // 0 = symbol absent

  // build canonical codes from (bits, vals) exactly per spec C.2
  void build(const uint8_t bits[17], const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    uint16_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len]; ++i) {
        code[vals[k]] = c++;
        size[vals[k]] = uint8_t(len);
        ++k;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void put(uint16_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);  // byte stuffing
      nbits -= 8;
    }
  }

  void flush() {
    if (nbits > 0) put(uint16_t((1u << (8 - nbits)) - 1), 8 - nbits);  // pad 1s
  }
};

inline int bit_category(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

// AAN (Arai-Agui-Nakajima) fast forward 8x8 DCT: 5 multiplies / 29 adds
// per 1-D pass (the jfdctflt factorization every libjpeg ships).  Output is
// SCALED by 8*aan[r]*aan[c] relative to the orthonormal DCT; the scale is
// folded into the quantization reciprocals (make_recip), costing nothing.
inline void fdct8x8_aan_1d(float* d, int stride) {
  float d0 = d[0 * stride], d1 = d[1 * stride], d2 = d[2 * stride],
        d3 = d[3 * stride], d4 = d[4 * stride], d5 = d[5 * stride],
        d6 = d[6 * stride], d7 = d[7 * stride];
  float tmp0 = d0 + d7, tmp7 = d0 - d7;
  float tmp1 = d1 + d6, tmp6 = d1 - d6;
  float tmp2 = d2 + d5, tmp5 = d2 - d5;
  float tmp3 = d3 + d4, tmp4 = d3 - d4;

  float tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  float tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  d[0 * stride] = tmp10 + tmp11;
  d[4 * stride] = tmp10 - tmp11;
  float z1 = (tmp12 + tmp13) * 0.707106781f;
  d[2 * stride] = tmp13 + z1;
  d[6 * stride] = tmp13 - z1;

  tmp10 = tmp4 + tmp5;
  tmp11 = tmp5 + tmp6;
  tmp12 = tmp6 + tmp7;
  float z5 = (tmp10 - tmp12) * 0.382683433f;
  float z2 = 0.541196100f * tmp10 + z5;
  float z4 = 1.306562965f * tmp12 + z5;
  float z3 = tmp11 * 0.707106781f;
  float z11 = tmp7 + z3, z13 = tmp7 - z3;
  d[5 * stride] = z13 + z2;
  d[3 * stride] = z13 - z2;
  d[1 * stride] = z11 + z4;
  d[7 * stride] = z11 - z4;
}

inline void fdct8x8(float blk[64]) {
  for (int y = 0; y < 8; ++y) fdct8x8_aan_1d(blk + y * 8, 1);  // rows
  for (int x = 0; x < 8; ++x) fdct8x8_aan_1d(blk + x, 8);      // cols
}

// reciprocal quantization divisors with the AAN output scaling folded in:
// recip[i] = 1 / (q[i] * 8 * aan[row] * aan[col])
inline void make_recip(const uint16_t q[64], float recip[64]) {
  static const float aan[8] = {1.0f,         1.387039845f, 1.306562965f,
                               1.175875602f, 1.0f,         0.785694958f,
                               0.541196100f, 0.275899379f};
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      int i = r * 8 + c;
      recip[i] = 1.0f / (float(q[i]) * 8.0f * aan[r] * aan[c]);
    }
}

// quantize + zigzag + entropy-code one block; returns the new DC predictor
inline int encode_block(BitWriter& bw, const float blk[64],
                        const float recip[64], const HuffTable& dc,
                        const HuffTable& ac, int prev_dc) {
  int zz[64];
  for (int i = 0; i < 64; ++i) {
    float v = blk[kZigzag[i]] * recip[kZigzag[i]];
    zz[i] = int(v < 0 ? v - 0.5f : v + 0.5f);
  }
  int diff = zz[0] - prev_dc;
  int cat = bit_category(diff);
  bw.put(dc.code[cat], dc.size[cat]);
  if (cat) bw.put(uint16_t(diff < 0 ? diff + (1 << cat) - 1 : diff), cat);
  int run = 0;
  for (int i = 1; i < 64; ++i) {
    if (zz[i] == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);  // ZRL
      run -= 16;
    }
    int c = bit_category(zz[i]);
    int sym = (run << 4) | c;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint16_t(zz[i] < 0 ? zz[i] + (1 << c) - 1 : zz[i]), c);
    run = 0;
  }
  if (run) bw.put(ac.code[0x00], ac.size[0x00]);  // EOB
  return zz[0];
}

inline void put16(std::vector<uint8_t>& o, uint16_t v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

inline void marker(std::vector<uint8_t>& o, uint8_t m, uint16_t len) {
  o.push_back(0xFF);
  o.push_back(m);
  put16(o, len);
}

// Entropy-code MCU rows [my0, my1) into ``out`` with fresh DC predictors
// and a byte-aligned tail — one restart interval's worth of scan data.
inline void encode_mcu_rows(const uint8_t* rgba, int w, int h, int my0,
                            int my1, const float rlum[64],
                            const float rchr[64], const HuffTable& dc_lum,
                            const HuffTable& ac_lum, const HuffTable& dc_chr,
                            const HuffTable& ac_chr,
                            std::vector<uint8_t>& out) {
  BitWriter bw(out);
  int dcY = 0, dcCb = 0, dcCr = 0;
  int mcux = (w + 15) / 16;
  float Y[16 * 16], Cb[8 * 8], Cr[8 * 8], blk[64];
  for (int my = my0; my < my1; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      // color-convert the 16x16 tile; average 2x2 for chroma
      for (int sy = 0; sy < 16; sy += 2) {
        for (int sx = 0; sx < 16; sx += 2) {
          float cb = 0, cr = 0;
          for (int dy = 0; dy < 2; ++dy) {
            for (int dx = 0; dx < 2; ++dx) {
              int px = mx * 16 + sx + dx, py = my * 16 + sy + dy;
              if (px >= w) px = w - 1;
              if (py >= h) py = h - 1;
              const uint8_t* p = rgba + (size_t(py) * w + px) * 4;
              float r = p[0], g = p[1], b = p[2];
              Y[(sy + dy) * 16 + sx + dx] =
                  0.299f * r + 0.587f * g + 0.114f * b - 128.0f;
              cb += -0.168736f * r - 0.331264f * g + 0.5f * b;
              cr += 0.5f * r - 0.418688f * g - 0.081312f * b;
            }
          }
          Cb[(sy / 2) * 8 + sx / 2] = cb * 0.25f;
          Cr[(sy / 2) * 8 + sx / 2] = cr * 0.25f;
        }
      }
      for (int b = 0; b < 4; ++b) {  // 4 Y blocks, left-to-right then down
        int ox = (b & 1) * 8, oy = (b >> 1) * 8;
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            blk[y * 8 + x] = Y[(oy + y) * 16 + ox + x];
        fdct8x8(blk);
        dcY = encode_block(bw, blk, rlum, dc_lum, ac_lum, dcY);
      }
      std::memcpy(blk, Cb, sizeof(blk));
      fdct8x8(blk);
      dcCb = encode_block(bw, blk, rchr, dc_chr, ac_chr, dcCb);
      std::memcpy(blk, Cr, sizeof(blk));
      fdct8x8(blk);
      dcCr = encode_block(bw, blk, rchr, dc_chr, ac_chr, dcCr);
    }
  }
  bw.flush();
}

}  // namespace detail

// RGBA (row-major, w*h*4 bytes, y-down) -> baseline JFIF bytes.
// quality in [1, 100], libjpeg semantics (90 ~ visually lossless).
// threads > 1 row-stripes the entropy coding over that many worker threads
// (restart-marker bands; see the header comment) — the encoder was the
// live-view bottleneck at 2048² (43 ms/frame single-threaded at q90 vs a
// 6.5 ms sim step).
inline std::vector<uint8_t> encode_jpeg(const uint8_t* rgba, int w, int h,
                                        int quality = 90, int threads = 1) {
  using namespace detail;
  std::vector<uint8_t> out;
  out.reserve(size_t(w) * h / 2 + 1024);

  // -- quality-scaled quantization tables (libjpeg jpeg_set_quality)
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  uint16_t qlum[64], qchr[64];
  for (int i = 0; i < 64; ++i) {
    int l = (kQuantLum[i] * scale + 50) / 100;
    int c = (kQuantChr[i] * scale + 50) / 100;
    qlum[i] = uint16_t(l < 1 ? 1 : (l > 255 ? 255 : l));
    qchr[i] = uint16_t(c < 1 ? 1 : (c > 255 ? 255 : c));
  }

  float rlum[64], rchr[64];
  make_recip(qlum, rlum);
  make_recip(qchr, rchr);

  HuffTable dc_lum, ac_lum, dc_chr, ac_chr;
  dc_lum.build(kDcLumBits, kDcLumVals);
  ac_lum.build(kAcLumBits, kAcLumVals);
  dc_chr.build(kDcChrBits, kDcChrVals);
  ac_chr.build(kAcChrBits, kAcChrVals);

  // -- headers
  out.push_back(0xFF);
  out.push_back(0xD8);  // SOI
  marker(out, 0xE0, 16);  // APP0 JFIF
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), jfif, jfif + 14);
  for (int t = 0; t < 2; ++t) {  // DQT x2 (zigzag order on the wire)
    marker(out, 0xDB, 67);
    out.push_back(uint8_t(t));
    const uint16_t* q = t == 0 ? qlum : qchr;
    for (int i = 0; i < 64; ++i) out.push_back(uint8_t(q[kZigzag[i]]));
  }
  marker(out, 0xC0, 17);  // SOF0: 8-bit, 3 components, 4:2:0
  out.push_back(8);
  put16(out, uint16_t(h));
  put16(out, uint16_t(w));
  out.push_back(3);
  const uint8_t sof_comp[] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  out.insert(out.end(), sof_comp, sof_comp + 9);
  struct {
    uint8_t cls_id;
    const uint8_t* bits;
    const uint8_t* vals;
    int n;
  } dhts[] = {{0x00, kDcLumBits, kDcLumVals, 12},
              {0x10, kAcLumBits, kAcLumVals, 162},
              {0x01, kDcChrBits, kDcChrVals, 12},
              {0x11, kAcChrBits, kAcChrVals, 162}};
  for (auto& d : dhts) {
    marker(out, 0xC4, uint16_t(2 + 1 + 16 + d.n));
    out.push_back(d.cls_id);
    for (int i = 1; i <= 16; ++i) out.push_back(d.bits[i]);
    out.insert(out.end(), d.vals, d.vals + d.n);
  }
  // -- band plan: whole MCU rows per thread; every band but the last holds
  // exactly rows_per_band rows, so one band == one restart interval (DRI's
  // 16-bit MCU count bounds rows_per_band from below)
  int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  int bands = 1;
  int rows_per_band = mcuy;
  if (threads > 1 && mcuy > 1) {
    int want = threads < mcuy ? threads : mcuy;
    rows_per_band = (mcuy + want - 1) / want;
    while (size_t(mcux) * rows_per_band > 0xFFFF) ++rows_per_band;
    if (rows_per_band < mcuy)
      bands = (mcuy + rows_per_band - 1) / rows_per_band;
  }
  if (bands > 1) {
    marker(out, 0xDD, 4);  // DRI: restart every band's worth of MCUs
    put16(out, uint16_t(mcux * rows_per_band));
  }

  marker(out, 0xDA, 12);  // SOS
  out.push_back(3);
  const uint8_t sos_comp[] = {1, 0x00, 2, 0x11, 3, 0x11};
  out.insert(out.end(), sos_comp, sos_comp + 6);
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  // -- entropy-coded 16x16 MCUs (4 Y + Cb + Cr), edge-replicated
  if (bands == 1) {
    encode_mcu_rows(rgba, w, h, 0, mcuy, rlum, rchr, dc_lum, ac_lum, dc_chr,
                    ac_chr, out);
  } else {
    std::vector<std::vector<uint8_t>> parts(bands);
    std::vector<std::thread> pool;
    pool.reserve(bands);
    for (int b = 0; b < bands; ++b) {
      int my0 = b * rows_per_band;
      int my1 = my0 + rows_per_band < mcuy ? my0 + rows_per_band : mcuy;
      parts[b].reserve(size_t(w) * 16 * rows_per_band / 4 + 64);
      pool.emplace_back([&, b, my0, my1] {
        encode_mcu_rows(rgba, w, h, my0, my1, rlum, rchr, dc_lum, ac_lum,
                        dc_chr, ac_chr, parts[b]);
      });
    }
    for (auto& t : pool) t.join();
    for (int b = 0; b < bands; ++b) {
      out.insert(out.end(), parts[b].begin(), parts[b].end());
      if (b != bands - 1) {  // RST0..7 between intervals, none before EOI
        out.push_back(0xFF);
        out.push_back(uint8_t(0xD0 + (b & 7)));
      }
    }
  }
  out.push_back(0xFF);
  out.push_back(0xD9);  // EOI
  return out;
}

}  // namespace jpegenc

#endif  // FLUIDS_JPEG_ENCODE_H_
