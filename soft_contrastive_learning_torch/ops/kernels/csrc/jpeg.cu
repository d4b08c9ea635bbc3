// JPEG decoding to OpenCV's bits for Hopper, sm_90a: J1, the pixel stage, a
// hand kernel, and the entropy decoder, host C++ in the same library.
//
// J1 replaces no pl.pallas_call site. It replaces libjpeg-turbo's host IDCT,
// upsampling and colour conversion, which the JAX package reaches through
// cv2.imread / cv2.imdecode (soft_contrastive_learning_tpu/utils/io.py
// load_img, serving.py _decode_image): the port's machine has no OpenCV, and
// the images it embeds are decoded here. The plain version, and the
// semantics, are soft_contrastive_learning_torch/utils/jpeg.py
// (pixels_plain): libjpeg's islow IDCT (jidctint.c, with the final range
// limit a clamp as libjpeg-turbo's SIMD code has it), its fancy upsampling
// (jdsample.c: h2v1, h1v2 and h2v2 triangle filters with their biases and
// repeated edges; sample repetition for other integral ratios and for
// components 2 samples wide or less) and its fixed-point YCbCr -> RGB
// (jdcolor.c, SCALEBITS 16), then OpenCV's EXIF orientation. J1 is bit-equal
// to it on every input: every step is integer arithmetic.
//
// Two launches, counted as one J1 launch by the wrapper:
//  (1) idct_kernel: 8 threads per 8x8 block, 32 blocks per 256-thread CTA.
//      Thread t of a block dequantizes column t and runs the column pass into
//      shared memory; after a warp barrier it runs the row pass of row t and
//      writes the row's 8 samples (one 8-byte store) into the component's
//      plane in device memory.
//  (2) pixel_kernel: one thread per output pixel. It maps the oriented pixel
//      back to the decoded one, reads each component's plane through its
//      upsampling filter (up to 4 plane bytes per component), converts the
//      colour and writes 3 bytes. Fancy upsampling reads neighbouring rows of
//      the planes, so it runs after (1) has written all of them.
// Bound on this card: bytes. A sample in costs a 2-byte coefficient (plus a
// 64-entry table per component), a pixel out 3 bytes: ~6 B a pixel at 4:2:0
// (0.26 MB for 180x240, 0.08 us at 3.35 TB/s; 7.4 MB for 1280x960, 2.2 us).
// The operations, ~30 integer multiply-adds a sample, are far below the
// card's rate. At 180x240 the two launches' fixed cost (~2-3 us each) is the
// time; the planes (1 B a sample) go through L2 between the launches. The
// design spends nothing on the small case beyond two launches, and keeps the
// large one to one pass over the coefficients and one over the planes.
//
// The entropy decoder (scl_jpeg_info, scl_jpeg_entropy) is host code: Huffman
// decoding is a serial bit stream, the part nvJPEG's hybrid mode also keeps on
// the host. It mirrors utils/jpeg.py's plain decoder (decode_coefficients) and
// gives the same coefficient buffer: each component's (bh, bw) blocks of 64
// int16 in natural order, one component after another. It refuses what that
// decoder refuses, with its reasons. Called through ctypes, it runs without the
// GIL, so the callers' decode threads run it in parallel.

#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <algorithm>
#include <string>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace {

constexpr int kGray = 0, kYcc = 1, kRgb = 2;
constexpr int kMaxComps = 3;

// zigzag position -> natural index, and 16 more entries at 63 (libjpeg's
// jpeg_natural_order: where corrupt data that runs past a block writes)
constexpr int kNat[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------------ geometry
// What both launches need of a component (passed by value in the launch).
struct J1Comp {
  int64_t block0;  // first block in the coefficient buffer
  int64_t plane0;  // first byte of its plane
  int bw, bh;      // blocks (the plane is bw*8 wide)
  int dw, dh;      // samples it holds
  int hr, vr;      // upsampling ratios
  int fancy;       // triangle filter (else repetition)
};

struct J1Geom {
  J1Comp c[kMaxComps];
  int ncomp, colour, orientation, height, width;
  int64_t blocks;  // all components'
};

// ------------------------------------------------------------------ IDCT
constexpr int kConstBits = 13, kPass1Bits = 2;

// one pass of jpeg_idct_islow over 8 inputs; outputs descaled by `shift`
HD void idct_1d(const long long* x, long long* out, int shift) {
  long long z2 = x[2], z3 = x[6];
  long long z1 = (z2 + z3) * 4433;
  long long tmp2 = z1 - z3 * 15137;
  long long tmp3 = z1 + z2 * 6270;
  long long tmp0 = (x[0] + x[4]) * (1LL << kConstBits);
  long long tmp1 = (x[0] - x[4]) * (1LL << kConstBits);
  long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  long long t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  long long a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  long long z5 = (a3 + a4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  a1 *= -7373;
  a2 *= -20995;
  a3 = a3 * -16069 + z5;
  a4 = a4 * -3196 + z5;
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  const long long half = 1LL << (shift - 1);
  out[0] = (tmp10 + t3 + half) >> shift;
  out[1] = (tmp11 + t2 + half) >> shift;
  out[2] = (tmp12 + t1 + half) >> shift;
  out[3] = (tmp13 + t0 + half) >> shift;
  out[4] = (tmp13 - t0 + half) >> shift;
  out[5] = (tmp12 - t1 + half) >> shift;
  out[6] = (tmp11 - t2 + half) >> shift;
  out[7] = (tmp10 - t3 + half) >> shift;
}

// the column pass of column `col` of a block: dequantized inputs down the
// column, outputs (one per row) into ws[row * 8 + col]
HD void idct_column(const int16_t* blk, const int32_t* q, int col, long long* ws) {
  long long x[8], o[8];
  for (int k = 0; k < 8; ++k) x[k] = (long long)blk[k * 8 + col] * q[k * 8 + col];
  idct_1d(x, o, kConstBits - kPass1Bits);
  for (int k = 0; k < 8; ++k) ws[k * 8 + col] = o[k];
}

// the row pass of row `row`: 8 samples, range-limited
HD void idct_row(const long long* ws, int row, uint8_t* out) {
  long long o[8];
  idct_1d(ws + row * 8, o, kConstBits + kPass1Bits + 3);
  for (int k = 0; k < 8; ++k) {
    long long v = o[k] + 128;
    out[k] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

// ------------------------------------------------------------------ pixels
HD int plane_at(const uint8_t* planes, const J1Comp& k, int r, int c) {
  return planes[k.plane0 + (int64_t)r * (k.bw * 8) + c];
}

// component k's value at decoded pixel (r, c), through its upsampling
HD int upsampled(const uint8_t* planes, const J1Comp& k, int r, int c) {
  if (k.hr == 1 && k.vr == 1) return plane_at(planes, k, r, c);
  if (!k.fancy) return plane_at(planes, k, r / k.vr, c / k.hr);
  if (k.vr == 1) {  // h2v1
    int j = c >> 1, x = 3 * plane_at(planes, k, r, j);
    if (c & 1) return (x + plane_at(planes, k, r, j + 1 < k.dw ? j + 1 : j) + 2) >> 2;
    return (x + plane_at(planes, k, r, j > 0 ? j - 1 : 0) + 1) >> 2;
  }
  int i = r >> 1;
  int ni = (r & 1) ? (i + 1 < k.dh ? i + 1 : i) : (i > 0 ? i - 1 : 0);
  if (k.hr == 1) {  // h1v2
    return (3 * plane_at(planes, k, i, c) + plane_at(planes, k, ni, c) + ((r & 1) ? 2 : 1)) >> 2;
  }
  int j = c >> 1;  // h2v2
  int nj = (c & 1) ? (j + 1 < k.dw ? j + 1 : j) : (j > 0 ? j - 1 : 0);
  int near_sum = 3 * plane_at(planes, k, i, j) + plane_at(planes, k, ni, j);
  int far_sum = 3 * plane_at(planes, k, i, nj) + plane_at(planes, k, ni, nj);
  return (3 * near_sum + far_sum + ((c & 1) ? 7 : 8)) >> 4;
}

HD uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// the RGB of output pixel (oy, ox): the decoded pixel it shows (OpenCV's
// EXIF transform), upsampled and colour-converted
HD void pixel(const uint8_t* planes, const J1Geom& g, int oy, int ox, uint8_t* rgb) {
  const int h = g.height, w = g.width;
  int r, c;
  switch (g.orientation) {
    case 2: r = oy; c = w - 1 - ox; break;
    case 3: r = h - 1 - oy; c = w - 1 - ox; break;
    case 4: r = h - 1 - oy; c = ox; break;
    case 5: r = ox; c = oy; break;
    case 6: r = h - 1 - ox; c = oy; break;
    case 7: r = h - 1 - ox; c = w - 1 - oy; break;
    case 8: r = ox; c = w - 1 - oy; break;
    default: r = oy; c = ox; break;
  }
  int v0 = upsampled(planes, g.c[0], r, c);
  if (g.colour == kGray) {
    rgb[0] = rgb[1] = rgb[2] = (uint8_t)v0;
    return;
  }
  int v1 = upsampled(planes, g.c[1], r, c), v2 = upsampled(planes, g.c[2], r, c);
  if (g.colour == kRgb) {
    rgb[0] = (uint8_t)v0;
    rgb[1] = (uint8_t)v1;
    rgb[2] = (uint8_t)v2;
    return;
  }
  // jdcolor.c: FIX(1.40200) 91881, FIX(1.77200) 116130, FIX(0.71414) 46802,
  // FIX(0.34414) 22554, ONE_HALF 1 << 15; arithmetic right shifts
  const long long cb = v1 - 128, cr = v2 - 128, half = 1LL << 15;
  int cr_r = (int)((91881 * cr + half) >> 16);
  int cb_b = (int)((116130 * cb + half) >> 16);
  int g_off = (int)((-22554 * cb + half - 46802 * cr) >> 16);
  rgb[0] = clamp255(v0 + cr_r);
  rgb[1] = clamp255(v0 + g_off);
  rgb[2] = clamp255(v0 + cb_b);
}

HD int find_comp(const J1Geom& g, int64_t blk) {
  int ci = 0;
  while (ci + 1 < g.ncomp && blk >= g.c[ci + 1].block0) ++ci;
  return ci;
}

#ifdef __CUDACC__
constexpr int kThreads = 256;
constexpr int kBlocksPerCta = kThreads / 8;

__global__ void __launch_bounds__(kThreads) idct_kernel(const int16_t* __restrict__ coefs,
                                                        const int32_t* __restrict__ quant,
                                                        uint8_t* __restrict__ planes, J1Geom g) {
  __shared__ long long ws[kBlocksPerCta][64];
  const int lane = threadIdx.x & 7, local = threadIdx.x >> 3;
  const int64_t blk = (int64_t)blockIdx.x * kBlocksPerCta + local;
  const bool active = blk < g.blocks;
  int ci = 0;
  if (active) {
    ci = find_comp(g, blk);
    idct_column(coefs + blk * 64, quant + ci * 64, lane, ws[local]);
  }
  __syncwarp();
  if (active) {
    const J1Comp& k = g.c[ci];
    const int64_t b = blk - k.block0;
    const int by = (int)(b / k.bw), bx = (int)(b % k.bw);
    uint8_t row[8];
    idct_row(ws[local], lane, row);
    uint2 packed;
    memcpy(&packed, row, 8);
    *reinterpret_cast<uint2*>(planes + k.plane0 + (int64_t)(by * 8 + lane) * (k.bw * 8) + bx * 8) =
        packed;
  }
}

__global__ void __launch_bounds__(kThreads) pixel_kernel(const uint8_t* __restrict__ planes,
                                                         uint8_t* __restrict__ out, J1Geom g,
                                                         int out_w, int64_t pixels) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= pixels) return;
  uint8_t rgb[3];
  pixel(planes, g, (int)(i / out_w), (int)(i % out_w), rgb);
  out[i * 3] = rgb[0];
  out[i * 3 + 1] = rgb[1];
  out[i * 3 + 2] = rgb[2];
}
#endif

// ------------------------------------------------------------------ entropy
struct Comp {
  int cid, h, v, tq, dw, dh, bw, bh;
};

// a Huffman table as libjpeg derives it: a 9-bit lookahead, then the
// canonical code's maxcode / value offsets for longer codes
struct Huff {
  bool defined = false;
  uint16_t look[512];  // (length << 8) | symbol for codes of <= 9 bits, else 0
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t vals[256];
};

struct Fail {
  std::string what;
};

// the frame types refused, as utils/jpeg.py's _SOF_REFUSED names them
const char* refused_frame(int code) {
  switch (code) {
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "hierarchical (SOF5)";
    case 0xC6: return "hierarchical progressive (SOF6)";
    case 0xC7: return "hierarchical lossless (SOF7)";
    case 0xC9: return "arithmetic-coded (SOF9)";
    case 0xCA: return "arithmetic-coded progressive (SOF10)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded hierarchical (SOF13)";
    case 0xCE: return "arithmetic-coded hierarchical progressive (SOF14)";
    case 0xCF: return "arithmetic-coded hierarchical lossless (SOF15)";
    default: return nullptr;
  }
}

[[noreturn]] void fail(const std::string& what) { throw Fail{what}; }

struct Scan {
  int ns, comps[4], td[4], ta[4], ss, se, ah, al, restart;
};

struct Decoder {
  const uint8_t* d;
  int64_t n;
  int16_t* coefs = nullptr;  // null: parse the header only
  int height = 0, width = 0, ncomp = 0, colour = kYcc, orientation = 1;
  bool progressive = false, seen_sof = false, saw_jfif = false, saw_exif = false;
  int adobe = -1;
  int restart = 0;
  int nscans = 0;
  Comp comps[kMaxComps];
  int64_t block0[kMaxComps + 1];
  int32_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  int32_t latched[kMaxComps][64];
  bool is_latched[kMaxComps] = {false, false, false};
  int coef_bits[kMaxComps][64];
  Huff dc[4], ac[4];

  // bit reader over the entropy data at `pos`; zeros after a marker or the end
  int64_t pos = 0;
  uint64_t acc = 0;
  int nb = 0;
  int64_t fed = 0, real_fed = 0;
  bool at_marker = false, hit_eof = false;

  Decoder(const uint8_t* data, int64_t size) : d(data), n(size) {}

  int hmax() const {
    int m = 1;
    for (int i = 0; i < ncomp; ++i) m = std::max(m, comps[i].h);
    return m;
  }
  int vmax() const {
    int m = 1;
    for (int i = 0; i < ncomp; ++i) m = std::max(m, comps[i].v);
    return m;
  }

  void fill() {
    while (nb <= 56) {
      int byte = 0;
      if (!at_marker && pos < n) {
        if (d[pos] != 0xFF) {
          byte = d[pos++];
          real_fed += 8;
        } else {
          int64_t j = pos + 1;
          while (j < n && d[j] == 0xFF) ++j;
          if (j >= n) {
            at_marker = true;
            hit_eof = true;
          } else if (d[j] == 0) {
            byte = 0xFF;
            pos = j + 1;
            real_fed += 8;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
          }
        }
      } else if (!at_marker) {
        at_marker = true;
        hit_eof = true;
      }
      acc |= (uint64_t)byte << (56 - nb);
      nb += 8;
      fed += 8;
    }
  }
  uint32_t peek16() {
    if (nb < 16) fill();
    return (uint32_t)(acc >> 48);
  }
  void skip(int k) {
    acc <<= k;
    nb -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    if (nb < k) fill();
    int v = (int)(acc >> (64 - k));
    skip(k);
    return v;
  }
  int receive(int s) {  // s bits, sign-extended (HUFF_EXTEND)
    int v = get(s);
    return v >= (1 << (s - 1)) ? v : v - (1 << s) + 1;
  }
  int huff(const Huff& t) {
    uint32_t w = peek16();
    int e = t.look[w >> 7];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int32_t code = (int32_t)(w >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[code + t.valoff[l]];
      }
    }
    fail("JPEG entropy data is corrupt (a bad Huffman code)");
  }
  void reset_bits(int64_t at) {
    pos = at;
    acc = 0;
    nb = 0;
    fed = real_fed = 0;
    at_marker = hit_eof = false;
  }
  bool overran() const { return fed - nb > real_fed; }
  // after an interval: the position of the next marker (skipping what is left
  // of the entropy data), and its code, or -1 at the end of the file
  int next_marker(int64_t* at) {
    int64_t p = pos;
    while (true) {
      while (p < n && d[p] != 0xFF) ++p;
      int64_t j = p + 1;
      while (j < n && d[j] == 0xFF) ++j;
      if (j >= n) {
        *at = n;
        return -1;
      }
      if (d[j] == 0) {
        p = j + 1;
        continue;
      }
      *at = j - 1;
      return d[j];
    }
  }

  void build_huff(Huff& t, const uint8_t* counts, const uint8_t* syms, int total) {
    memset(t.look, 0, sizeof t.look);
    memcpy(t.vals, syms, total);
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      t.valoff[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i) {
        if (code >= (1 << l)) fail("JPEG Huffman table is over-subscribed (corrupt)");
        if (l <= 9) {
          int lo = code << (9 - l);
          for (int f = 0; f < (1 << (9 - l)); ++f) t.look[lo + f] = (uint16_t)((l << 8) | syms[k]);
        }
        ++code;
        ++k;
      }
      t.maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    t.maxcode[17] = 0x7FFFFFFF;
    t.defined = true;
  }

  static int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

  void parse_sof(int code, const uint8_t* b, int len) {
    if (len < 6) fail("JPEG frame header is short (corrupt)");
    int precision = b[0];
    height = u16(b + 1);
    width = u16(b + 3);
    int nc = b[5];
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG; the port decodes 8-bit samples only");
    if (height == 0 || width == 0)
      fail("JPEG frame of " + std::to_string(width) + "x" + std::to_string(height) +
           " (a DNL height, or corrupt)");
    if (nc != 1 && nc != 3) {
      std::string what = nc == 4 ? "CMYK/YCCK" : std::to_string(nc) + "-component";
      fail(what + " JPEG; the port decodes gray and 3-component JPEG only");
    }
    if (len != 6 + 3 * nc) fail("JPEG frame header has the wrong length (corrupt)");
    progressive = code == 0xC2;
    ncomp = nc;
    for (int i = 0; i < nc; ++i) {
      Comp& c = comps[i];
      c.cid = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (!(c.h >= 1 && c.h <= 4 && c.v >= 1 && c.v <= 4) || c.tq > 3)
        fail("JPEG component sampling " + std::to_string(c.h) + "x" + std::to_string(c.v) +
             " / table " + std::to_string(c.tq) + " (corrupt)");
    }
    int hm = hmax(), vm = vmax();
    block0[0] = 0;
    for (int i = 0; i < nc; ++i) {
      Comp& c = comps[i];
      if (hm % c.h || vm % c.v)
        fail("JPEG with fractional sampling (" + std::to_string(c.h) + "x" +
             std::to_string(c.v) + " against " + std::to_string(hm) + "x" + std::to_string(vm) +
             "); libjpeg refuses it too");
      c.dw = (width * c.h + hm - 1) / hm;
      c.dh = (height * c.v + vm - 1) / vm;
      if (nc == 1) {
        c.bw = (c.dw + 7) / 8;
        c.bh = (c.dh + 7) / 8;
      } else {
        c.bw = (width + 8 * hm - 1) / (8 * hm) * c.h;
        c.bh = (height + 8 * vm - 1) / (8 * vm) * c.v;
      }
      block0[i + 1] = block0[i] + (int64_t)c.bw * c.bh;
    }
    if (nc == 1)
      colour = kGray;
    else
      colour = (comps[0].cid == 82 && comps[1].cid == 71 && comps[2].cid == 66) ? kRgb : kYcc;
  }

  Scan parse_sos(const uint8_t* b, int len) {
    if (len < 1) fail("JPEG scan header is empty (corrupt)");
    Scan s;
    s.ns = b[0];
    if (s.ns < 1 || s.ns > 4 || len != 4 + 2 * s.ns)
      fail("JPEG scan header has the wrong length (corrupt)");
    int blocks = 0;
    for (int i = 0; i < s.ns; ++i) {
      int cid = b[1 + 2 * i], found = -1;
      for (int c = 0; c < ncomp; ++c)
        if (comps[c].cid == cid) {
          found = c;
          break;
        }
      for (int k = 0; k < i; ++k)
        if (s.comps[k] == found) found = -1;
      if (found < 0)
        fail("JPEG scan names component " + std::to_string(cid) + " wrongly (corrupt)");
      s.comps[i] = found;
      s.td[i] = b[2 + 2 * i] >> 4;
      s.ta[i] = b[2 + 2 * i] & 15;
      blocks += comps[found].h * comps[found].v;
    }
    s.ss = b[1 + 2 * s.ns];
    s.se = b[2 + 2 * s.ns];
    s.ah = b[3 + 2 * s.ns] >> 4;
    s.al = b[3 + 2 * s.ns] & 15;
    if (progressive) {
      bool bad = (s.ss == 0 && s.se != 0) || (s.ss > 0 && (s.se < s.ss || s.se > 63 || s.ns != 1));
      if (bad || (s.ah && s.al != s.ah - 1) || s.al > 13)
        fail("JPEG progressive scan parameters Ss=" + std::to_string(s.ss) +
             " Se=" + std::to_string(s.se) + " Ah=" + std::to_string(s.ah) +
             " Al=" + std::to_string(s.al) + " are invalid (corrupt)");
    } else if (s.ss != 0 || s.se != 63 || s.ah || s.al) {
      s.ss = 0;  // libjpeg ignores these in a sequential frame
      s.se = 63;
      s.ah = s.al = 0;
    }
    if (blocks > 10 && s.ns > 1) fail("JPEG MCU of more than 10 blocks (corrupt)");
    s.restart = restart;
    return s;
  }

  // decode one scan's entropy data from `pos`; on return pos is the marker
  // that ends it
  void decode_scan(const Scan& s) {
    int64_t n_mcu, mx = 1;
    int cbw = 0, cbh = 0;
    const int hm = hmax(), vm = vmax();
    if (s.ns == 1) {
      const Comp& c = comps[s.comps[0]];
      cbw = (c.dw + 7) / 8;
      cbh = (c.dh + 7) / 8;
      n_mcu = (int64_t)cbw * cbh;
    } else {
      mx = (width + 8 * hm - 1) / (8 * hm);
      n_mcu = mx * ((height + 8 * vm - 1) / (8 * vm));
    }
    const int64_t per = s.restart ? s.restart : n_mcu;
    const int64_t intervals = (n_mcu + per - 1) / per;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    for (int64_t iv = 0; iv < intervals; ++iv) {
      reset_bits(pos);
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
      const int64_t m_end = std::min(n_mcu, (iv + 1) * per);
      for (int64_t m = iv * per; m < m_end; ++m) {
        if (s.ns == 1) {
          const Comp& c = comps[s.comps[0]];
          int64_t blk = block0[s.comps[0]] + (m / cbw) * c.bw + m % cbw;
          decode_block(s, 0, blk, pred, eobrun);
        } else {
          const int64_t my_ = m / mx, mx_ = m % mx;
          for (int k = 0; k < s.ns; ++k) {
            const Comp& c = comps[s.comps[k]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                int64_t blk =
                    block0[s.comps[k]] + (my_ * c.v + y) * c.bw + mx_ * c.h + x;
                decode_block(s, k, blk, pred, eobrun);
              }
          }
        }
      }
      if (overran())
        fail(std::string("JPEG entropy data ends before the scan does (") +
             (hit_eof && iv == intervals - 1 ? "truncated" : "corrupt") + ")");
      int64_t at;
      int code = next_marker(&at);
      if (iv < intervals - 1) {
        if (code < 0xD0 || code > 0xD7)
          fail("JPEG scan ends after " + std::to_string(iv + 1) + " of its " +
               std::to_string(intervals) + " restart intervals (truncated)");
        if (code - 0xD0 != iv % 8)
          fail("JPEG restart marker RST" + std::to_string(code - 0xD0) + " where RST" +
               std::to_string(iv % 8) + " belongs (corrupt)");
        pos = at + 2;
      } else {
        // restart markers after the last interval must hold no data
        while (code >= 0xD0 && code <= 0xD7) {
          const int64_t p = at + 2;
          pos = p;
          code = next_marker(&at);
          for (int64_t q = p; q < at; ++q)
            if (d[q] != 0xFF)
              fail("JPEG scan has entropy data past its last restart interval (corrupt)");
        }
        pos = at;
      }
    }
  }

  void decode_block(const Scan& s, int k, int64_t blk, int* pred, int& eobrun) {
    int16_t* out = coefs + blk * 64;
    if (!progressive) {
      int t = huff(dc[s.td[k]]);
      if (t > 15) fail("JPEG entropy data is corrupt (a DC difference of more than 15 bits)");
      if (t) pred[k] += receive(t);
      out[0] = (int16_t)pred[k];
      const Huff& a = ac[s.ta[k]];
      for (int i = 1; i < 64; ++i) {
        int rs = huff(a), r = rs >> 4, sz = rs & 15;
        if (sz) {
          i += r;
          out[kNat[i]] = (int16_t)receive(sz);
        } else {
          if (r != 15) break;
          i += 15;
        }
      }
      return;
    }
    if (s.ss == 0) {
      if (s.ah == 0) {
        int t = huff(dc[s.td[k]]);
        if (t > 15) fail("JPEG entropy data is corrupt (a DC difference of more than 15 bits)");
        if (t) pred[k] += receive(t);
        out[0] = (int16_t)(pred[k] * (1 << s.al));
      } else if (get(1)) {
        out[0] = (int16_t)(out[0] | (1 << s.al));
      }
      return;
    }
    const Huff& a = ac[s.ta[0]];
    if (s.ah == 0) {  // AC first
      if (eobrun) {
        --eobrun;
        return;
      }
      for (int i = s.ss; i <= s.se; ++i) {
        int rs = huff(a), r = rs >> 4, sz = rs & 15;
        if (sz) {
          i += r;
          out[kNat[i]] = (int16_t)(receive(sz) * (1 << s.al));
        } else if (r == 15) {
          i += 15;
        } else {
          eobrun = (1 << r) + get(r) - 1;
          break;
        }
      }
      return;
    }
    // AC refine
    const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
    int i = s.ss;
    if (eobrun == 0) {
      for (; i <= s.se; ++i) {
        int rs = huff(a), r = rs >> 4, sz = rs & 15;
        if (sz) {
          if (sz != 1)
            fail("JPEG entropy data is corrupt (a refinement coefficient of more than one bit)");
          sz = get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = (1 << r) + get(r);
          break;
        }
        do {
          int16_t* c = out + kNat[i];
          if (*c) {
            if (get(1) && !(*c & p1)) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= s.se);
        if (sz) out[kNat[i]] = (int16_t)sz;
      }
    }
    if (eobrun > 0) {
      for (; i <= s.se; ++i) {
        int16_t* c = out + kNat[i];
        if (*c && get(1) && !(*c & p1)) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
      }
      --eobrun;
    }
  }

  // libjpeg's coef_bits bookkeeping for a progressive scan (utils/jpeg.py
  // _check_progression)
  void track_progression(const Scan& s) {
    for (int k = 0; k < s.ns; ++k) {
      int* row = coef_bits[s.comps[k]];
      if (s.ss > 0 && row[0] < 0) fail("JPEG progression sends AC before DC (corrupt)");
      for (int i = s.ss; i <= s.se; ++i) {
        if ((row[i] < 0 ? 0 : row[i]) != s.ah)
          fail("JPEG progression refines bits not sent (corrupt)");
        row[i] = s.al;
      }
    }
  }
  void check_smoothing() {
    static const int kFirst[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool quant_ok = true, dc_known = true, unfinished = false;
    for (int c = 0; c < ncomp; ++c) {
      for (int i = 0; i < 10; ++i)
        if (!is_latched[c] || latched[c][kFirst[i]] == 0) quant_ok = false;
      if (coef_bits[c][0] < 0) dc_known = false;
      for (int i = 1; i < 10; ++i)
        if (coef_bits[c][i] != 0) unfinished = true;
    }
    if (quant_ok && dc_known && unfinished)
      fail("progressive JPEG whose scans stop before its first coefficients are whole; libjpeg "
           "smooths such blocks and the port does not");
  }

  // walk the markers; with coefs null stop at the first scan
  void run() {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) fail("not a JPEG file");
    for (int c = 0; c < kMaxComps; ++c)
      for (int i = 0; i < 64; ++i) coef_bits[c][i] = -1;
    int64_t p = 2;
    while (true) {
      if (p >= n) {
        if (!nscans) fail("JPEG ends before its first scan (truncated)");
        break;  // no EOI after the last scan: libjpeg reads on as cv2 does
      }
      if (d[p] != 0xFF) fail("JPEG marker expected at byte " + std::to_string(p) + " (corrupt)");
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n) fail("JPEG truncated in a marker");
      int code = d[p++];
      if (code == 0xD9) {
        if (!nscans) fail("JPEG has no scan");
        break;
      }
      if (code == 0xD8 || code == 0x01 || (code >= 0xD0 && code <= 0xD7)) continue;
      if (p + 2 > n) fail("JPEG truncated in a marker segment");
      int length = u16(d + p);
      if (length < 2 || p + length > n) {
        char hex[8];
        snprintf(hex, sizeof hex, "%02X", code);
        fail(std::string("JPEG truncated in marker 0x") + hex + "'s segment");
      }
      const uint8_t* b = d + p + 2;
      const int len = length - 2;
      p += length;
      if (const char* what = refused_frame(code))
        fail(std::string(what) + " JPEG; the port decodes baseline, extended and progressive "
             "Huffman JPEG only");
      if (code == 0xC0 || code == 0xC1 || code == 0xC2) {
        if (seen_sof) fail("JPEG has two frame headers (corrupt)");
        seen_sof = true;
        parse_sof(code, b, len);
      } else if (code == 0xC4) {
        int at = 0;
        while (at < len) {
          if (at + 17 > len) fail("JPEG DHT segment is short (corrupt)");
          int tc = b[at] >> 4, th = b[at] & 15, total = 0;
          for (int i = 0; i < 16; ++i) total += b[at + 1 + i];
          if (tc > 1 || th > 3 || at + 17 + total > len || total > 256)
            fail("JPEG DHT segment is malformed (corrupt)");
          build_huff(tc == 0 ? dc[th] : ac[th], b + at + 1, b + at + 17, total);
          at += 17 + total;
        }
      } else if (code == 0xDB) {
        int at = 0;
        while (at < len) {
          int pq = b[at] >> 4, tq = b[at] & 15, size = pq ? 128 : 64;
          if (pq > 1 || tq > 3 || at + 1 + size > len)
            fail("JPEG DQT segment is malformed (corrupt)");
          for (int k = 0; k < 64; ++k)
            quant[tq][kNat[k]] = pq ? u16(b + at + 1 + 2 * k) : b[at + 1 + k];
          quant_defined[tq] = true;
          at += 1 + size;
        }
      } else if (code == 0xDD) {
        if (len != 2) fail("JPEG DRI segment is malformed (corrupt)");
        restart = u16(b);
      } else if (code == 0xDA) {
        if (!seen_sof) fail("JPEG scan before its frame header (corrupt)");
        Scan s = parse_sos(b, len);
        for (int k = 0; k < s.ns; ++k) {
          int ci = s.comps[k];
          if (!is_latched[ci]) {
            int tq = comps[ci].tq;
            if (!quant_defined[tq])
              fail("JPEG component uses quantization table " + std::to_string(tq) +
                   ", which the file does not define (corrupt)");
            memcpy(latched[ci], quant[tq], sizeof latched[ci]);
            is_latched[ci] = true;
          }
          bool need_dc = s.ss == 0 && s.ah == 0, need_ac = s.se > 0;
          if ((need_dc && (s.td[k] > 3 || !dc[s.td[k]].defined)) ||
              (need_ac && (s.ta[k] > 3 || !ac[s.ta[k]].defined)))
            fail("JPEG scan names a Huffman table the file does not define; the port has no "
                 "default tables");
        }
        if (!coefs) return;  // the header: enough for the geometry
        if (progressive) track_progression(s);
        pos = p;
        decode_scan(s);
        p = pos;
        ++nscans;
      } else if ((code == 0xE0 || code == 0xE1 || code == 0xEE) && nscans) {
        // libjpeg settles the colour and saves the Exif before the first scan
      } else if (code == 0xE0) {
        if (len >= 14 && !memcmp(b, "JFIF\0", 5)) saw_jfif = true;
      } else if (code == 0xE1) {
        if (len >= 6 && !memcmp(b, "Exif\0\0", 6) && !saw_exif) {
          saw_exif = true;
          orientation = exif_orientation(b + 6, len - 6);
        }
      } else if (code == 0xEE) {
        if (len >= 12 && !memcmp(b, "Adobe", 5)) adobe = b[11];
      } else if (code == 0xDC) {
        fail("JPEG with a DNL marker; the port decodes frames that state their height");
      } else if ((code >= 0xC0 && code <= 0xCF) || code == 0xDE || code == 0xDF) {
        char hex[8];
        snprintf(hex, sizeof hex, "%02X", code);
        fail(std::string("JPEG marker 0x") + hex + " is not supported");
      }
    }
    if (!coefs) fail("JPEG has no scan");
    if (progressive) check_smoothing();
    for (int c = 0; c < ncomp; ++c)
      if (!is_latched[c])
        fail("JPEG component " + std::to_string(comps[c].cid) + " is in no scan (corrupt)");
  }

  void settle_colour() {
    if (ncomp == 3 && !saw_jfif && adobe >= 0) colour = adobe == 0 ? kRgb : kYcc;
    else if (ncomp == 3 && saw_jfif) colour = kYcc;
  }

  static int exif_orientation(const uint8_t* t, int len) {
    if (len < 8) return 1;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 1;
    auto rd16 = [&](int at) { return le ? t[at] | (t[at + 1] << 8) : (t[at] << 8) | t[at + 1]; };
    auto rd32 = [&](int at) -> uint32_t {
      return le ? (uint32_t)t[at] | ((uint32_t)t[at + 1] << 8) | ((uint32_t)t[at + 2] << 16) |
                      ((uint32_t)t[at + 3] << 24)
                : ((uint32_t)t[at] << 24) | ((uint32_t)t[at + 1] << 16) |
                      ((uint32_t)t[at + 2] << 8) | (uint32_t)t[at + 3];
    };
    if (rd16(2) != 42) return 1;
    uint32_t ifd = rd32(4);
    if ((int64_t)ifd + 2 > len) return 1;
    int count = rd16(ifd);
    for (int i = 0; i < count; ++i) {
      int64_t at = ifd + 2 + 12 * (int64_t)i;
      if (at + 4 > len) return 1;
      if (rd16(at) == 0x0112) {
        if (rd16(at + 2) != 3 || at + 10 > len) return 1;
        int v = rd16(at + 8);
        return v >= 1 && v <= 8 ? v : 1;
      }
    }
    return 1;
  }
};

void copy_error(const std::string& what, char* err, int errlen) {
  if (errlen <= 0) return;
  size_t k = std::min((size_t)errlen - 1, what.size());
  memcpy(err, what.data(), k);
  err[k] = 0;
}

void write_info(const Decoder& dec, int32_t* info) {
  // [H, W, ncomp, colour, orientation, progressive,
  //  per component: cid, h, v, tq, dw, dh, bw, bh]
  info[0] = dec.height;
  info[1] = dec.width;
  info[2] = dec.ncomp;
  info[3] = dec.colour;
  info[4] = dec.orientation;
  info[5] = dec.progressive;
  for (int c = 0; c < dec.ncomp; ++c) {
    const Comp& k = dec.comps[c];
    int32_t* o = info + 6 + 8 * c;
    o[0] = k.cid;
    o[1] = k.h;
    o[2] = k.v;
    o[3] = k.tq;
    o[4] = k.dw;
    o[5] = k.dh;
    o[6] = k.bw;
    o[7] = k.bh;
  }
}

}  // namespace

extern "C" {

// The frame's geometry from the markers before the first scan (info: 30
// int32, layout in write_info). 0, or 1 with the reason in err.
int scl_jpeg_info(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.run();
    dec.settle_colour();
    write_info(dec, info);
    return 0;
  } catch (const Fail& f) {
    copy_error(f.what, err, errlen);
    return 1;
  } catch (...) {
    copy_error("JPEG decoder failed", err, errlen);
    return 1;
  }
}

// Every scan's coefficients into `coefs` (zeroed by the caller, sized by
// scl_jpeg_info: each component's bw*bh*64 int16 in turn) and each
// component's latched table into `quant` (ncomp x 64 int32, natural order).
int scl_jpeg_entropy(const uint8_t* data, int64_t n, int16_t* coefs, int32_t* quant,
                     int32_t* info, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.coefs = coefs;
    dec.run();
    dec.settle_colour();
    write_info(dec, info);
    for (int c = 0; c < dec.ncomp; ++c)
      memcpy(quant + 64 * c, dec.latched[c], 64 * sizeof(int32_t));
    return 0;
  } catch (const Fail& f) {
    copy_error(f.what, err, errlen);
    return 1;
  } catch (...) {
    copy_error("JPEG decoder failed", err, errlen);
    return 1;
  }
}

#ifdef __CUDACC__
const char* scl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int scl_jpeg_threads(void) { return kThreads; }

// J1: coefs (blocks x 64 int16) and quant (ncomp x 64 int32) on the card ->
// planes (scratch, sum of bw*8 x bh*8 bytes) -> out (out_h x out_w x 3 uint8).
// comp: ncomp x 9 int64 (block0, plane0, bw, bh, dw, dh, hr, vr, fancy).
int scl_jpeg_pixels(const void* coefs, const void* quant, void* planes, void* out,
                    const int64_t* comp, int ncomp, int colour, int orientation, int height,
                    int width, int64_t blocks, void* stream) {
  J1Geom g;
  memset(&g, 0, sizeof g);
  g.ncomp = ncomp;
  g.colour = colour;
  g.orientation = orientation;
  g.height = height;
  g.width = width;
  g.blocks = blocks;
  for (int c = 0; c < ncomp; ++c) {
    const int64_t* k = comp + 9 * c;
    g.c[c] = J1Comp{k[0], k[1], (int)k[2], (int)k[3], (int)k[4], (int)k[5], (int)k[6], (int)k[7],
                    (int)k[8]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ctas = (blocks + kBlocksPerCta - 1) / kBlocksPerCta;
  idct_kernel<<<(unsigned)ctas, kThreads, 0, s>>>(static_cast<const int16_t*>(coefs),
                                                 static_cast<const int32_t*>(quant),
                                                 static_cast<uint8_t*>(planes), g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int out_w = orientation >= 5 ? height : width;
  const int64_t pixels = (int64_t)height * width;
  pixel_kernel<<<(unsigned)((pixels + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(planes), static_cast<uint8_t*>(out), g, out_w, pixels);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
