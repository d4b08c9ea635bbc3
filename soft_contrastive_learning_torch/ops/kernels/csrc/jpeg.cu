// JPEG decoding to OpenCV's bits for Hopper, sm_90a: J1, the pixel stage, a
// hand kernel, and the entropy decoder, host C++ in the same library.
//
// J1 replaces no pl.pallas_call site. It replaces libjpeg-turbo's host block
// smoothing, IDCT, upsampling and colour conversion, which the JAX package
// reaches through cv2.imread / cv2.imdecode (soft_contrastive_learning_tpu/
// utils/io.py load_img, serving.py _decode_image): the port's machine has no
// OpenCV, and the images it embeds are decoded here. The plain version, and
// the semantics, are soft_contrastive_learning_torch/utils/jpeg.py
// (pixels_plain): libjpeg-turbo 2.1+'s block smoothing of an incomplete
// progressive image (jdcoefct.c decompress_smooth_data), its islow IDCT
// (jidctint.c, with the final range limit a clamp as libjpeg-turbo's SIMD
// code has it), its fancy upsampling (jdsample.c: h2v1, h1v2 and h2v2
// triangle filters with their biases and repeated edges; sample repetition
// for other integral ratios and for components 2 samples wide or less), its
// fixed-point YCbCr -> RGB and YCCK -> CMYK (jdcolor.c, SCALEBITS 16) and
// OpenCV's CMYK -> BGR (icvCvt_CMYK2BGR_8u_C4C3R), then OpenCV's EXIF
// orientation. J1 is bit-equal to it on every input: every step is integer
// arithmetic.
//
// Two launches, counted as one J1 launch by the wrapper:
//  (1) idct_kernel: 8 threads per 8x8 block, 32 blocks per 256-thread CTA.
//      Thread t of a block loads column t's coefficients, dequantizes and
//      runs the column pass into shared memory (in the instantiation for a
//      smoothed frame, threads 0-3 first replace the column's entries among
//      the first ten coefficients by their estimates from the DC values of
//      the 5x5 blocks around, read from the coefficient buffer; the plain
//      instantiation carries none of that code or its registers); after a warp barrier it runs
//      the row pass of row t and writes the row's 8 samples (one 8-byte
//      store) into the component's plane in device memory.
//  (2) pixel_kernel: one thread per output pixel. It maps the oriented pixel
//      back to the decoded one, reads each component's plane through its
//      upsampling filter (up to 4 plane bytes per component), converts the
//      colour and writes 3 bytes. Fancy upsampling reads neighbouring rows of
//      the planes, so it runs after (1) has written all of them.
// Bound on this card: bytes. A sample in costs a 2-byte coefficient (plus a
// 64-entry table per component), a pixel out 3 bytes: ~6 B a pixel at 4:2:0
// (0.26 MB for 180x240, 0.08 us at 3.35 TB/s; 7.4 MB for 1280x960, 2.2 us).
// The operations, ~30 integer multiply-adds a sample (smoothing adds ~200 a
// block), are far below the card's rate. At 180x240 the two launches' fixed
// cost (~2-3 us each) is the time; the planes (1 B a sample) go through L2
// between the launches. The design spends nothing on the small case beyond
// two launches, and keeps the large one to one pass over the coefficients
// and one over the planes.
//
// The entropy decoder (scl_jpeg_info, scl_jpeg_entropy) is host code: Huffman
// and arithmetic decoding are serial bit streams, the part nvJPEG's hybrid
// mode also keeps on the host. It mirrors utils/jpeg.py's plain decoder
// (decode_coefficients, its _Walk: libjpeg-turbo's markers, restart
// resynchronisation, zero fill and default tables, in OpenCV's file or buffer
// mode) and gives the same coefficient buffer: each component's (bh, bw)
// blocks of 64 int16 in natural order, one component after another, and the
// same smoothing state. It refuses what that decoder refuses, with its
// reasons. Called through ctypes, it runs without the GIL, so the callers'
// decode threads run it in parallel.

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

constexpr int kGray = 0, kYcc = 1, kRgb = 2, kCmyk = 3, kYcck = 4;
constexpr int kMaxComps = 4;
constexpr int kSmoothWords = 20;  // per component: known bits of zigzag 0-9, and of 1-9 before

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
  int v;           // its vertical sampling factor (block rows per iMCU row)
};

struct J1Geom {
  J1Comp c[kMaxComps];
  int ncomp, colour, orientation, height, width;
  int64_t blocks;  // all components'
};

// the block smoothing's state, passed to the smoothing IDCT launch only
struct J1Smooth {
  int bits[kMaxComps][kSmoothWords];  // coef bits now (zigzag 0-9), before the last scan (1-9)
  int imcu_rows, last_good;
};

// ------------------------------------------------------------------ smoothing
// the zigzag index (1-9) of the natural positions the smoothing estimates
// (jdcoefct.c's Q01_POS ... Q30_POS), 0 for the DC, -1 for the others
HD int smooth_index(int pos) {
  switch (pos) {
    case 0: return 0;
    case 1: return 1;
    case 8: return 2;
    case 16: return 3;
    case 9: return 4;
    case 2: return 5;
    case 3: return 6;
    case 10: return 7;
    case 17: return 8;
    case 24: return 9;
    default: return -1;
  }
}

HD int16_t s16(long long v) { return (int16_t)(uint16_t)(v & 0xFFFF); }

// the block rows of a 5x5 window around block row r (-1: past the array, DC
// 0), libjpeg's image_block_row arithmetic (utils/jpeg.py smoothing_neighbours)
HD void smooth_rows(const J1Comp& k, int imcu_rows, int r, int* rows) {
  const int hib = (k.dh + 7) / 8, v = k.v;
  const int last_rows = hib % v ? hib % v : v;
  const int imcu = r / v, br = r % v;
  const int block_rows = imcu == imcu_rows - 1 ? last_rows : v;
  const int ibr = imcu * block_rows + br, ibrs = block_rows * imcu_rows;
  const int prev = ibr > 0 ? r - 1 : r;
  const int pp = ibr > 1 ? r - 2 : prev;
  const int nxt = ibr < ibrs - 1 ? r + 1 : r;
  const int nn = ibr < ibrs - 2 ? r + 2 : nxt;
  const int w[5] = {pp, prev, r, nxt, nn};
  for (int i = 0; i < 5; ++i) rows[i] = w[i] < k.bh ? w[i] : -1;
}

// the block columns of the window around column b: the sliding registers
// repeat the edge block
HD void smooth_cols(const J1Comp& k, int b, int* cols) {
  const int wib = (k.dw + 7) / 8;
  for (int j = 0; j < 5; ++j) {
    const int c = b + j - 2;
    cols[j] = c < 0 ? 0 : (c > wib - 1 ? wib - 1 : c);
  }
}

// a smoothing estimate: rounded division by Q << 8, limited below 2^al where al > 0
HD long long smooth_pred(long long num, long long q, int al, bool limit) {
  long long mag = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
  if (limit && al > 0 && mag >= (1LL << al)) mag = (1LL << al) - 1;
  return num < 0 ? -mag : mag;
}

// coefficient `pos` (natural order) of block `blk` of component ci as the
// IDCT takes it: the stored value, or its smoothing estimate
HD int coef_at(const int16_t* coefs, const int32_t* quant, const J1Geom& g, const J1Smooth& sm,
               int ci, int64_t blk, int pos) {
  const int raw = coefs[blk * 64 + pos];
  const int k = smooth_index(pos);
  if (k < 0) return raw;
  const J1Comp& c = g.c[ci];
  const int64_t b = blk - c.block0;
  const int by = (int)(b / c.bw), bx = (int)(b % c.bw);
  const bool prev = by / c.v > sm.last_good;
  int bits[10];
  for (int i = 0; i < 10; ++i) bits[i] = prev && i ? sm.bits[ci][10 + i] : sm.bits[ci][i];
  bool change_dc = true;
  for (int i = 1; i < 10; ++i) change_dc = change_dc && bits[i] == -1;
  if (pos == 0 && !change_dc) return raw;
  if (k > 5 && !change_dc) return raw;
  if (k > 0 && (bits[k] == 0 || raw != 0)) return raw;
  int rows[5], cols[5];
  smooth_rows(c, sm.imcu_rows, by, rows);
  smooth_cols(c, bx, cols);
  long long D[26];
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j)
      D[5 * i + j + 1] =
          rows[i] < 0 ? 0 : coefs[(c.block0 + (int64_t)rows[i] * c.bw + cols[j]) * 64];
  const int32_t* q = quant + ci * 64;
  const long long q00 = q[0];
  long long num;
  switch (pos) {
    case 1:
      num = change_dc ? -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] +
                            3 * D[10] - 3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] -
                            3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] - D[22] +
                            D[24] + D[25]
                      : -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15];
      break;
    case 8:
      num = change_dc ? -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] +
                            38 * D[8] + 13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] -
                            13 * D[19] + D[20] + D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] +
                            D[25]
                      : -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23];
      break;
    case 16:
      num = change_dc ? D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] -
                            5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]
                      : -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23];
      break;
    case 9:
      num = change_dc ? -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] -
                            D[25]
                      : D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] -
                            D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9];
      break;
    case 2:
      num = change_dc ? 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] +
                            7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]
                      : -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15];
      break;
    case 3: num = D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]; break;
    case 10: num = D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]; break;
    case 17: num = D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]; break;
    case 24: num = D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]; break;
    default:  // the DC
      num = -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
            42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
            42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
            6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25];
      return s16(smooth_pred(q00 * num, q00, 0, false));
  }
  return s16(smooth_pred(q00 * num, q[pos], bits[k], true));
}

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

// the column pass of column `col` of block blk (component ci): its
// coefficients (smoothed where kSmooth) dequantized down the column, outputs
// (one per row) into ws[row * 8 + col]
template <bool kSmooth>
HD void idct_column(const int16_t* coefs, const int32_t* quant, const J1Geom& g,
                    const J1Smooth& sm, int ci, int64_t blk, int col, long long* ws) {
  const int32_t* q = quant + ci * 64;
  long long x[8], o[8];
  for (int k = 0; k < 8; ++k) {
    const int c = kSmooth ? coef_at(coefs, quant, g, sm, ci, blk, k * 8 + col)
                          : coefs[blk * 64 + k * 8 + col];
    x[k] = (long long)c * q[k * 8 + col];
  }
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

// OpenCV's CMYK -> BGR on libjpeg's (Adobe, inverted) samples, as RGB
HD void cmyk_rgb(int c, int m, int y, int k, uint8_t* rgb) {
  rgb[0] = (uint8_t)(k - (((255 - c) * k) >> 8));
  rgb[1] = (uint8_t)(k - (((255 - m) * k) >> 8));
  rgb[2] = (uint8_t)(k - (((255 - y) * k) >> 8));
}

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
  if (g.colour == kCmyk) {
    cmyk_rgb(v0, v1, v2, upsampled(planes, g.c[3], r, c), rgb);
    return;
  }
  // jdcolor.c: FIX(1.40200) 91881, FIX(1.77200) 116130, FIX(0.71414) 46802,
  // FIX(0.34414) 22554, ONE_HALF 1 << 15; arithmetic right shifts
  const long long cb = v1 - 128, cr = v2 - 128, half = 1LL << 15;
  int cr_r = (int)((91881 * cr + half) >> 16);
  int cb_b = (int)((116130 * cb + half) >> 16);
  int g_off = (int)((-22554 * cb + half - 46802 * cr) >> 16);
  if (g.colour == kYcck) {  // ycck_cmyk_convert, then OpenCV's CMYK -> BGR
    cmyk_rgb(clamp255(255 - (v0 + cr_r)), clamp255(255 - (v0 + g_off)),
             clamp255(255 - (v0 + cb_b)), upsampled(planes, g.c[3], r, c), rgb);
    return;
  }
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

template <bool kSmooth>
__global__ void __launch_bounds__(kThreads) idct_kernel(const int16_t* __restrict__ coefs,
                                                        const int32_t* __restrict__ quant,
                                                        uint8_t* __restrict__ planes, J1Geom g,
                                                        J1Smooth sm) {
  __shared__ long long ws[kBlocksPerCta][64];
  const int lane = threadIdx.x & 7, local = threadIdx.x >> 3;
  const int64_t blk = (int64_t)blockIdx.x * kBlocksPerCta + local;
  const bool active = blk < g.blocks;
  int ci = 0;
  if (active) {
    ci = find_comp(g, blk);
    idct_column<kSmooth>(coefs, quant, g, sm, ci, blk, lane, ws[local]);
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

struct HuffSpec {
  bool defined = false;
  uint8_t counts[16];
  uint8_t vals[256];
};

// a Huffman table as libjpeg derives it at a scan's start: a 9-bit
// lookahead, then the canonical code's maxcode / value offsets
struct Huff {
  uint16_t look[512];  // (length << 8) | symbol for codes of <= 9 bits, else 0
  int32_t maxcode[18];
  int32_t valoff[18];
  uint8_t vals[256];
};

struct Fail {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Fail{what}; }

std::string hex2(int code) {
  char hex[8];
  snprintf(hex, sizeof hex, "%02X", code);
  return hex;
}

// the frame types refused, as utils/jpeg.py's _SOF_REFUSED names them
const char* refused_frame(int code) {
  switch (code) {
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "hierarchical (SOF5)";
    case 0xC6: return "hierarchical progressive (SOF6)";
    case 0xC7: return "hierarchical lossless (SOF7)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded hierarchical (SOF13)";
    case 0xCE: return "arithmetic-coded hierarchical progressive (SOF14)";
    case 0xCF: return "arithmetic-coded hierarchical lossless (SOF15)";
    default: return nullptr;
  }
}

// ITU T.81 K.3 (jstdhuff.c): counts of lengths 1-16 and symbols of DC 0,
// DC 1, AC 0 and AC 1
const uint8_t kStdCounts[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAc0[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAc1[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// T.81 Table D.2 packed as jaricom.c: Qe << 16 | Next_MPS << 8 | Switch << 7
// | Next_LPS; entry 113 the fixed 0.5 bin
const uint32_t kQe[114][4] = {  // Qe, Next_LPS, Next_MPS, Switch
    {0x5A1D, 1, 1, 1},    {0x2586, 14, 2, 0},   {0x1114, 16, 3, 0},   {0x080B, 18, 4, 0},
    {0x03D8, 20, 5, 0},   {0x01DA, 23, 6, 0},   {0x00E5, 25, 7, 0},   {0x006F, 28, 8, 0},
    {0x0036, 30, 9, 0},   {0x001A, 33, 10, 0},  {0x000D, 35, 11, 0},  {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},  {0x0001, 12, 13, 0},  {0x5A7F, 15, 15, 1},  {0x3F25, 36, 16, 0},
    {0x2CF2, 38, 17, 0},  {0x207C, 39, 18, 0},  {0x17B9, 40, 19, 0},  {0x1182, 42, 20, 0},
    {0x0CEF, 43, 21, 0},  {0x09A1, 45, 22, 0},  {0x072F, 46, 23, 0},  {0x055C, 48, 24, 0},
    {0x0406, 49, 25, 0},  {0x0303, 51, 26, 0},  {0x0240, 52, 27, 0},  {0x01B1, 54, 28, 0},
    {0x0144, 56, 29, 0},  {0x00F5, 57, 30, 0},  {0x00B7, 59, 31, 0},  {0x008A, 60, 32, 0},
    {0x0068, 62, 33, 0},  {0x004E, 63, 34, 0},  {0x003B, 32, 35, 0},  {0x002C, 33, 9, 0},
    {0x5AE1, 37, 37, 1},  {0x484C, 64, 38, 0},  {0x3A0D, 65, 39, 0},  {0x2EF1, 67, 40, 0},
    {0x261F, 68, 41, 0},  {0x1F33, 69, 42, 0},  {0x19A8, 70, 43, 0},  {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0},  {0x0E74, 74, 46, 0},  {0x0BFB, 75, 47, 0},  {0x09F8, 77, 48, 0},
    {0x0861, 78, 49, 0},  {0x0706, 79, 50, 0},  {0x05CD, 48, 51, 0},  {0x04DE, 50, 52, 0},
    {0x040F, 50, 53, 0},  {0x0363, 51, 54, 0},  {0x02D4, 52, 55, 0},  {0x025C, 53, 56, 0},
    {0x01F8, 54, 57, 0},  {0x01A4, 55, 58, 0},  {0x0160, 56, 59, 0},  {0x0125, 57, 60, 0},
    {0x00F6, 58, 61, 0},  {0x00CB, 59, 62, 0},  {0x00AB, 61, 63, 0},  {0x008F, 61, 32, 0},
    {0x5B12, 65, 65, 1},  {0x4D04, 80, 66, 0},  {0x412C, 81, 67, 0},  {0x37D8, 82, 68, 0},
    {0x2FE8, 83, 69, 0},  {0x293C, 84, 70, 0},  {0x2379, 86, 71, 0},  {0x1EDF, 87, 72, 0},
    {0x1AA9, 87, 73, 0},  {0x174E, 72, 74, 0},  {0x1424, 72, 75, 0},  {0x119C, 74, 76, 0},
    {0x0F6B, 74, 77, 0},  {0x0D51, 75, 78, 0},  {0x0BB6, 77, 79, 0},  {0x0A40, 77, 48, 0},
    {0x5832, 80, 81, 1},  {0x4D1C, 88, 82, 0},  {0x438E, 89, 83, 0},  {0x3BDD, 90, 84, 0},
    {0x34EE, 91, 85, 0},  {0x2EAE, 92, 86, 0},  {0x299A, 93, 87, 0},  {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1},  {0x4CA9, 95, 90, 0},  {0x44D9, 96, 91, 0},  {0x3E22, 97, 92, 0},
    {0x3824, 99, 93, 0},  {0x32B4, 99, 94, 0},  {0x2E17, 93, 86, 0},  {0x56A8, 95, 96, 1},
    {0x4F46, 101, 97, 0}, {0x47E5, 102, 98, 0}, {0x41CF, 103, 99, 0}, {0x3C3D, 104, 100, 0},
    {0x375E, 99, 93, 0},  {0x5231, 105, 102, 0}, {0x4C0F, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415E, 103, 99, 0}, {0x5627, 105, 106, 1}, {0x50E7, 108, 107, 0}, {0x4B85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504F, 111, 107, 0}, {0x5A10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59EB, 112, 111, 1}, {0x5A1D, 113, 113, 0}};
constexpr int kFixedBin = 113;

struct Scan {
  int ns, comps[4], td[4], ta[4], ss, se, ah, al;
};

struct Decoder {
  const uint8_t* d;
  int64_t n;
  bool buffer;
  int16_t* coefs = nullptr;  // null: parse the header only
  int height = 0, width = 0, ncomp = 0, colour = kYcc, orientation = 1;
  bool progressive = false, arith = false, seen_sof = false, saw_jfif = false, saw_exif = false;
  bool multi = true;
  int adobe = -1;
  int restart = 0;
  int nscans = 0;
  Comp comps[kMaxComps];
  int64_t block0[kMaxComps + 1];
  int32_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  int32_t latched[kMaxComps][64];
  bool is_latched[kMaxComps] = {false, false, false, false};
  int coef_bits[kMaxComps][64];
  int prev_bits[kMaxComps][10];
  int last_good = 0;
  HuffSpec dcspec[4], acspec[4];
  Huff dct[4], act[4];  // the current scan's derived tables
  int cond_l[16], cond_u[16], cond_k[16];
  std::string* rec = nullptr;  // where set: each read's length (a code's, or -value bits)

  // the bit reader over the entropy data at `pos`: zeros after a marker (pos
  // stays on its first 0xFF) or, in buffer mode, the end of the data
  int64_t pos = 0;
  uint64_t acc = 0;
  int nb = 0;
  int64_t fed = 0, real_fed = 0;
  bool at_marker = false, hit_end = false;

  Decoder(const uint8_t* data, int64_t size, bool buf) : d(data), n(size), buffer(buf) {
    for (int i = 0; i < 16; ++i) {
      cond_l[i] = 0;
      cond_u[i] = 1;
      cond_k[i] = 5;
    }
  }

  [[noreturn]] void truncated() {
    fail("JPEG data ends before the decoder is done (truncated); decoded from memory as "
         "cv2.imdecode does, which gives no image for it");
  }
  // byte i of the source: the data, then in file mode the stdio source's
  // fake EOI markers (FF D9 ...); -1 past the end of a buffer
  int byte(int64_t i) const {
    if (i < n) return d[i];
    if (buffer || i >= n + 65540) return -1;
    return (i - n) & 1 ? 0xD9 : 0xFF;
  }
  int need(int64_t i) {
    int b = byte(i);
    if (b < 0) truncated();
    return b;
  }
  // libjpeg's next_marker from p: (code, position after it)
  int next_marker(int64_t p, int64_t* after) {
    while (true) {
      while (need(p) != 0xFF) ++p;
      int64_t j = p + 1;
      int c;
      while ((c = need(j)) == 0xFF) ++j;
      if (c) {
        *after = j + 1;
        return c;
      }
      p = j + 1;
    }
  }

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

  // ---- bits
  void fill() {
    while (nb <= 56) {
      int byte = 0;
      if (!at_marker) {
        int b = this->byte(pos);
        if (b < 0) {
          at_marker = hit_end = true;
        } else if (b != 0xFF) {
          byte = b;
          ++pos;
          real_fed += 8;
        } else {
          int64_t j = pos + 1;
          int c;
          while ((c = this->byte(j)) == 0xFF) ++j;
          if (c < 0) {
            at_marker = hit_end = true;
          } else if (c == 0) {
            byte = 0xFF;
            pos = j + 1;
            real_fed += 8;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
          }
        }
      }
      acc |= (uint64_t)byte << (56 - nb);
      nb += 8;
      fed += 8;
    }
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
    if (rec) rec->push_back((char)-s);
    int v = get(s);
    return v >= (1 << (s - 1)) ? v : v - (1 << s) + 1;
  }
  int huff(const Huff& t) {
    if (nb < 17) fill();
    uint32_t w = (uint32_t)(acc >> 48);
    int e = t.look[w >> 7];
    if (e) {
      skip(e >> 8);
      if (rec) rec->push_back((char)(e >> 8));
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int32_t code = (int32_t)(w >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        if (rec) rec->push_back((char)l);
        return t.vals[(code + t.valoff[l]) & 0xFF];
      }
    }
    skip(17);  // a bad code: libjpeg reads 17 bits and fakes a zero
    if (rec) rec->push_back((char)17);
    return 0;
  }
  void reset_bits(int64_t at, bool marker) {
    pos = at;
    acc = 0;
    nb = 0;
    fed = real_fed = 0;
    at_marker = marker;
    hit_end = false;
  }
  bool overran() const { return fed - nb > real_fed; }

  // the table a scan names, derived as jpeg_make_d_derived_tbl does: the
  // file's, else in a sequential frame the default for ids 0-1 (jdhuff.c
  // installs them; jdphuff.c does not)
  void derive(Huff& t, int ac, int tid) {
    if (tid > 3) fail("JPEG scan names Huffman table " + std::to_string(tid) + " (corrupt)");
    const HuffSpec& s = ac ? acspec[tid] : dcspec[tid];
    const uint8_t* counts;
    const uint8_t* syms;
    int total = 0;
    if (s.defined) {
      counts = s.counts;
      syms = s.vals;
    } else if (tid < 2 && !progressive) {
      counts = kStdCounts[2 * ac + tid];
      static const uint8_t dcs[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
      syms = ac ? (tid ? kStdAc1 : kStdAc0) : dcs;
    } else {
      fail(std::string("JPEG scan names ") + (ac ? "AC" : "DC") + " Huffman table " +
           std::to_string(tid) +
           ", which the file does not define (libjpeg has default tables 0-1 for sequential "
           "frames only)");
    }
    for (int i = 0; i < 16; ++i) total += counts[i];
    if (!ac)
      for (int i = 0; i < total; ++i)
        if (syms[i] > 15) fail("JPEG DC Huffman table has a symbol above 15 (corrupt)");
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
  }

  static int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

  // a marker segment's bytes (into buf) and its length word; fails where the
  // length is below 2
  int segment(int64_t p, int code, std::string& buf) {
    int length = (need(p) << 8) | need(p + 1);
    if (length < 2)
      fail("JPEG marker 0x" + hex2(code) + "'s segment has length " + std::to_string(length) +
           " (corrupt)");
    buf.resize(length - 2);
    for (int i = 0; i < length - 2; ++i) buf[i] = (char)need(p + 2 + i);
    return length;
  }

  void parse_sof(int code, const uint8_t* b, int len) {
    if (len < 6) fail("JPEG frame header is short (corrupt)");
    int precision = b[0];
    height = u16(b + 1);
    width = u16(b + 3);
    int nc = b[5];
    if (height == 0 || width == 0 || nc == 0)
      fail("JPEG frame of " + std::to_string(width) + "x" + std::to_string(height) + ", " +
           std::to_string(nc) + " components (a DNL height, or corrupt)");
    if (len != 6 + 3 * nc) fail("JPEG frame header has the wrong length (corrupt)");
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG; OpenCV decodes 8-bit samples only");
    if (height > 65500 || width > 65500 || (int64_t)height * width > (1LL << 30))
      fail("JPEG frame of " + std::to_string(width) + "x" + std::to_string(height) +
           " is larger than OpenCV reads");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(std::to_string(nc) + "-component JPEG; OpenCV decodes gray, 3- and 4-component JPEG "
           "only");
    progressive = code == 0xC2 || code == 0xCA;
    arith = code == 0xC9 || code == 0xCA;
    ncomp = nc;
    for (int i = 0; i < nc; ++i) {
      Comp& c = comps[i];
      c.cid = b[6 + 3 * i];
      int top = -1;
      bool repeat = false;
      for (int k = 0; k < i; ++k) {
        top = std::max(top, comps[k].cid);
        repeat = repeat || comps[k].cid == c.cid;
      }
      if (repeat) c.cid = top + 1;  // libjpeg renames a repeated id
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (!(c.h >= 1 && c.h <= 4 && c.v >= 1 && c.v <= 4))
        fail("JPEG component sampling " + std::to_string(c.h) + "x" + std::to_string(c.v) +
             " (corrupt)");
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
  }

  void settle_colour() {
    if (ncomp == 1) {
      colour = kGray;
    } else if (ncomp == 3) {
      if (saw_jfif) colour = kYcc;
      else if (adobe >= 0) colour = adobe == 0 ? kRgb : kYcc;
      else colour = (comps[0].cid == 82 && comps[1].cid == 71 && comps[2].cid == 66) ? kRgb : kYcc;
    } else {
      colour = adobe > 0 ? kYcck : kCmyk;
    }
  }

  Scan parse_sos(const uint8_t* b, int len) {
    Scan s;
    s.ns = len ? b[0] : 0;
    if (len != 4 + 2 * s.ns || s.ns < 1 || s.ns > 4)
      fail("JPEG scan header has the wrong length (corrupt)");
    if (!seen_sof) fail("JPEG scan before its frame header (corrupt)");
    int blocks = 0;
    for (int i = 0; i < s.ns; ++i) {
      int cid = b[1 + 2 * i], found = -1, top = -1;
      bool repeat = false;
      for (int k = 0; k < i; ++k) {
        top = std::max(top, comps[s.comps[k]].cid);
        repeat = repeat || comps[s.comps[k]].cid == cid;
      }
      if (repeat) cid = top + 1;  // libjpeg renames a repeated id
      for (int c = 0; c < ncomp; ++c)
        if (comps[c].cid == cid) {
          found = c;
          break;
        }
      if (found < 0)
        fail("JPEG scan names component " + std::to_string(cid) +
             ", which the frame lacks (corrupt)");
      s.comps[i] = found;
      s.td[i] = b[2 + 2 * i] >> 4;
      s.ta[i] = b[2 + 2 * i] & 15;
      blocks += comps[found].h * comps[found].v;
    }
    s.ss = b[1 + 2 * s.ns];
    s.se = b[2 + 2 * s.ns];
    s.ah = b[3 + 2 * s.ns] >> 4;
    s.al = b[3 + 2 * s.ns] & 15;
    if (!nscans) {
      settle_colour();
      multi = progressive || s.ns < ncomp;
    }
    if (blocks > 10 && s.ns > 1) fail("JPEG MCU of more than 10 blocks (corrupt)");
    for (int k = 0; k < s.ns; ++k) {
      int ci = s.comps[k];
      if (!is_latched[ci]) {
        int tq = comps[ci].tq;
        if (tq > 3 || !quant_defined[tq])
          fail("JPEG component uses quantization table " + std::to_string(tq) +
               ", which the file does not define (corrupt)");
        memcpy(latched[ci], quant[tq], sizeof latched[ci]);
        is_latched[ci] = true;
      }
    }
    if (progressive) {
      bool bad = (s.ss == 0 && s.se != 0) || (s.ss > 0 && (s.se < s.ss || s.se > 63 || s.ns != 1));
      if (bad || (s.ah && s.al != s.ah - 1) || s.al > 13)
        fail("JPEG progressive scan parameters Ss=" + std::to_string(s.ss) +
             " Se=" + std::to_string(s.se) + " Ah=" + std::to_string(s.ah) +
             " Al=" + std::to_string(s.al) + " are invalid (corrupt)");
    } else {
      s.ss = 0;  // libjpeg warns and decodes all 64
      s.se = 63;
      s.ah = s.al = 0;
    }
    return s;
  }

  // ---- restarts: libjpeg's read_restart_marker and jpeg_resync_to_restart.
  // The marker that ends the interval is found from pos; returns whether it
  // was swallowed (the reader then starts after it) or left (the reader
  // reads zeros, and the marker stays for the next restart or the scan's end)
  bool restart_marker(int expect) {
    if (hit_end) truncated();
    int64_t after;
    int64_t at = pos;
    int code = next_marker(at, &after);
    while (code != 0xD0 + expect) {
      int action;
      if (code < 0xC0) action = 2;
      else if (code < 0xD0 || code > 0xD7) action = 3;
      else if (code - 0xD0 == ((expect + 1) & 7) || code - 0xD0 == ((expect + 2) & 7)) action = 3;
      else if (code - 0xD0 == ((expect - 1) & 7) || code - 0xD0 == ((expect - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) break;
      if (action == 3) {
        reset_bits(after - 2, true);  // the reader sits on the marker: no data
        // after - 2 is at or after the marker's last fill byte; next_marker
        // from there finds the same marker
        return false;
      }
      at = after;
      code = next_marker(at, &after);
    }
    reset_bits(after, false);
    return true;
  }

  // the scan's MCUs: count, and per MCU its blocks
  struct Layout {
    int64_t n_mcu, mx;
    int cbw;
  };
  Layout layout(const Scan& s) {
    Layout L;
    if (s.ns == 1) {
      const Comp& c = comps[s.comps[0]];
      L.cbw = (c.dw + 7) / 8;
      L.n_mcu = (int64_t)L.cbw * ((c.dh + 7) / 8);
      L.mx = 1;
    } else {
      const int hm = hmax(), vm = vmax();
      L.mx = (width + 8 * hm - 1) / (8 * hm);
      L.n_mcu = L.mx * ((height + 8 * vm - 1) / (8 * vm));
      L.cbw = 0;
    }
    return L;
  }
  int imcu_row(const Scan& s, const Layout& L, int64_t m) const {
    if (s.ns == 1) return (int)((m / L.cbw) / comps[s.comps[0]].v);
    return (int)(m / L.mx);
  }
  template <class F>
  void for_blocks(const Scan& s, const Layout& L, int64_t m, F&& f) {
    if (s.ns == 1) {
      const Comp& c = comps[s.comps[0]];
      f(0, block0[s.comps[0]] + (m / L.cbw) * c.bw + m % L.cbw);
      return;
    }
    const int64_t my_ = m / L.mx, mx_ = m % L.mx;
    for (int k = 0; k < s.ns; ++k) {
      const Comp& c = comps[s.comps[k]];
      for (int y = 0; y < c.v; ++y)
        for (int x = 0; x < c.h; ++x)
          f(k, block0[s.comps[k]] + (my_ * c.v + y) * c.bw + mx_ * c.h + x);
    }
  }

  // decode one Huffman scan's entropy data from pos; on return pos is where
  // the marker that ends it is looked for
  int64_t seg_at = 0, tail_begin = 0;  // where the scan's last restart interval starts

  void huffman_scan(const Scan& s) {
    for (int k = 0; k < s.ns; ++k) {
      if (!progressive || (s.ss == 0 && s.ah == 0)) derive(dct[k], 0, s.td[k]);
      if (!progressive || s.ss > 0) derive(act[k], 1, s.ta[k]);
    }
    const Layout L = layout(s);
    const int64_t per = restart ? restart : L.n_mcu;
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    bool insufficient = false;
    int64_t last = 0;
    seg_at = pos;
    tail_begin = 0;
    reset_bits(pos, false);
    for (int64_t m = 0; m < L.n_mcu; ++m) {
      if (m && m % per == 0) {
        if (restart_marker((int)((m / per - 1) & 7))) {
          insufficient = false;
          seg_at = pos;
        }
        tail_begin = m;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
      }
      if (insufficient) continue;
      last = m;
      for_blocks(s, L, m, [&](int k, int64_t blk) { decode_block(s, k, blk, pred, eobrun); });
      if (overran()) {
        if (hit_end) truncated();  // buffer mode: the reader ran into the end of the data
        insufficient = true;
      }
    }
    last_good = imcu_row(s, L, last);
  }

  // Whether libjpeg-turbo's bit reader reads past the end of the data while
  // it decodes the last restart interval of a one-scan file whose data ends
  // without a marker (utils/jpeg.py _reads_past): replays jdhuff.c's bit
  // buffer on the interval's reads, decoded again with their lengths kept.
  bool tail_reads_past(const Scan& s) {
    const Layout L = layout(s);
    std::string ops;  // per MCU: its block count, its reads, 0
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    rec = &ops;
    reset_bits(seg_at, false);
    for (int64_t m = tail_begin; m < L.n_mcu; ++m) {
      const size_t head = ops.size();
      ops.push_back(0);
      int count = 0;
      for_blocks(s, L, m, [&](int k, int64_t blk) {
        decode_block(s, k, blk, pred, eobrun);
        ++count;
      });
      ops[head] = (char)count;
      ops.push_back(0);
    }
    rec = nullptr;
    int64_t ptr = seg_at;
    int left = 0;
    auto fill = [&]() -> bool {  // jpeg_fill_bit_buffer; false where it reads past the end
      while (left < 57) {
        if (ptr >= n) return false;
        int c = d[ptr++];
        if (c == 0xFF) {
          do {
            if (ptr >= n) return false;
            c = d[ptr++];
          } while (c == 0xFF);
          if (c) {
            left = 57;
            return true;
          }
        }
        left += 8;
      }
      return true;
    };
    size_t at = 0;
    while (at < ops.size()) {
      const int nblocks = ops[at++];
      if (!restart && n - ptr >= 512 * (int64_t)nblocks) {  // decode_mcu_fast
        for (; ops[at]; ++at) {
          if (left <= 16)
            for (int i = 0; i < 6; ++i) {
              const int c0 = d[ptr++];
              left += 8;
              if (c0 == 0xFF) ++ptr;
            }
          left -= std::abs((int)ops[at]);
        }
        ++at;
        continue;
      }
      for (; ops[at]; ++at) {  // decode_mcu_slow
        const int op = ops[at];
        if (op > 0) {  // HUFF_DECODE: 8 bits of lookahead, longer codes a bit at a time
          if (left < 8 && !fill()) return true;
          if (op > 8) {
            if (left < 9 && !fill()) return true;
            left -= 9;
            for (int i = 9; i < op; ++i) {
              if (left < 1 && !fill()) return true;
              left -= 1;
            }
            continue;
          }
        } else if (left < -op && !fill()) {
          return true;
        }
        left -= std::abs(op);
      }
      ++at;
    }
    return false;
  }

  bool marker_follows(int64_t p) const {
    for (; p + 1 < n; ++p) {
      if (d[p] != 0xFF) continue;
      int64_t j = p + 1;
      while (j < n && d[j] == 0xFF) ++j;
      if (j < n && d[j]) return true;
      p = j;
    }
    return false;
  }

  void decode_block(const Scan& s, int k, int64_t blk, int* pred, int& eobrun) {
    int16_t* out = coefs + blk * 64;
    if (!progressive) {
      int t = huff(dct[k]);
      if (t) pred[k] += receive(t);
      out[0] = (int16_t)pred[k];
      const Huff& a = act[k];
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
        int t = huff(dct[k]);
        if (t) pred[k] += receive(t);
        out[0] = s16((long long)pred[k] * (1LL << s.al));
      } else if (get(1)) {
        out[0] = (int16_t)(out[0] | (1 << s.al));
      }
      return;
    }
    const Huff& a = act[0];
    if (s.ah == 0) {  // AC first
      if (eobrun) {
        --eobrun;
        return;
      }
      for (int i = s.ss; i <= s.se; ++i) {
        int rs = huff(a), r = rs >> 4, sz = rs & 15;
        if (sz) {
          i += r;
          out[kNat[i]] = s16((long long)receive(sz) * (1LL << s.al));
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
          sz = get(1) ? p1 : m1;  // a size other than 1 only warns in libjpeg
        } else if (r != 15) {
          eobrun = (1 << r) + get(r);
          break;
        }
        do {
          int16_t* c = out + kNat[i];
          if (*c) {
            if (get(1) && !(*c & p1)) *c = s16(*c + (*c >= 0 ? p1 : m1));
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
        if (*c && get(1) && !(*c & p1)) *c = s16(*c + (*c >= 0 ? p1 : m1));
      }
      --eobrun;
    }
  }

  // ---- arithmetic decoding (jdarith.c)
  int64_t ac_c = 0;
  int32_t ac_a = 0;
  int ac_ct = -16;
  bool ac_read_past = false;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin = kFixedBin;
  int last_dc[4], dc_context[4];

  int arith_byte() {
    if (at_marker) {
      if (hit_end) ac_read_past = true;
      return 0;
    }
    int b = byte(pos);
    if (b < 0) {
      at_marker = hit_end = ac_read_past = true;
      return 0;
    }
    if (b != 0xFF) {
      ++pos;
      return b;
    }
    int64_t j = pos + 1;
    int c;
    while ((c = byte(j)) == 0xFF) ++j;
    if (c < 0) {
      at_marker = hit_end = ac_read_past = true;
      return 0;
    }
    if (c == 0) {
      pos = j + 1;
      return 0xFF;
    }
    at_marker = true;
    return 0;
  }
  int decode(uint8_t* st) {
    while (ac_a < 0x8000) {
      if (--ac_ct < 0) {
        ac_c = (ac_c << 8) | arith_byte();
        if ((ac_ct += 8) < 0)
          if (++ac_ct == 0) ac_a = 0x8000;
      }
      ac_a <<= 1;
    }
    int sv = *st;
    const uint32_t* e = kQe[sv & 0x7F];
    const int32_t qe = (int32_t)e[0];
    const int nl = (int)(e[3] << 7 | e[1]), nm = (int)e[2];
    ac_a -= qe;
    int64_t temp = (int64_t)ac_a << ac_ct;
    if (ac_c >= temp) {
      ac_c -= temp;
      if (ac_a < qe) {
        ac_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ac_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a < 0x8000) {
      if (ac_a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // one DC difference (Figures F.19-F.24); false on an overflow
  bool arith_dc(int k, int tbl, int* diff) {
    uint8_t* st = dc_stats[tbl];
    const int s0 = dc_context[k];
    if (decode(st + s0) == 0) {
      dc_context[k] = 0;
      *diff = 0;
      return true;
    }
    const int sign = decode(st + s0 + 1);
    int at = s0 + 2 + sign;
    int m = decode(st + at);
    if (m) {
      at = 20;
      while (decode(st + at)) {
        if ((m <<= 1) == 0x8000) return false;
        ++at;
      }
    }
    if (m < ((1 << cond_l[tbl]) >> 1)) dc_context[k] = 0;
    else if (m > ((1 << cond_u[tbl]) >> 1)) dc_context[k] = 12 + sign * 4;
    else dc_context[k] = 4 + sign * 4;
    int v = m;
    at += 14;
    while (m >>= 1)
      if (decode(st + at)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }
  bool arith_ac(uint8_t* st, int16_t* out, int ss, int se, int kk, int al) {
    for (int k = ss; k <= se; ++k) {
      int at = 3 * (k - 1);
      if (decode(st + at)) break;
      while (decode(st + at + 1) == 0) {
        at += 3;
        if (++k > se) return false;
      }
      const int sign = decode(&fixed_bin);
      at += 2;
      int m = decode(st + at);
      if (m && decode(st + at)) {
        m <<= 1;
        at = k <= kk ? 189 : 217;
        while (decode(st + at)) {
          if ((m <<= 1) == 0x8000) return false;
          ++at;
        }
      }
      int v = m;
      at += 14;
      while (m >>= 1)
        if (decode(st + at)) v |= m;
      v += 1;
      out[kNat[k]] = s16((long long)(sign ? -v : v) * (1LL << al));
    }
    return true;
  }
  bool arith_ac_refine(uint8_t* st, int16_t* out, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    while (kex > 0 && !out[kNat[kex]]) --kex;
    for (int k = ss; k <= se; ++k) {
      int at = 3 * (k - 1);
      if (k > kex && decode(st + at)) break;
      while (true) {
        int16_t* c = out + kNat[k];
        if (*c) {
          if (decode(st + at + 2)) *c = s16(*c + (*c < 0 ? m1 : p1));
          break;
        }
        if (decode(st + at + 1)) {
          *c = (int16_t)(decode(&fixed_bin) ? m1 : p1);
          break;
        }
        at += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }
  void arith_reset(const Scan& s) {
    for (int k = 0; k < s.ns; ++k) {
      if (!progressive || (s.ss == 0 && s.ah == 0)) memset(dc_stats[s.td[k]], 0, 64);
      if (!progressive || s.ss > 0) memset(ac_stats[s.ta[k]], 0, 256);
      last_dc[k] = dc_context[k] = 0;
    }
    ac_c = 0;
    ac_a = 0;
    ac_ct = -16;
  }
  // one MCU; false where the data is bad (the rest of the interval is left)
  bool arith_mcu(const Scan& s, const Layout& L, int64_t m) {
    bool ok = true;
    for_blocks(s, L, m, [&](int k, int64_t blk) {
      if (!ok) return;
      int16_t* out = coefs + blk * 64;
      if (!progressive || (s.ss == 0 && s.ah == 0)) {
        int diff;
        if (!arith_dc(k, s.td[k], &diff)) {
          ok = false;
          return;
        }
        last_dc[k] += diff;
        out[0] = s16((long long)last_dc[k] * (1LL << (progressive ? s.al : 0)));
        if (progressive) return;
      } else if (s.ss == 0) {
        if (decode(&fixed_bin)) out[0] = (int16_t)(out[0] | (1 << s.al));
        return;
      }
      uint8_t* st = ac_stats[s.ta[k]];
      if (!progressive) ok = arith_ac(st, out, 1, 63, cond_k[s.ta[k]], 0);
      else if (s.ah == 0) ok = arith_ac(st, out, s.ss, s.se, cond_k[s.ta[k]], s.al);
      else ok = arith_ac_refine(st, out, s.ss, s.se, s.al);
    });
    return ok;
  }
  void arith_scan(const Scan& s) {
    const Layout L = layout(s);
    const int64_t per = restart ? restart : L.n_mcu;
    bool error = false;
    reset_bits(pos, false);
    ac_read_past = false;
    arith_reset(s);
    for (int64_t m = 0; m < L.n_mcu; ++m) {
      if (m && m % per == 0) {
        if (ac_read_past) truncated();
        restart_marker((int)((m / per - 1) & 7));
        arith_reset(s);
        error = false;
      }
      if (!error && !arith_mcu(s, L, m)) error = true;
      if (ac_read_past) truncated();
    }
    last_good = imcu_row(s, L, L.n_mcu - 1);
  }

  // ---- the markers; with coefs null stop at the first scan
  void run() {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) fail("not a JPEG file");
    for (int c = 0; c < kMaxComps; ++c)
      for (int i = 0; i < 64; ++i) coef_bits[c][i] = -1;
    std::string buf;
    int64_t p;
    int code = next_marker(2, &p);
    while (true) {
      if (code == 0xD9) {  // past the data, the stdio source's fake EOI
        if (!nscans)
          fail(p > n ? "JPEG ends before its first scan (truncated)" : "JPEG has no scan");
        return;
      }
      if (code == 0xDA) {
        const int length = segment(p, code, buf);
        Scan s = parse_sos(reinterpret_cast<const uint8_t*>(buf.data()), length - 2);
        if (!coefs) return;  // the header: enough for the geometry
        ++nscans;
        if (progressive) {  // coef_bits and their state before this scan; a bad order warns
          for (int k = 0; k < s.ns; ++k) {
            const int ci = s.comps[k];
            for (int i = 1; i < 10; ++i) prev_bits[ci][i] = nscans > 1 ? coef_bits[ci][i] : 0;
            for (int i = s.ss; i <= s.se; ++i) coef_bits[ci][i] = s.al;
          }
        }
        pos = p + length;
        if (arith) arith_scan(s);
        else huffman_scan(s);
        if (!multi) {
          // one scan: the image is whole, OpenCV reads no further; in buffer
          // mode Huffman data that ends without a marker is refused where the
          // bit reader, filling ahead of what it decodes, reads past its end
          if (buffer && !arith && !marker_follows(pos) && tail_reads_past(s)) truncated();
          return;
        }
        code = next_marker(pos, &p);
        continue;
      }
      p = marker_segment(code, p, buf);
      code = next_marker(p, &p);
    }
  }

  // one marker segment at p (after its code); returns the position after it
  int64_t marker_segment(int code, int64_t p, std::string& buf) {
    if (code == 0xC0 || code == 0xC1 || code == 0xC2 || code == 0xC9 || code == 0xCA) {
      const int length = segment(p, code, buf);
      if (seen_sof) fail("JPEG has two frame headers (corrupt)");
      seen_sof = true;
      parse_sof(code, reinterpret_cast<const uint8_t*>(buf.data()), length - 2);
      return p + length;
    }
    if (const char* what = refused_frame(code))
      fail(std::string(what) + " JPEG; OpenCV decodes baseline, extended and progressive JPEG "
           "only");
    if (code == 0xC4) {
      const int length = segment(p, code, buf);
      const int len = length - 2;
      const uint8_t* b = reinterpret_cast<const uint8_t*>(buf.data());
      int at = 0;
      while (len - at > 16) {
        const int index = b[at];
        int total = 0;
        for (int i = 0; i < 16; ++i) total += b[at + 1 + i];
        at += 17;
        if (total > 256 || total > len - at) fail("JPEG DHT segment is malformed (corrupt)");
        const int ac = index & 0x10, th = index & ~0x10;
        if (th > 3) fail("JPEG DHT defines table " + std::to_string(th) + " (corrupt)");
        HuffSpec& h = ac ? acspec[th] : dcspec[th];
        h.defined = true;
        memcpy(h.counts, b + at - 16, 16);
        memcpy(h.vals, b + at, total);
        at += total;
      }
      if (at != len) fail("JPEG DHT segment has the wrong length (corrupt)");
      return p + length;
    }
    if (code == 0xDB) {
      const int length = segment(p, code, buf);
      const int len = length - 2;
      const uint8_t* b = reinterpret_cast<const uint8_t*>(buf.data());
      int at = 0;
      while (at < len) {
        int pq = b[at] >> 4, tq = b[at] & 15, size = pq ? 128 : 64;
        if (tq > 3 || at + 1 + size > len) fail("JPEG DQT segment is malformed (corrupt)");
        for (int k = 0; k < 64; ++k)
          quant[tq][kNat[k]] = pq ? u16(b + at + 1 + 2 * k) : b[at + 1 + k];
        quant_defined[tq] = true;
        at += 1 + size;
      }
      return p + length;
    }
    if (code == 0xDD) {
      const int length = segment(p, code, buf);
      if (length != 4) fail("JPEG DRI segment is malformed (corrupt)");
      restart = u16(reinterpret_cast<const uint8_t*>(buf.data()));
      return p + length;
    }
    if (code == 0xCC) {
      const int length = segment(p, code, buf);
      const int len = length - 2;
      if (len % 2) fail("JPEG DAC segment has the wrong length (corrupt)");
      for (int at = 0; at < len; at += 2) {
        const int index = (uint8_t)buf[at], val = (uint8_t)buf[at + 1];
        if (index >= 32) fail("JPEG DAC defines table " + std::to_string(index) + " (corrupt)");
        if (index >= 16) {
          cond_k[index - 16] = val;
        } else if ((val & 15) > (val >> 4)) {
          fail("JPEG DAC conditioning L > U (corrupt)");
        } else {
          cond_l[index] = val & 15;
          cond_u[index] = val >> 4;
        }
      }
      return p + length;
    }
    if ((code >= 0xE0 && code <= 0xEF) || code == 0xFE || code == 0xDC) {
      // skipped or saved; a length below 2 reads as no bytes
      const int length = (need(p) << 8) | need(p + 1);
      if (length <= 2) return p + 2;
      segment(p, code, buf);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(buf.data());
      const int len = length - 2;
      if (!nscans) {  // the colour and the Exif are settled at the first scan
        if (code == 0xE0 && len >= 14 && !memcmp(b, "JFIF\0", 5)) {
          saw_jfif = true;
        } else if (code == 0xE1 && len >= 6 && !memcmp(b, "Exif\0\0", 6) && !saw_exif) {
          saw_exif = true;
          orientation = exif_orientation(b + 6, len - 6);
        } else if (code == 0xEE && len >= 12 && !memcmp(b, "Adobe", 5)) {
          adobe = b[11];
        }
      }
      return p + length;
    }
    if (code == 0x01 || (code >= 0xD0 && code <= 0xD7)) return p;  // no parameters
    if (code == 0xD8) fail("JPEG has a second SOI marker (corrupt)");
    fail("JPEG marker 0x" + hex2(code) + " is not supported (libjpeg refuses it)");
  }

  // jdcoefct.c smoothing_ok, and the state the smoothing reads
  bool smoothing(int32_t* out) const {
    static const int kFirst[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    if (!progressive) return false;
    bool useful = false;
    for (int c = 0; c < ncomp; ++c) {
      if (!is_latched[c] || coef_bits[c][0] < 0) return false;
      for (int i = 0; i < 10; ++i)
        if (latched[c][kFirst[i]] == 0) return false;
      for (int i = 1; i < 10; ++i)
        if (coef_bits[c][i] != 0) useful = true;
    }
    if (!useful) return false;
    out[0] = last_good;
    for (int c = 0; c < ncomp; ++c) {
      int32_t* o = out + 1 + kSmoothWords * c;
      for (int i = 0; i < 10; ++i) o[i] = coef_bits[c][i];
      o[10] = 0;
      for (int i = 1; i < 10; ++i) o[10 + i] = nscans > 1 ? prev_bits[c][i] : -1;
    }
    return true;
  }

  static int exif_orientation(const uint8_t* t, int len) {
    if (len < 8) return 1;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 1;
    auto rd16 = [&](int64_t at) {
      return le ? t[at] | (t[at + 1] << 8) : (t[at] << 8) | t[at + 1];
    };
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

// info words: [H, W, ncomp, colour, orientation, progressive,
//  per component (4 slots): cid, h, v, tq, dw, dh, bw, bh,
//  smoothing flag, last_good, per component (4 slots): 20 coef-bit words]
constexpr int kInfoLen = 6 + 8 * kMaxComps + 2 + kSmoothWords * kMaxComps;

void write_info(const Decoder& dec, int32_t* info) {
  memset(info, 0, kInfoLen * sizeof(int32_t));
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
  int32_t* sm = info + 6 + 8 * kMaxComps;
  sm[0] = dec.coefs ? dec.smoothing(sm + 1) : 0;
}

}  // namespace

extern "C" {

int scl_jpeg_info_len(void) { return kInfoLen; }

// The frame's geometry from the markers before the first scan (info:
// kInfoLen int32, layout in write_info). buffer: 1 as cv2.imdecode reads
// bytes, 0 as cv2.imread reads a file. 0, or 1 with the reason in err.
int scl_jpeg_info(const uint8_t* data, int64_t n, int buffer, int32_t* info, char* err,
                  int errlen) {
  try {
    Decoder dec(data, n, buffer != 0);
    dec.run();
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
// component's latched table into `quant` (ncomp x 64 int32, natural order;
// zero for a component no scan reached), and the frame with its smoothing
// state into info.
int scl_jpeg_entropy(const uint8_t* data, int64_t n, int buffer, int16_t* coefs, int32_t* quant,
                     int32_t* info, char* err, int errlen) {
  try {
    Decoder dec(data, n, buffer != 0);
    dec.coefs = coefs;
    dec.run();
    write_info(dec, info);
    for (int c = 0; c < dec.ncomp; ++c) {
      if (dec.is_latched[c]) memcpy(quant + 64 * c, dec.latched[c], 64 * sizeof(int32_t));
      else memset(quant + 64 * c, 0, 64 * sizeof(int32_t));
    }
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
#endif

// J1's geometry from the wrapper's rows: comp is ncomp x 30 int64 (block0,
// plane0, bw, bh, dw, dh, hr, vr, fancy, v, 20 smoothing words); smooth is
// the flag, imcu_rows and last_good its frame-wide state
int scl_jpeg_geometry_len(void) { return 10 + kSmoothWords; }

#ifdef __CUDACC__
// J1: coefs (blocks x 64 int16) and quant (ncomp x 64 int32) on the card ->
// planes (scratch, sum of bw*8 x bh*8 bytes) -> out (out_h x out_w x 3 uint8).
// The IDCT launch with the block smoothing where smooth is set.
int scl_jpeg_pixels(const void* coefs, const void* quant, void* planes, void* out,
                    const int64_t* comp, int ncomp, int colour, int orientation, int height,
                    int width, int smooth, int imcu_rows, int last_good, int64_t blocks,
                    void* stream) {
  J1Geom g;
  J1Smooth sm;
  memset(&g, 0, sizeof g);
  memset(&sm, 0, sizeof sm);
  g.ncomp = ncomp;
  g.colour = colour;
  g.orientation = orientation;
  g.height = height;
  g.width = width;
  g.blocks = blocks;
  sm.imcu_rows = imcu_rows;
  sm.last_good = last_good;
  const int stride = 10 + kSmoothWords;
  for (int c = 0; c < ncomp; ++c) {
    const int64_t* k = comp + stride * c;
    J1Comp& j = g.c[c];
    j.block0 = k[0];
    j.plane0 = k[1];
    j.bw = (int)k[2];
    j.bh = (int)k[3];
    j.dw = (int)k[4];
    j.dh = (int)k[5];
    j.hr = (int)k[6];
    j.vr = (int)k[7];
    j.fancy = (int)k[8];
    j.v = (int)k[9];
    for (int i = 0; i < kSmoothWords; ++i) sm.bits[c][i] = (int)k[10 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned ctas = (unsigned)((blocks + kBlocksPerCta - 1) / kBlocksPerCta);
  const int16_t* cf = static_cast<const int16_t*>(coefs);
  const int32_t* qt = static_cast<const int32_t*>(quant);
  uint8_t* pl = static_cast<uint8_t*>(planes);
  if (smooth) idct_kernel<true><<<ctas, kThreads, 0, s>>>(cf, qt, pl, g, sm);
  else idct_kernel<false><<<ctas, kThreads, 0, s>>>(cf, qt, pl, g, sm);
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
