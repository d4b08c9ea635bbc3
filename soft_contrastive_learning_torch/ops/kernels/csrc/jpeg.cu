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
// One launch over a batch of images (j1_kernel), of any sizes, samplings,
// colour transforms and orientations. Its unit is a tile: one iMCU row of
// one image by as many MCU columns as 128 pixels hold (at most 32 x 128
// pixels), or, where that leaves the batch fewer tiles than the card has
// SMs (a lone image), as 64, 32 or 16 pixels hold, so that more, shorter
// tiles run at once (J1Image.span is per image). The wrapper (ops/kernels/jpeg.py plan_batch) writes a table of
// J1Image entries (each image's geometry, smoothing words and offsets into
// the batch's coefficient, table and output buffers) and a tile prefix; a
// CTA of 256 threads finds its image and tile from them and runs:
//  - the prologue: the image's entry and tables into shared memory, the
//    tile's plan (tile_plan): per component its own blocks, the one-block
//    halo fancy upsampling reads above, below and to each side (inside the
//    component: jdsample.c repeats the edge sample), and a region of
//    samples in shared memory with room for the halo;
//  - the blocks: 96 blocks' coefficients loaded at once (8 threads a block,
//    16 bytes a thread), then 32 blocks at a time: the block smoothing
//    where the frame has it (its DC values, with a margin of two blocks,
//    staged in shared memory once a tile), the column pass, the row pass
//    into the region. The passes run in 32 bits wherever a block's
//    dequantized inputs and column outputs stay within +-35,079 (each sum
//    then lies inside int32; checked per block), else that block's rows
//    are computed again in 64 bits (wide_row), as the plain version does
//    beyond libjpeg-turbo's 16-bit lanes;
//  - the pixels: two adjacent pixels a thread (8 to 64 threads a row, as
//    the tile is wide), each component's pair read
//    from its region (h2v1, h1v2 and h2v2 triangle filters, or repetition),
//    converted, and staged in shared memory at the oriented place (for
//    orientations 5-8 the tile's transpose), each output row shifted by its
//    address mod 16;
//  - the store: the staged rows to the output in 16-byte words, a warp a
//    row.
// There is no planes buffer in device memory and no second launch. The
// instantiation with the block smoothing is launched only for a batch that
// holds a smoothed image, so that the common case carries none of its
// registers. Where J1Args.clocks is set, thread 0 writes its SM, the global
// timer at its start and end, and the SM's clock after each phase (the
// wrapper's phase_clocks reads them).
// Bound on this card: bytes. A sample in costs a 2-byte coefficient (plus a
// 64-entry table per component), a pixel out 3 bytes: ~6 B a pixel at 4:2:0
// (0.26 MB for 180x240, 0.08 us at 3.35 TB/s; 7.4 MB for 1280x960, 2.2 us).
// The operations, ~30 integer multiply-adds a sample (smoothing adds ~200 a
// block), are far below the card's rate. What the time is made of is the
// tiles' latency: a tile's phases are chains of shared-memory reads and
// integer work on 8 warps, and the halo costs a 4:2:0 tile 92 blocks for
// its 48; the batch is what fills the card (PERF.md, J1's row).
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
#define HD_COLD __host__ __device__ __noinline__
#else
#define HD inline
#define HD_COLD inline
#endif
// a loop of constant count unrolled on the card, so that the arrays it
// indexes stay in registers
#ifdef __CUDA_ARCH__
#define UNROLL _Pragma("unroll")
#else
#define UNROLL
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

// ------------------------------------------------------------------ the batch table
// One image of a J1 batch as the wrapper writes it (ops/kernels/jpeg.py
// IMAGE_DTYPE is the same layout; the static_assert pins it).
struct J1Comp {
  int32_t block0;              // its first block, counted from the image's first
  int32_t bw, bh;              // blocks in its coefficient array
  int32_t dw, dh;              // samples it holds
  int32_t h, v;                // sampling factors: its blocks in an MCU
  int32_t hr, vr;              // upsampling ratios
  int32_t fancy;               // triangle filter (else repetition)
  int32_t bits[kSmoothWords];  // smoothing: known bits of zigzag 0-9, of 1-9 before the last scan
  int32_t pad[2];
};

struct J1Image {
  int32_t ncomp, colour, orientation, height, width, hmax, vmax;
  int32_t span;       // MCU columns a tile spans
  int32_t spans;      // tiles across; imcu_rows tiles down (a tile is an iMCU row's span)
  int32_t imcu_rows;
  int32_t smooth, last_good;  // block smoothing, and the last iMCU row whose data was whole
  int32_t quant0;     // its first table among the batch's
  int32_t pad;
  int64_t coef0;      // its first block among the batch's coefficients
  int64_t out0;       // its first byte in the batch's output (16-byte aligned)
  J1Comp c[kMaxComps];
};
static_assert(sizeof(J1Comp) == 128 && sizeof(J1Image) == 584,
              "J1Image is ops/kernels/jpeg.py's IMAGE_DTYPE");

// the launch's arguments: the table, the tile prefix (image i owns tiles
// prefix[i] .. prefix[i + 1] - 1 of the grid), the packed coefficients and
// tables, the output and the launch's dynamic shared memory
struct J1Args {
  const J1Image* images;
  const int32_t* prefix;
  const int16_t* coefs;
  const int32_t* quant;
  uint8_t* out;
  int64_t* clocks;  // null, or kClocks words a CTA: its SM, then the phases' ends
  int nimages, smem;
};

// one component's part of a tile: its own first block row and column, the
// blocks it transforms (its own and the one-block halo fancy upsampling
// reads: rows by_lo..by_hi-1, columns bx_lo..bx_hi-1, inside the component),
// its region of samples in shared memory (rows x pitch bytes from sample
// (8 by0 - 1, 8 bx0 - 8): one halo row above and below, 8 columns either
// side), its DC stage for the smoothing (the blocks' DC values with a margin
// of two blocks, dc_pitch words a row) and its first job (block) in the
// tile's list
struct J1Tile {
  int by0, bx0, by_lo, by_hi, bx_lo, bx_hi;
  int rows, pitch, region;
  int dc, dc_pitch;
  int jobs0;
  int pad;
};

// the tile's pixels in the decoded image
struct J1Rect {
  int r0, c0, th, tw;
};

// the tile in the output: its first row and column, rows and columns (5-8
// swap them), the staging pitch, and the output image's width
struct J1Out {
  int oy0, ox0, rows, cols, pitch;
  int64_t width;
};

constexpr int kThreads = 256;
constexpr int kMinBlocks = 768 / kThreads;  // CTAs an SM holds: 80 registers a thread
constexpr int kClocks = 8;  // the SM, the global timer at the start and end, the SM's clock
                            // at the start and after each of 4 phases
constexpr int kJobs = kThreads / 8;  // blocks transformed at once, 8 threads each
constexpr int kStage = 96;           // blocks whose coefficients are loaded at once
static_assert(kStage % kJobs == 0 && kThreads % 128 == 0, "J1's CTA");
// a block's words in the workspace and int16 in the coefficient stage: 64 + 8,
// so that the four blocks of a warp fall on other banks
constexpr int kWsPitch = 72, kCfPitch = 72;
// the largest input magnitude of an islow pass whose sums stay inside int32:
// every output is a sum of at most 61,214 x its largest input, plus 2^17
constexpr int kIdct32Max = 35079;
// shared memory: the image's table entry, the tiles, the wide flags and the
// jobs' blocks, misc words (image, tile, jobs, late bytes, region bytes, DC
// words), the tables, then per image the late area (the IDCT's workspace
// and coefficient stage, which the output staging takes over once the
// blocks are done), the regions and the DC stage
constexpr int kSmTile = 592;
constexpr int kSmWide = kSmTile + kMaxComps * (int)sizeof(J1Tile);
constexpr int kSmJob = kSmWide + 4 * kStage;
constexpr int kSmMisc = kSmJob + 12 * kStage;
constexpr int kSmQuant = kSmMisc + 32;
constexpr int kSmLate = kSmQuant + 4 * 64 * kMaxComps;
constexpr int kLateCf = 4 * kWsPitch * kJobs;
constexpr int kLateMin = kLateCf + 2 * kCfPitch * kStage;
static_assert(sizeof(J1Image) <= kSmTile && kSmLate % 16 == 0 && kLateCf % 16 == 0 &&
                  kLateMin % 16 == 0,
              "J1 shared memory layout");

HD int imin(int a, int b) { return a < b ? a : b; }
HD int imax(int a, int b) { return a > b ? a : b; }
HD int align16(int n) { return (n + 15) & ~15; }

HD void fault() {
#ifdef __CUDA_ARCH__
  __trap();
#else
  __builtin_trap();
#endif
}

HD void copy16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

HD void store8(void* dst, uint32_t lo, uint32_t hi) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
#else
  memcpy(dst, &lo, 4);
  memcpy(static_cast<uint8_t*>(dst) + 4, &hi, 4);
#endif
}

// the CTA's shared memory
struct J1Smem {
  uint8_t* base;
  HD J1Image& im() const { return *reinterpret_cast<J1Image*>(base); }
  HD J1Tile* tile() const { return reinterpret_cast<J1Tile*>(base + kSmTile); }
  HD int* wide() const { return reinterpret_cast<int*>(base + kSmWide); }
  HD int* job(int j) const { return reinterpret_cast<int*>(base + kSmJob) + 3 * j; }
  HD int* misc() const { return reinterpret_cast<int*>(base + kSmMisc); }
  HD int32_t* quant(int k) const { return reinterpret_cast<int32_t*>(base + kSmQuant) + 64 * k; }
  HD int32_t* ws(int slot) const {
    return reinterpret_cast<int32_t*>(base + kSmLate) + kWsPitch * slot;
  }
  HD int16_t* cf(int j) const {
    return reinterpret_cast<int16_t*>(base + kSmLate + kLateCf) + kCfPitch * j;
  }
  HD uint8_t* stage() const { return base + kSmLate; }
  HD uint8_t* region(int k) const { return base + kSmLate + misc()[3] + tile()[k].region; }
  HD int32_t* dc(int k) const {
    return reinterpret_cast<int32_t*>(base + kSmLate + misc()[3] + misc()[4]) + tile()[k].dc;
  }
};

// ------------------------------------------------------------------ the tile plan
HD J1Rect tile_rect(const J1Image& im, int tile) {
  J1Rect t;
  t.r0 = tile / im.spans * 8 * im.vmax;
  t.c0 = tile % im.spans * im.span * 8 * im.hmax;
  t.th = imin(8 * im.vmax, im.height - t.r0);
  t.tw = imin(8 * im.hmax * im.span, im.width - t.c0);
  return t;
}

// each component's part of tile `tile` (into t), and into m (the misc
// words): the jobs (blocks to transform); the late area's bytes (the IDCT's
// workspace and coefficient stage, or the output staging, whichever is
// larger); the regions' bytes; the DC stage's words
// (ops/kernels/jpeg.py plan_batch and tile_plan are the same arithmetic)
HD void tile_plan(const J1Image& im, int tile, J1Tile* t, int* m) {
  const int iy = tile / im.spans, sp = tile % im.spans;
  const int th = 8 * im.vmax, tw = 8 * im.hmax * im.span;
  int jobs = 0, region = 0, dc = 0;
  for (int k = 0; k < im.ncomp; ++k) {
    const J1Comp& c = im.c[k];
    const int fv = c.fancy && c.vr == 2, fh = c.fancy && c.hr == 2;
    J1Tile& u = t[k];
    u.by0 = iy * c.v;
    u.bx0 = sp * im.span * c.h;
    u.by_lo = imax(u.by0 - fv, 0);
    u.by_hi = imin(u.by0 + c.v + fv, c.bh);
    u.bx_lo = imax(u.bx0 - fh, 0);
    u.bx_hi = imin(u.bx0 + im.span * c.h + fh, c.bw);
    u.rows = 8 * c.v + 2;
    u.pitch = 8 * im.span * c.h + 16;
    u.region = region;
    region += u.rows * u.pitch;
    u.dc_pitch = u.bx_hi - u.bx_lo + 4;
    u.dc = dc;
    if (im.smooth) dc += (u.by_hi - u.by_lo + 4) * u.dc_pitch;
    u.jobs0 = jobs;
    jobs += (u.by_hi - u.by_lo) * (u.bx_hi - u.bx_lo);
  }
  const int staging = im.orientation >= 5 ? tw * ((3 * th + 30) & ~15) : th * ((3 * tw + 30) & ~15);
  m[2] = jobs;
  m[3] = imax(kLateMin, align16(staging));
  m[4] = region;
  m[5] = dc;
}

// the output position of decoded pixel (r, c): OpenCV's EXIF transform
HD void oriented(int orientation, int h, int w, int r, int c, int* oy, int* ox) {
  switch (orientation) {
    case 2: *oy = r; *ox = w - 1 - c; break;
    case 3: *oy = h - 1 - r; *ox = w - 1 - c; break;
    case 4: *oy = h - 1 - r; *ox = c; break;
    case 5: *oy = c; *ox = r; break;
    case 6: *oy = c; *ox = h - 1 - r; break;
    case 7: *oy = w - 1 - c; *ox = h - 1 - r; break;
    case 8: *oy = w - 1 - c; *ox = r; break;
    default: *oy = r; *ox = c; break;
  }
}

HD J1Out out_rect(const J1Image& im, const J1Rect& t) {
  int ya, xa, yb, xb;
  oriented(im.orientation, im.height, im.width, t.r0, t.c0, &ya, &xa);
  oriented(im.orientation, im.height, im.width, t.r0 + t.th - 1, t.c0 + t.tw - 1, &yb, &xb);
  const bool turn = im.orientation >= 5;
  J1Out o;
  o.oy0 = imin(ya, yb);
  o.ox0 = imin(xa, xb);
  o.rows = turn ? t.tw : t.th;
  o.cols = turn ? t.th : t.tw;
  o.pitch = (3 * o.cols + 30) & ~15;  // a row's bytes, shifted by its address mod 16
  o.width = turn ? im.height : im.width;
  return o;
}

// the output byte of row j's first pixel
HD int64_t out_byte(const J1Image& im, const J1Out& o, int j) {
  return im.out0 + 3 * ((int64_t)(o.oy0 + j) * o.width + o.ox0);
}

// job j of the tile: its component and block
HD void job_block(const J1Smem& s, int job, int* k, int* by, int* bx) {
  const J1Image& im = s.im();
  const J1Tile* t = s.tile();
  int ci = 0;
  while (ci + 1 < im.ncomp && job >= t[ci + 1].jobs0) ++ci;
  const int w = t[ci].bx_hi - t[ci].bx_lo, local = job - t[ci].jobs0;
  *k = ci;
  *by = t[ci].by_lo + local / w;
  *bx = t[ci].bx_lo + local % w;
}

// ------------------------------------------------------------------ smoothing
// the natural position of zigzag coefficient z (0-9)
HD int zigzag_pos(int z) {
  switch (z) {
    case 1: return 1;
    case 2: return 8;
    case 3: return 16;
    case 4: return 9;
    case 5: return 2;
    case 6: return 3;
    case 7: return 10;
    case 8: return 17;
    case 9: return 24;
    default: return 0;
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

// a smoothing estimate: rounded division by Q << 8, limited below 2^al where al > 0
HD long long smooth_pred(long long num, long long q, int al, bool limit) {
  const long long a = (q << 7) + (num < 0 ? -num : num), b = q << 8;
  long long mag = (a >> 32) == 0 && b > 0 && (b >> 32) == 0
                      ? (long long)((uint32_t)a / (uint32_t)b)
                      : a / b;
  if (limit && al > 0 && mag >= (1LL << al)) mag = (1LL << al) - 1;
  return num < 0 ? -mag : mag;
}

// the estimate of coefficient `pos` (natural order) from the DC values D[1..25]
// of the 5x5 blocks around (jdcoefct.c decompress_smooth_data): each sum of
// D's stays within 432 x 2^15, its product with the table's DC entry needs 64 bits
HD int16_t smooth_estimate(int pos, const int* D, const int32_t* q, int al, bool change_dc) {
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
  return s16(smooth_pred(q00 * num, q[pos], al, true));
}

// D[1..25]: the DC values of the 5x5 window around block (by, bx) of
// component k, from the tile's DC stage (columns past the component's last
// block of samples repeat it, rows past the array read 0)
HD void dc_window(const J1Smem& s, int k, int by, int bx, int* D) {
  const J1Image& im = s.im();
  const J1Tile& u = s.tile()[k];
  const int32_t* dc = s.dc(k);
  int rows[5];
  smooth_rows(im.c[k], im.imcu_rows, by, rows);
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 5; ++j)
      D[5 * i + j + 1] =
          rows[i] < 0 ? 0 : dc[(rows[i] - u.by_lo + 2) * u.dc_pitch + bx + j - u.bx_lo];
}

// ------------------------------------------------------------------ IDCT
constexpr int kConstBits = 13, kPass1Bits = 2;

// one pass of jpeg_idct_islow over 8 inputs in 64 bits; outputs descaled by `shift`
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

// the same pass in 32 bits: the products and sums wrap (unsigned), and the
// outputs are exact wherever every input is within +-kIdct32Max (each
// output's sum then lies inside int32, and a sum mod 2^32 is the sum)
HD void idct_1d32(const int32_t* xin, int32_t* out, int shift) {
  typedef uint32_t U;
  const U x0 = (U)xin[0], x1 = (U)xin[1], x2 = (U)xin[2], x3 = (U)xin[3];
  const U x4 = (U)xin[4], x5 = (U)xin[5], x6 = (U)xin[6], x7 = (U)xin[7];
  const U z1 = (x2 + x6) * 4433u;
  const U tmp2 = z1 - x6 * 15137u;
  const U tmp3 = z1 + x2 * 6270u;
  const U tmp0 = (x0 + x4) << kConstBits;
  const U tmp1 = (x0 - x4) << kConstBits;
  const U tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const U tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const U z5 = (x7 + x3 + x5 + x1) * 9633u;
  const U a1 = (x7 + x1) * (U)-7373, a2 = (x5 + x3) * (U)-20995;
  const U a3 = (x7 + x3) * (U)-16069 + z5, a4 = (x5 + x1) * (U)-3196 + z5;
  const U t0 = x7 * 2446u + a1 + a3;
  const U t1 = x5 * 16819u + a2 + a4;
  const U t2 = x3 * 25172u + a2 + a3;
  const U t3 = x1 * 12299u + a1 + a4;
  const U half = 1u << (shift - 1);
  out[0] = (int32_t)(tmp10 + t3 + half) >> shift;
  out[1] = (int32_t)(tmp11 + t2 + half) >> shift;
  out[2] = (int32_t)(tmp12 + t1 + half) >> shift;
  out[3] = (int32_t)(tmp13 + t0 + half) >> shift;
  out[4] = (int32_t)(tmp13 - t0 + half) >> shift;
  out[5] = (int32_t)(tmp12 - t1 + half) >> shift;
  out[6] = (int32_t)(tmp11 - t2 + half) >> shift;
  out[7] = (int32_t)(tmp10 - t3 + half) >> shift;
}

HD uint8_t clamp255(long long v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// two words of 4 samples each: a row pass's outputs, range-limited
HD void pack_row(const long long* o, uint32_t* lo, uint32_t* hi) {
  uint32_t w[2] = {0, 0};
  for (int k = 0; k < 8; ++k) w[k >> 2] |= (uint32_t)clamp255(o[k] + 128) << (8 * (k & 3));
  *lo = w[0];
  *hi = w[1];
}

// row `row` of a block whose passes leave int32 (only corrupt data or a
// broken table gets there): each column pass again in 64 bits, its output at
// that row kept, then the row pass; a call of its own, so that its 64-bit
// registers do not weigh on the common path
HD_COLD void wide_row(const int16_t* cf, const int32_t* q, int row, uint32_t* lo, uint32_t* hi) {
  long long w[8];
  for (int c = 0; c < 8; ++c) {
    long long x[8], o[8];
    for (int k = 0; k < 8; ++k) x[k] = (long long)cf[k * 8 + c] * q[k * 8 + c];
    idct_1d(x, o, kConstBits - kPass1Bits);
    long long v = o[0];
    for (int k = 1; k < 8; ++k) v = k == row ? o[k] : v;
    w[c] = v;
  }
  long long o[8];
  idct_1d(w, o, kConstBits + kPass1Bits + 3);
  pack_row(o, lo, hi);
}

// ------------------------------------------------------------------ pixels
// a component's samples in the tile's region
struct Region {
  const uint8_t* p;
  int row0, col0, pitch;
  HD int at(int r, int c) const { return p[(r - row0) * pitch + (c - col0)]; }
};

HD Region region_of(const J1Smem& s, int k) {
  const J1Tile& u = s.tile()[k];
  return Region{s.region(k), 8 * u.by0 - 1, 8 * u.bx0 - 8, u.pitch};
}

// component k's values at decoded pixels (r, c) and (r, c + 1), c even, as
// the low and the next byte, through its upsampling (jdsample.c: the h2v1,
// h1v2 and h2v2 triangle filters with their biases, edges repeated at the
// component's last sample; sample repetition otherwise)
HD int sample_pair(const Region& g, const J1Comp& k, int r, int c) {
  if (k.hr == 1 && k.vr == 1) return g.at(r, c) | g.at(r, c + 1) << 8;
  if (!k.fancy) {
    const int rr = r / k.vr;
    return g.at(rr, c / k.hr) | g.at(rr, (c + 1) / k.hr) << 8;
  }
  if (k.hr == 1) {  // h1v2
    const int i = r >> 1, ni = (r & 1) ? imin(i + 1, k.dh - 1) : imax(i - 1, 0);
    const int bias = (r & 1) ? 2 : 1;
    return (3 * g.at(i, c) + g.at(ni, c) + bias) >> 2 |
           ((3 * g.at(i, c + 1) + g.at(ni, c + 1) + bias) >> 2) << 8;
  }
  const int j = c >> 1, jm = imax(j - 1, 0), jp = imin(j + 1, k.dw - 1);
  if (k.vr == 1) {  // h2v1
    const int x = 3 * g.at(r, j);
    return (x + g.at(r, jm) + 1) >> 2 | ((x + g.at(r, jp) + 2) >> 2) << 8;
  }
  // h2v2: column sums 3 x the nearer row + the farther, then 3 x the nearer
  // column sum + the farther, biases 8 and 7, over 16
  const int i = r >> 1, ni = (r & 1) ? imin(i + 1, k.dh - 1) : imax(i - 1, 0);
  const int near_sum = 3 * (3 * g.at(i, j) + g.at(ni, j));
  return (near_sum + 3 * g.at(i, jm) + g.at(ni, jm) + 8) >> 4 |
         ((near_sum + 3 * g.at(i, jp) + g.at(ni, jp) + 7) >> 4) << 8;
}

// OpenCV's CMYK -> BGR on libjpeg's (Adobe, inverted) samples, as RGB
HD void cmyk_rgb(int c, int m, int y, int k, uint8_t* rgb) {
  rgb[0] = (uint8_t)(k - (((255 - c) * k) >> 8));
  rgb[1] = (uint8_t)(k - (((255 - m) * k) >> 8));
  rgb[2] = (uint8_t)(k - (((255 - y) * k) >> 8));
}

// a pixel's RGB from its components' values
HD void convert(int colour, int v0, int v1, int v2, int v3, uint8_t* rgb) {
  if (colour == kGray) {
    rgb[0] = rgb[1] = rgb[2] = (uint8_t)v0;
    return;
  }
  if (colour == kRgb) {
    rgb[0] = (uint8_t)v0;
    rgb[1] = (uint8_t)v1;
    rgb[2] = (uint8_t)v2;
    return;
  }
  if (colour == kCmyk) {
    cmyk_rgb(v0, v1, v2, v3, rgb);
    return;
  }
  // jdcolor.c: FIX(1.40200) 91881, FIX(1.77200) 116130, FIX(0.71414) 46802,
  // FIX(0.34414) 22554, ONE_HALF 1 << 15; arithmetic right shifts
  const int cb = v1 - 128, cr = v2 - 128, half = 1 << 15;
  const int cr_r = (91881 * cr + half) >> 16;
  const int cb_b = (116130 * cb + half) >> 16;
  const int g_off = (-22554 * cb + half - 46802 * cr) >> 16;
  if (colour == kYcck) {  // ycck_cmyk_convert, then OpenCV's CMYK -> BGR
    cmyk_rgb(clamp255(255 - (v0 + cr_r)), clamp255(255 - (v0 + g_off)),
             clamp255(255 - (v0 + cb_b)), v3, rgb);
    return;
  }
  rgb[0] = clamp255(v0 + cr_r);
  rgb[1] = clamp255(v0 + g_off);
  rgb[2] = clamp255(v0 + cb_b);
}

// ------------------------------------------------------------------ the CTA's steps
// J1's CTA runs these in order, each by all kThreads threads, with a barrier
// between two (__syncthreads, or __syncwarp between the steps on one job,
// whose 8 threads share a warp); under g++ scl_jpeg_pixels_host runs the
// same steps thread by thread.

// the tile's image (the prefix's entry <= the CTA < the next) and its tile
HD void j1_locate(const J1Args& a, const J1Smem& s, int cta, int tid) {
  for (int i = tid; i < a.nimages; i += kThreads) {
    if (a.prefix[i] <= cta && cta < a.prefix[i + 1]) {
      s.misc()[0] = i;
      s.misc()[1] = cta - a.prefix[i];
    }
  }
}

// the image's table entry into shared memory
HD void j1_fetch(const J1Args& a, const J1Smem& s, int tid) {
  const int32_t* src = reinterpret_cast<const int32_t*>(a.images + s.misc()[0]);
  int32_t* dst = reinterpret_cast<int32_t*>(s.base);
  for (int i = tid; i < (int)(sizeof(J1Image) / 4); i += kThreads) dst[i] = src[i];
}

// its tables; tid 0: the tile's plan (a launch with too little shared memory
// for it faults)
HD void j1_plan(const J1Args& a, const J1Smem& s, int tid) {
  const J1Image& im = s.im();
  for (int i = tid; i < 64 * im.ncomp; i += kThreads)
    s.quant(0)[i] = a.quant[64 * (int64_t)im.quant0 + i];
  if (tid) return;
  int* m = s.misc();
  tile_plan(im, m[1], s.tile(), m);
  if (kSmLate + m[3] + m[4] + 4 * m[5] > a.smem) fault();
}

// smoothing: the DC values of the blocks around the tile's
HD void j1_stage_dc(const J1Args& a, const J1Smem& s, int tid) {
  const J1Image& im = s.im();
  for (int k = 0; k < im.ncomp; ++k) {
    const J1Comp& c = im.c[k];
    const J1Tile& u = s.tile()[k];
    const int n = (u.by_hi - u.by_lo + 4) * u.dc_pitch, last = (c.dw + 7) / 8 - 1;
    const int16_t* blocks = a.coefs + 64 * (im.coef0 + c.block0);
    int32_t* dc = s.dc(k);
    for (int i = tid; i < n; i += kThreads) {
      const int r = u.by_lo - 2 + i / u.dc_pitch;
      const int col = imin(imax(u.bx_lo - 2 + i % u.dc_pitch, 0), last);
      dc[i] = r >= 0 && r < c.bh ? blocks[64 * ((int64_t)r * c.bw + col)] : 0;
    }
  }
}

// 16 bytes of coefficients (a block's row)
struct Row16 {
  uint32_t w[4];
};

HD Row16 load16(const int16_t* p) {
  Row16 r;
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  r.w[0] = v.x;
  r.w[1] = v.y;
  r.w[2] = v.z;
  r.w[3] = v.w;
#else
  memcpy(r.w, p, 16);
#endif
  return r;
}

HD void store16(int16_t* p, const Row16& r) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
#else
  memcpy(p, r.w, 16);
#endif
}

// jobs base .. base + kStage - 1 into the stage: thread t of a job's 8 its
// row t of coefficients (the three loads of a thread issued before any
// store), and the job's component and block
HD void j1_load(const J1Args& a, const J1Smem& s, int base, int tid) {
  const int slot = tid >> 3, lane = tid & 7, jobs = s.misc()[2];
  const J1Image& im = s.im();
  Row16 rows[kStage / kJobs];
  UNROLL
  for (int r = 0; r < kStage / kJobs; ++r) {
    const int j = r * kJobs + slot;
    if (base + j < jobs) {
      int k, by, bx;
      job_block(s, base + j, &k, &by, &bx);
      if (lane == 0) {
        int* w = s.job(j);
        w[0] = k;
        w[1] = by;
        w[2] = bx;
        s.wide()[j] = 0;
      }
      const J1Comp& c = im.c[k];
      rows[r] = load16(a.coefs + 64 * (im.coef0 + c.block0 + (int64_t)by * c.bw + bx) + 8 * lane);
    }
  }
  UNROLL
  for (int r = 0; r < kStage / kJobs; ++r) {
    const int j = r * kJobs + slot;
    if (base + j < jobs) store16(s.cf(j) + 8 * lane, rows[r]);
  }
}

// a workspace row (8 int32, 32-byte aligned) in two 16-byte loads
HD void load_row8(const int32_t* p, int32_t* x) {
#ifdef __CUDA_ARCH__
  const int4 a = reinterpret_cast<const int4*>(p)[0], b = reinterpret_cast<const int4*>(p)[1];
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
#else
  memcpy(x, p, 32);
#endif
}

// the known bits of zigzag coefficient i for a block (the bits before the
// last scan where its iMCU row is past the last whole one)
HD int known_bits(const J1Comp& c, bool prev, int i) {
  return prev && i ? c.bits[10 + i] : c.bits[i];
}

// smoothing, sub-round r of the stage: thread t estimates zigzag
// coefficients t and t + 8 (up to 9) where the block smoothing replaces them
HD void j1_smooth(const J1Smem& s, int base, int r, int tid) {
  const int j = r * kJobs + (tid >> 3), lane = tid & 7;
  if (base + j >= s.misc()[2]) return;
  const int* w = s.job(j);
  const int k = w[0], by = w[1], bx = w[2];
  const J1Image& im = s.im();
  const J1Comp& c = im.c[k];
  const bool prev = by / c.v > im.last_good;
  bool change_dc = true;
  for (int i = 1; i < 10; ++i) change_dc = change_dc && known_bits(c, prev, i) == -1;
  int16_t* cf = s.cf(j);
  int D[26];
  bool have = false;
  for (int z = lane; z < 10; z += 8) {
    const int pos = zigzag_pos(z), al = known_bits(c, prev, z);
    if (z == 0 ? !change_dc : (z > 5 && !change_dc) || al == 0 || cf[pos] != 0) continue;
    if (!have) dc_window(s, k, by, bx, D);
    have = true;
    cf[pos] = smooth_estimate(pos, D, s.quant(k), al, change_dc);
  }
}

// the column pass, sub-round r: thread t dequantizes column t and transforms
// it in 32 bits into the workspace; a block whose inputs or outputs leave
// +-kIdct32Max is marked wide
HD void j1_columns(const J1Smem& s, int base, int r, int tid) {
  const int slot = tid >> 3, col = tid & 7, j = r * kJobs + slot;
  if (base + j >= s.misc()[2]) return;
  const int16_t* cf = s.cf(j);
  const int32_t* q = s.quant(s.job(j)[0]);
  int32_t x[8], o[8];
  bool wide = false;
  for (int i = 0; i < 8; ++i) {
    const long long v = (long long)cf[8 * i + col] * q[8 * i + col];
    wide = wide || v > kIdct32Max || v < -kIdct32Max;
    x[i] = (int32_t)v;
  }
  idct_1d32(x, o, kConstBits - kPass1Bits);
  int32_t* ws = s.ws(slot);
  for (int i = 0; i < 8; ++i) {
    wide = wide || o[i] > kIdct32Max || o[i] < -kIdct32Max;
    ws[8 * i + col] = o[i];
  }
  if (wide) s.wide()[j] = 1;
}

// the row pass, sub-round r: thread t's row of 8 samples into the
// component's region, where the region holds that row (a halo block above
// or below gives one)
HD void j1_rows(const J1Smem& s, int base, int r, int tid) {
  const int slot = tid >> 3, row = tid & 7, j = r * kJobs + slot;
  if (base + j >= s.misc()[2]) return;
  const int* w = s.job(j);
  const int k = w[0], by = w[1], bx = w[2];
  const J1Tile& u = s.tile()[k];
  const int rr = 8 * (by - u.by0) + row + 1;
  if (rr < 0 || rr >= u.rows) return;
  uint32_t lo, hi;
  if (s.wide()[j]) {
    wide_row(s.cf(j), s.quant(k), row, &lo, &hi);
  } else {
    int32_t x[8], o[8];
    long long o64[8];
    load_row8(s.ws(slot) + 8 * row, x);
    idct_1d32(x, o, kConstBits + kPass1Bits + 3);
    for (int i = 0; i < 8; ++i) o64[i] = o[i];
    pack_row(o64, &lo, &hi);
  }
  store8(s.region(k) + rr * u.pitch + 8 * (bx - u.bx0) + 8, lo, hi);
}

// the pixel pass's layouts: every component at full resolution; the first
// (and a fourth) at full resolution and the second and third through the
// h2v2 triangle filter with one geometry (4:2:0); any other
constexpr int kFull = 0, kH2V2 = 1, kAnyLayout = 2;

HD int pixel_layout(const J1Image& im) {
  bool full = true;
  for (int k = 0; k < im.ncomp; ++k) full = full && im.c[k].hr == 1 && im.c[k].vr == 1;
  if (full) return kFull;
  const J1Comp &c0 = im.c[0], &c1 = im.c[1], &c2 = im.c[2], &c3 = im.c[3];
  const bool h2v2 = im.ncomp >= 3 && c0.hr == 1 && c0.vr == 1 && c1.fancy && c1.hr == 2 &&
                    c1.vr == 2 && c2.fancy && c2.hr == 2 && c2.vr == 2 && c1.h == c2.h &&
                    c1.v == c2.v && c1.dw == c2.dw && c1.dh == c2.dh &&
                    (im.ncomp == 3 || (c3.hr == 1 && c3.vr == 1));
  return h2v2 ? kH2V2 : kAnyLayout;
}

// two pixels of a full-resolution component
HD int full_pair(const Region& g, int r, int c) { return g.at(r, c) | g.at(r, c + 1) << 8; }

// the tile's pixels two at a time (a thread a pair of columns of a row: as
// many threads a row as the power of two at or above its pairs, at least 8,
// so that a narrow tile keeps them busy too and a thread's columns stay
// the same from row to row), each component's pair from its region (upsampled
// where it is sampled below the image's resolution), converted, and staged
// at their oriented place: each output row shifted by its address mod 16,
// so that the store writes 16-byte words. The layout's loop keeps what it
// reads of the table in registers.
template <int kLayout>
HD void pixels_of(const J1Smem& s, const J1Rect& t, const J1Out& o, int tid) {
  const J1Image& im = s.im();
  const int pairs = (t.tw + 1) >> 1;
  const int lanes = pairs > 32 ? 64 : pairs > 16 ? 32 : pairs > 8 ? 16 : 8;
  const int c2 = 2 * (tid & (lanes - 1));
  if (c2 >= t.tw) return;
  const int nc = im.ncomp, colour = im.colour, orientation = im.orientation;
  const int height = im.height, width = im.width, pitch = o.pitch, oy0 = o.oy0, ox0 = o.ox0;
  const Region g0 = region_of(s, 0), g1 = region_of(s, nc > 1 ? 1 : 0);
  const Region g2 = region_of(s, nc > 2 ? 2 : 0), g3 = region_of(s, nc > 3 ? 3 : 0);
  const int cdw = im.c[nc > 1 ? 1 : 0].dw, cdh = im.c[nc > 1 ? 1 : 0].dh;
  uint8_t* stage = s.stage();
  const uint32_t w3 = 3u * (uint32_t)o.width, x3 = 3u * (uint32_t)o.ox0;
  for (int ry = tid / lanes; ry < t.th; ry += kThreads / lanes) {
    const int r = t.r0 + ry, c = t.c0 + c2;
    int p0, p1, p2, p3;
    if (kLayout == kFull) {
      p0 = full_pair(g0, r, c);
      p1 = nc > 1 ? full_pair(g1, r, c) : 0;
      p2 = nc > 2 ? full_pair(g2, r, c) : 0;
      p3 = nc > 3 ? full_pair(g3, r, c) : 0;
    } else if (kLayout == kH2V2) {
      // both chroma components' filters read the same places of their regions
      const int i = r >> 1, ni = (r & 1) ? imin(i + 1, cdh - 1) : imax(i - 1, 0);
      const int j = c >> 1, jm = imax(j - 1, 0), jp = imin(j + 1, cdw - 1);
      const int ri = (i - g1.row0) * g1.pitch - g1.col0, rn = (ni - g1.row0) * g1.pitch - g1.col0;
      p0 = full_pair(g0, r, c);
      p3 = nc > 3 ? full_pair(g3, r, c) : 0;
      const uint8_t* q = g1.p;
      int near_sum = 3 * (3 * q[ri + j] + q[rn + j]);
      p1 = (near_sum + 3 * q[ri + jm] + q[rn + jm] + 8) >> 4 |
           ((near_sum + 3 * q[ri + jp] + q[rn + jp] + 7) >> 4) << 8;
      q = g2.p;
      near_sum = 3 * (3 * q[ri + j] + q[rn + j]);
      p2 = (near_sum + 3 * q[ri + jm] + q[rn + jm] + 8) >> 4 |
           ((near_sum + 3 * q[ri + jp] + q[rn + jp] + 7) >> 4) << 8;
    } else {
      p0 = sample_pair(g0, im.c[0], r, c);
      p1 = nc > 1 ? sample_pair(g1, im.c[1], r, c) : 0;
      p2 = nc > 2 ? sample_pair(g2, im.c[2], r, c) : 0;
      p3 = nc > 3 ? sample_pair(g3, im.c[3], r, c) : 0;
    }
    UNROLL
    for (int x = 0; x < 2; ++x) {
      if (c2 + x < t.tw) {
        int oy, ox;
        oriented(orientation, height, width, r, c + x, &oy, &ox);
        const int shift = (int)((w3 * (uint32_t)oy + x3) & 15u);  // out0 is 16-byte aligned
        const int b = 8 * x;
        convert(colour, p0 >> b & 255, p1 >> b & 255, p2 >> b & 255, p3 >> b & 255,
                stage + (oy - oy0) * pitch + shift + 3 * (ox - ox0));
      }
    }
  }
}

HD void j1_pixels(const J1Smem& s, int tid) {
  const J1Image& im = s.im();
  const J1Rect t = tile_rect(im, s.misc()[1]);
  const J1Out o = out_rect(im, t);
  switch (pixel_layout(im)) {
    case kFull: pixels_of<kFull>(s, t, o, tid); break;
    case kH2V2: pixels_of<kH2V2>(s, t, o, tid); break;
    default: pixels_of<kAnyLayout>(s, t, o, tid); break;
  }
}

// the staged rows to the output, a warp a row: its 16-byte words whole, the
// bytes before the first and after the last a lane each
HD void j1_store(const J1Args& a, const J1Smem& s, int tid) {
  const J1Image& im = s.im();
  const J1Out o = out_rect(im, tile_rect(im, s.misc()[1]));
  const uint8_t* stage = s.stage();
  const int n = 3 * o.cols, lane = tid & 31;
  for (int j = tid >> 5; j < o.rows; j += kThreads / 32) {
    const int64_t g = out_byte(im, o, j), end = g + n;
    const int64_t first = (g + 15) & ~(int64_t)15, last = end & ~(int64_t)15;
    const uint8_t* row = stage + j * o.pitch + (int)(g & 15);  // output byte b at row[b - g]
    const int words = last > first ? (int)((last - first) >> 4) : 0;
    for (int w = lane; w < words; w += 32) copy16(a.out + first + 16 * w, row + (first - g) + 16 * w);
    // the first and last word's own bytes (at most 15 each), a lane a byte
    const int64_t head = first < end ? first : end, tail = last > head ? last : head;
    const int b = lane < 16 ? lane : (int)(tail - g) + lane - 16;
    if (lane < 16 ? b < head - g : g + b < end) a.out[g + b] = row[b];
  }
}

#ifdef __CUDACC__
// where a.clocks is set, thread 0 writes its SM and the global timer (ns)
// at the tile's start and end, and the SM's clock at its start and after
// each phase
__device__ __forceinline__ void stamp(const J1Args& a, int i) {
  if (!a.clocks || threadIdx.x) return;
  int64_t* c = a.clocks + kClocks * blockIdx.x;
  c[i] = clock64();
  if (i == 3 || i == 7) {
    int64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    c[i == 3 ? 1 : 2] = t;
  }
  if (i == 3) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    c[0] = sm;
  }
}

template <bool kSmooth>
__global__ void __launch_bounds__(kThreads, kSmooth ? (kMinBlocks + 1) / 2 : kMinBlocks) j1_kernel(J1Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const J1Smem s{smem};
  const int tid = threadIdx.x;
  stamp(a, 3);
  j1_locate(a, s, blockIdx.x, tid);
  __syncthreads();
  j1_fetch(a, s, tid);
  __syncthreads();
  j1_plan(a, s, tid);
  __syncthreads();
  stamp(a, 4);
  const bool smooth = kSmooth && s.im().smooth;
  if (smooth) {
    j1_stage_dc(a, s, tid);
    __syncthreads();
  }
  const int jobs = s.misc()[2];
  for (int base = 0; base < jobs; base += kStage) {
    j1_load(a, s, base, tid);
    __syncwarp();
    for (int r = 0; r < kStage / kJobs && base + r * kJobs < jobs; ++r) {
      if (smooth) {
        j1_smooth(s, base, r, tid);
        __syncwarp();
      }
      j1_columns(s, base, r, tid);
      __syncwarp();
      j1_rows(s, base, r, tid);
      __syncwarp();
    }
  }
  __syncthreads();
  stamp(a, 5);
  j1_pixels(s, tid);
  __syncthreads();
  stamp(a, 6);
  j1_store(a, s, tid);
  stamp(a, 7);
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
#endif

// J1's table entry, the shared memory a CTA needs before its image's late
// area, the late area's least size, and the CTA's threads (what
// ops/kernels/jpeg.py checks its plan against)
int scl_jpeg_image_bytes(void) { return (int)sizeof(J1Image); }
int scl_jpeg_smem_fixed(void) { return kSmLate; }
int scl_jpeg_late_min(void) { return kLateMin; }
int scl_jpeg_threads(void) { return kThreads; }

#ifdef __CUDACC__
// J1: one launch over a batch of images. images: nimages J1Image entries;
// prefix: nimages + 1 int32, image i's tiles from prefix[i], tiles in all;
// coefs and quant: the batch's blocks (64 int16, natural order) and tables
// (64 int32) as the entries' coef0/block0 and quant0 index them; out: every
// image's (rows, columns, 3) RGB bytes at its out0. smem: the dynamic
// shared memory (scl_jpeg_smem_fixed and the most that an image's late
// area, regions and DC stage take); smooth: launch the instantiation with the block smoothing (a
// batch holding a smoothed image); clocks: null, or kClocks int64 a tile
// (the phase clocks, for profiling).
int scl_jpeg_pixels(const void* images, const void* prefix, int nimages, int tiles,
                    const void* coefs, const void* quant, void* out, int smem, int smooth,
                    void* clocks, void* stream) {
  J1Args a;
  a.clocks = static_cast<int64_t*>(clocks);
  a.images = static_cast<const J1Image*>(images);
  a.prefix = static_cast<const int32_t*>(prefix);
  a.coefs = static_cast<const int16_t*>(coefs);
  a.quant = static_cast<const int32_t*>(quant);
  a.out = static_cast<uint8_t*>(out);
  a.nimages = nimages;
  a.smem = smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(smooth ? j1_kernel<true> : j1_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (smooth) j1_kernel<true><<<tiles, kThreads, smem, s>>>(a);
  else j1_kernel<false><<<tiles, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}
#else
// J1's CTAs on the host, one after another, each step run thread by thread in
// the kernel's order (the CPU check of the fused kernel's tiling and
// arithmetic: scripts/jpeg_crosscheck.py, tests/test_torch_jpeg_batch.py).
// Shared memory starts each CTA filled with junk, as on the card.
int scl_jpeg_pixels_host(const void* images, const void* prefix, int nimages, int tiles,
                         const void* coefs, const void* quant, void* out, int smem, int smooth) {
  J1Args a;
  a.clocks = nullptr;
  a.images = static_cast<const J1Image*>(images);
  a.prefix = static_cast<const int32_t*>(prefix);
  a.coefs = static_cast<const int16_t*>(coefs);
  a.quant = static_cast<const int32_t*>(quant);
  a.out = static_cast<uint8_t*>(out);
  a.nimages = nimages;
  a.smem = smem;
  uint64_t* buf = new uint64_t[(smem + 7) / 8];
  const J1Smem s{reinterpret_cast<uint8_t*>(buf)};
  for (int cta = 0; cta < tiles; ++cta) {
    memset(s.base, 0xA5 ^ (cta & 0xFF), smem);
    for (int t = 0; t < kThreads; ++t) j1_locate(a, s, cta, t);
    for (int t = 0; t < kThreads; ++t) j1_fetch(a, s, t);
    for (int t = 0; t < kThreads; ++t) j1_plan(a, s, t);
    const bool smoothed = smooth && s.im().smooth;
    if (smoothed)
      for (int t = 0; t < kThreads; ++t) j1_stage_dc(a, s, t);
    const int jobs = s.misc()[2];
    for (int base = 0; base < jobs; base += kStage) {
      for (int t = 0; t < kThreads; ++t) j1_load(a, s, base, t);
      for (int r = 0; r < kStage / kJobs && base + r * kJobs < jobs; ++r) {
        if (smoothed)
          for (int t = 0; t < kThreads; ++t) j1_smooth(s, base, r, t);
        for (int t = 0; t < kThreads; ++t) j1_columns(s, base, r, t);
        for (int t = 0; t < kThreads; ++t) j1_rows(s, base, r, t);
      }
    }
    for (int t = 0; t < kThreads; ++t) j1_pixels(s, t);
    for (int t = 0; t < kThreads; ++t) j1_store(a, s, t);
  }
  delete[] buf;
  return 0;
}
#endif

}  // extern "C"
