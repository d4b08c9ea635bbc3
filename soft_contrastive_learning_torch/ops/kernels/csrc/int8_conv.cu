// Q1: int8 3x3 SAME convolution as a persistent implicit GEMM for Hopper,
// sm_90a, with the post-training-quantized stack's epilogue fused; Q1_stem:
// the stack's first conv (C = 3) with the input's requant and 3x3 gather in
// its producer; Q1_pool: the 2x2 floor max-pool on int8 that follows each
// block-final conv.
//
// Replaces XLA work, not a Pallas kernel: the int8 conv of
// soft_contrastive_learning_tpu/models/quant.py::quantized_conv_stack
// (conv_general_dilated, int8 x int8 -> int32, then the elementwise dequant,
// bias, ReLU and requant), the input's centring and requant before the first
// one, and its reduce_window max on int8. The port's framework has no int8
// convolution on CUDA.
//
// What it computes. x (B, H, W, C) int8 NHWC, w (F, 3, 3, C) int8 K-major,
// SAME padding (inputs past the edge read as zero): acc[b, h, w, f] = sum over
// (r, s, c) of x[b, h + r - 1, w + s - 1, c] * w[f, r, s, c], exact in int32.
// Then y = float(acc) * m[f] + bias[f] (two fp32 roundings,
// __fmul_rn/__fadd_rn, as JAX's separate multiply and add), and either y as
// fp32 (conv5_3: no ReLU), or ReLU where asked, then rint(y * inv_next) (half
// to even) clipped to +-127 as int8. The rounding is an fp32 add of
// 1.5 * 2^23 to the clipped product: at that exponent the representable
// values are the integers, so the add rounds to the nearest one, ties to
// even, and the result's low byte is the int8 (no conversion instruction).
// The stem's x is the requantized image, clip(rint((float(img) -
// average_rgb[c]) * inv_in), +-127), which its producer computes from the raw
// uint8 or fp32 pixels.
//
// Bound on this card: 2 B H W 9 C F operations at the int8 tensor-core rate
// (1,979 TOP/s) against the input, the weights and the output read or written
// once (B H W C + 9 C F + B H W F bytes, x4 for an fp32 output) at 3.35 TB/s.
// Every VGG16 layer at 180x240 is operation-bound but the two of block 1
// (the stem: 3 input bytes a pixel, 64 out).
//
// Design. Integer wgmma + TMA with A gathered by TMA from the NHWC input: a
// tile is TH x 16 pixels of one image (M = 128 or 256 rows) by BN output
// channels, and K = 9 C runs in steps of BK channels of one tap: for tap
// (r, s) and channel block c0 the producer thread loads the 4-D box
// (BK, 16, TH, 1) at (c0, w0 + s - 1, h0 + r - 1, b), which TMA fills with
// zeros where it runs past the edge (the SAME padding, no padded copy, no
// im2col in memory). The box lands as M rows of BK bytes, K-major with the
// 128- or 64-byte swizzle, wgmma's s8 A layout. A block holds one
// producer warpgroup and one or two consumer warpgroups: two split a tile's
// rows, one block an SM; one takes whole tiles and two blocks share an SM, so
// that one block's epilogue runs beside the other's products (the choice of
// conv1_2 and the stem, whose epilogue is a large share of a tile).
// Persistent: as many blocks as fit at once, each walking the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... in the order (output channels,
// then 16-pixel columns, then rows of tiles, then images), so the blocks in
// flight share their input halos in L2; the producer runs ahead across tile
// boundaries through a ring of 4-8 stages, so the next tile's loads are in
// flight during this tile's epilogue; each stage holds the tap's A box and its
// (BK, BN) slice of the weights, but for conv1_2's tile (F = 64 one tile,
// 36 KB of weights), which loads them once a block and keeps them in shared
// memory (streaming them cost conv1_2 46%). The epilogue dequantizes, adds the
// bias, applies ReLU and requantizes into a swizzled shared tile per consumer
// warpgroup, and one thread stores it with 4-D TMA boxes (TMA clips the box at
// the map's edge); the store drains while the next tile's products run.
// Q1_stem: the producer warpgroup loads the (TH + 2, 18, 3) halo of the raw
// image with ordinary loads (3-byte pixels are below TMA's 16-byte rows),
// requantizes it into shared memory and writes each pixel's 27 (r, s, c)
// values and 5 zeros as a swizzled 32-byte A row; one k32 product a tile, by
// the stem's 2 KB of weights, kept in shared memory likewise.
//
// Q1_pool: one thread per 16 channels of an output pixel, four 16-byte loads
// and __vmaxs4; bound by its bytes (B H W C in, a quarter of that out).

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

namespace q1 {

constexpr int kTW = 16;  // pixel columns of a tile
constexpr int kMaxStages = 8, kMinStages = 4;
constexpr int kStemTH = 8, kStemBN = 64, kStemK = 32, kStemCons = 1;

// CONS consumer warpgroups and one producer warpgroup a block. Two consumers
// share a tile, one block an SM; one consumer takes a whole tile, two blocks
// an SM, whose epilogues and main loops the SM interleaves.
__host__ __device__ constexpr int threads(int cons) { return 128 * (cons + 1); }
// the dynamic shared memory a block may use: an SM's 228 KB less 1 KB each
// block reserves, over its blocks
__host__ __device__ constexpr int smem_budget(int cons) { return cons == 2 ? 232448 : 114688; }
// bytes of one requantized stem halo, (TH + 2, 18, 3), padded to 16
__host__ __device__ constexpr int stem_halo(int th) { return (th + 2) * (kTW + 2) * 3; }
__host__ __device__ constexpr int stem_halo_pad(int th) { return (stem_halo(th) + 15) / 16 * 16; }
constexpr uint32_t kLayout32B = 3;  // wgmma descriptor layout of the 32-byte swizzle
constexpr float kRound = 12582912.0f;  // 1.5 * 2^23

// Shared memory of one launch, the same on the host and in the kernel: the
// ring, the resident weights, the staged output tiles (two in turn where the
// ring keeps kMinStages, so a tile's store drains during the next tile), the
// stem's two halos, the barriers, all from a 1024-byte-aligned base
struct Plan {
  int stages, stage_bytes, a_bytes, out_tile, out_bufs, w_off, out_off, halo_off, bars_off,
      total;
};

__host__ __device__ inline Plan make_plan(int th, int bn, int bk, int out_bytes, int w_bytes,
                                          bool stem, int cons) {
  Plan p;
  p.a_bytes = th * kTW * bk;
  p.stage_bytes = p.a_bytes + (w_bytes ? 0 : bn * bk);
  p.out_tile = th * kTW * bn * out_bytes;
  const int halos = stem ? 2 * stem_halo_pad(th) : 0;
  const int other = w_bytes + halos + 8 * (2 * kMaxStages + 2);
  for (p.out_bufs = 2; p.out_bufs >= 1; --p.out_bufs) {
    const int fit = (smem_budget(cons) - 1024 - other - p.out_bufs * p.out_tile) / p.stage_bytes;
    p.stages = fit > kMaxStages ? kMaxStages : fit;
    if (p.stages >= kMinStages || p.out_bufs == 1) break;
  }
  p.w_off = p.stages * p.stage_bytes;
  p.out_off = p.w_off + w_bytes;
  p.halo_off = p.out_off + p.out_bufs * p.out_tile;
  p.bars_off = p.halo_off + halos;
  p.total = 1024 + p.bars_off + 8 * (2 * kMaxStages + 2);
  return p;
}

struct alignas(64) Params {
  CUtensorMap map_x;    // Q1: the int8 input (C, W, H, B), boxes (BK, 16, TH, 1)
  CUtensorMap map_w;    // the weights (9 C, F; the stem's 32, 64), boxes (BK, BN)
  CUtensorMap map_out;  // the output (F, W, H, B), boxes of one staged chunk
  const void* img;      // Q1_stem: the raw image (B, H, W, 3), uint8 or fp32
  const float* avg;     // Q1_stem: (3,) average_rgb
  const float* mult;    // (F,)
  const float* bias;    // (F,)
  float inv_in, inv_next;
  int relu, H, W, C;
  int tiles_n, tiles_w, tiles_h, total;
};

struct Tile {
  int n0, w0, h0, img;
};

template <int TH, int BN>
__device__ __forceinline__ Tile decode(const Params& p, int t) {
  Tile r;
  r.n0 = t % p.tiles_n * BN;
  const int m = t / p.tiles_n, per_img = p.tiles_h * p.tiles_w;
  r.img = m / per_img;
  const int rem = m - r.img * per_img;
  r.h0 = rem / p.tiles_w * TH;
  r.w0 = rem % p.tiles_w * kTW;
  return r;
}

template <int BN>
__device__ __forceinline__ void mma(int (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) sm90::wgmma_m64n256k32_s8(acc, da, db);
  else if constexpr (BN == 128) sm90::wgmma_m64n128k32_s8(acc, da, db);
  else sm90::wgmma_m64n64k32_s8(acc, da, db);
}

// the byte of rint(y * inv) clipped to +-127 (y after ReLU where asked)
__device__ __forceinline__ uint32_t requant_byte(float y, float inv, int relu) {
  if (relu) y = fmaxf(y, 0.f);
  const float t = fminf(fmaxf(__fmul_rn(y, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, kRound));  // low byte: the int8
}

// two fp32 values of mult or bias, kept in program order with the epilogue's
// shared-memory stores (the compiler would hoist every group's loads ahead of
// the first store, beyond the registers the accumulators leave)
__device__ __forceinline__ float2 ld_pair(const float* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ld_volatile_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The stem's producer warpgroup: per tile, the requantized (TH + 2, 18, 3)
// halo into shared memory, then each pixel's 32-byte A row
template <int TH, bool F32IN, int CONS>
__device__ void stem_producer(const Params& p, uint32_t ring, unsigned char* halo_base,
                              uint32_t full_bar, uint32_t empty_bar, int stage_bytes, int stages) {
  constexpr int HW = kTW + 2, kHalo = stem_halo(TH), kPer = (kHalo + 127) / 128;
  const int pt = threadIdx.x - CONS * 128;
  const float avg0 = __ldg(p.avg), avg1 = __ldg(p.avg + 1), avg2 = __ldg(p.avg + 2);
  // the next tile's pixels as loaded (fp32 bits or a byte), converted only at
  // the requant, so the loads stay in flight while this tile's rows are built
  uint32_t v[kPer];
  uint32_t inside = 0;
  auto load = [&](int t) {
    const Tile tile = decode<TH, kStemBN>(p, t);
    inside = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = pt + 128 * e, hr = idx / (HW * 3), rem = idx - hr * HW * 3;
      const int wc = rem / 3, c = rem - wc * 3;
      const int gy = tile.h0 - 1 + hr, gx = tile.w0 - 1 + wc;
      v[e] = 0;
      if (idx < kHalo && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        const size_t at = (((size_t)tile.img * p.H + gy) * p.W + gx) * 3 + c;
        if constexpr (F32IN) v[e] = __ldg(static_cast<const uint32_t*>(p.img) + at);
        else v[e] = __ldg(static_cast<const unsigned char*>(p.img) + at);
        inside |= 1u << e;
      }
    }
  };
  int s = 0, phase = 0, it = 0;
  if ((int)blockIdx.x < p.total) load(blockIdx.x);
  for (int t = blockIdx.x; t < p.total; t += gridDim.x, ++it) {
    // two halos in turn: this one was last read for tile it - 2, and every
    // thread finished those reads before the barrier of tile it - 1
    unsigned char* halo = halo_base + (it & 1) * stem_halo_pad(TH);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = pt + 128 * e;
      if (idx >= kHalo) continue;
      signed char q = 0;  // SAME padding: zero in the requantized map
      if (inside >> e & 1u) {
        const int c = idx % 3;
        const float a = c == 0 ? avg0 : c == 1 ? avg1 : avg2;
        const float x = F32IN ? __uint_as_float(v[e]) : (float)v[e];
        const float r = rintf(__fmul_rn(__fsub_rn(x, a), p.inv_in));
        q = (signed char)__float2int_rn(fminf(fmaxf(r, -127.f), 127.f));
      }
      halo[idx] = (unsigned char)q;
    }
    sm90::named_barrier_sync(1, 128);  // the halo is whole
    if (t + (int)gridDim.x < p.total) load(t + gridDim.x);  // in flight during the rows
    sm90::mbar_wait(empty_bar + 8u * s, phase ^ 1);
    const uint32_t stage = ring + s * stage_bytes;
#pragma unroll
    for (int k = 0; k < TH * kTW / 128; ++k) {
      const int row = pt + 128 * k, py = row / kTW, px = row % kTW;
      uint32_t word[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const unsigned char* src = halo + ((py + r) * HW + px) * 3;  // taps (r, 0..2), 9 bytes
#pragma unroll
        for (int u = 0; u < 9; ++u) {
          const int k = r * 9 + u;
          word[k / 4] |= (uint32_t)src[u] << (8 * (k % 4));
        }
      }
      // the row's two 16-byte chunks, 32-byte swizzle: chunk ^= bit 7 of the offset
      const uint32_t o = row * kStemK, flip = ((o >> 7) & 1u) << 4;
      const uint32_t a0 = stage + (o ^ flip), a1 = stage + ((o + 16) ^ flip);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a0), "r"(word[0]),
                   "r"(word[1]), "r"(word[2]), "r"(word[3]) : "memory");
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a1), "r"(word[4]),
                   "r"(word[5]), "r"(word[6]), "r"(word[7]) : "memory");
    }
    sm90::fence_proxy_async();  // the rows, written by threads, read by wgmma
    sm90::mbar_arrive(full_bar + 8u * s);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// STEM: 0 Q1 (A by TMA), 1 Q1_stem on uint8 pixels, 2 on fp32 pixels. RES:
// the weights (F = BN) loaded once a block and kept in shared memory, else a
// (BK, BN) slice in each stage. out (B, H, W, F): int8 after the requant, or
// fp32 (F32 = true)
template <int TH, int BN, int BK, bool F32, int STEM, int CONS, bool RES>
__global__ void __launch_bounds__(threads(CONS), 3 - CONS)
conv_kernel(const __grid_constant__ Params p) {
  constexpr int kM = TH * kTW, kMH = kM / CONS, kSub = kMH / 64;
  constexpr int kOB = F32 ? 4 : 1;                             // output bytes a value
  constexpr int kSW = BN * kOB >= 128 ? 128 : BN * kOB;        // staged row chunk, bytes
  constexpr int kChunks = BN * kOB / kSW;
  constexpr uint32_t kLayout =
      BK == 128 ? sm90::kLayout128B : BK == 64 ? sm90::kLayout64B : kLayout32B;
  static_assert(BK == 128 || BK == 64 || BK == 32, "one swizzle row of int8");
  static_assert(kMH % 64 == 0 && (kSW == 128 || kSW == 64), "tile shape");
  static_assert(STEM == 0 || (BN == kStemBN && BK == kStemK && !F32 && RES), "stem");

  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = sm90::smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem + (base - raw);
  const int nk = STEM ? 1 : 9 * (p.C / BK);  // K steps a tile
  const Plan plan = make_plan(TH, BN, BK, kOB, RES ? nk * BN * BK : 0, STEM != 0, CONS);
  const uint32_t bars = base + plan.bars_off;
  const uint32_t full_bar = bars, empty_bar = bars + 8u * kMaxStages;
  const uint32_t w_bar = bars + 16u * kMaxStages;
  const uint32_t zero_word = w_bar + 8;  // holds 0; see the epilogue
  const uint32_t res_w = base + plan.w_off;
  const int tid = threadIdx.x, g = tid / 128;  // warpgroup

  if (tid == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      sm90::mbar_init(full_bar + 8u * s, STEM ? 128 : 1);
      sm90::mbar_init(empty_bar + 8u * s, CONS);
    }
    sm90::mbar_init(w_bar, 1);
    asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(zero_word));
    sm90::fence_barrier_init();
  } else if (tid == CONS * 128) {
    if constexpr (STEM == 0) sm90::prefetch_tensormap(&p.map_x);
    sm90::prefetch_tensormap(&p.map_w);
    sm90::prefetch_tensormap(&p.map_out);
  }
  __syncthreads();

  if (g == CONS) {  // producer warpgroup
    if (RES && tid == CONS * 128) {  // the weights, once
      sm90::mbar_arrive_expect_tx(w_bar, nk * BN * BK);
      for (int kt = 0; kt < nk; ++kt)
        sm90::tma_load_2d(res_w + kt * BN * BK, &p.map_w, w_bar, kt * BK, 0);
    }
    if constexpr (STEM != 0) {
      stem_producer<TH, STEM == 2, CONS>(p, base, sbase + plan.halo_off, full_bar, empty_bar,
                                         plan.stage_bytes, plan.stages);
    } else {
      if constexpr (CONS == 2) sm90::setmaxnreg_dec<40>();
      if (tid == CONS * 128) {  // one thread starts every load
        const int cblocks = p.C / BK;
        int s = 0, phase = 0;
        for (int t = blockIdx.x; t < p.total; t += gridDim.x) {
          const Tile tile = decode<TH, BN>(p, t);
          for (int kt = 0; kt < nk; ++kt) {
            const int tap = kt / cblocks, c0 = (kt - tap * cblocks) * BK;
            sm90::mbar_wait(empty_bar + 8u * s, phase ^ 1);
            // a box past the map's edge is zero-filled and still counts its full bytes
            sm90::mbar_arrive_expect_tx(full_bar + 8u * s, plan.stage_bytes);
            const uint32_t sa = base + s * plan.stage_bytes;
            sm90::tma_load_4d(sa, &p.map_x, full_bar + 8u * s, c0, tile.w0 + tap % 3 - 1,
                              tile.h0 + tap / 3 - 1, tile.img);
            if constexpr (!RES)
              sm90::tma_load_2d(sa + plan.a_bytes, &p.map_w, full_bar + 8u * s, kt * BK, tile.n0);
            if (++s == plan.stages) {
              s = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup g: pixel rows g TH / CONS .. of each tile
  if constexpr (STEM == 0 && CONS == 2) sm90::setmaxnreg_inc<232>();
  if constexpr (RES) sm90::mbar_wait(w_bar, 0);
  const int lt = tid % 128, warp = lt / 32, lane = lt % 32;
  int s = 0, phase = 0, it = 0;
  for (int t = blockIdx.x; t < p.total; t += gridDim.x, ++it) {
    const Tile tile = decode<TH, BN>(p, t);
    int acc[kSub][BN / 2];
#pragma unroll
    for (int j = 0; j < kSub; ++j)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[j][i] = 0;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      sm90::mbar_wait(full_bar + 8u * s, phase);
      const uint32_t sa = base + s * plan.stage_bytes + g * kMH * BK;  // this warpgroup's rows
      const uint32_t sb = RES ? res_w + kt * BN * BK : base + s * plan.stage_bytes + plan.a_bytes;
#pragma unroll
      for (int j = 0; j < kSub; ++j) sm90::fence_operands(acc[j]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)  // 32 bytes along both operands' swizzled rows
#pragma unroll
        for (int j = 0; j < kSub; ++j)
          mma<BN>(acc[j], sm90::make_desc(sa + j * 64 * BK + 32 * kk, 16, 8 * BK, kLayout),
                  sm90::make_desc(sb + 32 * kk, 16, 8 * BK, kLayout));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the products of step kt - 1 are done: release its stage
#pragma unroll
      for (int j = 0; j < kSub; ++j) sm90::fence_operands(acc[j]);
      if (kt > 0 && lt == 0) sm90::mbar_arrive(empty_bar + 8u * prev);
      prev = s;
      if (++s == plan.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kSub; ++j) sm90::fence_operands(acc[j]);
    if (lt == 0) sm90::mbar_arrive(empty_bar + 8u * prev);

    // epilogue: this staged tile is free once the store that last read it
    // (the previous tile's, or with two buffers the one before) is done reading
    const uint32_t staged = base + plan.out_off + (it % plan.out_bufs) * plan.out_tile +
                            g * (kMH * BN * kOB);
    if (lt == 0) {
      if (plan.out_bufs == 2) sm90::bulk_wait_read<1>();
      else sm90::bulk_wait_read<0>();
    }
    sm90::named_barrier_sync(2 + g, 128);
    // accumulator i of thread t: row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2)
    // of the m64 block, column 8 (i / 4) + 2 (t % 4) + i % 2
    // The staged rows' swizzle: 16-byte chunk ^= bits 7-9 (128-byte rows) or
    // 7-8 (64-byte rows) of the offset, for this thread's rows always
    // (lane / 4) & 7, resp. (lane / 8) & 3 (the rows' other terms are
    // multiples of 8). Adding the volatile zero word makes it a value of this
    // tile, so the compiler computes each store's offset here instead of
    // holding every one across the main loop (registers it lacks).
    const uint32_t flip =
        ((kSW == 128 ? (lane / 4) & 7 : (lane / 8) & 3) << 4) + ld_volatile_shared(zero_word);
    const float* mult = p.mult + tile.n0 + 2 * (lane % 4);
    const float* bias = p.bias + tile.n0 + 2 * (lane % 4);
    float2 m_next = ld_pair(mult), b_next = ld_pair(bias);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const float2 m = m_next, b = b_next;
      if (i + 4 < BN / 2) {  // the next group's, in flight during this one's
        m_next = ld_pair(mult + 8 * (i / 4 + 1));
        b_next = ld_pair(bias + 8 * (i / 4 + 1));
      }
      constexpr int kPerChunk = kSW / kOB;  // columns of one staged chunk
      const uint32_t chunk = staged + (col / kPerChunk) * (kMH * kSW);
      const int cb = (col % kPerChunk) * kOB;
#pragma unroll
      for (int j = 0; j < kSub; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * j + 16 * warp + lane / 4 + 8 * h;
          const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][i + 2 * h]), m.x), b.x);
          const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][i + 2 * h + 1]), m.y), b.y);
          const uint32_t at = chunk + row * kSW + (cb ^ flip);
          if constexpr (F32) {
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(y0), "f"(y1)
                         : "memory");
          } else {
            const uint32_t pair = __byte_perm(requant_byte(y0, p.inv_next, p.relu),
                                              requant_byte(y1, p.inv_next, p.relu), 0x0040);
            asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(at), "h"((unsigned short)pair)
                         : "memory");
          }
        }
    }
    sm90::fence_proxy_async();  // the staged tile, written by threads, read by TMA
    sm90::named_barrier_sync(2 + g, 128);
    if (lt == 0) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
        sm90::tma_store_4d(&p.map_out, staged + q * (kMH * kSW), tile.n0 + q * (kSW / kOB),
                           tile.w0, tile.h0 + g * (TH / CONS), tile.img);
      sm90::bulk_commit();
    }
  }
  if (lt == 0) sm90::bulk_wait<0>();  // the last stores are done before the block exits
}

int sm_count() {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return err == cudaSuccess ? sms : -(int)err;
}

// encode the output map, fill the tile counts and launch the persistent grid:
// as many blocks as fit on the card at once, at most one a tile
template <int TH, int BN, int BK, bool F32, int STEM, int CONS, bool RES>
int launch(Params& p, void* out, int B, int F, cudaStream_t stream) {
  constexpr int kOB = F32 ? 4 : 1, kSW = BN * kOB >= 128 ? 128 : BN * kOB;
  const uint64_t dims_o[4] = {(uint64_t)F, (uint64_t)p.W, (uint64_t)p.H, (uint64_t)B};
  const uint64_t strides_o[3] = {(uint64_t)F * kOB, (uint64_t)p.W * F * kOB,
                                 (uint64_t)p.H * p.W * F * kOB};
  const uint32_t box_o[4] = {kSW / kOB, kTW, TH / CONS, 1};
  const CUtensorMapSwizzle sw = kSW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  int err = F32 ? sm90::encode_f32(&p.map_out, 4, out, dims_o, strides_o, box_o, sw)
                : sm90::encode_s8(&p.map_out, 4, out, dims_o, strides_o, box_o, sw);
  if (err) return err;
  p.tiles_n = F / BN;
  p.tiles_w = (p.W + kTW - 1) / kTW;
  p.tiles_h = (p.H + TH - 1) / TH;
  const long long total = (long long)B * p.tiles_h * p.tiles_w * p.tiles_n;
  if (total >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  p.total = (int)total;
  const int nk = STEM ? 1 : 9 * (p.C / BK);
  if (RES && F != BN) return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(TH, BN, BK, kOB, RES ? nk * BN * BK : 0, STEM != 0, CONS);
  if (plan.stages < kMinStages) return (int)cudaErrorInvalidValue;
  auto kernel = conv_kernel<TH, BN, BK, F32, STEM, CONS, RES>;
  static const int attr_err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_budget(CONS));
  if (attr_err) return attr_err;
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads(CONS), plan.total);
  if (occ != cudaSuccess) return (int)occ;
  const int sms = sm_count();
  if (sms <= 0) return sms < 0 ? -sms : (int)cudaErrorInvalidValue;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * per_sm;
  const int grid = p.total < slots ? p.total : (int)slots;
  kernel<<<grid, threads(CONS), plan.total, stream>>>(p);
  return (int)cudaGetLastError();
}

// the compiled tile shapes (TH, BN, BK, fp32 out, consumer warpgroups,
// resident weights), as ops/kernels/int8_conv.py::tile_shape picks them
#define Q1_TILES(X)                                               \
  X(8, 64, 64, false, 1, true) X(16, 128, 64, false, 2, false)    \
  X(8, 256, 128, false, 2, false) X(8, 256, 64, true, 2, false)

// 1 for a compiled tile shape whose weights stay resident, 0 for one that
// streams them, -1 for one not compiled
inline int compiled(int th, int bn, int bk, int out_f32, int cons) {
#define Q1_IS(TH, BN, BK, F32, CONS, RES) \
  if (th == TH && bn == BN && bk == BK && (out_f32 != 0) == F32 && cons == CONS) return RES;
  Q1_TILES(Q1_IS)
#undef Q1_IS
  return -1;
}

// ---------------------------------------------------------------- Q1_pool

// out (B, H / 2, W / 2, C) = max over each 2x2 window of x (B, H, W, C), int8,
// floor (an odd last row or column is dropped), C a multiple of 16
__global__ void __launch_bounds__(256)
pool_kernel(const int4* __restrict__ x, int4* __restrict__ out, long long total, int H, int W,
            int Ho, int Wo, int C16) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C16);
  long long rest = i / C16;
  const int wo = (int)(rest % Wo);
  rest /= Wo;
  const int ho = (int)(rest % Ho);
  const long long b = rest / Ho;
  const int4* p = x + ((b * H + 2 * ho) * W + 2 * wo) * C16 + c;
  const int4 a = __ldg(p), bb = __ldg(p + C16), cc = __ldg(p + (long long)W * C16),
             d = __ldg(p + (long long)W * C16 + C16);
  int4 m;
  m.x = __vmaxs4(__vmaxs4(a.x, bb.x), __vmaxs4(cc.x, d.x));
  m.y = __vmaxs4(__vmaxs4(a.y, bb.y), __vmaxs4(cc.y, d.y));
  m.z = __vmaxs4(__vmaxs4(a.z, bb.z), __vmaxs4(cc.z, d.z));
  m.w = __vmaxs4(__vmaxs4(a.w, bb.w), __vmaxs4(cc.w, d.w));
  out[i] = m;
}

}  // namespace q1

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) { return sm90::error_string(err); }

// Q1's launch for tile (th, bn, bk), fp32 output or not and `cons` consumer
// warpgroups, on C input channels: what = 0 its ring stages, 1 its dynamic
// shared memory, 2 the tile's pixel columns, 3 the blocks an SM, 4 whether
// its weights stay resident; -1 for a tile shape that is not compiled
int scl_int8_conv_config(int what, int th, int bn, int bk, int out_f32, int cons, int C) {
  const int res = q1::compiled(th, bn, bk, out_f32, cons);
  if (res < 0 || C % bk) return -1;
  const q1::Plan plan =
      q1::make_plan(th, bn, bk, out_f32 ? 4 : 1, res ? 9 * C * bn : 0, false, cons);
  switch (what) {
    case 0: return plan.stages;
    case 1: return plan.total;
    case 2: return q1::kTW;
    case 3: return 3 - cons;
    case 4: return res;
  }
  return -1;
}

// Q1_stem's: what = 0 ring stages, 1 dynamic shared memory, 2 the tile's pixel
// rows, 3 its columns, 4 the output channels it takes, 5 its consumer
// warpgroups (blocks an SM: 3 less that)
int scl_int8_stem_config(int what) {
  const q1::Plan plan = q1::make_plan(q1::kStemTH, q1::kStemBN, q1::kStemK, 1,
                                      q1::kStemBN * q1::kStemK, true, q1::kStemCons);
  switch (what) {
    case 0: return plan.stages;
    case 1: return plan.total;
    case 2: return q1::kStemTH;
    case 3: return q1::kTW;
    case 4: return q1::kStemBN;
    case 5: return q1::kStemCons;
  }
  return -1;
}

// x (B, H, W, C) int8, w (F, 3, 3, C) int8, both contiguous and 16-byte
// aligned (TMA); mult and bias (F,) fp32, 8-byte aligned; out (B, H, W, F)
// int8 (out_f32 == 0: ReLU where relu != 0, then the requant by inv_next) or
// fp32 (out_f32 != 0: y alone), 16-byte aligned. Tile (th, bn, bk) with `cons`
// consumer warpgroups one of Q1_TILES, C a multiple of bk, F of bn (F = bn
// for a tile with resident weights, C small enough for them). Returns
// the first error: a refused tensor map (sm90::kErrTensorMap + CUresult) or
// cudaGetLastError() of the launch, else 0.
int scl_int8_conv(const void* x, const void* w, void* out, const float* mult, const float* bias,
                  float inv_next, int relu, int out_f32, int B, int H, int W, int C, int F,
                  int th, int bn, int bk, int cons, void* stream) {
  if (C % bk || F % bn || B <= 0 || H <= 0 || W <= 0 ||
      q1::compiled(th, bn, bk, out_f32, cons) < 0)
    return (int)cudaErrorInvalidValue;
  q1::Params p{};
  const CUtensorMapSwizzle swizzle =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint64_t dims_x[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides_x[3] = {(uint64_t)C, (uint64_t)W * C, (uint64_t)H * W * C};
  const uint32_t box_x[4] = {(uint32_t)bk, (uint32_t)q1::kTW, (uint32_t)th, 1};
  int err = sm90::encode_s8(&p.map_x, 4, x, dims_x, strides_x, box_x, swizzle);
  if (err) return err;
  const uint64_t dims_w[2] = {(uint64_t)9 * C, (uint64_t)F};
  const uint64_t strides_w[1] = {(uint64_t)9 * C};
  const uint32_t box_w[2] = {(uint32_t)bk, (uint32_t)bn};
  err = sm90::encode_s8(&p.map_w, 2, w, dims_w, strides_w, box_w, swizzle);
  if (err) return err;
  p.mult = mult;
  p.bias = bias;
  p.inv_next = inv_next;
  p.relu = relu;
  p.H = H;
  p.W = W;
  p.C = C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define Q1_LAUNCH(TH, BN, BK, F32, CONS, RES)                                     \
  if (th == TH && bn == BN && bk == BK && (out_f32 != 0) == F32 && cons == CONS) \
    return q1::launch<TH, BN, BK, F32, 0, CONS, RES>(p, out, B, F, s);
  Q1_TILES(Q1_LAUNCH)
#undef Q1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Q1_stem: img (B, H, W, 3) uint8 (img_f32 == 0) or fp32, contiguous; avg (3,)
// fp32; w (64, 32) int8, the 27 (r, s, c) taps of each output channel then 5
// zeros, 16-byte aligned; mult, bias (64,) fp32, 8-byte aligned; out
// (B, H, W, 64) int8, 16-byte aligned: the 3x3 conv of
// clip(rint((img - avg) * inv_in), +-127) with the epilogue of scl_int8_conv.
int scl_int8_stem(const void* img, int img_f32, const float* avg, float inv_in, const void* w,
                  void* out, const float* mult, const float* bias, float inv_next, int relu,
                  int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  q1::Params p{};
  const uint64_t dims_w[2] = {(uint64_t)q1::kStemK, (uint64_t)q1::kStemBN};
  const uint64_t strides_w[1] = {(uint64_t)q1::kStemK};
  const uint32_t box_w[2] = {(uint32_t)q1::kStemK, (uint32_t)q1::kStemBN};
  const int err =
      sm90::encode_s8(&p.map_w, 2, w, dims_w, strides_w, box_w, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err) return err;
  p.img = img;
  p.avg = avg;
  p.inv_in = inv_in;
  p.mult = mult;
  p.bias = bias;
  p.inv_next = inv_next;
  p.relu = relu;
  p.H = H;
  p.W = W;
  p.C = q1::kStemK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int TH = q1::kStemTH, N = q1::kStemBN, K = q1::kStemK, CONS = q1::kStemCons;
  return img_f32 ? q1::launch<TH, N, K, false, 2, CONS, true>(p, out, B, N, s)
                 : q1::launch<TH, N, K, false, 1, CONS, true>(p, out, B, N, s);
}

// x (B, H, W, C) int8 -> out (B, H / 2, W / 2, C), the 2x2 floor max-pool; C a
// multiple of 16, both 16-byte aligned
int scl_int8_pool(const void* x, void* out, int B, int H, int W, int C, void* stream) {
  if (C % 16 || B <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int Ho = H / 2, Wo = W / 2, C16 = C / 16;
  const long long total = (long long)B * Ho * Wo * C16;
  const long long blocks = (total + 255) / 256;
  q1::pool_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), total, H, W, Ho, Wo, C16);
  return (int)cudaGetLastError();
}

}  // extern "C"
