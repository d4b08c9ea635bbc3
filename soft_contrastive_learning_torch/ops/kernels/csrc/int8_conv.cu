// Q1: int8 3x3 SAME convolution as an implicit GEMM for Hopper, sm_90a, with
// the post-training-quantized stack's epilogue fused; Q1_pool: the 2x2 floor
// max-pool on int8 that follows each block-final conv.
//
// Replaces XLA work, not a Pallas kernel: the int8 conv of
// soft_contrastive_learning_tpu/models/quant.py::quantized_conv_stack
// (conv_general_dilated, int8 x int8 -> int32, then the elementwise dequant,
// bias, ReLU and requant) and its reduce_window max on int8. The port's
// framework has no int8 convolution on CUDA.
//
// What it computes. x (B, H, W, C) int8 NHWC, w (F, T, T, C) int8 K-major
// (T = 3, or T = 1 for the stem's packed columns), SAME padding (inputs past
// the edge read as zero): acc[b, h, w, f] = sum over (r, s, c) of
// x[b, h + r - T/2, w + s - T/2, c] * w[f, r, s, c], exact in int32. Then
// y = float(acc) * m[f] + bias[f] (two fp32 roundings, __fmul_rn/__fadd_rn, as
// JAX's separate multiply and add), and either y as fp32 (conv5_3: no ReLU),
// or ReLU where asked, then rint(y * inv_next) clipped to +-127 as int8
// (rintf rounds half to even, as jnp.round and the plain version do).
//
// Bound on this card: 2 B H W T^2 C F operations at the int8 tensor-core rate
// (1,979 TOP/s) against the int8 input, the weights and the output read or
// written once (B H W C + T^2 C F + B H W F bytes, x4 for an fp32 output) at
// 3.35 TB/s. Every VGG16 layer at 180x240 is operation-bound (T^2 C >= 576
// operations per input byte but the stem's).
//
// Design: P4's integer wgmma + TMA mainloop (probe_gemm.cu) with A gathered
// by TMA from the NHWC input instead of a matrix. A block owns an 8 x 16 pixel
// tile of one image (M = 128 rows, two consumer warpgroups of 64) and BN output
// channels, and loops over K = T^2 C in steps of BK channels of one tap: for
// tap (r, s) and channel block c0 the producer thread loads the 4-D box
// (BK, 16, 8, 1) at (c0, w0 + s - 1, h0 + r - 1, b) of the input, which TMA
// fills with zeros where it runs past the edge (the SAME padding, no padded
// copy, no im2col in memory), and the (BN, BK) box of the weights at
// (tap C + c0, n0). The box lands as 128 rows of BK bytes, K-major with the
// 128-, 64- or 32-byte swizzle (BK = 128, 64, 32), which is wgmma's s8 A
// layout. The ring holds 4-6 stages (full and empty mbarriers); setmaxnreg
// gives the consumers 232 registers. The epilogue dequantizes, adds the bias,
// applies ReLU and requantizes from the accumulators and stores int8 pairs
// (or fp32 pairs), the pixels past the map's edge masked. The stem (C = 3)
// arrives as packed columns: the 27 (r, s, c) values of each pixel padded to
// 32, a 1x1 conv with BK = 32.
//
// Q1_pool: one thread per 16 channels of an output pixel, four 16-byte loads
// and __vmaxs4; bound by its bytes (B H W C in, a quarter of that out).

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

namespace q1 {

constexpr int kTH = 8, kTW = 16;  // the pixel tile: 8 rows of 16
constexpr int kBM = kTH * kTW;    // GEMM rows a block owns
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kLayout32B = 3;  // wgmma descriptor layout of the 32-byte swizzle

template <int BN, int BK> struct Shape {
  static constexpr int kABytes = kBM * BK;  // one (BK, 16, 8) box of the input
  static constexpr int kBBytes = BN * BK;   // one (BK, BN) box of the weights
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes < 6 ? 200 * 1024 / kStageBytes : 6;
  // + 1 KB to align the ring to the swizzle's 1024 bytes, + the barriers
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
  static constexpr uint32_t kLayout =
      BK == 128 ? sm90::kLayout128B : BK == 64 ? sm90::kLayout64B : kLayout32B;
  static constexpr uint32_t kRowGroup = 8 * BK;  // 8 rows of one swizzle row each
  static_assert(BK == 128 || BK == 64 || BK == 32, "one swizzle row of int8");
  static_assert(kStages >= 4, "at least four stages in flight");
};

template <int BN>
__device__ __forceinline__ void mma(int (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) sm90::wgmma_m64n256k32_s8(acc, da, db);
  else if constexpr (BN == 128) sm90::wgmma_m64n128k32_s8(acc, da, db);
  else sm90::wgmma_m64n64k32_s8(acc, da, db);
}

__device__ __forceinline__ signed char requant(float y, float inv, int relu) {
  if (relu) y = fmaxf(y, 0.f);
  const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(q));
}

// out (B, H, W, F): int8 after requant, or fp32 (F32 = true)
template <int BN, int BK, bool F32>
__global__ void __launch_bounds__(kThreads, 1)
conv_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            void* __restrict__ out, const float* __restrict__ mult,
            const float* __restrict__ bias, float inv_next, int relu, int H, int W, int C, int F,
            int taps) {
  using S = Shape<BN, BK>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (sm90::smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t bars = base + S::kStages * S::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S::kStages + s); };

  // the output channels vary fastest, so the blocks that share an input tile run together
  const int tiles_n = F / BN, tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  const int pid = blockIdx.x, n0 = pid % tiles_n * BN;
  const int m_tile = pid / tiles_n, per_img = tiles_h * tiles_w;
  const int img = m_tile / per_img, rem = m_tile % per_img;
  const int h0 = rem / tiles_w * kTH, w0 = rem % tiles_w * kTW;
  const int cblocks = C / BK, nk = taps * cblocks, pad = taps == 9 ? 1 : 0;
  const int tid = threadIdx.x, g = tid / 128;  // warpgroup

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::fence_barrier_init();
  } else if (tid == kConsumers * 128) {
    sm90::prefetch_tensormap(&map_x);
    sm90::prefetch_tensormap(&map_w);
  }
  __syncthreads();

  if (g == kConsumers) {  // producer warpgroup: one thread issues every load
    sm90::setmaxnreg_dec<40>();
    if (tid == kConsumers * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S::kStages, tap = kt / cblocks, c0 = (kt - tap * cblocks) * BK;
        sm90::mbar_wait(empty(s), ((kt / S::kStages) & 1) ^ 1);
        // a box past the map's edge is zero-filled and still counts its full bytes
        sm90::mbar_arrive_expect_tx(full(s), S::kStageBytes);
        const uint32_t sa = base + s * S::kStageBytes;
        sm90::tma_load_4d(sa, &map_x, full(s), c0, w0 + tap % 3 - pad, h0 + tap / 3 - pad, img);
        sm90::tma_load_2d(sa + S::kABytes, &map_w, full(s), kt * BK, n0);
      }
    }
  } else {  // consumer warpgroup g: pixel rows 4 g .. 4 g + 3 of the tile
    sm90::setmaxnreg_inc<232>();
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S::kStages;
      sm90::mbar_wait(full(s), (kt / S::kStages) & 1);
      const uint32_t sa = base + s * S::kStageBytes + g * 64 * BK;  // this warpgroup's rows
      const uint32_t sb = base + s * S::kStageBytes + S::kABytes;
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)  // 32 bytes along both operands' swizzled rows
        mma<BN>(acc, sm90::make_desc(sa + 32 * kk, 16, S::kRowGroup, S::kLayout),
                sm90::make_desc(sb + 32 * kk, 16, S::kRowGroup, S::kLayout));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the products of step kt - 1 are done: release its stage
      sm90::fence_operands(acc);
      if (kt > 0 && tid % 128 == 0) sm90::mbar_arrive(empty((kt - 1) % S::kStages));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);

    // accumulator i of thread t: row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) of the
    // warpgroup's 64, column 8 (i / 4) + 2 (t % 4) + i % 2
    const int lane = tid % 32, row0 = g * 64 + (tid % 128) / 32 * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = row0 + 8 * h, y = h0 + p / kTW, x = w0 + p % kTW;
      if (y >= H || x >= W) continue;
      const size_t pixel = ((size_t)img * H + y) * W + x;
#pragma unroll
      for (int i = 0; i < BN / 2; i += 4) {
        const int col = col0 + 2 * i;
        const float m0 = __ldg(mult + col), m1 = __ldg(mult + col + 1);
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i + 2 * h]), m0), b0);
        const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i + 2 * h + 1]), m1), b1);
        if constexpr (F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + pixel * F + col) =
              make_float2(y0, y1);
        } else {
          char2 v;
          v.x = requant(y0, inv_next, relu);
          v.y = requant(y1, inv_next, relu);
          *reinterpret_cast<char2*>(static_cast<signed char*>(out) + pixel * F + col) = v;
        }
      }
    }
  }
}

template <int BN, int BK, bool F32>
int launch(const void* x, const void* w, void* out, const float* mult, const float* bias,
           float inv_next, int relu, int B, int H, int W, int C, int F, int taps,
           cudaStream_t stream) {
  using S = Shape<BN, BK>;
  const CUtensorMapSwizzle swizzle = BK == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : BK == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap map_x, map_w;
  const uint64_t dims_x[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides_x[3] = {(uint64_t)C, (uint64_t)W * C, (uint64_t)H * W * C};
  const uint32_t box_x[4] = {BK, kTW, kTH, 1};
  int err = sm90::encode_s8(&map_x, 4, x, dims_x, strides_x, box_x, swizzle);
  if (err) return err;
  const uint64_t dims_w[2] = {(uint64_t)taps * C, (uint64_t)F};
  const uint64_t strides_w[1] = {(uint64_t)taps * C};
  const uint32_t box_w[2] = {BK, BN};
  err = sm90::encode_s8(&map_w, 2, w, dims_w, strides_w, box_w, swizzle);
  if (err) return err;
  auto kernel = conv_kernel<BN, BK, F32>;
  static const int attr_err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (attr_err) return attr_err;
  const long long blocks =
      (long long)B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW) * (F / BN);
  kernel<<<(unsigned)blocks, kThreads, S::kSmemBytes, stream>>>(
      map_x, map_w, out, mult, bias, inv_next, relu, H, W, C, F, taps);
  return (int)cudaGetLastError();
}

template <int BK, bool F32>
int launch_bn(int bn, const void* x, const void* w, void* out, const float* mult,
              const float* bias, float inv_next, int relu, int B, int H, int W, int C, int F,
              int taps, cudaStream_t s) {
  switch (bn) {
    case 256: return launch<256, BK, F32>(x, w, out, mult, bias, inv_next, relu, B, H, W, C, F,
                                          taps, s);
    case 128: return launch<128, BK, F32>(x, w, out, mult, bias, inv_next, relu, B, H, W, C, F,
                                          taps, s);
    case 64: return launch<64, BK, F32>(x, w, out, mult, bias, inv_next, relu, B, H, W, C, F,
                                        taps, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool F32>
int launch_bk(int bk, int bn, const void* x, const void* w, void* out, const float* mult,
              const float* bias, float inv_next, int relu, int B, int H, int W, int C, int F,
              int taps, cudaStream_t s) {
  switch (bk) {
    case 128: return launch_bn<128, F32>(bn, x, w, out, mult, bias, inv_next, relu, B, H, W, C,
                                         F, taps, s);
    case 64: return launch_bn<64, F32>(bn, x, w, out, mult, bias, inv_next, relu, B, H, W, C, F,
                                       taps, s);
    case 32: return launch_bn<32, F32>(bn, x, w, out, mult, bias, inv_next, relu, B, H, W, C, F,
                                       taps, s);
  }
  return (int)cudaErrorInvalidValue;
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

// Q1's tile: what = 0 the pixel rows of a tile (8), 1 its columns (16), 2 the
// dynamic shared memory of tile (bn, bk), 3 its pipeline stages; -1 for a
// tile shape that is not compiled
int scl_int8_conv_config(int what, int bn, int bk) {
  if (what == 0) return q1::kTH;
  if (what == 1) return q1::kTW;
  if ((bn != 64 && bn != 128 && bn != 256) || (bk != 32 && bk != 64 && bk != 128)) return -1;
#define Q1_SHAPE(BN, BK)                                                \
  if (bn == BN && bk == BK)                                             \
    return what == 2 ? q1::Shape<BN, BK>::kSmemBytes : q1::Shape<BN, BK>::kStages;
  Q1_SHAPE(256, 128) Q1_SHAPE(256, 64) Q1_SHAPE(256, 32)
  Q1_SHAPE(128, 128) Q1_SHAPE(128, 64) Q1_SHAPE(128, 32)
  Q1_SHAPE(64, 128) Q1_SHAPE(64, 64) Q1_SHAPE(64, 32)
#undef Q1_SHAPE
  return -1;
}

// x (B, H, W, C) int8, w (F, taps, C) int8 (taps = 9: a 3x3 conv, 1: a 1x1),
// both contiguous and 16-byte aligned (TMA); mult and bias (F,) fp32; out
// (B, H, W, F) int8 (out_f32 == 0: ReLU where relu != 0, then the requant by
// inv_next) or fp32 (out_f32 != 0: y alone). C a multiple of bk, F of bn; bk
// in {32, 64, 128}, bn in {64, 128, 256}. Returns the first error: a refused
// tensor map (sm90::kErrTensorMap + CUresult) or cudaGetLastError() of the
// launch, else 0.
int scl_int8_conv(const void* x, const void* w, void* out, const float* mult, const float* bias,
                  float inv_next, int relu, int out_f32, int B, int H, int W, int C, int F,
                  int taps, int bn, int bk, void* stream) {
  if ((taps != 9 && taps != 1) || C % bk || F % bn || B <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return q1::launch_bk<true>(bk, bn, x, w, out, mult, bias, inv_next, relu, B, H, W, C, F,
                               taps, s);
  return q1::launch_bk<false>(bk, bn, x, w, out, mult, bias, inv_next, relu, B, H, W, C, F,
                              taps, s);
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
