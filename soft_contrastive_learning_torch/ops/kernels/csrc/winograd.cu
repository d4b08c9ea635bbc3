// Fused Winograd F(2x2, 3x3) convolution (K4) for Hopper, sm_90a.
//
// Replaces soft_contrastive_learning_tpu/ops/pallas/winograd_kernel.py
// (_winograd_kernel, called from winograd_conv_pallas, and the weight transform
// that wrapper runs before it). From x (B, H, W, C) bf16 NHWC, the conv weight
// w (F, C, 3, 3) fp32 and bias (F) fp32 it computes the SAME 3x3 stride-1
// convolution + bias (+ ReLU) into out (B, H, W, F), bf16 or fp32. First the
// transformed filter, position p = 4a + b, in fp32 and rounded once:
//   U[p]     = bf16(G w G^T)[a][b],  G rows (1,0,0), (.5,.5,.5), (.5,-.5,.5), (0,0,1),
//              each 3-term sum left to right, .5 ((k0 +- k1) + k2), rows first
//              then columns (ops/winograd.py::weight_transform takes the same
//              sums in the same order, so the two give the same bits)
// Then per 2x2 output tile (i, j) of image n:
//   d[a][b]  = x[n, 2i + a - 1, 2j + b - 1, :]                 zero outside the image
//   V        = B^T d B   in bf16, one rounding per add, rows first then columns,
//                        each in the order (d0-d2, d1+d2, d2-d1, d1-d3)
//   M[p]     = V[p] (tiles, C) . U[p] (C, F)   bf16 operands, fp32 sums, p = 0..15
//   Y        = A^T M A   in fp32:  t0 = (M[0]+M[1])+M[2], t1 = (M[1]-M[2])-M[3] over a,
//                                  then the same two sums over b
//   out      = cast(relu(Y + bias))
// Only the order of the fp32 sums inside M differs from the plain version
// (ops/winograd.py::winograd_conv_plain); no atomics, so the same bits every run.
// The weight transform is a kernel of its own (a thread per (c, f) reads 9
// weights and writes 16 bf16 values, coalesced along f) because as PyTorch ops
// it cost more than the convolution's own launch on the host: an einsum, a
// transposing copy of 16 C F floats and a cast per call.
//
// Bound on this card, from what the function needs: 2 * 16 * B * ceil(H/2) *
// ceil(W/2) * C * F operations at the bf16 tensor-core rate against
// 2 (B H W C + B H W F) + 2 * 16 C F bytes (x and U read once, out written
// once). At B = 64 the flagship's conv2_2 (90x120, 128 -> 128) is byte-bound
// (0.106 ms against 0.092 ms of operations) and every later layer is
// operation-bound (conv4_2, 22x30, 512 -> 512: 0.090 ms).
//
// Design. The TPU kernel keeps the whole U (up to 8 MB) and the full C in VMEM
// per grid cell; an SM has 227 KB. Here a block owns 32 tiles x 64 output
// channels and loops over C in chunks of 32 inside the block: per chunk every
// thread loads one tile's 4x4 patch for one channel pair straight from global
// memory (the halo and the ragged last tile row/column are masked to zero, so
// no padded copy of x exists), transforms it with __hsub2/__hadd2 and writes V
// (16, 32, 32) to shared memory; the block copies U's (16, 32, 64) chunk beside
// it; then warp p of the 16 multiplies V[p] . U[p] with m16n16k16 bf16 mma
// (nvcuda::wmma) into its 2 x 4 fp32 accumulator fragments, which stay in
// registers across the C loop (64 registers a thread). After the last chunk
// the accumulators go to shared memory (over the dead V and U), and each
// thread finishes four (tile, channel) outputs: output transform, bias, ReLU,
// cast, four masked stores of 128 contiguous bytes per warp.
// The grid is ceil(tiles / 32) * (F / 64) blocks, the F chunk fastest so that
// the blocks that share a patch run together and x comes from device memory
// once. Per layer at B = 64: conv2_2 10,800 blocks, conv3_1 5,520, conv3_2/3
// 5,520, conv4_1 2,640, conv4_2/3 2,640, conv5_x 768 (5.8 per SM), so the late
// layers still fill the 132 SMs. What holds it back: a 32 x 64 tile per
// position reuses each U element 32 times and each V element 64 times, which
// is ~21 FLOP per byte brought into shared memory, and every block streams its
// own copy of U's chunks from L2 (64 KB per chunk and SM). Overlapping the
// loads with the mma does not help by itself: a two-stage cp.async variant of
// this loop measured slower (PERF.md), so the next step is fewer bytes per
// SM (U shared across a thread-block cluster), then wgmma.
//
// Stages. The kernel takes a compile-time STAGE, the counterpart of
// perf/winograd_ablate.py::make_kernel(stage): the same code cut short, so that
// the differences between the stages' times say where the full kernel's time
// goes. STAGE 3 (`full`) is the kernel above and the only one winograd_conv
// runs; `if constexpr` keeps every line of the others out of it. Each shorter
// stage writes something a plain version reproduces
// (ops/winograd.py::winograd_stage_plain), so that the compiler cannot drop
// the work and the stage is shown to do what its name says:
//   0 `dma`        per chunk: the patch as loaded (no transform) and U's chunk
//                  into shared memory; out[block] = the sum, mod 2^32, of the
//                  16-bit patterns of every bf16 value the block brought in
//                  (an integer sum: any order gives it)
//   1 `transform`  + the bf16 input transform: the same sum over V and U
//   2 `matmul`     + the 16 products; out (tiles, F) fp32 = M[0], the
//                  accumulators of position 0
// Stages 0 and 1 sum each value from the register it is stored from (about
// 200 integer operations a thread and chunk beside its 24 loads and 24
// stores), so they make no shared-memory access the full kernel does not.
// Nothing would then read what they store, and the stores could go: one load
// at an address the compiler cannot know, under a test that never holds
// (`relu` is 0 or 1), keeps them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTiles = 32;      // 2x2 output tiles per block
constexpr int kFeat = 64;       // output channels per block
constexpr int kChunk = 32;      // input channels per step of the C loop
constexpr int kThreads = 512;   // 16 warps, warp p owns Winograd position p
constexpr int kVld = kChunk + 8;  // row strides, padded against bank conflicts
constexpr int kUld = kFeat + 8;
constexpr int kMld = kFeat + 4;
constexpr int kVBytes = 16 * kTiles * kVld * 2;
constexpr int kUBytes = 16 * kChunk * kUld * 2;
constexpr int kMBytes = 16 * kTiles * kMld * 4;
constexpr int kSmemBytes = kVBytes + kUBytes > kMBytes ? kVBytes + kUBytes : kMBytes;
constexpr int kStageDma = 0, kStageTransform = 1, kStageMatmul = 2, kStageFull = 3;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// U (16, C, F) bf16 from w (F, C, 3, 3) fp32; one thread per (c, f).
__global__ void weight_transform_kernel(const float* __restrict__ w,
                                        __nv_bfloat16* __restrict__ u, int C, int F) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * F) return;
  const int c = idx / F, f = idx - c * F;
  const float* k = w + ((size_t)f * C + c) * 9;
  float t[4][3];  // rows: t[a][j] = sum_i G[a][i] k[i][j]
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float k0 = k[j], k1 = k[3 + j], k2 = k[6 + j];
    t[0][j] = k0;
    t[1][j] = __fmul_rn(0.5f, __fadd_rn(__fadd_rn(k0, k1), k2));
    t[2][j] = __fmul_rn(0.5f, __fadd_rn(__fsub_rn(k0, k1), k2));
    t[3][j] = k2;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {  // columns: U[a][b] = sum_j t[a][j] G[b][j]
    const float ub[4] = {t[a][0],
                         __fmul_rn(0.5f, __fadd_rn(__fadd_rn(t[a][0], t[a][1]), t[a][2])),
                         __fmul_rn(0.5f, __fadd_rn(__fsub_rn(t[a][0], t[a][1]), t[a][2])),
                         t[a][2]};
#pragma unroll
    for (int b = 0; b < 4; ++b)
      u[((size_t)(4 * a + b) * C + c) * F + f] = __float2bfloat16_rn(ub[b]);
  }
}

// sum of the two 16-bit halves of a word, and of each word of a 16-byte vector
__device__ __forceinline__ unsigned bits_sum(const unsigned w) {
  return (w & 0xffffu) + (w >> 16);
}
__device__ __forceinline__ unsigned bits_sum(const __nv_bfloat162 v) {
  return bits_sum(*reinterpret_cast<const unsigned*>(&v));
}
__device__ __forceinline__ unsigned bits_sum(const uint4 v) {
  return bits_sum(v.x) + bits_sum(v.y) + bits_sum(v.z) + bits_sum(v.w);
}

template <typename OutT, int STAGE>
__global__ void __launch_bounds__(kThreads, 1)
winograd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ u,
                const float* __restrict__ bias, OutT* __restrict__ out, int B, int H, int W,
                int C, int F, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem);            // (16, kTiles, kVld)
  __nv_bfloat16* us = reinterpret_cast<__nv_bfloat16*>(smem + kVBytes);  // (16, kChunk, kUld)
  float* ms = reinterpret_cast<float*>(smem);  // (16, kTiles, kMld), after the C loop

  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const int per_image = th * tw;
  const int n_tiles = B * per_image;
  const int nf = F / kFeat;
  const int f0 = (blockIdx.x % nf) * kFeat;
  const int tile0 = (blockIdx.x / nf) * kTiles;
  const int tid = threadIdx.x, warp = tid >> 5;

  // the input transform's work item: tile tl of the block, channel pair cp of the chunk
  const int tl = tid >> 4, cp = tid & 15;
  unsigned valid = 0;   // bit 4a + b: pixel (2i + a - 1, 2j + b - 1) lies inside the image
  long long base = 0;   // element offset of that patch's (a, b) = (0, 0), channel 2 cp
  {
    const int t = tile0 + tl;
    if (t < n_tiles) {
      const int n = t / per_image, r = t - n * per_image, i = r / tw, j = r - i * tw;
      const int row0 = 2 * i - 1, col0 = 2 * j - 1;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (row0 + a >= 0 && row0 + a < H && col0 + b >= 0 && col0 + b < W)
            valid |= 1u << (4 * a + b);
      base = (((long long)n * H + row0) * W + col0) * C + 2 * cp;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  unsigned checksum = 0;  // stages dma and transform only
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    // V: the 4x4 patch of one tile and channel pair, transformed in bf16
    __nv_bfloat162 d[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        d[a][b] = (valid >> (4 * a + b)) & 1u
                      ? *reinterpret_cast<const __nv_bfloat162*>(
                            x + (base + ((long long)a * W + b) * C + c0))
                      : zero2;
    if constexpr (STAGE == kStageDma) {  // the patch as it came, in V's layout
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          *reinterpret_cast<__nv_bfloat162*>(vs + ((4 * a + b) * kTiles + tl) * kVld + 2 * cp) =
              d[a][b];
          checksum += bits_sum(d[a][b]);
        }
    } else {
      __nv_bfloat162 r[4][4];  // rows: r[a'][b] = sum_a BT[a'][a] d[a][b]
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        r[0][b] = __hsub2(d[0][b], d[2][b]);
        r[1][b] = __hadd2(d[1][b], d[2][b]);
        r[2][b] = __hsub2(d[2][b], d[1][b]);
        r[3][b] = __hsub2(d[1][b], d[3][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {  // columns: V[a'][b'] = sum_b BT[b'][b] r[a'][b]
        __nv_bfloat162 v[4];
        v[0] = __hsub2(r[a][0], r[a][2]);
        v[1] = __hadd2(r[a][1], r[a][2]);
        v[2] = __hsub2(r[a][2], r[a][1]);
        v[3] = __hsub2(r[a][1], r[a][3]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          *reinterpret_cast<__nv_bfloat162*>(vs + ((4 * a + b) * kTiles + tl) * kVld + 2 * cp) =
              v[b];
          if constexpr (STAGE == kStageTransform) checksum += bits_sum(v[b]);
        }
      }
    }
    // U: rows (p, c0 + c) of 64 bf16 = 8 x 16 bytes
#pragma unroll
    for (int it = 0; it < 16 * kChunk * 8 / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int row = idx >> 3, vec = idx & 7;
      const int p = row / kChunk, c = row - p * kChunk;
      const uint4 val = *reinterpret_cast<const uint4*>(
          u + ((size_t)p * C + c0 + c) * F + f0 + vec * 8);
      *reinterpret_cast<uint4*>(us + (p * kChunk + c) * kUld + vec * 8) = val;
      if constexpr (STAGE <= kStageTransform) checksum += bits_sum(val);
    }
    __syncthreads();

    if constexpr (STAGE <= kStageTransform) {
      // never taken; it keeps the stores above (the note on stages says why)
      if (relu < 0)
        checksum += reinterpret_cast<const unsigned*>(smem)[(tid - relu) % (kSmemBytes / 4)];
    } else {
#pragma unroll
      for (int k0 = 0; k0 < kChunk; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wmma::load_matrix_sync(af[m], vs + (warp * kTiles + m * 16) * kVld + k0, kVld);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, us + (warp * kChunk + k0) * kUld + n * 16, kUld);
#pragma unroll
          for (int m = 0; m < 2; ++m) wmma::mma_sync(acc[m][n], af[m], bf, acc[m][n]);
        }
      }
    }
    __syncthreads();  // V and U are free for the next chunk (or for M below)
  }

  if constexpr (STAGE <= kStageTransform) {
    // one sum per block, in any order: integer adds mod 2^32
    unsigned* red = reinterpret_cast<unsigned*>(smem);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) checksum += __shfl_xor_sync(0xffffffffu, checksum, o);
    if ((tid & 31) == 0) red[warp] = checksum;
    __syncthreads();
    if (tid == 0) {
      unsigned total = 0;
      for (int i = 0; i < kThreads / 32; ++i) total += red[i];
      out[blockIdx.x] = total;
    }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(ms + (warp * kTiles + m * 16) * kMld + n * 16, acc[m][n], kMld,
                                wmma::mem_row_major);
    __syncthreads();
    if constexpr (STAGE == kStageMatmul) {  // M[0] as it is, rows past the last tile masked
#pragma unroll
      for (int it = 0; it < kTiles * kFeat / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int tile = idx / kFeat, f = idx - tile * kFeat;
        if (tile0 + tile < n_tiles)
          out[(size_t)(tile0 + tile) * F + f0 + f] = ms[tile * kMld + f];
      }
    } else {
      // output transform, bias, ReLU, cast: four (tile, channel) items a thread
#pragma unroll
      for (int it = 0; it < kTiles * kFeat / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int tile = idx / kFeat, f = idx - tile * kFeat;
        const int t = tile0 + tile;
        if (t >= n_tiles) continue;
        float mm[4][4];
#pragma unroll
        for (int p = 0; p < 16; ++p) mm[p >> 2][p & 3] = ms[(p * kTiles + tile) * kMld + f];
        float t0[4], t1[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          t0[b] = __fadd_rn(__fadd_rn(mm[0][b], mm[1][b]), mm[2][b]);
          t1[b] = __fsub_rn(__fsub_rn(mm[1][b], mm[2][b]), mm[3][b]);
        }
        const float bv = bias[f0 + f];
        float y[2][2];
        y[0][0] = __fadd_rn(__fadd_rn(__fadd_rn(t0[0], t0[1]), t0[2]), bv);
        y[0][1] = __fadd_rn(__fsub_rn(__fsub_rn(t0[1], t0[2]), t0[3]), bv);
        y[1][0] = __fadd_rn(__fadd_rn(__fadd_rn(t1[0], t1[1]), t1[2]), bv);
        y[1][1] = __fadd_rn(__fsub_rn(__fsub_rn(t1[1], t1[2]), t1[3]), bv);
        const int n = t / per_image, r = t - n * per_image, i = r / tw, j = r - i * tw;
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int row = 2 * i + a, col = 2 * j + b;
            if (row < H && col < W) {
              const float v = relu ? fmaxf(y[a][b], 0.f) : y[a][b];
              store_out(out + (((size_t)n * H + row) * W + col) * F + f0 + f, v);
            }
          }
      }
    }
  }
}

template <typename OutT, int STAGE = kStageFull>
int launch(const void* x, const void* u, const void* bias, void* out, int B, int H, int W, int C,
           int F, int relu, cudaStream_t s) {
  auto kernel = winograd_kernel<OutT, STAGE>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmemBytes);
  if (err) return err;
  const long long n_tiles = (long long)B * ((H + 1) / 2) * ((W + 1) / 2);
  const long long blocks = (n_tiles + kTiles - 1) / kTiles * (F / kFeat);
  kernel<<<(unsigned)blocks, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(u),
      static_cast<const float*>(bias), static_cast<OutT*>(out), B, H, W, C, F, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int scl_winograd_chunk_channels(void) { return kChunk; }
int scl_winograd_block_features(void) { return kFeat; }
int scl_winograd_block_tiles(void) { return kTiles; }

// w (F, C, 3, 3) fp32 -> u (16, C, F) bf16, both contiguous on one device, C * F
// below 2^31. Returns cudaGetLastError() of the launch, else 0.
int scl_winograd_weight_transform(const void* w, void* u, int C, int F, void* stream) {
  weight_transform_kernel<<<(C * F + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(u), C, F);
  return (int)cudaGetLastError();
}

// x (B, H, W, C) bf16, u (16, C, F) bf16, bias (F) fp32, out (B, H, W, F) bf16
// (out_bf16 != 0) or fp32, all contiguous on one device; C a multiple of
// scl_winograd_chunk_channels(), F of scl_winograd_block_features(), the block
// count below 2^31. Returns cudaGetLastError() of the launch, else 0.
int scl_winograd_conv(const void* x, const void* u, const void* bias, void* out, int B, int H,
                      int W, int C, int F, int relu, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(x, u, bias, out, B, H, W, C, F, relu, s)
                  : launch<float>(x, u, bias, out, B, H, W, C, F, relu, s);
}

// The kernel cut short at `stage` (0 dma, 1 transform, 2 matmul; the source
// note says what each writes): x and u as for scl_winograd_conv; out is one
// uint32 per block, (ceil(tiles / block_tiles) * F / block_features), for
// stages 0 and 1, and (tiles, F) fp32 for stage 2. Returns cudaGetLastError()
// of the launch, else 0; cudaErrorInvalidValue for another stage.
int scl_winograd_stage(int stage, const void* x, const void* u, void* out, int B, int H, int W,
                       int C, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kStageDma:
      return launch<unsigned, kStageDma>(x, u, nullptr, out, B, H, W, C, F, 0, s);
    case kStageTransform:
      return launch<unsigned, kStageTransform>(x, u, nullptr, out, B, H, W, C, F, 0, s);
    case kStageMatmul:
      return launch<float, kStageMatmul>(x, u, nullptr, out, B, H, W, C, F, 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
