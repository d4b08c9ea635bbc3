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
// it cost more than the convolution's own launch on the host.
//
// Bound on this card, from what the function needs: 2 * 16 * B * ceil(H/2) *
// ceil(W/2) * C * F operations at the bf16 tensor-core rate against
// 2 (B H W C + B H W F) + 2 * 16 C F bytes (x and U read once, out written
// once). At B = 64 the flagship's conv2_2 (90x120, 128 -> 128) is byte-bound
// (0.106 ms against 0.092 ms of operations) and every later layer is
// operation-bound (conv4_2, 22x30, 512 -> 512: 0.090 ms).
//
// Design. The TPU kernel copies a strip of input rows with its halo once per
// grid cell and keeps U resident in VMEM; an SM has 227 KB. Here a block owns
// 32 tiles (a rectangle of r x s = 2 x 16 or 4 x 8 tiles of one image, chosen
// per layer width by the wrapper) x 64 output channels and loops over C in
// chunks of 32 with the chunks in a ring of two stages:
//  - one producer warp issues, per chunk, one TMA box of the rectangle's input
//    region, (2r + 2) x (2s + 2) pixels x 32 channels of a 4-D map over x
//    (13 KB for 2 x 16), started at pixel (-1, -1) relative to the rectangle:
//    TMA fills the halo and the ragged last tile row and column with zeros, so
//    there is no padded copy of x and each input value comes in once per
//    block, not four times; and 1/n of U's chunk, (16 / n) positions x 32
//    channels x 64 features, multicast to the n blocks of its thread-block
//    cluster (n = 2 blocks with the same 64 features and neighbouring tiles),
//    which each issue another part: a block receives U's 64 KB chunk but
//    brings only 32 KB of it out of L2. (Clusters of 4 and 8 measured
//    slower on the H100: the blocks of a cluster wait for each other at
//    every chunk, since a stage is free only when all have released it.)
//    U lands with the 128-byte swizzle that wgmma reads, the box with the
//    64-byte swizzle (its pixel rows are 64 bytes; the 128-byte swizzle does
//    not lay them out densely); both complete a "full" mbarrier; consumers
//    release the stage through an "empty" mbarrier in every block of the
//    cluster, since a block's loads write into all of them.
//  - four consumer warpgroups (512 threads) read the patches from shared
//    memory (a thread: one tile, one channel pair, 16 4-byte loads, at most
//    two-way bank conflicts under the swizzle), transform them in bf16
//    exactly as above and write V in the core-matrix layout that wgmma
//    reads K-major.
//  - warpgroup g multiplies positions 4g .. 4g + 3 with wgmma m64n32k16: A =
//    U[p]^T (64 features x 32 channels, MN-major from the swizzled U, the
//    transpose bit), B = V[p]^T (32 channels x 32 tiles, K-major), fp32
//    accumulators in registers across C (64 a thread). The products of chunk
//    k run on the tensor cores while the threads load and transform chunk
//    k + 1; before storing its V (into the other buffer) each warpgroup
//    waits for them and releases chunk k's stage, so the load of chunk k + 2
//    starts as early as two stages allow.
// After the last chunk the accumulators go to shared memory (over the dead
// stages), and each consumer thread finishes four (tile, channel) outputs:
// output transform, bias, ReLU, cast, masked stores of 128 contiguous bytes
// per warp. The grid is (n, F / 64, tile blocks / n), so that the blocks that
// share a patch run together and x comes from device memory about once.
//
// Stages. The kernel takes a compile-time STAGE, the counterpart of
// perf/winograd_ablate.py::make_kernel(stage): the same code cut short, so that
// the differences between the stages' times say where the full kernel's time
// goes. STAGE 3 (`full`) is the kernel above and the only one winograd_conv
// runs. Each shorter stage writes something a plain version reproduces
// (ops/winograd.py::winograd_stage_plain), so that the compiler cannot drop
// the work and the stage is shown to do what its name says:
//   0 `dma`        per chunk: the input box and U's chunk into shared memory by
//                  TMA, as the full kernel loads them; out[block] = the sum,
//                  mod 2^32, of the 16-bit patterns of a fixed sample of what
//                  arrived: consumer thread t reads one 4-byte word of the box
//                  (pixel (t / 16) * P / 32 of the box's P, channel pair t % 16)
//                  and one of U (position t % 16, channel t / 16, feature pair
//                  (t / 4) % 32). No register holds what TMA copies, so this
//                  sample (2 KB of shared-memory reads of ~78 KB landed) is the
//                  witness that every box arrived.
//   1 `transform`  + the bf16 input transform and V's stores: the sum of the
//                  16-bit patterns of every V value the block computes (from
//                  the registers it is stored from) and of the same U sample
//   2 `matmul`     + the 16 products; out (tiles, F) fp32 = M[0], the
//                  accumulators of position 0
// Shared memory is written with st.shared in inline assembly, which the
// compiler keeps whether or not anything reads it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kTiles = 32;                    // 2x2 output tiles per block
constexpr int kFeat = 64;                     // output channels per block
constexpr int kChunk = 32;                    // input channels per step of the C loop
constexpr int kConsumers = 4;                 // warpgroups; g owns positions 4g .. 4g + 3
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kStages = 2;
constexpr int kCluster = 2;                   // blocks that share U's loads
constexpr int kUBytes = 16 * kChunk * kFeat * 2;  // U's chunk: 64 KB
constexpr int kXBytesMax = 13 * 1024;         // the largest box, 6 x 34 x 32 bf16, in whole KB
constexpr int kStageBytes = kUBytes + kXBytesMax;
constexpr int kVBytes = 16 * kTiles * kChunk * 2;  // one V buffer: 32 KB
constexpr int kMld = kFeat + 4;               // row stride of M in shared memory
constexpr int kMBytes = 16 * kTiles * kMld * 4;
constexpr int kVOffset = kStages * kStageBytes;
constexpr int kBarOffset = kVOffset + 2 * kVBytes;  // full[2], empty[2], then 16 words
constexpr int kSmemBytes = kBarOffset + 128 + 1024;  // + 1 KB to align to the swizzle
constexpr int kStageDma = 0, kStageTransform = 1, kStageMatmul = 2, kStageFull = 3;
static_assert(kMBytes <= kVOffset, "M goes over the dead stages");
static_assert(kSmemBytes <= 232448, "one block per SM");

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


// sum of the two 16-bit halves of a word
__device__ __forceinline__ unsigned bits_sum(const uint32_t w) { return (w & 0xffffu) + (w >> 16); }

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t w) {
  return *reinterpret_cast<__nv_bfloat162*>(&w);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename OutT, int STAGE>
__global__ void __launch_bounds__(kThreads, 1)
winograd_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_u,
                const float* __restrict__ bias, OutT* __restrict__ out, int B, int H, int W, int C,
                int F, int relu, int rows) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = sm90::smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  unsigned char* gbase = smem + (base - raw);    // the same byte, as a generic pointer
  const uint32_t bars = base + kBarOffset;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  unsigned* red = reinterpret_cast<unsigned*>(gbase + kBarOffset + 32);

  // the cluster is gridDim.x blocks with the same features and neighbouring tiles
  const int n_cta = gridDim.x;
  const uint32_t rank = sm90::cluster_ctarank();
  const int cols = kTiles / rows;  // the block's tiles: a rows x cols rectangle of one image
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  const int gi = (th + rows - 1) / rows, gj = (tw + cols - 1) / cols;
  const int tb = blockIdx.z * n_cta + blockIdx.x;  // tile block; past the last: all zero
  const int img = tb / (gi * gj), rem = tb - img * (gi * gj);
  const int i0 = rem / gj * rows, j0 = rem % gj * cols;
  const int f0 = blockIdx.y * kFeat;
  const int box_w = 2 * cols + 2, box_px = (2 * rows + 2) * box_w;
  const uint32_t x_bytes = box_px * kChunk * 2;
  const int nk = C / kChunk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers * n_cta);  // every consumer warpgroup of the cluster
    }
    sm90::fence_barrier_init();
  } else if (tid == 128 * kConsumers) {
    sm90::prefetch_tensormap(&map_x);
    sm90::prefetch_tensormap(&map_u);
  }
  sm90::cluster_sync();  // all barriers of the cluster are ready before any load or arrival

  if (tid >= 128 * kConsumers) {  // the producer warp; one thread issues every load
    if (tid == 128 * kConsumers) {
      const int slice = 16 / n_cta;  // positions of U this block loads for the cluster
      const uint16_t mask = (uint16_t)((1u << n_cta) - 1u);
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc & 1;
        sm90::mbar_wait(empty(s), ((kc >> 1) & 1) ^ 1);  // released in every block
        sm90::mbar_arrive_expect_tx(full(s), kUBytes + x_bytes);
        const uint32_t stage = base + s * kStageBytes;
        sm90::tma_load_4d(stage + kUBytes, &map_x, full(s), kc * kChunk, 2 * j0 - 1, 2 * i0 - 1,
                          img);
        sm90::tma_load_3d_multicast(stage + rank * slice * 4096, &map_u, full(s), mask, f0,
                                    kc * kChunk, rank * slice);
      }
    }
    __syncwarp();
  } else {
    const int warp = tid >> 5, lane = tid & 31, g = warp >> 2;
    // the input transform's work item: tile tl of the rectangle, channel pair cp
    const int tl = 8 * (warp & 3) + (lane & 7), cp = 4 * (warp >> 2) + (lane >> 3);
    const int q0 = 2 * (tl / cols) * box_w + 2 * (tl % cols);  // box pixel of d[0][0]
    // V[p]: 8 x 16-byte core matrices, (tile / 8, channel / 8) at 512 and 128 bytes
    const uint32_t v_off = (tl >> 3) * 512 + (cp >> 2) * 128 + (tl & 7) * 16 + (cp & 3) * 4;
    // the dma and transform stages' sample of what TMA brought in
    const uint32_t x_sample = sm90::swizzle64(((tid >> 4) * box_px >> 5) * 64 + 4 * (tid & 15));
    const uint32_t u_sample =
        sm90::swizzle128((tid & 15) * 4096 + (tid >> 4) * 128 + 4 * ((tid >> 2) & 31));

    float acc[4][16];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[j][i] = 0.f;
    unsigned checksum = 0;  // stages dma and transform only

    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc & 1;
      sm90::mbar_wait(full(s), (kc >> 1) & 1);
      const uint32_t stage = base + s * kStageBytes, xs = stage + kUBytes;
      const uint32_t vs = base + kVOffset + s * kVBytes;
      if constexpr (STAGE == kStageDma) {
        checksum += bits_sum(lds32(xs + x_sample)) + bits_sum(lds32(stage + u_sample));
      } else {
        __nv_bfloat162 d[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            d[a][b] = as_bf2(lds32(xs + sm90::swizzle64((q0 + a * box_w + b) * 64 + 4 * cp)));
        __nv_bfloat162 r[4][4];  // rows: r[a'][b] = sum_a BT[a'][a] d[a][b]
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          r[0][b] = __hsub2(d[0][b], d[2][b]);
          r[1][b] = __hadd2(d[1][b], d[2][b]);
          r[2][b] = __hsub2(d[2][b], d[1][b]);
          r[3][b] = __hsub2(d[1][b], d[3][b]);
        }
        uint32_t v[16];  // columns: V[a'][b'] = sum_b BT[b'][b] r[a'][b], position 4a' + b'
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          v[4 * a + 0] = as_u32(__hsub2(r[a][0], r[a][2]));
          v[4 * a + 1] = as_u32(__hadd2(r[a][1], r[a][2]));
          v[4 * a + 2] = as_u32(__hsub2(r[a][2], r[a][1]));
          v[4 * a + 3] = as_u32(__hsub2(r[a][1], r[a][3]));
        }
        if constexpr (STAGE >= kStageMatmul) {
          if (kc > 0) {
            // the products of chunk kc - 1 ran beside this chunk's loads and
            // transform: once done, their stage goes back to the producer
            sm90::wgmma_wait<0>();
#pragma unroll
            for (int j = 0; j < 4; ++j) sm90::fence_operands(acc[j]);
            if ((tid & 127) == 0)
              for (int c = 0; c < n_cta; ++c) sm90::mbar_arrive_cluster(empty(s ^ 1), c);
          }
        }
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          sts32(vs + p * 2048 + v_off, v[p]);
          if constexpr (STAGE == kStageTransform) checksum += bits_sum(v[p]);
        }
        if constexpr (STAGE == kStageTransform) checksum += bits_sum(lds32(stage + u_sample));
      }
      if constexpr (STAGE <= kStageTransform) {
        sm90::named_barrier_sync(1, 128 * kConsumers);  // every consumer is done with stage s
        if ((tid & 127) == 0)
          for (int c = 0; c < n_cta; ++c) sm90::mbar_arrive_cluster(empty(s), c);
      } else {
        sm90::fence_proxy_async();  // V's stores, visible to wgmma
        // V of chunk kc is whole (and every warpgroup's products of kc - 1,
        // which read the other V buffer, are done)
        sm90::named_barrier_sync(1, 128 * kConsumers);
#pragma unroll
        for (int j = 0; j < 4; ++j) sm90::fence_operands(acc[j]);
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * g + j;
#pragma unroll
          for (int ks = 0; ks < kChunk / 16; ++ks)
            sm90::wgmma_m64n32k16<1, 0>(
                acc[j],
                sm90::make_desc(stage + p * 4096 + ks * 2048, 8192, 1024, sm90::kLayout128B),
                sm90::make_desc(vs + p * 2048 + ks * 256, 128, 512, sm90::kLayoutNone));
        }
        sm90::wgmma_commit();
      }
    }

    if constexpr (STAGE <= kStageTransform) {
      // one sum per block, in any order: integer adds mod 2^32
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) checksum += __shfl_xor_sync(0xffffffffu, checksum, o);
      if (lane == 0) red[warp] = checksum;
      sm90::named_barrier_sync(1, 128 * kConsumers);
      if (tid == 0) {
        unsigned total = 0;
        for (int w = 0; w < 4 * kConsumers; ++w) total += red[w];
        out[(size_t)tb * gridDim.y + blockIdx.y] = total;
      }
    } else {
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 4; ++j) sm90::fence_operands(acc[j]);
      // accumulator i of this thread: feature fr + 8 ((i / 2) % 2), tile 8 (i / 4) + tc + i % 2
      const int fr = 16 * (warp & 3) + (lane >> 2), tc = 2 * (lane & 3);
      if constexpr (STAGE == kStageMatmul) {  // M[0] as it is, tiles outside the image masked
        if (g == 0) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int tile = 8 * (i >> 2) + tc + (i & 1), f = fr + 8 * ((i >> 1) & 1);
            const int ti = i0 + tile / cols, tj = j0 + tile % cols;
            if (img < B && ti < th && tj < tw)
              out[(((size_t)img * th + ti) * tw + tj) * F + f0 + f] = acc[0][i];
          }
        }
      } else {
        sm90::named_barrier_sync(1, 128 * kConsumers);  // every product is done: stages are dead
        float* ms = reinterpret_cast<float*>(gbase);    // (16, kTiles, kMld)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 16; ++i)
            ms[((4 * g + j) * kTiles + 8 * (i >> 2) + tc + (i & 1)) * kMld + fr +
               8 * ((i >> 1) & 1)] = acc[j][i];
        sm90::named_barrier_sync(1, 128 * kConsumers);
        // output transform, bias, ReLU, cast: four (tile, channel) items a thread
#pragma unroll
        for (int it = 0; it < kTiles * kFeat / (128 * kConsumers); ++it) {
          const int idx = tid + it * 128 * kConsumers;
          const int tile = idx / kFeat, f = idx - tile * kFeat;
          const int ti = i0 + tile / cols, tj = j0 + tile % cols;
          if (img >= B || ti >= th || tj >= tw) continue;
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
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int row = 2 * ti + a, col = 2 * tj + b;
              if (row < H && col < W) {
                const float v = relu ? fmaxf(y[a][b], 0.f) : y[a][b];
                store_out(out + (((size_t)img * H + row) * W + col) * F + f0 + f, v);
              }
            }
        }
      }
    }
  }
  sm90::cluster_sync();  // no block leaves while another may still arrive on its barriers
}

template <typename OutT, int STAGE = kStageFull>
int launch(const void* x, const void* u, const void* bias, void* out, int B, int H, int W, int C,
           int F, int relu, int rows, cudaStream_t s) {
  if (rows != 2 && rows != 4) return (int)cudaErrorInvalidValue;
  const int cols = kTiles / rows, th = (H + 1) / 2, tw = (W + 1) / 2;
  const long long tile_blocks =
      (long long)B * ((th + rows - 1) / rows) * ((tw + cols - 1) / cols);
  CUtensorMap map_x, map_u;
  const uint64_t dims_x[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides_x[3] = {2ull * C, 2ull * W * C, 2ull * H * W * C};
  const uint32_t box_x[4] = {kChunk, (uint32_t)(2 * cols + 2), (uint32_t)(2 * rows + 2), 1};
  int err = sm90::encode_bf16(&map_x, 4, x, dims_x, strides_x, box_x, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  const uint64_t dims_u[3] = {(uint64_t)F, (uint64_t)C, 16};
  const uint64_t strides_u[2] = {2ull * F, 2ull * C * F};
  const uint32_t box_u[3] = {kFeat, kChunk, (uint32_t)(16 / kCluster)};
  err = sm90::encode_bf16(&map_u, 3, u, dims_u, strides_u, box_u, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto kernel = winograd_kernel<OutT, STAGE>;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, F / kFeat, (unsigned)((tile_blocks + kCluster - 1) / kCluster));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmemBytes;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&config, kernel, map_x, map_u, static_cast<const float*>(bias),
                                static_cast<OutT*>(out), B, H, W, C, F, relu, rows);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) { return sm90::error_string(err); }

int scl_winograd_chunk_channels(void) { return kChunk; }
int scl_winograd_block_features(void) { return kFeat; }
int scl_winograd_block_tiles(void) { return kTiles; }
int scl_winograd_smem_bytes(void) { return kSmemBytes; }
int scl_winograd_cluster_blocks(void) { return kCluster; }

// w (F, C, 3, 3) fp32 -> u (16, C, F) bf16, both contiguous on one device, C * F
// below 2^31. Returns cudaGetLastError() of the launch, else 0.
int scl_winograd_weight_transform(const void* w, void* u, int C, int F, void* stream) {
  weight_transform_kernel<<<(C * F + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(u), C, F);
  return (int)cudaGetLastError();
}

// x (B, H, W, C) bf16, u (16, C, F) bf16, bias (F) fp32, out (B, H, W, F) bf16
// (out_bf16 != 0) or fp32, all contiguous on one device, x and u 16-byte
// aligned; C a multiple of scl_winograd_chunk_channels(), F of
// scl_winograd_block_features(). A block owns rows x (32 / rows) tiles (rows 2
// or 4); scl_winograd_cluster_blocks() blocks share U's loads; the tile
// blocks, rounded up to whole clusters, over that, below 65,536. Returns the
// first error: a refused tensor map (sm90::kErrTensorMap + CUresult), a
// refused launch (too much shared memory, a cluster that cannot be placed) or
// cudaGetLastError(), else 0.
int scl_winograd_conv(const void* x, const void* u, const void* bias, void* out, int B, int H,
                      int W, int C, int F, int relu, int out_bf16, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(x, u, bias, out, B, H, W, C, F, relu, rows, s)
                  : launch<float>(x, u, bias, out, B, H, W, C, F, relu, rows, s);
}

// The kernel cut short at `stage` (0 dma, 1 transform, 2 matmul; the source
// note says what each writes): x, u and rows as for scl_winograd_conv;
// out is one uint32 per block, (tile blocks rounded up to whole clusters,
// F / block_features), for stages 0 and 1, and (tiles, F) fp32 for stage 2.
// Returns as scl_winograd_conv; cudaErrorInvalidValue for another stage.
int scl_winograd_stage(int stage, const void* x, const void* u, void* out, int B, int H, int W,
                       int C, int F, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kStageDma:
      return launch<unsigned, kStageDma>(x, u, nullptr, out, B, H, W, C, F, 0, rows, s);
    case kStageTransform:
      return launch<unsigned, kStageTransform>(x, u, nullptr, out, B, H, W, C, F, 0, rows, s);
    case kStageMatmul:
      return launch<float, kStageMatmul>(x, u, nullptr, out, B, H, W, C, F, 0, rows, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
