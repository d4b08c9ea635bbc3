// Fused soft weighted multi-similarity (wms) loss forward (K3) for Hopper, sm_90a.
//
// Replaces soft_contrastive_learning_tpu/ops/pallas/wms_kernel.py
// (_wms_kernel, called from wms_loss_pallas). From emb (B, D) fp32, geo (B, B)
// fp32 and the scalars d_alpha, d_beta, alpha, beta, lamb, eps, mining it
// computes the scalar loss of losses/ms.py::wms_loss with wfunction='exp' and
// sumfunction='ms':
//   r_i   = 1 / sqrt(max(sum_d x_id^2, 1e-12))
//   sim   = max(r_i r_j sum_d x_id x_jd, 0)                      full fp32, no TF32
//   mp    = sigmoid(-d_alpha (geo - d_beta)) - [i == j],  mn = sigmoid(-d_alpha (d_beta - geo))
//   mining (per row): keep mp where sim*mp < max_j(sim*mn) + eps, keep mn where
//                     sim*mn > min_j((sim - tmax) mp) + tmax - eps, tmax = max_j(sim*mp)
//   term_i = log1p(sum_{mp>0} exp(-alpha (sim mp - lamb))) / alpha
//          + log1p(sum_{mn>0} exp( beta  (sim mn - lamb))) / beta
//   loss  = mean_i term_i
//
// Bound on this card, from what the loss needs: the Gram is symmetric, so
// B (B + 1) D FLOP, against 4 (B D + B^2) + 4 bytes (emb and geo read once,
// one float written). At the flagship B = 50, D = 32,768 that is 84 MFLOP
// (1.25 us at the fp32 non-tensor-core rate) and 6.56 MB (1.96 us at
// 3.35 TB/s): byte-bound at ~2.0 us. (The TPU kernel's CostEstimate counts
// 2 B^2 D FLOP and 4 (B D + 2 B^2) bytes.)
//
// Design: one cooperative launch, four phases (two grid-wide barriers, then
// a last-block ticket), so a call costs one launch and one workspace. The TPU kernel held the whole
// (B, D) in one VMEM block and failed to compile at B >= 1024; here every B
// runs, each phase walking its work items with a grid stride:
//  (a) Gram partials over the upper triangle only: an item is (64-row tile
//      pair ti <= tj, 128-column chunk of D). The block issues every load of
//      the item at once (16 B per load, 16 loads in flight per thread: one
//      memory round trip an item), stores the rows transposed in shared
//      memory (a diagonal pair loads its tile once), and multiplies with a
//      4x4 register tile per thread (two 16-byte shared loads per 16 FMA);
//      a diagonal tile computes only its 136 upper 4x4 blocks (4.25 of 8
//      warps busy). At B = 50 the one tile pair's 256 chunks are what fill the SMs;
//      each row of emb is read once. Partials are written chunk-major, 16 KB
//      coalesced per item.
//  (b) Reduce: a block per 32 entries of a tile pair; warp w adds the chunks
//      c = w, w + 8, ... in order (its lanes read 128 coalesced bytes a
//      chunk), and the 8 warps' sums are added in warp order; the sum is
//      written to (i, j) and (j, i).
//  (c) Rows: every mining threshold is a row reduction, so a warp per row i
//      normalizes and clamps its similarities (the norms are the Gram's
//      diagonal), builds the masks, takes the row max/min by shuffles and
//      writes its term.
//  (d) Mean: the last block to finish its rows (an arrival ticket, no
//      barrier) sums the B terms in a fixed order.
// No float atomics anywhere and every sum in a fixed order, so the loss is
// the same bits from run to run. The grid barrier is an arrival counter and
// a generation word, beside the ticket, in a three-word buffer the wrapper
// keeps per device and stream (zero at first use; the last block to arrive
// resets its counter);
// a wait longer than 4 s traps, so a fault fails the launch instead of
// holding the card. The cooperative launch guarantees that every block of
// the grid is resident. All sums are fp32 with expf/log1pf (not the fast
// intrinsics).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows per Gram tile: 16 x 16 threads, 4 x 4 each
constexpr int kItemCols = 128;  // columns of D per Gram item
constexpr int kThreads = 256;
constexpr int kPad = kTile + 4;  // a staged column's 64 rows, 16-byte aligned
constexpr int kSmemBytes = 2 * kItemCols * kPad * 4;
constexpr float kNormEps = 1e-12f;

struct Params {
  float d_alpha, d_beta, alpha, beta, lamb, eps;
  int mining;
};

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// every block of the grid; bar[0] counts arrivals, bar[1] is the generation
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const uint64_t start = global_ns();
      while (*gen == seen)
        if (global_ns() - start > 4000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// upper-triangle pair p (row-major over ti <= tj) of `tiles` tiles
__device__ __forceinline__ void tile_pair(int p, int tiles, int& ti, int& tj) {
  ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  tj = ti + p;
}

// (a): load rows r0.. (64) x columns [d0, d0 + 128) of x into registers: 8
// float4 per thread, lane (row lane % 8, float4 column lane / 8) of each warp
// taking 8 rows x 64 contiguous bytes per load; zeros past B and past d_end.
__device__ __forceinline__ void load_tile(const float* __restrict__ x, int B, int D, int r0,
                                          int d0, int d_end, float4 (&v)[8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = r0 + (lane & 7) + 8 * warp;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int d = d0 + 4 * ((lane >> 3) + 4 * it);
    v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= B || d >= d_end) continue;
    const float* p = x + (size_t)r * D + d;
    if (d + 3 < d_end && (D & 3) == 0) {
      v[it] = *reinterpret_cast<const float4*>(p);
    } else {
      v[it].x = p[0];
      if (d + 1 < d_end) v[it].y = p[1];
      if (d + 2 < d_end) v[it].z = p[2];
      if (d + 3 < d_end) v[it].w = p[3];
    }
  }
}

// ... and store them transposed, t[column][row] (row stride kPad)
__device__ __forceinline__ void store_tile(const float4 (&v)[8], float* t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = (lane & 7) + 8 * warp;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int c = 4 * ((lane >> 3) + 4 * it);
    t[(c + 0) * kPad + r] = v[it].x;
    t[(c + 1) * kPad + r] = v[it].y;
    t[(c + 2) * kPad + r] = v[it].z;
    t[(c + 3) * kPad + r] = v[it].w;
  }
}

// (a): the partial Gram tile of rows i0.. x rows j0.. over columns
// [d0, d_end), 64 x 64 row-major into out. Thread t owns the 4 x 4 block
// (ty, tx); in a diagonal tile only the 136 blocks with ty <= tx, numbered
// row by row (threads 136.. idle: the entries below the diagonal are never
// read, so they are neither computed nor written).
__device__ void gram_partial(const float* __restrict__ x, float* __restrict__ out, int B, int D,
                             int i0, int j0, int d0, int d_end, float* smem) {
  const bool diag = i0 == j0;
  float* xi = smem;
  float* xj = diag ? xi : smem + kItemCols * kPad;
  float4 vi[8], vj[8];
  load_tile(x, B, D, i0, d0, d_end, vi);
  if (!diag) load_tile(x, B, D, j0, d0, d_end, vj);
  store_tile(vi, xi);
  if (!diag) store_tile(vj, xj);
  __syncthreads();
  int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (diag) {
    int t = threadIdx.x;
    for (ty = 0; ty < 16 && t >= 16 - ty; ++ty) t -= 16 - ty;
    tx = ty + t;
  }
  if (ty < 16) {  // not one of a diagonal tile's threads past its 136 blocks
    float acc[4][4] = {};
    const int cols = min(kItemCols, d_end - d0);
#pragma unroll 4
    for (int k = 0; k < cols; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(xi + k * kPad + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(xj + k * kPad + 4 * tx);
      const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(ar[u], br[w], acc[u][w]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float4*>(out + (4 * ty + u) * kTile + 4 * tx) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
  __syncthreads();  // the tiles are free for the next item
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float inv_norm(const float* gram, int B, int i) {
  return 1.f / sqrtf(fmaxf(gram[(size_t)i * B + i], kNormEps));
}

// Warp-wide reduction; op 0 = sum, 1 = max, 2 = min. Every lane gets the
// result. Fixed order: an xor-shuffle tree.
template <int Op>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = Op == 0 ? v + o : (Op == 1 ? fmaxf(v, o) : fminf(v, o));
  }
  return v;
}

// (c): row i's term from the Gram, by one warp
__device__ float row_term(const float* __restrict__ gram, const float* __restrict__ geo, int B,
                          int i, const Params& p) {
  const int lane = threadIdx.x & 31;
  const float ri = inv_norm(gram, B, i);
  const float* grow = gram + (size_t)i * B;
  const float* drow = geo + (size_t)i * B;
  // similarity and masks of (i, j), recomputed in every pass from the Gram
  auto load = [&](int j, float& sim, float& mp, float& mn) {
    sim = fmaxf(grow[j] * ri * inv_norm(gram, B, j), 0.f);
    const float d = drow[j];
    mp = sigmoidf(-p.d_alpha * (d - p.d_beta)) - (j == i ? 1.f : 0.f);
    mn = sigmoidf(-p.d_alpha * (p.d_beta - d));
  };

  float max_val = 0.f, min_val = 0.f;
  if (p.mining) {
    float neg_max = -INFINITY, pos_max = -INFINITY;
    for (int j = lane; j < B; j += 32) {
      float sim, mp, mn;
      load(j, sim, mp, mn);
      neg_max = fmaxf(neg_max, sim * mn);
      pos_max = fmaxf(pos_max, sim * mp);
    }
    max_val = warp_reduce<1>(neg_max);
    const float tmp_max = warp_reduce<1>(pos_max);
    float lo = INFINITY;
    for (int j = lane; j < B; j += 32) {
      float sim, mp, mn;
      load(j, sim, mp, mn);
      lo = fminf(lo, (sim - tmp_max) * mp);
    }
    min_val = warp_reduce<2>(lo) + tmp_max;
  }

  float pos_sum = 0.f, neg_sum = 0.f;
  for (int j = lane; j < B; j += 32) {
    float sim, mp, mn;
    load(j, sim, mp, mn);
    if (p.mining) {
      if (!(sim * mp < max_val + p.eps)) mp = 0.f;
      if (!(sim * mn > min_val - p.eps)) mn = 0.f;
    }
    if (mp > 0.f) pos_sum += expf(-p.alpha * (sim * mp - p.lamb));
    if (mn > 0.f) neg_sum += expf(p.beta * (sim * mn - p.lamb));
  }
  pos_sum = warp_reduce<0>(pos_sum);
  neg_sum = warp_reduce<0>(neg_sum);
  return log1pf(pos_sum) / p.alpha + log1pf(neg_sum) / p.beta;
}

// ws: part (pairs, n_chunks, 64 x 64) | gram (B, B) | terms (B) | out (1)
__global__ void __launch_bounds__(kThreads)
wms_kernel(const float* __restrict__ emb, const float* __restrict__ geo, float* __restrict__ ws,
           unsigned* __restrict__ bar, int B, int D, int n_chunks, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tiles = (B + kTile - 1) / kTile;
  const int pairs = tiles * (tiles + 1) / 2;
  constexpr int kEntries = kTile * kTile;
  float* part = ws;
  float* gram = part + (size_t)pairs * n_chunks * kEntries;
  float* terms = gram + (size_t)B * B;
  float* out = terms + B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = kThreads / 32;

  // (a) Gram partials, items (pair, chunk) with the chunk fastest
  for (int item = blockIdx.x; item < pairs * n_chunks; item += gridDim.x) {
    const int pair = item / n_chunks, c = item % n_chunks;
    int ti, tj;
    tile_pair(pair, tiles, ti, tj);
    const int d0 = c * kItemCols;
    gram_partial(emb, part + (size_t)item * kEntries, B, D, ti * kTile, tj * kTile, d0,
                 min(d0 + kItemCols, D), smem);
  }
  grid_sync(bar);

  // (b) a block per 32 entries of a tile pair: warp w adds chunks w, w + 8, ...
  for (int g = blockIdx.x; g < pairs * (kEntries / 32); g += gridDim.x) {
    const int pair = g / (kEntries / 32), local = (g % (kEntries / 32)) * 32 + lane;
    const float* pp = part + (size_t)pair * n_chunks * kEntries + local;
    float s = 0.f;
    for (int c = warp; c < n_chunks; c += warps) s += pp[(size_t)c * kEntries];
    smem[warp * 32 + lane] = s;
    __syncthreads();
    if (warp == 0) {
      float t = 0.f;
      for (int w = 0; w < warps; ++w) t += smem[w * 32 + lane];
      int ti, tj;
      tile_pair(pair, tiles, ti, tj);
      const int i = ti * kTile + local / kTile, j = tj * kTile + local % kTile;
      if (i < B && j < B && (ti < tj || i <= j)) {
        gram[(size_t)i * B + j] = t;
        gram[(size_t)j * B + i] = t;
      }
    }
    __syncthreads();
  }
  grid_sync(bar);

  // (c) a warp per row
  for (int i = blockIdx.x * warps + warp; i < B; i += gridDim.x * warps) {
    const float t = row_term(gram, geo, B, i, p);
    if (lane == 0) terms[i] = t;
  }

  // (d) the mean, in a fixed order, by the last block to arrive
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's terms are visible before its ticket
    last = atomicAdd(bar + 2, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    float s = 0.f;
    for (int i = threadIdx.x; i < B; i += kThreads) s += __ldcg(terms + i);
    s = warp_reduce<0>(s);
    if (lane == 0) smem[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < warps; ++w) t += smem[w];
      out[0] = t / (float)B;
      bar[2] = 0;  // every block has taken its ticket
    }
  }
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int scl_wms_tile_rows(void) { return kTile; }
int scl_wms_item_cols(void) { return kItemCols; }

// How many blocks of the kernel the device can hold at once (the cooperative
// launch's largest grid), or a negative cudaError_t.
int scl_wms_resident_blocks(void) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wms_kernel, kThreads,
                                                        kSmemBytes);
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

// emb (B, D) fp32, geo (B, B) fp32, all contiguous on one device, emb 16-byte
// aligned; ws the workspace laid out as the kernel's comment says, the loss
// at its last float, with n_chunks = ceil(D / scl_wms_item_cols()); bar three
// uint32 that are zero when no launch is in flight (the kernel leaves them
// so); `grid` blocks, at most scl_wms_resident_blocks() (which also sets the
// kernel's shared-memory attribute: call it first). Returns the launch's
// error or 0.
int scl_wms_loss(const void* emb, const void* geo, void* ws, void* bar, int B, int D, int n_chunks,
                 int grid, float d_alpha, float d_beta, float alpha, float beta, float lamb,
                 float eps, int mining, void* stream) {
  Params p{d_alpha, d_beta, alpha, beta, lamb, eps, mining};
  const float* e = static_cast<const float*>(emb);
  const float* g = static_cast<const float*>(geo);
  float* w = static_cast<float*>(ws);
  unsigned* b = static_cast<unsigned*>(bar);
  void* args[] = {&e, &g, &w, &b, &B, &D, &n_chunks, &p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(wms_kernel), dim3(grid), dim3(kThreads), args, kSmemBytes,
      static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // extern "C"
