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
// 2 B^2 D FLOP and 4 (B D + 2 B^2) bytes.) This kernel forms the whole Gram.
//
// Design. The TPU kernel holds the whole (B, D) in one VMEM block and failed
// to compile at B >= 1024. Here the work is split so that every B runs:
//  (a) Gram partials: a block per (32-row tile i, 32-row tile j, D-chunk)
//      stages 32 columns of both tiles in shared memory at a time and keeps a
//      2x2 register tile per thread; its partial sums go to scratch
//      (n_chunks, B, B). At B = 50 there are only 4 output tiles and D is
//      long, so splitting D is what fills the SMs (the wrapper picks the
//      chunk count).
//  (b) Reduce: one thread per (i, j) sums the partials in chunk order, with
//      no atomics, so the loss is the same bits from run to run.
//  (c) Rows: every mining threshold is a row reduction, so one block per row
//      i normalizes and clamps its similarities (the norms are the Gram's
//      diagonal), builds the masks, takes the row max/min, and writes its
//      term.
//  (d) Mean: one block sums the B terms in a fixed order.
// All sums are fp32 with expf/log1pf (not the fast intrinsics).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;     // rows per Gram tile
constexpr int kStage = 32;    // columns staged per step
constexpr int kGramThreads = 256;  // 16 x 16 threads, 2 x 2 outputs each
constexpr int kRowThreads = 256;
constexpr float kNormEps = 1e-12f;

__global__ void __launch_bounds__(kGramThreads)
gram_partial_kernel(const float* __restrict__ x, float* __restrict__ part, int B, int D,
                    int chunk_cols) {
  __shared__ float xi[kTile][kStage + 1];
  __shared__ float xj[kTile][kStage + 1];
  const int i0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  const int c = blockIdx.z;
  const int d_begin = c * chunk_cols;
  const int d_end = min(d_begin + chunk_cols, D);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lc = tid & 31, lr = tid >> 5;  // loader: column, first row
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int d0 = d_begin; d0 < d_end; d0 += kStage) {
#pragma unroll
    for (int r = lr; r < kTile; r += kGramThreads / 32) {
      const int d = d0 + lc;
      const bool col_ok = d < d_end;
      xi[r][lc] = (col_ok && i0 + r < B) ? x[(size_t)(i0 + r) * D + d] : 0.f;
      xj[r][lc] = (col_ok && j0 + r < B) ? x[(size_t)(j0 + r) * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kStage; ++k) {
      const float a0 = xi[ty * 2][k], a1 = xi[ty * 2 + 1][k];
      const float b0 = xj[tx * 2][k], b1 = xj[tx * 2 + 1][k];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  float* pc = part + (size_t)c * B * B;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + ty * 2 + a, j = j0 + tx * 2 + b;
      if (i < B && j < B) pc[(size_t)i * B + j] = acc[a][b];
    }
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ gram,
                                   int BB, int n_chunks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BB) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * BB + idx];
  gram[idx] = s;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float inv_norm(const float* gram, int B, int i) {
  return 1.f / sqrtf(fmaxf(gram[(size_t)i * B + i], kNormEps));
}

// Block-wide reduction of one value per thread; op 0 = sum, 1 = max, 2 = min.
// Every thread gets the result. Fixed order: lanes by xor-shuffle, then warps.
template <int Op>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = Op == 0 ? v + o : (Op == 1 ? fmaxf(v, o) : fminf(v, o));
  }
  __syncthreads();  // scratch is free from the previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    r = Op == 0 ? r + scratch[w] : (Op == 1 ? fmaxf(r, scratch[w]) : fminf(r, scratch[w]));
  return r;
}

struct Params {
  float d_alpha, d_beta, alpha, beta, lamb, eps;
  int mining;
};

__global__ void __launch_bounds__(kRowThreads)
row_terms_kernel(const float* __restrict__ gram, const float* __restrict__ geo,
                 float* __restrict__ terms, int B, Params p) {
  __shared__ float scratch[kRowThreads / 32];
  const int i = blockIdx.x;
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
    for (int j = threadIdx.x; j < B; j += blockDim.x) {
      float sim, mp, mn;
      load(j, sim, mp, mn);
      neg_max = fmaxf(neg_max, sim * mn);
      pos_max = fmaxf(pos_max, sim * mp);
    }
    max_val = block_reduce<1>(neg_max, scratch);
    const float tmp_max = block_reduce<1>(pos_max, scratch);
    float lo = INFINITY;
    for (int j = threadIdx.x; j < B; j += blockDim.x) {
      float sim, mp, mn;
      load(j, sim, mp, mn);
      lo = fminf(lo, (sim - tmp_max) * mp);
    }
    min_val = block_reduce<2>(lo, scratch) + tmp_max;
  }

  float pos_sum = 0.f, neg_sum = 0.f;
  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    float sim, mp, mn;
    load(j, sim, mp, mn);
    if (p.mining) {
      if (!(sim * mp < max_val + p.eps)) mp = 0.f;
      if (!(sim * mn > min_val - p.eps)) mn = 0.f;
    }
    if (mp > 0.f) pos_sum += expf(-p.alpha * (sim * mp - p.lamb));
    if (mn > 0.f) neg_sum += expf(p.beta * (sim * mn - p.lamb));
  }
  pos_sum = block_reduce<0>(pos_sum, scratch);
  neg_sum = block_reduce<0>(neg_sum, scratch);
  if (threadIdx.x == 0) terms[i] = log1pf(pos_sum) / p.alpha + log1pf(neg_sum) / p.beta;
}

__global__ void __launch_bounds__(kRowThreads)
mean_kernel(const float* __restrict__ terms, float* __restrict__ out, int B) {
  __shared__ float scratch[kRowThreads / 32];
  float s = 0.f;
  for (int i = threadIdx.x; i < B; i += blockDim.x) s += terms[i];
  s = block_reduce<0>(s, scratch);
  if (threadIdx.x == 0) out[0] = s / (float)B;
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int scl_wms_tile_rows(void) { return kTile; }
int scl_wms_stage_cols(void) { return kStage; }

// emb (B, D) fp32, geo (B, B) fp32, all contiguous on one device; scratch:
// part (n_chunks, B, B), gram (B, B), terms (B) fp32; out (1) fp32. The
// chunks of chunk_cols columns cover D. Returns the first non-zero
// cudaGetLastError() of the four launches, else 0.
int scl_wms_loss(const void* emb, const void* geo, void* part, void* gram, void* terms,
                 void* out, int B, int D, int n_chunks, int chunk_cols, float d_alpha,
                 float d_beta, float alpha, float beta, float lamb, float eps, int mining,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (B + kTile - 1) / kTile;
  gram_partial_kernel<<<dim3(tiles, tiles, n_chunks), kGramThreads, 0, s>>>(
      static_cast<const float*>(emb), static_cast<float*>(part), B, D, chunk_cols);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int bb = B * B;
  gram_reduce_kernel<<<(bb + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                      static_cast<float*>(gram), bb, n_chunks);
  err = (int)cudaGetLastError();
  if (err) return err;
  const Params p{d_alpha, d_beta, alpha, beta, lamb, eps, mining};
  row_terms_kernel<<<B, kRowThreads, 0, s>>>(static_cast<const float*>(gram),
                                             static_cast<const float*>(geo),
                                             static_cast<float*>(terms), B, p);
  err = (int)cudaGetLastError();
  if (err) return err;
  mean_kernel<<<1, kRowThreads, 0, s>>>(static_cast<const float*>(terms),
                                        static_cast<float*>(out), B);
  return (int)cudaGetLastError();
}

}  // extern "C"
