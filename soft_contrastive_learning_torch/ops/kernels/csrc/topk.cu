// Streaming brute-force L2 top-k (K2) for Hopper, sm_90a.
//
// Replaces soft_contrastive_learning_tpu/ops/pallas/topk_kernel.py
// (_topk_kernel, called from topk_l2_pallas). For queries q (Q, D) and refs
// r (R, D), both fp32, it returns the k <= 128 nearest refs per query by
// score = 2 q.r - |r|^2 (a monotone transform of -|q - r|^2), ties to the
// smallest ref id, as distances sqrt(max(|q|^2 - score, 0)) with int64 ids,
// padded with (inf, -1) when R < k.
//
// Bound on this card: 2*Q*R*D fp32 FMA operations against R*D*4 bytes of
// refs read once. At Q=64 the fp32 (non-tensor-core) rate is the floor
// (64 x 66,048 x 32,768: 277 GFLOP, ~4.1 ms at 67 TFLOP/s; 8.7 GB, ~2.6 ms
// at 3.35 TB/s). Full fp32 FMA, no TF32, so that the ids agree exactly with
// the plain PyTorch version wherever scores are exact.
//
// Design: the TPU grid runs in order and carries a running best set in
// scratch; Hopper blocks run in no order, so the refs are split instead.
//   kernel 1 (partial): one block per (64-query tile, 256-ref chunk). D is
//     streamed through shared memory 32 columns at a time (a raw 32,768-D
//     ref row is 128 KB, so no row is ever resident whole); each thread
//     keeps an 8x8 register tile of dot products and warp 0 also sums |r|^2.
//     The 64x256 scores then go to shared memory, and each warp selects the
//     top-p of its 8 queries by p rounds of a warp-wide arg-max, ordered by
//     (score desc, id asc). Partials go to a (Q, n_chunks, p) scratch.
//   kernel 2 (merge): one block per query does a p-round tournament over
//     the heads of the n_chunks sorted partial lists, then converts to
//     distances. Every ref row is read from device memory once per query
//     tile; the (Q, R) score matrix never leaves the chip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // queries per block
constexpr int kBR = 256;           // refs per block: one split-R chunk
constexpr int kBK = 32;            // D columns per shared-memory stage
constexpr int kLd = kBK + 4;       // padded row stride: conflict-free float4 reads
constexpr int kThreads = 256;      // 8 warps x (8 queries x 8 refs per lane)
constexpr int kMergeThreads = 128;
constexpr int kInvalidId = 0x7fffffff;

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

__global__ void __launch_bounds__(kThreads, 2)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ r,
                    float* __restrict__ part_s, int* __restrict__ part_i, int Q, int R, int D,
                    int p, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // (kBQ, kLd) query stage
  float* rs = qs + kBQ * kLd;     // (kBR, kLd) ref stage
  float* rsq = rs + kBR * kLd;    // (kBR) |r|^2
  float* sc = rsq + kBR;          // (kBQ, kBR) scores

  const int chunk = blockIdx.x;
  const int q_base = blockIdx.y * kBQ;
  const int r_base = chunk * kBR;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // acc[i][j]: query warp*8 + i, ref lane + 32*j (refs strided by 32 so that
  // both the float4 stage reads and the score stores are conflict-free).
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float rsq_acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int d0 = 0; d0 < D; d0 += kBK) {
    // Stage the tiles: 8 threads cover one 128-byte row segment (coalesced).
#pragma unroll
    for (int t = tid; t < kBQ * kBK / 4; t += kThreads) {
      const int row = t >> 3, c = (t & 7) * 4;
      const int gq = q_base + row, gd = d0 + c;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gq < Q && gd < D) val = __ldg(reinterpret_cast<const float4*>(q + (size_t)gq * D + gd));
      *reinterpret_cast<float4*>(qs + row * kLd + c) = val;
    }
#pragma unroll
    for (int t = tid; t < kBR * kBK / 4; t += kThreads) {
      const int row = t >> 3, c = (t & 7) * 4;
      const int gr = r_base + row, gd = d0 + c;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < R && gd < D) val = __ldg(reinterpret_cast<const float4*>(r + (size_t)gr * D + gd));
      *reinterpret_cast<float4*>(rs + row * kLd + c) = val;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 rv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rv[j] = *reinterpret_cast<const float4*>(rs + (lane + 32 * j) * kLd + kk);
      if (warp == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          rsq_acc[j] = fmaf(rv[j].x, rv[j].x, rsq_acc[j]);
          rsq_acc[j] = fmaf(rv[j].y, rv[j].y, rsq_acc[j]);
          rsq_acc[j] = fmaf(rv[j].z, rv[j].z, rsq_acc[j]);
          rsq_acc[j] = fmaf(rv[j].w, rv[j].w, rsq_acc[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (warp * 8 + i) * kLd + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(qv.x, rv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv.y, rv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv.z, rv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv.w, rv[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) rsq[lane + 32 * j] = rsq_acc[j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sc[(warp * 8 + i) * kBR + lane + 32 * j] = 2.0f * acc[i][j] - rsq[lane + 32 * j];
  __syncthreads();

  // Per-query top-p of this chunk: p rounds of a warp arg-max. Each lane
  // holds 8 candidates; the winner's owner drops it before the next round.
  for (int i = 0; i < 8; ++i) {
    const int ql = warp * 8 + i;
    const int gq = q_base + ql;
    if (gq >= Q) break;
    float s[8];
    int id[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = lane + 32 * j;
      const bool valid = r_base + col < R;
      s[j] = valid ? sc[ql * kBR + col] : -INFINITY;
      id[j] = valid ? r_base + col : kInvalidId;
    }
    float* ps = part_s + ((size_t)gq * n_chunks + chunk) * p;
    int* pi = part_i + ((size_t)gq * n_chunks + chunk) * p;
    for (int t = 0; t < p; ++t) {
      float bs = -INFINITY;
      int bi = kInvalidId;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (better(s[j], id[j], bs, bi)) { bs = s[j]; bi = id[j]; }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, bs, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
      }
      if (lane == 0) { ps[t] = bs; pi[t] = bi; }
      if (bi != kInvalidId) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (id[j] == bi) { s[j] = -INFINITY; id[j] = kInvalidId; }
      }
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ q, const float* __restrict__ part_s,
                  const int* __restrict__ part_i, float* __restrict__ out_d,
                  long long* __restrict__ out_i, int D, int n_chunks, int p, int k) {
  extern __shared__ int heads[];  // (n_chunks) next unread entry of each partial list
  __shared__ float w_s[kMergeThreads / 32];
  __shared__ int w_i[kMergeThreads / 32];
  __shared__ int w_c[kMergeThreads / 32];
  __shared__ float qsq_s;

  const int gq = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* ps = part_s + (size_t)gq * n_chunks * p;
  const int* pi = part_i + (size_t)gq * n_chunks * p;

  // |q|^2 for the distance conversion.
  float acc = 0.f;
  for (int d = tid; d < D; d += kMergeThreads) {
    const float val = q[(size_t)gq * D + d];
    acc = fmaf(val, val, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) w_s[warp] = acc;
  for (int c = tid; c < n_chunks; c += kMergeThreads) heads[c] = 0;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kMergeThreads / 32; ++w) t += w_s[w];
    qsq_s = t;
  }
  __syncthreads();
  const float qsq = qsq_s;

  // Each thread's best head among the chunks it owns (c = tid mod 128).
  float ls = -INFINITY;
  int li = kInvalidId, lc = -1;
  auto refresh = [&]() {
    ls = -INFINITY; li = kInvalidId; lc = -1;
    for (int c = tid; c < n_chunks; c += kMergeThreads) {
      const int h = heads[c];
      if (h < p) {
        const float s = ps[(size_t)c * p + h];
        const int i = pi[(size_t)c * p + h];
        if (lc < 0 || better(s, i, ls, li)) { ls = s; li = i; lc = c; }
      }
    }
  };
  refresh();

  for (int t = 0; t < k; ++t) {
    float bs = ls;
    int bi = li, bc = lc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (better(os, oi, bs, bi) || (os == bs && oi == bi && oc > bc)) { bs = os; bi = oi; bc = oc; }
    }
    if (lane == 0) { w_s[warp] = bs; w_i[warp] = bi; w_c[warp] = bc; }
    __syncthreads();
    bs = w_s[0]; bi = w_i[0]; bc = w_c[0];
#pragma unroll
    for (int w = 1; w < kMergeThreads / 32; ++w)
      if (better(w_s[w], w_i[w], bs, bi) || (w_s[w] == bs && w_i[w] == bi && w_c[w] > bc)) {
        bs = w_s[w]; bi = w_i[w]; bc = w_c[w];
      }
    if (tid == 0) {
      const bool valid = bi != kInvalidId;
      out_d[(size_t)gq * k + t] = valid ? sqrtf(fmaxf(qsq - bs, 0.f)) : INFINITY;
      out_i[(size_t)gq * k + t] = valid ? (long long)bi : -1LL;
    }
    if (bc >= 0 && bc % kMergeThreads == tid) {
      heads[bc] += 1;
      refresh();
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Refs per split-R chunk: the wrapper sizes the (Q, n_chunks, p) scratch.
int scl_topk_chunk_rows(void) { return kBR; }

size_t scl_topk_merge_smem_bytes(int n_chunks) { return (size_t)n_chunks * sizeof(int); }

// q (Q, D) fp32, r (R, D) fp32, contiguous, D % 4 == 0, 1 <= p = min(k, R),
// p <= scl_topk_chunk_rows(). part_s/part_i: (Q, n_chunks, p) scratch with
// n_chunks = ceil(R / scl_topk_chunk_rows()). out_d (Q, k) fp32 and out_i
// (Q, k) int64 receive the ascending distances and ids. Launches both
// kernels on `stream`; returns cudaGetLastError().
int scl_topk_l2(const void* q, const void* r, void* part_s, void* part_i, void* out_d,
                void* out_i, int Q, int R, int D, int k, int p, int n_chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = ((size_t)kBQ * kLd + (size_t)kBR * kLd + kBR + (size_t)kBQ * kBR) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1(n_chunks, (Q + kBQ - 1) / kBQ);
  topk_partial_kernel<<<grid1, kThreads, smem1, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(r), static_cast<float*>(part_s),
      static_cast<int*>(part_i), Q, R, D, p, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem2 = (size_t)n_chunks * sizeof(int);
  err = cudaFuncSetAttribute(topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<Q, kMergeThreads, smem2, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(part_s),
      static_cast<const int*>(part_i), static_cast<float*>(out_d),
      static_cast<long long*>(out_i), D, n_chunks, p, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
