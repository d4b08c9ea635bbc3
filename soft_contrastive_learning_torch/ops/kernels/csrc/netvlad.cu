// Fused NetVLAD aggregation (K1) for Hopper, sm_90a.
//
// Replaces soft_contrastive_learning_tpu/ops/pallas/netvlad_kernel.py
// (_netvlad_kernel, called from vlad_aggregate_pallas). Per image b it
// computes, from x (N, D) fp32, logits (N, K) fp32 or bf16 and the negated
// centers C (D, K) fp32:
//   a = softmax_K(logits)                         (N, K)
//   V = x^T a + C * sum_n a                       (D, K)
//   V[:, k] /= sqrt(sum_d V[d, k]^2 + 1e-12)      intra-normalization
//   V /= sqrt(sum V^2 + 1e-12)                    global L2
// and stores V d-major, out[b, d*K + k], in one pass.
//
// Bound on this card: at the flagship shapes (B=64, N=165, D=512, K=64) the
// product is 0.69 GFLOP of fp32 FMA against ~33 MB of traffic, so the fp32
// (non-tensor-core) rate and the bytes give about the same floor, ~10 us.
// Full fp32 FMA (no TF32) keeps the result within ~1e-6 of the plain
// PyTorch version.
//
// Design: the TPU kernel keeps a whole image in VMEM; here one image's x is
// 338 KB, more than a block's 227 KB of shared memory, so x is streamed
// through shared memory 64 columns (42 KB) at a time with coalesced loads.
// One block per image: the (N, K) softmax (42 KB) and the (D, K) fp32 result
// (128 KB) stay in shared memory, the product runs over those D-chunks with
// a 4x4 register tile per thread, and both norms are applied before the
// single coalesced store. The logits are staged with coalesced loads too.
// Only B blocks are in flight (64 at batch 64 on 132 SMs), each running its
// product alone, which is what keeps it at ~9x its bound; splitting an
// image over a cluster of blocks and moving the product to wgmma is later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;      // clusters: 16 thread columns x 4
constexpr int kDChunk = 64;    // descriptor rows per pass: 16 thread rows x 4
constexpr int kRowGroups = kThreads / 16;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename LogitT>
__global__ void __launch_bounds__(kThreads)
netvlad_kernel(const float* __restrict__ x, const LogitT* __restrict__ logits,
               const float* __restrict__ neg_centers, float* __restrict__ out,
               int N, int D, int K) {
  extern __shared__ __align__(16) float smem[];
  float* a = smem;                          // (N, K) soft assignment
  float* v = a + N * K;                     // (D, K) aggregated residuals
  float* part = v + D * K;                  // (kRowGroups, kMaxK) partial sums of squares
  float* mass = part + kRowGroups * kMaxK;  // (kMaxK) sum_n a[n, k]
  float* scale = mass + kMaxK;              // (kMaxK) intra-norm x global-norm factor
  float* xs = scale + kMaxK;                // (N, kDChunk) staged feature columns

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xb = x + (size_t)b * N * D;
  const LogitT* sb = logits + (size_t)b * N * K;

  // 1. Softmax over clusters. The logits are staged first with coalesced
  //    loads by the whole block; then one warp per row, two clusters per
  //    lane, in place.
  for (int i = tid; i < N * K; i += kThreads) a[i] = to_f32(sb[i]);
  __syncthreads();
  for (int n = warp; n < N; n += kThreads / 32) {
    const float s0 = lane < K ? a[n * K + lane] : -INFINITY;
    const float s1 = lane + 32 < K ? a[n * K + lane + 32] : -INFINITY;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float e0 = lane < K ? expf(s0 - m) : 0.f;
    const float e1 = lane + 32 < K ? expf(s1 - m) : 0.f;
    float sum = e0 + e1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane < K) a[n * K + lane] = e0 / sum;
    if (lane + 32 < K) a[n * K + lane + 32] = e1 / sum;
  }
  __syncthreads();

  // 2. Assignment mass per cluster.
  if (tid < K) {
    float m = 0.f;
    for (int n = 0; n < N; ++n) m += a[n * K + tid];
    mass[tid] = m;
  }
  __syncthreads();

  // 3. V = x^T a + C * mass, 64 descriptor rows per pass; thread (td, tk)
  //    owns rows d0..d0+3 and clusters k0..k0+3.
  const int tk = tid & 15;
  const int td = tid >> 4;
  const int k0 = tk * 4;
  const bool active_k = k0 < K;
  float sq[4] = {0.f, 0.f, 0.f, 0.f};
  for (int dc = 0; dc < D; dc += kDChunk) {
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int t = tid; t < N * (kDChunk / 4); t += kThreads) {
      const int n = t / (kDChunk / 4), c = (t % (kDChunk / 4)) * 4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (dc + c < D) val = __ldg(reinterpret_cast<const float4*>(xb + (size_t)n * D + dc + c));
      *reinterpret_cast<float4*>(xs + n * kDChunk + c) = val;
    }
    __syncthreads();
    const int d0 = dc + td * 4;
    if (!active_k || d0 >= D) continue;
    float acc[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + n * kDChunk + td * 4);
      const float4 av = *reinterpret_cast<const float4*>(a + n * K + k0);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], ar[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += mass[k0 + j] * neg_centers[(size_t)(d0 + i) * K + k0 + j];
        sq[j] = fmaf(acc[i][j], acc[i][j], sq[j]);
      }
      *reinterpret_cast<float4*>(v + (d0 + i) * K + k0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  if (active_k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) part[td * kMaxK + k0 + j] = sq[j];
  }
  __syncthreads();

  // 4. Intra-norm per cluster, then the global norm of the intra-normalized
  //    descriptor: sum_k ss_k / (ss_k + eps), folded into one scale per k.
  if (warp == 0) {
    float g = 0.f;
    for (int k = lane; k < K; k += 32) {
      float ss = 0.f;
      for (int r = 0; r < kRowGroups; ++r) ss += part[r * kMaxK + k];
      const float inv = 1.f / sqrtf(ss + kEps);
      scale[k] = inv;
      g += ss * inv * inv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) g += __shfl_xor_sync(0xffffffffu, g, off);
    const float ginv = 1.f / sqrtf(g + kEps);
    for (int k = lane; k < K; k += 32) scale[k] *= ginv;
  }
  __syncthreads();

  // 5. One coalesced store of the d-major (D, K) tile.
  float* ob = out + (size_t)b * D * K;
  for (int i = tid * 4; i < D * K; i += kThreads * 4) {
    const int k = i % K;
    float4 vv = *reinterpret_cast<const float4*>(v + i);
    vv.x *= scale[k];
    vv.y *= scale[k + 1];
    vv.z *= scale[k + 2];
    vv.w *= scale[k + 3];
    *reinterpret_cast<float4*>(ob + i) = vv;
  }
}

template <typename LogitT>
int launch(const float* x, const LogitT* logits, const float* neg_centers, float* out,
           int B, int N, int D, int K, cudaStream_t stream) {
  const size_t smem =
      ((size_t)N * K + (size_t)D * K + kRowGroups * kMaxK + 2 * kMaxK + (size_t)N * kDChunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      netvlad_kernel<LogitT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  netvlad_kernel<LogitT><<<B, kThreads, smem, stream>>>(x, logits, neg_centers, out, N, D, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block needs; the wrapper refuses shapes above
// the card's per-block limit before launching.
size_t scl_netvlad_smem_bytes(int N, int D, int K) {
  return ((size_t)N * K + (size_t)D * K + kRowGroups * kMaxK + 2 * kMaxK + (size_t)N * kDChunk) * sizeof(float);
}

int scl_netvlad_max_clusters(void) { return kMaxK; }

// x (B, N, D) fp32, logits (B, N, K) fp32 or bf16 (logits_bf16 != 0),
// neg_centers (D, K) fp32, out (B, D*K) fp32; all contiguous on one device.
// Requires K <= 64, K % 4 == 0 and D % 4 == 0. Returns cudaGetLastError().
int scl_netvlad_aggregate(const void* x, const void* logits, int logits_bf16,
                          const void* neg_centers, void* out, int B, int N, int D, int K,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_bf16)
    return launch(static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(logits),
                  static_cast<const float*>(neg_centers), static_cast<float*>(out), B, N, D,
                  K, s);
  return launch(static_cast<const float*>(x), static_cast<const float*>(logits),
                static_cast<const float*>(neg_centers), static_cast<float*>(out), B, N, D, K,
                s);
}

}  // extern "C"
