// Fused NetVLAD aggregation (K1) for Hopper, sm_90a: forward and backward.
//
// Replaces soft_contrastive_learning_tpu/ops/pallas/netvlad_kernel.py
// (_netvlad_kernel, called from vlad_aggregate_pallas; and _fused_bwd, the
// custom_vjp's backward). Per image b, from x (N, D) fp32, logits s (N, K)
// fp32 or bf16 and the negated centers C (D, K) fp32:
//   a = softmax_K(s)                  (N, K)
//   m_k = sum_n a_nk
//   V = x^T a + C diag(m)             (D, K)
//   u_k = sqrt(sum_d V_dk^2 + 1e-12)  W = V / u       intra-normalization
//   g = sqrt(sum W^2 + 1e-12)         y = W / g       global L2
// stored d-major, y[b, d*K + k]. Given dy (B, D*K) the backward is
//   dW = dy/g - W <W, dy>/g^3 = (dy - y <y, dy>) / g
//   dV_.k = dW_.k/u_k - V_.k <V_.k, dW_.k>/u_k^3 = (dW_.k - g^2 y_.k <y_.k, dW_.k>) / u_k
//   dx = a dV^T (N, D),  da = x dV + 1 (sum_d C_dk dV_dk) (N, K)
//   ds = a * (da - rowsum(a * da)),   dC = sum_b m_bk dV_b
//
// Bound on this card at the flagship's shapes (N=165, D=512, K=64): the
// forward's product is 2 B N D K FLOP (0.69 GFLOP at B=64, 10.3 us at the fp32
// non-tensor-core rate) against ~33 MB; the backward is two such products
// plus dx's 16.9 MB at B=50. Full fp32 FMA (no TF32) keeps both within ~1e-6
// of the plain PyTorch versions.
//
// Design. One image is split over a cluster of kCluster = 4 blocks along D,
// kMaxChunks x 32 descriptor rows each, so B images fill 4 B blocks (256 at
// B=64, 200 at B=50, on 132 SMs). Each block stages the logits and takes the
// softmax of its image (10.5 k exps: cheaper than sharing it) and loads its
// x columns as 32-column TMA boxes (N rows x 128 bytes, the rows past N and
// the columns past D zero-filled by the TMA unit) into mbarrier-guarded
// stages.
//  Forward: a ring of 2 stages, one per half of the block: half h multiplies
//  local chunks h and h + 2 with a 4x4 register tile per thread, so the two
//  halves never wait for each other and the stage is reloaded as soon as its
//  half is done with it (a named barrier). ~90 KB of shared memory: two
//  blocks per SM. The per-cluster sums of squares are exchanged through
//  distributed shared memory (mapa); every block adds the four in rank order,
//  so all compute the same u and g, and a second cluster barrier keeps each
//  block alive until its peers have read it. The result stays in registers
//  until the scales are known, then one coalesced store. With a residual
//  pointer (training) rank 0 also writes 1/u_k and 1/g per image; inference
//  passes null and moves no extra byte.
//  Backward: the softmax again (from the logits the Function keeps) and the
//  two residual scales; <y, dy> and <y_.k, dW_.k> over the block's rows
//  (y and dy read from device memory, dW kept in shared memory) summed over
//  the cluster in rank order as above; dV in shared memory, its 16-byte
//  groups XOR-swizzled by row (conflict-free reads by row and by column);
//  dx = a dV^T for the block's rows. The softmax is then dead, and its space
//  takes a ring of 2 x-box stages for da's partial x^T dV (registers), which
//  is then written over the spent stages and summed over the cluster; each
//  block finishes a quarter of the positions, recomputing their softmax in
//  registers (ds in the logits' type). ~78 KB and <= 128 registers: two
//  blocks per SM. dC is not summed with atomics: each image writes m_bk dV_b
//  (B, D, K), and a second launch adds them in image order, so two runs give
//  the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 4;    // blocks per image, split along D
constexpr int kChunk = 32;     // descriptor rows (x columns) per TMA box: 128 bytes
constexpr int kMaxChunks = 4;  // chunks per block: D <= 4 * 4 * 32 = 512
constexpr int kMaxK = 64;      // clusters: 16 thread columns x 4
constexpr int kMaxN = 256;     // a TMA box dimension
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// the block's rows: chunks [first, first + count) of the image's ceil(D / 32)
struct Rows {
  int first, count;
  __device__ Rows(uint32_t rank, int D) {
    const int n_chunks = (D + kChunk - 1) / kChunk;
    const int per_block = (n_chunks + kCluster - 1) / kCluster;
    first = (int)rank * per_block;
    count = max(0, min(per_block, n_chunks - first));
  }
};

// Shared-memory layouts (byte offsets from a 1024-aligned base).
struct FwdLayout {
  int stage, a, small, bar, total;
  __host__ __device__ FwdLayout(int N, int K) {
    stage = N * kChunk * 4;  // a multiple of 128, as TMA's destination needs
    a = 2 * stage;
    small = a + N * K * 4;
    // mass, part (2 halves x 8 row groups), cl_ss, scale
    bar = small + (kMaxK + 16 * kMaxK + 2 * kMaxK) * 4;
    total = bar + 2 * 8 + 1024;
  }
};

struct BwdLayout {
  int stage, dv, small, bar, total;
  __host__ __device__ BwdLayout(int N, int K) {
    stage = N * kChunk * 4;
    // [0, dv): the softmax (N x K), then the ring of 2 x stages, then da's
    // partial (N x K)
    dv = max(N * K * 4, 2 * stage);
    small = dv + kMaxChunks * kChunk * kMaxK * 4;  // dV: the block's rows x 64, swizzled
    // mass, inv_u, tpart[4], t_slot, cpart[4], cc_slot, red[8], s_slot
    bar = small + (2 * kMaxK + 4 * kMaxK + kMaxK + 4 * kMaxK + kMaxK + 8 + 8) * 4;
    total = bar + 2 * 8 + 1024;
  }
};

// dV's element (r, k): the 16-byte group k / 4 XOR-swizzled by r % 16
__device__ __forceinline__ int dv_at(int r, int k) {
  return r * kMaxK + ((((k >> 2) ^ r) & 15) << 2) + (k & 3);
}

// One warp's softmax of a row of logits: lane holds clusters lane and
// lane + 32 (-inf past K, 0 out).
__device__ __forceinline__ void softmax_row(float s0, float s1, int K, float& a0, float& a1) {
  const int lane = threadIdx.x & 31;
  float m = fmaxf(s0, s1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float e0 = lane < K ? expf(s0 - m) : 0.f;
  const float e1 = lane + 32 < K ? expf(s1 - m) : 0.f;
  float sum = e0 + e1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  a0 = e0 / sum;
  a1 = e1 / sum;
}

// a = softmax_K(logits of image b) into shared memory (N x K, row stride K),
// and mass[k] = sum_n a[n, k] (4 threads a cluster, then in their order);
// `part` holds 4 x kMaxK floats of scratch. Ends with the block synchronized.
template <typename LogitT>
__device__ void softmax_and_mass(const LogitT* __restrict__ sb, float* a, float* mass,
                                 float* part, int N, int K) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < N * K; i += kThreads) a[i] = to_f32(sb[i]);
  __syncthreads();
  for (int n = warp; n < N; n += kThreads / 32) {
    float a0, a1;
    softmax_row(lane < K ? a[n * K + lane] : -INFINITY,
                lane + 32 < K ? a[n * K + lane + 32] : -INFINITY, K, a0, a1);
    if (lane < K) a[n * K + lane] = a0;
    if (lane + 32 < K) a[n * K + lane + 32] = a1;
  }
  __syncthreads();
  const int k = tid & 63, q = tid >> 6;
  if (k < K) {
    float m = 0.f;
    for (int n = q; n < N; n += 4) m += a[n * K + k];
    part[q * kMaxK + k] = m;
  }
  __syncthreads();
  if (tid < K)
    mass[tid] = ((part[tid] + part[kMaxK + tid]) + part[2 * kMaxK + tid]) + part[3 * kMaxK + tid];
  __syncthreads();
}

// the sum over the cluster's blocks, in rank order, of the float at `p`
__device__ __forceinline__ float cluster_sum(const float* p) {
  const uint32_t addr = sm90::smem_u32(p);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) s += sm90::ld_shared_cluster(addr, q);
  return s;
}

template <typename LogitT>
__global__ void __launch_bounds__(kThreads, 2)
netvlad_forward_kernel(const __grid_constant__ CUtensorMap map_x, const LogitT* __restrict__ logits,
                       const float* __restrict__ neg_centers, float* __restrict__ out,
                       float* __restrict__ scales, int N, int D, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const FwdLayout L(N, K);
  float* a = reinterpret_cast<float*>(base + L.a);
  float* mass = reinterpret_cast<float*>(base + L.small);
  float* part = mass + kMaxK;           // [half][row group][k] sums of squares
  float* cl_ss = part + 16 * kMaxK;     // this block's sum of squares per cluster
  float* scale = cl_ss + kMaxK;         // 1/u_k * 1/g
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L.bar);

  const uint32_t rank = sm90::cluster_ctarank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, half = tid >> 7, ht = tid & 127;
  const Rows rows(rank, D);
  const float* xs = reinterpret_cast<const float*>(base + half * L.stage);
  const uint32_t my_bar = sm90::smem_u32(&bar[half]);

  if (ht == 0) {
    sm90::mbar_init(my_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (ht == 0 && half < rows.count) {  // local chunks `half` and `half + 2` go through this stage
    sm90::mbar_arrive_expect_tx(my_bar, L.stage);
    sm90::tma_load_3d(sm90::smem_u32(xs), &map_x, my_bar, (rows.first + half) * kChunk, 0, b);
  }
  softmax_and_mass(logits + (size_t)b * N * K, a, mass, part, N, K);

  // V = x^T a for the half's chunks: thread (td, tk) owns rows 4 td.. and
  // clusters 4 tk.. of each.
  const int td = ht >> 4, tk = ht & 15, k0 = 4 * tk;
  const bool active_k = k0 < K;
  float acc[2][4][4] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = half + 2 * r;
    if (j >= rows.count) break;
    sm90::mbar_wait(my_bar, r);
    if (active_k) {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + n * kChunk + 4 * td);
        const float4 av = *reinterpret_cast<const float4*>(a + n * K + k0);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][i][q] = fmaf(xr[i], ar[q], acc[r][i][q]);
      }
    }
    if (r == 0 && j + 2 < rows.count) {
      sm90::named_barrier_sync(1 + half, 128);  // the half is done reading the stage
      if (ht == 0) {
        sm90::mbar_arrive_expect_tx(my_bar, L.stage);
        sm90::tma_load_3d(sm90::smem_u32(xs), &map_x, my_bar, (rows.first + j + 2) * kChunk, 0,
                          b);
      }
    }
  }

  // + C diag(m), and the sums of squares per cluster (rows past D are 0)
  float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = half + 2 * r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = (rows.first + j) * kChunk + 4 * td + i;
      const bool ok = active_k && j < rows.count && d < D;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = ok ? __fadd_rn(acc[r][i][q],
                                       __fmul_rn(mass[k0 + q], neg_centers[(size_t)d * K + k0 + q]))
                           : 0.f;
        acc[r][i][q] = v;
        sq[q] = fmaf(v, v, sq[q]);
      }
    }
  }
  if (active_k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) part[(half * 8 + td) * kMaxK + k0 + q] = sq[q];
  }
  __syncthreads();
  if (tid < K) {
    float s = 0.f;
    for (int g = 0; g < 16; ++g) s += part[g * kMaxK + tid];
    cl_ss[tid] = s;
  }
  sm90::cluster_sync();  // every block's cl_ss is written

  // every block: the same u and g from the four partial sums in rank order
  if (tid < 32) {
    float g = 0.f;
    for (int k = tid; k < K; k += 32) {
      const float ss = cluster_sum(&cl_ss[k]);
      const float inv = 1.f / sqrtf(ss + kEps);
      scale[k] = inv;
      g += ss * inv * inv;  // sum_d W_dk^2
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) g += __shfl_xor_sync(0xffffffffu, g, off);
    const float ginv = 1.f / sqrtf(g + kEps);
    if (scales != nullptr && rank == 0) {
      float* sc = scales + (size_t)b * (K + 1);
      for (int k = tid; k < K; k += 32) sc[k] = scale[k];
      if (tid == 0) sc[K] = ginv;
    }
    for (int k = tid; k < K; k += 32) scale[k] *= ginv;
  }
  sm90::cluster_sync();  // the peers are done reading cl_ss; scale is visible

  float* ob = out + (size_t)b * D * K;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = half + 2 * r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = (rows.first + j) * kChunk + 4 * td + i;
      if (active_k && j < rows.count && d < D)
        *reinterpret_cast<float4*>(ob + (size_t)d * K + k0) =
            make_float4(acc[r][i][0] * scale[k0], acc[r][i][1] * scale[k0 + 1],
                        acc[r][i][2] * scale[k0 + 2], acc[r][i][3] * scale[k0 + 3]);
    }
  }
}

template <typename LogitT>
__global__ void __launch_bounds__(kThreads, 2)
netvlad_backward_kernel(const __grid_constant__ CUtensorMap map_x,
                        const LogitT* __restrict__ logits, const float* __restrict__ neg_centers,
                        const float* __restrict__ y, const float* __restrict__ dy,
                        const float* __restrict__ scales, float* __restrict__ dx,
                        LogitT* __restrict__ ds, float* __restrict__ dv_mass, int N, int D, int K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const BwdLayout L(N, K);
  float* a = reinterpret_cast<float*>(base);  // then the x stages, then da's partial
  float* dv = reinterpret_cast<float*>(base + L.dv);
  float* mass = reinterpret_cast<float*>(base + L.small);
  float* inv_u = mass + kMaxK;
  float* tpart = inv_u + kMaxK;   // [row group][k]
  float* t_slot = tpart + 4 * kMaxK;
  float* cpart = t_slot + kMaxK;  // [row group][k]
  float* cc_slot = cpart + 4 * kMaxK;
  float* red = cc_slot + kMaxK;   // one float per warp
  float* s_slot = red + 8;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L.bar);

  const uint32_t rank = sm90::cluster_ctarank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Rows rows(rank, D);
  const int d_first = rows.first * kChunk, n_rows = rows.count * kChunk;

  if (tid == 0) {
    sm90::mbar_init(sm90::smem_u32(&bar[0]), 1);
    sm90::mbar_init(sm90::smem_u32(&bar[1]), 1);
    sm90::fence_barrier_init();
  }
  softmax_and_mass(logits + (size_t)b * N * K, a, mass, cpart, N, K);
  const float* sc = scales + (size_t)b * (K + 1);
  if (tid < K) inv_u[tid] = sc[tid];
  const float inv_g = sc[K];
  const float g = 1.f / inv_g;

  // element (row dg + 4 i, cluster kk) of the block's rows for thread (dg, kk)
  const int kk = tid & 63, dg = tid >> 6;
  const bool kk_ok = kk < K;
  const float* yb = y + (size_t)b * D * K;
  const float* dyb = dy + (size_t)b * D * K;
  constexpr int kRowsPerThread = kMaxChunks * kChunk / 4;
  auto row_ok = [&](int i) {
    const int r = dg + 4 * i;
    return kk_ok && r < n_rows && d_first + r < D;
  };
  auto at = [&](int i) { return (size_t)(d_first + dg + 4 * i) * K + kk; };
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < kRowsPerThread; ++i)
    if (row_ok(i)) s = fmaf(yb[at(i)], dyb[at(i)], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    s_slot[0] = t;
  }
  sm90::cluster_sync();  // 1: <y, dy> partials
  const float s1 = cluster_sum(s_slot);

  // dW = (dy - y <y, dy>) / g into dv; <y_.k, dW_.k> per cluster
  float t = 0.f;
#pragma unroll 8
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = dg + 4 * i;
    float w = 0.f;
    if (row_ok(i)) {
      const float yv = yb[at(i)];
      w = (dyb[at(i)] - yv * s1) * inv_g;
      t = fmaf(yv, w, t);
    }
    if (kk_ok) dv[dv_at(r, kk)] = w;
  }
  tpart[dg * kMaxK + kk] = t;
  __syncthreads();
  if (tid < K) t_slot[tid] = ((tpart[tid] + tpart[kMaxK + tid]) + tpart[2 * kMaxK + tid]) +
                             tpart[3 * kMaxK + tid];
  sm90::cluster_sync();  // 2: <y_.k, dW_.k> partials
  const float g2t = kk_ok ? g * g * cluster_sum(&t_slot[kk]) : 0.f;

  // dV = (dW - g^2 y <y_.k, dW_.k>) / u_k in place (rows past D: 0); m_bk dV_b
  // for dC, and sum_d C_dk dV_dk for da
  const float iu = kk_ok ? inv_u[kk] : 0.f;
  const float m = kk_ok ? mass[kk] : 0.f;
  float* dvm = dv_mass + (size_t)b * D * K;
  float cp = 0.f;
#pragma unroll 8
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (!row_ok(i)) continue;
    const int r = dg + 4 * i;
    const float v = (dv[dv_at(r, kk)] - yb[at(i)] * g2t) * iu;
    dv[dv_at(r, kk)] = v;
    dvm[at(i)] = m * v;
    cp = fmaf(neg_centers[at(i)], v, cp);
  }
  cpart[dg * kMaxK + kk] = cp;
  __syncthreads();  // dv is complete
  if (tid < K) cc_slot[tid] = ((cpart[tid] + cpart[kMaxK + tid]) + cpart[2 * kMaxK + tid]) +
                              cpart[3 * kMaxK + tid];

  // dx = a dV^T for the block's rows: warp w takes 4 positions at a time, lane
  // the rows lane, lane + 32, ... (coalesced stores, conflict-free dv reads)
  float* dxb = dx + (size_t)b * N * D;
  const int n_tiles = (N + 3) / 4;
  for (int nt = warp; nt < n_tiles; nt += kThreads / 32) {
    float acc[4][4] = {};
    for (int k = 0; k < K; k += 4) {
      float4 av[4], dvv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + min(4 * nt + i, N - 1) * K + k);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dvv[c] = *reinterpret_cast<const float4*>(dv + dv_at(lane + 32 * c, k));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][c] = fmaf(av[i].x, dvv[c].x, acc[i][c]);
          acc[i][c] = fmaf(av[i].y, dvv[c].y, acc[i][c]);
          acc[i][c] = fmaf(av[i].z, dvv[c].z, acc[i][c]);
          acc[i][c] = fmaf(av[i].w, dvv[c].w, acc[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * nt + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = lane + 32 * c, d = d_first + r;
        if (n < N && r < n_rows && d < D) dxb[(size_t)n * D + d] = acc[i][c];
      }
    }
  }
  __syncthreads();  // the softmax is dead: its space takes the x stages

  // da's partial x dV over the block's rows, in registers: thread (ns, tk4)
  // of warp w owns positions 4 nt.. (nt = 2 w + ns + 16 t) and clusters 4 tk4..
  auto stage = [&](int j) { return reinterpret_cast<float*>(base + (j & 1) * L.stage); };
  auto issue = [&](int j) {
    const uint32_t bj = sm90::smem_u32(&bar[j & 1]);
    sm90::fence_proxy_async();  // the threads' reads of this space come first
    sm90::mbar_arrive_expect_tx(bj, L.stage);
    sm90::tma_load_3d(sm90::smem_u32(stage(j)), &map_x, bj, (rows.first + j) * kChunk, 0, b);
  };
  if (tid == 0)
    for (int j = 0; j < min(2, rows.count); ++j) issue(j);
  const int tk4 = lane & 15, ns = lane >> 4, k0 = 4 * tk4;
  const bool act = k0 < K;
  float pacc[kMaxN / 64][4][4] = {};
  for (int j = 0; j < rows.count; ++j) {
    sm90::mbar_wait(sm90::smem_u32(&bar[j & 1]), (j >> 1) & 1);
    const float* xs = stage(j);
    for (int dd = 0; dd < kChunk; dd += 4) {
      float dvr[4][4];  // rows dd.. of dV, clusters k0..
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = act ? *reinterpret_cast<const float4*>(dv + dv_at(j * kChunk + dd + e, k0))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        dvr[e][0] = v.x;
        dvr[e][1] = v.y;
        dvr[e][2] = v.z;
        dvr[e][3] = v.w;
      }
#pragma unroll
      for (int rt = 0; rt < kMaxN / 64; ++rt) {
        const int nt = 2 * warp + ns + 16 * rt;
        if (4 * nt >= N) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + min(4 * nt + i, N - 1) * kChunk + dd);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int q = 0; q < 4; ++q) pacc[rt][i][q] = fmaf(xr[e], dvr[e][q], pacc[rt][i][q]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (tid == 0 && j + 2 < rows.count) issue(j + 2);
  }
  float* P = a;  // da's partial (N, K) over the spent stages
#pragma unroll
  for (int rt = 0; rt < kMaxN / 64; ++rt) {
    const int nt = 2 * warp + ns + 16 * rt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * nt + i;
      if (act && n < N)
        *reinterpret_cast<float4*>(P + n * K + k0) =
            make_float4(pacc[rt][i][0], pacc[rt][i][1], pacc[rt][i][2], pacc[rt][i][3]);
    }
  }
  sm90::cluster_sync();  // 3: da's partials and sum_d C dV

  // a quarter of the positions per block: their softmax again, in registers;
  // da = sum of the partials (rank order) + sum_d C_dk dV_dk; ds = a (da -
  // rowsum(a da)), one warp a row
  const float cc0 = lane < K ? cluster_sum(&cc_slot[lane]) : 0.f;
  const float cc1 = lane + 32 < K ? cluster_sum(&cc_slot[lane + 32]) : 0.f;
  const int per = (N + kCluster - 1) / kCluster;
  const int n_end = min(N, ((int)rank + 1) * per);
  const LogitT* sb = logits + (size_t)b * N * K;
  LogitT* dsb = ds + (size_t)b * N * K;
  for (int n = (int)rank * per + warp; n < n_end; n += kThreads / 32) {
    float a0, a1;
    softmax_row(lane < K ? to_f32(sb[n * K + lane]) : -INFINITY,
                lane + 32 < K ? to_f32(sb[n * K + lane + 32]) : -INFINITY, K, a0, a1);
    const float da0 = lane < K ? cluster_sum(&P[n * K + lane]) + cc0 : 0.f;
    const float da1 = lane + 32 < K ? cluster_sum(&P[n * K + lane + 32]) + cc1 : 0.f;
    float rs = a0 * da0 + a1 * da1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    if (lane < K) dsb[n * K + lane] = from_f32<LogitT>(a0 * (da0 - rs));
    if (lane + 32 < K) dsb[n * K + lane + 32] = from_f32<LogitT>(a1 * (da1 - rs));
  }
  sm90::cluster_sync();  // 4: no block leaves while a peer may still read it
}

// dC[e] = sum_b dv_mass[b, e], in image order
__global__ void __launch_bounds__(kThreads)
center_grad_kernel(const float* __restrict__ dv_mass, float* __restrict__ dc, int B, int DK) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= DK) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += dv_mass[(size_t)b * DK + e];
  dc[e] = s;
}

// x (B, N, D) fp32 as a 3-D tensor map of 32-column boxes, N rows deep
int encode_x(CUtensorMap* map, const void* x, int B, int N, int D) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {4ull * D, 4ull * N * D};
  const uint32_t box[3] = {kChunk, (uint32_t)N, 1};
  return sm90::encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, x, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int B, int smem, cudaStream_t s, Args... args) {
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, B);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&config, kernel, args...);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <typename LogitT>
int forward(const void* x, const void* logits, const void* neg_centers, void* out, void* scales,
            int B, int N, int D, int K, cudaStream_t s) {
  CUtensorMap map;
  int err = encode_x(&map, x, B, N, D);
  if (err) return err;
  return launch_clusters(netvlad_forward_kernel<LogitT>, B, FwdLayout(N, K).total, s, map,
                         static_cast<const LogitT*>(logits),
                         static_cast<const float*>(neg_centers), static_cast<float*>(out),
                         static_cast<float*>(scales), N, D, K);
}

template <typename LogitT>
int backward(const void* x, const void* logits, const void* neg_centers, const void* y,
             const void* dy, const void* scales, void* dx, void* ds, void* dc, void* dv_mass,
             int B, int N, int D, int K, cudaStream_t s) {
  CUtensorMap map;
  int err = encode_x(&map, x, B, N, D);
  if (err) return err;
  err = launch_clusters(netvlad_backward_kernel<LogitT>, B, BwdLayout(N, K).total, s, map,
                        static_cast<const LogitT*>(logits), static_cast<const float*>(neg_centers),
                        static_cast<const float*>(y), static_cast<const float*>(dy),
                        static_cast<const float*>(scales), static_cast<float*>(dx),
                        static_cast<LogitT*>(ds), static_cast<float*>(dv_mass), N, D, K);
  if (err) return err;
  const int dk = D * K;
  center_grad_kernel<<<(dk + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(dv_mass), static_cast<float*>(dc), B, dk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) { return sm90::error_string(err); }

// Dynamic shared memory one block of the forward (backward != 0: the
// backward) needs; the wrapper refuses shapes above the card's per-block
// limit before launching.
int scl_netvlad_smem_bytes(int N, int K, int backward) {
  return backward ? BwdLayout(N, K).total : FwdLayout(N, K).total;
}

// The kernels' limits: K <= clusters, D <= dim, N <= positions.
int scl_netvlad_max_clusters(void) { return kMaxK; }
int scl_netvlad_max_dim(void) { return kCluster * kMaxChunks * kChunk; }
int scl_netvlad_max_positions(void) { return kMaxN; }
int scl_netvlad_cluster_blocks(void) { return kCluster; }

// How many clusters of the forward (backward != 0: the backward) kernel with
// bf16 logits the device holds at once, or a negative cudaError_t.
int scl_netvlad_active_clusters(int N, int K, int backward) {
  const void* kernel = backward ? reinterpret_cast<const void*>(
                                      netvlad_backward_kernel<__nv_bfloat16>)
                                : reinterpret_cast<const void*>(
                                      netvlad_forward_kernel<__nv_bfloat16>);
  const int smem = backward ? BwdLayout(N, K).total : FwdLayout(N, K).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, 1024);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}

// x (B, N, D) fp32, logits (B, N, K) fp32 or bf16 (logits_bf16 != 0),
// neg_centers (D, K) fp32, out (B, D*K) fp32; scales (B, K + 1) fp32 or null:
// where given, 1/u_k and 1/g per image, the backward's residuals. All
// contiguous on one device, x 16-byte aligned; K <= 64, K % 4 == 0,
// D % 4 == 0, D <= 512, N <= 256. Returns the first error (a refused tensor
// map: sm90::kErrTensorMap + CUresult; a refused launch) or 0.
int scl_netvlad_aggregate(const void* x, const void* logits, int logits_bf16,
                          const void* neg_centers, void* out, void* scales, int B, int N, int D,
                          int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_bf16) return forward<__nv_bfloat16>(x, logits, neg_centers, out, scales, B, N, D, K, s);
  return forward<float>(x, logits, neg_centers, out, scales, B, N, D, K, s);
}

// The backward from the forward's inputs, its output y and its scales, and
// dy (B, D*K) fp32: dx (B, N, D) fp32, ds (B, N, K) in the logits' type, dc
// (D, K) fp32; dv_mass (B, D, K) fp32 is scratch. Same layout and limits as
// the forward. Two launches: the backward kernel, then dC's sum over images.
int scl_netvlad_backward(const void* x, const void* logits, int logits_bf16,
                         const void* neg_centers, const void* y, const void* dy,
                         const void* scales, void* dx, void* ds, void* dc, void* dv_mass, int B,
                         int N, int D, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (logits_bf16)
    return backward<__nv_bfloat16>(x, logits, neg_centers, y, dy, scales, dx, ds, dc, dv_mass, B,
                                   N, D, K, s);
  return backward<float>(x, logits, neg_centers, y, dy, scales, dx, ds, dc, dv_mass, B, N, D, K,
                         s);
}

}  // extern "C"
