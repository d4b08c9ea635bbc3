// Tiled batched matrix product C[z] = A[z] . B[z] for Hopper, sm_90a: the
// hand-written kernel behind the matmul-rate probes.
//
// Replaces the Pallas kernels of the probe scripts under perf/:
// mxu_probe.py (resident_dot, blocked_grid), mxu_probe2.py, mxu_probe3.py and
// mxu_probe4.py (pallas_matmul) and matmul_probe.py (probe). On the TPU they
// are one function, a matrix product, asked at different shapes, types and
// blockings; here they are one kernel template with a short list of tile
// shapes. A (Z, M, K) and B (Z, K, N) row-major, bf16 or int8; C (Z, M, N)
// row-major, fp32 or bf16 from bf16 operands (fp32 sums, one rounding at the
// cast), int32 from int8 operands (exact).
//
// Bound on this card: 2 Z M K N operations at the tensor-core rate of the
// type (989 TFLOP/s bf16, 1,979 TOP/s int8, dense) against Z (M K + K N)
// input bytes read once and Z M N output bytes written once at 3.35 TB/s.
// The probes' large problems are operation-bound (8192 x 4096 x 8192: 0.556 ms
// in bf16, 0.278 ms in int8); the Winograd product shapes with C = 128 are
// byte-bound.
//
// Design. A block owns a (BM, BN) tile of C for batch entry blockIdx.z and
// loops over K in chunks of BK. Each chunk of A (BM, BK) and B (BK, BN) comes
// into shared memory with 16-byte cp.async copies, three stages deep, so that
// two chunks are in flight while one is multiplied; rows past M are filled
// with zeros by the copy itself (source size 0), so a ragged last tile needs
// no padded operand. Each warp owns a (WM, WN) part of the tile as m16n16k16
// fragments (nvcuda::wmma: mma.sync with fp32 or int32 accumulators), which
// stay in registers across the K loop. The epilogue takes every fragment
// through a 1 KB patch of shared memory per warp, casts, and writes 8
// contiguous outputs a lane with the rows past M masked. B stays (K, N)
// row-major for both types, as the probes give it; for int8 that is the
// costlier of wmma's two layouts and is kept for a like-for-like shape.
// Not here: wgmma, TMA, clusters, a persistent grid. They are the way to the
// card's full rate and come as further instantiations of this probe.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kStages = 3;
constexpr int kNumConfigs = 4;
// (BM, BN, BK) and the warp's (WM, WN) part of it
constexpr int kConfigs[kNumConfigs][5] = {
    {64, 64, 32, 32, 32},
    {128, 128, 32, 64, 32},
    {128, 256, 32, 64, 64},
    {256, 128, 64, 64, 64},
};

template <typename T> struct AccOf;
template <> struct AccOf<__nv_bfloat16> { using type = float; };
template <> struct AccOf<signed char> { using type = int; };

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 contiguous outputs, 16-byte aligned on both sides
__device__ __forceinline__ void store8(float* d, const float* s) {
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
  *reinterpret_cast<float4*>(d + 4) = *reinterpret_cast<const float4*>(s + 4);
}
__device__ __forceinline__ void store8(int* d, const int* s) {
  *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(s);
  *reinterpret_cast<int4*>(d + 4) = *reinterpret_cast<const int4*>(s + 4);
}
__device__ __forceinline__ void store8(__nv_bfloat16* d, const float* s) {
  __align__(16) __nv_bfloat162 h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(s[2 * e], s[2 * e + 1]);
  *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(h);
}

template <typename InT, int BM, int BN, int BK> struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(InT);  // elements per 16-byte copy
  static constexpr int kLda = BK + kVec;              // row strides, padded by 16 bytes
  static constexpr int kLdb = BN + kVec;
  static constexpr int kABytes = BM * kLda * (int)sizeof(InT);
  static constexpr int kBBytes = BK * kLdb * (int)sizeof(InT);
  static constexpr int kSmemBytes = kStages * (kABytes + kBBytes);
};

template <typename InT, typename OutT, int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gemm_kernel(const InT* __restrict__ a, const InT* __restrict__ b, OutT* __restrict__ c, int M,
            int N, int K) {
  using AccT = typename AccOf<InT>::type;
  using T = Tile<InT, BM, BN, BK>;
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  constexpr int kVec = T::kVec, kLda = T::kLda, kLdb = T::kLdb;
  constexpr int FM = WM / 16, FN = WN / 16;
  static_assert(kThreads / 32 * 1024 <= T::kSmemBytes, "epilogue patches need the room");
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  a += (size_t)blockIdx.z * M * K;
  b += (size_t)blockIdx.z * K * N;
  c += (size_t)blockIdx.z * M * N;

  auto a_stage = [&](int s) {
    return reinterpret_cast<InT*>(smem + s * (T::kABytes + T::kBBytes));
  };
  auto b_stage = [&](int s) {
    return reinterpret_cast<InT*>(smem + s * (T::kABytes + T::kBBytes) + T::kABytes);
  };
  auto load = [&](int s, int k0) {
    InT* as = a_stage(s);
    InT* bs = b_stage(s);
    constexpr int kARow = BK / kVec, kBRow = BN / kVec;  // copies per row
#pragma unroll
    for (int idx = tid; idx < BM * kARow; idx += kThreads) {
      const int row = idx / kARow, v = idx - row * kARow;
      const int gr = m0 + row;
      const bool ok = gr < M;  // rows past M: zeros, the address stays inside A
      cp_async16(as + row * kLda + v * kVec, a + (size_t)(ok ? gr : M - 1) * K + k0 + v * kVec,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int idx = tid; idx < BK * kBRow; idx += kThreads) {
      const int row = idx / kBRow, v = idx - row * kBRow;
      cp_async16(bs + row * kLdb + v * kVec, b + (size_t)(k0 + row) * N + n0 + v * kVec, 16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, AccT> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], AccT(0));

  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // chunk kt has landed
    __syncthreads();               // and everyone is done with chunk kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load(nxt % kStages, nxt * BK);  // into the stage chunk kt - 1 used
    cp_async_commit();
    const InT* as = a_stage(kt % kStages) + wm * WM * kLda;
    const InT* bs = b_stage(kt % kStages) + wn * WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, InT, wmma::row_major> af[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(af[i], as + i * 16 * kLda + kk, kLda);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, InT, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, bs + kk * kLdb + j * 16, kLdb);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the operand stages are dead: their room takes the patches

  AccT* patch = reinterpret_cast<AccT*>(smem) + warp * 256;  // 16 x 16 per warp
  const int r = lane >> 1, cb = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * WM + i * 16 + r;
      if (gr < M) store8(c + (size_t)gr * N + n0 + wn * WN + j * 16 + cb, patch + r * 16 + cb);
      __syncwarp();
    }
}

template <typename InT, typename OutT, int BM, int BN, int BK, int WM, int WN>
int launch(const void* a, const void* b, void* c, int Z, int M, int N, int K, cudaStream_t s) {
  auto kernel = gemm_kernel<InT, OutT, BM, BN, BK, WM, WN>;
  constexpr int smem = Tile<InT, BM, BN, BK>::kSmemBytes;
  // above 48 KB the launch is refused unless the attribute is set; once is enough
  static const int attr_err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr_err) return attr_err;
  const dim3 grid(N / BN, (M + BM - 1) / BM, Z);
  kernel<<<grid, (BM / WM) * (BN / WN) * 32, smem, s>>>(
      static_cast<const InT*>(a), static_cast<const InT*>(b), static_cast<OutT*>(c), M, N, K);
  return (int)cudaGetLastError();
}

template <typename InT, typename OutT>
int launch_config(int config, const void* a, const void* b, void* c, int Z, int M, int N, int K,
                  cudaStream_t s) {
  switch (config) {
    case 0: return launch<InT, OutT, 64, 64, 32, 32, 32>(a, b, c, Z, M, N, K, s);
    case 1: return launch<InT, OutT, 128, 128, 32, 64, 32>(a, b, c, Z, M, N, K, s);
    case 2: return launch<InT, OutT, 128, 256, 32, 64, 64>(a, b, c, Z, M, N, K, s);
    case 3: return launch<InT, OutT, 256, 128, 64, 64, 64>(a, b, c, Z, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int scl_probe_gemm_num_configs(void) { return kNumConfigs; }

// what = 0, 1, 2: BM, BN, BK of tile shape `config`
int scl_probe_gemm_config(int config, int what) {
  return config >= 0 && config < kNumConfigs && what >= 0 && what < 3 ? kConfigs[config][what]
                                                                      : -1;
}

// a (Z, M, K), b (Z, K, N), c (Z, M, N), contiguous on one device. int8 != 0:
// signed 8-bit operands and int32 c; else bf16 operands and c in bf16
// (out_bf16 != 0) or fp32. N a multiple of the tile's BN, K of its BK, any
// M > 0; N / BN, ceil(M / BM) and Z within the grid's limits (2^31, 65,535,
// 65,535). Returns cudaGetLastError() of the launch, else 0.
int scl_probe_gemm(const void* a, const void* b, void* c, int Z, int M, int N, int K, int int8,
                   int out_bf16, int config, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) return launch_config<signed char, int>(config, a, b, c, Z, M, N, K, s);
  return out_bf16 ? launch_config<__nv_bfloat16, __nv_bfloat16>(config, a, b, c, Z, M, N, K, s)
                  : launch_config<__nv_bfloat16, float>(config, a, b, c, Z, M, N, K, s);
}

}  // extern "C"
