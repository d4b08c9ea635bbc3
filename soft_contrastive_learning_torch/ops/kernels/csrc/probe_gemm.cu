// Tiled batched matrix product C[z] = A[z] . B[z] for Hopper, sm_90a: the
// hand-written kernels behind the matmul-rate probes.
//
// Replaces the Pallas kernels of the probe scripts under perf/:
// mxu_probe.py (resident_dot, blocked_grid), mxu_probe2.py, mxu_probe3.py and
// mxu_probe4.py (pallas_matmul) and matmul_probe.py (probe). On the TPU they
// are one function, a matrix product, asked at different shapes, types and
// blockings; here they are two kernel templates with a short list of tile
// shapes each. A (Z, M, K) and B (Z, K, N) row-major, bf16 or int8; C (Z, M, N)
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
// bf16: wgmma fed by TMA, warp-specialized. A block owns a (128, BN) tile of
// C for batch entry blockIdx.z (BN = 256, 128 or 64) and loops over K in
// steps of 64. One producer thread keeps TMA loads in flight into a ring of
// 4-6 stages (full and empty mbarriers per stage): A's (128, 64) box and
// BN / 64 boxes (64, 64) of B, all with the 128-byte swizzle. A (M, K)
// row-major is K-major for wgmma; B (K, N) row-major, as the probes give it,
// is MN-major, which bf16 allows (the transpose bit). The tensor maps are 3-D
// (inner dim, rows, Z), so the rows past M of a ragged last tile are filled
// with zeros by TMA itself, not taken from the next batch entry, and there is
// no padded copy. Two consumer warpgroups each run wgmma m64nBNk16 on their
// 64 rows; the fp32 accumulators (BN / 2 a thread) stay in registers across K,
// and setmaxnreg moves registers from the producer warpgroup (40) to the
// consumers (232). A consumer keeps one group of products in flight and
// releases a stage when the group that read it has completed. The epilogue
// casts and stores from the registers, the rows past M masked. Tiles are
// handed out in groups of 16 tile rows, so that the blocks in flight share
// their A and B panels in L2.
//
// int8: nvcuda::wmma (mma.sync m16n16k16, int32 accumulators), cp.async
// three stages deep; rows past M are filled with zeros by the copy itself
// (source size 0) and masked in the epilogue. wgmma takes s8 operands only
// K-major and the probes give B (K, N) row-major, so int8 stays here until B
// comes K-major. Each warp owns a (WM, WN) part of the tile as fragments that
// stay in registers across K; the epilogue takes every fragment through a
// 1 KB patch of shared memory per warp and writes 8 contiguous outputs a lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "sm90.cuh"

namespace {

using namespace nvcuda;

constexpr int kStages = 3;  // of the int8 kernel
constexpr int kNumConfigs = 4;
// int8: (BM, BN, BK) and the warp's (WM, WN) part of it
constexpr int kConfigs[kNumConfigs][5] = {
    {64, 64, 32, 32, 32},
    {128, 128, 32, 64, 32},
    {128, 256, 32, 64, 64},
    {256, 128, 64, 64, 64},
};

template <typename T> struct AccOf;
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
__device__ __forceinline__ void store8(int* d, const int* s) {
  *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(s);
  *reinterpret_cast<int4*>(d + 4) = *reinterpret_cast<const int4*>(s + 4);
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

int launch_int8(int config, const void* a, const void* b, void* c, int Z, int M, int N, int K,
                cudaStream_t s) {
  switch (config) {
    case 0: return launch<signed char, int, 64, 64, 32, 32, 32>(a, b, c, Z, M, N, K, s);
    case 1: return launch<signed char, int, 128, 128, 32, 64, 32>(a, b, c, Z, M, N, K, s);
    case 2: return launch<signed char, int, 128, 256, 32, 64, 64>(a, b, c, Z, M, N, K, s);
    case 3: return launch<signed char, int, 256, 128, 64, 64, 64>(a, b, c, Z, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- bf16: wgmma + TMA

namespace wg {

constexpr int kBM = 128, kBK = 64;  // tile rows; K step = one 128-byte swizzle row
constexpr int kConsumers = 2;       // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kGroupM = 16;          // tile rows handed out together
constexpr int kNumConfigs = 3;
constexpr int kBN[kNumConfigs] = {256, 128, 64};

template <int BN> struct Shape {
  static constexpr int kABytes = kBM * kBK * 2;   // one (128, 64) box
  static constexpr int kBBytes = kBK * BN * 2;    // BN / 64 boxes of (64, 64)
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes < 6 ? 200 * 1024 / kStageBytes : 6;
  // + 1 KB to align the ring to the swizzle's 1024 bytes, + the barriers
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
  static_assert(kStages >= 4, "at least four stages in flight");
};

template <int BN>
__device__ __forceinline__ void mma(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) sm90::wgmma_m64n256k16<0, 1>(acc, da, db);
  else if constexpr (BN == 128) sm90::wgmma_m64n128k16<0, 1>(acc, da, db);
  else sm90::wgmma_m64n64k16<0, 1>(acc, da, db);
}

__device__ __forceinline__ void store2(float* d, float x, float y) {
  *reinterpret_cast<float2*>(d) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* d, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(x, y);
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, OutT* __restrict__ c, int M, int N,
                  int K) {
  using S = Shape<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (sm90::smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t bars = base + S::kStages * S::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S::kStages + s); };

  // grouped order: kGroupM tile rows, all their tile columns, then the next rows
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = N / BN;
  const int per_group = kGroupM * tiles_n;
  const int pid = blockIdx.x, first_m = pid / per_group * kGroupM;
  const int rows = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + pid % per_group % rows) * kBM;
  const int n0 = pid % per_group / rows * BN;
  const int z = blockIdx.z, nk = K / kBK;
  const int tid = threadIdx.x, g = tid / 128;  // warpgroup

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::fence_barrier_init();
  } else if (tid == kConsumers * 128) {
    sm90::prefetch_tensormap(&map_a);
    sm90::prefetch_tensormap(&map_b);
  }
  __syncthreads();

  if (g == kConsumers) {  // producer warpgroup: one thread issues every load
    sm90::setmaxnreg_dec<40>();
    if (tid == kConsumers * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S::kStages;
        sm90::mbar_wait(empty(s), ((kt / S::kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full(s), S::kStageBytes);
        const uint32_t sa = base + s * S::kStageBytes;
        sm90::tma_load_3d(sa, &map_a, full(s), kt * kBK, m0, z);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_3d(sa + S::kABytes + j * 8192, &map_b, full(s), n0 + 64 * j, kt * kBK, z);
      }
    }
  } else {  // consumer warpgroup g: rows m0 + 64 g ..
    sm90::setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S::kStages;
      sm90::mbar_wait(full(s), (kt / S::kStages) & 1);
      const uint32_t sa = base + s * S::kStageBytes + g * 64 * 128;  // this warpgroup's rows
      const uint32_t sb = base + s * S::kStageBytes + S::kABytes;
      sm90::fence_operands(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // A: 32 bytes along the swizzled row; B: 16 rows
        mma<BN>(acc, sm90::make_desc(sa + 32 * kk, 16, 1024, sm90::kLayout128B),
                sm90::make_desc(sb + 2048 * kk, 8192, 1024, sm90::kLayout128B));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the products of step kt - 1 are done: release its stage
      sm90::fence_operands(acc);
      if (kt > 0 && tid % 128 == 0) sm90::mbar_arrive(empty((kt - 1) % S::kStages));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);

    const int lane = tid % 32, row0 = m0 + g * 64 + (tid % 128) / 32 * 16 + lane / 4;
    OutT* cz = c + (size_t)z * M * N + n0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M) store2(cz + (size_t)row * N + 2 * i, acc[i + 2 * h], acc[i + 2 * h + 1]);
      }
  }
}

template <int BN, typename OutT>
int launch(const void* a, const void* b, void* c, int Z, int M, int N, int K, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[3] = {(uint64_t)K, (uint64_t)M, (uint64_t)Z};
  const uint64_t strides_a[2] = {2ull * K, 2ull * M * K};
  const uint32_t box_a[3] = {kBK, kBM, 1};
  int err = sm90::encode_bf16(&map_a, 3, a, dims_a, strides_a, box_a, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const uint64_t dims_b[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)Z};
  const uint64_t strides_b[2] = {2ull * N, 2ull * K * N};
  const uint32_t box_b[3] = {64, kBK, 1};
  err = sm90::encode_bf16(&map_b, 3, b, dims_b, strides_b, box_b, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto kernel = gemm_wgmma_kernel<BN, OutT>;
  static const int attr_err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<BN>::kSmemBytes);
  if (attr_err) return attr_err;
  const dim3 grid(((M + kBM - 1) / kBM) * (N / BN), 1, Z);
  kernel<<<grid, kThreads, Shape<BN>::kSmemBytes, s>>>(map_a, map_b, static_cast<OutT*>(c), M, N,
                                                        K);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_config(int config, const void* a, const void* b, void* c, int Z, int M, int N, int K,
                  cudaStream_t s) {
  switch (config) {
    case 0: return launch<256, OutT>(a, b, c, Z, M, N, K, s);
    case 1: return launch<128, OutT>(a, b, c, Z, M, N, K, s);
    case 2: return launch<64, OutT>(a, b, c, Z, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) { return sm90::error_string(err); }

// tile shapes: bf16 (wgmma) when int8 == 0, int8 (mma.sync) otherwise
int scl_probe_gemm_num_configs(int int8) { return int8 ? kNumConfigs : wg::kNumConfigs; }

// what = 0, 1, 2: BM, BN, BK of tile shape `config` of the type's list; 3: its
// dynamic shared memory in bytes; 4: its pipeline stages
int scl_probe_gemm_config(int int8, int config, int what) {
  if (config < 0 || config >= scl_probe_gemm_num_configs(int8) || what < 0 || what > 4) return -1;
  if (int8) {
    constexpr int smem[kNumConfigs] = {
        Tile<signed char, 64, 64, 32>::kSmemBytes, Tile<signed char, 128, 128, 32>::kSmemBytes,
        Tile<signed char, 128, 256, 32>::kSmemBytes, Tile<signed char, 256, 128, 64>::kSmemBytes};
    return what < 3 ? kConfigs[config][what] : what == 3 ? smem[config] : kStages;
  }
  constexpr int smem[wg::kNumConfigs] = {wg::Shape<256>::kSmemBytes, wg::Shape<128>::kSmemBytes,
                                         wg::Shape<64>::kSmemBytes};
  constexpr int stages[wg::kNumConfigs] = {wg::Shape<256>::kStages, wg::Shape<128>::kStages,
                                           wg::Shape<64>::kStages};
  return what == 0 ? wg::kBM : what == 1 ? wg::kBN[config] : what == 2 ? wg::kBK
       : what == 3 ? smem[config] : stages[config];
}

// a (Z, M, K), b (Z, K, N), c (Z, M, N), contiguous on one device. int8 != 0:
// signed 8-bit operands and int32 c; else bf16 operands and c in bf16
// (out_bf16 != 0) or fp32, a and b 16-byte aligned (TMA). N a multiple of the
// tile's BN, K of its BK, any M > 0; the grid within its limits (2^31 blocks
// in x, 65,535 in y and z). Returns the first error: a refused tensor map
// (sm90::kErrTensorMap + CUresult) or cudaGetLastError() of the launch, else 0.
int scl_probe_gemm(const void* a, const void* b, void* c, int Z, int M, int N, int K, int int8,
                   int out_bf16, int config, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) return launch_int8(config, a, b, c, Z, M, N, K, s);
  return out_bf16 ? wg::launch_config<__nv_bfloat16>(config, a, b, c, Z, M, N, K, s)
                  : wg::launch_config<float>(config, a, b, c, Z, M, N, K, s);
}

}  // extern "C"
