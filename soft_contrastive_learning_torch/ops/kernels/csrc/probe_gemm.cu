// Tiled batched matrix product C[z] = A[z] . B[z] for Hopper, sm_90a: the
// hand-written kernels behind the matmul-rate probes.
//
// Replaces the Pallas kernels of the probe scripts under perf/:
// mxu_probe.py (resident_dot, blocked_grid), mxu_probe2.py, mxu_probe3.py and
// mxu_probe4.py (pallas_matmul) and matmul_probe.py (probe). On the TPU they
// are one function, a matrix product, asked at different shapes, types and
// blockings; here they are two kernel templates, both on wgmma fed by TMA,
// with a short list of tile shapes each. A (Z, M, K) and B (Z, K, N)
// row-major, bf16 or int8; C (Z, M, N) row-major, fp32 or bf16 from bf16
// operands (fp32 sums, one rounding at the cast), int32 from int8 operands
// (exact).
//
// Bound on this card: 2 Z M K N operations at the tensor-core rate of the
// type (989 TFLOP/s bf16, 1,979 TOP/s int8, dense) against Z (M K + K N)
// input bytes read once and Z M N output bytes written once at 3.35 TB/s.
// The probes' large problems are operation-bound (8192 x 4096 x 8192: 0.556 ms
// in bf16, 0.278 ms in int8; int8 replaces perf/mxu_probe4.py:42); the
// Winograd product shapes with C = 128 are byte-bound. The int8 kernel this
// one replaced ran mma.sync (nvcuda::wmma) at 14% of its bound: wgmma is the
// only way to the int8 rate.
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
// int8: the same warp-specialized ring and consumers on wgmma m64nBNk32
// .s32.s8.s8 (exact int32 sums). wgmma takes s8 operands only K-major, and
// the probes give B (K, N) row-major, as the JAX probe does: a hand-written
// transpose kernel first writes B into an (N, K) scratch (64 x 64 tiles
// through shared memory, 16 bytes a thread each way; 2 Z K N bytes, 64 MB at
// the probes' 4096 x 8192), inside the same call. A's (128, BK) box and
// B's (BN, BK) box take the 128-byte swizzle at BK = 128 int8 (one swizzle
// row) and the 64-byte one at BK = 64; the epilogue stores the int32 sums from
// the registers, the rows past M masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------- int8: wgmma + TMA

namespace s8 {

constexpr int kBM = 128;        // tile rows: two consumer warpgroups of 64
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kGroupM = 16;     // tile rows handed out together
constexpr int kNumConfigs = 4;
constexpr int kBN[kNumConfigs] = {256, 256, 128, 64};
constexpr int kBK[kNumConfigs] = {128, 64, 128, 64};
constexpr int kTile = 64;       // the transpose's square tile

template <int BN, int BK> struct Shape {
  static constexpr int kABytes = kBM * BK;   // one (128, BK) box
  static constexpr int kBBytes = BN * BK;    // one (BN, BK) box of the transposed B
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes < 6 ? 200 * 1024 / kStageBytes : 6;
  // + 1 KB to align the ring to the swizzle's 1024 bytes, + the barriers
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
  static constexpr uint32_t kLayout = BK == 128 ? sm90::kLayout128B : sm90::kLayout64B;
  static constexpr uint32_t kRowGroup = 8 * BK;  // 8 rows of one swizzle row each
  static_assert(BK == 128 || BK == 64, "one 128- or 64-byte swizzle row of int8");
  static_assert(kStages >= 4, "at least four stages in flight");
};

// bt[z] = b[z]^T: b (Z, K, N) -> bt (Z, N, K), int8, K and N multiples of 64
__global__ void __launch_bounds__(256)
transpose_kernel(const signed char* __restrict__ b, signed char* __restrict__ bt, int K, int N) {
  __shared__ __align__(16) signed char tile[kTile][kTile + 16];
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile, tid = threadIdx.x;
  const size_t z = blockIdx.z;
  const int r = tid >> 2, c = (tid & 3) * 16;  // row and 16-byte column of the tile
  *reinterpret_cast<int4*>(&tile[r][c]) =
      *reinterpret_cast<const int4*>(b + (z * K + k0 + r) * N + n0 + c);
  __syncthreads();
  alignas(16) signed char v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = tile[c + i][r];  // column r, rows c .. c + 15
  *reinterpret_cast<int4*>(bt + (z * N + n0 + r) * K + k0 + c) = *reinterpret_cast<const int4*>(v);
}

template <int BN>
__device__ __forceinline__ void mma(int (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) sm90::wgmma_m64n256k32_s8(acc, da, db);
  else if constexpr (BN == 128) sm90::wgmma_m64n128k32_s8(acc, da, db);
  else sm90::wgmma_m64n64k32_s8(acc, da, db);
}

template <int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_bt, int* __restrict__ c, int M, int N,
               int K) {
  using S = Shape<BN, BK>;
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
  const int z = blockIdx.z, nk = K / BK;
  const int tid = threadIdx.x, g = tid / 128;  // warpgroup

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::fence_barrier_init();
  } else if (tid == kConsumers * 128) {
    sm90::prefetch_tensormap(&map_a);
    sm90::prefetch_tensormap(&map_bt);
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
        sm90::tma_load_3d(sa, &map_a, full(s), kt * BK, m0, z);
        sm90::tma_load_3d(sa + S::kABytes, &map_bt, full(s), kt * BK, n0, z);
      }
    }
  } else {  // consumer warpgroup g: rows m0 + 64 g ..
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

    const int lane = tid % 32, row0 = m0 + g * 64 + (tid % 128) / 32 * 16 + lane / 4;
    int* cz = c + (size_t)z * M * N + n0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M)
          *reinterpret_cast<int2*>(cz + (size_t)row * N + 2 * i) =
              make_int2(acc[i + 2 * h], acc[i + 2 * h + 1]);
      }
  }
}

int transpose(const void* b, void* bt, int Z, int K, int N, cudaStream_t s) {
  transpose_kernel<<<dim3(N / kTile, K / kTile, Z), 256, 0, s>>>(
      static_cast<const signed char*>(b), static_cast<signed char*>(bt), K, N);
  return (int)cudaGetLastError();
}

template <int BN, int BK>
int launch(const void* a, const void* bt, void* c, int Z, int M, int N, int K, cudaStream_t s) {
  using S = Shape<BN, BK>;
  const CUtensorMapSwizzle swizzle =
      BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap map_a, map_bt;
  const uint64_t dims_a[3] = {(uint64_t)K, (uint64_t)M, (uint64_t)Z};
  const uint64_t strides_a[2] = {(uint64_t)K, (uint64_t)M * K};
  const uint32_t box_a[3] = {BK, kBM, 1};
  int err = sm90::encode_s8(&map_a, 3, a, dims_a, strides_a, box_a, swizzle);
  if (err) return err;
  const uint64_t dims_b[3] = {(uint64_t)K, (uint64_t)N, (uint64_t)Z};
  const uint64_t strides_b[2] = {(uint64_t)K, (uint64_t)N * K};
  const uint32_t box_b[3] = {BK, BN, 1};
  err = sm90::encode_s8(&map_bt, 3, bt, dims_b, strides_b, box_b, swizzle);
  if (err) return err;
  auto kernel = gemm_s8_kernel<BN, BK>;
  static const int attr_err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (attr_err) return attr_err;
  const dim3 grid(((M + kBM - 1) / kBM) * (N / BN), 1, Z);
  kernel<<<grid, kThreads, S::kSmemBytes, s>>>(map_a, map_bt, static_cast<int*>(c), M, N, K);
  return (int)cudaGetLastError();
}

// the transpose of b into bt, then the product a . bt^T
int launch_config(int config, const void* a, const void* b, void* bt, void* c, int Z, int M,
                  int N, int K, cudaStream_t s) {
  if (config < 0 || config >= kNumConfigs) return (int)cudaErrorInvalidValue;
  int err = transpose(b, bt, Z, K, N, s);
  if (err) return err;
  switch (config) {
    case 0: return launch<256, 128>(a, bt, c, Z, M, N, K, s);
    case 1: return launch<256, 64>(a, bt, c, Z, M, N, K, s);
    case 2: return launch<128, 128>(a, bt, c, Z, M, N, K, s);
    case 3: return launch<64, 64>(a, bt, c, Z, M, N, K, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace s8

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

// tile shapes: bf16 when int8 == 0, int8 otherwise (both on wgmma)
int scl_probe_gemm_num_configs(int int8) { return int8 ? s8::kNumConfigs : wg::kNumConfigs; }

// what = 0, 1, 2: BM, BN, BK of tile shape `config` of the type's list; 3: its
// dynamic shared memory in bytes; 4: its pipeline stages
int scl_probe_gemm_config(int int8, int config, int what) {
  if (config < 0 || config >= scl_probe_gemm_num_configs(int8) || what < 0 || what > 4) return -1;
  if (int8) {
    constexpr int smem[s8::kNumConfigs] = {
        s8::Shape<256, 128>::kSmemBytes, s8::Shape<256, 64>::kSmemBytes,
        s8::Shape<128, 128>::kSmemBytes, s8::Shape<64, 64>::kSmemBytes};
    constexpr int stages[s8::kNumConfigs] = {
        s8::Shape<256, 128>::kStages, s8::Shape<256, 64>::kStages, s8::Shape<128, 128>::kStages,
        s8::Shape<64, 64>::kStages};
    return what == 0 ? s8::kBM : what == 1 ? s8::kBN[config] : what == 2 ? s8::kBK[config]
         : what == 3 ? smem[config] : stages[config];
  }
  constexpr int smem[wg::kNumConfigs] = {wg::Shape<256>::kSmemBytes, wg::Shape<128>::kSmemBytes,
                                         wg::Shape<64>::kSmemBytes};
  constexpr int stages[wg::kNumConfigs] = {wg::Shape<256>::kStages, wg::Shape<128>::kStages,
                                           wg::Shape<64>::kStages};
  return what == 0 ? wg::kBM : what == 1 ? wg::kBN[config] : what == 2 ? wg::kBK
       : what == 3 ? smem[config] : stages[config];
}

// a (Z, M, K), b (Z, K, N), c (Z, M, N), contiguous on one device, a and b
// 16-byte aligned (TMA). int8 != 0: signed 8-bit operands, int32 c, and
// scratch a (Z, N, K) int8 buffer for B's transpose (both kernels launch);
// else bf16 operands, c in bf16 (out_bf16 != 0) or fp32, and no scratch. N a
// multiple of the tile's BN, K of its BK, any M > 0; the grid within its
// limits (2^31 blocks in x, 65,535 in z). Returns the first error: a refused
// tensor map (sm90::kErrTensorMap + CUresult) or cudaGetLastError() of a
// launch, else 0.
int scl_probe_gemm(const void* a, const void* b, void* c, void* scratch, int Z, int M, int N,
                   int K, int int8, int out_bf16, int config, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) return s8::launch_config(config, a, b, scratch, c, Z, M, N, K, s);
  return out_bf16 ? wg::launch_config<__nv_bfloat16>(config, a, b, c, Z, M, N, K, s)
                  : wg::launch_config<float>(config, a, b, c, Z, M, N, K, s);
}

// The int8 path's transpose alone: b (Z, K, N) int8 -> bt (Z, N, K), K and N
// multiples of 64 (timed apart from the product).
int scl_probe_transpose_s8(const void* b, void* bt, int Z, int K, int N, void* stream) {
  if (K % s8::kTile || N % s8::kTile) return (int)cudaErrorInvalidValue;
  return s8::transpose(b, bt, Z, K, N, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
