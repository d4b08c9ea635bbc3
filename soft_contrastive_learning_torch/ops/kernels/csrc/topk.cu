// Streaming brute-force L2 top-k (K2) for Hopper, sm_90a.
//
// Replaces soft_contrastive_learning_tpu/ops/pallas/topk_kernel.py:41
// (_topk_kernel, called from topk_l2_pallas). For queries q (Q, D) and refs
// r (R, D), both fp32, it returns the k <= 128 nearest refs per query by
// score = 2 q.r - |r|^2 (a monotone transform of -|q - r|^2), ties to the
// smallest ref id, as distances sqrt(max(|q|^2 - score, 0)) with int64 ids,
// padded with (inf, -1) when R < k.
//
// Bound on this card, at the serving shape (Q = 64, R = 66,048, D = 32,768):
// the bytes. The refs are read once, 4 (R D + Q D) + 12 Q k bytes = 8.665 GB,
// 2.587 ms at 3.35 TB/s; the three TF32 products, 3 x 2 Q R D = 831 GFLOP,
// take 1.679 ms at 495 TFLOP/s. (The kernel this one replaced multiplied in
// fp32 FMA on the CUDA cores, where 2 Q R D at 67 TFLOP/s set its bound at
// 4.199 ms: 32 FLOP per ref byte at Q = 64 is above that rate's ridge.)
//
// Precision: 3xTF32 on the tensor cores, as the TPU kernel's
// Precision.HIGHEST is a multi-pass bf16 split. x_hi is x with its low 13
// mantissa bits zeroed; x_lo = x - x_hi (exact in fp32), rounded to the
// nearest tf32 value; both by explicit bit operations, so no operand leans on
// the tensor cores dropping bits. q.r ~ q_hi.r_hi + q_hi.r_lo + q_lo.r_hi,
// all three into one fp32 accumulator. Multiples of 1/8 have x_lo = 0 and
// exact products, so on them the scores equal the plain version's bit for
// bit. topk_l2_3xtf32_plain (ops/kernels/topk.py) emulates the split.
//
// Design, three launches a call:
//   split: q -> a (2, Q, D) scratch of q_hi and q_lo, once a call; it stays
//     in L2 (8 MB at Q = 64).
//   partial: persistent blocks, in clusters of 2, one block per SM. A block
//     owns 64 queries (grid y) and walks its own run of 128-row ref tiles: the
//     two blocks of a cluster take the even and odd tiles of the cluster's run
//     of tile pairs, in step. D streams through a ring of 4-5 stages of 32
//     fp32 (one 128-byte swizzle row): per stage TMA loads the block's (128,
//     32) ref box and the query tile's q_hi and q_lo (64, 32) boxes, each of
//     those loaded by one block of the cluster and multicast to both, so a
//     query byte leaves L2 once per cluster. One producer thread keeps the
//     loads in flight; two consumer warpgroups own 64 ref rows each, and
//     setmaxnreg moves registers from the producer warpgroup (40) to them
//     (232), as in probe_gemm.cu's bf16 kernel (on an H100 at Q = 64: 3.1 ms
//     against 3.7 without; ptxas then gives the kernel 168 registers, not
//     135, and spills none). A consumer reads its fp32 ref fragment from
//     shared memory into registers, splits it there, adds its squares into
//     |r|^2 (fp32 FMA), and issues wgmma m64n64k8 tf32 with A = r_hi or r_lo
//     from registers and B = q_hi or q_lo from shared memory: 12 products a
//     stage into 32 fp32 accumulators a thread. Every 4 stages the products'
//     sum is added into an fp32 total in registers, rounded to nearest, and
//     the accumulators start again from zero: an accumulator kept by the
//     tensor cores over all of D (whose fp32 adds do not round to nearest)
//     drifted by up to 1e-3 in the served queries' squared distances. The A
//     fragments are split and issued by half stages into two register
//     buffers, so one half's split runs while the other half's products are
//     in flight; a stage returns to the producers of both blocks once the
//     products that read it are done. Shared-memory traffic a stage and
//     block: 32 KB written by TMA, 16 KB read for the ref fragments, 48 KB
//     read by wgmma for B (q_hi twice and q_lo once per warpgroup). The split
//     writes nothing back: splitting R into hi/lo tiles in shared memory
//     would have added 32 KB of stores and 16 KB of reads a stage.
//     After a tile, the scores 2 q.r - |r|^2 go to shared memory, and each
//     consumer warp merges them into the running best-p lists of its 8
//     queries, as the TPU kernel carries best_d / best_i across its grid
//     steps: when any of the tile's 128 candidates beats a list's p-th entry,
//     the warp sorts the candidates by a bitonic network (4 a lane), keeps the
//     better of list entry i and candidate 127 - i, and sorts that bitonic
//     sequence; the order is (score descending, id ascending), so ties go to
//     the smallest id. Each block writes its lists to a (Q, lists, p) scratch.
//   merge: one block per query, a p-round tournament over the heads of the
//     <= 132 sorted lists with the same tie rule, then the distances.
// The (Q, R) score matrix never leaves the chip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBR = 128;     // refs per tile: two consumer warpgroups of 64 rows
constexpr int kNQ = 64;      // queries per block: the n of wgmma
constexpr int kBK = 32;      // fp32 columns per stage: one 128-byte swizzle row
constexpr int kCluster = 2;  // blocks sharing the query loads (q_hi from one, q_lo from the other)
constexpr int kConsumers = 2;
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kRefBytes = kBR * kBK * 4;  // 16 KB
constexpr int kQBytes = kNQ * kBK * 4;    // 8 KB, each of q_hi and q_lo
constexpr int kStageBytes = kRefBytes + 2 * kQBytes;
constexpr int kScoreLd = kBR + 4;  // a query's row of scores, padded
constexpr int kScoreBytes = kNQ * kScoreLd * 4;  // one tile's scores, (query, ref)
constexpr int kMaxStages = 5, kMinStages = 3;
// stages whose products the tensor cores sum before their sum joins the
// fp32 total (the tensor cores' own adds do not round to nearest)
constexpr int kDrain = 4;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory one Hopper block may use
constexpr int kMergeThreads = 128;
constexpr int kInvalidId = 0x7fffffff;
constexpr uint32_t kHiMask = 0xffffe000u;  // sign, exponent and the top 10 mantissa bits
static_assert(kCluster == 2, "one block of the pair loads q_hi, the other q_lo");

__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// the running lists: per query, p scores and ids in whole warps' worth of
// slots (the rest stay sentinels), query-major
__host__ __device__ inline int list_slots(int p) { return (p + 31) / 32 * 32; }
__host__ __device__ inline size_t list_bytes(int p) { return (size_t)list_slots(p) * kNQ * 8; }

size_t partial_smem(int stages, int p) {
  // + 1 KB to align the ring to the swizzle's 1024 bytes, + the barriers
  return 1024 + (size_t)stages * kStageBytes + kScoreBytes + list_bytes(p) + 16 * stages;
}

int ring_stages(int p) {
  int stages = kMaxStages;
  while (stages > kMinStages && partial_smem(stages, p) > kSmemLimit) --stages;
  return stages;
}

__device__ __forceinline__ uint32_t tf32_hi(float x) { return __float_as_uint(x) & kHiMask; }

// x - hi is exact; its nearest tf32 value (half away from zero: the carry of
// the added half-unit runs into the exponent where it must)
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & kHiMask;
}

// Bitonic networks over 128 (score, id) pairs held by a warp, 4 a lane:
// element e of lane l is number 32 e + l; `better` orders them (score
// descending, id ascending), and a block of `size` elements runs descending
// where its index has bit `size` clear. Partners 32 or 64 apart sit in the
// same lane; nearer ones are a shuffle away.
__device__ __forceinline__ void exchange(float (&s)[4], int (&id)[4], int j, int size, int lane) {
  if (j >= 32) {
    const int jr = j >> 5;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e & jr) continue;  // e is the lower of the pair (e, e | jr)
      const int f = e | jr;
      const bool desc = ((32 * e + lane) & size) == 0;
      if (better(s[f], id[f], s[e], id[e]) == desc) {
        const float ts = s[e]; s[e] = s[f]; s[f] = ts;
        const int ti = id[e]; id[e] = id[f]; id[f] = ti;
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float os = __shfl_xor_sync(0xffffffffu, s[e], j);
    const int oi = __shfl_xor_sync(0xffffffffu, id[e], j);
    const int i = 32 * e + lane;
    const bool keep_better = ((i & j) == 0) == ((i & size) == 0);
    if (keep_better != better(s[e], id[e], os, oi)) { s[e] = os; id[e] = oi; }
  }
}

__device__ __forceinline__ void bitonic_sort(float (&s)[4], int (&id)[4], int lane) {
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) exchange(s, id, j, size, lane);
}

// a bitonic sequence of 128 into descending order
__device__ __forceinline__ void bitonic_merge(float (&s)[4], int (&id)[4], int lane) {
#pragma unroll
  for (int j = 64; j > 0; j >>= 1) exchange(s, id, j, 128, lane);
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__global__ void __launch_bounds__(256)
split_queries_kernel(const float4* __restrict__ q, uint4* __restrict__ out, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = q[i];
    uint4 hi, lo;
    hi.x = tf32_hi(v.x); lo.x = tf32_lo(v.x, hi.x);
    hi.y = tf32_hi(v.y); lo.y = tf32_lo(v.y, hi.y);
    hi.z = tf32_hi(v.z); lo.z = tf32_lo(v.z, hi.z);
    hi.w = tf32_hi(v.w); lo.w = tf32_lo(v.w, hi.w);
    out[i] = hi;
    out[n4 + i] = lo;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
topk_partial_kernel(const __grid_constant__ CUtensorMap map_r,
                    const __grid_constant__ CUtensorMap map_q, float* __restrict__ part_s,
                    int* __restrict__ part_i, int Q, int R, int D, int p, int n_tiles,
                    int n_pairs, int stages) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = sm90::smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  unsigned char* gbase = smem + (base - raw);    // the same byte, as a generic pointer
  float* sc = reinterpret_cast<float*>(gbase + (size_t)stages * kStageBytes);  // (kNQ, kScoreLd)
  float* ls = sc + kNQ * kScoreLd;                                  // (kNQ, slots) scores
  int* li = reinterpret_cast<int*>(ls + (size_t)list_slots(p) * kNQ);  // (kNQ, slots) ids
  const uint32_t bars = base + stages * kStageBytes + kScoreBytes + (uint32_t)list_bytes(p);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };

  const uint32_t rank = sm90::cluster_ctarank();
  const int cluster = blockIdx.x / kCluster, n_clusters = gridDim.x / kCluster;
  const int pair0 = (int)((long long)cluster * n_pairs / n_clusters);
  const int pair1 = (int)((long long)(cluster + 1) * n_pairs / n_clusters);
  const int q0 = blockIdx.y * kNQ;
  const int nk = (D + kBK - 1) / kBK;  // a ragged last stage is zero-filled by TMA
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers * kCluster);  // every consumer of the cluster
    }
    sm90::fence_barrier_init();
  } else if (tid == 128 * kConsumers) {
    sm90::prefetch_tensormap(&map_r);
    sm90::prefetch_tensormap(&map_q);
  }
  sm90::cluster_sync();  // all barriers of the cluster are ready before any load or arrival

  if (tid >= 128 * kConsumers) {  // the producer warpgroup; one thread issues every load
    sm90::setmaxnreg_dec<40>();
    if (tid == 128 * kConsumers) {
      const uint16_t mask = (uint16_t)((1u << kCluster) - 1u);
      int it = 0;
      for (int pair = pair0; pair < pair1; ++pair) {
        const int tile = kCluster * pair + (int)rank;
        // past the last tile (odd n_tiles): the neighbour's rows again, never selected
        const int row0 = (tile < n_tiles ? tile : tile - 1) * kBR;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % stages;
          sm90::mbar_wait(empty(s), ((it / stages) & 1) ^ 1);  // released in both blocks
          sm90::mbar_arrive_expect_tx(full(s), kStageBytes);
          const uint32_t st = base + s * kStageBytes;
          sm90::tma_load_2d(st, &map_r, full(s), kt * kBK, row0);
          sm90::tma_load_3d_multicast(st + kRefBytes + rank * kQBytes, &map_q, full(s), mask,
                                      kt * kBK, q0, (int)rank);
        }
      }
    }
    __syncwarp();
  } else {
    sm90::setmaxnreg_inc<232>();
    const int warp = tid >> 5, lane = tid & 31;  // consumer warps 0 .. 7
    // this thread's rows of the A fragments: row and row + 8 of the ref tile
    const int row = 64 * (tid >> 7) + 16 * (warp & 3) + (lane >> 2);
    const uint32_t row_off = row * 128 + (lane & 3) * 4;
    const int slots = list_slots(p);
    float acc[32];  // the products of the current run of kDrain stages (wgmma)
    float tot[32];  // their sums over D, rounded to nearest
    // A fragments of half a stage (k8 steps 2 h, 2 h + 1): r_hi, r_lo, two buffers
    uint32_t ah0[8], al0[8], ah1[8], al1[8];
    float rs0 = 0.f, rs1 = 0.f;  // |r|^2 of row and row + 8, partial
    int it = 0;

    for (int i = tid; i < kNQ * slots; i += 128 * kConsumers) {
      ls[i] = -INFINITY;
      li[i] = kInvalidId;
    }

    // A fragment e = 4 kk' + 2 j + h of k8 step kk = 2 half + kk': row + 8 h,
    // column 8 kk + 4 j + lane % 4
    auto load = [&](uint32_t st, int half, uint32_t (&ah)[8], uint32_t (&al)[8]) {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kk = 2 * half + k2;
            const float x =
                lds_f32(st + row_off + h * 1024 + ((((2 * kk + j) ^ (lane >> 2)) & 7) << 4));
            const int e = 4 * k2 + 2 * j + h;
            ah[e] = tf32_hi(x);
            al[e] = tf32_lo(x, ah[e]);
            if (h) rs1 = fmaf(x, x, rs1);
            else rs0 = fmaf(x, x, rs0);
          }
    };
    auto issue = [&](uint32_t st, int half, const uint32_t (&ah)[8], const uint32_t (&al)[8]) {
      const uint32_t qh = st + kRefBytes, ql = qh + kQBytes;
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int kk = 2 * half + k2, e = 4 * k2;
        const uint64_t dh = sm90::make_desc(qh + 32 * kk, 16, 1024, sm90::kLayout128B);
        const uint64_t dl = sm90::make_desc(ql + 32 * kk, 16, 1024, sm90::kLayout128B);
        sm90::wgmma_m64n64k8_tf32_rs(acc, ah[e], ah[e + 1], ah[e + 2], ah[e + 3], dh);
        sm90::wgmma_m64n64k8_tf32_rs(acc, al[e], al[e + 1], al[e + 2], al[e + 3], dh);
        sm90::wgmma_m64n64k8_tf32_rs(acc, ah[e], ah[e + 1], ah[e + 2], ah[e + 3], dl);
      }
      sm90::wgmma_commit();
    };
    // every issued product but the last half stage's is done: the buffer it
    // read may be written again
    auto settle = [&]() {
      sm90::wgmma_wait<1>();
      sm90::fence_operands(acc);
      sm90::fence_operands(ah0);
      sm90::fence_operands(al0);
      sm90::fence_operands(ah1);
      sm90::fence_operands(al1);
    };
    auto release = [&](int stage_it) {
      if ((tid & 127) == 0)
        for (int c = 0; c < kCluster; ++c) sm90::mbar_arrive_cluster(empty(stage_it % stages), c);
    };
    // all issued products are done: their sums go into the total
    auto drain = [&]() {
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        tot[i] += acc[i];
        acc[i] = 0.f;
      }
    };

    for (int pair = pair0; pair < pair1; ++pair) {
      const int tile = kCluster * pair + (int)rank;
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] = acc[i] = 0.f;
      rs0 = rs1 = 0.f;
#pragma unroll 1
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % stages;
        const uint32_t st = base + s * kStageBytes;
        sm90::mbar_wait(full(s), (it / stages) & 1);  // the previous products ran meanwhile
        if (kt > 0 && kt % kDrain == 0) drain();
        load(st, 0, ah0, al0);  // its last reader, half 0 of the previous stage, is done
        sm90::wgmma_fence();
        issue(st, 0, ah0, al0);
        settle();  // the previous stage's products are done: it goes back to the producers
        if (kt > 0) release(it - 1);
        load(st, 1, ah1, al1);
        sm90::wgmma_fence();
        issue(st, 1, ah1, al1);
        settle();
      }
      drain();
      release(it - 1);
      // |r|^2 over the four lanes that share the rows, then the scores,
      // query-major (132-float rows: the stores and the selection's loads
      // meet no bank twice)
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        sc[col * kScoreLd + row + 8 * h] = 2.0f * tot[i] - (h ? rs1 : rs0);
      }
      sm90::named_barrier_sync(1, 128 * kConsumers);

      // each warp merges the tile into the lists of queries warp, warp + 8, ..
      if (tile < n_tiles) {
        const int id0 = tile * kBR, n = min(kBR, R - id0);
        for (int q = warp; q < kNQ && q0 + q < Q; q += kConsumerWarps) {
          float* lq = ls + q * slots;
          int* iq = li + q * slots;
          const float ts = lq[p - 1];  // the list's p-th entry: a sentinel until it is full
          const int ti = iq[p - 1];
          float cs[4];
          int ci[4];
          bool any = false;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 32 * e + lane;
            cs[e] = j < n ? sc[q * kScoreLd + j] : -INFINITY;
            ci[e] = j < n ? id0 + j : kInvalidId;
            any |= j < n && better(cs[e], ci[e], ts, ti);
          }
          if (!__any_sync(0xffffffffu, any)) continue;  // nothing beats the p-th best
          bitonic_sort(cs, ci, lane);
          float bs[4];
          int bi[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 32 * e + lane;
            bs[e] = j < slots ? lq[j] : -INFINITY;
            bi[e] = j < slots ? iq[j] : kInvalidId;
          }
          // the best 128 of both sorted lists: element i against the
          // candidates' 127 - i (lane 31 - l, element 3 - e), a bitonic sequence
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float os = __shfl_xor_sync(0xffffffffu, cs[3 - e], 31);
            const int oi = __shfl_xor_sync(0xffffffffu, ci[3 - e], 31);
            if (better(os, oi, bs[e], bi[e])) { bs[e] = os; bi[e] = oi; }
          }
          bitonic_merge(bs, bi, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 32 * e + lane;
            if (j < p) { lq[j] = bs[e]; iq[j] = bi[e]; }
          }
          __syncwarp();
        }
      }
      sm90::named_barrier_sync(1, 128 * kConsumers);  // the scores' room is free again
    }

    for (int q = warp; q < kNQ && q0 + q < Q; q += kConsumerWarps) {
      const size_t off = ((size_t)(q0 + q) * gridDim.x + blockIdx.x) * p;
      for (int j = lane; j < p; j += 32) {
        part_s[off + j] = ls[q * slots + j];
        part_i[off + j] = li[q * slots + j];
      }
    }
  }
  sm90::cluster_sync();  // no block leaves while the other may still load or arrive into it
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

cudaLaunchConfig_t partial_config(int p, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = partial_smem(ring_stages(p), p);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

extern "C" {

const char* scl_cuda_error_string(int err) { return sm90::error_string(err); }

// Refs per tile of the partial kernel.
int scl_topk_tile_rows(void) { return kBR; }

// The partial kernel's ring stages and dynamic shared memory for lists of p
// entries.
int scl_topk_stages(int p) { return ring_stages(p); }
size_t scl_topk_smem_bytes(int p) { return partial_smem(ring_stages(p), p); }

// The partial lists a call on Q queries and R refs with lists of p = min(k,
// R) entries makes per query: 2 blocks a cluster, as many clusters per
// 64-query tile as fit on the card at once (cudaOccupancyMaxActiveClusters,
// shared by the query tiles), at most one per pair of ref tiles. A negative
// value is a cudaError_t.
int scl_topk_num_lists(int Q, int R, int p) {
  if (Q <= 0 || R <= 0 || p <= 0 || partial_smem(ring_stages(p), p) > kSmemLimit)
    return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config = partial_config(p, attr);
  config.gridDim = dim3(kCluster, 1);
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)config.dynamicSmemBytes);
  if (err != cudaSuccess) return -(int)err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, topk_partial_kernel, &config);
  if (err != cudaSuccess) return -(int)err;
  const int n_tiles = (R + kBR - 1) / kBR, n_pairs = (n_tiles + kCluster - 1) / kCluster;
  const int q_tiles = (Q + kNQ - 1) / kNQ;
  int clusters = active / q_tiles;
  if (clusters < 1) clusters = 1;
  if (clusters > n_pairs) clusters = n_pairs;
  return kCluster * clusters;
}

// q (Q, D) fp32, r (R, D) fp32, contiguous and 16-byte aligned, D % 4 == 0,
// 1 <= p = min(k, R); q_split: (2, Q, D) fp32 scratch; part_s / part_i: (Q,
// n_lists, p) scratch with n_lists = scl_topk_num_lists(Q, R, p). out_d (Q,
// k) fp32 and out_i (Q, k) int64 receive the ascending distances and ids.
// Launches the three kernels on `stream`; returns the first error (a refused
// tensor map: sm90::kErrTensorMap + CUresult; else a cudaError_t), or 0.
int scl_topk_l2(const void* q, void* q_split, const void* r, void* part_s, void* part_i,
                void* out_d, void* out_i, int Q, int R, int D, int k, int p, int n_lists,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_lists < kCluster || n_lists % kCluster) return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)Q * D / 4;
  const int split_blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  split_queries_kernel<<<split_blocks, 256, 0, s>>>(static_cast<const float4*>(q),
                                                    static_cast<uint4*>(q_split), n4);
  cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  CUtensorMap map_r, map_q;
  const uint64_t dims_r[2] = {(uint64_t)D, (uint64_t)R};
  const uint64_t strides_r[1] = {4ull * D};
  const uint32_t box_r[2] = {kBK, kBR};
  int err = sm90::encode_f32(&map_r, 2, r, dims_r, strides_r, box_r, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const uint64_t dims_q[3] = {(uint64_t)D, (uint64_t)Q, 2};
  const uint64_t strides_q[2] = {4ull * D, 4ull * Q * D};
  const uint32_t box_q[3] = {kBK, kNQ, 1};
  err = sm90::encode_f32(&map_q, 3, q_split, dims_q, strides_q, box_q, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;

  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config = partial_config(p, attr);
  config.gridDim = dim3(n_lists, (Q + kNQ - 1) / kNQ);
  config.stream = s;
  cerr = cudaFuncSetAttribute(topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)config.dynamicSmemBytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_tiles = (R + kBR - 1) / kBR, n_pairs = (n_tiles + kCluster - 1) / kCluster;
  cerr = cudaLaunchKernelEx(&config, topk_partial_kernel, map_r, map_q, static_cast<float*>(part_s),
                            static_cast<int*>(part_i), Q, R, D, p, n_tiles, n_pairs,
                            ring_stages(p));
  if (cerr != cudaSuccess) return (int)cerr;
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return (int)cerr;

  const size_t smem2 = (size_t)n_lists * sizeof(int);
  cerr = cudaFuncSetAttribute(topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem2);
  if (cerr != cudaSuccess) return (int)cerr;
  topk_merge_kernel<<<Q, kMergeThreads, smem2, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(part_s),
      static_cast<const int*>(part_i), static_cast<float*>(out_d),
      static_cast<long long*>(out_i), D, n_lists, p, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
