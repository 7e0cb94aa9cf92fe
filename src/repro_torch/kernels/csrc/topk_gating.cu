// Router gating and GShard priority positions for Hopper (sm_90a).
//
// topk_gating replaces src/repro/kernels/topk_gating.py::topk_gating_fused
// (_fused_kernel / _softmax_topk): logits = x @ router with fp32 sums,
// rounded to x's type (bf16, the only type taken here), softmax in fp32,
// iterated first-max top-k (strict '>', the lowest index on ties, a taken
// expert masked to -1), weights renormalised by max(sum, 1e-9).
//
// Bound on the card: bytes.  The product is a skinny GEMM [T, D] x [D, E]
// at E operations a byte of x, far below the tensor cores' ~295, so the
// kernel has to stream x (T*D*2 bytes) at the memory's rate; the [D, E]
// router is small and stays in L2.  Design:
//   * one block a 64-row token tile, so 8192 tokens give 128 blocks: one
//     wave on 132 SMs.  A block is one consumer warpgroup (the products
//     and the epilogue) and one producer warp.  One SM takes in x at only
//     ~33 GB/s here (Mixtral's router at 2048 tokens: 25.2 MB of x over
//     32 tiles in 0.0236 ms, chip_smoke.py phase 1), so where the tiles
//     leave half the SMs idle and D is deep (2048 tokens at d 5120-6144:
//     32 tiles of 80-96 steps), 2-8 CTAs of a thread-block cluster split
//     a tile's k steps, and rank 0 adds the others' accumulators, in rank
//     order, from distributed shared memory before its epilogue (that
//     case: 0.0236 -> 0.0185 ms);
//   * x streams through a ring of [64 rows, 64 k] bf16 stages, loaded by
//     TMA with the 128-byte swizzle (grouped_matmul's K-major A operand);
//     the producer keeps up to kStages stages in flight (prefetching both
//     tensor maps first) and refills a stage once each consumer warp has
//     arrived on its empty barrier; one group of products stays in flight
//     behind the next stage's wait, and the consumers' loop holds no
//     branch but the arrive (a thread-0 refill inside it made ptxas
//     insert a wait for every group, its C7517 note);
//   * each stage also holds the router's [64 k, N] slice, N-major (the
//     router's own row-major layout), zero-padded to N = E rounded up to
//     16, 32, 64, 128 or 256, with the swizzle spanning a row of the slice
//     (32 or 64 bytes below N = 64; 128 bytes in 64-column blocks from
//     there): by TMA where a router row is a multiple of 16 bytes (E % 8
//     == 0; the columns past E and the rows past D load as zeros), else
//     staged by the threads (E not a multiple of 8, such as 2 or 4
//     experts) over a slice zeroed once;
//   * the product is wgmma m64nNk16, B through the transpose bit, as flash
//     attention's V and grouped_matmul's N-major B.  mma.sync would do as
//     well at this intensity (neither route nears the tensor cores'
//     limit); wgmma reads both operands straight from the TMA-swizzled
//     stages, with no ldmatrix and no register staging.  N follows E
//     closely, not 64 and up: a first version that padded E = 16 to 64
//     (four times the products and the epilogue, at one warp a scheduler)
//     took 0.0130 ms at the training shape, this one 0.0065;
//   * the epilogue runs on the accumulator: row r's N logits lie across
//     the four threads of a quad (N/4 each), so the bf16 rounding, the
//     max, exp and the sum are quad shuffles (exp and the division by the
//     sum on the special function unit: __expf, one reciprocal a row;
//     within ~1e-6 of the reference, and equal logits give equal
//     probabilities, so ties stay ties), each thread writes its
//     probabilities as float2, and the top-k is k rounds of a quad
//     arg-max on (value, lower index), the taken column set to -1.  The
//     padded columns enter as -inf and are never picked, even where every
//     remaining real probability has underflowed to 0.  Rows past T (TMA
//     zero-fills them) are never stored.
//
// topk_positions replaces topk_gating.py::topk_positions (_pos_kernel): the
// choice-major rank of each (token, choice) within its expert.  The TPU
// kernel carries per-expert counters across a sequential grid; blocks have
// no order on Hopper, so one block walks the T*k entries in chunks of 1024:
// __match_any_sync ranks equal experts inside a warp, a per-warp count table
// in shared memory is scanned over the 32 warps in order, and the running
// per-expert base carries to the next chunk.  No atomics, so the result is
// deterministic.  Bound: bytes (T*k*4 in, T*k*4 out) and launch latency.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxE = 256;     // router columns one product holds
constexpr int kMaxK = 4;       // choices: one a thread of a quad
constexpr int kBM = 64;        // token rows a block: wgmma's M
constexpr int kBK = 64;        // k a stage: one 128-byte swizzled row of x
constexpr int kConsumers = 128;  // one warpgroup: the products, the epilogue
constexpr int kThreads = 160;    // + one producer warp: the TMA loads
constexpr int kXStage = kBM * kBK * 2;     // 8 KB of x a stage
constexpr int kRBlock = 8192;   // kBK x 64 router columns x 2 bytes
static_assert(kRBlock == kBK * 64 * 2, "a router column block");
constexpr int kRingMax = 204800;           // the ring's shared memory
constexpr int kMaxSplits = 8;    // CTAs of a cluster that split a tile's k
constexpr int kMinSplitSteps = 16;   // k steps each of them keeps at least
constexpr int kPosThreads = 1024;
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kPosMaxE = 256;

using bf16 = __nv_bfloat16;

// the router slice of one stage at width N: 64 k rows of RB = min(N, 64)
// * 2 bytes along n, swizzled over RB (the 32-, 64- or 128-byte mode: 16
// bytes XORed with address bits [7, 7 + log2(RB / 16))), in 64-column
// blocks kRBlock apart for N > 64.  Its TMA box is {N or 64, 64}.
template <int N>
struct Slice {
  static constexpr int kRow = (N < 64 ? N : 64) * 2;    // RB
  static constexpr int kBytes = N < 64 ? kBK * kRow : N / 64 * kRBlock;
  // wgmma descriptor: layout type (3: 32-byte, 2: 64-byte, 1: 128-byte
  // swizzle), the 8-row group stride along k (SBO) and the 64-column
  // block stride (LBO, read only for N > 64)
  static constexpr uint64_t kMode = kRow == 32 ? 3 : kRow == 64 ? 2 : 1;
  static constexpr uint32_t kSbo = 8 * kRow;
  static constexpr uint32_t kLbo = kRBlock;
};

// the ring of one router width N: stages of x's 8 KB and the router slice,
// as many (at most 16) as fit in kRingMax, each on a 1024-byte boundary
template <int N>
struct Ring {
  static constexpr int kR = Slice<N>::kBytes;
  static constexpr int kStage = kXStage + kR;
  static constexpr int kStages =
      kRingMax / kStage < 16 ? kRingMax / kStage : 16;
  // + 1024 to align the ring, + the stages' full and empty mbarriers
  static constexpr int kSmem = kStages * kStage + 1024 + kStages * 16;
  static_assert(kStage % 1024 == 0, "stages on 1024-byte boundaries");
};

// byte offset of element (k, n) of a stage's router slice
template <int N>
__device__ __forceinline__ int router_off(int k, int n) {
  constexpr int kRow = Slice<N>::kRow;
  const int o = k * kRow + (n & 63) * 2;
  return (n >> 6) * kRBlock + (o ^ (((o >> 7) & (kRow / 16 - 1)) << 4));
}

// the N-major router slice's descriptor at k row 16 kk
template <int N>
__device__ __forceinline__ uint64_t router_desc(uint32_t addr, int kk) {
  using S = Slice<N>;
  return (uint64_t)(((addr + kk * 16 * S::kRow) & 0x3FFFF) >> 4) |
         ((uint64_t)(S::kLbo >> 4) << 16) | ((uint64_t)(S::kSbo >> 4) << 32) |
         (S::kMode << 62);
}

// d[64 x 16] += a[64 x 16] (K-major) . b[16 x 16] (N-major), bf16
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : R8(0)
      : "l"(da), "l"(db), "r"(1));
}
// the same at n32: d[64 x 32]
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : R8(0), R8(8)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x N] += a[64 x 16] (K-major) . b[16 x N] (N-major), bf16
template <int N>
__device__ __forceinline__ void gate_mma(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 16)
    wgmma_n16(d, da, db);
  else if constexpr (N == 32)
    wgmma_n32(d, da, db);
  else if constexpr (N == 256)
    wgmma_bf16_n256<0, 1>(d, da, db);
  else
    wgmma_ss<0, 1>(d, da, db, 1);
}

// every thread of the block's cluster has arrived (release / acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the float at the same shared-memory offset as `p` in CTA `rank` of the
// cluster
__device__ __forceinline__ float ld_peer(const float* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

// blockIdx.x = tile * splits + rank: the `splits` CTAs of a cluster share
// a 64-row tile and take the k steps [rank S / splits, (rank + 1) S /
// splits) of D's S; the others' sums reach rank 0 through distributed
// shared memory, added in rank order, and rank 0 runs the epilogue
template <int N, bool TMA_ROUTER>
__global__ void __launch_bounds__(kThreads, 1)
gating_kernel(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tr,
              const bf16* __restrict__ router, int n_tok, int d, int e,
              int k, int splits, int32_t* __restrict__ idx_out,
              float* __restrict__ w_out, float* __restrict__ probs_out) {
  using R = Ring<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kStages * R::kStage);
  uint64_t* empty = full + R::kStages;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index, broadcast so that ptxas sees the branch around the
  // products as warp-uniform (else it serializes them)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int rank = blockIdx.x % splits;
  const int m0 = blockIdx.x / splits * kBM;
  const int steps = (d + kBK - 1) / kBK;
  const int kb0 = rank * steps / splits;
  const int nk = (rank + 1) * steps / splits - kb0;   // this CTA's k steps

  if (!TMA_ROUTER) {
    // the columns past E (and rows past D) of every stage stay zero: the
    // consumers write only the real columns below
    for (int s = 0; s < R::kStages; ++s)
      for (int o = tid * 16; o < R::kR; o += kThreads * 16)
        *reinterpret_cast<uint4*>(smem + s * R::kStage + kXStage + o) =
            make_uint4(0, 0, 0, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc[N / 2];
  if (warp == kConsumers / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];"
                   :: "l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      if (TMA_ROUTER)
        asm volatile("prefetch.tensormap [%0];"
                     :: "l"(reinterpret_cast<uint64_t>(&tr)) : "memory");
      for (int i = 0; i < nk; ++i) {
        const int s = i % R::kStages;
        if (i >= R::kStages)
          mbar_wait(&empty[s], ((i / R::kStages) - 1) & 1);
        uint8_t* xs = smem + s * R::kStage;
        const int k0 = (kb0 + i) * kBK;
        mbar_expect_tx(&full[s], TMA_ROUTER ? R::kStage : kXStage);
        tma_load(xs, &tx, &full[s], k0, m0, 0);
        if (TMA_ROUTER) {
#pragma unroll
          for (int j = 0; j < (N + 63) / 64; ++j)
            tma_load(xs + kXStage + j * kRBlock, &tr, &full[s], 64 * j, k0,
                     0);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % R::kStages;
      uint8_t* xs = smem + s * R::kStage;
      if (!TMA_ROUTER) {
        // stage s was last read by step kb - kStages: every warp has waited
        // for its products of step kb - 2 or later
        consumer_bar(0);
        const int k0 = (kb0 + kb) * kBK;
        for (int i = tid; i < kBK * e; i += kConsumers) {
          const int kr = i / e, n = i - kr * e;
          *reinterpret_cast<bf16*>(xs + kXStage + router_off<N>(kr, n)) =
              k0 + kr < d ? router[(size_t)(k0 + kr) * e + n]
                          : __float2bfloat16(0.f);
        }
        fence_proxy_async();   // the writes, to wgmma's proxy
        consumer_bar(0);
      }
      mbar_wait(&full[s], (kb / R::kStages) & 1);
      const uint32_t a = smem_u32(xs), b = smem_u32(xs + kXStage);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        gate_mma<N>(acc, sw128_desc(a + kk * 32, 16, 1024),
                    router_desc<N>(b, kk));
      wgmma_commit();
      wgmma_wait<1>();         // step kb - 1's products are done
      fence_regs(acc);
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(kb - 1) % R::kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  if constexpr (N <= 128) {   // (at N 256 the registers allow no split)
    if (splits > 1) {
      // the ring is drained (each consumer warp waited for its products,
      // the producer issued nothing unconsumed): ranks 1.. leave their
      // sums at its start, register i of thread t at float i * 128 + t
      float* red = reinterpret_cast<float*>(smem);
      if (tid < kConsumers) consumer_bar(0);   // no product reads the ring
      if (rank > 0 && tid < kConsumers) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) red[i * kConsumers + tid] = acc[i];
      }
      __syncwarp();
      cluster_sync();
      if (rank == 0 && tid < kConsumers) {
        for (int r = 1; r < splits; ++r)
#pragma unroll
          for (int i = 0; i < N / 2; ++i)
            acc[i] = __fadd_rn(acc[i],
                               ld_peer(&red[i * kConsumers + tid], r));
      }
      cluster_sync();  // the peers' shared memory stays until it is read
    }
  }
  if (rank > 0 || tid >= kConsumers) return;

  // epilogue: register 4j + 2h + c holds row 16 warp + lane / 4 + 8h,
  // column 8j + 2q + c (q = lane % 4): a row's columns over the quad
  const int q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 16 * warp + (lane >> 2) + 8 * h;
#define P(j, c) acc[4 * (j) + 2 * h + (c)]
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool real = 8 * j + 2 * q + c < e;
        P(j, c) = real ? __bfloat162float(__float2bfloat16(P(j, c)))
                       : -INFINITY;          // rounded as x
        m = fmaxf(m, P(j, c));
      }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        P(j, c) = __expf(P(j, c) - m);     // the padded columns: 0
        sum += P(j, c);
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = __frcp_rn(sum);
    float* pr = probs_out + (size_t)row * e;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      P(j, 0) *= inv;
      P(j, 1) *= inv;
      if (row < n_tok) {
        if ((e & 1) == 0) {
          if (col < e)
            *reinterpret_cast<float2*>(pr + col) =
                make_float2(P(j, 0), P(j, 1));
        } else {
          if (col < e) pr[col] = P(j, 0);
          if (col + 1 < e) pr[col + 1] = P(j, 1);
        }
      }
      if (col >= e) P(j, 0) = -INFINITY;    // never picked
      if (col + 1 >= e) P(j, 1) = -INFINITY;
    }

    // k rounds of a quad arg-max on (value, lower index)
    float ws[kMaxK];
    int ids[kMaxK];
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      ws[i] = 0.f;
      ids[i] = 0;
      if (i < k) {
        float bv = -INFINITY;
        int bi = 0x7fffffff;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (P(j, c) > bv) {             // ascending: the first max
              bv = P(j, c);
              bi = 8 * j + 2 * q + c;
            }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (8 * j + 2 * q + c == bi) P(j, c) = -1.f;   // taken
        ws[i] = bv;
        ids[i] = bi;
        tot += bv;
      }
    }
#undef P
    // thread q of the quad writes choice q
    float wq = 0.f;
    int iq = 0;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i)
      if (i == q) {
        wq = ws[i];
        iq = ids[i];
      }
    if (row < n_tok && q < k) {
      idx_out[(size_t)row * k + q] = iq;
      w_out[(size_t)row * k + q] = wq / fmaxf(tot, 1e-9f);
    }
  }
}

// the router [D, E] as a map of boxes {min(N, 64) columns, kBK rows}, the
// swizzle spanning a box row (32, 64 or 128 bytes): Slice<N>'s layout
bool encode_router(CUtensorMap* map, const void* router, int e, int d,
                   int n) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int box0 = n < 64 ? n : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)e, (cuuint64_t)d, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)e * 2, (cuuint64_t)e * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)kBK, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = box0 == 16   ? CU_TENSOR_MAP_SWIZZLE_32B
                                : box0 == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_128B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(router), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, bool TMA_ROUTER>
cudaError_t launch_gating(const CUtensorMap& tx, const CUtensorMap& tr,
                          const bf16* router, int n_tok, int d, int e, int k,
                          int32_t* idx, float* w, float* probs,
                          cudaStream_t s) {
  using R = Ring<N>;
  static const cudaError_t attr =
      allow_smem(gating_kernel<N, TMA_ROUTER>, R::kSmem);
  if (attr != cudaSuccess) return attr;
  // split the k steps over a cluster while the tiles leave half the SMs
  // idle and each CTA keeps kMinSplitSteps (a split of fewer steps lost
  // more to the cluster's launch and reduction than it gained: 8 CTAs of
  // 1-2 steps took a 256-token prefill from 0.0046 to 0.0054 ms)
  const int tiles = (n_tok + kBM - 1) / kBM, steps = (d + kBK - 1) / kBK;
  int splits = 1;
  while (N <= 128 && splits < kMaxSplits && tiles * splits * 2 <= sm_count()
         && steps >= splits * 2 * kMinSplitSteps)
    splits *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = splits;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gating_kernel<N, TMA_ROUTER>, tx,
                                       tr, router, n_tok, d, e, k, splits,
                                       idx, w, probs);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int N>
cudaError_t launch_width(bool tma_router, const CUtensorMap& tx,
                         const CUtensorMap& tr, const bf16* router, int n_tok,
                         int d, int e, int k, int32_t* idx, float* w,
                         float* probs, cudaStream_t s) {
  return tma_router
             ? launch_gating<N, true>(tx, tr, router, n_tok, d, e, k, idx, w,
                                      probs, s)
             : launch_gating<N, false>(tx, tr, router, n_tok, d, e, k, idx,
                                       w, probs, s);
}

__global__ void __launch_bounds__(kPosThreads)
positions_kernel(const int32_t* __restrict__ idx, int n_tok, int k, int e,
                 int32_t* __restrict__ pos) {
  __shared__ int warp_cnt[kPosWarps][kPosMaxE];
  __shared__ int base[kPosMaxE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < e; j += kPosThreads) base[j] = 0;
  const int n = n_tok * k;
  for (int start = 0; start < n; start += kPosThreads) {
    // choice-major flat order: f = choice * T + token
    const int f = start + tid;
    int ex = -1, t = 0, c = 0;
    if (f < n) {
      c = f / n_tok;
      t = f - c * n_tok;
      ex = idx[(size_t)t * k + c];
      if (ex >= e) ex = -1;
    }
    for (int j = tid; j < kPosWarps * e; j += kPosThreads)
      warp_cnt[j / e][j % e] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, ex);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (ex >= 0 && lane == __ffs(peers) - 1) warp_cnt[warp][ex] = __popc(peers);
    __syncthreads();
    // exclusive scan of each expert's count over the warps, in order
    for (int j = tid; j < e; j += kPosThreads) {
      int run = base[j];
      for (int w = 0; w < kPosWarps; ++w) {
        const int cnt = warp_cnt[w][j];
        warp_cnt[w][j] = run;
        run += cnt;
      }
      base[j] = run;
    }
    __syncthreads();
    if (f < n) pos[(size_t)t * k + c] = ex >= 0 ? warp_cnt[warp][ex] + rank : 0;
    __syncthreads();
  }
}

}  // namespace

// x [T, D] and router [D, E] are bfloat16, contiguous, 16-byte aligned,
// D a positive multiple of 8 (x's rows a multiple of 16 bytes: TMA's rule;
// the router loads by TMA where E is a multiple of 8 too).  1 <= E <= 256,
// 1 <= k <= min(4, E).
extern "C" int topk_gating(const void* x, const void* router, int n_tok,
                           int d, int e, int k, void* idx, void* w,
                           void* probs, void* stream) {
  if (e < 1 || e > kMaxE || k < 1 || k > kMaxK || k > e || d < 8 ||
      d % 8 != 0 || n_tok < 0)
    return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return (int)cudaGetLastError();
  const bool tma_router = e % 8 == 0;
  const int n = e <= 16 ? 16 : e <= 32 ? 32 : e <= 64 ? 64 : e <= 128 ? 128
                                                                     : 256;
  CUtensorMap tx, tr;
  memset(&tx, 0, sizeof(tx));
  memset(&tr, 0, sizeof(tr));
  if (!encode_3d(&tx, x, true, d, n_tok, 1, kBK, kBM, true) ||
      (tma_router && !encode_router(&tr, router, e, d, n)))
    return (int)cudaErrorInvalidValue;
  const bf16* r = (const bf16*)router;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* ip = (int32_t*)idx;
  float *wp = (float*)w, *pp = (float*)probs;
  switch (n) {
    case 16:
      return (int)launch_width<16>(tma_router, tx, tr, r, n_tok, d, e, k, ip,
                                   wp, pp, s);
    case 32:
      return (int)launch_width<32>(tma_router, tx, tr, r, n_tok, d, e, k, ip,
                                   wp, pp, s);
    case 64:
      return (int)launch_width<64>(tma_router, tx, tr, r, n_tok, d, e, k, ip,
                                   wp, pp, s);
    case 128:
      return (int)launch_width<128>(tma_router, tx, tr, r, n_tok, d, e, k, ip,
                                    wp, pp, s);
    default:
      return (int)launch_width<256>(tma_router, tx, tr, r, n_tok, d, e, k, ip,
                                    wp, pp, s);
  }
}

extern "C" int topk_positions(const void* idx, int n_tok, int k, int e,
                              void* pos, void* stream) {
  if (e < 1 || e > kPosMaxE) return (int)cudaErrorInvalidValue;
  if (n_tok == 0 || k == 0) return (int)cudaGetLastError();
  positions_kernel<<<1, kPosThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n_tok, k, e, (int32_t*)pos);
  return (int)cudaGetLastError();
}
