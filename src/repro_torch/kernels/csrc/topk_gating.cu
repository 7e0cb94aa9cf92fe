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
// choice-major rank of each (token, choice) within its expert, flat entry
// f = choice * T + token; an id of -1 or >= E ranks 0 and advances nothing.
// The TPU kernel carries per-expert counters across a sequential grid.
// Bound on the card: bytes (T*k*4 in, T*k*4 out), some 0.04 us at the
// training shape, so what costs is latency: the parent walked all T*k
// entries in one 1,024-thread block, 16 chunks in series at 8192 x 2, each
// with four barriers, a zeroed 32 x E table and E threads scanning 32 warps
// in series (0.0216 ms, 131 SMs idle).  Design:
//   * one thread-block cluster of G CTAs (up to 16 where the card takes a
//     non-portable cluster that size, else 8), each owning `span`
//     contiguous chunks of 1,024 entries of the flat order; G and span
//     follow from n alone (topk_positions_plan), so every CTA keeps at
//     least one chunk (8192 x 2: 16 CTAs of one chunk).  n <= 1,024 (the
//     serve path) takes one CTA of ceil(n / 32) warps and no cluster
//     (positions_solo_kernel): 0.0017 ms at a 256-token prefill against
//     the parent's 0.0020, where a cluster launch of this kernel's one
//     1,024-thread CTA took 0.0025 (chip_smoke.py phase 1);
//   * a chunk is one entry a thread: __match_any_sync ranks equal experts
//     inside a warp, the lowest lane of each group writes the group's count
//     to the warp's row of a [32, E] table, and one warp a group of experts
//     scans an expert's 32 counts with shuffles (lane w reads row w; rows
//     are kPosRow = 257 ints apart, so the 32 reads hit 32 banks; a warp's
//     up to 8 experts side by side), writing back each warp's offset
//     complemented (~x < 0).  A positive entry is thus a count of this
//     chunk and anything else counts 0: each warp zeroes its own row once,
//     under its first loads, never a chunk;
//   * spans of up to kPosHeld chunks rank as they load (the offsets held in
//     registers, the CTA's per-expert count the scan's running total);
//     longer spans count first (shared-memory adds, which give the same sum
//     in any order) and rank in a second walk over the span;
//   * cluster barrier; each CTA reads the counts of the ranks below it
//     from distributed shared memory (all loads in flight at once) and adds
//     them in rank order: its base per expert.  A second barrier, waited
//     for only before exit, keeps each CTA's counts until its peers have
//     read them.
// No global scratch and no atomic that decides an order: the result is
// exact and the same on every run.  One launch a call.
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
constexpr int kSmemMax = 232448;           // a block's dynamic limit
constexpr int kMaxSplits = 8;    // CTAs of a cluster that split a tile's k
constexpr int kMinSplitSteps = 16;   // k steps each of them keeps at least
constexpr int kPosThreads = 1024;   // a chunk: an entry a thread
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kPosMaxE = 256;
constexpr int kPosRow = 257;   // count table row stride: odd, no bank conflict
constexpr int kPosMaxCluster = 16;     // CTAs, where the card allows it
constexpr int kPosPortableCluster = 8;
constexpr int kPosHeld = 2;    // chunks a CTA ranks in one pass
constexpr int kPosMaxEntries = 1 << 30;   // T * k: offsets stay in int
constexpr int kStaticSmemMax = 49152;      // a block's static limit
// the positions kernels' static tables: tab, cnt and base
constexpr int kPosSmem = (kPosWarps * kPosRow + 2 * kPosMaxE) * 4;
static_assert(kPosSmem <= kStaticSmemMax, "positions' tables exceed 48 KB");

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
  static_assert(kSmem <= kSmemMax, "gating ring exceeds shared memory");
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

// the int at the same shared-memory offset as `p` in CTA `rank` of the
// cluster
__device__ __forceinline__ int ld_peer_int(const int* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// entry f of the flat order: its expert (-1 if masked, past E or past the
// span's end f1) and its index t * k + c in idx and pos
__device__ __forceinline__ int pos_entry(const int32_t* __restrict__ idx,
                                         int f, int f1, int n_tok, int k,
                                         int e, int* at) {
  if (f >= f1) return -1;
  const int c = f / n_tok;
  *at = (f - c * n_tok) * k + c;
  const int ex = __ldg(idx + *at);
  return (unsigned)ex < (unsigned)e ? ex : -1;
}

// one chunk: each entry's rank among its expert's entries of the chunk
// before it, plus run[expert] (the expert's count before the chunk); adds
// the chunk's counts to run.  Masked entries get 0.  Warp w scans the SCAN
// experts w, w + 32, ... (SCAN = E / 32 rounded up to 1, 2, 4 or 8) side
// by side: independent shuffle chains, unrolled with no test around a
// shuffle (8 of them each under a runtime test cost 1.2-1.4 us at E 16)
template <int SCAN>
__device__ __forceinline__ int rank_chunk(int* tab, int* run, int ex, int e,
                                          int lane, int warp) {
  const unsigned peers = __match_any_sync(0xffffffffu, ex);
  const int below = __popc(peers & ((1u << lane) - 1u));
  if (ex >= 0 && below == 0) tab[warp * kPosRow + ex] = __popc(peers);
  __syncthreads();
  int cnt[SCAN], incl[SCAN];
#pragma unroll
  for (int i = 0; i < SCAN; ++i) {
    const int x = warp + i * kPosWarps;
    const int v = x < e ? tab[lane * kPosRow + x] : 0;
    cnt[i] = v > 0 ? v : 0;    // not positive: no entry of x there
    incl[i] = cnt[i];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int i = 0; i < SCAN; ++i) {
      const int o = __shfl_up_sync(0xffffffffu, incl[i], d);
      if (lane >= d) incl[i] += o;
    }
  }
#pragma unroll
  for (int i = 0; i < SCAN; ++i) {
    const int x = warp + i * kPosWarps;
    if (x < e) {
      const int r0 = run[x];
      tab[lane * kPosRow + x] = ~(r0 + incl[i] - cnt[i]);
      __syncwarp();
      if (lane == 31) run[x] = r0 + incl[i];
    }
  }
  __syncthreads();
  return ex >= 0 ? ~tab[warp * kPosRow + ex] + below : 0;
}

// n > 1024: the grid is one cluster of gridDim.x >= 2 CTAs, CTA r owning
// the entries [r span 1024, (r + 1) span 1024) of the flat order
template <bool HELD, int SCAN>
__global__ void __launch_bounds__(kPosThreads, 1)
positions_kernel(const int32_t* __restrict__ idx, int n_tok, int k, int e,
                 int span, int32_t* __restrict__ pos) {
  __shared__ int tab[kPosWarps * kPosRow];
  __shared__ int cnt[kPosMaxE];    // this CTA's count an expert: the peers'
  __shared__ int base[kPosMaxE];   // the count of the ranks below
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = blockIdx.x;
  const int n = n_tok * k;
  const int f0 = rank * span * kPosThreads;
  const int f1 = min(n, f0 + span * kPosThreads);
  int ex[kPosHeld], at[kPosHeld], loc[kPosHeld];
  if (HELD) {   // the loads in flight first, under the zeroing
#pragma unroll
    for (int j = 0; j < kPosHeld; ++j)
      if (j < span)
        ex[j] = pos_entry(idx, f0 + j * kPosThreads + tid, f1, n_tok, k, e,
                          &at[j]);
  }
  // each warp zeroes its own row of the table and the counts it scans:
  // both stay the warp's own until rank_chunk's first barrier
  for (int c = lane; c < e; c += 32) tab[warp * kPosRow + c] = 0;
  if (lane == 0)
    for (int x = warp; x < e; x += kPosWarps) cnt[x] = 0;
  __syncwarp();

  if (HELD) {
    // rank chunk by chunk from 0: cnt ends as the span's count an expert
#pragma unroll
    for (int j = 0; j < kPosHeld; ++j)
      if (j < span)
        loc[j] = rank_chunk<SCAN>(tab, cnt, ex[j], e, lane, warp);
  } else {
    __syncthreads();   // cnt, before any warp adds to it
    for (int j = 0; j < span; ++j) {
      int a;
      const int x = pos_entry(idx, f0 + j * kPosThreads + tid, f1, n_tok, k,
                              e, &a);
      const unsigned peers = __match_any_sync(0xffffffffu, x);
      if (x >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&cnt[x], __popc(peers));
    }
  }

  // the base an expert: the counts of ranks 0 .. rank - 1, in rank order
  cluster_sync();
  for (int x = tid; x < e; x += kPosThreads) {
    int v[kPosMaxCluster];
#pragma unroll
    for (int r = 0; r < kPosMaxCluster; ++r)
      v[r] = r < (int)rank ? ld_peer_int(&cnt[x], r) : 0;
    int b = 0;
#pragma unroll
    for (int r = 0; r < kPosMaxCluster; ++r) b += v[r];
    base[x] = b;
  }
  cluster_arrive();     // done with the peers' counts
  __syncthreads();

  if (HELD) {
#pragma unroll
    for (int j = 0; j < kPosHeld; ++j)
      if (j < span && f0 + j * kPosThreads + tid < f1)
        pos[at[j]] = ex[j] >= 0 ? base[ex[j]] + loc[j] : 0;
  } else {
    // the second walk, from the base: base ends as base + the span's count
    for (int j = 0; j < span; ++j) {
      int a;
      const int f = f0 + j * kPosThreads + tid;
      const int x = pos_entry(idx, f, f1, n_tok, k, e, &a);
      const int p = rank_chunk<SCAN>(tab, base, x, e, lane, warp);
      if (f < f1) pos[a] = p;
    }
  }
  cluster_wait();       // the peers are done with cnt
}

// n <= 1024 (the serve path): one CTA of ceil(n / 32) warps, no cluster
// and no base.  Thread x sums expert x's counts over the CTA's warps
// itself, the loads unrolled and in flight together: at 1 to 8 warps a
// shuffle scan would leave each warp several experts to scan in series
__global__ void __launch_bounds__(kPosThreads)
positions_solo_kernel(const int32_t* __restrict__ idx, int n_tok, int k,
                      int e, int32_t* __restrict__ pos) {
  __shared__ int tab[kPosWarps * kPosRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  int at = 0;
  const int ex = pos_entry(idx, tid, n_tok * k, n_tok, k, e, &at);
  for (int c = lane; c < e; c += 32) tab[warp * kPosRow + c] = 0;
  __syncwarp();
  const unsigned peers = __match_any_sync(0xffffffffu, ex);
  const int below = __popc(peers & ((1u << lane) - 1u));
  if (ex >= 0 && below == 0) tab[warp * kPosRow + ex] = __popc(peers);
  __syncthreads();
  for (int x = tid; x < e; x += blockDim.x) {
    int v[kPosWarps];
#pragma unroll
    for (int w = 0; w < kPosWarps; ++w)
      v[w] = w < nw ? tab[w * kPosRow + x] : 0;
    int run = 0;
#pragma unroll
    for (int w = 0; w < kPosWarps; ++w) {
      if (w < nw) tab[w * kPosRow + x] = run;
      run += v[w];
    }
  }
  __syncthreads();
  if (tid < n_tok * k)
    pos[at] = ex >= 0 ? tab[warp * kPosRow + ex] + below : 0;
}

// G and span of n entries at clusters of up to gmax CTAs: span the fewest
// chunks a CTA for which gmax CTAs cover n, G the CTAs that span needs
void positions_plan(int n, int gmax, int* g, int* span) {
  const int chunks = (n + kPosThreads - 1) / kPosThreads;
  *span = (chunks + gmax - 1) / gmax;
  *g = (chunks + *span - 1) / *span;
}

// the largest cluster the card runs positions_kernel in: 16 CTAs where it
// allows non-portable sizes and a cluster that size fits, else 8
template <bool HELD, int SCAN>
bool allow_big_cluster() {
  static const bool ok =
      cudaFuncSetAttribute(positions_kernel<HELD, SCAN>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) == cudaSuccess;
  return ok;
}

int positions_cluster_max() {
  static const int gmax = [] {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kPosMaxCluster);
    cfg.blockDim = dim3(kPosThreads);
    cudaLaunchAttribute cl[1];
    cl[0].id = cudaLaunchAttributeClusterDimension;
    cl[0].val.clusterDim.x = kPosMaxCluster;
    cl[0].val.clusterDim.y = 1;
    cl[0].val.clusterDim.z = 1;
    cfg.attrs = cl;
    cfg.numAttrs = 1;
    int clusters = 0;
    const bool big =
        allow_big_cluster<true, 1>() &&
        cudaOccupancyMaxActiveClusters(&clusters, positions_kernel<true, 1>,
                                       &cfg) == cudaSuccess &&
        clusters >= 1;
    cudaGetLastError();
    return big ? kPosMaxCluster : kPosPortableCluster;
  }();
  return gmax;
}

template <bool HELD, int SCAN>
cudaError_t launch_positions(const int32_t* idx, int n_tok, int k, int e,
                             int g, int span, int32_t* pos, cudaStream_t s) {
  if (g > kPosPortableCluster && !allow_big_cluster<HELD, SCAN>())
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g);
  cfg.blockDim = dim3(kPosThreads);
  cfg.stream = s;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = g;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, positions_kernel<HELD, SCAN>, idx, n_tok, k, e, span, pos);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool HELD>
cudaError_t launch_positions_e(const int32_t* idx, int n_tok, int k, int e,
                               int g, int span, int32_t* pos,
                               cudaStream_t s) {
  if (e <= 32)
    return launch_positions<HELD, 1>(idx, n_tok, k, e, g, span, pos, s);
  if (e <= 64)
    return launch_positions<HELD, 2>(idx, n_tok, k, e, g, span, pos, s);
  if (e <= 128)
    return launch_positions<HELD, 4>(idx, n_tok, k, e, g, span, pos, s);
  return launch_positions<HELD, 8>(idx, n_tok, k, e, g, span, pos, s);
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

// idx [T, k] int32 contiguous; pos [T, k] int32.  1 <= E <= 256.
extern "C" int topk_positions(const void* idx, int n_tok, int k, int e,
                              void* pos, void* stream) {
  if (e < 1 || e > kPosMaxE || n_tok < 0 || k < 0 ||
      (long long)n_tok * k > kPosMaxEntries)
    return (int)cudaErrorInvalidValue;
  const int n = n_tok * k;
  if (n == 0) return (int)cudaGetLastError();
  const int32_t* ip = (const int32_t*)idx;
  int32_t* pp = (int32_t*)pos;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= kPosThreads) {
    positions_solo_kernel<<<1, (n + 31) / 32 * 32, 0, s>>>(ip, n_tok, k, e,
                                                           pp);
    return (int)cudaGetLastError();
  }
  int g, span;
  positions_plan(n, positions_cluster_max(), &g, &span);
  return (int)(span <= kPosHeld
                   ? launch_positions_e<true>(ip, n_tok, k, e, g, span, pp, s)
                   : launch_positions_e<false>(ip, n_tok, k, e, g, span, pp,
                                               s));
}

// what topk_positions launches for n = T * k entries: out[0] the CTAs of
// its cluster, out[1] the chunks of 1,024 entries each owns, out[2] 0 for
// the one-CTA kernel (n <= 1024), 1 where a CTA ranks its span in one pass
// (span <= kPosHeld), 2 where it walks the span twice
extern "C" int topk_positions_plan(int n, void* out) {
  if (n < 1 || n > kPosMaxEntries) return (int)cudaErrorInvalidValue;
  int* o = (int*)out;
  if (n <= kPosThreads) {
    o[0] = o[1] = 1;
    o[2] = 0;
    return (int)cudaGetLastError();
  }
  positions_plan(n, positions_cluster_max(), &o[0], &o[1]);
  o[2] = o[1] <= kPosHeld ? 1 : 2;
  return (int)cudaGetLastError();
}
