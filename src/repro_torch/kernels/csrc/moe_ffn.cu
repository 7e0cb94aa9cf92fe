// Grouped expert FFN for Hopper (sm_90a), bf16 in, fp32 sums, bf16 out.
//
// Replaces src/repro/kernels/moe_ffn.py::grouped_ffn (_kernel): per group g,
// y[g] = act(x[g] @ wi[e]) @ wo[e], act = gelu (tanh form) or
// silu(x @ wi) * (x @ wu), h rounded to bf16 before the second product (as
// the TPU kernel's h.astype(x.dtype)).  Two options the TPU kernel does not
// take, both off by default (then e = g and every row counts, the TPU
// kernel's function exactly):
// - group_expert [G] (int32, on the card): group g reads expert
//   e = group_expert[g] of the unexpanded [E, D, F] / [E, F, D] weights, in
//   place; -1 marks an empty group, which writes zeros.  The serve layer
//   passes its slot -> expert index here instead of gathering a
//   [slots, D, F] copy of the hosted experts' weights.
// - group_rows [G] (int32, on the card): out[g, r] = FFN(x[g, r]) for r <
//   group_rows[g] and 0 for every other row.  Every caller's buffer is zero
//   past that row (gelu(0) = silu(0) * 0 = 0), so the result equals the
//   full product's; tiles wholly past the count load nothing.
//
// Bound on the card.  At the training shape ([16, 1288, 768], F 3072) the
// two products are 194.5 GFLOP against 214 MB moved: operations, 0.197 ms at
// 989 TFLOP/s.  On the serve path a slot holds 8-640 rows, so at decode the
// weights' bytes bound it, and through group_expert the least the card must
// read is each hosted expert's weights once a call, not once a slot.
//
// Design.  The TPU kernel fuses both products over F tiles into a [bt, D]
// fp32 block in VMEM; at D = 6144 that block does not fit a Hopper block's
// registers, so this is two launches of one persistent, warp-specialized
// grouped GEMM on hopper.cuh's bf16 ring (the mainloop of grouped_matmul.cu's
// bf16 path): 384 threads, a producer warpgroup (setmaxnreg 40) one thread
// of which issues TMA loads into kStages stages of 64 k (a: 128 rows of the
// K-major activations, 16 KB; b: four 64 (n) x 64 (k) boxes of the N-major
// weights, 32 KB, 128-byte swizzled), and two consumer warpgroups
// (setmaxnreg 232) that run m64n256k16 with both operands in shared memory,
// 64 rows each.
// - GEMM 1: h = act(x @ wi) into bf16, the activation on the fp32
//   accumulators in registers.  Swiglu stages b as [wi | wu], two boxes of
//   each for the same 128 columns of F, so one m64n256 product gives h in
//   accumulator columns 0-127 and u in 128-255: register i (< 64) of a
//   thread holds column c and register i + 64 column c + 128 of the same
//   row, and silu(h) * u forms in place.  Gelu tiles are 256 columns wide,
//   swiglu 128.
// - GEMM 2: out = h @ wo, rows past the group's count written as 0.
// - Epilogue: bf16 pairs into a 128-byte-swizzled staging tile per
//   warpgroup, then TMA stores of 64 x 64 boxes (rows past T clipped), so
//   the write overlaps the next tile's mainloop; the staging tile is reused
//   once the store has read it.
// - The walk: persistent, one block an SM, tile t, t + grid, ...  Groups
//   are walked sorted by expert (stable; the first block-local step builds
//   the order in shared memory, up to kMaxGroups groups, else in index
//   order), and the tiles of a run of groups that read one expert go (m,
//   n, member) with the member fastest: the slots that host an expert read
//   each weight tile at about the same time and meet in the 50 MB L2, so
//   the weights come from device memory about once an expert.  Without
//   group_expert every run is one group and the walk is grouped_matmul's
//   (n fastest, then m, then g).
// - Empty rows: a tile wholly past its group's count loads nothing and runs
//   no products; GEMM 1 writes nothing there (GEMM 2 never reads it), GEMM 2
//   writes its zeros with plain 16-byte stores.  A consumer warpgroup whose
//   64 rows are all past the count waits and frees each stage without
//   multiplying.  What remains is the ragged last tile of each group: its
//   rows past the count are multiplied (zeros, or masked to zero).
// - No split-K, no atomics: every output is one fixed-order sum, bitwise the
//   same from run to run.
//
// Timed on an H100 and not kept: the warpgroup skip as a branch inside the
// k loop on a value ptxas could not prove warp-uniform; ptxas serialized
// every wgmma of the kernel and the training shape ran about a quarter
// slower.  Costs accepted: a 128 x 256 tile reads 48 KB a 64-deep stage for
// 4.2 MFLOP, more than L2 can feed 132 SMs at the tensor cores' full rate
// (a cluster pair sharing the weight tile by TMA multicast would halve
// that); at Mixtral's prefill (~128 rows a slot) the ragged second row tile
// of a slot is multiplied for a few rows.
// (The backward's grouped GEMM is csrc/grouped_matmul.cu.)
#include <cuda_bf16.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerThreads = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int BM = 128, BN = 256;                 // rows x b columns a tile
constexpr int BK = kRingK;                        // k a stage
constexpr int kStages = 3;
constexpr int kBox = 64;                // columns of a store box (128 bytes)
constexpr int kMaxGroups = 512;         // groups whose walk sits in smem
constexpr int kSmemMax = 232448;        // a block's dynamic limit
enum Epi { kOut = 0, kGelu = 1, kSwiglu = 2 };

// shared memory: the ring, each warpgroup's 64 x 256 bf16 staging tile,
// the walk's tables (5 x kMaxGroups ints), the ring's barriers
constexpr int kCOff = kStages * kRingStage;            // 144 KB
constexpr int kCBytes = 2 * 64 * BN * 2;               // 64 KB
constexpr int kTabOff = kCOff + kCBytes;
constexpr int kBarOff = kTabOff + 5 * kMaxGroups * 4;
constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;
static_assert(kSmem <= kSmemMax, "ffn ring exceeds shared memory");
static_assert(BM == 128 && BN == 256 && BK == 64, "the ring's tile");

struct Params {
  const int* group_expert;   // [G] or null: group g reads expert g
  const int* group_rows;     // [G] or null: every row counts
  bf16* out;                 // GEMM 2's output, for its empty tiles' zeros
  int groups, t, n, k;       // n: output columns, k: depth
  int tiles_m, tiles_n;
};

// the rows of group g that count: its group_rows, within [0, T]; none for
// an empty group
__device__ __forceinline__ int rows_of(const Params& p, int g) {
  int r = p.t;
  if (p.group_rows != nullptr) r = min(max(p.group_rows[g], 0), p.t);
  if (p.group_expert != nullptr && p.group_expert[g] < 0) r = 0;
  return r;
}

// The walk's tables, position j of the sorted order: tab[j] the group,
// tab[M + j] its expert, tab[2M + j] its rows, tab[3M + j] the first
// position of its run (the groups that read the same expert), tab[4M + j]
// the run's length (M = kMaxGroups).  Groups sorted by expert, ties by
// index; without group_expert each group is its own run at its own index.
// `key` is scratch for G ints.  Called by every thread of the block.
__device__ __forceinline__ void build_walk(const Params& p, int* tab,
                                           int* key) {
  if (p.groups > kMaxGroups) return;
  for (int g = threadIdx.x; g < p.groups; g += blockDim.x)
    key[g] = p.group_expert != nullptr ? p.group_expert[g] : g;
  __syncthreads();
  for (int g = threadIdx.x; g < p.groups; g += blockDim.x) {
    const int kg = key[g];
    int lt = 0, eq = 0, before = 0;
    for (int j = 0; j < p.groups; ++j) {
      const int kj = key[j];
      lt += kj < kg;
      eq += kj == kg;
      before += kj == kg && j < g;
    }
    const int pos = lt + before;
    tab[pos] = g;
    tab[kMaxGroups + pos] = kg;
    tab[2 * kMaxGroups + pos] = rows_of(p, g);
    tab[3 * kMaxGroups + pos] = lt;
    tab[4 * kMaxGroups + pos] = eq;
  }
}

struct Tile {
  int g, e, rows;   // the group, its expert, its rows that count
  int m0, n0;
};

// Tile t of the walk: the tiles_m x tiles_n tiles of every group in sorted
// order, those of one run (m, n, member) with the member fastest.  Every
// group has tpg = tiles_m * tiles_n tiles, so run [j0, j0 + len) owns tiles
// [j0 tpg, (j0 + len) tpg).  Past kMaxGroups groups: index order, runs of
// one, read from device memory.
template <int NC>
__device__ __forceinline__ Tile tile_at(int t, const Params& p,
                                        const int* tab) {
  const int tpg = p.tiles_m * p.tiles_n;
  const int jl = t / tpg;
  const bool small = p.groups <= kMaxGroups;
  const int j0 = small ? tab[3 * kMaxGroups + jl] : jl;
  const int len = small ? tab[4 * kMaxGroups + jl] : 1;
  const int u = t - j0 * tpg;
  const int j = j0 + u % len;
  const int rest = u / len;
  Tile r;
  r.n0 = (rest % p.tiles_n) * NC;
  r.m0 = (rest / p.tiles_n) * BM;
  if (small) {
    r.g = tab[j];
    r.e = tab[kMaxGroups + j];
    r.rows = tab[2 * kMaxGroups + j];
  } else {
    r.g = j;
    r.e = p.group_expert != nullptr ? p.group_expert[j] : j;
    r.rows = rows_of(p, j);
  }
  return r;
}

// gelu (tanh form, jax.nn.gelu(approximate=True)) and silu, as v *
// sigmoid(z): 0.5 (1 + tanh(u)) = sigmoid(2 u)
__device__ __forceinline__ float gelu_tanh(float v) {
  const float c2 = 2.f * 0.7978845608028654f;   // 2 sqrt(2 / pi)
  return __fdividef(v, 1.f + __expf(-c2 * (v + 0.044715f * v * v * v)));
}
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// a bf16 pair at (row rr, column cc) of a warpgroup's 64-row staging tile:
// 64-column boxes of 64 rows x 128 bytes, 128-byte swizzled as the store
// map reads them
__device__ __forceinline__ void put_pair(uint8_t* c_wg, int rr, int cc,
                                         float lo, float hi) {
  const uint32_t off = rr * 128 + (cc % kBox) * 2;
  const uint32_t swz = off ^ (((off >> 7) & 7) << 4);
  *reinterpret_cast<uint32_t*>(c_wg + (cc / kBox) * (64 * 128) + swz) =
      pack_bf16(lo, hi);
}

// zeros over GEMM 2's output tile at (m0, n0) of group g, 16 bytes a store,
// by the 256 consumer threads
__device__ __forceinline__ void zero_tile(const Params& p, int g, int m0,
                                          int n0) {
  constexpr int kVecs = BN / 8;   // 16-byte vectors a tile row
  for (int v = threadIdx.x; v < BM * kVecs; v += kConsumerThreads) {
    const int r = m0 + v / kVecs, c = n0 + (v % kVecs) * 8;
    if (r < p.t && c < p.n)
      *reinterpret_cast<uint4*>(p.out + ((size_t)g * p.t + r) * p.n + c) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// One pass.  ta: a [G, T, K] K-major, box {64, 128}; tb (and tb2, wu, for
// swiglu): b [E, K, N] N-major, box {64, 64}; tc: c [G, T, N], box {64, 64},
// the store.  kGelu / kSwiglu: c = act(a @ b) (GEMM 1); kOut: c = a @ b
// with rows past the count zeroed (GEMM 2).
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
ffn_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tb2,
                const __grid_constant__ CUtensorMap tc, const Params p) {
  constexpr int NC = EPI == kSwiglu ? BN / 2 : BN;   // output columns a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* cs = smem + kCOff;
  int* tab = reinterpret_cast<int*>(smem + kTabOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  const int tiles = p.groups * p.tiles_m * p.tiles_n;
  const int nk = p.k / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  build_walk(p, tab, reinterpret_cast<int*>(cs));   // staging tile as scratch
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumerThreads) {
      int i = 0;   // k steps loaded so far, over all of this block's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at<NC>(t, p, tab);
        if (tl.m0 >= tl.rows) continue;          // empty: nothing to load
        for (int kb = 0; kb < nk; ++kb, ++i) {
          const int s = ring_acquire<kStages>(full, empty, i);
          uint8_t* a = smem + s * kRingStage;
          uint8_t* b = a + kRingA;
          const int k0 = kb * BK;
          tma_load(a, &ta, &full[s], k0, tl.m0, tl.g);   // 128 rows of 64 k
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // four 64 (n) x 64 (k) boxes; swiglu: columns n0 .. n0 + 127 of
            // wi, then the same of wu
            const bool up = EPI == kSwiglu && j >= 2;
            const int col = tl.n0 + kBox * (EPI == kSwiglu ? (j & 1) : j);
            tma_load(b + j * (kRingB / 4), up ? &tb2 : &tb, &full[s], col,
                     k0, tl.e);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31;
    const bool leader = lane == 0;
    uint8_t* c_wg = cs + wg * (kCBytes / 2);
    // register i holds row rr0 + 8 ((i / 2) % 2), column 8 (i / 4) + cc0 +
    // i % 2 of the warpgroup's 64 x 256 accumulator tile
    const int rr0 = 16 * warp + (lane >> 2), cc0 = 2 * (lane & 3);
    float d[128];
    int i = 0;     // k steps consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at<NC>(t, p, tab);
      // the branches around the products, broadcast from lane 0 so that
      // ptxas sees them warp-uniform (a divergent path around wgmma
      // serializes every wgmma of the kernel)
      if (__shfl_sync(0xffffffffu, tl.m0 >= tl.rows, 0)) {
        if (EPI == kOut) zero_tile(p, tl.g, tl.m0, tl.n0);
        continue;
      }
      const int r0 = tl.m0 + 64 * wg;      // this warpgroup's first row
      // some row of its 64 counts
      const bool live = __shfl_sync(0xffffffffu, r0 < tl.rows, 0);
#pragma unroll
      for (int j = 0; j < 128; ++j) d[j] = 0.f;
      fence_regs(d);
      if (live)
        ring_consume<false, true, kStages>(d, smem, full, empty, i, nk, wg,
                                           leader);
      else
        ring_release<kStages>(full, empty, i, nk, leader);
      // GEMM 1 leaves h of uncounted rows unwritten: GEMM 2 never multiplies
      // them.  Rows past T have nothing to store.
      if (r0 >= p.t || (EPI != kOut && !live)) continue;

      if (wt == 0) tma_store_wait_read();   // the last store read c_wg
      consumer_bar(wg);
      if constexpr (EPI == kSwiglu) {
#pragma unroll
        for (int q = 0; q < 64; q += 2) {
          const int rr = rr0 + 8 * ((q >> 1) & 1), cc = 8 * (q >> 2) + cc0;
          put_pair(c_wg, rr, cc, silu(d[q]) * d[q + 64],
                   silu(d[q + 1]) * d[q + 65]);
        }
      } else {
        const int counted = tl.rows - r0;   // rows of this warpgroup
#pragma unroll
        for (int q = 0; q < 128; q += 2) {
          const int rr = rr0 + 8 * ((q >> 1) & 1), cc = 8 * (q >> 2) + cc0;
          float lo = d[q], hi = d[q + 1];
          if (EPI == kGelu) {
            lo = gelu_tanh(lo);
            hi = gelu_tanh(hi);
          } else if (rr >= counted) {
            lo = 0.f;
            hi = 0.f;
          }
          put_pair(c_wg, rr, cc, lo, hi);
        }
      }
      fence_proxy_async();
      consumer_bar(wg);
      if (wt == 0) {
#pragma unroll
        for (int c = 0; c < NC / kBox; ++c)
          if (tl.n0 + kBox * c < p.n)
            tma_store_3d(&tc, c_wg + c * (64 * 128), tl.n0 + kBox * c, r0,
                         tl.g);
        tma_store_commit();
      }
    }
    if (wt == 0) tma_store_wait();
  }
}

template <int EPI>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const CUtensorMap& tb2, const CUtensorMap& tc,
                   const Params& p, cudaStream_t s) {
  static const cudaError_t attr = allow_smem(ffn_gemm_kernel<EPI>, kSmem);
  if (attr != cudaSuccess) return attr;
  const long long tiles = (long long)p.groups * p.tiles_m * p.tiles_n;
  ffn_gemm_kernel<EPI><<<persistent_grid(tiles), kThreads, kSmem, s>>>(
      ta, tb, tb2, tc, p);
  return cudaGetLastError();
}

}  // namespace

// x [G,T,D], h scratch [G,T,F], out [G,T,D]; wi / wu [E,D,F], wo [E,F,D];
// all bf16, contiguous, 16-byte aligned; wu may be null for gelu.
// group_expert [G] int32 in [-1, E) or null (then E == G and group g reads
// expert g); group_rows [G] int32 or null (every row counts).  D % 64 == 0,
// F % 64 == 0.  act: 1 gelu (tanh form), 2 swiglu.
extern "C" int grouped_ffn(const void* x, const void* wi, const void* wu,
                           const void* wo, const void* group_expert,
                           const void* group_rows, void* h, void* out, int g,
                           int t, int d, int f, int e, int act,
                           void* stream) {
  if (g < 0 || t < 0 || d <= 0 || f <= 0 || e <= 0 || d % kBox ||
      f % kBox || (act != kGelu && act != kSwiglu) ||
      (act == kSwiglu && wu == nullptr))
    return (int)cudaErrorInvalidValue;
  if (g == 0 || t == 0) return (int)cudaGetLastError();
  const int nc1 = act == kSwiglu ? BN / 2 : BN;
  const long long tiles_m = (t + BM - 1) / BM;
  if ((long long)g * tiles_m * ((f + nc1 - 1) / nc1) > 0x7fffffffLL ||
      (long long)g * tiles_m * ((d + BN - 1) / BN) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, twi, twu, th_st, th_ld, two, tout;
  memset(&twu, 0, sizeof(twu));
  bool ok = encode_3d(&tx, x, true, d, t, g, BK, BM, true) &&
            encode_3d(&twi, wi, true, f, d, e, kBox, BK, true) &&
            encode_3d(&th_st, h, true, f, t, g, kBox, 64, true) &&
            encode_3d(&th_ld, h, true, f, t, g, BK, BM, true) &&
            encode_3d(&two, wo, true, d, f, e, kBox, BK, true) &&
            encode_3d(&tout, out, true, d, t, g, kBox, 64, true);
  if (ok && act == kSwiglu)
    ok = encode_3d(&twu, wu, true, f, d, e, kBox, BK, true);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Params p;
  p.group_expert = (const int*)group_expert;
  p.group_rows = (const int*)group_rows;
  p.out = nullptr;
  p.groups = g;
  p.t = t;
  p.n = f;
  p.k = d;
  p.tiles_m = (int)tiles_m;
  p.tiles_n = (f + nc1 - 1) / nc1;
  cudaError_t err = act == kGelu
                        ? launch<kGelu>(tx, twi, twi, th_st, p, s)
                        : launch<kSwiglu>(tx, twi, twu, th_st, p, s);
  if (err != cudaSuccess) return (int)err;
  p.out = (bf16*)out;
  p.n = d;
  p.k = f;
  p.tiles_n = (d + BN - 1) / BN;
  return (int)launch<kOut>(th_ld, two, two, tout, p, s);
}
