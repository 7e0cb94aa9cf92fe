// Grouped GEMM for Hopper (sm_90a): c[g] = a[g] @ b[g], a [G,M,K], b [G,K,N],
// c [G,M,N] fp32; each operand bf16 or fp32, row-major or the transpose view
// of a row-major array, read in place.
//
// Replaces src/repro/kernels/moe_ffn.py::grouped_matmul (_mm_kernel): the
// dgrad / wgrad GEMMs of the FFN backward (ops._GroupedFFN.backward).  At
// gpt2-moe training (D = 768, F = 3072, 16 experts of capacity C = 1288) a
// layer runs five, each 2*16*1288*768*3072 = 97 GFLOP, with these operands
// as stored ("K-major": the contracted index is contiguous):
//   h   = x   @ wi     bf16 K-major . bf16 N-major
//   da  = dy  @ wo^T   fp32 K-major . bf16 K-major
//   dwo = act^T @ dy   fp32 M-major . fp32 N-major
//   dx  = dh  @ wi^T   fp32 K-major . bf16 K-major
//   dwi = x^T @ dh     bf16 M-major . fp32 N-major
// Bound on the card: operations at the TF32 rate for the four with an fp32
// operand (0.196 ms each at 495 TFLOP/s); bytes for h, whose 253 MB fp32
// result takes longer to write (0.108 ms) than its bf16 products to run.
//
// Design.  Persistent: one block an SM walks the 128 x 256 output tiles of
// every group (528-2112 at the training shapes), so the producer loads the
// next tile's first stages while the consumers write the last one out.
// 384 threads: two consumer warpgroups of 64 rows each and a producer
// warpgroup, one thread of which issues TMA loads into a ring of shared-
// memory stages with full / empty mbarriers (setmaxnreg: 232 registers for
// the consumers, 40 for the producer).  Each operand has one 3-D tensor map
// over [G, rows, cols] as stored.  The TMA's out-of-bounds zero fill masks
// the ragged M, N and K edges (C = 1288 = 10 x 128 + 8 rows; K = C in the
// wgrad GEMMs), so the mainloop has no masks; the epilogue masks M and N and
// writes the fp32 accumulators with 8-byte stores.  TMA needs every global
// stride but the innermost to be a multiple of 16 bytes: each operand's
// contiguous dimension is a multiple of 8 bf16 or 4 fp32 values and its base
// 16-byte aligned (the wrapper checks it: D and F are multiples of 64 in
// every config, C only ever counts rows).
//
// Two bf16 operands (h): 4 stages 64 deep that land with the 128-byte
// swizzle in the layout wgmma reads; m64n256k16 bf16 with both operands in
// shared memory, the transpose bits taking an M-major a or an N-major b as
// it lands (4 instances: the bits are immediates).  Products are exact,
// sums fp32.
//
// Any fp32 operand: wgmma .tf32 (m64n256k8) reads K-major operands only (the
// transpose bits exist for 16-bit types alone) and no instruction mixes
// bf16 with fp32, so a transform stage sits between the TMA ring and the
// tensor cores.  Each 32-deep stage (2 in the ring) lands as stored,
// unswizzled, in its own type and layout; the 256 consumer threads read it,
// widen bf16 to fp32 (exact: tf32 holds bf16's mantissa) or round fp32 to
// tf32 (cvt.rna, to nearest, as the WMMA kernel before this one did; the
// tensor core fed fp32 directly would truncate, a bias of up to 2^-10 an
// operand), and write a K-major, 128-byte-swizzled tile into one of two
// conversion buffers; then fence.proxy.async, a named barrier of the
// consumers, and wgmma on that buffer while the next stage converts.  A
// buffer is rewritten two stages after the products that read it: a first
// barrier a stage, after the raw loads, holds the writes until every
// consumer warp has waited for those products (wait_group 1).  One
// instance: the two operands' type and layout are uniform branches of the
// transform.
//
// Each of these choices was timed on an H100 against the one before it, at
// gpt2-moe's five GEMMs: 128 x 256 TF32 tiles beat 128 x 128 (the two
// consumer warpgroups each read all of b, so a wider tile reads less a
// FLOP); persistent beat one block a tile; a raw ring
// sized to the operands' types (3-4 stages) gained nothing; a separate
// transform warpgroup that left the consumers only wgmma to issue lost
// (four warps convert more slowly than eight).  Taking a from registers and
// computing c^T = b^T a^T would spare da and dx the transform, but dwo and
// dwi have both operands M/N-major and would still need a transpose
// through shared memory; one path serves all twelve mixes.
//
// Costs accepted: the transform doubles the shared-memory traffic of the
// TF32 mainloop (TMA write, raw read, converted write, wgmma read: ~224 KB
// per 128 x 256 x 32 stage of 2 MFLOP, ~1750 cycles of the SM's 128 bytes a
// cycle against ~980 of products), which holds the TF32 mainloop to about a
// third of the TF32 peak (chip_smoke.py's depth sweep reads its steady
// rate).  At M = 1288 the 11th row band holds 8 of 128 rows, 7% of the MMA
// work of h, da and dx; a 64-row tile would halve the reuse of b in the
// other ten bands, so the waste stays.  No split-K, no atomics: every
// output is one fixed-order sum, bitwise the same from run to run.
#include <cuda_bf16.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerThreads = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int BM = 128, BN = 256;                 // every output tile
constexpr int kSmemMax = 232448;                  // a block's dynamic limit

// operand kind, as the wrapper plans it: bit 0 bf16 (else fp32), bit 1 the
// operand is stored M- or N-major (else K-major)
constexpr int kBf16 = 1, kMnMajor = 2;

// -- bf16 x bf16: 128 x 256 x 64 stages straight from TMA -----------------
constexpr int kBfK = 64, kBfStages = 4;
constexpr int kBfA = BM * kBfK * 2, kBfB = BN * kBfK * 2;  // 16 KB, 32 KB
constexpr int kBfStage = kBfA + kBfB;
constexpr int kBfSmem = kBfStages * kBfStage + 2 * kBfStages * 8 + 1024;
static_assert(kBfSmem <= kSmemMax, "bf16 ring exceeds shared memory");

// -- any fp32: 128 x 256 x 32 raw stages, converted into two buffers ------
constexpr int kTfK = 32, kTfStages = 2, kTfBufs = 2;
constexpr int kTfA = BM * kTfK * 4, kTfB = BN * kTfK * 4;  // 16, 32 KB
constexpr int kTfStage = kTfA + kTfB;   // raw (sized for fp32) or converted
constexpr int kTfSmem = (kTfStages + kTfBufs) * kTfStage +
                        2 * kTfStages * 8 + 1024;
static_assert(kTfSmem <= kSmemMax, "tf32 ring exceeds shared memory");

// ---------------------------------------------------------------------------
// wgmma instructions of this kernel (hopper.cuh has the rest of the PTX)
// ---------------------------------------------------------------------------

// d[64 x 256] += a[64 x 8] . b[8 x 256], tf32, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_n256(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {" REGS128
      "}, %128, %129, p, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56),
        R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 256] += a[64 x 16] . b[16 x 256], bf16; TA / TB: a M-major, b
// N-major (the transpose bits)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" REGS128
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56),
        R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Epilogue: one warpgroup's m64nN accumulators into c (row stride n),
// masked to m x n.  Register i of thread (warp w, lane l) of the warpgroup
// holds row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) +
// i % 2 of the warpgroup's 64 x N tile.
template <int N>
__device__ __forceinline__ void store_tile(const float (&d)[N], float* c,
                                           int m, int n, int row0, int col0) {
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
  const bool pairs = (n & 1) == 0;   // 8-byte aligned column pairs
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int r = row0 + 16 * w + (l >> 2) + 8 * ((i >> 1) & 1);
    const int col = col0 + 8 * (i >> 2) + 2 * (l & 3);
    if (r >= m || col >= n) continue;
    float* p = c + (size_t)r * n + col;
    if (pairs) {
      *reinterpret_cast<float2*>(p) = make_float2(d[i], d[i + 1]);
    } else {
      p[0] = d[i];
      if (col + 1 < n) p[1] = d[i + 1];
    }
  }
}

// The persistent walk: block b takes tiles b, b + gridDim.x, ... in the
// order N tiles fastest, then M tiles, then groups, so the blocks in flight
// share a band of a and sweep b.  The producer runs on into the next tile's
// stages while the consumers write the last one out.
struct Tile {
  int g, m0, n0;
};
__device__ __forceinline__ Tile tile_at(int t, int tiles_n, int tiles_m) {
  Tile r;
  r.n0 = (t % tiles_n) * BN;
  t /= tiles_n;
  r.m0 = (t % tiles_m) * BM;
  r.g = t / tiles_m;
  return r;
}

// ---------------------------------------------------------------------------
// bf16 x bf16
// ---------------------------------------------------------------------------

// A_MN: a stored M-major ([G,K,M]); B_MN: b stored N-major ([G,K,N])
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(kThreads, 1)
gmm_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, float* __restrict__ c,
                int groups, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBfStages * kBfStage);
  uint64_t* empty = full + kBfStages;
  const int tiles_n = (n + BN - 1) / BN, tiles_m = (m + BM - 1) / BM;
  const int tiles = tiles_n * tiles_m * groups;
  const int nk = (k + kBfK - 1) / kBfK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBfStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads / 32);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumerThreads) {
      int i = 0;   // k steps loaded so far, over all of this block's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, tiles_n, tiles_m);
        for (int kb = 0; kb < nk; ++kb, ++i) {
          const int s = i % kBfStages;
          if (i >= kBfStages) mbar_wait(&empty[s], ((i / kBfStages) - 1) & 1);
          uint8_t* a = smem + s * kBfStage;
          uint8_t* b = a + kBfA;
          const int k0 = kb * kBfK;
          mbar_expect_tx(&full[s], kBfStage);
          if (A_MN) {   // two 64 (m) x 64 (k) blocks, 8 KB each
            tma_load(a, &ta, &full[s], tl.m0, k0, tl.g);
            tma_load(a + kBfA / 2, &ta, &full[s], tl.m0 + 64, k0, tl.g);
          } else {    // 128 rows (m) of 64 k
            tma_load(a, &ta, &full[s], k0, tl.m0, tl.g);
          }
          if (B_MN) {  // four 64 (n) x 64 (k) blocks
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tma_load(b + j * (kBfB / 4), &tb, &full[s], tl.n0 + 64 * j, k0,
                       tl.g);
          } else {    // 256 rows (n) of 64 k
            tma_load(b, &tb, &full[s], k0, tl.n0, tl.g);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x >> 7;
    const bool leader = (threadIdx.x & 31) == 0;
    float d[128];
    int i = 0;     // k steps consumed so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, tiles_n, tiles_m);
#pragma unroll
      for (int j = 0; j < 128; ++j) d[j] = 0.f;
      fence_regs(d);
      for (int kb = 0; kb < nk; ++kb, ++i) {
        const int s = i % kBfStages;
        mbar_wait(&full[s], (i / kBfStages) & 1);
        // this warpgroup's 64 rows of a: the second half of the K-major
        // tile, or the second 64-wide M block
        const uint32_t a = smem_u32(smem + s * kBfStage) + wg * (kBfA / 2);
        const uint32_t b = smem_u32(smem + s * kBfStage + kBfA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBfK / 16; ++kk) {
          // 16 k: 32 bytes along a K-major row, or 16 rows of an M/N-major
          // one
          const uint64_t da = A_MN ? sw128_desc(a + kk * 2048, kBfA / 2, 1024)
                                   : sw128_desc(a + kk * 32, 16, 1024);
          const uint64_t db = B_MN ? sw128_desc(b + kk * 2048, kBfB / 4, 1024)
                                   : sw128_desc(b + kk * 32, 16, 1024);
          wgmma_bf16_n256<A_MN, B_MN>(d, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous step's products are done
        fence_regs(d);
        if (kb > 0 && leader) mbar_arrive(&empty[(i - 1) % kBfStages]);
      }
      wgmma_wait<0>();
      fence_regs(d);
      if (nk > 0 && leader) mbar_arrive(&empty[(i - 1) % kBfStages]);
      store_tile(d, c + (size_t)tl.g * m * n, m, n, tl.m0 + 64 * wg, tl.n0);
    }
  }
}

// ---------------------------------------------------------------------------
// any fp32 operand: TF32 through the transform stage
// ---------------------------------------------------------------------------

__device__ __forceinline__ float tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// The transform: one ROWS x 32 stage of an operand (ROWS = 128 for a, 256
// for b), landed as stored, into the K-major fp32 tile wgmma reads, 16-byte
// chunk j (k = 4j .. 4j+3) of row r (m or n) at byte 128 r + 16 (j ^ r % 8).
// Each of the 256 consumer threads moves ROWS / 32 chunks, item = tid + 256
// u: a warp reads 512 (or 256) contiguous bytes of a K-major raw tile, or 32
// neighbouring rows of an M/N-major one in 4 loads of 32 consecutive values.
// All loads of a stage are issued before its stores, so their latencies
// overlap.
template <int KIND, int ROWS>
__device__ __forceinline__ int chunk_row(int item) {
  return (KIND & kMnMajor) ? item % ROWS : item >> 3;
}
template <int KIND, int ROWS>
__device__ __forceinline__ int chunk_col(int item) {
  return (KIND & kMnMajor) ? item / ROWS : item & 7;
}

template <int KIND, int ROWS>
__device__ __forceinline__ void load_chunks(const uint8_t* raw, int tid,
                                            float4 (&v)[ROWS / 32]) {
#pragma unroll
  for (int u = 0; u < ROWS / 32; ++u) {
    const int item = tid + kConsumerThreads * u;
    const int r = chunk_row<KIND, ROWS>(item), j = chunk_col<KIND, ROWS>(item);
    if constexpr ((KIND & kMnMajor) != 0) {   // raw [32 k][ROWS r]
      if constexpr ((KIND & kBf16) != 0) {
        const bf16* p = reinterpret_cast<const bf16*>(raw) + 4 * j * ROWS + r;
        v[u] = make_float4(bf(p[0]), bf(p[ROWS]), bf(p[2 * ROWS]),
                           bf(p[3 * ROWS]));
      } else {
        const float* p = reinterpret_cast<const float*>(raw) + 4 * j * ROWS + r;
        v[u] = make_float4(p[0], p[ROWS], p[2 * ROWS], p[3 * ROWS]);
      }
    } else {                                   // raw [ROWS r][32 k]
      if constexpr ((KIND & kBf16) != 0) {
        const uint2 w = reinterpret_cast<const uint2*>(raw)[item];
        v[u] = make_float4(__uint_as_float(w.x << 16),
                           __uint_as_float(w.x & 0xffff0000u),
                           __uint_as_float(w.y << 16),
                           __uint_as_float(w.y & 0xffff0000u));
      } else {
        v[u] = reinterpret_cast<const float4*>(raw)[item];
      }
    }
  }
}

template <int KIND, int ROWS>
__device__ __forceinline__ void store_chunks(uint8_t* conv, int tid,
                                             const float4 (&v)[ROWS / 32]) {
#pragma unroll
  for (int u = 0; u < ROWS / 32; ++u) {
    const int item = tid + kConsumerThreads * u;
    const int r = chunk_row<KIND, ROWS>(item), j = chunk_col<KIND, ROWS>(item);
    float4 x = v[u];
    if constexpr ((KIND & kBf16) == 0) {
      x.x = tf32_round(x.x);
      x.y = tf32_round(x.y);
      x.z = tf32_round(x.z);
      x.w = tf32_round(x.w);
    }
    *reinterpret_cast<float4*>(conv + 128 * r + 16 * (j ^ (r & 7))) = x;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_any(int kind, const uint8_t* raw,
                                         int tid, float4 (&v)[ROWS / 32]) {
  switch (kind) {
    case 0: load_chunks<0, ROWS>(raw, tid, v); break;
    case kBf16: load_chunks<kBf16, ROWS>(raw, tid, v); break;
    case kMnMajor: load_chunks<kMnMajor, ROWS>(raw, tid, v); break;
    default: load_chunks<kMnMajor | kBf16, ROWS>(raw, tid, v); break;
  }
}

template <int ROWS>
__device__ __forceinline__ void store_any(int kind, uint8_t* conv, int tid,
                                          const float4 (&v)[ROWS / 32]) {
  switch (kind) {
    case 0: store_chunks<0, ROWS>(conv, tid, v); break;
    case kBf16: store_chunks<kBf16, ROWS>(conv, tid, v); break;
    case kMnMajor: store_chunks<kMnMajor, ROWS>(conv, tid, v); break;
    default: store_chunks<kMnMajor | kBf16, ROWS>(conv, tid, v); break;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gmm_tf32_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, float* __restrict__ c,
                int groups, int m, int n, int k, int a_kind, int b_kind) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* conv0 = smem + kTfStages * kTfStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(conv0 + kTfBufs * kTfStage);
  uint64_t* empty = full + kTfStages;
  const int tiles_n = (n + BN - 1) / BN, tiles_m = (m + BM - 1) / BM;
  const int tiles = tiles_n * tiles_m * groups;
  const int nk = (k + kTfK - 1) / kTfK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);   // after the consumers' first barrier
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumerThreads) {
      const uint32_t bytes = BM * kTfK * (a_kind & kBf16 ? 2 : 4) +
                             BN * kTfK * (b_kind & kBf16 ? 2 : 4);
      const bool am = a_kind & kMnMajor, bn = b_kind & kMnMajor;
      int i = 0;   // k steps loaded so far, over all of this block's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, tiles_n, tiles_m);
        for (int kb = 0; kb < nk; ++kb, ++i) {
          const int s = i % kTfStages;
          if (i >= kTfStages)
            mbar_wait(&empty[s], ((i / kTfStages) - 1) & 1);
          uint8_t* a = smem + s * kTfStage;
          const int k0 = kb * kTfK;
          mbar_expect_tx(&full[s], bytes);
          // boxes as stored: a 128 (m) x 32 (k), b 256 (n) x 32 (k);
          // [32][rows] M/N-major, [rows][32] K-major
          tma_load(a, &ta, &full[s], am ? tl.m0 : k0, am ? k0 : tl.m0, tl.g);
          tma_load(a + kTfA, &tb, &full[s], bn ? tl.n0 : k0,
                   bn ? k0 : tl.n0, tl.g);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x, wg = tid >> 7;
    float d[128];
    int i = 0;     // k steps consumed so far (the conversion buffer's turn)
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, tiles_n, tiles_m);
#pragma unroll
      for (int j = 0; j < 128; ++j) d[j] = 0.f;
      fence_regs(d);
      for (int kb = 0; kb < nk; ++kb, ++i) {
        const int s = i % kTfStages;
        mbar_wait(&full[s], (i / kTfStages) & 1);
        const uint8_t* raw = smem + s * kTfStage;
        uint8_t* conv = conv0 + (i % kTfBufs) * kTfStage;
        float4 va[BM / 32], vb[BN / 32];
        load_any<BM>(a_kind, raw, tid, va);
        load_any<BN>(b_kind, raw + kTfA, tid, vb);
        // every consumer warp has loaded this raw stage and waited for the
        // products of step i - 2, the last to read this conversion buffer
        asm volatile("bar.sync 1, %0;" :: "n"(kConsumerThreads) : "memory");
        if (tid == 0) mbar_arrive(&empty[s]);
        store_any<BM>(a_kind, conv, tid, va);
        store_any<BN>(b_kind, conv + kTfA, tid, vb);
        // the generic-proxy writes become visible to wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, %0;" :: "n"(kConsumerThreads) : "memory");
        const uint32_t a = smem_u32(conv) + wg * (kTfA / 2);
        const uint32_t b = smem_u32(conv + kTfA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTfK / 8; ++kk)   // 8 k = 32 bytes of a row
          wgmma_tf32_n256(d, sw128_desc(a + kk * 32, 16, 1024),
                          sw128_desc(b + kk * 32, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(d);
      }
      wgmma_wait<0>();
      fence_regs(d);
      store_tile(d, c + (size_t)tl.g * m * n, m, n, tl.m0 + 64 * wg, tl.n0);
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launch
// ---------------------------------------------------------------------------

// 3-D map over a row-major [g, outer, inner] array, box {box0, box1, 1}
bool encode(CUtensorMap* map, const void* ptr, bool is_bf16, int inner,
            int outer, int g, int box0, int box1, bool swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)g};
  const cuuint64_t strides[2] = {inner * es, (cuuint64_t)inner * outer * es};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// one block an SM (each takes all of its shared memory), at most one a tile
int persistent_grid(long long tiles) {
  const int sms = sm_count();
  return (int)(tiles < sms ? tiles : sms);
}

template <bool A_MN, bool B_MN>
cudaError_t launch_bf16(const CUtensorMap& ta, const CUtensorMap& tb,
                        float* c, int grid, int g, int m, int n, int k,
                        cudaStream_t s) {
  static const cudaError_t attr =
      allow_smem(gmm_bf16_kernel<A_MN, B_MN>, kBfSmem);
  if (attr != cudaSuccess) return attr;
  gmm_bf16_kernel<A_MN, B_MN><<<grid, kThreads, kBfSmem, s>>>(ta, tb, c, g, m,
                                                             n, k);
  return cudaGetLastError();
}

}  // namespace

// c [G,M,N] fp32 = a [G,M,K] @ b [G,K,N].  a_kind / b_kind: bit 0 the operand
// is bf16 (else fp32); bit 1 it is stored M-major ([G,K,M]) / N-major
// ([G,K,N], b's row-major layout), else K-major ([G,M,K] / [G,N,K]).  Each
// operand's contiguous dimension times its element size is a multiple of 16
// bytes and its base 16-byte aligned.  Any M, N, K >= 0; K == 0 writes zeros.
extern "C" int grouped_matmul(const void* a, const void* b, void* c, int g,
                              int m, int n, int k, int a_kind, int b_kind,
                              void* stream) {
  const long long tiles =
      (long long)((n + BN - 1) / BN) * ((m + BM - 1) / BM) * g;
  if (g < 0 || m < 0 || n < 0 || k < 0 || a_kind < 0 || a_kind > 3 ||
      b_kind < 0 || b_kind > 3 || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaGetLastError();
  const int grid = persistent_grid(tiles);
  cudaStream_t s = (cudaStream_t)stream;
  float* out = (float*)c;
  const bool a_bf = a_kind & kBf16, b_bf = b_kind & kBf16;
  const bool am = a_kind & kMnMajor, bn = b_kind & kMnMajor;
  const bool both_bf = a_bf && b_bf;
  // K == 0: no tile is loaded and the maps are never read; the kernel writes
  // its zero accumulators
  CUtensorMap ta, tb;
  memset(&ta, 0, sizeof(ta));
  memset(&tb, 0, sizeof(tb));
  if (k > 0) {
    bool ok;
    if (both_bf)
      ok = (am ? encode(&ta, a, true, m, k, g, 64, 64, true)
               : encode(&ta, a, true, k, m, g, kBfK, BM, true)) &&
           (bn ? encode(&tb, b, true, n, k, g, 64, 64, true)
               : encode(&tb, b, true, k, n, g, kBfK, BN, true));
    else
      ok = (am ? encode(&ta, a, a_bf, m, k, g, BM, kTfK, false)
               : encode(&ta, a, a_bf, k, m, g, kTfK, BM, false)) &&
           (bn ? encode(&tb, b, b_bf, n, k, g, BN, kTfK, false)
               : encode(&tb, b, b_bf, k, n, g, kTfK, BN, false));
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  if (both_bf) {
    if (am && bn)
      return (int)launch_bf16<true, true>(ta, tb, out, grid, g, m, n, k, s);
    if (am)
      return (int)launch_bf16<true, false>(ta, tb, out, grid, g, m, n, k, s);
    if (bn)
      return (int)launch_bf16<false, true>(ta, tb, out, grid, g, m, n, k, s);
    return (int)launch_bf16<false, false>(ta, tb, out, grid, g, m, n, k, s);
  }
  static const cudaError_t attr = allow_smem(gmm_tf32_kernel, kTfSmem);
  if (attr != cudaSuccess) return (int)attr;
  gmm_tf32_kernel<<<grid, kThreads, kTfSmem, s>>>(ta, tb, out, g, m, n, k,
                                                  a_kind, b_kind);
  return (int)cudaGetLastError();
}
