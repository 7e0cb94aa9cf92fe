// Flash attention for Hopper (sm_90a): causal, sliding-window or
// bidirectional, grouped-query heads; bf16 in, fp32 softmax and sums, bf16
// out.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (_kernel):
// o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // (H/KV)] * hd^-0.5, masked
// to j <= i (causal) and j > i - window) @ v[b, :, h // (H/KV)], the online
// softmax over KV tiles in fp32 (running max m, denominator l, accumulator
// rescaled by exp(m_old - m_new)), P rounded to bf16 before P.V (as the TPU
// kernel's p.astype(v.dtype)), and the output divided by max(l, 1e-30).  The
// TPU kernel walks KV tiles on a sequential grid axis with m, l and the
// accumulator in VMEM scratch; here that axis is a loop inside the block and
// m, l and the accumulator live in registers.  Masked scores are held at
// -2^100 before the scale (the TPU kernel: -1e30 after it): a power of two,
// so that on a row masked so far the FMA below cancels exactly, as the TPU
// kernel's subtraction does.  Every query row has an unmasked key (its
// own), so both give the same output.
//
// Bound on the card: operations.  Each unmasked (query, key) pair of a head
// costs 4*hd operations (q.k and p.v) while q, k, v and o are each moved
// once: at S in the thousands, hundreds of operations a byte, above the
// ~295 where the tensor cores become the limit.  Besides the products, every
// pair costs one ex2 on the SM's 16-a-cycle function units: at hd 64 that
// is as many cycles as the products take on the tensor cores.
//
// Design (what held the kernel before this one, with warp-level m16n8k16
// products, to 20% of the bound, and what this one does about it):
// - Tensor cores: both products run on wgmma.  S = Q K^T is m64n128k16 with
//   Q and K from 128-byte-swizzled shared memory, both K-major as stored (hd
//   contiguous).  P never leaves the registers: the m64n128 fp32
//   accumulator's values for keys 16c .. 16c+15 are exactly the A-register
//   fragment of the k16 step c, so P is packed to bf16 in place and O += P V
//   is m64n{hd}k16 with A from registers and B the V tile, which is N-major
//   as stored (hd contiguous) and read through the transpose bit: no copy.
// - Loads: one producer thread issues TMA loads into a two-stage ring of K/V
//   tiles with full / empty mbarriers, K and V on barriers of their own (S
//   starts before V lands; a K stage refills once S is done, before P V),
//   while two consumer warpgroups compute (setmaxnreg: 240 registers for the
//   consumers, 24 for the producer warpgroup).  One 4-D tensor map a tensor
//   over [B, S, heads, hd] as stored, box {64, 1, rows, 1}: a 64-column
//   slice of one head (two boxes at hd 128 and at hd 80); the GQA head is
//   the map's head coordinate h // (H/KV).  The TMA's zero fill covers rows
//   >= S, so nothing is masked on load, and its store clips them.
// - Head dim 80 (hubert-xlarge): the maps keep the real inner dimension
//   (rows of 160 bytes, a multiple of 16 as the TMA requires), and a tile is
//   the two 64-column boxes of hd 128, the second zero-filled past column
//   80.  S = Q K^T issues the 5 k16 steps that hold real columns, P V runs
//   at m64n80k16 over the same two-box descriptor, the epilogue writes
//   columns 0 .. 79 and the TMA store clips the second box at column 80.
//   The scale is 80^-0.5: each instance takes it from its own HD.
// - Blocks: 384 threads; each work item is a 128-row query tile of one
//   (b, h), 64 rows a consumer warpgroup, so each staged K/V tile feeds 128
//   rows.  Persistent: one block an SM (the ring takes most of its shared
//   memory) walks the items, so the next item's Q and first K/V tiles load
//   while the last one's output is stored (TMA store from shared memory).
//   Items go longest first under causal (the last query tiles), the query
//   heads of one KV head next to each other (their K/V tiles meet in L2),
//   the blocks walking each round of items in alternate directions so that
//   the long and the short items even out.
// - Masks: only on the KV tiles that cross the diagonal, the window's lower
//   edge or S; KV tiles masked for every row of the item are not loaded.
//   The scale and log2(e) fold into one FMA before ex2.
// - Overlap: each warpgroup runs S, the softmax and P V in turn, and the
//   two warpgroups overlap each other: one's softmax runs while the other's
//   products are on the tensor cores.  At most O and S are live.
//
// Timed on an H100 against each other at the phase-1 shapes and not kept:
// - issuing S_{j+1} = Q K_{j+1}^T with P_j V_j before the softmax of S_j
//   (within a warpgroup): at hd 128, O, S and P live at once outgrow the
//   registers and ptxas serializes every wgmma; slower than the in-order
//   loop at hd 128 and no better at hd 64;
// - the warpgroups taking turns to issue their products (named barriers,
//   "ping-pong"): no steady gain over the schedulers' own interleaving;
// - one block an item instead of the persistent walk: slower (exposed
//   prologue and epilogue);
// - a one-warp producer without setmaxnreg (288 threads, 168 registers):
//   a little slower at hd 128;
// - three consumer warpgroups (192-row items) at hd 64: faster at zamba2's
//   4 x 2048, slower at gpt2-moe's 8 x 1024, where the last item is two
//   thirds empty;
// - four K/V stages at hd 64, partial sums of the row max and sum, skipping
//   the rescale where the max holds: no gain.
#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kConsumerThreads = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int BM = 128;                           // query rows an item
constexpr int BN = 128;                           // keys a KV tile
constexpr int kSmemMax = 232448;                  // a block's dynamic limit
constexpr float kMask = -0x1p100f;                // a masked score (raw)
constexpr double kLog2e = 1.4426950408889634;

// shared memory: Q [BM rows], kStages x (K, V) [BN rows], O [BM rows], each
// tile ceil(hd / 64) boxes of rows x 128 bytes, 128-byte swizzled (at hd 80
// the second box holds columns 64 .. 79, the TMA's zero fill past them);
// then barriers
template <int HD>
struct Smem {
  static constexpr int kBoxes = (HD + 63) / 64;
  static constexpr int kStages = 2;
  static constexpr int kQ = BM * kBoxes * 128, kKV = BN * kBoxes * 128,
                       kO = BM * kBoxes * 128;
  static constexpr int kOOff = kQ + kStages * 2 * kKV;
  static constexpr int kBarOff = kOOff + kO;
  static constexpr int kBytes = kBarOff + (2 + 4 * kStages) * 8 + 1024;
  static_assert(kBytes <= kSmemMax, "flash ring exceeds shared memory");
};

struct Params {
  int b, s, h, kvh, causal, window;
  int tiles_m, items;
  float c;            // hd^-0.5 * log2(e)
};

// ---------------------------------------------------------------------------
// the work: items and their KV tiles
// ---------------------------------------------------------------------------

struct Item {
  int b, h, q0;
};

// item t: query tiles from the last (the longest under causal), then b, then
// h fastest, so the query heads of a KV head are neighbours
__device__ __forceinline__ Item item_at(int t, const Params& p) {
  const int bh = p.b * p.h;
  Item it;
  it.q0 = (p.tiles_m - 1 - t / bh) * BM;
  const int r = t % bh;
  it.b = r / p.h;
  it.h = r % p.h;
  return it;
}

// the k-th item of this block: round k of gridDim.x items, walked forwards
// on even rounds and backwards on odd ones (-1: none in this round)
__device__ __forceinline__ int walk(int k, const Params& p) {
  const int t = k * gridDim.x +
                ((k & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                         : (int)blockIdx.x);
  return t < p.items ? t : -1;
}

// KV tiles [j0, j1) that some row of the item at q0 needs
__device__ __forceinline__ void kv_tiles(int q0, const Params& p, int& j0,
                                         int& j1) {
  const int kv_end = p.causal ? min(q0 + BM, p.s) : p.s;
  const int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  j0 = kv_begin / BN;
  j1 = (kv_end + BN - 1) / BN;
}

// does the KV tile at k0 hold a masked (row, key) for rows r0 .. r0+63?
__device__ __forceinline__ bool tile_needs_mask(int r0, int k0,
                                                const Params& p) {
  return k0 + BN > p.s || (p.causal && k0 + BN - 1 > r0) ||
         (p.window > 0 && k0 <= r0 + 63 - p.window);
}

// ---------------------------------------------------------------------------
// the two products
// ---------------------------------------------------------------------------

// S = Q K^T of this warpgroup's 64 rows against one staged K tile
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q,
                                         uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss<0, 0>(sc,
                   sw128_desc(q + (kk / 4) * (BM * 128) + (kk % 4) * 32, 16,
                              1024),
                   sw128_desc(k + (kk / 4) * (BN * 128) + (kk % 4) * 32, 16,
                              1024),
                   kk > 0);
}

#define REGS40 REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39"

// d[64 x 80] += a[64 x 16] (registers) . b[16 x 80] (N-major in shared
// memory): hopper.cuh's wgmma_rs at n80, the P V of head dim 80.  The
// descriptor's 64-column blocks sit lbo apart, so columns 64 .. 79 come
// from the second box
__device__ __forceinline__ void wgmma_rs(float (&d)[40], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {" REGS40
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over the BN keys of one staged V tile: k16 step c reads V rows
// 16c .. 16c+15 (2048 bytes on), the column boxes BN * 128 apart; the
// product is m64n{hd}k16 (n80 at hd 80: no padded columns multiplied)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int c = 0; c < BN / 16; ++c)
    wgmma_rs(o, pa[c], sw128_desc(v + c * 2048, BN * 128, 1024));
}

// ---------------------------------------------------------------------------
// the softmax, on the m64n128 accumulator: register i of thread (warp w,
// lane l) of a warpgroup holds row 16 w + l / 4 + 8 ((i / 2) % 2), key
// 8 (i / 4) + 2 (l % 4) + i % 2
// ---------------------------------------------------------------------------

// row: this thread's first row (the second is row + 8); col: its first key
__device__ __forceinline__ void mask_tile(float (&sc)[64], int row, int col,
                                          const Params& p) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = row + 8 * ((i >> 1) & 1);
    const int c = col + 8 * (i >> 2) + (i & 1);
    const bool ok = c < p.s && (!p.causal || c <= r) &&
                    (p.window == 0 || c > r - p.window);
    if (!ok) sc[i] = kMask;
  }
}

// the online softmax of one tile: sc becomes P (fp32), alpha the factor of
// the old accumulator; l_run holds this thread's columns' share of l
__device__ __forceinline__ void softmax_tile(float (&sc)[64],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2], float c) {
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float mc[2], ls[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // the 4 threads of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m_run[r] - mx[r]) * c);
    m_run[r] = mx[r];
    mc[r] = mx[r] * c;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float e = ex2(fmaf(sc[i], c, -mc[(i >> 1) & 1]));
    sc[i] = e;
    ls[(i >> 1) & 1] += e;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// P (bf16) as the A fragments of the BN / 16 k16 steps of P V
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int c = 0; c < BN / 16; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[c][j] = pack_bf16(sc[8 * c + 2 * j], sc[8 * c + 2 * j + 1]);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap to, const Params p) {
  using L = Smem<HD>;
  constexpr int ST = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* os = smem + L::kOOff;
  // full: the producer's loads landed; empty: every consumer warp is done
  // with the tile (K after S = Q K^T, V after O += P V, Q after an item's
  // last S)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;
  auto k_stage = [&](int st) { return smem + L::kQ + st * 2 * L::kKV; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerThreads / 32);    // one arrive a warp
    for (int st = 0; st < ST; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], kConsumerThreads / 32);
      mbar_init(&v_empty[st], kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer warpgroup: one thread keeps Q and the K/V ring loaded
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kConsumerThreads) {
      int it = 0;    // KV tiles loaded so far, over all of this block's items
      int done = 0;  // items
      for (int n = 0; n * (int)gridDim.x < p.items; ++n) {
        const int t = walk(n, p);
        if (t < 0) continue;
        const Item w = item_at(t, p);
        const int kh = w.h / (p.h / p.kvh);       // the GQA head
        int j0, j1;
        kv_tiles(w.q0, p, j0, j1);
        if (done > 0) mbar_wait(q_empty, (done - 1) & 1);
        mbar_expect_tx(q_full, L::kQ);
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load_4d(qs + c * BM * 128, &tq, q_full, 64 * c, w.h, w.q0, w.b);
        for (int j = j0; j < j1; ++j, ++it) {
          const int st = it % ST;
          const uint32_t par = ((it / ST) - 1) & 1;
          uint8_t* ks = k_stage(st);
          uint8_t* vs = ks + L::kKV;
          if (it >= ST) mbar_wait(&k_empty[st], par);
          mbar_expect_tx(&k_full[st], L::kKV);
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load_4d(ks + c * BN * 128, &tk, &k_full[st], 64 * c, kh, j * BN,
                        w.b);
          if (it >= ST) mbar_wait(&v_empty[st], par);
          mbar_expect_tx(&v_full[st], L::kKV);
#pragma unroll
          for (int c = 0; c < L::kBoxes; ++c)
            tma_load_4d(vs + c * BN * 128, &tv, &v_full[st], 64 * c, kh, j * BN,
                        w.b);
        }
        ++done;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31;
    const bool leader = lane == 0;
    const uint32_t q_wg = smem_u32(qs) + wg * 64 * 128;  // its 64 Q rows
    uint8_t* o_wg = os + wg * L::kBoxes * 64 * 128;
    int it = 0;      // KV tiles consumed so far
    int done = 0;    // items
    for (int n = 0; n * (int)gridDim.x < p.items; ++n) {
      const int t = walk(n, p);
      if (t < 0) continue;
      const Item w = item_at(t, p);
      const int r0 = w.q0 + 64 * wg;                  // this warpgroup's rows
      const int row = r0 + 16 * warp + (lane >> 2);   // this thread's: +0, +8
      const int col = 2 * (lane & 3);                 // its first key in a tile
      int j0, j1;
      kv_tiles(w.q0, p, j0, j1);

      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m_run[2] = {kMask, kMask}, l_run[2] = {0.f, 0.f}, alpha[2];
      float sc[64];
      uint32_t pa[BN / 16][4];
      mbar_wait(q_full, done & 1);

      // S, the softmax and P V in turn; the other warpgroup's products run
      // on the tensor cores meanwhile.  At most O and S are live.
      for (int j = j0; j < j1; ++j, ++it) {
        const int st = it % ST;
        const uint32_t par = (it / ST) & 1;
        mbar_wait(&k_full[st], par);
        wgmma_fence();
        issue_qk<HD>(sc, q_wg, smem_u32(k_stage(st)));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (leader) {
          mbar_arrive(&k_empty[st]);
          if (j + 1 == j1) mbar_arrive(q_empty);
        }
        if (tile_needs_mask(r0, j * BN, p))
          mask_tile(sc, row, j * BN + col, p);
        softmax_tile(sc, m_run, l_run, alpha, p.c);
        rescale(o, alpha);
        pack_p(pa, sc);
        mbar_wait(&v_full[st], par);
        wgmma_fence();
        issue_pv<HD>(o, pa, smem_u32(k_stage(st) + L::kKV));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int c = 0; c < BN / 16; ++c) fence_regs(pa[c]);
        if (leader) mbar_arrive(&v_empty[st]);
      }

      // epilogue: o / max(l, 1e-30) in bf16 into this warpgroup's swizzled
      // O boxes, then one TMA store a box (rows >= S clipped)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        l_run[r] = fmaxf(l_run[r], 1e-30f);
      }
      if (wt == 0) tma_store_wait_read();     // the last item's store read O
      consumer_bar(wg);
#pragma unroll
      for (int i = 0; i < HD / 2; i += 2) {
        const int rr = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int cc = 8 * (i >> 2) + col;
        const uint32_t off = rr * 128 + (cc % 64) * 2;
        const uint32_t swz = off ^ (((off >> 7) & 7) << 4);
        *reinterpret_cast<uint32_t*>(o_wg + (cc / 64) * 64 * 128 + swz) =
            pack_bf16(o[i] / l_run[(i >> 1) & 1],
                      o[i + 1] / l_run[(i >> 1) & 1]);
      }
      fence_proxy_async();
      consumer_bar(wg);
      if (wt == 0 && r0 < p.s) {
#pragma unroll
        for (int c = 0; c < L::kBoxes; ++c)
          tma_store_4d(&to, o_wg + c * 64 * 128, 64 * c, w.h, r0, w.b);
        tma_store_commit();
      }
      ++done;
    }
    if (wt == 0) tma_store_wait();
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// 4-D map over a [B, S, heads, hd] bf16 array as stored, box {64, 1, rows,
// 1} with the 128-byte swizzle; out-of-bounds rows read as 0
bool encode(CUtensorMap* map, const void* ptr, int b, int s, int heads,
            int hd, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)s * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int h, int kvh, int causal, int window, cudaStream_t stream) {
  Params p;
  p.b = b;
  p.s = s;
  p.h = h;
  p.kvh = kvh;
  p.causal = causal != 0;
  p.window = window;
  p.tiles_m = (s + BM - 1) / BM;
  const long long items = (long long)b * h * p.tiles_m;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  p.c = (float)(kLog2e / sqrt((double)HD));
  CUtensorMap tq, tk, tv, to;
  memset(&tq, 0, sizeof(tq));
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  memset(&to, 0, sizeof(to));
  if (!encode(&tq, q, b, s, h, HD, BM) ||
      !encode(&tk, k, b, s, kvh, HD, BN) ||
      !encode(&tv, v, b, s, kvh, HD, BN) || !encode(&to, o, b, s, h, HD, 64))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<HD>::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  const int grid = (int)(items < sm_count() ? items : sm_count());
  flash_kernel<HD><<<grid, kThreads, Smem<HD>::kBytes, stream>>>(tq, tk, tv,
                                                                 to, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o [B,S,H,hd]; k, v [B,S,KV,hd]; all bf16, contiguous, 16-byte aligned.
// hd 64, 80 or 128; H % KV == 0; window 0 = none; causal 0/1.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int s, int h, int kvh, int hd,
                               int causal, int window, void* stream) {
  if (b < 0 || s < 0 || h <= 0 || kvh <= 0 || h % kvh || window < 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64) return launch<64>(q, k, v, o, b, s, h, kvh, causal, window, st);
  if (hd == 80) return launch<80>(q, k, v, o, b, s, h, kvh, causal, window, st);
  if (hd == 128)
    return launch<128>(q, k, v, o, b, s, h, kvh, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
