// Mamba2 SSD chunk scan for Hopper (sm_90a): bf16 x, dt, B, C; fp32
// decays, state, sums and output.
//
// Replaces src/repro/kernels/ssd.py::ssd_scan (_kernel).  Per (b, h), over
// chunks of Q = 128 steps, with dt <- softplus(dt), a = -exp(a_log[h]) and
// L the in-chunk inclusive cumulative sum of dt * a:
//   M = (C B^T) .* tril(exp(L_t - L_s)) .* dt_s
//   y = M x + exp(L_t) C h^T + D x
//   h <- exp(L_Q) h + x^T (cw .* B),   cw_s = exp(L_Q - L_s) dt_s
// The TPU kernel carries h in VMEM scratch across a sequential grid axis of
// chunks; here the chunk axis is a loop inside one block and h lives in the
// registers of the warpgroup that updates it.  h can start from h0 and the
// final state can be written to hT.
//
// Bound on the card: bytes.  x, dt, B and C are read once in bf16 and y is
// written once in fp32 (134 of the 204.5 MB of a 4 x 2048 call at 64 heads:
// 0.061 ms at 3.35 TB/s); the products take a fifth of that at the bf16
// tensor-core peak counted once, three fifths with the hi / lo pairs below.
//
// Design:
// - Tensor cores: all four products of a chunk run on wgmma, bf16 operands
//   and fp32 sums.  S = C B^T is m64n{64,128}k16 with C and B K-major as
//   TMA lands them (the first 64 rows need only s < 64: the upper-right
//   quadrant is masked).  M = S .* exp(L_t - L_s) .* dt_s is formed in the
//   accumulator's registers (make_m): below a row's diagonal 16-block the
//   exponent is factored at the block's last row r, exp(L_t - L_r) exp(L_r
//   - L_s), both factors at most 1 (the column one, times dt, computed once
//   a chunk by the producer); in the diagonal block it is taken per
//   element and the entries above the diagonal are selected away, never
//   multiplied by a mask (exp overflows there at a = -16; inf * 0 is NaN).
//   M x takes M from registers as the A fragment (as flash attention takes
//   P) and x N-major through the transpose bit.  C h^T takes h, which the
//   state's warpgroup writes K-major after each update.  The state update
//   takes x^T as the M-major A operand straight from the staged x and
//   cw .* B, formed in fp32, N-major.
// - Numerics: x, B and C are bf16 already and enter the tensor cores
//   exactly.  M, h and cw .* B are not: each is split into two bf16 terms,
//   hi = bf16(v) and lo = bf16(v - hi), and multiplied twice, which leaves
//   a relative error near 2^-16 a term instead of bf16's 2^-8 (one rounding
//   of M alone gives ~2e-3 norm-wise, past the 1e-4 the card's check holds
//   the kernel to; tests/test_torch_ssd_layout.py models both).  L is fp32,
//   in log2 units for ex2; the rows past T take L_Q exactly (see the
//   producer).
// - Loads: one producer warp keeps a two-stage ring of chunks: per chunk a
//   4-D TMA box of x over [B, T, H, P] and 3-D boxes of B and C over [B, T,
//   N], each through the caller's batch and time strides (the model's
//   slices of one projection, read in place), 128-byte swizzled.  The maps'
//   time extent is the call's T, so rows past T load as zeros.  The same
//   warp loads the chunk's 128 dt values, applies the softplus and masks
//   rows past T to 0 after it (softplus(0) = ln 2 would decay L across the
//   padding and change h), and writes L, dt, cw and the column factors
//   beside the stage before arming its full barrier.  Chunk c + 1 loads
//   while chunk c is computed.
// - Blocks: one per (b, h), 288 threads: two consumer warpgroups (chunk
//   rows 0-63 and 64-127) and the producer warp.  The first warpgroup has
//   the lighter triangle and owns h: its accumulator (fp32) is carried
//   across chunks, decayed by exp(L_Q) and accumulated into by the state
//   update, then split into the bf16 pair for the next chunk's C h^T.  Two
//   named barriers hand h over: the second warpgroup must have read h_{c-1}
//   before h_c overwrites it, and h_c must be written before it is read.
//   y is stored from the accumulator: a quad of lanes writes a full
//   32-byte sector of a row, rows past T are not stored.  Shared memory
//   (the x, B, C ring 96 KB; h pair 16 KB; cw .* B pair 32 KB; L, dt, cw,
//   column factors 4 KB) and registers (~160 a thread: the second
//   warpgroup's S, M pair and y) hold one block an SM: 256 blocks at 4 x
//   2048 run in two waves of 132 / 124, a 1 x 2048 request in one of 64.
//   Two blocks an SM would leave 112 registers a thread.
//
// Timed on an H100 at 4 x 2048 against each other and not kept: y through
// shared memory by TMA stores (a little slower than the direct stores); a
// third stage (no gain); exp(L_t - L_s) taken per element everywhere (no
// faster than the factored form, which takes a fifth of the ex2); hi taken
// by truncation rather than rounding (barely faster, larger errors).
// Per-chunk clock64 stamps of a throw-away instrumented copy put the
// consumers busy nearly all of each chunk, with their tensor-core,
// make_m, cw .* B and store phases overlapping poorly at one block an SM:
// removing any one of those phases shortened the call by a few percent at
// most (PERF.md, the SSD redesign's findings).
#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int Q = 128;                            // steps a chunk
constexpr int P = 64;                             // head size
constexpr int N = 64;                             // state size
constexpr int kStages = 2;                        // the x / B / C ring
constexpr int kSplit = 2;                         // bf16 terms: hi, lo
constexpr int kConsumerThreads = 256;             // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;   // + the producer warp
constexpr int kSmemMax = 232448;                  // a block's dynamic limit
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: the ring (per stage x, B, C: Q rows of 128 bytes each),
// the h pair (P rows), the cw .* B pair (Q rows), per stage L, dt, cw and
// colf (Q fp32 each), the barriers; tiles 1024-aligned, 128-byte swizzled
constexpr int kTile = Q * 128;
constexpr int kStage = 3 * kTile;
constexpr int kH = P * 128;
constexpr int kArr = 4 * Q * 4;
constexpr int kHOff = kStages * kStage;
constexpr int kCwbOff = kHOff + kSplit * kH;
constexpr int kArrOff = kCwbOff + kSplit * kTile;
constexpr int kBarOff = kArrOff + kStages * kArr;
constexpr int kBytes = kBarOff + 2 * kStages * 8 + 1024;  // + alignment
static_assert(kBytes <= kSmemMax, "ssd shared memory exceeds the limit");

struct Params {
  const bf16* dt;
  long long dsb, dst;
  const float* a_log;
  const float* d_skip;
  const float* h0;
  float* y;
  float* hT;
  int t, h, chunks;
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // logaddexp(x, 0)
}

// byte offset of (row, byte) in a tile of 128-byte rows, 128-byte swizzle
__device__ __forceinline__ uint32_t swz(uint32_t row, uint32_t byte) {
  const uint32_t off = row * 128 + byte;
  return off ^ (((off >> 7) & 7) << 4);
}

// the bf16 pair of (a, b): hi = bf16(v), lo = bf16(v - hi), packed two
// values a register (a in the low half)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(a - __low2float(h2), b - __high2float(h2));
}

// ---------------------------------------------------------------------------
// the m64nN accumulator: register i of thread (warp w, lane l) of a
// warpgroup holds row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (l % 4) + i % 2.  Registers 8c .. 8c+7 (columns 16c .. 16c+15) are, two
// to an A register, the A fragment of k16 step c (flash_attention.cu's
// pack_p).
// ---------------------------------------------------------------------------

// M of this warpgroup's 64 rows over the first 16 NS columns s, from S =
// C B^T, as the bf16 pair of A fragments of the NS k16 steps of M x.  arr:
// the stage's L (log2 units), dt and colf; row: this thread's first chunk
// row (the second is row + 8, in the same 16-row block cd).  Below the
// diagonal block, exp(L_t - L_s) = exp(L_t - L_r) exp(L_r - L_s) with r the
// last row of s's 16-column block: both factors are at most 1, the column
// one (times dt) is the producer's colf, the row one is one ex2 a (row,
// block).  In the diagonal block each exponent is taken per element and
// the entries above the diagonal are selected away (exp may be inf there;
// inf * 0 is NaN); the blocks above it are zeros.
template <int NS>
__device__ __forceinline__ void make_m(uint32_t (&mh)[NS][4],
                                       uint32_t (&ml)[NS][4],
                                       const float (&sc)[8 * NS],
                                       const float* arr, int row, int q4) {
  const int cd = row >> 4;
  const float lt[2] = {arr[row], arr[row + 8]};
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    if (c < cd) {
      float rf[2];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        rf[half] = ex2(lt[half] - arr[16 * c + 15]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float2 cf = *reinterpret_cast<const float2*>(
            arr + 3 * Q + 16 * c + 8 * jj + 2 * q4);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 8 * c + 4 * jj + 2 * half;
          split2(sc[i] * rf[half] * cf.x, sc[i + 1] * rf[half] * cf.y,
                 mh[c][half + 2 * jj], ml[c][half + 2 * jj]);
        }
      }
    } else if (c == cd) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int s = 16 * c + 8 * jj + 2 * q4;
        const float2 ls = *reinterpret_cast<const float2*>(arr + s);
        const float2 ds = *reinterpret_cast<const float2*>(arr + Q + s);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = row + 8 * half;
          const int i = 8 * c + 4 * jj + 2 * half;
          const float m0 = s <= t ? sc[i] * ex2(lt[half] - ls.x) * ds.x : 0.f;
          const float m1 =
              s + 1 <= t ? sc[i + 1] * ex2(lt[half] - ls.y) * ds.y : 0.f;
          split2(m0, m1, mh[c][half + 2 * jj], ml[c][half + 2 * jj]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) mh[c][j] = ml[c][j] = 0u;
    }
  }
}

// y *= exp(L_t): the decay of the carried state's term, row by row
__device__ __forceinline__ void scale_rows(float (&y)[32], const float* arr,
                                           int row) {
  const float e0 = ex2(arr[row]), e1 = ex2(arr[row + 8]);
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] *= ((i >> 1) & 1) ? e1 : e0;
}

// y + D x stored from the accumulator: each register pair is 8 bytes of a
// row, a quad of lanes a full 32-byte sector, rows past T not stored.
// xs: the stage's x tile; yrow: this thread's first row of y (the second
// is 8 rows on); r: its row in the warpgroup.
__device__ __forceinline__ void store_y(const float (&y)[32],
                                        const uint8_t* xs, float* yrow,
                                        long long ystride, float dsk, int wg,
                                        int r, int q4, int nrows) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int half = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * q4;
    const float2 xv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(
            xs + swz(64 * wg + r + 8 * half, col * 2)));
    if (r + 8 * half < nrows)
      *reinterpret_cast<float2*>(yrow + half * 8 * ystride + col) =
          make_float2(fmaf(dsk, xv.x, y[i]), fmaf(dsk, xv.y, y[i + 1]));
  }
}

// the state's warpgroup: h (fp32, register i at row p, column n of the
// accumulator) as the bf16 pair, K-major [p][n] at hs (hi) and hs + kH
// (lo), for C h^T; fenced for wgmma and the warpgroup synced
__device__ __forceinline__ void write_h(uint8_t* hs, const float (&hr)[32],
                                        int r, int q4) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int pp = r + 8 * ((i >> 1) & 1), n = 8 * (i >> 2) + 2 * q4;
    uint32_t hi, lo;
    split2(hr[i], hr[i + 1], hi, lo);
    *reinterpret_cast<uint32_t*>(hs + swz(pp, n * 2)) = hi;
    *reinterpret_cast<uint32_t*>(hs + kH + swz(pp, n * 2)) = lo;
  }
  fence_proxy_async();
  consumer_bar(0);
}

// this warp is done with the stage (its lanes' reads included)
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// the named barriers that hand h between the warpgroups (ids 1, 2 are
// consumer_bar's): h_{c-1} written and h_{c-1} read
constexpr int kHReady = 3, kHRead = 4;
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(kConsumerThreads)
               : "memory");
}
__device__ __forceinline__ void bar_wait(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(kConsumerThreads)
               : "memory");
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tb,
           const __grid_constant__ CUtensorMap tc, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // full: the chunk's tiles landed and its L, dt, cw are written; empty:
  // every consumer warp is done with the stage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  const int b = blockIdx.x / p.h, hh = blockIdx.x % p.h;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerThreads / 32);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // the producer warp: lane l takes steps 4l .. 4l+3 of each chunk
    const float a2 = -expf(p.a_log[hh]) * kLog2e;
    const bf16* dtb = p.dt + b * p.dsb + hh;
    for (int c = 0; c < p.chunks; ++c) {
      const int st = c % kStages, t0 = c * Q;
      float v[4], l[4], run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 4 * lane + e;
        // masked after the softplus: a padded row must not decay L
        v[e] = t < p.t ? softplus(__bfloat162float(dtb[(long long)t * p.dst]))
                       : 0.f;
        run += v[e] * a2;
        l[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e] += excl;
      // L_Q is L of the last row below T, and the rows past T take it
      // exactly: the scan sums their zeros in another order, and at |L| ~
      // 1e4 an ulp of difference is 1e-3 in exp(L_Q - L_s) of the row
      // that carries the most weight
      const int last = min(Q, p.t - t0) - 1, k = last & 3;
      const float lq = __shfl_sync(
          0xffffffffu, k == 0 ? l[0] : k == 1 ? l[1] : k == 2 ? l[2] : l[3],
          last >> 2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * lane + e > last) l[e] = lq;
      if (c >= kStages) mbar_wait(&empty[st], ((c / kStages) - 1) & 1);
      float* arr = reinterpret_cast<float*>(smem + kArrOff + st * kArr);
      *reinterpret_cast<float4*>(arr + 4 * lane) =
          make_float4(l[0], l[1], l[2], l[3]);
      *reinterpret_cast<float4*>(arr + Q + 4 * lane) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(arr + 2 * Q + 4 * lane) = make_float4(
          ex2(lq - l[0]) * v[0], ex2(lq - l[1]) * v[1], ex2(lq - l[2]) * v[2],
          ex2(lq - l[3]) * v[3]);
      // colf: exp(L_r - L_s) dt_s, r the last row of s's 16-row block (lane
      // l | 3's last step)
      const float lr = __shfl_sync(0xffffffffu, l[3], lane | 3);
      *reinterpret_cast<float4*>(arr + 3 * Q + 4 * lane) = make_float4(
          ex2(lr - l[0]) * v[0], ex2(lr - l[1]) * v[1], ex2(lr - l[2]) * v[2],
          ex2(lr - l[3]) * v[3]);
      __syncwarp();
      if (lane == 0) {
        uint8_t* xs = smem + st * kStage;
        mbar_expect_tx(&full[st], kStage);   // zero-filled bytes count too
        tma_load_4d(xs, &tx, &full[st], 0, hh, t0, b);
        tma_load(xs + kTile, &tb, &full[st], 0, t0, b);
        tma_load(xs + 2 * kTile, &tc, &full[st], 0, t0, b);
      }
    }
    return;
  }

  // a branch on a value ptxas can prove warp-uniform, around whole loops
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int wt = threadIdx.x & 127, warp = wt >> 5, q4 = lane & 3;
  const int r = 16 * warp + (lane >> 2);   // this thread's row in the wg
  const int row = 64 * wg + r;             // ... in the chunk (and + 8)
  const float dsk = p.d_skip[hh];
  // y rows of this thread: (b, t0 + row, h) and 8 rows on
  const long long ystride = (long long)p.h * P;
  float* ybase = p.y + ((long long)b * p.t + row) * ystride + (long long)hh * P;
  uint8_t* hs = smem + kHOff;
  const uint32_t hhi = smem_u32(hs), hlo = hhi + kH;
  float y[32];

  if (wg == 0) {
    // rows 0-63, and the state: h[p][n] in the accumulator layout (row p,
    // column n)
    const long long hbase = (long long)blockIdx.x * P * N;
    float hr[32];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int pp = r + 8 * ((i >> 1) & 1), n = 8 * (i >> 2) + 2 * q4;
      const float2 v = p.h0 ? *reinterpret_cast<const float2*>(
                                  p.h0 + hbase + pp * N + n)
                            : make_float2(0.f, 0.f);
      hr[i] = v.x;
      hr[i + 1] = v.y;
    }
    if (p.chunks > 0) {
      write_h(hs, hr, r, q4);
      bar_arrive(kHReady);
    }
    uint8_t* cwb = smem + kCwbOff;
    const uint32_t cwhi = smem_u32(cwb), cwlo = cwhi + kTile;
    for (int c = 0; c < p.chunks; ++c) {
      const int st = c % kStages, t0 = c * Q;
      uint8_t* xs = smem + st * kStage;
      const uint32_t xa = smem_u32(xs), ba = xa + kTile, ca = xa + 2 * kTile;
      const float* arr = reinterpret_cast<const float*>(smem + kArrOff +
                                                        st * kArr);
      mbar_wait(&full[st], (c / kStages) & 1);
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)   // S = C B^T, s < 64
        wgmma_ss<0, 0>(sc, sw128_desc(ca + kk * 32, 16, 1024),
                       sw128_desc(ba + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)   // y = C h_hi^T + C h_lo^T
        wgmma_ss<0, 0>(y, sw128_desc(ca + kk * 32, 16, 1024),
                       sw128_desc(hhi + kk * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<0, 0>(y, sw128_desc(ca + kk * 32, 16, 1024),
                       sw128_desc(hlo + kk * 32, 16, 1024), 1);
      wgmma_commit();
      // cw .* B as the bf16 pair, N-major [s][n] in B's own layout: thread
      // wt takes row s = wt, eight 16-byte chunks
      {
        const float w = arr[2 * Q + wt];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t off = swz(wt, 16 * k);
          const uint4 raw = *reinterpret_cast<const uint4*>(xs + kTile + off);
          const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&in[j]));
            split2(f.x * w, f.y * w, hi[j], lo[j]);
          }
          *reinterpret_cast<uint4*>(cwb + off) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(cwb + kTile + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
      fence_proxy_async();
      consumer_bar(0);
      // h <- exp(L_Q) h + x^T (cw B)_hi + x^T (cw B)_lo
      const float dec = ex2(arr[Q - 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) hr[i] *= dec;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const uint64_t da = sw128_desc(xa + kk * 2048, kTile, 1024);
        wgmma_ss<1, 1>(hr, da, sw128_desc(cwhi + kk * 2048, kTile, 1024), 1);
        wgmma_ss<1, 1>(hr, da, sw128_desc(cwlo + kk * 2048, kTile, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<2>();   // S
      fence_regs(sc);
      uint32_t mh[4][4], ml[4][4];
      make_m<4>(mh, ml, sc, arr, row, q4);
      wgmma_wait<1>();   // C h^T
      fence_regs(y);
      scale_rows(y, arr, row);
      wgmma_fence();
#pragma unroll
      for (int cs = 0; cs < 4; ++cs) {   // y += M_hi x + M_lo x, s < 64
        const uint64_t db = sw128_desc(xa + cs * 2048, kTile, 1024);
        wgmma_rs(y, mh[cs], db);
        wgmma_rs(y, ml[cs], db);
      }
      wgmma_commit();
      wgmma_wait<0>();   // the state update, M x
      fence_regs(hr);
      fence_regs(y);
#pragma unroll
      for (int cs = 0; cs < 4; ++cs) {
        fence_regs(mh[cs]);
        fence_regs(ml[cs]);
      }
      store_y(y, xs, ybase + (long long)t0 * ystride, ystride, dsk, 0, r,
              q4, p.t - t0);
      release(&empty[st], lane);
      bar_wait(kHRead);          // the other warpgroup has read h_{c-1}
      if (c + 1 < p.chunks) {
        write_h(hs, hr, r, q4);
        bar_arrive(kHReady);
      }
    }
    if (p.hT) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int pp = r + 8 * ((i >> 1) & 1), n = 8 * (i >> 2) + 2 * q4;
        *reinterpret_cast<float2*>(p.hT + hbase + pp * N + n) =
            make_float2(hr[i], hr[i + 1]);
      }
    }
  } else {
    // rows 64-127: s over the whole chunk
    for (int c = 0; c < p.chunks; ++c) {
      const int st = c % kStages, t0 = c * Q;
      uint8_t* xs = smem + st * kStage;
      const uint32_t xa = smem_u32(xs), ba = xa + kTile;
      const uint32_t ca = xa + 2 * kTile + 64 * 128;   // C rows 64-127
      const float* arr = reinterpret_cast<const float*>(smem + kArrOff +
                                                        st * kArr);
      mbar_wait(&full[st], (c / kStages) & 1);
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)   // S = C B^T
        wgmma_ss<0, 0>(sc, sw128_desc(ca + kk * 32, 16, 1024),
                       sw128_desc(ba + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
      bar_wait(kHReady);                    // h_{c-1} is written
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<0, 0>(y, sw128_desc(ca + kk * 32, 16, 1024),
                       sw128_desc(hhi + kk * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<0, 0>(y, sw128_desc(ca + kk * 32, 16, 1024),
                       sw128_desc(hlo + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();   // S
      fence_regs(sc);
      uint32_t mh[8][4], ml[8][4];
      make_m<8>(mh, ml, sc, arr, row, q4);
      wgmma_wait<0>();   // C h^T: h_{c-1} may be overwritten
      fence_regs(y);
      bar_arrive(kHRead);
      scale_rows(y, arr, row);
      wgmma_fence();
#pragma unroll
      for (int cs = 0; cs < 8; ++cs) {
        const uint64_t db = sw128_desc(xa + cs * 2048, kTile, 1024);
        wgmma_rs(y, mh[cs], db);
        wgmma_rs(y, ml[cs], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
#pragma unroll
      for (int cs = 0; cs < 8; ++cs) {
        fence_regs(mh[cs]);
        fence_regs(ml[cs]);
      }
      store_y(y, xs, ybase + (long long)t0 * ystride, ystride, dsk, 1, r,
              q4, p.t - t0 - 64);
      release(&empty[st], lane);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// a rank-D tensor map, dims[0] innermost and contiguous, strides[i] the
// bytes between steps of dim i + 1; 128-byte swizzle; out-of-bounds
// elements load as 0 and are not stored
bool encode(CUtensorMap* map, const void* ptr, bool is_bf16, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            rank, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: [b, t, h, P] bf16 at batch / time strides xsb / xst (elements; the
// [h, P] part contiguous); dt: [b, t, h] bf16 at dsb / dst; b_, c_:
// [b, t, N] bf16 at bsb / bst and csb / cst; a_log, d_skip: [h] fp32;
// h0: [b, h, P, N] fp32 or null (zeros); y: [b, t, h, P] fp32 contiguous;
// hT: [b, h, P, N] fp32 or null.  x, b_ and c_ are read by TMA: their
// bases and batch and time strides in bytes are multiples of 16.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a_log,
                        const void* b_, const void* c_, const void* d_skip,
                        const void* h0, void* y, void* hT, int b, int t,
                        int h, int p, int n, long long xsb, long long xst,
                        long long dsb, long long dst, long long bsb,
                        long long bst, long long csb, long long cst,
                        void* stream) {
  if (b < 0 || t < 0 || h < 0 || p != P || n != N)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  CUtensorMap mx, mb, mc;
  memset(&mx, 0, sizeof(mx));
  memset(&mb, 0, sizeof(mb));
  memset(&mc, 0, sizeof(mc));
  if (t > 0) {   // no chunk reads a map at t = 0
    const cuuint64_t xd[4] = {(cuuint64_t)P, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
    const cuuint64_t xs[3] = {(cuuint64_t)P * 2, (cuuint64_t)xst * 2,
                              (cuuint64_t)xsb * 2};
    const cuuint32_t xbox[4] = {64, 1, Q, 1};
    const cuuint64_t nd[3] = {(cuuint64_t)N, (cuuint64_t)t, (cuuint64_t)b};
    const cuuint64_t bs[2] = {(cuuint64_t)bst * 2, (cuuint64_t)bsb * 2};
    const cuuint64_t cs[2] = {(cuuint64_t)cst * 2, (cuuint64_t)csb * 2};
    const cuuint32_t nbox[3] = {64, Q, 1};
    if (!encode(&mx, x, true, 4, xd, xs, xbox) ||
        !encode(&mb, b_, true, 3, nd, bs, nbox) ||
        !encode(&mc, c_, true, 3, nd, cs, nbox))
      return (int)cudaErrorInvalidValue;
  }
  Params prm;
  prm.dt = (const __nv_bfloat16*)dt;
  prm.dsb = dsb;
  prm.dst = dst;
  prm.a_log = (const float*)a_log;
  prm.d_skip = (const float*)d_skip;
  prm.h0 = (const float*)h0;
  prm.y = (float*)y;
  prm.hT = (float*)hT;
  prm.t = t;
  prm.h = h;
  prm.chunks = (t + Q - 1) / Q;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return (int)attr;
  ssd_kernel<<<b * h, kThreads, kBytes, (cudaStream_t)stream>>>(mx, mb, mc,
                                                               prm);
  return (int)cudaGetLastError();
}
