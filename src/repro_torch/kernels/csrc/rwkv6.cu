// RWKV6 WKV recurrence for Hopper (sm_90a): bf16 r, k, v, fp32 log decay
// w, fp32 state, sums and output.
//
// Replaces src/repro/kernels/rwkv6.py::rwkv6_wkv (_kernel).  Per (b, h),
// with S the [hd, hd] state (row i: key channel, column j: value channel):
//   y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//   S      <- exp(w_t)[:, None] * S + k_t (x) v_t
// The TPU kernel carries S in VMEM scratch across a sequential grid axis of
// chunks and starts it at zero; here the chunk axis is a loop inside one
// block, S can start from an initial state s0 and the final state can be
// written to sT (the model's decode step runs T = 1 from the cached state).
//
// Bound on the card: bytes.  r, k, v are read once in bf16, w once and y
// written once in fp32 (235 MB at 4 x 2048 x 32 heads: 0.0701 ms at 3.35
// TB/s).  The function's 5 hd^2 + 6 hd operations a step of a head take
// 0.0816 ms at the fp32 rate of 67 TFLOP/s and a tenth of the byte time at
// the bf16 tensor-core peak; with the hi / lo pairs below about a third.
//
// Design (T >= Q; a shorter T runs the step loop of wkv_step_kernel):
// - The chunked form (the reference's models/rwkv.py::wkv_chunked).  In a
//   chunk of Q = 64 steps, with W_t the inclusive sum of w over the chunk
//   (W_-1 = 0) and S_0 the state entering it,
//     y_t = (r_t .* e^W_{t-1}) S_0 + sum_{s<t} A[t, s] v_s + (r_t . u k_t) v_t
//     A[t, s] = sum_i r_t[i] k_s[i] e^(W_{t-1}[i] - W_s[i])
//     S <- e^W_{Q-1} .* S_0 + sum_s (k_s .* e^(W_{Q-1} - W_s)) v_s^T
//   The decay is per channel, inside the sum of A, so it cannot be applied
//   to A after a product (as ssd.cu's scalar decay is): both operands are
//   scaled before it, around a reference point between s and t - 1 that
//   keeps both factors at most 1.  Such a point exists for a pair of
//   sub-chunks of kSub = 16 steps (one consumer warp's rows each): for
//   t in sub-chunk a and s in sub-chunk c < a,
//     A[t, s] = (r_t .* E_t .* prod_{c<g<a} G_g) . (k_s .* D_s)
//   with E_t the decay from the start of t's sub-chunk to t - 1, D_s the
//   decay from s + 1 to the end of its sub-chunk and G_g a sub-chunk's
//   whole decay: all products of x = e^w, all at most 1.  The row factor
//   depends on the pair (a, c), so the scores of column block c are their
//   own m64n16 product with A from registers (each warp scales its own
//   rows; warps a <= c supply zeros).  In the diagonal blocks (s < t in
//   one sub-chunk) no such point exists: e^(+-W) within 16 steps overflows
//   under the decays of a trained model (several units a step), so each
//   warp forms its 120 entries on the CUDA cores as a chain, k_s times x
//   of each step passed (a product, never an exponent of a difference;
//   diag_chains: a lane carries 4 values of s over 8 channels, so a step
//   reads 64 bytes of r and x a lane, and the sums meet in a butterfly).
// - Products, all on wgmma with fp32 sums: y = R S_0 (R = r .* E .* the
//   decay from the chunk's start to the sub-chunk's, A from registers, S
//   N-major from shared memory); the scores; y += A V (A from the scores'
//   accumulators and the diagonal chains, V N-major through the transpose
//   bit); S <- e^W_{Q-1} .* S + K'^T V (K' = k .* D .* the later
//   sub-chunks' G, M-major from shared memory).
// - Numerics: r, k and v are bf16 and enter the tensor cores exactly; R,
//   the scaled k, the scores A and S are not, and each is split into two
//   bf16 terms, hi = bf16(v) and lo = bf16(v - hi): a product of two such
//   operands takes three wgmma (hi hi, hi lo, lo hi), of one and a bf16
//   operand two.  One bf16 rounding of the scaled operands gives ~2e-3
//   norm-wise, past the 1e-4 the card's check holds the kernel to
//   (tests/test_torch_wkv_layout.py models both).  Every decay is a
//   product of x = expf(w) (one a step and channel, 4096 a chunk), never
//   an exponent of a difference of sums: the rows past T take x = 1
//   exactly (selected), so they leave every product, and S, exactly as
//   the last row below T left it.  expf, not ex2.approx: under a weak
//   decay (-1e-4 a step) S carries 2048 steps' products, and ex2's error
//   compounded to 2.1e-5 norm-wise at 4 x 2048 (6.5e-6 with expf).  S is
//   fp32 in the accumulator across chunks.
// - Loads: a two-stage ring of chunks: 4-D TMA boxes of r, k, v (bf16,
//   128-byte swizzled) and w (fp32, unswizzled) over [B, T, H, hd]; rows
//   past T load as zeros.  Thread 0 loads chunk c + 2 once every warp is
//   done with chunk c's stage (no producer warp: a ninth warp would put
//   three on one SM quarter and cap a thread at 168 registers, where
//   ptxas serializes the wgmma).
// - Blocks: one per (b, h), 256 threads, two warpgroups; ~193 KB of shared
//   memory, one block an SM (128 blocks at 4 x 2048 x 32 heads).  Warp a
//   of each warpgroup takes sub-chunk a's rows.  Per chunk the helper
//   warpgroup forms the decays (x, E, G, D) and the scaled operands into
//   shared memory, then the diagonal blocks while the products warpgroup
//   issues R S_0, the state update and the scores on the tensor cores;
//   the products warpgroup then multiplies A V and stores y from the
//   accumulator (rows past T not stored) while the helper prepares the
//   next chunk.
// Tried on an H100 at 4 x 2048 and not kept (throw-away builds, each timed
// against the one before it in one call; PERF.md has the committed runs):
// - one warpgroup doing everything (0.307 ms in chip_smoke.py with the
//   chains a lane one s over 32 channels: they read r and x 16 times over
//   and took about half of a chunk's cycles; four s over 8 channels cut
//   that by nearly half);
// - the two warpgroups sharing the decays and the chains (no faster: 232
//   registers, and ptxas waits on the wgmma);
// - the shared-memory base cast through an integer (every access
//   generic: slower);
// - a producer warp (nine warps put three on one SM quarter, a thread gets
//   168 registers and ptxas serializes the wgmma: slower);
// - the independent accumulators' k16 chains issued interleaved (no gain);
// - the helper running a chunk ahead with two chunks' r .* E, x, G and
//   diagonal blocks, the products warpgroup forming k .* D and K' (no
//   gain: a chunk moves ~460 KB through shared memory, ~3.6k cycles at
//   128 bytes a cycle, and the warpgroups share each scheduler);
// - ex2.approx for x instead of expf (a little faster, but 2.1e-5
//   norm-wise under the weak decay in chip_smoke.py instead of 6.5e-6).
// Removing any one part of the kept design (the chains, the expf, two
// thirds of the score products) saved only a small share each: a chunk's
// time is a chain of dependent phases through all of them, at one or two
// warps a scheduler.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;                            // head size
constexpr int Q = 64;                             // steps a chunk
constexpr int kSub = 16;                          // steps a sub-chunk
constexpr int kStages = 2;                        // the r / k / v / w ring
constexpr int kSplit = 2;                         // bf16 terms: hi, lo
constexpr int kThreads = 256;                     // two warpgroups
constexpr int kSmemMax = 232448;                  // a block's dynamic limit
constexpr int kRow = HD + 8;                      // padded fp32 row (floats)

// shared memory: the ring (per stage r, k, v: Q rows of 128 bytes, 128-byte
// swizzled; w: Q rows of HD fp32), the pairs of k .* D, K' and S (64 rows
// of 128 bytes each, swizzled), the fp32 tiles r .* E, r and x (padded
// rows), the warps' diagonal blocks, G, the row factors, e^W_{Q-1}, u, the
// barriers; tiles 1024-aligned
constexpr int kTile = Q * 128;
constexpr int kWTile = Q * HD * 4;
constexpr int kStage = 3 * kTile + kWTile;
constexpr int kKtOff = kStages * kStage;
constexpr int kKpOff = kKtOff + kSplit * kTile;
constexpr int kStOff = kKpOff + kSplit * kTile;
constexpr int kF32 = Q * kRow * 4;
constexpr int kReOff = kStOff + kSplit * kTile;
constexpr int kRfOff = kReOff + kF32;
constexpr int kXfOff = kRfOff + kF32;
constexpr int kAdOff = kXfOff + kF32;
constexpr int kGOff = kAdOff + (Q / kSub) * kSub * kSub * 4;
constexpr int kFOff = kGOff + (Q / kSub) * HD * 4;
constexpr int kGtOff = kFOff + (Q / kSub) * (Q / kSub) * HD * 4;
constexpr int kUOff = kGtOff + HD * 4;
constexpr int kBarOff = kUOff + HD * 4;
constexpr int kBytes = kBarOff + 2 * kStages * 8 + 1024;  // + alignment
static_assert(kBytes <= kSmemMax, "wkv shared memory exceeds the limit");
static_assert(Q / kSub == kThreads / 64,
              "a warp of each warpgroup a sub-chunk");

struct Params {
  const float* u;
  const float* s0;
  float* y;
  float* sT;
  int t, h, chunks;
};

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

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// d[64 x 16] += a[64 x 16] (registers: the A fragment) . b[16 x 16]
// (K-major in shared memory)
__device__ __forceinline__ void wgmma_rs16(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the A fragments (bf16 pair) of the 64 x HD operand re .* f (f: a factor
// a channel), k16 step kk in [kk]: register j of this thread holds row
// row0 + 8 (j % 2), channels 16 kk + 8 (j / 2) + 2 q4 (+1)
__device__ __forceinline__ void build_frag(uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4],
                                           const float* re, const float* f,
                                           int row0, int q4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int ch = 16 * kk + 8 * jh + 2 * q4;
      const float2 fv = *reinterpret_cast<const float2*>(f + ch);
#pragma unroll
      for (int jr = 0; jr < 2; ++jr) {
        const float2 v = *reinterpret_cast<const float2*>(
            re + (row0 + 8 * jr) * kRow + ch);
        split2(v.x * fv.x, v.y * fv.y, hi[kk][jr + 2 * jh],
               lo[kk][jr + 2 * jh]);
      }
    }
  }
}

// S (fp32, register i at row i, column j of the accumulator) as the bf16
// pair, N-major [i][j] at ss (hi) and ss + kTile (lo), for R S
__device__ __forceinline__ void write_s(uint8_t* ss, const float (&s)[32],
                                        int row0, int q4) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int ri = row0 + 8 * ((i >> 1) & 1), cj = 8 * (i >> 2) + 2 * q4;
    uint32_t hi, lo;
    split2(s[i], s[i + 1], hi, lo);
    *reinterpret_cast<uint32_t*>(ss + swz(ri, cj * 2)) = hi;
    *reinterpret_cast<uint32_t*>(ss + kTile + swz(ri, cj * 2)) = lo;
  }
}

// an accumulator's registers set to 0 one by one: zeros the compiler may
// not merge into copies of one register (a copy read while a wgmma writes
// that register makes ptxas wait for the wgmma)
template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("mov.b32 %0, 0;" : "=f"(d[i]));
}

template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(a[i]);
}

// the named barrier of the block's two warpgroups
__device__ __forceinline__ void all_bar() {
  asm volatile("bar.sync 3, %0;" :: "r"(kThreads) : "memory");
}

// the butterfly over the 8 lanes of one s-group (lane bits 2-4) of four
// partial sums d[0..3]: the lane ends with the whole sum of d[j], j = 2 b4
// + b3 (b4, b3: lane bits 4 and 3), as does the lane one bit 2 apart
__device__ __forceinline__ float reduce4(const float (&d)[4], int lane) {
  const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1;
  const float k0 = b4 ? d[2] : d[0], s0 = b4 ? d[0] : d[2];
  const float k1 = b4 ? d[3] : d[1], s1 = b4 ? d[1] : d[3];
  const float e0 = k0 + __shfl_xor_sync(0xffffffffu, s0, 16);
  const float e1 = k1 + __shfl_xor_sync(0xffffffffu, s1, 16);
  const float f = (b3 ? e1 : e0) + __shfl_xor_sync(0xffffffffu, b3 ? e0 : e1,
                                                   8);
  return f + __shfl_xor_sync(0xffffffffu, f, 4);
}

// one sub-chunk's diagonal block: ad[t][s] = sum_i r_t[i] k_s[i] x_{s+1}[i]
// .. x_{t-1}[i] for s < t, the bonus r_s . u k_s for t = s, 0 above.  Lane
// (sg = lane % 4, cg = lane / 4) carries k_s of s = sg + 4 j (j < 4) over
// channels 8 cg .. 8 cg + 7, times x of each step passed (a product: no
// exponent of a difference, nothing that overflows); row t's partial dots
// are summed over the channel groups by reduce4.  Which (t, j) can have
// s_j < t is known at compile time (s_j <= 4 j + 3), so the empty triangle
// is skipped and only t in (4 j, 4 j + 3] selects per lane.
__device__ __forceinline__ void diag_chains(float* ad, const uint8_t* ks,
                                            const float* rf, const float* xf,
                                            const float* us, int warp,
                                            int lane) {
  const int sg = lane & 3, cg = lane >> 2;
  const int sl = sg + 4 * (2 * ((lane >> 4) & 1) + ((lane >> 3) & 1));
  const float* rw = rf + 16 * warp * kRow + 8 * cg;
  const float* xw = xf + 16 * warp * kRow + 8 * cg;
  float acc[4][8];
  float d[4];
  {
    const float4 u0 = *reinterpret_cast<const float4*>(us + 8 * cg);
    const float4 u1 = *reinterpret_cast<const float4*>(us + 8 * cg + 4);
    const float uu[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = sg + 4 * j;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          ks + swz(16 * warp + s, 16 * cg));
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 f = bf2(in[m]);
        acc[j][2 * m] = f.x;
        acc[j][2 * m + 1] = f.y;
      }
      const float4 r0 = *reinterpret_cast<const float4*>(rw + s * kRow);
      const float4 r1 = *reinterpret_cast<const float4*>(rw + s * kRow + 4);
      const float rr[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
      d[j] = 0.f;
#pragma unroll
      for (int ch = 0; ch < 8; ++ch)
        d[j] = fmaf(rr[ch] * uu[ch], acc[j][ch], d[j]);
    }
  }
  const float bonus = reduce4(d, lane);   // of s = sl
  // this lane's column sl of the block, stored after the loop (a store in
  // it would hold the next step's loads behind it)
  float out[kSub];
  out[0] = sl == 0 ? bonus : 0.f;
#pragma unroll
  for (int t = 1; t < kSub; ++t) {
    const float4 r0 = *reinterpret_cast<const float4*>(rw + t * kRow);
    const float4 r1 = *reinterpret_cast<const float4*>(rw + t * kRow + 4);
    const float rr[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d[j] = 0.f;
      if (4 * j < t) {   // some lane's s_j < t
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) d[j] = fmaf(rr[ch], acc[j][ch], d[j]);
      }
    }
    const float dot = reduce4(d, lane);
    out[t] = t > sl ? dot : (t == sl ? bonus : 0.f);
    if (t + 1 < kSub) {   // k_s times x_t for the rows after t
      const float4 x0 = *reinterpret_cast<const float4*>(xw + t * kRow);
      const float4 x1 = *reinterpret_cast<const float4*>(xw + t * kRow + 4);
      const float xx[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * j + 3 < t) {          // every lane's s_j < t
#pragma unroll
          for (int ch = 0; ch < 8; ++ch) acc[j][ch] *= xx[ch];
        } else if (4 * j < t) {       // the lanes whose s_j < t
          const bool on = sg + 4 * j < t;
#pragma unroll
          for (int ch = 0; ch < 8; ++ch)
            acc[j][ch] = on ? acc[j][ch] * xx[ch] : acc[j][ch];
        }
      }
    }
  }
  if (((lane >> 2) & 1) == 0) {
#pragma unroll
    for (int t = 0; t < kSub; ++t) ad[t * kSub + sl] = out[t];
  }
}

// ---------------------------------------------------------------------------
// the chunked kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
wkv_chunk_kernel(const __grid_constant__ CUtensorMap tr,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tw, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-aligned by an offset into the array, which keeps every access a
  // shared-memory one (an address cast through an integer is generic)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // full: the chunk's tiles landed; empty: every warp is done with the
  // stage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  const int b = blockIdx.x / p.h, hh = blockIdx.x % p.h;
  const int lane = threadIdx.x & 31;
  float* us = reinterpret_cast<float*>(smem + kUOff);

  // thread 0 keeps the ring full: chunks 0 and 1 now, chunk c + kStages
  // once every warp is done with chunk c's stage
  auto load = [&](int c) {
    const int st = c % kStages;
    uint8_t* base = smem + st * kStage;
    mbar_expect_tx(&full[st], kStage);   // zero-filled bytes count too
    tma_load_4d(base, &tr, &full[st], 0, hh, c * Q, b);
    tma_load_4d(base + kTile, &tk, &full[st], 0, hh, c * Q, b);
    tma_load_4d(base + 2 * kTile, &tv, &full[st], 0, hh, c * Q, b);
    tma_load_4d(base + 3 * kTile, &tw, &full[st], 0, hh, c * Q, b);
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kThreads / 32);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < kStages && c < p.chunks; ++c) load(c);
  }
  if (threadIdx.x < HD) us[threadIdx.x] = p.u[hh * HD + threadIdx.x];
  __syncthreads();

  // values ptxas can prove warp-uniform: the warpgroup (0: the products,
  // 1: the helper), the warp in it and its sub-chunk
  const int wg = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  const int warp = __shfl_sync(0xffffffffu, (int)((threadIdx.x >> 5) & 3), 0);
  const int q4 = lane & 3;
  const int row0 = 16 * warp + (lane >> 2);   // accumulator rows: + 0, 8
  float* re = reinterpret_cast<float*>(smem + kReOff);
  float* rf = reinterpret_cast<float*>(smem + kRfOff);
  float* xf = reinterpret_cast<float*>(smem + kXfOff);
  float* ad = reinterpret_cast<float*>(smem + kAdOff) + warp * kSub * kSub;
  float* gs = reinterpret_cast<float*>(smem + kGOff);
  float* fw = reinterpret_cast<float*>(smem + kFOff) + warp * 4 * HD;
  float* gt = reinterpret_cast<float*>(smem + kGtOff);
  uint8_t* kt = smem + kKtOff;
  uint8_t* kp = smem + kKpOff;
  uint8_t* ss = smem + kStOff;
  const uint32_t kta = smem_u32(kt), kpa = smem_u32(kp), ssa = smem_u32(ss);
  const long long ystride = (long long)p.h * HD;
  float* ybase = p.y + (long long)b * p.t * ystride + (long long)hh * HD;

  // S[i][j] in the first warpgroup's accumulator layout: register i at row
  // row0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 q4 + i % 2
  const long long sbase = (long long)blockIdx.x * HD * HD;
  float S[32];
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int ri = row0 + 8 * ((i >> 1) & 1), cj = 8 * (i >> 2) + 2 * q4;
      const float2 v = p.s0 ? *reinterpret_cast<const float2*>(
                                  p.s0 + sbase + ri * HD + cj)
                            : make_float2(0.f, 0.f);
      S[i] = v.x;
      S[i + 1] = v.y;
    }
    write_s(ss, S, row0, q4);
    fence_proxy_async();
  }

  for (int c = 0; c < p.chunks; ++c) {
    const int st = c % kStages, t0 = c * Q, nrows = min(Q, p.t - t0);
    const uint8_t* rs = smem + st * kStage;
    const uint8_t* ks = rs + kTile;
    const uint32_t va = smem_u32(rs + 2 * kTile);
    const float* ws = reinterpret_cast<const float*>(rs + 3 * kTile);
    mbar_wait(&full[st], (c / kStages) & 1);

    if (wg == 1) {
      // the helper warpgroup.  1. this warp's sub-chunk, channels 2 lane
      // and 2 lane + 1: x = e^w (1 past T), E (the decay from the
      // sub-chunk's start to t - 1) into r .* E, r and x; G the
      // sub-chunk's whole decay
      float2 x[kSub], rv[kSub];
#pragma unroll
      for (int tau = 0; tau < kSub; ++tau) {   // loads first, then stores
        const int t = 16 * warp + tau;
        const float2 wv = *reinterpret_cast<const float2*>(ws + t * HD +
                                                           2 * lane);
        x[tau] = t < nrows ? make_float2(expf(wv.x), expf(wv.y))
                           : make_float2(1.f, 1.f);
        rv[tau] =
            bf2(*reinterpret_cast<const uint32_t*>(rs + swz(t, 4 * lane)));
      }
      float2 e = make_float2(1.f, 1.f);
#pragma unroll
      for (int tau = 0; tau < kSub; ++tau) {
        const int t = 16 * warp + tau;
        *reinterpret_cast<float2*>(rf + t * kRow + 2 * lane) = rv[tau];
        *reinterpret_cast<float2*>(re + t * kRow + 2 * lane) =
            make_float2(rv[tau].x * e.x, rv[tau].y * e.y);
        *reinterpret_cast<float2*>(xf + t * kRow + 2 * lane) = x[tau];
        e = make_float2(e.x * x[tau].x, e.y * x[tau].y);
      }
      *reinterpret_cast<float2*>(gs + warp * HD + 2 * lane) = e;
      consumer_bar(1);

      // 2. from every sub-chunk's G: this warp's row factors (set 0: the
      // decay from the chunk's start, for R S_0; set 1 + cb: the decay
      // between column block cb's end and this sub-chunk's start, 0 where
      // cb >= warp), the later sub-chunks' decay (for K'), e^W_{Q-1}; then
      // k .* D (D: the decay from s + 1 to the sub-chunk's end) and K' =
      // k .* D .* later, each as its bf16 pair, [s][i] swizzled
      float2 g[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        g[gi] = *reinterpret_cast<const float2*>(gs + gi * HD + 2 * lane);
#pragma unroll
      for (int cb = -1; cb < 3; ++cb) {
        float2 f = make_float2(1.f, 1.f);
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
          if (gi > cb && gi < warp)
            f = make_float2(f.x * g[gi].x, f.y * g[gi].y);
        *reinterpret_cast<float2*>(fw + (cb + 1) * HD + 2 * lane) =
            cb < warp ? f : make_float2(0.f, 0.f);
      }
      float2 later = make_float2(1.f, 1.f), all = make_float2(1.f, 1.f);
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        if (gi > warp)
          later = make_float2(later.x * g[gi].x, later.y * g[gi].y);
        all = make_float2(all.x * g[gi].x, all.y * g[gi].y);
      }
      if (warp == 0) *reinterpret_cast<float2*>(gt + 2 * lane) = all;
      float2 kv[kSub];
#pragma unroll
      for (int tau = 0; tau < kSub; ++tau)
        kv[tau] = bf2(*reinterpret_cast<const uint32_t*>(
            ks + swz(16 * warp + tau, 4 * lane)));
      float2 dd = make_float2(1.f, 1.f);
#pragma unroll
      for (int tau = kSub - 1; tau >= 0; --tau) {
        const uint32_t off = swz(16 * warp + tau, 4 * lane);
        const float2 kd = make_float2(kv[tau].x * dd.x, kv[tau].y * dd.y);
        uint32_t hi, lo;
        split2(kd.x, kd.y, hi, lo);
        *reinterpret_cast<uint32_t*>(kt + off) = hi;
        *reinterpret_cast<uint32_t*>(kt + kTile + off) = lo;
        split2(kd.x * later.x, kd.y * later.y, hi, lo);
        *reinterpret_cast<uint32_t*>(kp + off) = hi;
        *reinterpret_cast<uint32_t*>(kp + kTile + off) = lo;
        dd = make_float2(dd.x * x[tau].x, dd.y * x[tau].y);
      }
      fence_proxy_async();
      all_bar();   // the chunk's operands are in shared memory

      // 3. the diagonal blocks, while the other warpgroup multiplies; then
      // the stage is done with
      diag_chains(ad, ks, rf, xf, us, warp, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      all_bar();   // the diagonal blocks are in ad
      continue;
    }

    all_bar();   // the chunk's operands are in shared memory

    // the products warpgroup.  4. y = R S_0 (three products of the pairs)
    // and S <- e^W_{Q-1} .* S + K'^T V (two: V is bf16)
    uint32_t ah[4][4], al[4][4];
    build_frag(ah, al, re, fw, row0, q4);
    float y[32];
    zero_acc(y);
    {
      const float g0 = gt[row0], g1 = gt[row0 + 8];
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] *= ((i >> 1) & 1) ? g1 : g0;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = sw128_desc(ssa + kk * 2048, kTile, 1024);
      const uint64_t dl = sw128_desc(ssa + kTile + kk * 2048, kTile, 1024);
      wgmma_rs(y, ah[kk], dh);
      wgmma_rs(y, ah[kk], dl);
      wgmma_rs(y, al[kk], dh);
    }
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      const uint64_t db = sw128_desc(va + kk * 2048, kTile, 1024);
      wgmma_ss<1, 1>(S, sw128_desc(kpa + kk * 2048, kTile, 1024), db, 1);
      wgmma_ss<1, 1>(S, sw128_desc(kpa + kTile + kk * 2048, kTile, 1024), db,
                     1);
    }
    wgmma_commit();

    // 5. the scores of column blocks 0-2 (rows of later sub-chunks): (r .*
    // E .* the factor of the pair) . (k .* D), three products of the pairs
    float sc0[8], sc1[8], sc2[8];
    zero_acc(sc0);
    zero_acc(sc1);
    zero_acc(sc2);
    uint32_t bh[4][4], bl[4][4];
    build_frag(bh, bl, re, fw + HD, row0, q4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = sw128_desc(kta + kk * 32, 16, 1024);
      const uint64_t dl = sw128_desc(kta + kTile + kk * 32, 16, 1024);
      wgmma_rs16(sc0, bh[kk], dh);
      wgmma_rs16(sc0, bh[kk], dl);
      wgmma_rs16(sc0, bl[kk], dh);
    }
    wgmma_commit();

    wgmma_wait<1>();   // R S_0 and the state update
    fence_regs(y);
    fence_regs(S);
    fence_frag(ah);
    fence_frag(al);
    // S_{c+1} for the next chunk's R S (R S_c has read S_c)
    if (c + 1 < p.chunks) {
      write_s(ss, S, row0, q4);
      fence_proxy_async();
    }
    build_frag(ah, al, re, fw + 2 * HD, row0, q4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = sw128_desc(kta + 2048 + kk * 32, 16, 1024);
      const uint64_t dl = sw128_desc(kta + kTile + 2048 + kk * 32, 16, 1024);
      wgmma_rs16(sc1, ah[kk], dh);
      wgmma_rs16(sc1, ah[kk], dl);
      wgmma_rs16(sc1, al[kk], dh);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc0);
    fence_frag(bh);
    fence_frag(bl);
    build_frag(bh, bl, re, fw + 3 * HD, row0, q4);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = sw128_desc(kta + 4096 + kk * 32, 16, 1024);
      const uint64_t dl = sw128_desc(kta + kTile + 4096 + kk * 32, 16, 1024);
      wgmma_rs16(sc2, bh[kk], dh);
      wgmma_rs16(sc2, bh[kk], dl);
      wgmma_rs16(sc2, bl[kk], dh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc1);
    fence_regs(sc2);
    fence_frag(ah);
    fence_frag(al);
    fence_frag(bh);
    fence_frag(bl);
    all_bar();   // the diagonal blocks are in ad

    // 6. y += A V: the A fragment of k16 step cb is the scores' accumulator
    // of column block cb below this warp's diagonal, the chains' block on
    // it and zeros above it, as its bf16 pair (selected, not branched)
    uint32_t mh[4][4], ml[4][4];
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * jj + 2 * half;
          const float2 dg = *reinterpret_cast<const float2*>(
              ad + ((lane >> 2) + 8 * half) * kSub + 8 * jj + 2 * q4);
          float2 sv = make_float2(0.f, 0.f);
          if (cb == 0) sv = make_float2(sc0[i], sc0[i + 1]);
          if (cb == 1) sv = make_float2(sc1[i], sc1[i + 1]);
          if (cb == 2) sv = make_float2(sc2[i], sc2[i + 1]);
          const float2 a = cb < warp ? sv
                                     : (cb == warp ? dg : make_float2(0.f, 0.f));
          split2(a.x, a.y, mh[cb][half + 2 * jj], ml[cb][half + 2 * jj]);
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      const uint64_t db = sw128_desc(va + cb * 2048, kTile, 1024);
      wgmma_rs(y, mh[cb], db);
      wgmma_rs(y, ml[cb], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    fence_frag(mh);
    fence_frag(ml);

    // 7. y from the accumulator: a quad of lanes writes a 32-byte sector of
    // a row; rows past T are not stored
    float* yrow = ybase + (long long)(t0 + row0) * ystride;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int half = (i >> 1) & 1, cj = 8 * (i >> 2) + 2 * q4;
      if (row0 + 8 * half < nrows)
        *reinterpret_cast<float2*>(yrow + half * 8 * ystride + cj) =
            make_float2(y[i], y[i + 1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && c + kStages < p.chunks) {
      mbar_wait(&empty[st], (c / kStages) & 1);
      load(c + kStages);
    }
    __syncwarp();
  }
  if (wg == 0 && p.sT) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int ri = row0 + 8 * ((i >> 1) & 1), cj = 8 * (i >> 2) + 2 * q4;
      *reinterpret_cast<float2*>(p.sT + sbase + ri * HD + cj) =
          make_float2(S[i], S[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the step loop, for T below one chunk (the decode step's T = 1)
// ---------------------------------------------------------------------------
//
// One block per (b, h), one thread per column j of S: its hd values live
// in registers, and the columns never talk to each other.  The steps of r,
// k and exp(w) (fp32, rows padded to 68 floats: float4-aligned and free of
// bank conflicts) and v are staged in dynamic shared memory; each step
// reads r, k and exp(w) as broadcast float4 loads.  sum_i r u k of every
// step is formed once, one step per thread.

constexpr int kStepRow = HD + 4;    // padded staged row (floats)

size_t step_smem_bytes(int n) {
  return sizeof(float) * ((size_t)3 * n * kStepRow + (size_t)n * HD + n + HD);
}

__global__ void __launch_bounds__(HD)
    wkv_step_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ sT, int T,
                    int H) {
  extern __shared__ float4 smem4[];
  const int n = T;                               // < Q
  float* sr = reinterpret_cast<float*>(smem4);   // [n][kStepRow] r
  float* sk = sr + n * kStepRow;                 // [n][kStepRow] k
  float* se = sk + n * kStepRow;                 // [n][kStepRow] exp(w)
  float* sv = se + n * kStepRow;                 // [n][HD] v
  float* su = sv + n * HD;                       // [HD] u of this head
  float* sb = su + HD;                           // [n] sum_i r u k

  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long row = (long long)H * HD;       // one step of [B, T, H, hd]
  const long long base = (long long)b * T * row + (long long)h * HD + j;

  float S[HD];
  const float* s0p = s0 ? s0 + (long long)bh * HD * HD : nullptr;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0p ? s0p[i * HD + j] : 0.f;
  su[j] = u[h * HD + j];

#pragma unroll 8
  for (int t = 0; t < n; ++t) {                  // 8 steps' loads in flight
    const long long off = base + (long long)t * row;
    sr[t * kStepRow + j] = __bfloat162float(r[off]);
    sk[t * kStepRow + j] = __bfloat162float(k[off]);
    se[t * kStepRow + j] = expf(w[off]);
    sv[t * HD + j] = __bfloat162float(v[off]);
  }
  __syncthreads();
  if (j < n) {                                   // one step per thread
    const float4* r4 = reinterpret_cast<const float4*>(sr + j * kStepRow);
    const float4* k4 = reinterpret_cast<const float4*>(sk + j * kStepRow);
    const float4* u4 = reinterpret_cast<const float4*>(su);
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < HD / 4; ++q) {
      const float4 rr = r4[q], kk = k4[q], uu = u4[q];
      a = fmaf(rr.x * uu.x, kk.x, a);
      a = fmaf(rr.y * uu.y, kk.y, a);
      a = fmaf(rr.z * uu.z, kk.z, a);
      a = fmaf(rr.w * uu.w, kk.w, a);
    }
    sb[j] = a;
  }
  __syncthreads();
  for (int t = 0; t < n; ++t) {
    const float vj = sv[t * HD + j];
    const float4* r4 = reinterpret_cast<const float4*>(sr + t * kStepRow);
    const float4* k4 = reinterpret_cast<const float4*>(sk + t * kStepRow);
    const float4* e4 = reinterpret_cast<const float4*>(se + t * kStepRow);
    float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
    for (int q = 0; q < HD / 4; ++q) {
      const float4 rr = r4[q], kk = k4[q], ee = e4[q];
      y0 = fmaf(rr.x, S[4 * q], y0);
      S[4 * q] = fmaf(ee.x, S[4 * q], kk.x * vj);
      y1 = fmaf(rr.y, S[4 * q + 1], y1);
      S[4 * q + 1] = fmaf(ee.y, S[4 * q + 1], kk.y * vj);
      y2 = fmaf(rr.z, S[4 * q + 2], y2);
      S[4 * q + 2] = fmaf(ee.z, S[4 * q + 2], kk.z * vj);
      y3 = fmaf(rr.w, S[4 * q + 3], y3);
      S[4 * q + 3] = fmaf(ee.w, S[4 * q + 3], kk.w * vj);
    }
    y[base + (long long)t * row] = ((y0 + y1) + (y2 + y3)) + vj * sb[t];
  }
  if (sT) {
    float* sTp = sT + (long long)bh * HD * HD;
#pragma unroll
    for (int i = 0; i < HD; ++i) sTp[i * HD + j] = S[i];
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// a 4-D map over [b, t, h, HD] (contiguous), box {HD, 1, Q, 1}; bf16
// 128-byte swizzled or fp32 unswizzled; rows past t load as 0
bool encode(CUtensorMap* map, const void* ptr, bool is_bf16, int b, int t,
            int h) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = is_bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)h, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {HD * es, (cuuint64_t)h * HD * es,
                                 (cuuint64_t)t * h * HD * es};
  const cuuint32_t box[4] = {HD, 1, Q, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            is_bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// r, k, v: [b, t, h, hd] bf16; w: [b, t, h, hd] fp32 (log decay); u: [h, hd]
// fp32; s0: [b, h, hd, hd] fp32 or null (zeros); y: [b, t, h, hd] fp32;
// sT: [b, h, hd, hd] fp32 or null.  All contiguous; at t >= 64, r, k, v
// and w are read by TMA: each base address a multiple of 16 bytes.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* y, void* sT, int b, int t, int h, int hd,
                         void* stream) {
  if (b < 0 || t < 0 || h < 0 || hd != HD) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  if (t < Q) {
    const int n = t > 0 ? t : 1;
    const size_t smem = step_smem_bytes(n);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          wkv_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    wkv_step_kernel<<<b * h, HD, smem, (cudaStream_t)stream>>>(
        (const bf16*)r, (const bf16*)k, (const bf16*)v, (const float*)w,
        (const float*)u, (const float*)s0, (float*)y, (float*)sT, t, h);
    return (int)cudaGetLastError();
  }
  CUtensorMap mr, mk, mv, mw;
  memset(&mr, 0, sizeof(mr));
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  memset(&mw, 0, sizeof(mw));
  if (!encode(&mr, r, true, b, t, h) || !encode(&mk, k, true, b, t, h) ||
      !encode(&mv, v, true, b, t, h) || !encode(&mw, w, false, b, t, h))
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.u = (const float*)u;
  prm.s0 = (const float*)s0;
  prm.y = (float*)y;
  prm.sT = (float*)sT;
  prm.t = t;
  prm.h = h;
  prm.chunks = (t + Q - 1) / Q;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return (int)attr;
  wkv_chunk_kernel<<<b * h, kThreads, kBytes, (cudaStream_t)stream>>>(
      mr, mk, mv, mw, prm);
  return (int)cudaGetLastError();
}
