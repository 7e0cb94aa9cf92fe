// The backward of the Mamba2 SSD scan for Hopper (sm_90a): x, dt, B and C
// bf16, read in place through their batch and time strides (the model's
// slices of one projection), a_log, D, h0 and the cotangents fp32; fp32
// states, sums and gradients.
//
// Replaces no TPU kernel: src/repro/kernels/ssd.py::ssd_scan has no VJP
// (the reference trains Mamba2 through jax.grad of its jnp chunked form,
// models/ssm.py::ssd_chunked, whose gradient is NaN at the default decays:
// it forms exp(L_t - L_s) above the diagonal and masks it afterwards).  It
// is the backward of csrc/ssd.cu's forward, so that the port trains
// zamba2-1.2b on the card.  Per (b, h), with d_t = softplus(dt_t),
// a = -e^{a_log}, g_t = e^{d_t a}, the [P, N] state h_t = g_t h_{t-1} +
// d_t x_t B_t^T, y_t = h_t C_t + D x_t, G_t the cotangent of h_t (the
// later steps' and y_t's; G_{T-1} starts from dh_T, or zero):
//   G_t    = g_{t+1} G_{t+1} + dy_t C_t^T
//   dC_t   = sum_h h_t^T dy_t            dB_t = sum_h d_t G_t^T x_t
//   dx_t   = D dy_t + d_t G_t B_t
//   ddt_t  = (x_t^T G_t B_t + a g_t <G_t, h_{t-1}>) sigmoid(dt_t)
//   da_log = a sum_{b, t} d_t g_t <G_t, h_{t-1}>
//   dD     = sum_{b, t} dy_t . x_t,      dh0 = g_0 G_0.
// The plain version is kernels/ref.py::ref_ssd_bwd.
//
// The chunked form.  In a chunk of Q = 64 steps, with l_t = d_t a, L_t its
// inclusive sum over the chunk, h the state entering the chunk and G the
// cotangent of the state leaving it (the later chunks' and dh_T):
//   S[t, s]  = C_t . B_s,   E[t, s] = e^{L_t - L_s} (s <= t, else 0)
//   DX[t, s] = dy_t . x_s,  W = S .* DX .* E,   dS = DX .* E .* d_s
//   dx   = D dy + (S .* E .* d_s)^T dy + diag(cw) B G^T,
//          cw_s = e^{L_Q - L_s} d_s
//   dC   = dS B + diag(e^L) dy h                (summed over heads)
//   dB   = dS^T C + diag(cw) x G                (summed over heads)
//   ddt_s = (sum_t W[t, s] + v_s + a dl_s) sigmoid(dt_s),
//           v_s = e^{L_Q - L_s} x_s . (G B_s),
//   dl_s (the cotangent of l_s) = sum_{t >= s} dL_t + sum_{r < s} d_r v_r,
//   dL_t = sum_{s < t} d_s W[t, s] - d_t sum_{t' > t} W[t', t]
//          + e^{L_t} C_t . (h^T dy_t)  [+ e^{L_Q} <G, h> at t = Q - 1],
// and the chunks meet only through h and G: h_{c+1} = e^{L_Q} h_c +
// x^T diag(cw) B, G_{c-1} = e^{L_Q} G_c + dy^T diag(e^L) C.  The u_r =
// d_r v_r terms enter dl as a sum over r < s directly: as a total at the
// chunk's end less the steps after s they cancel under a strong decay
// (the kernel's numpy model showed it while it was written).
//
// Bound on the card: bytes.  x, dt, B, C read once in bf16 and dy in fp32;
// dx, ddt, dB, dC written once in fp32 (at 4 x 2048, 64 heads: 345 MB,
// 0.103 ms at 3.35 TB/s).  The function's arithmetic is ~14 P N a step of
// a head: 0.031 ms at the bf16 tensor-core peak.  The chunked form does
// about twice that (Q-wide products, both orientations of the scores),
// and the hi / lo pairs below two or three times that again.  Measured on
// an H100 (chip_smoke.py phase 1): ~1.04 ms at 4 x 2048 x 64 heads, ~10%
// of the bound, of it the chunk kernel ~0.19, the state kernel ~0.19 (the
// chunk states, 536 MB read and written: near the HBM rate), the gradient
// kernel ~0.63, the sums ~0.03.
//
// Design: four kernels, one wrapper call.
// - ssd_bwd_chunk_kernel, a block per (chunk, group of kHeads heads, b): per
//   head the chunk's own state contribution x^T diag(cw) B and cotangent
//   contribution dy^T diag(e^L) C, [P, N] fp32 each, and e^{L_Q}, to the
//   scratch `states` [chunks, 2, B, H, P, N] and `decay` [chunks, B, H]
//   (chunk-major: one chunk's slabs are one stretch for the state kernel).
// - chunk_state_kernel<1> (warp_mma.cuh, shared with rwkv6_bwd.cu), a
//   thread per float4 of (b, h, p, n): the chunks in order for h (the
//   entering state overwrites the contribution) and in reverse for G (the
//   leaving cotangent overwrites its contribution), one decay a (b, h);
//   writes dh0.  fp32, elementwise: 128 MiB of chunk states a direction at
//   4 x 2048 x 64 heads.
// - ssd_bwd_grad_kernel, a block per (chunk, head group, b), 4 warps; warp w
//   owns rows 16 w .. 16 w + 15 of every 64-row product.  S = C B^T once a
//   block (fp32 in shared memory); per head the rows-t orientation (DX,
//   W, dS, dC, the per-step sums) and the rows-s orientation (DX^T, M^T
//   = (S .* E .* d_s)^T, dS^T, dx, G B^T, x G, dB), each a warp's 16 rows
//   against the causal half of the columns only (warp w: 2w + 2 column
//   tiles of the first, 8 - 2w of the second, so every warp does the same
//   work).  dB and dC stay in registers over the group's heads, summed in
//   head order, then go to the scratch `part` [B, T, groups, 2, N]; warp 0
//   assembles dL, its reverse sum and ddt from the warps' per-step sums.
// - ssd_bwd_sum_kernel: dB and dC summed over the groups in order, da_log and
//   dD over (b, chunk) in order.  No float atomics: every call repeats
//   bitwise.
// - Products on the tensor cores: mma.sync m16n8k16 (not wgmma:
//   warp_mma.cuh says why), bf16 operands, fp32 sums.  x, B and C are bf16 already and enter exactly; dy, DX .* E,
//   M, h, G, cw .* x and e^L .* dy are not: each is split into the pair
//   hi = bf16(v), lo = bf16(v - hi), and a product of one pair with a bf16
//   operand takes two mma, of two pairs three (hi hi, hi lo, lo hi), which
//   leaves ~2^-16 a term (one rounding of M alone: ~2e-3 norm-wise, past
//   the 1e-4 the card's check holds the kernel to).  Operands are bf16
//   tiles in shared memory with 144-byte rows, their fragments read by
//   ldmatrix (.trans for a tile stored the other way round; warp_mma.cuh).
//   The S and DX accumulators become the A fragments of the next products
//   in registers.
// - Decays: L is an fp32 pair (hi, lo), its scan exact to ~2^-48, so
//   e^{L_t - L_s} is as exact at |L| ~ 1e4 (a strong decay) as a product
//   of the steps' g; every exponent is <= 0 (s <= t, and L_Q - L_s,
//   L_t); the chunk's e^{L_Q}, e^{L_t}, e^{L_Q - L_s} with expf, the
//   in-chunk e^{L_t - L_s} with __expf (nothing compounds there); entries
//   above the diagonal are selected away, never multiplied by a mask.
//   Rows past T take d = 0 after the softplus and L of the last row below
//   T, so they leave every sum.
//
// Timed on an H100 at 4 x 2048 x 64 heads and not kept (throw-away builds
// in one call each): the chunk states [B, H, chunks, ...] (a (b, h)'s
// slabs 1 MB apart at one chunk: the state kernel took 3.15 ms, against
// 0.19 chunk-major); each 64 x 64 operand loaded row by row (one round
// trip a row: the gradient kernel 0.77 ms) or every load issued before
// the tile's stores but its fragments read as scalar pairs (0.93 ms at
// 255 registers; ldmatrix: 0.72); expf in the chunk (__expf: 0.02 ms
// less); dx's D dy from global memory (the pair in shared memory: 0.63
// ms); the next head's operands fetched into registers during warp 0's
// tail (444 bytes of spills, 0.785 ms); 16 heads a block (no gain).  By
// ablation the gradient kernel's rows-s orientation is ~0.31 ms of it,
// rows t ~0.18, the loads' exposed latency ~0.11, warp 0's tail ~0.06.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int Q = 64;             // steps a chunk
constexpr int P = 64;             // head dim, the one instance
constexpr int N = 64;             // state dim
constexpr int kWarps = 4;         // a warp a 16-row slab
constexpr int kThreads = 128;
constexpr int kHeads = 8;         // heads a block (dB and dC summed in it)
constexpr int kRowF = 68;         // floats a row of S
constexpr int kSplit = 2;         // bf16 terms: hi, lo
constexpr int kSmemMax = 232448;  // a block's dynamic limit
constexpr int kTile = Q * kRow;   // elements of a 64-row bf16 tile

// the steps of a chunk of one head
struct Steps {
  float d[Q];     // softplus(dt), 0 past T
  float lh[Q];    // L, the pair's hi
  float ll[Q];    // L, the pair's lo
  float el[Q];    // e^{L_t}
  float ecw[Q];   // e^{L_Q - L_s}
  float sig[Q];   // sigmoid(dt)
};

struct ChunkSmem {
  bf16 b[kTile], c[kTile];        // [t][n]
  bf16 cwx[kSplit][kTile];        // cw .* x, [s][p]
  bf16 edy[kSplit][kTile];        // e^L .* dy, [t][p]
  Steps st;
};

struct GradSmem {
  bf16 b[kTile], c[kTile];        // [t][n]
  bf16 x[kTile];                  // [t][p]
  bf16 dy[kSplit][kTile];         // [t][p]
  bf16 hin[kSplit][kTile];        // the entering state, [p][n]
  bf16 gx[kSplit][kTile];         // the leaving cotangent, [p][n]
  float s[Q][kRowF];              // S = C B^T, [t][s]
  float colp[kWarps][Q];          // a warp's column sums of W, s < t
  float rz[Q], wd[Q], sa[Q], v[Q], up[Q];   // per-step sums
  float red[2][kThreads];         // per-thread <G, h>, dy . x
  Steps st;
};
static_assert(sizeof(ChunkSmem) <= kSmemMax, "ssd_bwd shared memory");
static_assert(sizeof(GradSmem) <= kSmemMax, "ssd_bwd shared memory");

struct Args {
  const bf16 *x, *dt, *b, *c;
  const float *a_log, *d_skip, *h0, *dy, *dhT;
  float *dx, *ddt, *da_log, *db, *dc, *dd, *dh0;
  float *states, *decay, *part, *scal;
  long long xs_b, xs_t, dts_b, dts_t, bs_b, bs_t, cs_b, cs_t;
  int B, T, H, chunks, groups;
};

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));     // torch's threshold
}

// s + e = a + b exactly
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// (h, l) = (ah, al) + (bh, bl), the float pair renormalized
__device__ __forceinline__ void pair_add(float ah, float al, float bh,
                                         float bl, float& h, float& l) {
  float s, e;
  two_sum(ah, bh, s, e);
  const float lo = __fadd_rn(__fadd_rn(al, bl), e);
  h = __fadd_rn(s, lo);
  l = __fsub_rn(lo, __fsub_rn(h, s));
}

// the warp's inclusive scan of v over lanes (shuffle up)
__device__ __forceinline__ float lane_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = __fadd_rn(v, o);
  }
  return v;
}

// dt of steps 2l, 2l + 1 of the chunk (lane l; 0 past T): dt points at
// the head's dt at the chunk's first step, nv rows below T
__device__ __forceinline__ void fetch_dt(float (&raw)[2], const bf16* dt,
                                         long long dts_t, int nv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    raw[e] = t < nv ? __bfloat162float(dt[t * dts_t]) : 0.f;
  }
}

// One warp: the chunk's steps of a head from its dt (fetch_dt)
__device__ void chunk_steps(Steps& st, const float (&raw)[2], int nv,
                            float A) {
  const int lane = threadIdx.x & 31;
  float d[2], l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    d[e] = t < nv ? softplus(raw[e]) : 0.f;   // masked after the softplus
    l[e] = __fmul_rn(d[e], A);
  }
  float ih, il;
  pair_add(l[0], 0.f, l[1], 0.f, ih, il);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float oh = __shfl_up_sync(0xffffffffu, ih, off);
    const float ol = __shfl_up_sync(0xffffffffu, il, off);
    if (lane >= off) pair_add(ih, il, oh, ol, ih, il);
  }
  float eh = __shfl_up_sync(0xffffffffu, ih, 1);
  float el = __shfl_up_sync(0xffffffffu, il, 1);
  if (lane == 0) eh = el = 0.f;
  float Lh[2], Ll[2];
  pair_add(eh, el, l[0], 0.f, Lh[0], Ll[0]);
  pair_add(Lh[0], Ll[0], l[1], 0.f, Lh[1], Ll[1]);
  // the rows past T take L of the last row below it, exactly
  const int last = nv - 1;
  const float qh = __shfl_sync(0xffffffffu, (last & 1) ? Lh[1] : Lh[0],
                               last >> 1);
  const float ql = __shfl_sync(0xffffffffu, (last & 1) ? Ll[1] : Ll[0],
                               last >> 1);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    if (t > last) {
      Lh[e] = qh;
      Ll[e] = ql;
    }
    st.d[t] = d[e];
    st.lh[t] = Lh[e];
    st.ll[t] = Ll[e];
    st.el[t] = expf(__fadd_rn(Lh[e], Ll[e]));
    st.ecw[t] = expf(__fadd_rn(__fsub_rn(qh, Lh[e]), __fsub_rn(ql, Ll[e])));
    st.sig[t] = 1.f / (1.f + expf(-raw[e]));
  }
}

// e^v of a v <= 0 inside a chunk, on the special function unit: no decay
// compounds here (the chunks' e^{L_Q}, e^{L_t} and e^{L_Q - L_s} take expf)
__device__ __forceinline__ float exp_in(float v) { return __expf(v); }

// e^{L_t - L_s} from the pairs
__device__ __forceinline__ float e_diff(const Steps& st, float th, float tl,
                                       int s) {
  return exp_in(__fadd_rn(__fsub_rn(th, st.lh[s]), __fsub_rn(tl, st.ll[s])));
}

// the bf16 tile, row t scaled by d[t] e[t], as the bf16 pair
__device__ __forceinline__ void store_scaled_rows(bf16* hi, bf16* lo,
                                                  const uint4 (&v)[4],
                                                  const float* d,
                                                  const float* e) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = threadIdx.x + kThreads * k, t = i >> 3, col = (i & 7) * 8;
    const float f = d[t] * e[t];
    const uint32_t in[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&in[j]));
      split2(x2.x * f, x2.y * f, h[j], l[j]);
    }
    *reinterpret_cast<uint4*>(hi + t * kRow + col) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + t * kRow + col) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// the chunk state / cotangent slab (kind 0: the state, 1: the cotangent)
// of (c, b, h): states is [chunks][2][B][H][P][N], so that the state
// kernel's threads at one chunk read one contiguous stretch
__device__ __forceinline__ float* slab(const Args& a, int c, int kind, int b,
                                       int h) {
  return a.states +
         (((size_t)(2 * c + kind) * a.B + b) * a.H + h) * (size_t)(P * N);
}

// ---------------------------------------------------------------------------
// pass 1: the chunks' own state and cotangent contributions
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int c = blockIdx.x, grp = blockIdx.y, bb = blockIdx.z;
  const int t0 = c * Q, nv = min(Q, a.T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  {
    uint4 bv[4], cv[4];
    fetch_rows<kThreads>(bv, a.b + bb * a.bs_b + t0 * a.bs_t, a.bs_t, nv);
    fetch_rows<kThreads>(cv, a.c + bb * a.cs_b + t0 * a.cs_t, a.cs_t, nv);
    store_rows<kThreads>(sm.b, kRow, bv);
    store_rows<kThreads>(sm.c, kRow, cv);
  }
  const int h_end = min(a.H, (grp + 1) * kHeads);
  // a head's x, dy and dt in registers, fetched while the previous head's
  // products run
  uint4 xv[4];
  float4 dv[8];
  float raw[2];
  const auto fetch = [&](int h) {
    fetch_rows<kThreads>(xv, a.x + bb * a.xs_b + t0 * a.xs_t + h * P,
                         a.xs_t, nv);
    fetch_f32<kThreads>(dv, a.dy + (((size_t)bb * a.T + t0) * a.H + h) * P,
                        (long long)a.H * P, nv);
    fetch_dt(raw, a.dt + bb * a.dts_b + t0 * a.dts_t + h, a.dts_t, nv);
  };
  fetch(grp * kHeads);
  for (int h = grp * kHeads; h < h_end; ++h) {
    __syncthreads();    // the previous head's tiles are read
    if (warp == 0) chunk_steps(sm.st, raw, nv, -expf(a.a_log[h]));
    __syncthreads();
    // cw .* x and e^L .* dy as bf16 pairs
    store_scaled_rows(sm.cwx[0], sm.cwx[1], xv, sm.st.d, sm.st.ecw);
    store_split<kThreads>(sm.edy[0], sm.edy[1], dv, sm.st.el);
    __syncthreads();
    // rows p of warp w: X = (cw x)^T B, Y = (e^L dy)^T C
    float X[8][4], Y[8][4];
    zero(X);
    zero(Y);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t xh[4], xl[4], yh[4], yl[4];
      lda_t(xh, sm.cwx[0], 16 * warp, 16 * kk);
      lda_t(xl, sm.cwx[1], 16 * warp, 16 * kk);
      lda_t(yh, sm.edy[0], 16 * warp, 16 * kk);
      lda_t(yl, sm.edy[1], 16 * warp, 16 * kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[4];
        ldb_t(bf, sm.b, 16 * jj, 16 * kk);
        mma2(X, jj, xh, bf);
        mma2(X, jj, xl, bf);
        ldb_t(bf, sm.c, 16 * jj, 16 * kk);
        mma2(Y, jj, yh, bf);
        mma2(Y, jj, yl, bf);
      }
    }
    if (h + 1 < h_end) fetch(h + 1);
    float* out = slab(a, c, 0, bb, h);
    float* out_g = slab(a, c, 1, bb, h);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * warp + g + 8 * half, n = 8 * j + 2 * q;
        *reinterpret_cast<float2*>(out + p * N + n) =
            make_float2(X[j][2 * half], X[j][2 * half + 1]);
        *reinterpret_cast<float2*>(out_g + p * N + n) =
            make_float2(Y[j][2 * half], Y[j][2 * half + 1]);
      }
    if (threadIdx.x == 0)
      a.decay[((size_t)c * a.B + bb) * a.H + h] = sm.st.el[Q - 1];
  }
}

// ---------------------------------------------------------------------------
// pass 3: every gradient of a chunk, a head group a block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_grad_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem_raw);
  const int c = blockIdx.x, grp = blockIdx.y, bb = blockIdx.z;
  const int t0 = c * Q, nv = min(Q, a.T - t0);
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r0 = 16 * warp;            // this warp's rows
  {
    uint4 bv[4], cv[4];
    fetch_rows<kThreads>(bv, a.b + bb * a.bs_b + t0 * a.bs_t, a.bs_t, nv);
    fetch_rows<kThreads>(cv, a.c + bb * a.cs_b + t0 * a.cs_t, a.cs_t, nv);
    store_rows<kThreads>(sm.b, kRow, bv);
    store_rows<kThreads>(sm.c, kRow, cv);
  }
  __syncthreads();
  // S = C B^T, rows t of this warp, columns s < 16 w + 16
  {
    float S[8][4];
    zero(S);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ca[4];
      lda(ca, sm.c, r0, 16 * kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (jj <= warp) {
          uint32_t bf[4];
          ldb(bf, sm.b, 16 * jj, 16 * kk);
          mma2(S, jj, ca, bf);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(&sm.s[r0 + g + 8 * half][8 * j + 2 * q]) =
            make_float2(S[j][2 * half], S[j][2 * half + 1]);
  }
  float dB[8][4], dC[8][4];
  zero(dB);
  zero(dC);
  const int h_end = min(a.H, (grp + 1) * kHeads);
  for (int h = grp * kHeads; h < h_end; ++h) {
    const float A = -expf(a.a_log[h]);
    {
      // the head's x, dy, entering state, leaving cotangent and dt, every
      // load issued before the barrier
      uint4 xv[4];
      float4 dv[8], hv[8], gv[8];
      float raw[2];
      fetch_rows<kThreads>(xv, a.x + bb * a.xs_b + t0 * a.xs_t + h * P,
                         a.xs_t, nv);
      fetch_f32<kThreads>(dv, a.dy + (((size_t)bb * a.T + t0) * a.H + h) * P,
                          (long long)a.H * P, nv);
      fetch_f32<kThreads>(hv, slab(a, c, 0, bb, h), N, P);
      fetch_f32<kThreads>(gv, slab(a, c, 1, bb, h), N, P);
      fetch_dt(raw, a.dt + bb * a.dts_b + t0 * a.dts_t + h, a.dts_t, nv);
      float hg = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        hg = fmaf(gv[k].x, hv[k].x, hg);
        hg = fmaf(gv[k].y, hv[k].y, hg);
        hg = fmaf(gv[k].z, hv[k].z, hg);
        hg = fmaf(gv[k].w, hv[k].w, hg);
      }
      __syncthreads();    // the previous head is done with the tiles
      if (warp == 0) chunk_steps(sm.st, raw, nv, A);
      store_rows<kThreads>(sm.x, kRow, xv);
      store_split<kThreads>(sm.dy[0], sm.dy[1], dv, nullptr);
      store_split<kThreads>(sm.hin[0], sm.hin[1], hv, nullptr);
      store_split<kThreads>(sm.gx[0], sm.gx[1], gv, nullptr);
      sm.red[0][threadIdx.x] = hg;
    }
    __syncthreads();
    const Steps& st = sm.st;
    float th[2], tl[2];                // L of this thread's two rows
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      th[half] = st.lh[r0 + g + 8 * half];
      tl[half] = st.ll[r0 + g + 8 * half];
    }

    // ---- rows t: DX = dy x^T, W, dS; dC
    {
      float acc[8][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        lda(ah, sm.dy[0], r0, 16 * kk);
        lda(al, sm.dy[1], r0, 16 * kk);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (jj <= warp) {
            uint32_t bf[4];
            ldb(bf, sm.x, 16 * jj, 16 * kk);
            mma2(acc, jj, ah, bf);
            mma2(acc, jj, al, bf);
          }
      }
      float rz[2] = {0.f, 0.f}, wd[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float col[2] = {0.f, 0.f};
        if (j <= 2 * warp + 1) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = r0 + g + 8 * half;
            const float2 sv =
                *reinterpret_cast<const float2*>(&sm.s[t][8 * j + 2 * q]);
            const float svv[2] = {sv.x, sv.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = 8 * j + 2 * q + e;
              const float dx = acc[j][2 * half + e];
              float ds = 0.f;
              if (s < t) {
                const float ee = e_diff(st, th[half], tl[half], s);
                const float w = svv[e] * dx * ee;
                rz[half] = fmaf(w, st.d[s], rz[half]);
                col[e] += w;
                ds = dx * ee * st.d[s];
              } else if (s == t) {
                wd[half] = svv[e] * dx;
                ds = dx * st.d[s];
              }
              acc[j][2 * half + e] = ds;
            }
          }
        }
        // the warp's column sums of W over its 16 rows
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = col[e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) sm.colp[warp][8 * j + 2 * q + e] = v;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = rz[half], w = wd[half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        w += __shfl_xor_sync(0xffffffffu, w, 1);
        w += __shfl_xor_sync(0xffffffffu, w, 2);
        if (q == 0) {
          sm.rz[r0 + g + 8 * half] = v;
          sm.wd[r0 + g + 8 * half] = w;
        }
      }
      // dC += dS B over s < 16 w + 16
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk <= warp) {
          uint32_t ah[4], al[4];
          acc_to_a(acc, kk, ah, al);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bf[4];
            ldb_t(bf, sm.b, 16 * jj, 16 * kk);
            mma2(dC, jj, ah, bf);
            mma2(dC, jj, al, bf);
          }
        }
    }
    // ---- rows t: e^L .* (dy h) into dC, its row sums with C
    {
      float acc[8][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        lda(ah, sm.dy[0], r0, 16 * kk);
        lda(al, sm.dy[1], r0, 16 * kk);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bh[4], bl[4];
          ldb_t(bh, sm.hin[0], 16 * jj, 16 * kk);
          ldb_t(bl, sm.hin[1], 16 * jj, 16 * kk);
          mma2(acc, jj, ah, bh);
          mma2(acc, jj, ah, bl);
          mma2(acc, jj, al, bh);
        }
      }
      float sa[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = r0 + g + 8 * half;
        const float f = st.el[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 cv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  sm.c + t * kRow + 8 * j + 2 * q));
          const float v0 = acc[j][2 * half] * f;
          const float v1 = acc[j][2 * half + 1] * f;
          sa[half] = fmaf(cv.x, v0, sa[half]);
          sa[half] = fmaf(cv.y, v1, sa[half]);
          dC[j][2 * half] += v0;
          dC[j][2 * half + 1] += v1;
        }
        float v = sa[half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) sm.sa[t] = v;
      }
    }
    // ---- rows s: DX^T = x dy^T; dS^T and M^T over t >= s; dB, dx
    {
      uint32_t mh[4][4], ml[4][4];     // M^T's A fragments, t blocks >= w
      {
        float acc[8][4];
        zero(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t xa[4];
          lda(xa, sm.x, r0, 16 * kk);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (jj >= warp) {
              uint32_t bf[4];
              ldb(bf, sm.dy[0], 16 * jj, 16 * kk);
              mma2(acc, jj, xa, bf);
              ldb(bf, sm.dy[1], 16 * jj, 16 * kk);
              mma2(acc, jj, xa, bf);
            }
        }
        float m[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int s = r0 + g + 8 * half;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = 8 * j + 2 * q + e;
              float ds = 0.f, mv = 0.f;
              if (j >= 2 * warp && t >= s) {
                const float dl = __fadd_rn(__fsub_rn(st.lh[t], th[half]),
                                           __fsub_rn(st.ll[t], tl[half]));
                const float ee = (t == s ? 1.f : exp_in(dl)) * st.d[s];
                ds = acc[j][2 * half + e] * ee;
                mv = sm.s[t][s] * ee;
              }
              acc[j][2 * half + e] = ds;
              m[j][2 * half + e] = mv;
            }
          }
        // dB += dS^T C over t >= 16 w
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk >= warp) {
            uint32_t ah[4], al[4];
            acc_to_a(acc, kk, ah, al);
            acc_to_a(m, kk, mh[kk], ml[kk]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              uint32_t bf[4];
              ldb_t(bf, sm.c, 16 * jj, 16 * kk);
              mma2(dB, jj, ah, bf);
              mma2(dB, jj, al, bf);
            }
          }
      }
      // dx = D dy + M^T dy + diag(cw) B G^T; v_s = e^{L_Q - L_s} x_s . (G B_s)
      float dx[8][4], gb[8][4];
      zero(dx);
      zero(gb);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk >= warp) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            uint32_t bh[4], bl[4];
            ldb_t(bh, sm.dy[0], 16 * jj, 16 * kk);
            ldb_t(bl, sm.dy[1], 16 * jj, 16 * kk);
            mma2(dx, jj, mh[kk], bh);
            mma2(dx, jj, mh[kk], bl);
            mma2(dx, jj, ml[kk], bh);
          }
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ba[4];
        lda(ba, sm.b, r0, 16 * kk);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          ldb(bf, sm.gx[0], 16 * jj, 16 * kk);
          mma2(gb, jj, ba, bf);
          ldb(bf, sm.gx[1], 16 * jj, 16 * kk);
          mma2(gb, jj, ba, bf);
        }
      }
      const float dsk = a.d_skip[h];
      float ddp = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = r0 + g + 8 * half;
        const float cw = st.d[s] * st.ecw[s];
        float xg = 0.f;
        float* dxrow = a.dx + (((size_t)bb * a.T + t0 + s) * a.H + h) * P;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = 8 * j + 2 * q;
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sm.x + s * kRow + p));
          xg = fmaf(xf.x, gb[j][2 * half], xg);
          xg = fmaf(xf.y, gb[j][2 * half + 1], xg);
          if (s < nv) {     // dy as its pair: hi + lo is dy to 2^-17
            const float2 dh = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sm.dy[0] + s * kRow +
                                                         p));
            const float2 dl = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sm.dy[1] + s * kRow +
                                                         p));
            const float d0 = dh.x + dl.x, d1 = dh.y + dl.y;
            ddp = fmaf(d0, xf.x, ddp);
            ddp = fmaf(d1, xf.y, ddp);
            *reinterpret_cast<float2*>(dxrow + p) = make_float2(
                fmaf(dsk, d0, dx[j][2 * half]) + cw * gb[j][2 * half],
                fmaf(dsk, d1, dx[j][2 * half + 1]) +
                    cw * gb[j][2 * half + 1]);
          }
        }
        xg += __shfl_xor_sync(0xffffffffu, xg, 1);
        xg += __shfl_xor_sync(0xffffffffu, xg, 2);
        if (q == 0) sm.v[s] = st.ecw[s] * xg;
      }
      sm.red[1][threadIdx.x] = ddp;
      // dB += diag(cw) x G
      zero(gb);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t xa[4];
        lda(xa, sm.x, r0, 16 * kk);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          ldb_t(bf, sm.gx[0], 16 * jj, 16 * kk);
          mma2(gb, jj, xa, bf);
          ldb_t(bf, sm.gx[1], 16 * jj, 16 * kk);
          mma2(gb, jj, xa, bf);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = r0 + g + 8 * half;
        const float cw = st.d[s] * st.ecw[s];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dB[j][2 * half] = fmaf(cw, gb[j][2 * half], dB[j][2 * half]);
          dB[j][2 * half + 1] =
              fmaf(cw, gb[j][2 * half + 1], dB[j][2 * half + 1]);
        }
      }
    }
    __syncthreads();
    // ---- warp 0: dL, its reverse sum, ddt, the head's da and dD partials
    if (warp == 0) {
      float hg = 0.f, dd = 0.f;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) {
        hg += sm.red[0][lane + 32 * k];
        dd += sm.red[1][lane + 32 * k];
      }
      hg = warp_sum(hg);
      dd = warp_sum(dd);
      // the sum over r < s of u_r = d_r v_r (lane l: steps 2l, 2l + 1)
      {
        const float u0 = st.d[2 * lane] * sm.v[2 * lane];
        const float u1 = st.d[2 * lane + 1] * sm.v[2 * lane + 1];
        float ex = __shfl_up_sync(0xffffffffu, lane_scan(u0 + u1, lane), 1);
        if (lane == 0) ex = 0.f;
        sm.up[2 * lane] = ex;
        sm.up[2 * lane + 1] = ex + u0;
      }
      __syncwarp();
      // dL and its sum over t >= s (lane l: steps 63 - 2l, 62 - 2l)
      float dl[2], col[2];
      int ts[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = Q - 1 - 2 * lane - e;
        ts[e] = t;
        float cs = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if (16 * w + 15 > t) cs += sm.colp[w][t];
        col[e] = cs;
        dl[e] = sm.rz[t] - st.d[t] * cs + sm.sa[t];
        if (t == Q - 1) dl[e] += st.el[Q - 1] * hg;
      }
      float ex = __shfl_up_sync(0xffffffffu, lane_scan(dl[0] + dl[1], lane), 1);
      if (lane == 0) ex = 0.f;
      const float r0s = ex + dl[0];
      const float r1s = r0s + dl[1];
      float da = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = ts[e];
        const float l = (e == 0 ? r0s : r1s) + sm.up[s];
        da = fmaf(st.d[s], l, da);
        if (s < nv)
          a.ddt[((size_t)bb * a.T + t0 + s) * a.H + h] =
              (col[e] + sm.wd[s] + sm.v[s] + A * l) * st.sig[s];
      }
      da = warp_sum(da);
      if (lane == 0) {
        float* sc = a.scal + (((size_t)bb * a.chunks + c) * a.H + h) * 2;
        sc[0] = da;
        sc[1] = dd;
      }
    }
  }
  // the group's dB and dC, rows below T
  float* out = a.part + (((size_t)bb * a.T + t0) * a.groups + grp) * 2 * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r0 + g + 8 * half;
    if (t < nv) {
      float* row = out + (size_t)t * a.groups * 2 * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * q;
        *reinterpret_cast<float2*>(row + n) =
            make_float2(dB[j][2 * half], dB[j][2 * half + 1]);
        *reinterpret_cast<float2*>(row + N + n) =
            make_float2(dC[j][2 * half], dC[j][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pass 4: dB and dC over the head groups, da_log and dD over (b, chunk)
// ---------------------------------------------------------------------------

__global__ void ssd_bwd_sum_kernel(const Args a) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)a.B * a.T;
  if (idx < rows * N) {
    const long long row = idx / N;
    const int n = (int)(idx % N);
    const float* p = a.part + row * a.groups * 2 * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < a.groups; ++k) {
      sb += p[(size_t)k * 2 * N];
      sc += p[(size_t)k * 2 * N + N];
    }
    a.db[idx] = sb;
    a.dc[idx] = sc;
  } else if (idx < rows * N + a.H) {
    const int h = (int)(idx - rows * N);
    float sa = 0.f, sd = 0.f;
    for (long long k = 0; k < (long long)a.B * a.chunks; ++k) {
      sa += a.scal[(k * a.H + h) * 2];
      sd += a.scal[(k * a.H + h) * 2 + 1];
    }
    a.da_log[h] = -expf(a.a_log[h]) * sa;
    a.dd[h] = sd;
  }
}

}  // namespace

// x: bf16 [B, T, H, 64], dt: bf16 [B, T, H], b, c: bf16 [B, T, 64], each
// read through its batch and time strides (elements; the dims after time
// contiguous; x, b and c 16-byte aligned with strides of whole 16-byte
// units, as the forward's TMA needs them); a_log, d_skip: fp32 [H]; h0,
// dhT: fp32 [B, H, 64, 64] or null (zeros); dy: fp32 [B, T, H, 64]
// contiguous (h0, dhT and dy 16-byte aligned: loaded in 16-byte vectors).
// Writes dx (fp32 [B, T, H, 64]), ddt (fp32 [B, T, H]), da_log and dd
// (fp32 [H]), db and dc (fp32 [B, T, 64]) and dh0 (fp32 [B, H, 64, 64]).
// Scratch: states (fp32 [ceil(T / 64), 2, B, H, 64, 64]), decay (fp32
// [ceil(T / 64), B, H]), part (fp32 [B, T, ceil(H / 8), 2, 64]), scal
// (fp32 [B, ceil(T / 64), H, 2]).  Returns cudaGetLastError().
extern "C" int ssd_scan_bwd(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, const void* d_skip, const void* h0, const void* dy,
    const void* dhT, void* dx, void* ddt, void* da_log, void* db, void* dc,
    void* dd, void* dh0, void* states, void* decay, void* part, void* scal,
    int bsz, int t, int h, int p, int n, long long xs_b, long long xs_t,
    long long dts_b, long long dts_t, long long bs_b, long long bs_t,
    long long cs_b, long long cs_t, void* stream) {
  if (bsz < 0 || t < 0 || h < 0 || p != P || n != N)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || h == 0) return (int)cudaGetLastError();
  Args a;
  a.x = (const bf16*)x;
  a.dt = (const bf16*)dt;
  a.b = (const bf16*)b;
  a.c = (const bf16*)c;
  a.a_log = (const float*)a_log;
  a.d_skip = (const float*)d_skip;
  a.h0 = (const float*)h0;
  a.dy = (const float*)dy;
  a.dhT = (const float*)dhT;
  a.dx = (float*)dx;
  a.ddt = (float*)ddt;
  a.da_log = (float*)da_log;
  a.db = (float*)db;
  a.dc = (float*)dc;
  a.dd = (float*)dd;
  a.dh0 = (float*)dh0;
  a.states = (float*)states;
  a.decay = (float*)decay;
  a.part = (float*)part;
  a.scal = (float*)scal;
  a.xs_b = xs_b;
  a.xs_t = xs_t;
  a.dts_b = dts_b;
  a.dts_t = dts_t;
  a.bs_b = bs_b;
  a.bs_t = bs_t;
  a.cs_b = cs_b;
  a.cs_t = cs_t;
  a.B = bsz;
  a.T = t;
  a.H = h;
  a.chunks = (t + Q - 1) / Q;
  a.groups = (h + kHeads - 1) / kHeads;
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(ChunkSmem));
  static const cudaError_t attr3 = cudaFuncSetAttribute(
      ssd_bwd_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(GradSmem));
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr3 != cudaSuccess) return (int)attr3;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(a.chunks, a.groups, bsz);
  if (a.chunks > 0)
    ssd_bwd_chunk_kernel<<<grid, kThreads, sizeof(ChunkSmem), s>>>(a);
  const long long elems = (long long)bsz * h * (P * N / 4);
  chunk_state_kernel<1><<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(
      a.states, a.decay, a.h0, a.dhT, a.dh0, (long long)bsz * h, a.chunks);
  if (a.chunks > 0)
    ssd_bwd_grad_kernel<<<grid, kThreads, sizeof(GradSmem), s>>>(a);
  const long long total = (long long)bsz * t * N + h;
  ssd_bwd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}
