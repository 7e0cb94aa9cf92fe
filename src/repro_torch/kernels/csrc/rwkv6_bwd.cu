// The backward of the RWKV6 WKV recurrence for Hopper (sm_90a): bf16 r, k,
// v, fp32 log decay w, bonus u, initial state s0 and cotangents; fp32
// states, sums and gradients.
//
// Replaces no TPU kernel: src/repro/kernels/rwkv6.py::rwkv6_wkv has no VJP
// (the reference trains RWKV6 through jax.grad of its jnp scan,
// models/rwkv.py::wkv_chunked).  It is the backward of csrc/rwkv6.cu's
// forward, so that the port trains rwkv6-1.6b on the card.  Per (b, h),
// with S_{t-1} the [hd, hd] state before step t (row i: key channel,
// column j: value channel), G_t the cotangent of the state after step t
// (G_{T-1} = ds_T, or zero), x_t = e^{w_t} and dy_t the cotangent of y_t:
//   dr_t[i] = sum_j S_{t-1}[i, j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i, j] v_t[j]      + u[i] r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i, j] k_t[i]      + (r_t . u k_t) dy_t[j]
//   dw_t[i] = x_t[i] sum_j S_{t-1}[i, j] G_t[i, j]
//   du[i]   = sum_{b, t} r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1} = x_t[:, None] G_t + r_t dy_t^T,      ds0 = G_{-1}.
// The plain version is kernels/ref.py::ref_rwkv6_bwd.
//
// The chunked form, two levels.  Chunks of Q = 64 steps meet only through
// the state entering a chunk and the cotangent leaving it, [hd, hd] each;
// inside a chunk, sub-chunks of kSub = 16 steps meet the same way.  Every
// row i of the state is a recurrence of its own with the scalar decay
// x_t[i], so in a sub-chunk a (its first step o), with E_t = x_o ... x_{t-1}
// and D_s = x_{s+1} ... x_{o+15} (products within the sub-chunk, each <= 1),
// S_a the state entering it and G_a the cotangent leaving it:
//   dr_t = E_t .* (S_a dy_t) + sum_{s<t} dA[t, s] k_s e_ts + u k_t vd_t
//   dk_s = D_s .* (G_a v_s) + sum_{t>s} dA[t, s] r_t e_ts + u r_s vd_s
//   dv_s = sum_i (k_s .* D_s)[i] G_a[i, :] + sum_{t>s} A[t, s] dy_t
//          + (r_s . u k_s) dy_s
//   dw_s = x_s <S_{s-1}, G_s>_i = G(a) .* <S_a, G_a>_i
//          + sum_{t>s} E_t r_t (S_a dy_t) + sum_{s'<s} D_s' k_s' (G_a v_s')
//          + sum_{s'<s<t} dA[t, s'] r_t k_s' e_ts'
// with dA[t, s] = dy_t . v_s, e_ts = x_{s+1} ... x_{t-1} and A[t, s] =
// sum_i r_t k_s e_ts (s < t within the sub-chunk), vd_t = v_t . dy_t and
// G(a) the sub-chunk's whole decay; the sub-chunk's S and G step by
// S_{a+1} = G(a) .* S_a + (k .* D)^T v and G_{a-1} = G(a) .* G_a +
// (r .* E)^T dy.  dw's rectangle (the last sum) is summed directly, each
// term carrying x_s: the usual reverse sum of r .* dr - k .* dk over the
// chunk cancels terms that carry no x_s and misses 1e-4 under a strong
// decay (tests/test_torch_wkv_bwd_layout.py).
//
// Bound on the card: bytes.  r, k, v read once in bf16, w and dy once in
// fp32, dr, dk, dv, dw written once in fp32 (30 bytes a value: 503 MB at
// 4 x 2048 x 32 heads, 0.150 ms at 3.35 TB/s).  The function's arithmetic
// is ~14 hd^2 a step of a head: 0.015 ms at the bf16 tensor-core peak.
// Measured on an H100 (chip_smoke.py phase 1): ~0.97 ms at 4 x 2048 x 32
// heads, ~15% of the bound: the chunk kernel ~0.14, the state kernel
// ~0.09, the gradient kernel ~0.73, du ~0.02.
//
// Design: four kernels, one wrapper call.
// - wkv_bwd_chunk_kernel, a block per (chunk, h, b), 256 threads: thread
//   (i, a) takes channel i of sub-chunk a for the decays (products of
//   x = expf(w), 1 past T); then per chunk its own state contribution
//   (k .* DS)^T v and cotangent contribution (r .* EP)^T dy (EP, DS: the
//   products from the chunk's start to t - 1 and from s + 1 to its end) and
//   the decay per row to the scratch `states` [chunks, 2, B, H, 64, 64] and
//   `decay` [chunks, B, H, 64].
// - chunk_state_kernel<HD> (warp_mma.cuh, shared with ssd_bwd.cu), a thread
//   per float4 of (b, h, i, j): the chunks in order for S, in reverse for
//   G, the chunk's slot overwritten by the state entering it / the
//   cotangent leaving it (a row's decay a step); writes ds0.
// - wkv_bwd_grad_kernel, a block per (chunk, h, b), 8 warps.  The walks: warp
//   (row group, column half) carries 16 rows x 32 columns of S and then G
//   in registers across the four sub-chunks, writing each as its bf16
//   pair to shared memory, where all 8 warps multiply it with the
//   sub-chunk's rows (S_a dy, G_a v, (k .* D) G_a: an n8 column tile a
//   warp).  The chains: thread (i, a) walks its sub-chunk's 16 steps on the
//   CUDA cores (dr, dk, dw's sums and rectangle, A's entries summed over a
//   warp's 32 channels); then dv on the tensor cores.
// - wkv_bwd_sum_kernel: du over (b, chunk) in order.  No float atomics: every
//   call repeats bitwise.
// - Products: mma.sync m16n8k16 (warp_mma.cuh), bf16 operands, fp32 sums.
//   r, k and v are bf16 and enter exactly; dy, S, G, r .* E, k .* D and A
//   are split into the pair hi = bf16(v), lo = bf16(v - hi): two mma for a
//   pair against a bf16 operand, three for two pairs (one rounding of A
//   alone gives ~1.4e-3 norm-wise in dv in the numpy model, past the 1e-4
//   the card's check holds the kernel to).
// - Every decay is a product of x = expf(w) (expf: under a weak decay, ex2's
//   error compounds over the chunks), never an exponent of a difference of
//   sums, so none overflows; rows past T take x = 1 and zeros elsewhere,
//   so they leave every sum.
//
// Tried on an H100 at 4 x 2048 x 32 heads and not kept (throw-away builds,
// each timed against the one before in one call): one level of chains over
// the 64 steps with dw as the reverse sums of r .* dr - k .* dk (the numpy
// model misses 1e-4 under the strong decay: 2e-4); the first two-level
// kernel (E and D kept as arrays, the rectangle as 560 products with
// dA from shared memory, w read a value a thread: 2.39 ms, 1080 bytes of
// spills; E and D as the chains' own running products, the rectangle from
// the prefix sums of each row's terms, w staged by float4: 1.08 ms); A's
// rows by a reduce-scatter over the lanes (16 shuffles a row, each level
// waiting on the last: the gradient kernel 0.84 ms, against 0.73 with a
// butterfly an entry), two rows a reduce-scatter (1.07 ms, a stack frame).
// Neither dv's state term in shared memory (255 registers down to 174) nor
// the walk tiles taken by turns (two barriers a step down to one) moved
// the time.  By ablation the gradient kernel's time is ~0.27 ms the rows'
// chains (dr, A), ~0.25 the two walks, ~0.1 dk and dw, ~0.08 dv: one block
// an SM (187 KB of shared memory), eight warps, each phase a dependent
// chain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int HD = 64;            // head dim, the one instance
constexpr int Q = 64;             // steps a chunk
constexpr int kSub = 16;          // steps a sub-chunk
constexpr int kSubs = Q / kSub;   // sub-chunks a chunk
constexpr int kThreads = 256;     // thread (channel i, sub-chunk a)
constexpr int kRowF = 68;         // floats a row of T2 / T3
constexpr int kSplit = 2;         // bf16 terms: hi, lo
constexpr int kSmemMax = 232448;  // a block's dynamic limit
constexpr int kTile = Q * kRow;   // elements of a 64-row bf16 tile

struct Args {
  const bf16 *r, *k, *v;
  const float *w, *u, *s0, *dy, *dsT;
  float *dr, *dk, *dv, *dw, *du, *ds0;
  float *states, *decay, *du_part;
  int B, T, H, chunks;
};

struct ChunkSmem {
  float w[Q][kRowF];              // the chunk's w, [t][i] (0 past T)
  bf16 r[Q * HD], k[Q * HD];      // [t][i]
  bf16 v[kTile];                  // [s][j]
  bf16 dy[kSplit][kTile];         // [t][j]
  bf16 kd[kSplit][kTile];         // k .* DS, [s][i]
  bf16 re[kSplit][kTile];         // r .* EP, [t][i]
  float gdec[kSubs][HD];          // the sub-chunks' decays
};

struct GradSmem {
  bf16 r[Q * HD], k[Q * HD];      // [t][i] (read by the chains)
  bf16 v[kTile];                  // [s][j]
  bf16 dy[kSplit][kTile];         // [t][j]
  bf16 re[kSplit][kTile];         // r .* E, [t][i]
  bf16 kd[kSplit][kTile];         // k .* D, [s][i]
  bf16 wt[2][kSplit][kTile];      // the walks' S_a / G_a, [i][j], by turns
  float t2[Q][kRowF];             // (S_a dy_t)[i]; w before the walks
  float t3[Q][kRowF];             // (G_a v_s)[i]
  float dvs[Q][kRowF];            // dv's state term, (k .* D) G_a
  float da[kSubs][kSub][kSub];    // dy_t . v_s, s < t in a sub-chunk
  float ad[kSubs][2][kSub][kSub]; // A[t, s] over the channels of a warp
  float gdec[kSubs][HD];          // the sub-chunks' decays
  float rsp[2][kSubs][HD];        // <S_a, G_a>_i over a column half
  float vd[Q], ruk[Q], u[HD];     // v_t . dy_t, r_t . u k_t
  float dup[kSubs][HD];           // du over a sub-chunk
};
static_assert(sizeof(GradSmem) <= kSmemMax, "rwkv6_bwd shared memory");

// the chunk state / cotangent slab (kind 0: the state, 1: the cotangent) of
// (c, b, h): states is [chunks][2][B][H][64][64], one chunk's slabs one
// contiguous stretch for the state kernel's threads
__device__ __forceinline__ float* slab(const Args& a, int c, int kind, int b,
                                       int h) {
  return a.states +
         (((size_t)(2 * c + kind) * a.B + b) * a.H + h) * (size_t)(HD * HD);
}

// 64 rows of 64 bf16 into a tile of ld elements a row, of 64 fp32 into the
// bf16 pair of tiles (warp_mma.cuh's loads; rows at or past nv zeros)
__device__ __forceinline__ void load_rows(bf16* tile, int ld, const bf16* base,
                                          long long stride, int nv) {
  uint4 v[512 / kThreads];
  fetch_rows<kThreads>(v, base, stride, nv);
  store_rows<kThreads>(tile, ld, v);
}

__device__ __forceinline__ void load_split(bf16* hi, bf16* lo,
                                           const float* base, long long stride,
                                           int nv) {
  float4 v[1024 / kThreads];
  fetch_f32<kThreads>(v, base, stride, nv);
  store_split<kThreads>(hi, lo, v, nullptr);
}

// 64 rows of 64 fp32 into a [64][kRowF] tile (rows at or past nv zeros)
__device__ __forceinline__ void load_f32(float (*tile)[kRowF],
                                         const float* base, long long stride,
                                         int nv) {
  float4 v[1024 / kThreads];
  fetch_f32<kThreads>(v, base, stride, nv);
#pragma unroll
  for (int k = 0; k < 1024 / kThreads; ++k) {
    const int i = threadIdx.x + kThreads * k, t = i >> 4, col = (i & 15) * 4;
    *reinterpret_cast<float4*>(&tile[t][col]) = v[k];
  }
}

// thread (i, a): x = e^w of channel i over sub-chunk a's steps, from the
// staged w (0 past T, so x = 1 there)
__device__ __forceinline__ void stage_x(float (&x)[kSub],
                                        const float (*w)[kRowF], int i,
                                        int sub) {
#pragma unroll
  for (int s = 0; s < kSub; ++s) x[s] = expf(w[kSub * sub + s][i]);
}

// E_s = x_0 ... x_{s-1}, D_s = x_{s+1} ... x_15, G = x_0 ... x_15, products
// in step order
__device__ __forceinline__ void sub_decays(const float (&x)[kSub],
                                           float (&E)[kSub], float (&D)[kSub],
                                           float& G) {
  E[0] = 1.f;
#pragma unroll
  for (int s = 1; s < kSub; ++s) E[s] = E[s - 1] * x[s - 1];
  D[kSub - 1] = 1.f;
#pragma unroll
  for (int s = kSub - 2; s >= 0; --s) D[s] = D[s + 1] * x[s + 1];
  G = E[kSub - 1] * x[kSub - 1];
}

// the bf16 pair of v at column i of row t of a pair of tiles
__device__ __forceinline__ void put_pair(bf16* hi, bf16* lo, int t, int i,
                                         float v) {
  const bf16 h = __float2bfloat16_rn(v);
  hi[t * kRow + i] = h;
  lo[t * kRow + i] = __float2bfloat16_rn(v - __bfloat162float(h));
}

// row[s] = the sum over the warp's 32 lanes of p[s], s < n (a constant once
// inlined): an xor butterfly a entry, the n entries' shuffles independent
// of each other at every level (a reduce-scatter, 16 shuffles at n = 16
// instead of 5 n, ran slower: each level's selects and shuffles depend on
// the last); every lane ends with the same bits, lane 0 writes.
__device__ __forceinline__ void row_sums(float* row, float (&p)[kSub], int n,
                                         int lane) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
    for (int s = 0; s < kSub; ++s)
      if (s < n) p[s] += __shfl_xor_sync(0xffffffffu, p[s], off);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kSub; ++s)
      if (s < n) row[s] = p[s];
  }
}

// ---------------------------------------------------------------------------
// pass 1: the chunks' own state and cotangent contributions
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
wkv_bwd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, nv = min(Q, a.T - t0);
  const size_t row0 = ((size_t)b * a.T + t0) * a.H + h;
  const long long rs = (long long)a.H * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int i = threadIdx.x & (HD - 1), sub = threadIdx.x >> 6;
  load_rows(sm.r, HD, a.r + row0 * HD, rs, nv);
  load_rows(sm.k, HD, a.k + row0 * HD, rs, nv);
  load_rows(sm.v, kRow, a.v + row0 * HD, rs, nv);
  load_split(sm.dy[0], sm.dy[1], a.dy + row0 * HD, rs, nv);
  load_f32(sm.w, a.w + row0 * HD, rs, nv);
  __syncthreads();
  float x[kSub], E[kSub], D[kSub], gd;
  stage_x(x, sm.w, i, sub);
  sub_decays(x, E, D, gd);
  sm.gdec[sub][i] = gd;
  __syncthreads();
  // EP = (the decay before the sub-chunk) E, DS = D (the decay after it)
  float pre = 1.f, suf = 1.f;
#pragma unroll
  for (int s2 = 0; s2 < kSubs; ++s2)
    if (s2 < sub) pre *= sm.gdec[s2][i];
#pragma unroll
  for (int s2 = kSubs - 1; s2 >= 0; --s2)
    if (s2 > sub) suf *= sm.gdec[s2][i];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    const int t = kSub * sub + s;
    const float rv = __bfloat162float(sm.r[t * HD + i]);
    const float kv = __bfloat162float(sm.k[t * HD + i]);
    put_pair(sm.re[0], sm.re[1], t, i, rv * (pre * E[s]));
    put_pair(sm.kd[0], sm.kd[1], t, i, kv * (D[s] * suf));
  }
  if (sub == kSubs - 1)
    a.decay[(((size_t)c * a.B + b) * a.H + h) * HD + i] = pre * gd;
  __syncthreads();
  // rows i of warp (rg, ch), its columns 32 ch ..: X = (k DS)^T v,
  // Y = (r EP)^T dy
  const int rg = warp & 3, ch = warp >> 2;
  float X[4][4], Y[4][4];
  zero(X);
  zero(Y);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t xh[4], xl[4], yh[4], yl[4];
    lda_t(xh, sm.kd[0], 16 * rg, 16 * kk);
    lda_t(xl, sm.kd[1], 16 * rg, 16 * kk);
    lda_t(yh, sm.re[0], 16 * rg, 16 * kk);
    lda_t(yl, sm.re[1], 16 * rg, 16 * kk);
#pragma unroll
    for (int jl = 0; jl < 2; ++jl) {
      const int n0 = 32 * ch + 16 * jl;
      uint32_t bv[4], bh[4], bl[4];
      ldb_t(bv, sm.v, n0, 16 * kk);
      mma2(X, jl, xh, bv);
      mma2(X, jl, xl, bv);
      ldb_t(bh, sm.dy[0], n0, 16 * kk);
      ldb_t(bl, sm.dy[1], n0, 16 * kk);
      mma2(Y, jl, yh, bh);
      mma2(Y, jl, yh, bl);
      mma2(Y, jl, yl, bh);
    }
  }
  float* xs = slab(a, c, 0, b, h);
  float* ys = slab(a, c, 1, b, h);
#pragma unroll
  for (int jt = 0; jt < 4; ++jt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * rg + g + 8 * half, col = 32 * ch + 8 * jt + 2 * q;
      *reinterpret_cast<float2*>(xs + row * HD + col) =
          make_float2(X[jt][2 * half], X[jt][2 * half + 1]);
      *reinterpret_cast<float2*>(ys + row * HD + col) =
          make_float2(Y[jt][2 * half], Y[jt][2 * half + 1]);
    }
}

// ---------------------------------------------------------------------------
// pass 3: every gradient of a chunk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
wkv_bwd_grad_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, nv = min(Q, a.T - t0);
  const size_t row0 = ((size_t)b * a.T + t0) * a.H + h;
  const long long rs = (long long)a.H * HD;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int i = threadIdx.x & (HD - 1), sub = threadIdx.x >> 6;   // chains
  const int rg = warp & 3, ch = warp >> 2;                        // walks

  load_rows(sm.r, HD, a.r + row0 * HD, rs, nv);
  load_rows(sm.k, HD, a.k + row0 * HD, rs, nv);
  load_rows(sm.v, kRow, a.v + row0 * HD, rs, nv);
  load_split(sm.dy[0], sm.dy[1], a.dy + row0 * HD, rs, nv);
  load_f32(sm.t2, a.w + row0 * HD, rs, nv);
  if (threadIdx.x < HD) sm.u[threadIdx.x] = a.u[h * HD + threadIdx.x];
  // the walks' S (rows 16 rg .., columns 32 ch ..) from the entering state,
  // G from the leaving cotangent
  float S[4][4], G[4][4];
  {
    const float* sin = slab(a, c, 0, b, h);
    const float* gout = slab(a, c, 1, b, h);
#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = (16 * rg + g + 8 * half) * HD + 32 * ch + 8 * jt + 2 * q;
        const float2 sv = *reinterpret_cast<const float2*>(sin + o);
        const float2 gv = *reinterpret_cast<const float2*>(gout + o);
        S[jt][2 * half] = sv.x;
        S[jt][2 * half + 1] = sv.y;
        G[jt][2 * half] = gv.x;
        G[jt][2 * half + 1] = gv.y;
      }
  }
  __syncthreads();
  // thread (i, sub): its sub-chunk's decays, r .* E and k .* D as pairs
  float x[kSub];
  stage_x(x, sm.t2, i, sub);
  {
    float E[kSub], D[kSub], gd;
    sub_decays(x, E, D, gd);
    sm.gdec[sub][i] = gd;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      const int t = kSub * sub + s;
      put_pair(sm.re[0], sm.re[1], t, i,
               __bfloat162float(sm.r[t * HD + i]) * E[s]);
      put_pair(sm.kd[0], sm.kd[1], t, i,
               __bfloat162float(sm.k[t * HD + i]) * D[s]);
    }
  }
  if (warp < kSubs) {
    // dA = dy v^T within sub-chunk `warp`, s < t
    const int o = kSub * warp;
    float acc[2][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4], bf[4];
      lda(ah, sm.dy[0], o, 16 * kk);
      lda(al, sm.dy[1], o, 16 * kk);
      ldb(bf, sm.v, o, 16 * kk);
      mma(acc[0], ah, bf[0], bf[1]);
      mma(acc[1], ah, bf[2], bf[3]);
      mma(acc[0], al, bf[0], bf[1]);
      mma(acc[1], al, bf[2], bf[3]);
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = g + 8 * half, s = 8 * jt + 2 * q + e;
          sm.da[warp][t][s] = s < t ? acc[jt][2 * half + e] : 0.f;
        }
  } else {
    // v_t . dy_t (dy in fp32) and r_t . u k_t, rows 16 (warp - 4) ..
    for (int t = kSub * (warp - kSubs); t < kSub * (warp - kSubs + 1); ++t) {
      float vd = 0.f, rk = 0.f;
      if (t < nv) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = lane + 32 * e;
          const float dyv = a.dy[row0 * HD + t * rs + j];
          vd = fmaf(__bfloat162float(sm.v[t * kRow + j]), dyv, vd);
          rk = fmaf(__bfloat162float(sm.r[t * HD + j]) * sm.u[j],
                    __bfloat162float(sm.k[t * HD + j]), rk);
        }
      }
      vd = warp_sum(vd);
      rk = warp_sum(rk);
      if (lane == 0) {
        sm.vd[t] = vd;
        sm.ruk[t] = rk;
      }
    }
  }
  __syncthreads();

  // ---- the forward walk: S_a into shared memory, T2 = S_a dy, the update;
  // the two tiles take S_a by turns, so a step needs one barrier
  float Sa[kSubs][4][4];
#pragma unroll
  for (int sb = 0; sb < kSubs; ++sb) {
#pragma unroll
    for (int jt = 0; jt < 4; ++jt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o =
            (16 * rg + g + 8 * half) * kRow + 32 * ch + 8 * jt + 2 * q;
        uint32_t hi, lo;
        split2(S[jt][2 * half], S[jt][2 * half + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sm.wt[sb & 1][0] + o) = hi;
        *reinterpret_cast<uint32_t*>(sm.wt[sb & 1][1] + o) = lo;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          Sa[sb][jt][2 * half + e] = S[jt][2 * half + e];
      }
    __syncthreads();
    {   // T2 rows t of the sub-chunk, columns i 8 warp ..
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4], h0, h1, l0, l1;
        lda(ah, sm.dy[0], kSub * sb, 16 * kk);
        lda(al, sm.dy[1], kSub * sb, 16 * kk);
        ldb1(h0, h1, sm.wt[sb & 1][0], 8 * warp, 16 * kk);
        ldb1(l0, l1, sm.wt[sb & 1][1], 8 * warp, 16 * kk);
        mma(acc, ah, h0, h1);
        mma(acc, ah, l0, l1);
        mma(acc, al, h0, h1);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            &sm.t2[kSub * sb + g + 8 * half][8 * warp + 2 * q]) =
            make_float2(acc[2 * half], acc[2 * half + 1]);
    }
    {   // S <- G(sb) .* S + (k .* D)^T v over the sub-chunk
      float X[4][4];
      zero(X);
      uint32_t xh[4], xl[4];
      lda_t(xh, sm.kd[0], 16 * rg, kSub * sb);
      lda_t(xl, sm.kd[1], 16 * rg, kSub * sb);
#pragma unroll
      for (int jl = 0; jl < 2; ++jl) {
        uint32_t bv[4];
        ldb_t(bv, sm.v, 32 * ch + 16 * jl, kSub * sb);
        mma2(X, jl, xh, bv);
        mma2(X, jl, xl, bv);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float gdr = sm.gdec[sb][16 * rg + g + 8 * half];
#pragma unroll
        for (int jt = 0; jt < 4; ++jt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            S[jt][2 * half + e] =
                fmaf(gdr, S[jt][2 * half + e], X[jt][2 * half + e]);
      }
    }
  }

  // ---- the reverse walk: G_a into shared memory (the tiles by turns after
  // S_a's), <S_a, G_a>, T3 = G_a v, dv's state term (k .* D) G_a, the update
#pragma unroll
  for (int sb = kSubs - 1; sb >= 0; --sb) {
    bf16(*gt)[kTile] = sm.wt[(kSubs - 1 - sb) & 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float p = 0.f;
#pragma unroll
      for (int jt = 0; jt < 4; ++jt) {
        const int o =
            (16 * rg + g + 8 * half) * kRow + 32 * ch + 8 * jt + 2 * q;
        uint32_t hi, lo;
        split2(G[jt][2 * half], G[jt][2 * half + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(gt[0] + o) = hi;
        *reinterpret_cast<uint32_t*>(gt[1] + o) = lo;
        p = fmaf(Sa[sb][jt][2 * half], G[jt][2 * half], p);
        p = fmaf(Sa[sb][jt][2 * half + 1], G[jt][2 * half + 1], p);
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (q == 0) sm.rsp[ch][sb][16 * rg + g + 8 * half] = p;
    }
    __syncthreads();
    {   // T3 rows s of the sub-chunk, columns i 8 warp ..; dv's state term
        // rows s, columns j 8 warp ..
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, dvs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t va[4], kh[4], kl[4], h0, h1, l0, l1;
        lda(va, sm.v, kSub * sb, 16 * kk);
        ldb1(h0, h1, gt[0], 8 * warp, 16 * kk);
        ldb1(l0, l1, gt[1], 8 * warp, 16 * kk);
        mma(acc, va, h0, h1);
        mma(acc, va, l0, l1);
        lda(kh, sm.kd[0], kSub * sb, 16 * kk);
        lda(kl, sm.kd[1], kSub * sb, 16 * kk);
        ldb1_t(h0, h1, gt[0], 8 * warp, 16 * kk);
        ldb1_t(l0, l1, gt[1], 8 * warp, 16 * kk);
        mma(dvs, kh, h0, h1);
        mma(dvs, kh, l0, l1);
        mma(dvs, kl, h0, h1);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            &sm.dvs[kSub * sb + g + 8 * half][8 * warp + 2 * q]) =
            make_float2(dvs[2 * half], dvs[2 * half + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            &sm.t3[kSub * sb + g + 8 * half][8 * warp + 2 * q]) =
            make_float2(acc[2 * half], acc[2 * half + 1]);
    }
    {   // G <- G(sb) .* G + (r .* E)^T dy over the sub-chunk
      float Y[4][4];
      zero(Y);
      uint32_t yh[4], yl[4];
      lda_t(yh, sm.re[0], 16 * rg, kSub * sb);
      lda_t(yl, sm.re[1], 16 * rg, kSub * sb);
#pragma unroll
      for (int jl = 0; jl < 2; ++jl) {
        uint32_t bh[4], bl[4];
        ldb_t(bh, sm.dy[0], 32 * ch + 16 * jl, kSub * sb);
        ldb_t(bl, sm.dy[1], 32 * ch + 16 * jl, kSub * sb);
        mma2(Y, jl, yh, bh);
        mma2(Y, jl, yh, bl);
        mma2(Y, jl, yl, bh);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float gdr = sm.gdec[sb][16 * rg + g + 8 * half];
#pragma unroll
        for (int jt = 0; jt < 4; ++jt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            G[jt][2 * half + e] =
                fmaf(gdr, G[jt][2 * half + e], Y[jt][2 * half + e]);
      }
    }
  }
  __syncthreads();    // T3, dv's state term and <S_a, G_a> are written

  // ---- the chains: thread (i, sub), its sub-chunk's 16 steps
  {
    const int o = kSub * sub;
    float rv[kSub], kv[kSub];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      rv[s] = __bfloat162float(sm.r[(o + s) * HD + i]);
      kv[s] = __bfloat162float(sm.k[(o + s) * HD + i]);
    }
    const float ui = sm.u[i];
    const float (*dA)[kSub] = sm.da[sub];
    float(*ad)[kSub] = sm.ad[sub][warp & 1];
    float rect[kSub], sufs[kSub], dup = 0.f, E = 1.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) rect[s] = 0.f;
    // row tt: dr, A[tt, s] over this warp's channels, the rectangle's terms
    // of row tt (their prefix sums over s' < s); E = x_o ... x_{o+tt-1}
#pragma unroll
    for (int tt = 0; tt < kSub; ++tt) {
      float p[kSub], d[kSub];
      float e = 1.f, acc = 0.f;
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        p[s] = 0.f;
        d[s] = 0.f;
        if (s < tt) {
          const float cc = kv[s] * e;
          d[s] = dA[tt][s] * cc;
          acc += d[s];
          p[s] = rv[tt] * cc;
          e *= x[s];
        }
      }
      row_sums(ad[tt], p, tt, lane);
      float pr = 0.f;
#pragma unroll
      for (int s = 1; s < tt; ++s) {
        pr += d[s - 1];
        rect[s] = fmaf(rv[tt], pr, rect[s]);
      }
      const int t = o + tt;
      const float t2 = sm.t2[t][i], vd = sm.vd[t];
      sufs[tt] = E * rv[tt] * t2;
      dup = fmaf(rv[tt] * kv[tt], vd, dup);
      if (t < nv)
        a.dr[row0 * HD + t * rs + i] = E * t2 + acc + ui * kv[tt] * vd;
      E *= x[tt];
    }
    // the sums over t > s of E_t r_t T2[t]
    float run = 0.f;
#pragma unroll
    for (int s = kSub - 1; s >= 0; --s) {
      const float r_ = sufs[s];
      sufs[s] = run;
      run += r_;
    }
    // dk and dw: G(a) <S_a, G_a>, the suffix, the prefix of D k T3, the
    // rectangle; D_s = x_{s+1} ... x_{o+15} is the chain's e at its end
    const float bnd = E * (sm.rsp[0][sub][i] + sm.rsp[1][sub][i]);
    float pre = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      float e = 1.f, acc = 0.f;
#pragma unroll
      for (int tt = s + 1; tt < kSub; ++tt) {
        acc = fmaf(dA[tt][s], rv[tt] * e, acc);
        e *= x[tt];
      }
      const int t = o + s;
      const float t3 = sm.t3[t][i];
      if (t < nv) {
        a.dk[row0 * HD + t * rs + i] = e * t3 + acc + ui * rv[s] * sm.vd[t];
        a.dw[row0 * HD + t * rs + i] = bnd + sufs[s] + pre + rect[s];
      }
      pre += e * kv[s] * t3;
    }
    sm.dup[sub][i] = dup;
  }
  __syncthreads();

  // ---- dv: warp -> columns j 8 warp .., every sub-chunk: the state term,
  // A^T dy over the sub-chunk (A's halves summed), (r . u k) dy
#pragma unroll
  for (int sb = 0; sb < kSubs; ++sb) {
    const int o = kSub * sb;
    uint32_t ah[4], al[4];
#pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int s = g + 8 * (reg & 1), t = 2 * q + 8 * (reg >> 1);
      float v2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v2[e] = t + e > s
                    ? sm.ad[sb][0][t + e][s] + sm.ad[sb][1][t + e][s]
                    : 0.f;
      split2(v2[0], v2[1], ah[reg], al[reg]);
    }
    float dvs[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 st = *reinterpret_cast<const float2*>(
          &sm.dvs[o + g + 8 * half][8 * warp + 2 * q]);
      dvs[2 * half] = st.x;
      dvs[2 * half + 1] = st.y;
    }
    uint32_t h0, h1, l0, l1;
    ldb1_t(h0, h1, sm.dy[0], 8 * warp, o);
    ldb1_t(l0, l1, sm.dy[1], 8 * warp, o);
    mma(dvs, ah, h0, h1);
    mma(dvs, ah, l0, l1);
    mma(dvs, al, h0, h1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = o + g + 8 * half, j = 8 * warp + 2 * q;
      if (s < nv) {
        const float2 dh = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sm.dy[0] + s * kRow + j));
        const float2 dl = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sm.dy[1] + s * kRow + j));
        const float rk = sm.ruk[s];
        *reinterpret_cast<float2*>(a.dv + row0 * HD + s * rs + j) =
            make_float2(dvs[2 * half] + rk * (dh.x + dl.x),
                        dvs[2 * half + 1] + rk * (dh.y + dl.y));
      }
    }
  }
  if (threadIdx.x < HD)
    a.du_part[(((size_t)b * a.chunks + c) * a.H + h) * HD + threadIdx.x] =
        sm.dup[0][threadIdx.x] + sm.dup[1][threadIdx.x] +
        sm.dup[2][threadIdx.x] + sm.dup[3][threadIdx.x];
}

// ---------------------------------------------------------------------------
// pass 4: du over (b, chunk), in order
// ---------------------------------------------------------------------------

__global__ void wkv_bwd_sum_kernel(const Args a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= a.H * HD) return;
  float acc = 0.f;
  for (long long k = 0; k < (long long)a.B * a.chunks; ++k)
    acc += a.du_part[k * a.H * HD + n];
  a.du[n] = acc;
}

}  // namespace

// r, k, v: bf16 [B, T, H, 64]; w, dy: fp32 [B, T, H, 64]; u: fp32 [H, 64];
// s0, dsT: fp32 [B, H, 64, 64] or null (zeros); every tensor contiguous and
// 16-byte aligned (loaded in 16-byte vectors).  Writes dr, dk, dv, dw (fp32 [B, T, H,
// 64]), du (fp32 [H, 64]) and ds0 (fp32 [B, H, 64, 64]).  Scratch: states
// (fp32 [ceil(T / 64), 2, B, H, 64, 64]), decay (fp32 [ceil(T / 64), B, H,
// 64]), du_part (fp32 [B, ceil(T / 64), H, 64]).  Returns
// cudaGetLastError().
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* dy, const void* dsT, void* dr,
                             void* dk, void* dv, void* dw, void* du,
                             void* ds0, void* states, void* decay,
                             void* du_part, int b, int t, int h, int hd,
                             void* stream) {
  if (b < 0 || t < 0 || h < 0 || hd != HD) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  Args a;
  a.r = (const bf16*)r;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.w = (const float*)w;
  a.u = (const float*)u;
  a.s0 = (const float*)s0;
  a.dy = (const float*)dy;
  a.dsT = (const float*)dsT;
  a.dr = (float*)dr;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.dw = (float*)dw;
  a.du = (float*)du;
  a.ds0 = (float*)ds0;
  a.states = (float*)states;
  a.decay = (float*)decay;
  a.du_part = (float*)du_part;
  a.B = b;
  a.T = t;
  a.H = h;
  a.chunks = (t + Q - 1) / Q;
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      wkv_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(ChunkSmem));
  static const cudaError_t attr3 = cudaFuncSetAttribute(
      wkv_bwd_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(GradSmem));
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr3 != cudaSuccess) return (int)attr3;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(a.chunks, h, b);
  if (a.chunks > 0)
    wkv_bwd_chunk_kernel<<<grid, kThreads, sizeof(ChunkSmem), s>>>(a);
  const long long elems = (long long)b * h * (HD * HD / 4);
  chunk_state_kernel<HD><<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(
      a.states, a.decay, a.s0, a.dsT, a.ds0, (long long)b * h, a.chunks);
  if (a.chunks > 0)
    wkv_bwd_grad_kernel<<<grid, kThreads, sizeof(GradSmem), s>>>(a);
  wkv_bwd_sum_kernel<<<(h * HD + 255) / 256, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}
