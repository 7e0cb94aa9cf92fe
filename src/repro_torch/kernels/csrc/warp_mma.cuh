// Warp-level tensor-core helpers for Hopper (sm_90a) shared by the chunked
// backward kernels of the recurrences (ssd_bwd.cu, rwkv6_bwd.cu): mma.sync
// m16n8k16 with bf16 operands and fp32 sums, its fragments from bf16 tiles
// in shared memory by ldmatrix, an accumulator as the bf16 hi / lo pair
// (hopper.cuh's split2) of the A fragment of the next product.  A tile row
// is kRow bf16 elements (144 bytes: 16-byte aligned for ldmatrix, and a
// phase's 8 rows fall on 8 distinct bank quads).  Also the loads of a
// 64-row tile into shared memory by a block's threads, and the backwards'
// common pass 2, the scan of the chunk states.
//
// mma.sync rather than hopper.cuh's wgmma: one wgmma covers a warpgroup's
// 64 rows, so a causal product cannot skip the column tiles that a warp's
// 16 rows do not need.  Measured on an H100 by mma_forms.cu (chip_smoke.py
// phase 1r) at ssd_bwd_grad_kernel's grid: wgmma_rs takes ~2/3 of
// mma.sync's time for a whole product, but mma.sync over the causal half
// (bounds known when compiled) less than wgmma over the whole, so at that
// kernel's mix of products the two forms are within ~10%.
// kernels/_build.py hashes every csrc/*.cuh into each library's build key.
#pragma once

#include "hopper.cuh"     // pack_bf16, split2

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRow = 72;          // bf16 elements a shared-memory tile row

// mma.sync m16n8k16 and its fragments.  Lane l of a warp: g = l / 4, q =
// l % 4.  A (16 x 16): registers (row g, k 2q..2q+1), (row g + 8, ...),
// (row g, k 2q+8..), (row g + 8, k 2q+8..).  B (16 x 8): (k 2q..2q+1,
// column g), (k 2q+8.., column g).  The accumulator (16 x 8): (row g,
// columns 2q, 2q + 1), (row g + 8, ...): registers 0-3.

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments from shared memory by ldmatrix: four 8 x 8 bf16 matrices,
// lane i giving the address of row i % 8 of matrix i / 8 (16 bytes; a
// tile's 144-byte rows put a phase's 8 rows in 8 distinct bank quads).
// Lane l receives, of matrix j, stored row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1; with .trans stored rows 2 (l % 4), 2 (l % 4) + 1 of
// column l / 4.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// A fragment of rows m0.., k k0.. of a tile stored [m][k]
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int m0,
                                    int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm(a, t + (m0 + (j & 1) * 8 + r) * kRow + k0 + (j >> 1) * 8);
}

// A fragment of rows m0.., k k0.. of a tile stored [k][m]
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* t, int m0,
                                      int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm_t(a, t + (k0 + (j >> 1) * 8 + r) * kRow + m0 + (j & 1) * 8);
}

// B fragments of the column tiles n0.. and n0 + 8.., k k0.., of a tile
// stored [n][k]: b[0], b[1] of the first, b[2], b[3] of the second
__device__ __forceinline__ void ldb(uint32_t (&b)[4], const bf16* t, int n0,
                                    int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm(b, t + (n0 + (j >> 1) * 8 + r) * kRow + k0 + (j & 1) * 8);
}

// the same of a tile stored [k][n]
__device__ __forceinline__ void ldb_t(uint32_t (&b)[4], const bf16* t, int n0,
                                      int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm_t(b, t + (k0 + (j & 1) * 8 + r) * kRow + n0 + (j >> 1) * 8);
}

// acc[2 jj], acc[2 jj + 1] += a . b (b from ldb / ldb_t)
template <int J>
__device__ __forceinline__ void mma2(float (&acc)[J][4], int jj,
                                     const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma(acc[2 * jj], a, b[0], b[1]);
  mma(acc[2 * jj + 1], a, b[2], b[3]);
}

// the accumulator tiles 2kk, 2kk + 1 of a 16 x 64 product as the bf16 pair
// of the A fragment of k16 step kk
__device__ __forceinline__ void acc_to_a(const float (&acc)[8][4], int kk,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(acc[2 * kk][0], acc[2 * kk][1], hi[0], lo[0]);
  split2(acc[2 * kk][2], acc[2 * kk][3], hi[1], lo[1]);
  split2(acc[2 * kk + 1][0], acc[2 * kk + 1][1], hi[2], lo[2]);
  split2(acc[2 * kk + 1][2], acc[2 * kk + 1][3], hi[3], lo[3]);
}

template <int J>
__device__ __forceinline__ void zero(float (&a)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[j][r] = 0.f;
}

// B fragment of the one column tile n0.., k k0.., of a tile stored [n][k]
// (ldmatrix .x2: lanes 0-15 give the addresses)
__device__ __forceinline__ void ldb1(uint32_t& b0, uint32_t& b1, const bf16* t,
                                     int n0, int k0) {
  const int lane = threadIdx.x & 15;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
      : "=r"(b0), "=r"(b1)
      : "r"((uint32_t)__cvta_generic_to_shared(
          t + (n0 + (lane & 7)) * kRow + k0 + (lane >> 3) * 8)));
}

// the same of a tile stored [k][n]
__device__ __forceinline__ void ldb1_t(uint32_t& b0, uint32_t& b1,
                                       const bf16* t, int n0, int k0) {
  const int lane = threadIdx.x & 15;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(b0), "=r"(b1)
      : "r"((uint32_t)__cvta_generic_to_shared(
          t + (k0 + (lane >> 3) * 8 + (lane & 7)) * kRow + n0)));
}

// Loads of a 64-row tile by the kT threads of a block: every load issued
// into registers first (fetch_*), then the tile written to shared memory
// (store_*), so that a block waits one round trip a tile, not one a row.
// Row t of a bf16 tile: 64 values at base + t * stride (16-byte aligned),
// in uint4; of an fp32 tile, in float4.  Rows at or past nv: zeros.
template <int kT>
__device__ __forceinline__ void fetch_rows(uint4 (&v)[512 / kT],
                                           const bf16* base, long long stride,
                                           int nv) {
#pragma unroll
  for (int k = 0; k < 512 / kT; ++k) {
    const int i = threadIdx.x + kT * k, t = i >> 3, col = (i & 7) * 8;
    v[k] = t < nv ? *reinterpret_cast<const uint4*>(base + t * stride + col)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// into a tile of ld elements a row
template <int kT>
__device__ __forceinline__ void store_rows(bf16* tile, int ld,
                                           const uint4 (&v)[512 / kT]) {
#pragma unroll
  for (int k = 0; k < 512 / kT; ++k) {
    const int i = threadIdx.x + kT * k, t = i >> 3, col = (i & 7) * 8;
    *reinterpret_cast<uint4*>(tile + t * ld + col) = v[k];
  }
}

template <int kT>
__device__ __forceinline__ void fetch_f32(float4 (&v)[1024 / kT],
                                          const float* base, long long stride,
                                          int nv) {
#pragma unroll
  for (int k = 0; k < 1024 / kT; ++k) {
    const int i = threadIdx.x + kT * k, t = i >> 4, col = (i & 15) * 4;
    v[k] = t < nv ? *reinterpret_cast<const float4*>(base + t * stride + col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the fp32 tile, row t scaled by scale[t] (or 1), as the bf16 pair of
// tiles of kRow elements a row
template <int kT>
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo,
                                            const float4 (&v)[1024 / kT],
                                            const float* scale) {
#pragma unroll
  for (int k = 0; k < 1024 / kT; ++k) {
    const int i = threadIdx.x + kT * k, t = i >> 4, col = (i & 15) * 4;
    const float f = scale ? scale[t] : 1.f;
    uint32_t h0, l0, h1, l1;
    split2(v[k].x * f, v[k].y * f, h0, l0);
    split2(v[k].z * f, v[k].w * f, h1, l1);
    *reinterpret_cast<uint2*>(hi + t * kRow + col) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(lo + t * kRow + col) = make_uint2(l0, l1);
  }
}

// the sum over the warp's 32 lanes (an xor butterfly: every lane ends with
// the same bits)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Pass 2 of both chunked backwards, a thread per float4 of the [64, 64]
// slabs of the bh = B H (b, h) pairs: the state entering each chunk, in
// order from `first` (h0 / s0), and the cotangent leaving it, in reverse
// from `last` (the final state's); either null: zeros.  `states` is
// [chunks][2][bh][64 x 64] fp32, chunk-major (a chunk's slabs one
// contiguous stretch), and holds each chunk's own contribution (pass 1),
// which the entering state (kind 0) or leaving cotangent (kind 1)
// overwrites; `decay` is [chunks][bh][kDecayRows], the chunk's decay of a
// (b, h) (kDecayRows 1: SSD's e^{L_Q}) or of each state row (64: WKV's,
// per channel); `out` receives the cotangent entering chunk 0 (dh0 / ds0).
// fmaf in a fixed order: every call repeats bitwise.
template <int kDecayRows>
__global__ void chunk_state_kernel(float* states, const float* decay,
                                   const float* first, const float* last,
                                   float* out, long long bh, int chunks) {
  const long long slab4 = bh * (64 * 64 / 4);
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= slab4) return;
  const long long dstride = bh * kDecayRows;    // decay's chunk stride
  const float* __restrict__ dec = decay + n / (64 * 64 / 4 / kDecayRows);
  float4* st = reinterpret_cast<float4*>(states) + n;   // chunk 0, kind 0
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kind = 0; kind < 2; ++kind) {
    const float* from = kind == 0 ? first : last;
    float4 cur = from ? reinterpret_cast<const float4*>(from)[n] : zero4;
    const int c0 = kind == 0 ? 0 : chunks - 1;
    const int step = kind == 0 ? 1 : -1;
    float4* base = st + kind * slab4;
    float4 nxt = chunks > 0 ? base[2 * c0 * slab4] : zero4;
    for (int k = 0, c = c0; k < chunks; ++k, c += step) {
      const float4 x = nxt;
      if (k + 1 < chunks) nxt = base[2 * (c + step) * slab4];
      base[2 * c * slab4] = cur;
      const float g = dec[c * dstride];
      cur = make_float4(fmaf(g, cur.x, x.x), fmaf(g, cur.y, x.y),
                        fmaf(g, cur.z, x.z), fmaf(g, cur.w, x.w));
    }
    if (kind == 1) reinterpret_cast<float4*>(out)[n] = cur;
  }
}

}  // namespace
