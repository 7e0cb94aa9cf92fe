// Flash attention for Hopper (sm_90a): causal, sliding-window or
// bidirectional, grouped-query heads; bf16 in, fp32 softmax and sums, bf16
// out.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (_kernel):
// o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // (H/KV)] * hd^-0.5, masked
// to j <= i (causal) and j > i - window) @ v[b, :, h // (H/KV)], with masked
// logits at -1e30, the online softmax over KV tiles (running max m,
// denominator l, fp32 accumulator rescaled by exp(m_old - m_new)), P rounded
// to bf16 before P.V (as the TPU kernel's p.astype(v.dtype)), and the output
// divided by max(l, 1e-30).  The TPU kernel walks KV tiles on a sequential
// grid axis with m, l and the accumulator in VMEM scratch; here that axis is
// a loop inside the block and m, l and the accumulator live in registers.
//
// One block per (64-row query tile, b*H + h), 4 warps of 16 query rows each.
// q, k and v are read in place from their [B, S, heads, hd] layouts (the
// row stride is heads*hd; no transpose copies).  The Q tile is read once
// into registers as mma fragments; each 64-key K and V tile is staged in
// dynamic shared memory (Q + K + V tiles: 52 KB at hd 128).  S = Q K^T and
// O += P V run on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// out), operands loaded with ldmatrix (V with .trans); P never leaves the
// registers: the fp32 accumulator fragment of S is the A fragment of P V.
// KV tiles that are masked for every row of the block are skipped (after
// the query tile under causal; ending at or before q_start - window under a
// window): a row with at least one valid key gets the same result, and
// every row has its own key.  Keys >= S are masked, rows >= S not stored.
//
// Bound on the card: operations.  Each unmasked (query, key) pair of a head
// costs 4*hd operations (q.k and p.v), while q, k, v and o are each moved
// once: at S in the thousands that is hundreds of operations per byte,
// above the ~295 per byte where the tensor cores become the limit.  This
// simple kernel (no TMA, no wgmma, one stage, K and V reloaded for every
// query tile) is well short of that bound; PERF.md has its times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;            // query rows per block (16 per warp)
constexpr int BN = 64;            // keys per KV tile
constexpr int kThreads = 128;
constexpr int kPad = 8;           // row padding: conflict-free ldmatrix
constexpr float kNegInf = -1e30f; // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of one head into dst [64][HD + kPad]; rows >= s
// read as 0
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int s, size_t stride,
                                          int tid) {
  constexpr int kVec = HD / 8;    // 16-byte vectors per row
#pragma unroll 4
  for (int i = tid; i < BN * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride
                                            + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + kPad) + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int s, int h,
             int kvh, int causal, int window, float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BM * kLd;
  bf16* vs = ks + BN * kLd;

  // the longest causal tiles (last query rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int b = blockIdx.y / h, hh = blockIdx.y % h;
  const int kh = hh / (h / kvh);                        // GQA
  const size_t q_stride = (size_t)h * HD, kv_stride = (size_t)kvh * HD;
  const bf16* qb = q + ((size_t)b * s * h + hh) * HD;
  const bf16* kb = k + ((size_t)b * s * kvh + kh) * HD;
  const bf16* vb = v + ((size_t)b * s * kvh + kh) * HD;
  bf16* ob = o + ((size_t)b * s * h + hh) * HD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;    // mma fragment row / column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix matrix / row of lane

  load_tile<HD>(qs, qb, q0, s, q_stride, tid);
  __syncthreads();
  // A fragments of this warp's 16 query rows, for each 16-wide slice of hd
  uint32_t qf[HD / 16][4];
  {
    const bf16* p = qs + (warp * 16 + (mi & 1) * 8 + mr) * kLd + (mi >> 1) * 8;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) ldsm_x4(qf[kc], p + kc * 16);
  }

  // KV tiles some row of this block needs
  const int q_last = min(q0 + BM, s) - 1;
  const int kv_end = causal ? q_last + 1 : s;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = kv_begin / BN, j1 = (kv_end + BN - 1) / BN;

  const int row0 = q0 + warp * 16 + g;      // this thread's rows: row0, +8
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};              // this thread's columns only

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * BN;
    __syncthreads();                        // last tile's readers are done
    load_tile<HD>(ks, kb, k0, s, kv_stride, tid);
    load_tile<HD>(vs, vb, k0, s, kv_stride, tid);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; nt += 2) {
      const bf16* p = ks + ((nt + (mi >> 1)) * 8 + mr) * kLd + (mi & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        uint32_t kf[4];
        ldsm_x4(kf, p + kc * 16);
        mma_bf16(sc[nt], qf[kc], kf[0], kf[1]);
        mma_bf16(sc[nt + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // scale, mask, row max (the 4 threads of a quad share a row)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        bool ok = col < s;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        const float x = ok ? sc[nt][e] * scale : kNegInf;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f((m_run[r] - m_new) * kLog2e);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sc[nt][e] - m_run[e >> 1]) * kLog2e);
        sc[nt][e] = p;
        ls[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + ls[r];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the S fragments, 16 keys per step
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t pf[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
      const bf16* p = vs + (kc * 16 + (mi & 1) * 8 + mr) * kLd + (mi >> 1) * 8;
#pragma unroll
      for (int dt = 0; dt < HD / 8; dt += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, p + dt * 8);
        mma_bf16(acc[dt], pf, vf[0], vf[1]);
        mma_bf16(acc[dt + 1], pf, vf[2], vf[3]);
      }
    }
  }

  // o = acc / max(l, 1e-30), rows < s only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= s) continue;
    bf16* dst = ob + (size_t)row * q_stride + 2 * t;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * r] / l_run[r], acc[dt][2 * r + 1] / l_run[r]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int h, int kvh, int causal, int window, cudaStream_t stream) {
  const int smem = (BM + 2 * BN) * (HD + kPad) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BM - 1) / BM, b * h);
  const float scale = (float)(1.0 / sqrt((double)HD));
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, s, h, kvh,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o [B,S,H,hd]; k, v [B,S,KV,hd]; all bf16, contiguous, 16-byte aligned.
// hd 64 or 128; H % KV == 0; window 0 = none; causal 0/1.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int s, int h, int kvh, int hd,
                               int causal, int window, void* stream) {
  if (b < 0 || s < 0 || h <= 0 || kvh <= 0 || h % kvh || window < 0 ||
      (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64) return launch<64>(q, k, v, o, b, s, h, kvh, causal, window, st);
  if (hd == 128)
    return launch<128>(q, k, v, o, b, s, h, kvh, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
