// RWKV6 WKV recurrence for Hopper (sm_90a): bf16 r, k, v, fp32 log decay
// w, fp32 state, sums and output.
//
// Replaces src/repro/kernels/rwkv6.py::rwkv6_wkv (_kernel).  Per (b, h),
// with S the [hd, hd] state (row i: key channel, column j: value channel):
//   y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//   S      <- exp(w_t)[:, None] * S + k_t (x) v_t
// computed here as y_t[j] = sum_i r_t[i] S[i, j] + v_t[j] * sum_i r_t[i]
// u[i] k_t[i] (the same sum, regrouped).  The TPU kernel carries S in VMEM
// scratch across a sequential grid axis of chunks and starts it at zero;
// here the chunk axis is a loop inside one block, S can start from an
// initial state s0 and the final state can be written to sT (the model's
// decode step runs T = 1 from the cached state).
//
// One block per (b, h), one thread per column j of S: its hd values live in
// registers for the whole sequence, and the columns never talk to each
// other.  A chunk of min(64, T) steps of r, k and exp(w) (fp32, rows padded
// to 68 floats: float4-aligned and free of bank conflicts) and v is staged
// in dynamic shared memory; each step reads r, k and exp(w) as broadcast
// float4 loads.  sum_i r u k of every step is formed once per chunk, one
// step per thread.  r, k, v, w and y are read and written in place in
// their [B, T, H, hd] layouts (a step's row is H*hd wide).
//
// Bound on the card: bytes and operations are close.  Each step of a head
// moves 3 bf16 rows, one fp32 w row and one fp32 y row (896 bytes at hd
// 64) and does 5*hd^2 + 6*hd operations (20,864): about 23 operations a
// byte, against the ~20 at which the fp32 (non-tensor) peak of 67 TFLOP/s
// meets 3.35 TB/s.  This simple kernel is far from either: it runs one
// block of hd threads per (b, h) (128 blocks at the prefill shape, 2 warps
// an SM) and its step loop is latency-bound.  Splitting the columns of S
// across more warps or blocks is later work; PERF.md has its times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;          // head size: one thread per column of S
constexpr int kMaxChunk = 64;   // steps staged at once
constexpr int kRow = HD + 4;    // padded staged row (floats)

size_t smem_bytes(int chunk) {
  return sizeof(float) * ((size_t)3 * chunk * kRow + (size_t)chunk * HD +
                          chunk + HD);
}

__global__ void __launch_bounds__(HD)
    wkv_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ sT, int T, int H,
               int chunk) {
  extern __shared__ float4 smem4[];
  float* sr = reinterpret_cast<float*>(smem4);   // [chunk][kRow] r
  float* sk = sr + chunk * kRow;                 // [chunk][kRow] k
  float* se = sk + chunk * kRow;                 // [chunk][kRow] exp(w)
  float* sv = se + chunk * kRow;                 // [chunk][HD] v
  float* su = sv + chunk * HD;                   // [HD] u of this head
  float* sb = su + HD;                           // [chunk] sum_i r u k

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

  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int n = min(chunk, T - t0);
#pragma unroll 8
    for (int t = 0; t < n; ++t) {                // 8 steps' loads in flight
      const long long off = base + (long long)(t0 + t) * row;
      sr[t * kRow + j] = __bfloat162float(r[off]);
      sk[t * kRow + j] = __bfloat162float(k[off]);
      se[t * kRow + j] = expf(w[off]);
      sv[t * HD + j] = __bfloat162float(v[off]);
    }
    __syncthreads();
    if (j < n) {                                 // one step per thread
      const float4* r4 = reinterpret_cast<const float4*>(sr + j * kRow);
      const float4* k4 = reinterpret_cast<const float4*>(sk + j * kRow);
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
      const float4* r4 = reinterpret_cast<const float4*>(sr + t * kRow);
      const float4* k4 = reinterpret_cast<const float4*>(sk + t * kRow);
      const float4* e4 = reinterpret_cast<const float4*>(se + t * kRow);
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
      y[base + (long long)(t0 + t) * row] =
          ((y0 + y1) + (y2 + y3)) + vj * sb[t];
    }
    __syncthreads();                             // staging is rewritten next
  }
  if (sT) {
    float* sTp = sT + (long long)bh * HD * HD;
#pragma unroll
    for (int i = 0; i < HD; ++i) sTp[i * HD + j] = S[i];
  }
}

}  // namespace

// r, k, v: [b, t, h, hd] bf16; w: [b, t, h, hd] fp32 (log decay); u: [h, hd]
// fp32; s0: [b, h, hd, hd] fp32 or null (zeros); y: [b, t, h, hd] fp32;
// sT: [b, h, hd, hd] fp32 or null.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0,
                         void* y, void* sT, int b, int t, int h, int hd,
                         void* stream) {
  if (b < 0 || t < 0 || h < 0 || hd != HD) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  const int chunk = t < kMaxChunk ? (t > 0 ? t : 1) : kMaxChunk;
  const size_t smem = smem_bytes(chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wkv_kernel<<<b * h, HD, smem, (cudaStream_t)stream>>>(
      (const bf16*)r, (const bf16*)k, (const bf16*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)sT, t, h, chunk);
  return (int)cudaGetLastError();
}
