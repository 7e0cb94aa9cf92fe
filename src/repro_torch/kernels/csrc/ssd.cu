// Mamba2 SSD chunk scan for Hopper (sm_90a): bf16 x, dt, B, C; fp32
// decays, state, sums and output.
//
// Replaces src/repro/kernels/ssd.py::ssd_scan (_kernel).  Per (b, h), over
// chunks of Q = 128 steps, with dt <- softplus(dt), a = -exp(a_log[h]) and
// L the in-chunk inclusive cumulative sum of dt * a:
//   y = ((C B^T) .* tril(exp(L_t - L_s))) (x dt) + exp(L_t) C h^T + D x
//   h <- exp(L_Q) h + (x dt exp(L_Q - L_s))^T B
// The TPU kernel carries h in VMEM scratch across a sequential grid axis of
// chunks; here the chunk axis is a loop inside one block and h lives in
// registers (each thread owns a 4 x 4 tile) and, transposed, in shared
// memory for the C h^T product.  h can start from h0 and the final state
// can be written to hT.
//
// One block of 256 threads per (b, h).  A chunk of x, B and C is staged in
// fp32 in dynamic shared memory (rows padded by 4 floats: float4-aligned,
// no bank conflicts on the row-strided reads), beside the [Q, Q] decay
// matrix M (stored transposed) and h^T: 191 KB, one block an SM.  All
// three products run on the CUDA cores in fp32 with register tiles (8 x 8
// of C B^T, 8 x 4 of y, 4 x 4 of h).  Three details:
//  - exp(L_t - L_s) above the diagonal can overflow; it is selected away,
//    never multiplied by a 0/1 mask (inf * 0 is NaN).  Tiles of C B^T that
//    lie wholly above the diagonal are not computed.
//  - A ragged T is masked in the last chunk: its rows past T have x, B, C
//    and dt = 0 (L stays flat, they add nothing to h) and are not stored.
//    Q never shrinks (the Pallas wrapper halves it until it divides T).
//  - B and C are shared by all heads and read in place from [B, T, N]
//    (the Pallas wrapper broadcasts them H times).  x, dt, B and C are read
//    through their batch and time strides, so the model's slices of one
//    projection need no copies; y is written [B, T, H, P] contiguous.
//
// Bound on the card: operations, at the fp32 (non-tensor) peak.  A chunk of
// a head does about Q^2 (N + P) + 4 Q P N operations (4.2 M at Q = 128,
// P = N = 64) on 12 KB of bf16 inputs and 32 KB of fp32 output.  The
// intra-chunk products could move to the tensor cores (TF32 or bf16 mma),
// and C B^T is the same for every head of a batch row; both are later
// work.  PERF.md has its times.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int Q = 128;            // steps per chunk
constexpr int P = 64;             // head size
constexpr int N = 64;             // state size
constexpr int kThreads = 256;     // 16 x 16
constexpr int kRowP = P + 4;      // padded rows (floats)
constexpr int kRowN = N + 4;
constexpr int kRowQ = Q + 4;
constexpr int kSmemFloats =
    Q * kRowP + 2 * Q * kRowN + Q * kRowQ + N * kRowP + 3 * Q;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));   // logaddexp(x, 0)
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__global__ void __launch_bounds__(kThreads, 1)
    ssd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
               const float* __restrict__ a_log, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const float* __restrict__ d_skip,
               const float* __restrict__ h0, float* __restrict__ y,
               float* __restrict__ hT, int T, int H, long long xsb,
               long long xst, long long dsb, long long dst, long long bsb,
               long long bst, long long csb, long long cst) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][kRowP] x
  float* bs = xs + Q * kRowP;                    // [Q][kRowN] B
  float* cs = bs + Q * kRowN;                    // [Q][kRowN] C
  float* mt = cs + Q * kRowN;                    // [Q][kRowQ] mt[s][t] = M[t][s]
  float* ht = mt + Q * kRowQ;                    // [N][kRowP] ht[n][p] = h[p][n]
  float* lc = ht + N * kRowP;                    // [Q] L
  float* dts = lc + Q;                           // [Q] softplus(dt)
  float* cw = dts + Q;                           // [Q] exp(L_Q - L_s) dt_s

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = -expf(a_log[h]);
  const float dsk = d_skip[h];
  const bf16* xb = x + b * xsb + (long long)h * P;
  const bf16* db = dt + b * dsb + h;
  const bf16* bb = bm + b * bsb;
  const bf16* cb = cm + b * csb;
  const long long yrow = (long long)H * P;
  float* yb = y + (long long)b * T * yrow + (long long)h * P;

  // this thread's tile of h: p = ty*4 + i, n = tx*4 + j
  float hr[4][4];
  const float* h0p = h0 ? h0 + (long long)blockIdx.x * P * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      hr[i][j] = h0p ? h0p[(ty * 4 + i) * N + tx * 4 + j] : 0.f;
      ht[(tx * 4 + j) * kRowP + ty * 4 + i] = hr[i][j];
    }

  for (int t0 = 0; t0 < T; t0 += Q) {
    const int nv = min(Q, T - t0);
    // ---- stage the chunk; rows >= nv are zero
    for (int e = tid; e < Q * P; e += kThreads) {
      const int s = e / P, p = e % P;
      xs[s * kRowP + p] =
          s < nv ? __bfloat162float(xb[(long long)(t0 + s) * xst + p]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int s = e / N, n = e % N;
      const bool in = s < nv;
      bs[s * kRowN + n] =
          in ? __bfloat162float(bb[(long long)(t0 + s) * bst + n]) : 0.f;
      cs[s * kRowN + n] =
          in ? __bfloat162float(cb[(long long)(t0 + s) * cst + n]) : 0.f;
    }
    if (tid < Q)
      dts[tid] = tid < nv
          ? softplus(__bfloat162float(db[(long long)(t0 + tid) * dst]))
          : 0.f;
    __syncthreads();
    // ---- L: inclusive cumulative sum of dt * a, one warp, 4 steps a lane
    if (tid < 32) {
      float c[4];
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        run += dts[4 * tid + i] * a;
        c[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int i = 0; i < 4; ++i) lc[4 * tid + i] = excl + c[i];
    }
    __syncthreads();
    if (tid < Q) cw[tid] = expf(lc[Q - 1] - lc[tid]) * dts[tid];
    // ---- M[t][s] = (C_t . B_s) exp(L_t - L_s) dt_s for s <= t, else 0;
    // rows t = tb..tb+7, columns s = tx + 16 j
    {
      const int tb = ty * 8;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int n4 = 0; n4 < N; n4 += 4) {
        float4 cr[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cr[i] = ld4(cs + (tb + i) * kRowN + n4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          if (s <= tb + 7) {
            const float4 br = ld4(bs + s * kRowN + n4);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][j] = dot4(cr[i], br, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = tx + 16 * j;
        const float ls = lc[s], ds = dts[s];
        float m[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = tb + i;
          m[i] = s <= t ? acc[i][j] * expf(lc[t] - ls) * ds : 0.f;
        }
        float4* dst4 = reinterpret_cast<float4*>(mt + s * kRowQ + tb);
        dst4[0] = make_float4(m[0], m[1], m[2], m[3]);
        dst4[1] = make_float4(m[4], m[5], m[6], m[7]);
      }
    }
    __syncthreads();
    // ---- y[t][p] = sum_{s<=t} M[t][s] x[s][p] + exp(L_t) sum_n C[t][n]
    // h[p][n] + D x[t][p]; rows t = tb..tb+7, columns p = pb..pb+3
    {
      const int tb = ty * 8, pb = tx * 4;
      float acc[8][4], acc2[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = 0.f;
      for (int s = 0; s < tb + 8; ++s) {
        const float4 m0 = ld4(mt + s * kRowQ + tb);
        const float4 m1 = ld4(mt + s * kRowQ + tb + 4);
        const float4 xv = ld4(xs + s * kRowP + pb);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float mi = i < 4 ? comp(m0, i) : comp(m1, i - 4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(mi, comp(xv, j), acc[i][j]);
        }
      }
      for (int n4 = 0; n4 < N; n4 += 4) {
        float4 hv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = ld4(ht + (n4 + q) * kRowP + pb);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 cr = ld4(cs + (tb + i) * kRowN + n4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = acc2[i][j];
            v = fmaf(cr.x, comp(hv[0], j), v);
            v = fmaf(cr.y, comp(hv[1], j), v);
            v = fmaf(cr.z, comp(hv[2], j), v);
            acc2[i][j] = fmaf(cr.w, comp(hv[3], j), v);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = tb + i;
        if (t < nv) {
          const float el = expf(lc[t]);
          const float4 xv = ld4(xs + t * kRowP + pb);
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = fmaf(dsk, comp(xv, j), fmaf(el, acc2[i][j], acc[i][j]));
          *reinterpret_cast<float4*>(yb + (long long)(t0 + t) * yrow + pb) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      }
    }
    __syncthreads();                       // h^T is read above, rewritten below
    // ---- h[p][n] <- exp(L_Q) h[p][n] + sum_s cw[s] x[s][p] B[s][n]
    {
      const int pb = ty * 4, nb = tx * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < nv; ++s) {
        const float c = cw[s];
        const float4 xv = ld4(xs + s * kRowP + pb);
        const float4 bv = ld4(bs + s * kRowN + nb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xi = c * comp(xv, i);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xi, comp(bv, j), acc[i][j]);
        }
      }
      const float dec = expf(lc[Q - 1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) hr[i][j] = fmaf(dec, hr[i][j], acc[i][j]);
        *reinterpret_cast<float4*>(ht + (nb + j) * kRowP + pb) =
            make_float4(hr[0][j], hr[1][j], hr[2][j], hr[3][j]);
      }
    }
    __syncthreads();                       // the staging is rewritten next
  }
  if (hT) {
    float* hp = hT + (long long)blockIdx.x * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(hp + (ty * 4 + i) * N + tx * 4) =
          make_float4(hr[i][0], hr[i][1], hr[i][2], hr[i][3]);
  }
}

}  // namespace

// x: [b, t, h, P] bf16 at batch / time strides xsb / xst (elements; the
// [h, P] part contiguous); dt: [b, t, h] bf16 at dsb / dst; b_, c_:
// [b, t, N] bf16 at bsb / bst and csb / cst; a_log, d_skip: [h] fp32;
// h0: [b, h, P, N] fp32 or null (zeros); y: [b, t, h, P] fp32 contiguous;
// hT: [b, h, P, N] fp32 or null.
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
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<<<b * h, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)dt, (const float*)a_log, (const bf16*)b_,
      (const bf16*)c_, (const float*)d_skip, (const float*)h0, (float*)y,
      (float*)hT, t, h, xsb, xst, dsb, dst, bsb, bst, csb, cst);
  return (int)cudaGetLastError();
}
