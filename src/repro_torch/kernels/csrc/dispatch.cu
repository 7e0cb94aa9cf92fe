// Slot dispatch, gate-weighted combine and weighted replica routing for
// Hopper (sm_90a).
//
// dispatch_rows replaces src/repro/kernels/dispatch.py::dispatch_rows
// (_dispatch_kernel): out[r] = scale[r] * x[src[r]], 0 where src[r] = -1,
// product in fp32 then rounded to bf16 (the serve path's activation type,
// the only one the kernels here take).  The TPU kernel streams source
// tiles past a revisited output tile; here each block owns one output row
// and gathers its one source row directly.  Bound: bytes (the kept rows'
// reads plus every output row's write).
//
// combine_rows replaces dispatch.py::combine_rows (_combine_kernel):
// y[t] = sum_k w[t,k] * buf[rows[t,k]] in fp32, dropped choices (-1) add
// nothing.  Products and sums use explicit _rn intrinsics in choice order,
// so no fused multiply-add changes the rounding against the plain version
// and a repeat is bitwise.  Bound: bytes (the used slot rows' reads, the
// rows and weights, every output row's write), so the design keeps bytes
// in flight: one warp a token, its rows and weights read once; each lane
// moves 16-byte vectors (8 bf16) and issues the loads of kVec vectors of
// kChoices choices (at D 768 and top-2: all six of a lane's) before the
// first is used.  The wrapper requires D a multiple of 8 and buf 16-byte
// aligned (raising otherwise): every config of the repo has D a multiple
// of 8, so no scalar tail is kept.
//
// weighted_route replaces dispatch.py::weighted_route (_route_kernel): bin
// partition of each (token, choice)'s priority position over its expert's
// inclusive cumulative integer replica weights -> slot * slot_cap + offset,
// -1 when dropped.  One thread per (token, choice) scanning the R columns.
// Pure int32, exact.  Bound: bytes and launch latency (T*k is at most a few
// hundred on the serve path).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 128;
constexpr int kRouteThreads = 256;
constexpr int kTokWarps = 8;   // combine: tokens a block, one a warp
constexpr int kVec = 4;        // 16-byte vectors a lane loads together
constexpr int kChoices = 2;    // choices whose vectors load together

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kRowThreads)
dispatch_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ src,
                const float* __restrict__ scale, int n_src, int d,
                bf16* __restrict__ out) {
  const int r = blockIdx.x;
  const int s = src[r];
  bf16* o = out + (size_t)r * d;
  if (s < 0 || s >= n_src) {
    for (int c = threadIdx.x; c < d; c += kRowThreads)
      o[c] = __float2bfloat16(0.f);
    return;
  }
  const float sc = scale != nullptr ? scale[r] : 1.f;
  const bf16* xr = x + (size_t)s * d;
  for (int c = threadIdx.x; c < d; c += kRowThreads)
    o[c] = __float2bfloat16(__fmul_rn(__bfloat162float(xr[c]), sc));
}

// two floats -> two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[0..8) += v's 8 bf16 times w, each product and sum rounded to fp32
__device__ __forceinline__ void add8(float (&acc)[8], uint4 v, float w) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    acc[2 * i] = __fadd_rn(acc[2 * i], __fmul_rn(f.x, w));
    acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __fmul_rn(f.y, w));
  }
}

// dv = D / 8 vectors a row
__global__ void __launch_bounds__(kTokWarps * 32)
combine_kernel(const uint4* __restrict__ buf, const int32_t* __restrict__ rows,
               const float* __restrict__ w, int n_rows, int n_tok, int k,
               int dv, uint4* __restrict__ out) {
  const int t = blockIdx.x * kTokWarps + (threadIdx.x >> 5);
  if (t >= n_tok) return;   // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int32_t* tr = rows + (size_t)t * k;
  const float* tw = w + (size_t)t * k;
  uint4* o = out + (size_t)t * dv;
  for (int c0 = lane; c0 < dv; c0 += 32 * kVec) {
    float acc[kVec][8];
#pragma unroll
    for (int u = 0; u < kVec; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[u][i] = 0.f;
    for (int j0 = 0; j0 < k; j0 += kChoices) {
      int r[kChoices];
      float wj[kChoices];
#pragma unroll
      for (int c = 0; c < kChoices; ++c) {
        const int j = j0 + c;
        r[c] = j < k ? __ldg(tr + j) : -1;
        if (r[c] >= n_rows) r[c] = -1;   // dropped: adds nothing
        wj[c] = j < k ? __ldg(tw + j) : 0.f;
      }
      uint4 v[kVec][kChoices];
#pragma unroll
      for (int u = 0; u < kVec; ++u)
#pragma unroll
        for (int c = 0; c < kChoices; ++c)
          if (c0 + 32 * u < dv && r[c] >= 0)
            v[u][c] = __ldg(buf + (size_t)r[c] * dv + c0 + 32 * u);
#pragma unroll
      for (int u = 0; u < kVec; ++u)
#pragma unroll
        for (int c = 0; c < kChoices; ++c)   // in choice order
          if (c0 + 32 * u < dv && r[c] >= 0) add8(acc[u], v[u][c], wj[c]);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (c0 + 32 * u < dv)
        o[c0 + 32 * u] = make_uint4(pack2(acc[u][0], acc[u][1]),
                                    pack2(acc[u][2], acc[u][3]),
                                    pack2(acc[u][4], acc[u][5]),
                                    pack2(acc[u][6], acc[u][7]));
  }
}

__global__ void __launch_bounds__(kRouteThreads)
route_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
             const int32_t* __restrict__ cum,
             const int32_t* __restrict__ slot_of, int n, int e, int rw,
             int slot_cap, int32_t* __restrict__ out) {
  const int i = blockIdx.x * kRouteThreads + threadIdx.x;
  if (i >= n) return;
  const int ex = idx[i];
  if (ex < 0 || ex >= e) {
    out[i] = -1;
    return;
  }
  const int p = pos[i];
  const int32_t* c = cum + (size_t)ex * rw;
  int cnt = 0, prev = 0;
  for (int r = 0; r < rw; ++r) {
    const int cv = c[r];
    if (p >= cv) {
      ++cnt;
      prev = max(prev, cv);
    }
  }
  const int which = min(cnt, rw - 1);
  const int slot = slot_of[(size_t)ex * rw + which];
  out[i] = (p < c[rw - 1] && slot >= 0) ? slot * slot_cap + (p - prev) : -1;
}

}  // namespace

// x, buf and out are bfloat16.  scale may be null (all ones).
extern "C" int dispatch_rows(const void* x, const void* src, const void* scale,
                             int n_src, int n_rows, int d, void* out,
                             void* stream) {
  if (n_rows == 0) return (int)cudaGetLastError();
  dispatch_kernel<<<n_rows, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int32_t*)src, (const float*)scale, n_src, d,
      (bf16*)out);
  return (int)cudaGetLastError();
}

// combine_rows: D a multiple of 8, buf and out 16-byte aligned.
extern "C" int combine_rows(const void* buf, const void* rows, const void* w,
                            int n_rows, int n_tok, int k, int d, void* out,
                            void* stream) {
  if (d % 8 != 0 || ((uintptr_t)buf | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return (int)cudaGetLastError();
  combine_kernel<<<(n_tok + kTokWarps - 1) / kTokWarps, kTokWarps * 32, 0,
                   (cudaStream_t)stream>>>(
      (const uint4*)buf, (const int32_t*)rows, (const float*)w, n_rows,
      n_tok, k, d / 8, (uint4*)out);
  return (int)cudaGetLastError();
}

extern "C" int weighted_route(const void* idx, const void* pos,
                              const void* cum, const void* slot_of, int n,
                              int e, int rw, int slot_cap, void* out,
                              void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  if (rw < 1) return (int)cudaErrorInvalidValue;
  route_kernel<<<(n + kRouteThreads - 1) / kRouteThreads, kRouteThreads, 0,
                 (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const int32_t*)pos, (const int32_t*)cum,
      (const int32_t*)slot_of, n, e, rw, slot_cap, (int32_t*)out);
  return (int)cudaGetLastError();
}
