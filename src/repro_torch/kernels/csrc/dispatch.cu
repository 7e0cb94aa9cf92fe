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
// nothing.  One block per token, threads across d; products and sums use
// explicit _rn intrinsics so no fused multiply-add changes the rounding
// against the plain version.  Bound: bytes.
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

__global__ void __launch_bounds__(kRowThreads)
combine_kernel(const bf16* __restrict__ buf, const int32_t* __restrict__ rows,
               const float* __restrict__ w, int n_rows, int k, int d,
               bf16* __restrict__ out) {
  const int t = blockIdx.x;
  const int32_t* tr = rows + (size_t)t * k;
  const float* tw = w + (size_t)t * k;
  bf16* o = out + (size_t)t * d;
  for (int c = threadIdx.x; c < d; c += kRowThreads) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int r = tr[j];
      if (r < 0 || r >= n_rows) continue;
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(buf[(size_t)r * d + c]),
                                     tw[j]));
    }
    o[c] = __float2bfloat16(acc);
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

extern "C" int combine_rows(const void* buf, const void* rows, const void* w,
                            int n_rows, int n_tok, int k, int d, void* out,
                            void* stream) {
  if (n_tok == 0) return (int)cudaGetLastError();
  combine_kernel<<<n_tok, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)buf, (const int32_t*)rows, (const float*)w, n_rows, k, d,
      (bf16*)out);
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
