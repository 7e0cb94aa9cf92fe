// Slot dispatch, gate-weighted combine and weighted replica routing for
// Hopper (sm_90a).
//
// dispatch_rows replaces src/repro/kernels/dispatch.py::dispatch_rows
// (_dispatch_kernel): out[r] = scale[r] * x[src[r]], 0 where src[r] = -1
// or is out of range, product in fp32 (__fmul_rn) then rounded to nearest
// bf16, so every output is bitwise the plain version's; without a scale a
// pure row copy.  With a dot operand (combine's backward, whose dot is the
// saved slot buffer) the same pass also returns rowdot[r] = sum_c
// fp32(dot[r,c]) * fp32(x[src[r],c]), the unscaled x, 0 for empty rows:
// the gate weights' gradient is rowdot[rows[t,j]], since rows and src are
// inverse maps.  The TPU kernel streams source tiles past a revisited
// output tile; here a warp owns one slot row (kRowWarps a block: 2 to 16
// timed alike at 512, 1,536 and 20,608 rows; no grid-stride walk: 512
// rows give 128 blocks, one an SM) and gathers its one source row.  Bound: bytes (the kept rows' reads, the dot rows' with dot,
// every output row's write), so the design keeps bytes in flight: the
// row's src and scale are one broadcast load a warp; each lane moves
// 16-byte vectors (8 bf16) and issues the loads of kVec vectors (and as
// many of the dot row) before its first store (at D 768: 3 of 96 a lane);
// an empty row is zeroed by 16-byte stores.  rowdot: each lane sums its
// products into 8 fp32 partials (one a vector position, in vector order),
// adds them pairwise, then a shuffle butterfly over the 32 lanes; every
// product and sum is an explicit _rn intrinsic, so a repeat is bitwise.
// The wrapper requires D a multiple of 8 and x and dot 16-byte aligned
// (raising otherwise); no scalar path is kept.
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

constexpr int kRowWarps = 4;   // dispatch: slot rows a block, one a warp
constexpr int kRouteThreads = 256;
constexpr int kTokWarps = 8;   // combine: tokens a block, one a warp
constexpr int kVec = 4;        // 16-byte vectors a lane loads together
constexpr int kChoices = 2;    // choices whose vectors load together

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

// v's 8 bf16 times s, each product rounded to fp32, then to nearest bf16
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    o[i] = pack2(__fmul_rn(f.x, s), __fmul_rn(f.y, s));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// acc[i] += a[i] * b[i] over the 8 bf16 of each, product and sum rounded
// to fp32
__device__ __forceinline__ void dot8(float (&acc)[8], uint4 a, uint4 b) {
  const uint32_t ua[4] = {a.x, a.y, a.z, a.w};
  const uint32_t ub[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ua[i]));
    const float2 fb =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ub[i]));
    acc[2 * i] = __fadd_rn(acc[2 * i], __fmul_rn(fa.x, fb.x));
    acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __fmul_rn(fa.y, fb.y));
  }
}

// dv = D / 8 vectors a row; warp w of block b owns slot row b * kRowWarps
// + w.  kScaled: scale is given; kDot: dot and rowdot are.
template <bool kScaled, bool kDot>
__global__ void __launch_bounds__(kRowWarps * 32)
dispatch_kernel(const uint4* __restrict__ x, const int32_t* __restrict__ src,
                const float* __restrict__ scale,
                const uint4* __restrict__ dot, int n_src, int n_rows, int dv,
                uint4* __restrict__ out, float* __restrict__ rowdot) {
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;   // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int s = __ldg(src + r);   // one broadcast load a warp
  uint4* o = out + (size_t)r * dv;
  if (s < 0 || s >= n_src) {
    for (int c = lane; c < dv; c += 32) o[c] = make_uint4(0u, 0u, 0u, 0u);
    if (kDot && lane == 0) rowdot[r] = 0.f;
    return;
  }
  const float sc = kScaled ? __ldg(scale + r) : 1.f;
  const uint4* xr = x + (size_t)s * dv;
  const uint4* dr = kDot ? dot + (size_t)r * dv : nullptr;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int c0 = lane; c0 < dv; c0 += 32 * kVec) {
    uint4 v[kVec], w[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (c0 + 32 * u < dv) {
        v[u] = __ldg(xr + c0 + 32 * u);
        if (kDot) w[u] = __ldg(dr + c0 + 32 * u);
      }
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (c0 + 32 * u < dv) {
        o[c0 + 32 * u] = kScaled ? scale8(v[u], sc) : v[u];
        if (kDot) dot8(acc, w[u], v[u]);
      }
  }
  if (kDot) {
    float sum = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]),
                                    __fadd_rn(acc[2], acc[3])),
                          __fadd_rn(__fadd_rn(acc[4], acc[5]),
                                    __fadd_rn(acc[6], acc[7])));
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, m));
    if (lane == 0) rowdot[r] = sum;
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

// x, dot and out are bfloat16, D a multiple of 8, x, dot and out 16-byte
// aligned.  scale may be null (all ones); dot may be null (no rowdot),
// else rowdot is [n_rows] fp32.
extern "C" int dispatch_rows(const void* x, const void* src, const void* scale,
                             const void* dot, int n_src, int n_rows, int d,
                             void* out, void* rowdot, void* stream) {
  if (d % 8 != 0 ||
      ((uintptr_t)x | (uintptr_t)dot | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaGetLastError();
  const dim3 grid((n_rows + kRowWarps - 1) / kRowWarps), block(kRowWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  auto launch = [&](auto kernel) {
    kernel<<<grid, block, 0, st>>>((const uint4*)x, (const int32_t*)src,
                                   (const float*)scale, (const uint4*)dot,
                                   n_src, n_rows, d / 8, (uint4*)out,
                                   (float*)rowdot);
  };
  if (scale != nullptr && dot != nullptr) launch(dispatch_kernel<true, true>);
  else if (scale != nullptr) launch(dispatch_kernel<true, false>);
  else if (dot != nullptr) launch(dispatch_kernel<false, true>);
  else launch(dispatch_kernel<false, false>);
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
