// Router gating and GShard priority positions for Hopper (sm_90a).
//
// topk_gating replaces src/repro/kernels/topk_gating.py::topk_gating_fused
// (_fused_kernel / _softmax_topk): logits = x @ router with fp32 sums,
// rounded to x's type (bf16, the only type taken here), softmax in fp32, iterated first-max top-k, weights
// renormalised by max(sum, 1e-9).  One warp per token: the lanes stride over
// D holding all E partial dot products in registers, then butterfly-reduce
// them, so every lane ends with every logit.  Bound on the card: bytes (x is
// read once, T*D*2 B for bf16; the D*E router stays in L1/L2), at 2*D*E
// operations per token far below the tensor-core rate.
//
// topk_positions replaces topk_gating.py::topk_positions (_pos_kernel): the
// choice-major rank of each (token, choice) within its expert.  The TPU
// kernel carries per-expert counters across a sequential grid; blocks have
// no order on Hopper, so one block walks the T*k entries in chunks of 1024:
// __match_any_sync ranks equal experts inside a warp, a per-warp count table
// in shared memory is scanned over the 32 warps in order, and the running
// per-expert base carries to the next chunk.  No atomics, so the result is
// deterministic.  Bound: bytes (T*k*4 in, T*k*4 out) and launch latency.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 32;      // experts a gating warp holds in registers
constexpr int kMaxK = 4;
constexpr int kGateWarps = 8;  // tokens per block
constexpr int kPosThreads = 1024;
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kPosMaxE = 256;

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kGateWarps * 32)
gating_kernel(const bf16* __restrict__ x, const bf16* __restrict__ router,
              int n_tok, int d, int e, int k, int32_t* __restrict__ idx_out,
              float* __restrict__ w_out, float* __restrict__ probs_out) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kGateWarps + (threadIdx.x >> 5);
  if (t >= n_tok) return;  // whole warps leave together
  const bf16* xr = x + (size_t)t * d;

  float logit[kMaxE];
#pragma unroll
  for (int j = 0; j < kMaxE; ++j) logit[j] = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float xv = __bfloat162float(xr[c]);
    const bf16* rr = router + (size_t)c * e;
#pragma unroll
    for (int j = 0; j < kMaxE; ++j)
      if (j < e)
        logit[j] = fmaf(xv, __bfloat162float(__ldg(rr + j)), logit[j]);
  }
#pragma unroll
  for (int j = 0; j < kMaxE; ++j) {
    float v = logit[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    logit[j] = __bfloat162float(__float2bfloat16(v));  // rounded as x
  }

  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxE; ++j)
    if (j < e) m = fmaxf(m, logit[j]);
  float p[kMaxE];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxE; ++j) {
    p[j] = j < e ? expf(logit[j] - m) : 0.f;
    s += p[j];
  }
#pragma unroll
  for (int j = 0; j < kMaxE; ++j) {
    p[j] = p[j] / s;
    if (j < e && j == lane) probs_out[(size_t)t * e + j] = p[j];
  }

  // iterated first-max top-k: strict '>' keeps the lowest index on ties;
  // a taken expert is masked to -1 as in the TPU kernel
  float ws[kMaxK];
  int ids[kMaxK];
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    ws[i] = 0.f;
    ids[i] = 0;
    if (i < k) {
      float best = -INFINITY;
      int bi = 0;
#pragma unroll
      for (int j = 0; j < kMaxE; ++j)
        if (j < e && p[j] > best) {
          best = p[j];
          bi = j;
        }
#pragma unroll
      for (int j = 0; j < kMaxE; ++j)
        if (j == bi) p[j] = -1.f;
      ws[i] = best;
      ids[i] = bi;
      tot += best;
    }
  }
  if (lane == 0) {
    const float denom = fmaxf(tot, 1e-9f);
#pragma unroll
    for (int i = 0; i < kMaxK; ++i)
      if (i < k) {
        idx_out[(size_t)t * k + i] = ids[i];
        w_out[(size_t)t * k + i] = ws[i] / denom;
      }
  }
}

__global__ void __launch_bounds__(kPosThreads)
positions_kernel(const int32_t* __restrict__ idx, int n_tok, int k, int e,
                 int32_t* __restrict__ pos) {
  __shared__ int warp_cnt[kPosWarps][kPosMaxE];
  __shared__ int base[kPosMaxE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < e; j += kPosThreads) base[j] = 0;
  const int n = n_tok * k;
  for (int start = 0; start < n; start += kPosThreads) {
    // choice-major flat order: f = choice * T + token
    const int f = start + tid;
    int ex = -1, t = 0, c = 0;
    if (f < n) {
      c = f / n_tok;
      t = f - c * n_tok;
      ex = idx[(size_t)t * k + c];
      if (ex >= e) ex = -1;
    }
    for (int j = tid; j < kPosWarps * e; j += kPosThreads)
      warp_cnt[j / e][j % e] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, ex);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (ex >= 0 && lane == __ffs(peers) - 1) warp_cnt[warp][ex] = __popc(peers);
    __syncthreads();
    // exclusive scan of each expert's count over the warps, in order
    for (int j = tid; j < e; j += kPosThreads) {
      int run = base[j];
      for (int w = 0; w < kPosWarps; ++w) {
        const int cnt = warp_cnt[w][j];
        warp_cnt[w][j] = run;
        run += cnt;
      }
      base[j] = run;
    }
    __syncthreads();
    if (f < n) pos[(size_t)t * k + c] = ex >= 0 ? warp_cnt[warp][ex] + rank : 0;
    __syncthreads();
  }
}

}  // namespace

// x and router are bfloat16.
extern "C" int topk_gating(const void* x, const void* router, int n_tok,
                           int d, int e, int k, void* idx, void* w,
                           void* probs, void* stream) {
  if (e < 1 || e > kMaxE || k < 1 || k > kMaxK || k > e)
    return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return (int)cudaGetLastError();
  const dim3 grid((n_tok + kGateWarps - 1) / kGateWarps);
  gating_kernel<<<grid, kGateWarps * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)router, n_tok, d, e, k, (int32_t*)idx,
      (float*)w, (float*)probs);
  return (int)cudaGetLastError();
}

extern "C" int topk_positions(const void* idx, int n_tok, int k, int e,
                              void* pos, void* stream) {
  if (e < 1 || e > kPosMaxE) return (int)cudaErrorInvalidValue;
  if (n_tok == 0 || k == 0) return (int)cudaGetLastError();
  positions_kernel<<<1, kPosThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n_tok, k, e, (int32_t*)pos);
  return (int)cudaGetLastError();
}
