// The backward of the RWKV6 WKV recurrence for Hopper (sm_90a): bf16 r, k,
// v, fp32 log decay w, bonus u, initial state s0 and cotangents; fp32
// state, sums and gradients.
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
// Bound on the card: bytes.  r, k, v read once in bf16, w and dy once in
// fp32, dr, dk, dv, dw written once in fp32 (30 bytes a value: 503 MB at
// 4 x 2048 x 32 heads, 0.150 ms at 3.35 TB/s).  The function's arithmetic
// is ~14 hd^2 a step of a head (the state's update, S dy, G v, G^T k,
// S .* G, the cotangent's update): 0.015 ms at the bf16 tensor-core peak,
// 0.23 ms at the fp32 rate these CUDA cores run it at (the state is
// recomputed twice besides).  Measured on an H100 (chip_smoke.py phase
// 1): ~2.7 ms at 4 x 2048 x 32 heads, 5.5% of the bound: one block an SM,
// each step a dependent chain of shuffles.
//
// Design (a simple kernel, right first; its redesign on the tensor cores is
// later work):
// - One block per (b, h), 512 threads; thread (i, g) holds row i of S and
//   G, columns 8 g .. 8 g + 7, in registers.  Rows never mix in either
//   recurrence, so dr, dk and dw are each a sum over one row's 8 threads
//   (three shuffles); dv sums over rows: two shuffles within a warp, then
//   the 16 warps' partials from shared memory in warp order.
// - S_{t-1} is needed walking back, and recovering it by dividing by x_t
//   overflows under strong decays.  So a forward sweep first writes S at
//   every R = 8 steps to a scratch buffer (B H ceil(T / 8) hd^2 fp32:
//   512 MiB at 4 x 2048 x 32 heads), and the reverse walk, R steps at a
//   time, reloads the state at the start of its R steps and recomputes
//   them into registers (8 x 8 values a thread), then walks them back.
// - Each R steps' inputs are staged in shared memory (rows past T zeros,
//   w 0, so the recomputed state stands still there).  No float atomics:
//   du is one partial a (b, h), summed over b in order by a second
//   kernel, so every call repeats bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 64;            // head dim, the one instance
constexpr int R = 8;              // steps a checkpoint / recomputed stretch
constexpr int kThreads = 512;     // 64 rows x 8 column groups
constexpr int kWarps = kThreads / 32;
constexpr int kCols = HD / 8;     // columns a thread

struct Smem {
  float r[R][HD], k[R][HD], v[R][HD], x[R][HD], dy[R][HD];
  float vdy[R], ruk[R];
  float dvp[R][kWarps][HD];       // per-warp partials of G^T k
  float out[R][3][HD];            // dr, dk, dw of the stretch
};

__device__ __forceinline__ float row_sum8(float a) {
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  a += __shfl_xor_sync(0xffffffffu, a, 4);
  return a;
}

// Stage steps t0 .. t0 + R - 1 of (b, h): r, k, v (bf16), x = e^w and dy;
// zeros (x = 1) past T.  ``with_r``: the reverse walk also needs r and dy.
__device__ __forceinline__ void stage(Smem& sm, const __nv_bfloat16* r,
                                      const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, const float* w,
                                      const float* dy, int t0, int T, int H,
                                      size_t base, bool with_r) {
  const int rr = threadIdx.x / HD, j = threadIdx.x % HD;
  const int t = t0 + rr;
  const bool in = t < T;
  const size_t o = base + (size_t)t * H * HD + j;
  sm.k[rr][j] = in ? __bfloat162float(k[o]) : 0.f;
  sm.v[rr][j] = in ? __bfloat162float(v[o]) : 0.f;
  sm.x[rr][j] = in ? expf(w[o]) : 1.f;
  if (with_r) {
    sm.r[rr][j] = in ? __bfloat162float(r[o]) : 0.f;
    sm.dy[rr][j] = in ? dy[o] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
wkv_bwd_kernel(const __nv_bfloat16* __restrict__ r,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, const float* __restrict__ dy,
               const float* __restrict__ dsT, float* __restrict__ dr,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ds0, float* __restrict__ ckpt, int T,
               int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i = tid / 8, g = tid % 8, j0 = g * kCols;
  const size_t base = (size_t)b * T * H * HD + (size_t)h * HD;
  const int nsub = (T + R - 1) / R;
  float* my_ckpt = ckpt + (size_t)bh * nsub * HD * HD + i * HD + j0;
  const size_t state_off = (size_t)bh * HD * HD + i * HD + j0;

  // -- forward sweep: the state before every R-th step to the scratch
  float S[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) S[q] = s0 ? s0[state_off + q] : 0.f;
  for (int c = 0; c < nsub; ++c) {
    float4* dst = reinterpret_cast<float4*>(my_ckpt + (size_t)c * HD * HD);
    dst[0] = make_float4(S[0], S[1], S[2], S[3]);
    dst[1] = make_float4(S[4], S[5], S[6], S[7]);
    __syncthreads();
    stage(sm, r, k, v, w, dy, c * R, T, H, base, false);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float xi = sm.x[rr][i], ki = sm.k[rr][i];
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        S[q] = xi * S[q] + ki * sm.v[rr][j0 + q];
    }
  }

  // -- reverse walk, R steps at a time
  float G[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) G[q] = dsT ? dsT[state_off + q] : 0.f;
  const float ui = u[h * HD + i];
  float du_acc = 0.f;
  for (int c = nsub - 1; c >= 0; --c) {
    const int t0 = c * R;
    __syncthreads();
    stage(sm, r, k, v, w, dy, t0, T, H, base, true);
    __syncthreads();
    if (warp < R) {       // the step's v . dy and r . (u k), one warp a step
      const int rr = warp;
      float a = 0.f, e = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int jj = lane * 2 + q;
        a += sm.v[rr][jj] * sm.dy[rr][jj];
        e += sm.r[rr][jj] * u[h * HD + jj] * sm.k[rr][jj];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        e += __shfl_xor_sync(0xffffffffu, e, off);
      }
      if (lane == 0) {
        sm.vdy[rr] = a;
        sm.ruk[rr] = e;
      }
    }
    // the states before each of the R steps, from the checkpoint
    float hist[R][kCols];
    {
      const float4* src =
          reinterpret_cast<const float4*>(my_ckpt + (size_t)c * HD * HD);
      const float4 lo = src[0], hi = src[1];
      S[0] = lo.x; S[1] = lo.y; S[2] = lo.z; S[3] = lo.w;
      S[4] = hi.x; S[5] = hi.y; S[6] = hi.z; S[7] = hi.w;
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float xi = sm.x[rr][i], ki = sm.k[rr][i];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        hist[rr][q] = S[q];
        S[q] = xi * S[q] + ki * sm.v[rr][j0 + q];
      }
    }
    __syncthreads();      // vdy / ruk written
#pragma unroll
    for (int rr = R - 1; rr >= 0; --rr) {
      if (t0 + rr >= T) continue;                 // block-uniform
      const float ri = sm.r[rr][i], ki = sm.k[rr][i], xi = sm.x[rr][i];
      const float vdy = sm.vdy[rr];
      float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        pr += hist[rr][q] * sm.dy[rr][j0 + q];
        pk += G[q] * sm.v[rr][j0 + q];
        pw += hist[rr][q] * G[q];
      }
      pr = row_sum8(pr);
      pk = row_sum8(pk);
      pw = row_sum8(pw);
      if (g == 0) {
        sm.out[rr][0][i] = pr + ui * ki * vdy;
        sm.out[rr][1][i] = pk + ui * ri * vdy;
        sm.out[rr][2][i] = xi * pw;
        du_acc += ri * ki * vdy;
      }
      // G^T k over the warp's 4 rows (lanes g, g + 8, g + 16, g + 24)
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        float d = G[q] * ki;
        d += __shfl_xor_sync(0xffffffffu, d, 8);
        d += __shfl_xor_sync(0xffffffffu, d, 16);
        if (lane < 8) sm.dvp[rr][warp][j0 + q] = d;
        G[q] = xi * G[q] + ri * sm.dy[rr][j0 + q];
      }
    }
    __syncthreads();
    {                      // one (step, channel) of the stretch a thread
      const int rr = tid / HD, j = tid % HD;
      const int t = t0 + rr;
      if (t < T) {
        float acc = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) acc += sm.dvp[rr][ww][j];
        const size_t o = base + (size_t)t * H * HD + j;
        dv[o] = acc + sm.ruk[rr] * sm.dy[rr][j];
        dr[o] = sm.out[rr][0][j];
        dk[o] = sm.out[rr][1][j];
        dw[o] = sm.out[rr][2][j];
      }
    }
  }
  float4* dst = reinterpret_cast<float4*>(ds0 + state_off);
  dst[0] = make_float4(G[0], G[1], G[2], G[3]);
  dst[1] = make_float4(G[4], G[5], G[6], G[7]);
  if (g == 0) du_part[(size_t)bh * HD + i] = du_acc;
}

// du[h, i] = sum over b of the (b, h) partials, in order of b.
__global__ void du_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ du, int B, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + idx];
  du[idx] = acc;
}

}  // namespace

// r, k, v: bf16 [B, T, H, 64]; w, dy: fp32 [B, T, H, 64]; u: fp32 [H, 64];
// s0, dsT: fp32 [B, H, 64, 64] or null (zeros); every tensor contiguous.
// Writes dr, dk, dv, dw (fp32 [B, T, H, 64]), du (fp32 [H, 64]) and ds0
// (fp32 [B, H, 64, 64]); du_part (fp32 [B, H, 64]) and ckpt (fp32 [B, H,
// ceil(T / 8), 64, 64]) are scratch.  Returns cudaGetLastError().
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* dy, const void* dsT, void* dr,
                             void* dk, void* dv, void* dw, void* du,
                             void* ds0, void* du_part, void* ckpt, int b,
                             int t, int h, int hd, void* stream) {
  if (b < 0 || t < 0 || h < 0 || hd != HD) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaGetLastError();
  const int smem = (int)sizeof(Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  wkv_bwd_kernel<<<b * h, kThreads, smem, s>>>(
      (const __nv_bfloat16*)r, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)w, (const float*)u,
      (const float*)s0, (const float*)dy, (const float*)dsT, (float*)dr,
      (float*)dk, (float*)dv, (float*)dw, (float*)du_part, (float*)ds0,
      (float*)ckpt, t, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = h * HD;
  du_sum_kernel<<<(n + 255) / 256, 256, 0, s>>>((const float*)du_part,
                                                 (float*)du, b, n);
  return (int)cudaGetLastError();
}
