// The backward of the Mamba2 SSD scan for Hopper (sm_90a): x, dt, B and C
// bf16, read in place through their batch and time strides (the model's
// slices of one projection), a_log, D, h0 and the cotangents fp32; fp32
// state, sums and gradients.
//
// Replaces no TPU kernel: src/repro/kernels/ssd.py::ssd_scan has no VJP
// (the reference trains Mamba2 through jax.grad of its jnp chunked form,
// models/ssm.py::ssd_chunked, whose gradient is NaN at the default decays:
// it forms exp(L_t - L_s) above the diagonal and masks it afterwards).  It
// is the backward of csrc/ssd.cu's forward, so that the port trains
// zamba2-1.2b on the card.  Per (b, h), with d_t = softplus(dt_t),
// a = -e^{a_log}, g_t = e^{d_t a}, the [P, N] state h_t = g_t h_{t-1} +
// d_t x_t B_t^T, y_t = h_t C_t + D x_t, G_t the cotangent of h_t (the
// later steps' and y_t's; G_{T-1} starts from dh_T, or zero):
//   G_t    = g_{t+1} G_{t+1} + dy_t C_t^T
//   dC_t   = sum_h h_t^T dy_t            dB_t = sum_h d_t G_t^T x_t
//   dx_t   = D dy_t + d_t G_t B_t
//   ddt_t  = (x_t^T G_t B_t + a g_t <G_t, h_{t-1}>) sigmoid(dt_t)
//   da_log = a sum_{b, t} d_t g_t <G_t, h_{t-1}>
//   dD     = sum_{b, t} dy_t . x_t,      dh0 = g_0 G_0.
// The plain version is kernels/ref.py::ref_ssd_bwd.  Every decay is the
// product of a step's g_t, never an exponent of a difference of sums, so
// no term overflows where the forward does not.
//
// Bound on the card: bytes.  x, dt, B, C read once in bf16 and dy in fp32;
// dx, ddt, dB, dC written once in fp32 (at 4 x 2048, 64 heads: 345 MB,
// 0.103 ms at 3.35 TB/s).  The function's arithmetic is ~14 P N a step of
// a head: 0.031 ms at the bf16 tensor-core peak, 0.45 ms at the fp32 rate
// these CUDA cores run it at.  Measured on an H100 (chip_smoke.py phase
// 1): ~8.0 ms at 4 x 2048 x 64 heads, 1.3% of the bound: 256 blocks of
// one an SM run in two waves, each step a dependent chain of ~50 shuffles.
//
// Design (a simple kernel, right first; its redesign on the tensor cores is
// later work):
// - One block per (b, h), 512 threads; thread (p, g) holds row p of h and
//   G, columns 8 g .. 8 g + 7, in registers.  Rows never mix in either
//   recurrence: G B (dx) is a sum over one row's 8 threads; dB, dC, and
//   the two scalars of ddt sum over rows: shuffles within a warp, then the
//   16 warps' partials from shared memory in warp order.
// - h_{t-1} is needed walking back, and recovering it by dividing by g_t
//   underflows under strong decays.  So a forward sweep first writes h at
//   every R = 8 steps to a scratch buffer (B H ceil(T / 8) P N fp32: 1 GiB
//   at 4 x 2048 x 64 heads), and the reverse walk, R steps at a time,
//   reloads the state at the start of its R steps and recomputes them into
//   registers, then walks them back.
// - B and C are shared by every head, so dB and dC are written per head to
//   scratch [B, T, H, N] and summed over h in order by a second kernel,
//   which also sums da_log's and dD's per-(b, h) partials over b: no float
//   atomics, so every call repeats bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int P = 64;             // head dim, the one instance
constexpr int N = 64;             // state dim
constexpr int R = 8;              // steps a checkpoint / recomputed stretch
constexpr int kThreads = 512;     // 64 rows x 8 column groups
constexpr int kWarps = kThreads / 32;
constexpr int kCols = N / 8;      // columns a thread

struct Smem {
  float x[R][P], dy[R][P], b[R][N], c[R][N];
  float dtp[R], dec[R], sig[R];
  float dcp[R][kWarps][N], dbp[R][kWarps][N];   // per-warp partials
  float sp[R][kWarps][3];         // per-warp x^T G B, <G, h_{t-1}>, dy . x
  float dx[R][P];
};

struct Args {
  const __nv_bfloat16 *x, *dt, *b, *c;
  const float *a_log, *d_skip, *h0, *dy, *dhT;
  float *dx, *ddt, *dbh, *dch, *da_part, *dd_part, *dh0, *ckpt;
  long long xs_b, xs_t, dts_b, dts_t, bs_b, bs_t, cs_b, cs_t;
  int T, H;
};

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));     // torch's threshold
}

// Stage steps t0 .. t0 + R - 1 of (b, h): x, B (and C, dy with
// ``with_c``) and the step's d, g, sigmoid(dt); zeros and g = 1 past T.
__device__ __forceinline__ void stage(Smem& sm, const Args& a, int bb, int h,
                                      float A, int t0, bool with_c) {
  const int rr = threadIdx.x / P, j = threadIdx.x % P;
  const int t = t0 + rr;
  const bool in = t < a.T;
  const __nv_bfloat16* xr = a.x + bb * a.xs_b + (long long)t * a.xs_t + h * P;
  const __nv_bfloat16* br = a.b + bb * a.bs_b + (long long)t * a.bs_t;
  sm.x[rr][j] = in ? __bfloat162float(xr[j]) : 0.f;
  sm.b[rr][j] = in ? __bfloat162float(br[j]) : 0.f;
  if (with_c) {
    const __nv_bfloat16* cr =
        a.c + bb * a.cs_b + (long long)t * a.cs_t;
    sm.c[rr][j] = in ? __bfloat162float(cr[j]) : 0.f;
    sm.dy[rr][j] =
        in ? a.dy[(((size_t)bb * a.T + t) * a.H + h) * P + j] : 0.f;
  }
  if (j == 0) {
    float d = 0.f, g = 1.f, s = 0.f;
    if (in) {
      const float v = __bfloat162float(
          a.dt[bb * a.dts_b + (long long)t * a.dts_t + h]);
      d = softplus(v);
      g = expf(d * A);
      s = 1.f / (1.f + expf(-v));
    }
    sm.dtp[rr] = d;
    sm.dec[rr] = g;
    sm.sig[rr] = s;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int bb = bh / a.H, h = bh % a.H;
  const int T = a.T;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = tid / 8, g = tid % 8, n0 = g * kCols;
  const int nsub = (T + R - 1) / R;
  const float A = -expf(a.a_log[h]);
  const float Dh = a.d_skip[h];
  float* my_ckpt = a.ckpt + (size_t)bh * nsub * P * N + p * N + n0;
  const size_t state_off = (size_t)bh * P * N + p * N + n0;

  // -- forward sweep: the state before every R-th step to the scratch
  float S[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) S[q] = a.h0 ? a.h0[state_off + q] : 0.f;
  for (int c = 0; c < nsub; ++c) {
    float4* dst = reinterpret_cast<float4*>(my_ckpt + (size_t)c * P * N);
    dst[0] = make_float4(S[0], S[1], S[2], S[3]);
    dst[1] = make_float4(S[4], S[5], S[6], S[7]);
    __syncthreads();
    stage(sm, a, bb, h, A, c * R, false);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float gd = sm.dec[rr], xd = sm.dtp[rr] * sm.x[rr][p];
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        S[q] = gd * S[q] + xd * sm.b[rr][n0 + q];
    }
  }

  // -- reverse walk, R steps at a time
  float G[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) G[q] = a.dhT ? a.dhT[state_off + q] : 0.f;
  float da_acc = 0.f, dd_acc = 0.f;
  for (int c = nsub - 1; c >= 0; --c) {
    const int t0 = c * R;
    __syncthreads();
    stage(sm, a, bb, h, A, t0, true);
    __syncthreads();
    float hist[R][kCols];
    {
      const float4* src =
          reinterpret_cast<const float4*>(my_ckpt + (size_t)c * P * N);
      const float4 lo = src[0], hi = src[1];
      S[0] = lo.x; S[1] = lo.y; S[2] = lo.z; S[3] = lo.w;
      S[4] = hi.x; S[5] = hi.y; S[6] = hi.z; S[7] = hi.w;
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float gd = sm.dec[rr], xd = sm.dtp[rr] * sm.x[rr][p];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        hist[rr][q] = S[q];
        S[q] = gd * S[q] + xd * sm.b[rr][n0 + q];
      }
    }
#pragma unroll
    for (int rr = R - 1; rr >= 0; --rr) {
      if (t0 + rr >= T) continue;                 // block-uniform
      const float gd = sm.dec[rr], d = sm.dtp[rr];
      const float xp = sm.x[rr][p], dyp = sm.dy[rr][p];
      float gb = 0.f, q2 = 0.f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float bq = sm.b[rr][n0 + q];
        G[q] += dyp * sm.c[rr][n0 + q];
        gb += G[q] * bq;
        q2 += G[q] * hist[rr][q];
      }
      gb += __shfl_xor_sync(0xffffffffu, gb, 1);
      gb += __shfl_xor_sync(0xffffffffu, gb, 2);
      gb += __shfl_xor_sync(0xffffffffu, gb, 4);
      if (g == 0) sm.dx[rr][p] = Dh * dyp + d * gb;
      const float s1 = warp_sum(g == 0 ? xp * gb : 0.f);
      const float dd = warp_sum(g == 0 ? xp * dyp : 0.f);
      q2 = warp_sum(q2);
      if (lane == 0) {
        sm.sp[rr][warp][0] = s1;
        sm.sp[rr][warp][1] = q2;
        sm.sp[rr][warp][2] = dd;
      }
      // h_t^T dy_t and G_t^T x_t over the warp's 4 rows
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float ha = gd * hist[rr][q] + d * xp * sm.b[rr][n0 + q];
        float dc = ha * dyp, db = G[q] * xp;
        dc += __shfl_xor_sync(0xffffffffu, dc, 8);
        dc += __shfl_xor_sync(0xffffffffu, dc, 16);
        db += __shfl_xor_sync(0xffffffffu, db, 8);
        db += __shfl_xor_sync(0xffffffffu, db, 16);
        if (lane < 8) {
          sm.dcp[rr][warp][n0 + q] = dc;
          sm.dbp[rr][warp][n0 + q] = db;
        }
        G[q] *= gd;
      }
    }
    __syncthreads();
    {                      // one (step, channel) of the stretch a thread
      const int rr = tid / N, j = tid % N;
      const int t = t0 + rr;
      if (t < T) {
        float cc = 0.f, bsum = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) {
          cc += sm.dcp[rr][ww][j];
          bsum += sm.dbp[rr][ww][j];
        }
        const size_t row = ((size_t)bb * T + t) * a.H + h;
        a.dch[row * N + j] = cc;
        a.dbh[row * N + j] = sm.dtp[rr] * bsum;
        a.dx[row * P + j] = sm.dx[rr][j];
      }
    }
    if (tid == 0) {        // the stretch's scalars, in step order
      for (int rr = 0; rr < R; ++rr) {
        const int t = t0 + rr;
        if (t >= T) break;
        float s1 = 0.f, q2 = 0.f, dd = 0.f;
        for (int ww = 0; ww < kWarps; ++ww) {
          s1 += sm.sp[rr][ww][0];
          q2 += sm.sp[rr][ww][1];
          dd += sm.sp[rr][ww][2];
        }
        const float gd = sm.dec[rr], d = sm.dtp[rr];
        a.ddt[((size_t)bb * T + t) * a.H + h] =
            (s1 + A * gd * q2) * sm.sig[rr];
        da_acc += d * gd * q2;
        dd_acc += dd;
      }
    }
  }
  float4* dst = reinterpret_cast<float4*>(a.dh0 + state_off);
  dst[0] = make_float4(G[0], G[1], G[2], G[3]);
  dst[1] = make_float4(G[4], G[5], G[6], G[7]);
  if (tid == 0) {
    a.da_part[bh] = da_acc;
    a.dd_part[bh] = dd_acc;
  }
}

// dB[b, t, n] and dC[b, t, n]: the per-head partials summed over h in
// order; da_log[h] = a[h] times, and dD[h], the per-(b, h) partials summed
// over b in order.
__global__ void ssd_sum_kernel(const float* __restrict__ dbh,
                               const float* __restrict__ dch,
                               const float* __restrict__ da_part,
                               const float* __restrict__ dd_part,
                               const float* __restrict__ a_log,
                               float* __restrict__ db, float* __restrict__ dc,
                               float* __restrict__ da_log,
                               float* __restrict__ dd, long long rows, int B,
                               int H) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < rows * N) {
    const long long row = idx / N;
    const int n = (int)(idx % N);
    const float* pb = dbh + row * H * N + n;
    const float* pc = dch + row * H * N + n;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[(size_t)h * N];
      sc += pc[(size_t)h * N];
    }
    db[idx] = sb;
    dc[idx] = sc;
  } else if (idx < rows * N + H) {
    const int h = (int)(idx - rows * N);
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < B; ++b) {
      sa += da_part[(size_t)b * H + h];
      sd += dd_part[(size_t)b * H + h];
    }
    da_log[h] = -expf(a_log[h]) * sa;
    dd[h] = sd;
  }
}

}  // namespace

// x: bf16 [B, T, H, 64], dt: bf16 [B, T, H], b, c: bf16 [B, T, 64], each
// read through its batch and time strides (elements; the dims after time
// contiguous); a_log, d_skip: fp32 [H]; h0, dhT: fp32 [B, H, 64, 64] or
// null (zeros); dy: fp32 [B, T, H, 64] contiguous.  Writes dx (fp32 [B, T,
// H, 64]), ddt (fp32 [B, T, H]), da_log and dd (fp32 [H]), db and dc (fp32
// [B, T, 64]) and dh0 (fp32 [B, H, 64, 64]); dbh and dch (fp32 [B, T, H,
// 64]), da_part and dd_part (fp32 [B, H]) and ckpt (fp32 [B, H, ceil(T /
// 8), 64, 64]) are scratch.  Returns cudaGetLastError().
extern "C" int ssd_scan_bwd(
    const void* x, const void* dt, const void* a_log, const void* b,
    const void* c, const void* d_skip, const void* h0, const void* dy,
    const void* dhT, void* dx, void* ddt, void* da_log, void* db, void* dc,
    void* dd, void* dh0, void* dbh, void* dch, void* da_part, void* dd_part,
    void* ckpt, int bsz, int t, int h, int p, int n, long long xs_b,
    long long xs_t, long long dts_b, long long dts_t, long long bs_b,
    long long bs_t, long long cs_b, long long cs_t, void* stream) {
  if (bsz < 0 || t < 0 || h < 0 || p != P || n != N)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || h == 0) return (int)cudaGetLastError();
  Args a;
  a.x = (const __nv_bfloat16*)x;
  a.dt = (const __nv_bfloat16*)dt;
  a.b = (const __nv_bfloat16*)b;
  a.c = (const __nv_bfloat16*)c;
  a.a_log = (const float*)a_log;
  a.d_skip = (const float*)d_skip;
  a.h0 = (const float*)h0;
  a.dy = (const float*)dy;
  a.dhT = (const float*)dhT;
  a.dx = (float*)dx;
  a.ddt = (float*)ddt;
  a.dbh = (float*)dbh;
  a.dch = (float*)dch;
  a.da_part = (float*)da_part;
  a.dd_part = (float*)dd_part;
  a.dh0 = (float*)dh0;
  a.ckpt = (float*)ckpt;
  a.xs_b = xs_b;
  a.xs_t = xs_t;
  a.dts_b = dts_b;
  a.dts_t = dts_t;
  a.bs_b = bs_b;
  a.bs_t = bs_t;
  a.cs_b = cs_b;
  a.cs_t = cs_t;
  a.T = t;
  a.H = h;
  const int smem = (int)sizeof(Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  ssd_bwd_kernel<<<bsz * h, kThreads, smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)bsz * t;
  const long long total = rows * N + h;
  ssd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      (const float*)dbh, (const float*)dch, (const float*)da_part,
      (const float*)dd_part, (const float*)a_log, (float*)db, (float*)dc,
      (float*)da_log, (float*)dd, rows, bsz, h);
  return (int)cudaGetLastError();
}
