// Grouped expert FFN for Hopper (sm_90a), bf16 in, fp32 sums, bf16 out.
//
// Replaces src/repro/kernels/moe_ffn.py::grouped_ffn (_kernel): per group g,
// y[g] = act(x[g] @ wi[g]) @ wo[g], act = gelu (tanh form) or
// silu(x @ wi) * (x @ wu).  The TPU kernel fuses both products over F tiles
// and keeps a [bt, D] fp32 output block resident in VMEM; that block does not
// fit a Hopper block's registers, so this is two launches of one tiled
// grouped GEMM: the first applies the activation to its fp32 tile and stores
// h in bf16 (as the TPU kernel casts h to x's type before the second
// product), the second multiplies h by wo.
//
// Each block computes a BM x BN output tile of one group with 4 warps on the
// tensor cores (warp-level mma through nvcuda::wmma, 16x16x16 bf16 -> fp32),
// staging BM x BK and BK x BN tiles in shared memory and prefetching the next
// K step into registers while the current one multiplies.  Bound on the card:
// bytes.  On the serve path T (rows per slot) is 8..48, so each weight byte
// is used for 2*T operations, far below the ~295 operations per byte where
// the tensor cores become the limit; the G*D*F*2*2 B of wi and wo dominate.
// BM = 32 reads every weight tile once for T <= 32.
//
// grouped_matmul (second half of the file) replaces
// src/repro/kernels/moe_ffn.py::grouped_matmul (_mm_kernel): the dgrad /
// wgrad GEMMs of the FFN backward, c[g] = a[g] @ b[g] in fp32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 32, BN = 64, BK = 32;
constexpr int kThreads = 128;             // 4 warps: 2 row bands x 2 col halves
constexpr int kLdA = BK + 8, kLdB = BN + 8, kLdC = BN + 4;
enum Epi { kNone = 0, kGelu = 1, kSwiglu = 2 };

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True)
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <int EPI>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    const bf16* __restrict__ b2, bf16* __restrict__ c, int m,
                    int n, int k) {
  constexpr bool kTwo = EPI == kSwiglu;
  __shared__ __align__(128) bf16 as[BM][kLdA];
  __shared__ __align__(128) bf16 bs[BK][kLdB];
  __shared__ __align__(128) bf16 bs2[kTwo ? BK : 1][kLdB];
  __shared__ __align__(128) float cs[BM][kLdC];
  __shared__ __align__(128) float cs2[kTwo ? BM : 1][kLdC];

  const int g = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  a += (size_t)g * m * k;
  b += (size_t)g * k * n;
  if constexpr (kTwo) b2 += (size_t)g * k * n;
  c += (size_t)g * m * n;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = (warp >> 1) * 16;  // row band of this warp
  const int wc = (warp & 1) * 32;   // two 16-wide column tiles from here

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2], acc2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(acc[j], 0.f);
    wmma::fill_fragment(acc2[j], 0.f);
  }

  // 16-byte staging: the A tile is 128 vectors (one a thread), each B tile
  // 256 (two a thread)
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  uint4 ra, rb[2], rb2[2];
  auto load = [&](int k0) {
    ra = m0 + ar < m
             ? *reinterpret_cast<const uint4*>(a + (size_t)(m0 + ar) * k + k0 + ac)
             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads, br = v >> 3, bc = (v & 7) * 8;
      const size_t off = (size_t)(k0 + br) * n + n0 + bc;
      rb[i] = *reinterpret_cast<const uint4*>(b + off);
      if constexpr (kTwo) rb2[i] = *reinterpret_cast<const uint4*>(b2 + off);
    }
  };
  auto stage = [&]() {
    *reinterpret_cast<uint4*>(&as[ar][ac]) = ra;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads, br = v >> 3, bc = (v & 7) * 8;
      *reinterpret_cast<uint4*>(&bs[br][bc]) = rb[i];
      if constexpr (kTwo) *reinterpret_cast<uint4*>(&bs2[br][bc]) = rb2[i];
    }
  };

  load(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &as[wr][kk], kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &bs[kk][wc + 16 * j], kLdB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
        if constexpr (kTwo) {
          wmma::load_matrix_sync(fb, &bs2[kk][wc + 16 * j], kLdB);
          wmma::mma_sync(acc2[j], fa, fb, acc2[j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(&cs[wr][wc + 16 * j], acc[j], kLdC,
                            wmma::mem_row_major);
    if constexpr (kTwo)
      wmma::store_matrix_sync(&cs2[wr][wc + 16 * j], acc2[j], kLdC,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, col = i % BN;
    if (m0 + r >= m) continue;
    float v = cs[r][col];
    if constexpr (EPI == kGelu) v = gelu_tanh(v);
    if constexpr (kTwo) v = silu(v) * cs2[r][col];
    c[(size_t)(m0 + r) * n + n0 + col] = __float2bfloat16(v);
  }
}

template <int EPI>
void launch(const bf16* a, const bf16* b, const bf16* b2, bf16* c, int g,
            int m, int n, int k, cudaStream_t s) {
  const dim3 grid(n / BN, (m + BM - 1) / BM, g);
  grouped_gemm_kernel<EPI><<<grid, kThreads, 0, s>>>(a, b, b2, c, m, n, k);
}

}  // namespace

// x [G,T,D], wi/wu [G,D,F], wo [G,F,D], h scratch [G,T,F], out [G,T,D], all
// bf16 and contiguous; wu may be null for gelu.  D % 64 == 0, F % 64 == 0.
// act: 1 gelu (tanh form), 2 swiglu.
extern "C" int grouped_ffn(const void* x, const void* wi, const void* wu,
                           const void* wo, void* h, void* out, int g, int t,
                           int d, int f, int act, void* stream) {
  if (d % BN || f % BN || d % BK || f % BK || (act != kGelu && act != kSwiglu) ||
      (act == kSwiglu && wu == nullptr))
    return (int)cudaErrorInvalidValue;
  if (g == 0 || t == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (act == kGelu)
    launch<kGelu>((const bf16*)x, (const bf16*)wi, nullptr, (bf16*)h, g, t, f,
                  d, s);
  else
    launch<kSwiglu>((const bf16*)x, (const bf16*)wi, (const bf16*)wu,
                    (bf16*)h, g, t, f, d, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch<kNone>((const bf16*)h, (const bf16*)wo, nullptr, (bf16*)out, g, t, d,
                f, s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// grouped_matmul: c[g] = a[g] @ b[g], a [G,M,K], b [G,K,N], c [G,M,N] fp32.
//
// The FFN backward (src/repro/kernels/ops.py::_grouped_ffn_bwd) multiplies
// bf16 activations and weights with fp32 cotangents, by the transposes of
// x, act, wi and wo, at M, N, K of D = 768, F = 3072 and the capacity C
// (1288 at gpt2-moe training: not a multiple of any tile).  So:
//   * each operand is bf16 or fp32 (template TA / TB);
//   * each operand is either row-major or the transpose view of a row-major
//     array (template AT: a is M-contiguous, BT: b is K-contiguous), read
//     in place through the transpose flag, never copied;
//   * every edge is masked: out-of-range loads read 0, stores are skipped.
// Bound on the card: operations.  At the training shapes each GEMM does
// 2*16*1288*768*3072 = 97 GFLOP on 0.1-0.4 GB of operands, far above the
// ~295 operations per byte where the tensor cores become the limit.
// Design: 128 x 128 output tile per block, 8 warps (4 row bands x 2 column
// halves, each warp 32 x 64 = 2 x 4 fragments), K in steps of 32 staged in
// shared memory in the operand's own layout (coalesced global reads; the
// WMMA fragment layout, row_major or col_major, absorbs the transpose), the
// next K step prefetched into registers while the current one multiplies.
// Both operands bf16: bf16 m16n16k16 (exact products, fp32 sums).
// Otherwise: TF32 m16n16k8 on fp32 staging (bf16 -> fp32 -> tf32 is exact;
// an fp32 operand is rounded to tf32's 10-bit mantissa), fp32 sums.  The TPU
// kernel multiplies fp32 operands at the MXU's default bf16-pass precision,
// so TF32 is not below the reference's own precision.
namespace {

constexpr int GM = 128, GN = 128, GK = 32;
constexpr int kGThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename S, typename T>
__device__ __forceinline__ S to_smem(T v) {
  if constexpr (std::is_same<S, float>::value) return to_f32(v);
  else return v;  // bf16 staging only when the operand is bf16
}

template <typename TA, typename TB, bool AT, bool BT>
__global__ void __launch_bounds__(kGThreads)
grouped_matmul_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                      float* __restrict__ c, int m, int n, int k) {
  constexpr bool kBf = std::is_same<TA, bf16>::value &&
                       std::is_same<TB, bf16>::value;
  using S = typename std::conditional<kBf, bf16, float>::type;
  constexpr int kPad = kBf ? 8 : 4;
  constexpr int KS = kBf ? 16 : 8;           // WMMA depth
  // shared tiles in the operand's global layout
  constexpr int kAr = AT ? GK : GM, kAc = (AT ? GM : GK) + kPad;
  constexpr int kBr = BT ? GN : GK, kBc = (BT ? GK : GN) + kPad;
  __shared__ __align__(128) S as[kAr][kAc];
  __shared__ __align__(128) S bs[kBr][kBc];

  using FragIn = typename std::conditional<kBf, bf16,
                                           wmma::precision::tf32>::type;
  using LA = typename std::conditional<AT, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<BT, wmma::col_major,
                                       wmma::row_major>::type;

  const int g = blockIdx.z, m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  a += (size_t)g * m * k;
  b += (size_t)g * k * n;
  c += (size_t)g * m * n;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = (warp >> 1) * 32;   // 4 row bands of 32
  const int wc = (warp & 1) * 64;    // 2 column halves of 64

  wmma::fragment<wmma::accumulator, 16, 16, KS, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  constexpr int kPer = GM * GK / kGThreads;  // 16 elements of each tile
  TA ra[kPer];
  TB rb[kPer];
  // element e of a tile: (row, col) of the shared array, whose columns are
  // the operand's contiguous dimension
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kGThreads;
      const int r = e / (kAc - kPad), cc = e % (kAc - kPad);
      const int gm = AT ? m0 + cc : m0 + r, gk = AT ? k0 + r : k0 + cc;
      ra[i] = (gm < m && gk < k)
                  ? a[AT ? (size_t)gk * m + gm : (size_t)gm * k + gk]
                  : TA(0.f);
      const int r2 = e / (kBc - kPad), c2 = e % (kBc - kPad);
      const int gn = BT ? n0 + r2 : n0 + c2, gk2 = BT ? k0 + c2 : k0 + r2;
      rb[i] = (gn < n && gk2 < k)
                  ? b[BT ? (size_t)gn * k + gk2 : (size_t)gk2 * n + gn]
                  : TB(0.f);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kGThreads;
      as[e / (kAc - kPad)][e % (kAc - kPad)] = to_smem<S>(ra[i]);
      bs[e / (kBc - kPad)][e % (kBc - kPad)] = to_smem<S>(rb[i]);
    }
  };

  load(0);
  for (int k0 = 0; k0 < k; k0 += GK) {
    stage();
    __syncthreads();
    if (k0 + GK < k) load(k0 + GK);
#pragma unroll
    for (int kk = 0; kk < GK; kk += KS) {
      wmma::fragment<wmma::matrix_a, 16, 16, KS, FragIn, LA> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (AT) wmma::load_matrix_sync(fa[i], &as[kk][wr + 16 * i], kAc);
        else wmma::load_matrix_sync(fa[i], &as[wr + 16 * i][kk], kAc);
        if constexpr (!kBf) {
#pragma unroll
          for (int t = 0; t < fa[i].num_elements; ++t)
            fa[i].x[t] = wmma::__float_to_tf32(fa[i].x[t]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, KS, FragIn, LB> fb;
        if constexpr (BT) wmma::load_matrix_sync(fb, &bs[wc + 16 * j][kk], kBc);
        else wmma::load_matrix_sync(fb, &bs[kk][wc + 16 * j], kBc);
        if constexpr (!kBf) {
#pragma unroll
          for (int t = 0; t < fb.num_elements; ++t)
            fb.x[t] = wmma::__float_to_tf32(fb.x[t]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16 x 16 fragment at a time in its own
  // 1 KB of the (now idle) A tile and writes the in-range part
  static_assert(sizeof(as) >= 8 * 256 * sizeof(float), "staging room");
  float* st = reinterpret_cast<float*>(&as[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wr + 16 * i + e / 16;
        const int gn = n0 + wc + 16 * j + e % 16;
        if (gm < m && gn < n) c[(size_t)gm * n + gn] = st[e];
      }
      __syncwarp();
    }
}

template <typename TA, typename TB, bool AT, bool BT>
cudaError_t launch_mm(const void* a, const void* b, float* c, int g, int m,
                      int n, int k, cudaStream_t s) {
  const dim3 grid((n + GN - 1) / GN, (m + GM - 1) / GM, g);
  grouped_matmul_kernel<TA, TB, AT, BT><<<grid, kGThreads, 0, s>>>(
      (const TA*)a, (const TB*)b, c, m, n, k);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch_mm_t(const void* a, const void* b, float* c, int g, int m,
                        int n, int k, int a_t, int b_t, cudaStream_t s) {
  if (a_t && b_t) return launch_mm<TA, TB, true, true>(a, b, c, g, m, n, k, s);
  if (a_t) return launch_mm<TA, TB, true, false>(a, b, c, g, m, n, k, s);
  if (b_t) return launch_mm<TA, TB, false, true>(a, b, c, g, m, n, k, s);
  return launch_mm<TA, TB, false, false>(a, b, c, g, m, n, k, s);
}

}  // namespace

// c [G,M,N] fp32 = a [G,M,K] @ b [G,K,N].  a_bf16 / b_bf16: the operand is
// bf16 (else fp32).  a_t: a is stored as a row-major [G,K,M] array (the
// product reads its transpose); b_t: b is stored as a row-major [G,N,K]
// array.  Any M, N, K >= 0; K == 0 writes zeros.
extern "C" int grouped_matmul(const void* a, const void* b, void* c, int g,
                              int m, int n, int k, int a_bf16, int b_bf16,
                              int a_t, int b_t, void* stream) {
  if (g < 0 || m < 0 || n < 0 || k < 0 || g > 65535 ||
      (m + GM - 1) / GM > 65535)
    return (int)cudaErrorInvalidValue;
  if (g == 0 || m == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  float* out = (float*)c;
  cudaError_t err;
  if (a_bf16 && b_bf16)
    err = launch_mm_t<bf16, bf16>(a, b, out, g, m, n, k, a_t, b_t, s);
  else if (a_bf16)
    err = launch_mm_t<bf16, float>(a, b, out, g, m, n, k, a_t, b_t, s);
  else if (b_bf16)
    err = launch_mm_t<float, bf16>(a, b, out, g, m, n, k, a_t, b_t, s);
  else
    err = launch_mm_t<float, float>(a, b, out, g, m, n, k, a_t, b_t, s);
  return (int)err;
}
