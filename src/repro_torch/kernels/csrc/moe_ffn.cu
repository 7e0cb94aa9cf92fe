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
// (The backward's grouped GEMM is csrc/grouped_matmul.cu.)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

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
