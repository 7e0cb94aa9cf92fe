// The two tensor-core forms that the chunked backwards (ssd_bwd.cu,
// rwkv6_bwd.cu) could multiply with, side by side, at their gradient
// kernels' shapes.  It replaces no TPU kernel and no port's kernel calls it:
// chip_smoke.py phase 1r times it beside ssd_scan_bwd, the yardstick for
// the backwards' choice of mma.sync over wgmma.
//
// A block of 128 threads (4 warps, one warpgroup) holds a 64 x 64 fp32 A as
// the bf16 hi / lo pair of its fragments in registers (warp w: rows 16 w ..
// 16 w + 15) and a 64 x 64 bf16 B [k][n] in shared memory, and `reps`
// times forms the product A B as the gradient kernels do, into fp32
// accumulators zeroed for each product and summed into a total:
// - form 0, mma.sync m16n8k16 (warp_mma.cuh): B's fragments by ldmatrix
//   .trans from 144-byte rows, every column tile;
// - form 1, the same over the causal half, in pairs of turns: warp w takes
//   the column tiles jj <= w (rows t against s <= t), then jj >= w (rows s
//   against t >= s), as ssd_bwd_grad_kernel's two orientations do, 10 of
//   the 16 (k, column) tiles of a product on average; the bounds are tested
//   at run time against the warp's index, as in that kernel;
// - form 2, wgmma m64n64k16 with A from registers (hopper.cuh's wgmma_rs),
//   B from the 128-byte swizzled copy, the whole product: a warpgroup's
//   wgmma covers all 64 rows, so nothing causal is skipped;
// - form 3, form 1 with each warp's bounds known when it is compiled (a
//   switch on the warp around the loop).
// Dynamic shared memory of kSmem bytes a block keeps two blocks on an SM,
// as ssd_bwd_grad_kernel's ~105 KB does.  Block 0 writes its total
// (rows [64][64] fp32) to `out`, so that the forms can be checked against
// one another and a plain product.
#include "warp_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSmem = 100 * 1024;     // two blocks an SM
constexpr int kPadBytes = 64 * kRow * 2;

// one product over the column tiles [lo, hi] of this warp's rows, added
// to tot
__device__ __forceinline__ void product(float (&tot)[8][4], const bf16* pad,
                                        const uint32_t (&ah)[4][4],
                                        const uint32_t (&al)[4][4], int lo,
                                        int hi) {
  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (jj >= lo && jj <= hi) {
        uint32_t bf[4];
        ldb_t(bf, pad, 16 * jj, 16 * kk);
        mma2(acc, jj, ah[kk], bf);
        mma2(acc, jj, al[kk], bf);
      }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) tot[j][r] += acc[j][r];
}

// form 3's loop for warp W: both turns' bounds constants
template <int W>
__device__ __forceinline__ void causal_turns(float (&tot)[8][4],
                                             const bf16* pad,
                                             const uint32_t (&ah)[4][4],
                                             const uint32_t (&al)[4][4],
                                             int reps) {
  for (int it = 0; it < reps; it += 2) {
    product(tot, pad, ah, al, 0, W);
    product(tot, pad, ah, al, W, 3);
  }
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, 2)
mma_forms_kernel(const float* __restrict__ a, const bf16* __restrict__ b,
                 float* __restrict__ out, int reps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* pad = reinterpret_cast<bf16*>(smem_raw);            // [k][n], kRow
  unsigned char* sw = smem_raw + kPadBytes;                 // swizzled [k][n]
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads) {
    const int k = i >> 3, c = i & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(b + k * 64 + c * 8);
    *reinterpret_cast<uint4*>(pad + k * kRow + c * 8) = v;
    *reinterpret_cast<uint4*>(sw + k * 128 + ((c ^ (k & 7)) << 4)) = v;
  }
  // A's fragments of the four k16 steps as bf16 pairs: register r of step
  // kk is (row 16 w + g + 8 (r & 1), columns 16 kk + 2 q + 8 (r >> 1), +1)
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* p = a + (16 * warp + g + 8 * (r & 1)) * 64 + 16 * kk +
                       2 * q + 8 * (r >> 1);
      split2(p[0], p[1], ah[kk][r], al[kk][r]);
    }
  fence_proxy_async();     // the swizzled copy is seen by wgmma
  __syncthreads();
  float tot[8][4];
  zero(tot);
  if constexpr (kForm == 0) {
    for (int it = 0; it < reps; ++it) product(tot, pad, ah, al, 0, 3);
  } else if constexpr (kForm == 1) {
    for (int it = 0; it < reps; it += 2) {
      product(tot, pad, ah, al, 0, warp);
      product(tot, pad, ah, al, warp, 3);
    }
  } else if constexpr (kForm == 2) {
    for (int it = 0; it < reps; ++it) {
      float d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(smem_u32(sw) + kk * 2048, 8192, 1024);
        wgmma_rs(d, ah[kk], db);
        wgmma_rs(d, al[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) tot[j][r] += d[4 * j + r];
    }
  } else {
    switch (warp) {
      case 0: causal_turns<0>(tot, pad, ah, al, reps); break;
      case 1: causal_turns<1>(tot, pad, ah, al, reps); break;
      case 2: causal_turns<2>(tot, pad, ah, al, reps); break;
      default: causal_turns<3>(tot, pad, ah, al, reps); break;
    }
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            out + (16 * warp + g + 8 * half) * 64 + 8 * j + 2 * q) =
            make_float2(tot[j][2 * half], tot[j][2 * half + 1]);
  }
}

template <int kForm>
cudaError_t launch(const float* a, const bf16* b, float* out, int blocks,
                   int reps, cudaStream_t s) {
  static const cudaError_t attr = allow_smem(mma_forms_kernel<kForm>, kSmem);
  if (attr != cudaSuccess) return attr;
  mma_forms_kernel<kForm><<<blocks, kThreads, kSmem, s>>>(a, b, out, reps);
  return cudaGetLastError();
}

}  // namespace

// a: fp32 [64, 64]; b: bf16 [64, 64] ([k][n]), 16-byte aligned; out: fp32
// [64, 64], block 0's total over `reps` products (forms 1 and 3: over the
// tiles each turn reaches; reps even); form 0-3 as above; blocks blocks.
// Returns cudaGetLastError().
extern "C" int mma_forms(const void* a, const void* b, void* out, int form,
                         int blocks, int reps, void* stream) {
  if (blocks <= 0 || reps < 0 || reps % 2) return (int)cudaErrorInvalidValue;
  const float* af = (const float*)a;
  const bf16* bb = (const bf16*)b;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case 0: return (int)launch<0>(af, bb, o, blocks, reps, s);
    case 1: return (int)launch<1>(af, bb, o, blocks, reps, s);
    case 2: return (int)launch<2>(af, bb, o, blocks, reps, s);
    case 3: return (int)launch<3>(af, bb, o, blocks, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
