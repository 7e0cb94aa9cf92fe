// PTX helpers for Hopper (sm_90a) shared by the kernels that load tiles with
// TMA into mbarrier rings and multiply them with wgmma
// (grouped_matmul.cu, flash_attention.cu, moe_ffn.cu, ssd.cu), the bf16 hi /
// lo pair of an fp32 operand (split2: the recurrences' forwards and, through
// warp_mma.cuh, their backwards), and the bf16 ring
// mainloop that grouped_matmul.cu's bf16 path and moe_ffn.cu's two GEMMs
// share.  Each kernel source includes this header and builds into its own
// library; kernels/_build.py hashes every csrc/*.cuh into each library's
// build key, so an edit here rebuilds them all.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that never
// ends (a broken pipeline) traps, failing the launch, instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// box at (c0 innermost, c1, c2) of a 3-D tensor map into shared memory,
// completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the same for a 4-D tensor map, box at (c0 innermost, c1, c2, c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared memory into the box at (c0, c1, c2, c3) of a 4-D tensor map; the
// elements out of the map's bounds are not written.  Tracked by the
// issuing thread's bulk groups (tma_store_commit / tma_store_wait_read).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// the same for a 3-D tensor map, box at (c0, c1, c2)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until the issuing thread's stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// until the issuing thread's stores are complete
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// generic-proxy writes to shared memory become visible to TMA and wgmma
// (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
// K-major: rows of 128 bytes along K, 8-row groups `sbo` apart (lbo unused).
// M/N-major: rows of 128 bytes (64 bf16) along M or N, 8-row groups along K
// `sbo` apart, 64-wide blocks along M or N `lbo` apart.  The hardware XORs
// address bits [4, 7) with [7, 10), so tiles sit on 1024-byte boundaries
// and a K step inside a 128-byte row just moves the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// two floats -> two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 pair of (a, b): hi = bf16(v), lo = bf16(v - hi), packed two
// values a register (a in the low half)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(a - __low2float(h2), b - __high2float(h2));
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void consumer_bar(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
}

// keep the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes across the issue or the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// operand lists of the accumulator registers d[0 .. N) of one wgmma
#define R8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define REGS64 REGS32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define REGS128 REGS64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

// d[64 x 128] (+)= a[64 x 16] . b[16 x 128], bf16, both in shared memory; TA
// / TB: a M-major, b N-major (the transpose bits); accumulate 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}
// the same at n64: d[64 x 64]
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 128] += a[64 x 16] (registers: the A fragment) . b[16 x 128]
// (N-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// the same at n64: d[64 x 64]
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special function unit (flushes subnormals to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d[64 x 256] += a[64 x 16] . b[16 x 256], bf16, both in shared memory; TA /
// TB: a M-major, b N-major (the transpose bits)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" REGS128
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56),
        R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ---------------------------------------------------------------------------
// the bf16 ring: 128 x 256 output tiles, two consumer warpgroups of 64 rows
// each, stages of 64 k (a: 128 rows, b: 256 columns) that land from TMA with
// the 128-byte swizzle, full / empty mbarriers a stage
// ---------------------------------------------------------------------------

constexpr int kRingK = 64;                       // k a stage
constexpr int kRingA = 128 * kRingK * 2;         // 16 KB of a
constexpr int kRingB = 256 * kRingK * 2;         // 32 KB of b
constexpr int kRingStage = kRingA + kRingB;

// producer: the stage of k step i (counted over all of the block's tiles),
// once the consumers have freed it, armed for a full stage's bytes (the TMA
// counts a box's zero-filled elements too)
template <int STAGES>
__device__ __forceinline__ int ring_acquire(uint64_t* full, uint64_t* empty,
                                            int i) {
  const int s = i % STAGES;
  if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
  mbar_expect_tx(&full[s], kRingStage);
  return s;
}

// consumer: the nk k steps of one tile into d, this warpgroup's 64 rows of
// a (the second half of a K-major a tile, or the second 64-wide M block of
// an M-major one) against all 256 columns of b.  A_MN: a stored M-major;
// B_MN: b stored N-major (four 64-wide column blocks).  Each step's
// products overlap the next step's wait; a stage is freed (one arrive a
// warp) once the products that read it are done.  i: k steps consumed so
// far.
template <bool A_MN, bool B_MN, int STAGES>
__device__ __forceinline__ void ring_consume(float (&d)[128],
                                             const uint8_t* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int& i, int nk, int wg,
                                             bool leader) {
  for (int kb = 0; kb < nk; ++kb, ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t a = smem_u32(ring + s * kRingStage) + wg * (kRingA / 2);
    const uint32_t b = smem_u32(ring + s * kRingStage + kRingA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRingK / 16; ++kk) {
      // 16 k: 32 bytes along a K-major row, or 16 rows of an M/N-major one
      const uint64_t da = A_MN ? sw128_desc(a + kk * 2048, kRingA / 2, 1024)
                               : sw128_desc(a + kk * 32, 16, 1024);
      const uint64_t db = B_MN ? sw128_desc(b + kk * 2048, kRingB / 4, 1024)
                               : sw128_desc(b + kk * 32, 16, 1024);
      wgmma_bf16_n256<A_MN, B_MN>(d, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous step's products are done
    fence_regs(d);
    if (kb > 0 && leader) mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(d);
  if (nk > 0 && leader) mbar_arrive(&empty[(i - 1) % STAGES]);
}

// consumer, a tile whose rows of this warpgroup are known to be empty: wait
// for each of its nk stages and free it without multiplying (the wait
// makes the arrivals count toward the fill they belong to)
template <int STAGES>
__device__ __forceinline__ void ring_release(uint64_t* full, uint64_t* empty,
                                             int& i, int nk, bool leader) {
  for (int kb = 0; kb < nk; ++kb, ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    __syncwarp();
    if (leader) mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------------------------
// host: the tensor-map encoder, the SM count
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; these libraries link only the
// runtime, which hands out the driver's entry point
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// streaming multiprocessors of the current device (1 if the query fails)
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// 3-D map over a row-major [g, outer, inner] array, box {box0, box1, 1},
// bf16 or fp32; out-of-bounds elements load as 0 and are not stored
bool encode_3d(CUtensorMap* map, const void* ptr, bool is_bf16, int inner,
               int outer, int g, int box0, int box1, bool swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)g};
  const cuuint64_t strides[2] = {inner * es, (cuuint64_t)inner * outer * es};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// one block an SM (each takes all of its shared memory), at most one a tile
int persistent_grid(long long tiles) {
  const int sms = sm_count();
  return (int)(tiles < sms ? tiles : sms);
}

}  // namespace
