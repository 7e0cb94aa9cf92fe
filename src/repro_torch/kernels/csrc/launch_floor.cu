// The launch floor: an empty kernel, one block of 32 threads, no memory
// traffic.  It replaces no TPU kernel.  chip_smoke.py times it the way it
// times every kernel (CUDA events around many launches, and
// torch.profiler's kernel time) and judges each kernel against the larger
// of its bound and this floor: no launch on the card takes less.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
