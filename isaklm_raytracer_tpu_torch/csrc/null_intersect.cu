// Null intersector for Hopper (sm_90a): the fixed cost of a launch.
//
// Replaces the two Pallas probe kernels of scripts/fixed_cost_probe.py:
// `null_kernel` (:99, called by `null_call`, :104), which has the blocked
// kernel's grid, specs and VMEM scratch and writes zeros to its outputs,
// and the lambda of `null_small` (:143, :138), the same without the
// scratch. Together with the full call they split the blocked path's cost
// per packet into launch, scratch, ray preparation and traversal.
//
// Contract: out_t (R,) f32 and out_id (R,) i32 set to zero, in the
// blocked kernel's launch shape (blocks of 128 threads, one per ray) with
// `shared_floats` floats of dynamic shared memory that it never touches:
// the blocked kernel's 7 * NB for the counterpart of `null_kernel`, 0 for
// that of `null_small`.
//
// What bounds it on the H100: at the probe's 65,536 rays it writes 512 KB,
// 0.16 us at the HBM rate, far below a launch's few microseconds; the
// launch itself is what it measures. The design is the least kernel that
// keeps the blocked kernel's shape: one store per output and thread.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // the blocked kernel's rays per block

__global__ void __launch_bounds__(kThreads)
null_intersect_kernel(int num_rays, float* __restrict__ out_t, int* __restrict__ out_id) {
  extern __shared__ float scratch[];  // reserved, as the probe's VMEM scratch
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= num_rays) return;
  out_t[r] = 0.0f;
  out_id[r] = 0;
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int null_intersect(int device, int num_rays, int shared_floats, float* out_t,
                              int* out_id, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * (size_t)shared_floats;
  err = cudaFuncSetAttribute(null_intersect_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    null_intersect_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        num_rays, out_t, out_id);
  }
  return static_cast<int>(cudaGetLastError());
}
