// Null intersector for Hopper (sm_90a): the fixed cost of a launch.
//
// Replaces the two Pallas probe kernels of scripts/fixed_cost_probe.py:
// `null_kernel` (:99, called by `null_call`, :104), which has the blocked
// kernel's grid, specs and VMEM scratch and writes zeros to its outputs,
// and the lambda of `null_small` (:143, :138), the same without the
// scratch. Together with the full call they split the blocked path's cost
// per packet into launch, scratch, ray preparation and traversal.
//
// Contract: out_t (R,) f32 and out_id (R,) i32 set to zero, in the launch
// shape of the group walks (group_walk.cuh: blocks of kWalkThreads
// threads, one warp per ray) with the walk's dynamic shared memory for
// `shared_groups` groups, which it never touches: the blocked kernel's
// block count for the counterpart of `null_kernel`, 0 for that of
// `null_small`.
//
// What bounds it on the H100: at the probe's 65,536 rays it writes 512 KB,
// 0.16 us at the HBM rate, far below a launch's few microseconds; the
// launch itself is what it measures. The design is the least kernel that
// keeps the walk's shape: one store per output, by lane 0 of each warp.

#include "group_walk.cuh"

namespace {

using namespace isaklm;

__global__ void __launch_bounds__(kWalkThreads)
null_intersect_kernel(int num_rays, float* __restrict__ out_t, int* __restrict__ out_id) {
  extern __shared__ unsigned long long scratch[];  // reserved, as the walk's lists
  const int r = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (r >= num_rays || (threadIdx.x & 31) != 0) return;
  out_t[r] = 0.0f;
  out_id[r] = 0;
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int null_intersect(int device, int num_rays, int shared_groups, float* out_t,
                              int* out_id, void* stream) {
  return launch_walk(null_intersect_kernel, device, shared_groups, num_rays, stream,
                     num_rays, out_t, out_id);
}
