// Brute-force nearest hit for Hopper (sm_90a): every ray against every
// triangle, one thread a ray.
//
// Replaces no Pallas kernel. It computes `nearest_hit_brute`
// (isaklm_raytracer_tpu/accel/traverse.py:73) with its contract, for a
// scene without acceleration tables (the CLI's --no-kd): the test of
// tri_test.cuh (the unit normal, the plane distance, Cramer's
// barycentrics, ddn != 0, s >= t_eps), the lowest triangle id on ties, and
// (+inf, -1) for a miss and for an inactive ray. t_max is ignored, as in
// the JAX function. It equals the plain function
// (accel/traverse.py nearest_hit_brute) bit for bit.
//
// What bounds it on the H100: issue slots, one triangle test a (ray,
// triangle) pair; the triangles are read once a block. The design: each
// block of kBruteThreads rays stages the scene kBruteTile triangles at a
// time in shared memory, each thread forming one triangle's constants
// (make_tri: the normal and the Cramer terms, once a block instead of once
// a pair); every thread then tests its ray against the tile in id order,
// the threads of a warp reading the same constants (a broadcast). A
// strictly nearer candidate replaces the best, so the lowest id wins ties.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_test.cuh"

namespace {

using namespace isaklm;

constexpr int kBruteThreads = 128;  // rays a block
constexpr int kBruteTile = 128;     // triangles staged at a time, one a thread

__global__ void __launch_bounds__(kBruteThreads)
brute_intersect_kernel(const float* __restrict__ vertices, int num_tris,
                       const float* __restrict__ rays, int num_rays, float t_eps,
                       float* __restrict__ out_t, int* __restrict__ out_id) {
  __shared__ TriConsts tile[kBruteTile];
  const int r = blockIdx.x * kBruteThreads + threadIdx.x;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  bool active = false;
  if (r < num_rays) {
    const float4* row = reinterpret_cast<const float4*>(rays + 8 * static_cast<int64_t>(r));
    const float4 a = row[0], b = row[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z;
    d[0] = a.w; d[1] = b.x; d[2] = b.y;
    active = b.z > 0.0f;
  }
  float best_t = INFINITY;
  int best_i = -1;
  for (int base = 0; base < num_tris; base += kBruteTile) {
    const int i = base + threadIdx.x;
    __syncthreads();  // the previous tile is no longer read
    if (i < num_tris) {
      const float* p = vertices + 9 * static_cast<int64_t>(i);
      const float p1x = __ldg(p), p1y = __ldg(p + 1), p1z = __ldg(p + 2);
      tile[threadIdx.x] = make_tri(p1x, p1y, p1z, __ldg(p + 3) - p1x, __ldg(p + 4) - p1y,
                                   __ldg(p + 5) - p1z, __ldg(p + 6) - p1x,
                                   __ldg(p + 7) - p1y, __ldg(p + 8) - p1z);
    }
    __syncthreads();
    if (active) {
      const int count = min(kBruteTile, num_tris - base);
      for (int k = 0; k < count; ++k) {
        const float s = tri_t(tile[k], o[0], o[1], o[2], d[0], d[1], d[2], t_eps);
        if (s < best_t) {
          best_t = s;
          best_i = base + k;
        }
      }
    }
  }
  if (r < num_rays) {
    out_t[r] = best_t;
    out_id[r] = best_i;
  }
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int brute_intersect(int device, const float* vertices, int num_tris,
                               const float* rays, int num_rays, float t_eps, float* out_t,
                               int* out_id, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const dim3 grid((num_rays + kBruteThreads - 1) / kBruteThreads);
    brute_intersect_kernel<<<grid, kBruteThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        vertices, num_tris, rays, num_rays, t_eps, out_t, out_id);
  }
  return static_cast<int>(cudaGetLastError());
}
