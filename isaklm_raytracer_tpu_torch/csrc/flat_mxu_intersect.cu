// Flat nearest-hit intersector over MXU tile pairs, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flat_mxu_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py:557 (with
// `_make_intersect_mxu`, :259; called by `nearest_hit_cluster_flat_mxu`,
// :1303): every ray against every triangle of the real clusters of a scene
// of at most 64 clusters, each cluster a pair of tiles so that the TPU
// kernel's six ray/triangle dot products run as (2B, 8) @ (8, 128)
// matmuls on the MXU.
//
// Contract (the flat kernel's, over the MXU layout):
//   tiles   (C, 2, 16, 128) f32 (accel/cluster.py `with_mxu_tiles`): W1
//           holds n in rows 0-2 and e1 in rows 8-10, W2 holds e2 in rows
//           0-2 and np1 p1e1 p1e2 ca cb cc in rows 8-13; the kernel reads
//           the first `num_clusters` pairs
//   rays    (R, 8) f32, columns [ox oy oz dx dy dz active t_max]
//   out_t   (R,) f32: the best t, or t_max when no triangle beat it
//   out_id  (R,) i32: the winning id c*128 + lane, or 2^31-1 (no winner)
// The running best starts at (t_max, 2^31-1) and follows `accept`
// (intersect_common.cuh). Each dot product is the IEEE f32 sum of
// `tri_hit` (no tensor-core product), so the result equals the flat
// kernel's bit for bit.
//
// What bounds it on the H100: as the flat kernel, about 56 operations per
// ray per triangle slot and little memory traffic (the demo's six pairs
// are 96 KB, of which the test reads 15 rows of 32), so compute. The
// design, simple first: one thread per ray, walking the pairs in id order
// and reading each slot's 15 constants straight from the pair's rows
// (`intersect_tile_mxu`); every thread of a warp reads the same address,
// which L1 serves as one broadcast. Inactive rays skip the walk.

#include "intersect_common.cuh"

namespace {

using namespace isaklm;

constexpr int kThreads = 128;  // rays per block

__global__ void __launch_bounds__(kThreads)
flat_mxu_intersect_kernel(const float* __restrict__ tiles, int num_clusters,
                          const float* __restrict__ rays, int num_rays, float t_eps,
                          float* __restrict__ out_t, int* __restrict__ out_id) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= num_rays) return;
  const Ray ray = load_ray(rays, r);
  float best_t = ray.t_max;
  int best_id = kBigId;
  if (ray.active) {
    for (int c = 0; c < num_clusters; ++c) {
      const float* w1 = tiles + (int64_t)c * 2 * kTile;
      intersect_tile_mxu(w1, w1 + kTile, c * kWidth, ray, t_eps, best_t, best_id);
    }
  }
  out_t[r] = best_t;
  out_id[r] = best_id;
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int flat_mxu_intersect(int device, const float* tiles, int num_clusters,
                                  const float* rays, int num_rays, float t_eps,
                                  float* out_t, int* out_id, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    flat_mxu_intersect_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tiles, num_clusters, rays, num_rays, t_eps, out_t, out_id);
  }
  return static_cast<int>(cudaGetLastError());
}
