// Flat nearest-hit intersector for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flat_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py:521 (called by
// `nearest_hit_cluster_flat`, :1250): every ray against every triangle of
// the scene's real clusters, for scenes of at most 64 clusters of 128
// triangles.
//
// Contract: `flat_kernel` of flat_walk.cuh over
//   tri     (C, 16, 128) f32 cluster tiles (accel/cluster.py layout); the
//           kernel reads rows 0-14 of the first `num_clusters` tiles.
// What bounds it on the H100, the design (a staged test of each slot, one
// thread a ray, one cluster staged in shared memory at a time) and why the
// stages change no result: flat_walk.cuh.

#include "flat_walk.cuh"

namespace {

using namespace isaklm;

// Cluster tiles: constant k of cluster c is row k of tile c.
struct TileLayout {
  static constexpr int kClusterFloats = kTile;
  __host__ __device__ static constexpr int row(int k) { return k; }
};

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int flat_intersect(int device, const float* tri, int num_clusters,
                              const float* rays, int num_rays, float t_eps,
                              float* out_t, int* out_id, void* stream) {
  return launch_flat<TileLayout>(device, tri, num_clusters, rays, num_rays, t_eps, out_t,
                                 out_id, stream);
}
