// Queue nearest-hit intersector for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_vmem_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py:349 (called by
// `nearest_hit_cluster`, :1198): mid-size scenes whose cluster table fits
// the JAX package's 6 MB budget (65 to 768 clusters of 128 triangles). The
// TPU kernel culls every cluster box for a 256-ray packet in one dense
// pass, then pops clusters from an extract-min queue until the next entry
// lies beyond the packet's tmax.
//
// Contract (the TPU kernel's output, not its packet schedule):
//   box_t   (8, stride) f32 component-major cluster boxes (clu_bbox_t):
//           rows 0-5 min/max xyz, row 6 validity, clusters [0, C)
//   tri     (C, 16, 128) f32 cluster tiles (accel/cluster.py layout)
//   rays    (R, 8) f32, columns [ox oy oz dx dy dz active t_max]
//   out_t   (R,) f32: the best t, or t_max when no triangle beat it
//   out_id  (R,) i32: the winning id c*128 + lane, or 2^31-1
//   stats   (R, 2) i32 or null: per ray, clusters visited and clusters
//           intersected (equal: each visit is one cluster)
// The running best starts at (t_max, 2^31-1) and follows `accept`
// (intersect_common.cuh): nearest t, ties to the lowest id.
//
// What bounds it on the H100: a ray's walk is serial and data dependent,
// so latency and the warp's share of the work, not bytes or flops. A
// 768-cluster table is 6 MB and stays in the 50 MB L2. A thread-per-ray
// walk that rescans every cluster box at each step (some 700 slab tests a
// step, about 15 steps a ray at 704 clusters) in one thread, with the
// warp waiting on its longest walk, runs at some 37x its bound. The design
// (`walk` of group_walk.cuh, groups of one cluster, the group table being
// `clu_bbox_t` itself): one warp per ray. The warp computes the ray's
// cluster entries once, 22 boxes a lane from coalesced loads at 704
// clusters, and compacts the pierced valid clusters' (entry, index) keys
// into its slice of shared memory (8 bytes a cluster, 6 KB a warp at
// 768); a step is a warp argmin over those keys, and the cluster it picks
// is tested 4 slots a lane with one `accept` of the warp's least (t, id).
// A group of one cluster needs no second slab test: its entry is the key's.

#include "group_walk.cuh"

namespace {

using namespace isaklm;

// Groups of one cluster: cluster c's tile is tri + c * kTile.
struct ClusterLayout {
  static constexpr bool kOneCluster = true;
  const float* tri;

  struct Group {
    const float* tile;
    int base;  // id of lane 0

    __device__ __forceinline__ void intersect(int, const Ray& r, float t_eps, float& best_t,
                                              int& best_id) const {
      warp_intersect_tile(tile, base, r, t_eps, best_t, best_id);
    }
  };

  __device__ __forceinline__ int size() const { return 1; }

  __device__ __forceinline__ Group group(int c) const {
    return Group{tri + (int64_t)c * kTile, c * kWidth};
  }
};

__global__ void __launch_bounds__(kWalkThreads, kBlockWalkMinBlocks)
queue_intersect_kernel(const float* __restrict__ box_t, int stride, int num_clusters,
                       const float* __restrict__ tri, const float* __restrict__ rays,
                       int num_rays, float t_eps, float* __restrict__ out_t,
                       int* __restrict__ out_id, int* __restrict__ stats) {
  walk(ClusterLayout{tri}, box_t, stride, num_clusters, rays, num_rays, t_eps, out_t, out_id,
       stats);
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise. `stats` may
// be null.
extern "C" int queue_intersect(int device, const float* box_t, int stride, int num_clusters,
                               const float* tri, const float* rays, int num_rays, float t_eps,
                               float* out_t, int* out_id, int* stats, void* stream) {
  return launch_walk(queue_intersect_kernel, device, num_clusters, num_rays, stream, box_t,
                     stride, num_clusters, tri, rays, num_rays, t_eps, out_t, out_id, stats);
}
