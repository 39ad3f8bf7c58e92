// Oct-walk nearest-hit intersector for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_hbm_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py:390 (called by
// `nearest_hit_cluster_hbm`, :1473): the JAX package's v2 big-scene
// kernel, its auto rule's fallback for a big scene without blocked
// tables. The TPU kernel keeps `tri_const` in HBM and runs a packet queue
// over OCTS of `oct_branch` consecutive clusters (8, or 16/32 after
// `with_oct_branch`), two octs a loop turn over a 4-slot DMA ring. It reads each cluster's box
// from row 15, lanes 0-5, of the cluster's own tile; there is no validity
// row, so a pad cluster's inverted +-3e38 box passes the slab test and its
// all-zero tile rejects every slot (ddn == 0).
//
// Contract (the TPU kernel's output, not its packet schedule):
//   oct_t   (8, stride) f32 component-major oct boxes (oct_bbox_t): rows
//           0-5 min/max xyz, row 6 validity, octs [0, num_octs)
//   tri     (num_octs * oct_branch, 16, 128) f32 cluster tiles
//   rays    (R, 8) f32, columns [ox oy oz dx dy dz active t_max]
//   out_t   (R,) f32: the best t, or t_max when no triangle beat it
//   out_id  (R,) i32: the winning id c*128 + lane, or 2^31-1
//   stats   (R, 2) i32 or null: per ray, octs visited and clusters
//           intersected (the counterpart of stats=True, per ray instead of
//           per packet)
// The running best starts at (t_max, 2^31-1) and follows `accept`
// (intersect_common.cuh): nearest t, ties to the lowest id; the result is
// the queue kernel's on the same clusters.
//
// What bounds it on the H100: the latency of the tiles it reads, as the
// blocked kernel. A thread-per-ray walk that rescans all 1,952 oct boxes
// of the hero (oct_branch 8) in one thread at each of a ray's ~15 steps
// runs some 29,000 slab tests a ray, which then set the time. The design (`walk` of
// group_walk.cuh): one warp per ray. The warp computes the ray's oct
// entries once, 61 boxes a lane from coalesced loads of the (8, num_octs)
// table, and compacts the pierced octs' (entry, index) keys into its
// slice of shared memory (8 bytes an oct, 15.6 KB a warp on the hero,
// which bounds an SM at 7 blocks of 2 warps); a
// step is a warp argmin over the pierced octs only. Lanes 0..oct_branch-1
// cull an oct's clusters from their row-15 boxes; the pierced clusters
// are tested front to back, 4 slots a lane, with one `accept` of the
// warp's least (t, id). A cluster whose row-15 box is inverted (min x >
// max x) holds no triangle: it is skipped, neither intersected nor counted
// in `stats`, where the TPU kernel intersects its zero tile.

#include "group_walk.cuh"

namespace {

using namespace isaklm;

// Octs of `oct_branch` consecutive clusters of `tri`.
struct OctLayout {
  const float* tri;
  int oct_branch;

  struct Group {
    const float* tiles;  // the oct's first cluster tile
    int base;            // id of lane 0 of that cluster

    __device__ __forceinline__ bool entry(int k, const Ray& r, float t_eps,
                                          float& e) const {
      const float* box = tiles + (int64_t)k * kTile + 15 * kWidth;
      const float x0 = __ldg(box), x1 = __ldg(box + 3);
      if (!(x0 <= x1)) return false;  // a pad cluster's inverted box
      return slab(x0, __ldg(box + 1), __ldg(box + 2), x1, __ldg(box + 4), __ldg(box + 5),
                  r, t_eps, e);
    }

    __device__ __forceinline__ void intersect(int k, const Ray& r, float t_eps,
                                              float& best_t, int& best_id) const {
      warp_intersect_tile(tiles + (int64_t)k * kTile, base + k * kWidth, r, t_eps, best_t,
                          best_id);
    }
  };

  __device__ __forceinline__ int size() const { return oct_branch; }

  __device__ __forceinline__ Group group(int o) const {
    return Group{tri + (int64_t)o * oct_branch * kTile, o * oct_branch * kWidth};
  }
};

__global__ void __launch_bounds__(kWalkThreads)
hbm_intersect_kernel(const float* __restrict__ oct_t, int stride, int num_octs,
                     const float* __restrict__ tri, int oct_branch,
                     const float* __restrict__ rays, int num_rays, float t_eps,
                     float* __restrict__ out_t, int* __restrict__ out_id,
                     int* __restrict__ stats) {
  walk(OctLayout{tri, oct_branch}, oct_t, stride, num_octs, rays, num_rays, t_eps, out_t,
       out_id, stats);
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise. `stats` may
// be null. oct_branch must be in [1, 128].
extern "C" int hbm_intersect(int device, const float* oct_t, int stride, int num_octs,
                             const float* tri, int oct_branch, const float* rays,
                             int num_rays, float t_eps, float* out_t, int* out_id,
                             int* stats, void* stream) {
  return launch_walk(hbm_intersect_kernel, device, num_octs, num_rays, stream, oct_t,
                     stride, num_octs, tri, oct_branch, rays, num_rays, t_eps, out_t,
                     out_id, stats);
}
