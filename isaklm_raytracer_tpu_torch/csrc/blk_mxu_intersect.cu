// Blocked nearest-hit intersector over the MXU block layout, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `_blk_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py:592 with mxu=True (its `mxu`
// branches, intersect.py:643-665 and 801-806; called by
// `nearest_hit_cluster_blk(mxu=True)`, :1354). The TPU kernel walks the
// same blocks as the blocked kernel, but each cluster is a pair of tiles, W1
// (n, e1) and W2 (e2, plane and Cramer constants), so that the six
// ray/triangle dot products run as (2B, 8) @ (8, 128) matmuls on the MXU.
//
// Contract: as blk_intersect.cu, with
//   mxu     (NB, 2 * branch + 1, 16, 128) f32: per block the header tile,
//           then W1 and W2 of cluster k at tiles 1 + 2k and 2 + 2k
//           (accel/cluster.py `_build_blocks_np(..., mxu=True)`)
// and ids (blk*branch + k)*128 + lane. It returns the blocked kernel's
// bits on the same clusters.
//
// What bounds it on the H100: as the blocked kernel (the latency of the
// tiles it reads from L2 and device memory), with twice the table, 245 MB
// at the hero's 122 blocks of 128 clusters, of which the walk reads 15 of
// the 32 rows of a pair. The design: the blocked kernel's warp-per-ray walk
// (`walk` of group_walk.cuh) over `BlockLayout<2>`, with no design of its
// own; each cluster's dot products are the IEEE f32 sums of `tri_hit` read
// from the pair's rows 4 slots a lane (`warp_intersect_tile_mxu`), with no
// tensor-core product, so the result equals the blocked kernel's bit for
// bit.

#include "group_walk.cuh"

namespace {

using namespace isaklm;

__global__ void __launch_bounds__(kWalkThreads, kBlockWalkMinBlocks)
blk_mxu_intersect_kernel(const float* __restrict__ bbox_t, int stride,
                         int num_blocks, const float* __restrict__ mxu, int branch,
                         const float* __restrict__ rays, int num_rays, float t_eps,
                         float* __restrict__ out_t, int* __restrict__ out_id,
                         int* __restrict__ stats) {
  walk(BlockLayout<2>{mxu, branch}, bbox_t, stride, num_blocks, rays, num_rays, t_eps, out_t,
       out_id, stats);
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise. `stats` may
// be null.
extern "C" int blk_mxu_intersect(int device, const float* bbox_t, int stride,
                                 int num_blocks, const float* mxu, int branch,
                                 const float* rays, int num_rays, float t_eps,
                                 float* out_t, int* out_id, int* stats, void* stream) {
  return launch_walk(blk_mxu_intersect_kernel, device, num_blocks, num_rays, stream,
                     bbox_t, stride, num_blocks, mxu, branch, rays, num_rays, t_eps, out_t,
                     out_id, stats);
}
