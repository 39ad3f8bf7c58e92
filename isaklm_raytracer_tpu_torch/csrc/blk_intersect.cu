// Blocked nearest-hit intersector for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_blk_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py:592 (called by
// `nearest_hit_cluster_blk`, :1354): scenes whose cluster table exceeds
// the queue kernel's budget, such as the 2M-triangle hero scene. The TPU
// kernel keeps the blocked table in HBM and runs a packet queue over DMA
// blocks of `branch` clusters. Each block is a header tile of component-major
// cluster boxes followed by the block's cluster tiles
// (accel/cluster.py `_build_blocks_np`); a landed block's clusters are
// culled against the rays and the pierced ones intersected. Its per_ray
// and pipeline_depth settings shape only which blocks a packet visits and
// its DMA ring, not the nearest hit: this one kernel is the counterpart
// of both modes.
//
// Contract (the TPU kernel's output, not its packet schedule):
//   bbox_t  (8, stride) f32 component-major block boxes (blk_bbox_t):
//           rows 0-5 min/max xyz, row 6 validity, blocks [0, NB)
//   blk     (NB, branch + 1, 16, 128) f32: per block the header tile
//           (rows 0-5 cluster boxes along lanes, row 6 validity) and the
//           block's cluster tiles
//   rays    (R, 8) f32, columns [ox oy oz dx dy dz active t_max]
//   out_t   (R,) f32: the best t, or t_max when no triangle beat it
//   out_id  (R,) i32: the winning id (blk*branch + k)*128 + lane, or 2^31-1
//   stats   (R, 2) i32 or null: per ray, blocks visited and clusters
//           intersected (the counterpart of stats=True, per ray instead of
//           per packet)
// The running best starts at (t_max, 2^31-1) and follows `accept`
// (intersect_common.cuh): nearest t, ties to the lowest id.
//
// What bounds it on the H100: at the hero scale the table is 129 MB, more
// than the 50 MB L2, so the kernel waits on the latency of the cluster
// tiles it reads from L2 and device memory; the flops per ray are small.
// A thread-per-ray walk loses most of its time to what one thread does
// alone: a rescan of every block box at each step, scalar header loads at
// addresses that differ across the warp, a quadratic pick over the pierced
// clusters, and warps that wait for their longest walk. The design
// (`walk` of group_walk.cuh): one warp per ray. The warp computes the
// ray's block entries once (lanes over blocks, coalesced loads of the
// (8, NB) box table) and keeps the pierced blocks' (entry, index) keys in
// its slice of shared memory; each step is a warp argmin over them after
// an (entry, index) cursor bounded by the ray's own best t. In a block the
// lanes cull 4 clusters each from coalesced header rows and keep the
// entries in registers; each pierced cluster, front to back, is tested 4
// slots a lane with float4 loads (one 512-byte request a row) and one
// `accept` of the warp's least (t, id). The TPU kernel's DMA ring has no
// counterpart: the tiles come through L2 and L1 on demand.

#include "group_walk.cuh"

namespace {

using namespace isaklm;

__global__ void __launch_bounds__(kWalkThreads, kBlockWalkMinBlocks)
blk_intersect_kernel(const float* __restrict__ bbox_t, int stride,
                     int num_blocks, const float* __restrict__ blk, int branch,
                     const float* __restrict__ rays, int num_rays, float t_eps,
                     float* __restrict__ out_t, int* __restrict__ out_id,
                     int* __restrict__ stats) {
  walk(BlockLayout<1>{blk, branch}, bbox_t, stride, num_blocks, rays, num_rays, t_eps, out_t,
       out_id, stats);
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise. `stats` may
// be null.
extern "C" int blk_intersect(int device, const float* bbox_t, int stride,
                             int num_blocks, const float* blk, int branch,
                             const float* rays, int num_rays, float t_eps,
                             float* out_t, int* out_id, int* stats, void* stream) {
  return launch_walk(blk_intersect_kernel, device, num_blocks, num_rays, stream, bbox_t,
                     stride, num_blocks, blk, branch, rays, num_rays, t_eps, out_t, out_id,
                     stats);
}
