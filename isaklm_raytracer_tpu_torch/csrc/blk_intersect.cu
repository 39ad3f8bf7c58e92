// Blocked nearest-hit intersector for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_blk_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py (called by
// `nearest_hit_cluster_blk`): scenes whose cluster table exceeds the queue
// kernel's budget, such as the 2M-triangle hero scene. The TPU kernel
// keeps the blocked table in HBM and runs a packet queue over DMA blocks
// of `branch` clusters. Each block is a header tile of component-major
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
// than the 50 MB L2, so the kernel is bound by warp divergence (each ray
// walks its own blocks) and by L2 misses on the cluster tiles it reads;
// the flops per ray are small. The design: one thread per ray. The block
// boxes (NB x 7 floats, 3.4 KB for the hero's 122 blocks) sit in shared
// memory; a ray walks them front to back with an (entry, index) cursor
// whose entry is at most its own best t, as the queue kernel does. In a
// block it reads rows 0-6 of the header tile, culls the block's clusters
// against its own best t into a 128-bit mask held in registers, and walks
// the pierced clusters front to back, dropping those whose entry falls
// behind its best. The TPU kernel's DMA ring has no counterpart: the
// tiles come through L2 and L1 on demand.

#include "intersect_common.cuh"

namespace {

using namespace isaklm;

constexpr int kThreads = 128;  // rays per block
constexpr int kMaskWords = kWidth / 32;

// Slab test of cluster k of a header tile (row j of cluster k at
// hdr[j * 128 + k]); false for an invalid (padding) cluster.
__device__ __forceinline__ bool cluster_entry(const float* __restrict__ hdr, int k,
                                              const Ray& r, float t_eps, float& e) {
  if (!(__ldg(hdr + 6 * kWidth + k) > 0.0f)) return false;
  return slab(__ldg(hdr + k), __ldg(hdr + kWidth + k), __ldg(hdr + 2 * kWidth + k),
              __ldg(hdr + 3 * kWidth + k), __ldg(hdr + 4 * kWidth + k),
              __ldg(hdr + 5 * kWidth + k), r, t_eps, e);
}

__global__ void __launch_bounds__(kThreads)
blk_intersect_kernel(const float* __restrict__ bbox_t, int stride,
                     int num_blocks, const float* __restrict__ blk, int branch,
                     const float* __restrict__ rays, int num_rays, float t_eps,
                     float* __restrict__ out_t, int* __restrict__ out_id,
                     int* __restrict__ stats) {
  extern __shared__ float boxes[];  // 7 * num_blocks
  stage_boxes(bbox_t, stride, num_blocks, boxes);
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= num_rays) return;
  const Ray ray = load_ray(rays, r);
  float best_t = ray.t_max;
  int best_id = kBigId;
  int visits = 0, clusters = 0;
  if (ray.active) {
    float cur_e = -1.0f;
    int cur_b = -1;
    while (true) {
      float e;
      const int b = next_box(boxes, num_blocks, ray, t_eps, best_t, cur_e, cur_b, e);
      if (b < 0) break;
      cur_e = e;
      cur_b = b;
      ++visits;
      const float* hdr = blk + (int64_t)b * (branch + 1) * kTile;

      // cull the block's clusters against this ray's own best
      uint32_t mask[kMaskWords];
#pragma unroll
      for (int w = 0; w < kMaskWords; ++w) {
        uint32_t m = 0;
        for (int j = 0; j < 32 && w * 32 + j < branch; ++j) {
          float ce;
          if (cluster_entry(hdr, w * 32 + j, ray, t_eps, ce) && ce <= best_t) m |= 1u << j;
        }
        mask[w] = m;
      }

      // walk the pierced clusters front to back
      while (true) {
        int k = -1;
        float ke = 0.0f;
#pragma unroll
        for (int w = 0; w < kMaskWords; ++w) {
          uint32_t bits = mask[w];
          while (bits) {
            const int j = __ffs(bits) - 1;
            bits &= bits - 1;
            float ce;
            cluster_entry(hdr, w * 32 + j, ray, t_eps, ce);  // pierced when set
            if (ce > best_t) {
              mask[w] &= ~(1u << j);  // behind the best: never needed again
            } else if (k < 0 || ce < ke) {  // ascending: ties keep the lower k
              k = w * 32 + j;
              ke = ce;
            }
          }
        }
        if (k < 0) break;
#pragma unroll
        for (int w = 0; w < kMaskWords; ++w) {
          if (w == (k >> 5)) mask[w] &= ~(1u << (k & 31));
        }
        ++clusters;
        intersect_tile(hdr + (int64_t)(1 + k) * kTile, (b * branch + k) * kWidth, ray,
                       t_eps, best_t, best_id);
      }
    }
  }
  out_t[r] = best_t;
  out_id[r] = best_id;
  if (stats != nullptr) {
    stats[2 * (int64_t)r] = visits;
    stats[2 * (int64_t)r + 1] = clusters;
  }
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise. `stats` may
// be null.
extern "C" int blk_intersect(int device, const float* bbox_t, int stride,
                             int num_blocks, const float* blk, int branch,
                             const float* rays, int num_rays, float t_eps,
                             float* out_t, int* out_id, int* stats, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * 7 * (size_t)num_blocks;
  err = cudaFuncSetAttribute(blk_intersect_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    blk_intersect_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        bbox_t, stride, num_blocks, blk, branch, rays, num_rays, t_eps, out_t,
        out_id, stats);
  }
  return static_cast<int>(cudaGetLastError());
}
