// Queue nearest-hit intersector for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_vmem_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py (called by
// `nearest_hit_cluster`): mid-size scenes whose cluster table fits the
// JAX package's 6 MB budget (65 to 768 clusters of 128 triangles). The TPU
// kernel culls every cluster box for a 256-ray packet in one dense pass,
// then pops clusters from an extract-min queue until the next entry lies
// beyond the packet's tmax.
//
// Contract (the TPU kernel's output, not its packet schedule):
//   box_t   (8, stride) f32 component-major cluster boxes (clu_bbox_t):
//           rows 0-5 min/max xyz, row 6 validity, clusters [0, C)
//   tri     (C, 16, 128) f32 cluster tiles (accel/cluster.py layout)
//   rays    (R, 8) f32, columns [ox oy oz dx dy dz active t_max]
//   out_t   (R,) f32: the best t, or t_max when no triangle beat it
//   out_id  (R,) i32: the winning id c*128 + lane, or 2^31-1
// The running best starts at (t_max, 2^31-1) and follows `accept`
// (intersect_common.cuh): nearest t, ties to the lowest id.
//
// What bounds it on the H100: a ray's walk is serial and data dependent,
// so the bound is latency and warp divergence, not bytes or flops. A
// 768-cluster table is 6 MB and stays in the 50 MB L2; its boxes are
// 21 KB. The design: one thread per ray, its own queue. The block stages
// the component-major boxes in shared memory once; each step of a ray's
// walk rescans them for the pierced cluster with the least (entry, index)
// after an (entry, index) cursor whose entry is at most the ray's own best
// t -- the inclusive bound `m <= tmax` of the TPU loop (intersect.py:
// 376-378), per ray instead of per packet. The cursor keeps the walk in
// registers: no visited array, no queue in local memory. The cluster tiles
// are read from device memory (L2), with the threads of a warp that walk
// the same cluster reading the same addresses.

#include "intersect_common.cuh"

namespace {

using namespace isaklm;

constexpr int kThreads = 128;  // rays per block

__global__ void __launch_bounds__(kThreads)
queue_intersect_kernel(const float* __restrict__ box_t, int stride,
                       int num_clusters, const float* __restrict__ tri,
                       const float* __restrict__ rays, int num_rays,
                       float t_eps, float* __restrict__ out_t,
                       int* __restrict__ out_id) {
  extern __shared__ float boxes[];  // 7 * num_clusters
  stage_boxes(box_t, stride, num_clusters, boxes);
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= num_rays) return;
  const Ray ray = load_ray(rays, r);
  float best_t = ray.t_max;
  int best_id = kBigId;
  if (ray.active) {
    float cur_e = -1.0f;
    int cur_c = -1;
    while (true) {
      float e;
      const int c = next_box(boxes, num_clusters, ray, t_eps, best_t, cur_e, cur_c, e);
      if (c < 0) break;
      intersect_tile(tri + (int64_t)c * kTile, c * kWidth, ray, t_eps, best_t, best_id);
      cur_e = e;
      cur_c = c;
    }
  }
  out_t[r] = best_t;
  out_id[r] = best_id;
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int queue_intersect(int device, const float* box_t, int stride,
                               int num_clusters, const float* tri,
                               const float* rays, int num_rays, float t_eps,
                               float* out_t, int* out_id, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * 7 * (size_t)num_clusters;
  err = cudaFuncSetAttribute(queue_intersect_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    queue_intersect_kernel<<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        box_t, stride, num_clusters, tri, rays, num_rays, t_eps, out_t, out_id);
  }
  return static_cast<int>(cudaGetLastError());
}
