// Flat nearest-hit intersector for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flat_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py (called by
// `nearest_hit_cluster_flat`): every ray against every triangle of the
// scene's real clusters, for scenes of at most 64 clusters of 128 triangles.
//
// Contract (the same as the TPU kernel's output, not its packet schedule):
//   rays    (R, 8) f32, columns [ox oy oz dx dy dz active t_max]
//   tri     (C, 16, 128) f32 cluster tiles (accel/cluster.py layout); the
//           kernel reads rows 0-14 of the first `num_clusters` tiles
//   out_t   (R,) f32: the best t, or t_max when no triangle beat it
//   out_id  (R,) i32: the winning id c*128 + lane, or 2^31-1 (no winner)
// Per ray the running best starts at (t_max, 2^31-1) and the triangles are
// walked in id order with a strict `<` update, so ties go to the lowest id.
// The test is `_make_intersect` (intersect.py:225-254) operation for
// operation (`tri_hit` of intersect_common.cuh, shared with the queue and
// blocked kernels); the library is built with --fmad=false so that every
// product and sum rounds as in the plain PyTorch version, which makes the
// two agree bit for bit.
//
// What bounds it on the H100: about 40 flops per ray per triangle and no
// memory traffic to speak of (a 6-cluster table is 48 KB, a ray 32 bytes),
// so compute, at 262,144 rays x 768 slots about 8 GFLOP a call. The TPU
// kernel keeps the whole table in VMEM; 64 clusters are 512 KB, more than
// the 227 KB of shared memory a block may use. So each block of 128 threads
// (one thread per ray) stages ONE cluster tile at a time in shared memory,
// transposed to triangle-major so a thread reads a triangle's 15 constants
// as four 16-byte broadcasts, and all threads of a warp read the same
// triangle at the same time. Inactive rays skip the arithmetic but still
// help stage the tiles; a block whose rays are all inactive returns at
// once, which replaces the TPU path's Morton sort of dead lanes.

#include "intersect_common.cuh"

namespace {

using isaklm::kBigId;
using isaklm::kTileRows;
using isaklm::kWidth;

constexpr int kRows = 15;          // rows the test reads (row 15 is the bbox)
constexpr int kThreads = 128;      // rays per block

__global__ void __launch_bounds__(kThreads)
flat_intersect_kernel(const float* __restrict__ tri, int num_clusters,
                      const float* __restrict__ rays, int num_rays,
                      float t_eps, float* __restrict__ out_t,
                      int* __restrict__ out_id) {
  // Triangle-major tile: slot `lane` holds its 15 constants at
  // [lane * 16, lane * 16 + 15), 16-byte aligned for float4 reads.
  __shared__ __align__(16) float tile[kWidth * kTileRows];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < num_rays;
  float4 o4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (in_range) {
    const float4* row = reinterpret_cast<const float4*>(rays + 8 * (int64_t)r);
    o4 = row[0];  // ox oy oz dx
    d4 = row[1];  // dy dz active t_max
  }
  const float ox = o4.x, oy = o4.y, oz = o4.z;
  const float dx = o4.w, dy = d4.x, dz = d4.y;
  const bool active = in_range && d4.z > 0.0f;
  float best_t = d4.w;
  int best_id = kBigId;

  if (__syncthreads_or(active)) {
    for (int c = 0; c < num_clusters; ++c) {
      const float* src = tri + (int64_t)c * kTileRows * kWidth;
      __syncthreads();  // every thread is done with the previous tile
      for (int i = threadIdx.x; i < kRows * kWidth; i += kThreads) {
        const int k = i / kWidth, lane = i % kWidth;
        tile[lane * kTileRows + k] = src[i];
      }
      __syncthreads();
      if (!active) continue;
      for (int lane = 0; lane < kWidth; ++lane) {
        const float4* q = reinterpret_cast<const float4*>(tile + lane * kTileRows);
        const float4 a = q[0], b = q[1], e = q[2], f = q[3];
        const float nx = a.x, ny = a.y, nz = a.z;
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = e.x;
        const float np1 = e.y, p1e1 = e.z, p1e2 = e.w;
        const float ca = f.x, cb = f.y, cc = f.z;

        const float tval = isaklm::tri_hit(ox, oy, oz, dx, dy, dz, nx, ny, nz,
                                           e1x, e1y, e1z, e2x, e2y, e2z, np1,
                                           p1e1, p1e2, ca, cb, cc, t_eps);
        if (tval < best_t) {
          best_t = tval;
          best_id = c * kWidth + lane;
        }
      }
    }
  }
  if (in_range) {
    out_t[r] = best_t;
    out_id[r] = best_id;
  }
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int flat_intersect(int device, const float* tri, int num_clusters,
                              const float* rays, int num_rays, float t_eps,
                              float* out_t, int* out_id, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    flat_intersect_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        tri, num_clusters, rays, num_rays, t_eps, out_t, out_id);
  }
  return static_cast<int>(cudaGetLastError());
}
