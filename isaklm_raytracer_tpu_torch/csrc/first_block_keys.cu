// First-block sort keys for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_first_blocks_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py:949 (called by
// `first_block_keys`), the pre-pass of the blocked intersector's
// sort_rays="block" ordering. Per ray, a slab test against every block box
// gives the ray's nearest and second-nearest pierced blocks, and the key
//
//     ((first * (n + 1) + second) * 8 + direction octant)
//
// so that a sort groups rays that enter the same blocks in the same order
// with a similar heading.
//
// Contract, key for key the Pallas body's:
//   bbox_t  (8, n) f32 component-major block boxes (blk_bbox_t): rows 0-5
//           min/max xyz, row 6 validity; n is the PADDED width, and an
//           invalid box (row 6 <= 0) is never pierced
//   rays    (R, 8) f32, columns [ox oy oz dx dy dz active t_max]; t_max is
//           not read
//   out_key (R,) i32: the key above, with second = n when the ray pierces
//           one block only; 2^31-2 when it pierces none; 2^31-1 when it is
//           inactive
// A box's key is its entry distance max(near, 0), or 0 when the slab
// arithmetic gives NaN (an origin on a slab plane with a zero direction
// component): `slab` of intersect_common.cuh decides that case as the
// Pallas kernel's NaN-propagating jnp.minimum/maximum do. Equal entries go
// to the lower block index, for the first and for the second. An entry of
// 1e38 or more counts as not pierced.
//
// What bounds it on the H100: the slab arithmetic. Each (ray, box) pair
// costs about 27 float operations (6 subtractions, 6 products, 10
// min/max, the miss and clamp tests, two comparisons against the running
// pair) for 32 bytes of ray in and 4 bytes of key out, so the kernel is
// bound by operations, not bytes (230,400 rays x 122 blocks of the hero:
// 0.76 GOP against 8.3 MB). The design keeps every operand on chip: one
// thread per ray, the 7 x n box floats staged once per block of threads in
// shared memory (3.5 KB for the hero's 128-wide table) and read as
// broadcasts, and one pass over the boxes that keeps the least and
// second-least (entry, index) pairs in registers instead of the Pallas
// body's (B, n) key matrix and its two masked reductions.

#include "intersect_common.cuh"

namespace {

using namespace isaklm;

constexpr int kThreads = 128;  // rays per block
constexpr float kCut = 1e38f;  // intersect.py _CUT

__global__ void __launch_bounds__(kThreads)
first_block_keys_kernel(const float* __restrict__ bbox_t, int n,
                        const float* __restrict__ rays, int num_rays, float t_eps,
                        int* __restrict__ out_key) {
  extern __shared__ float boxes[];  // 7 * n
  stage_boxes(bbox_t, n, n, boxes);
  __syncthreads();

  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= num_rays) return;
  const Ray ray = load_ray(rays, r);
  if (!ray.active) {
    out_key[r] = kBigId;
    return;
  }
  // A box that is missed or invalid keys to 3.4e38 >= kCut in the Pallas
  // body; skipping it, and seeding the pair with that key, changes neither
  // which entries fall below kCut nor their least indices, which is all
  // the key reads.
  float first = kMiss, second = kMiss;
  int fidx = 0, sidx = 0;
  for (int i = 0; i < n; ++i) {
    if (!(boxes[6 * n + i] > 0.0f)) continue;
    float e;
    if (!slab(boxes[i], boxes[n + i], boxes[2 * n + i], boxes[3 * n + i],
              boxes[4 * n + i], boxes[5 * n + i], ray, t_eps, e)) continue;
    if (e < first) {  // i ascends: an equal entry keeps the lower index
      second = first;
      sidx = fidx;
      first = e;
      fidx = i;
    } else if (e < second) {
      second = e;
      sidx = i;
    }
  }
  if (!(first < kCut)) {
    out_key[r] = kBigId - 1;
    return;
  }
  if (!(second < kCut)) sidx = n;
  const int octant = (ray.dx > 0.0f) + 2 * (ray.dy > 0.0f) + 4 * (ray.dz > 0.0f);
  out_key[r] = (fidx * (n + 1) + sidx) * 8 + octant;
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int first_block_keys(int device, const float* bbox_t, int n,
                                const float* rays, int num_rays, float t_eps,
                                int* out_key, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * 7 * (size_t)n;
  err = cudaFuncSetAttribute(first_block_keys_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kThreads - 1) / kThreads;
    first_block_keys_kernel<<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        bbox_t, n, rays, num_rays, t_eps, out_key);
  }
  return static_cast<int>(cudaGetLastError());
}
