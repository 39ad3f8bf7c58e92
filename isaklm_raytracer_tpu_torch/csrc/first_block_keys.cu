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
// Equal entries go to the lower block index, for the first and for the
// second. An entry of 1e38 or more counts as not pierced.
//
// What bounds it on the H100: the slab arithmetic. Each (ray, box) pair
// costs some 30 issue slots (6 subtractions, 6 products, 10 min/max, the
// miss and clamp tests, the update of the running pair) for 32 bytes of
// ray in and 4 bytes of key out, so the kernel is bound by operations, not
// bytes (230,400 rays x 122 blocks of the hero: 0.95e9 issue slots against
// 8.3 MB). Every instruction that is not slab arithmetic is overhead, and
// the design cuts them:
//   - each block first stages the VALID boxes, in index order, in shared
//     memory as a float4 (x0 y0 z0 x1) and a float2 (y1 z1), 24 bytes, and
//     keeps their indices beside them (28 bytes a box in all, so a block
//     takes up to 8,301 boxes); a box comes in as two wide broadcast loads
//     and no validity test is left in the loop;
//   - each thread holds kKeyRays rays, so each staged box is read once for
//     kKeyRays rays;
//   - the running (first, second) pair of each ray is updated without a
//     branch, by its position j in the staged list (ascending with the
//     index), and mapped to the box index once, at the end;
//   - the slab's NaN case costs no test: min.NaN / max.NaN (sm_80 and
//     later) propagate NaN as the Pallas body's jnp.minimum/maximum and the
//     plain version's torch.minimum/maximum do, so near and far are theirs
//     operand for operand.
// Rays r, r + kKeyThreads, ... of a block go to consecutive threads, so
// the ray loads and key stores are coalesced; rays past the end of the
// batch are masked.
//
// Why the keys equal the plain version's (`_first_keys`, two masked
// reductions over a (rays, n) key matrix in which a missed or invalid box
// keys to 3.4e38 and a NaN slab to 0):
//   - a NaN in any of the six slab values makes near and far NaN; both
//     comparisons of the miss test are then false, so the box is pierced,
//     and fmaxf(NaN, 0) = 0 is its entry, as the plain version's NaN -> 0;
//     otherwise near, far, the miss test and max(near, 0) are the plain
//     version's (a -0 entry compares equal to 0, so its sign changes no
//     comparison);
//   - the pair starts at (3.4e38, 3.4e38), and only an entry strictly
//     below it is taken: a missed or invalid box (3.4e38 in the plain
//     version) and every entry at or above 1e38 (also above 3.4e38) key to
//     "not pierced" in both, so leaving them out of the pair changes
//     neither which entries fall below 1e38 nor their least indices, which
//     is all the key reads;
//   - boxes come in ascending index order and a strictly smaller entry
//     replaces the first (the old first becoming the second), or else a
//     strictly smaller one the second: the first is the least entry at its
//     lowest index, and the second the least of the others at its lowest
//     index, as the plain version's reductions with ties to the lower index.

#include <atomic>

#include "intersect_common.cuh"

namespace {

using namespace isaklm;

constexpr int kKeyRays = 2;       // rays a thread
constexpr int kKeyThreads = 128;  // threads a block
constexpr int kKeyWarps = kKeyThreads / 32;
constexpr int kBlockRays = kKeyRays * kKeyThreads;
constexpr float kCut = 1e38f;  // intersect.py _CUT
// Shared memory a staged box takes: its coordinates and its index.
constexpr int kBoxBytes = sizeof(float4) + sizeof(float2) + sizeof(int);
static_assert(kBoxBytes == 28, "kernels/intersect.py admits 232,448 // 28 boxes");

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Copies the valid boxes of the component-major (8, n) table to shared
// memory in index order: coordinates to lo and hi, indices to idx. Returns
// how many there are. Every thread of the block calls it.
__device__ __forceinline__ int stage_valid_boxes(const float* __restrict__ bbox_t, int n,
                                                 float4* lo, float2* hi, int* idx) {
  __shared__ int warp_count[kKeyWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int count = 0;  // boxes staged so far, the same in every thread
  for (int base = 0; base < n; base += kKeyThreads) {
    const int i = base + threadIdx.x;
    const bool valid = i < n && __ldg(bbox_t + 6 * n + i) > 0.0f;
    const unsigned ballot = __ballot_sync(kFullMask, valid);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int at = count + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < kKeyWarps; ++w) {
      const int c = warp_count[w];
      at += w < warp ? c : 0;
      count += c;
    }
    if (valid) {
      lo[at] = make_float4(__ldg(bbox_t + i), __ldg(bbox_t + n + i), __ldg(bbox_t + 2 * n + i),
                           __ldg(bbox_t + 3 * n + i));
      hi[at] = make_float2(__ldg(bbox_t + 4 * n + i), __ldg(bbox_t + 5 * n + i));
      idx[at] = i;
    }
    __syncthreads();  // warp_count is rewritten next round; the boxes are all in
  }
  return count;
}

__global__ void __launch_bounds__(kKeyThreads)
first_block_keys_kernel(const float* __restrict__ bbox_t, int n,
                        const float* __restrict__ rays, int num_rays, float t_eps,
                        int* __restrict__ out_key) {
  extern __shared__ float4 lo[];  // n boxes: lo, then hi (n float2), then idx (n int)
  float2* hi = reinterpret_cast<float2*>(lo + n);
  int* idx = reinterpret_cast<int*>(hi + n);
  const int count = stage_valid_boxes(bbox_t, n, lo, hi, idx);

  const int64_t r0 = (int64_t)blockIdx.x * kBlockRays + threadIdx.x;
  Ray ray[kKeyRays];
  float first[kKeyRays], second[kKeyRays];
  int fj[kKeyRays], sj[kKeyRays], octant[kKeyRays];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kKeyRays; ++k) {
    const int64_t r = r0 + k * kKeyThreads;
    ray[k] = r < num_rays ? load_ray(rays, r) : Ray{};  // past the end: inactive
    const Ray& q = ray[k];
    octant[k] = (q.dx > 0.0f) + 2 * (q.dy > 0.0f) + 4 * (q.dz > 0.0f);
    first[k] = second[k] = kMiss;
    fj[k] = sj[k] = 0;
    any |= ray[k].active;
  }
  if (any) {
    for (int j = 0; j < count; ++j) {
      const float4 a = lo[j];  // x0 y0 z0 x1
      const float2 b = hi[j];  // y1 z1
#pragma unroll
      for (int k = 0; k < kKeyRays; ++k) {
        const Ray& q = ray[k];
        const float t1x = (a.x - q.ox) * q.ix, t2x = (a.w - q.ox) * q.ix;
        const float t1y = (a.y - q.oy) * q.iy, t2y = (b.x - q.oy) * q.iy;
        const float t1z = (a.z - q.oz) * q.iz, t2z = (b.y - q.oz) * q.iz;
        const float near =
            max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)), min_nan(t1z, t2z));
        const float far =
            min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)), max_nan(t1z, t2z));
        const bool pierced = !((near > far) | (far < t_eps));  // true on NaN
        const float e = fmaxf(near, 0.0f);                      // NaN -> 0
        const bool lt1 = pierced & (e < first[k]);
        const bool lt2 = pierced & (e < second[k]);
        second[k] = lt1 ? first[k] : lt2 ? e : second[k];
        sj[k] = lt1 ? fj[k] : lt2 ? j : sj[k];
        first[k] = lt1 ? e : first[k];
        fj[k] = lt1 ? j : fj[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kKeyRays; ++k) {
    const int64_t r = r0 + k * kKeyThreads;
    if (r >= num_rays) break;
    int key = kBigId;
    if (ray[k].active && !(first[k] < kCut)) {
      key = kBigId - 1;
    } else if (ray[k].active) {
      const int sidx = second[k] < kCut ? idx[sj[k]] : n;
      key = (idx[fj[k]] * (n + 1) + sidx) * 8 + octant[k];
    }
    out_key[r] = key;
  }
}

// The dynamic shared memory the kernel is allowed on each device so far
// (0: not set yet); a launch that needs more raises it first.
constexpr int kMaxDevices = 64;
std::atomic<int> allowed_shared[kMaxDevices];

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int first_block_keys(int device, const float* bbox_t, int n,
                                const float* rays, int num_rays, float t_eps,
                                int* out_key, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = kBoxBytes * n;
  if (device < 0 || device >= kMaxDevices || smem > allowed_shared[device].load()) {
    err = cudaFuncSetAttribute(first_block_keys_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < kMaxDevices) allowed_shared[device].store(smem);
  }
  if (num_rays > 0) {
    const int blocks = (num_rays + kBlockRays - 1) / kBlockRays;
    first_block_keys_kernel<<<blocks, kKeyThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        bbox_t, n, rays, num_rays, t_eps, out_key);
  }
  return static_cast<int>(cudaGetLastError());
}
