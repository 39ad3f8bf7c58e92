// Brute-force nearest hit for Hopper (sm_90a): every ray against every
// triangle, one thread a ray.
//
// Replaces no Pallas kernel. It computes `nearest_hit_brute`
// (isaklm_raytracer_tpu/accel/traverse.py:73) with its contract, for a
// scene without acceleration tables (the CLI's --no-kd): the test of
// tri_test.cuh (the unit normal, the plane distance, Cramer's
// barycentrics, ddn != 0, s >= t_eps), the lowest triangle id on ties, and
// (+inf, -1) for a miss and for an inactive ray. t_max is ignored, as in
// the JAX function. It equals the plain function
// (accel/traverse.py nearest_hit_brute) bit for bit.
//
// What bounds it on the H100: issue slots, the plane distance of every
// (ray, triangle) pair and the rest of the test where that distance can
// win; the triangles are read once a block. The design: each
// block of kBruteThreads rays stages the scene up to kBruteTile triangles
// at a time in dynamic shared memory, each thread forming some triangles'
// constants (make_tri: the normal and the Cramer terms, once a block
// instead of once a pair) into 80-byte records (tri_test.cuh); every thread
// then reads each record in id order as five 16-byte loads, the same
// address across the warp (a broadcast): five shared loads a test. A test
// whose plane distance cannot win (not s >= t_eps, or not nearer than the
// best) skips the barycentrics, whose outcome could not change the result.
// A strictly nearer candidate replaces the best, so the lowest id wins
// ties.
//
// A block whose rays are all inactive (late bounces) writes its misses and
// stages nothing. One ray a thread: two or four (one record load serving
// each) ran slower on the bounce and NEE wavefronts, 15 of a sample's 16
// calls, in probe runs (PERF.md section 6); a tile of 128 records (10 KB)
// keeps the SM's 16 blocks resident, so a call of mostly inactive rays
// runs in one wave.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_test.cuh"

namespace {

using namespace isaklm;

constexpr int kBruteThreads = 128;  // rays a block
constexpr int kBruteTile = 128;     // triangles staged at a time

__global__ void __launch_bounds__(kBruteThreads)
brute_intersect_kernel(const float* __restrict__ vertices, int num_tris,
                       const float* __restrict__ rays, int num_rays, float t_eps,
                       float* __restrict__ out_t, int* __restrict__ out_id) {
  extern __shared__ float4 tile[];  // min(num_tris, kBruteTile) records
  const int r = blockIdx.x * kBruteThreads + threadIdx.x;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  bool active = false;
  if (r < num_rays) {
    const float4* row = reinterpret_cast<const float4*>(rays + 8 * static_cast<int64_t>(r));
    const float4 a = row[0], b = row[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z;
    d[0] = a.w; d[1] = b.x; d[2] = b.y;
    active = b.z > 0.0f;
  }
  float best_t = INFINITY;
  int best_i = -1;
  const bool block_active = __syncthreads_or(active);
  for (int base = 0; block_active && base < num_tris; base += kBruteTile) {
    const int count = min(kBruteTile, num_tris - base);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < count; i += kBruteThreads) {
      const float* p = vertices + 9 * static_cast<int64_t>(base + i);
      const float p1x = __ldg(p), p1y = __ldg(p + 1), p1z = __ldg(p + 2);
      pack_tri(make_tri(p1x, p1y, p1z, __ldg(p + 3) - p1x, __ldg(p + 4) - p1y,
                        __ldg(p + 5) - p1z, __ldg(p + 6) - p1x, __ldg(p + 7) - p1y,
                        __ldg(p + 8) - p1z),
               base + i, tile + kRecordWords * i);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < count; ++j) {
      const float4* rec = tile + kRecordWords * j;
      const TriConsts c = unpack_tri(rec[0], rec[1], rec[2], rec[3], rec[4]);
      float ddn;
      float s = tri_plane(c, o[0], o[1], o[2], d[0], d[1], d[2], ddn);
      if (!((s >= t_eps) & (s < best_t))) continue;  // it cannot win
      s = tri_inside(c, o[0], o[1], o[2], d[0], d[1], d[2], ddn, s, t_eps);
      if (s < best_t) {
        best_t = s;
        best_i = base + j;
      }
    }
  }
  if (r < num_rays) {
    out_t[r] = best_t;
    out_id[r] = best_i;
  }
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int brute_intersect(int device, const float* vertices, int num_tris,
                               const float* rays, int num_rays, float t_eps, float* out_t,
                               int* out_id, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int smem = static_cast<int>(sizeof(float4)) * kRecordWords * min(num_tris, kBruteTile);
    brute_intersect_kernel<<<(num_rays + kBruteThreads - 1) / kBruteThreads, kBruteThreads,
                             smem, static_cast<cudaStream_t>(stream)>>>(
        vertices, num_tris, rays, num_rays, t_eps, out_t, out_id);
  }
  return static_cast<int>(cudaGetLastError());
}
