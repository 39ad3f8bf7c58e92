// The triangle-constant table of the KD walk for Hopper (sm_90a): one thread
// a triangle slot writes `make_tri`'s constants as one 80-byte record
// (tri_test.cuh: five 16-byte words, the id in a pad word).
//
// Replaces no Pallas kernel. It computes, once a scene, the part of the
// JAX package's KD walks' triangle test that depends on the triangle alone
// (the unit normal, n.p1, Cramer's dot products and reciprocal:
// isaklm_raytracer_tpu/accel/wavefront.py:121-162 `_intersect_chunk`,
// accel/kd_traverse.py:39-73 `_leaf_scan`), which csrc/kd_intersect.cu
// then reads instead of forming it again at every test. It calls the same
// `make_tri` the walk called, so every word equals the term the walk
// formed, and the plain version (accel/wavefront.py `tri_consts_plain`,
// the terms of `tri_hits` in its order) bit for bit.
//
// Its source is the scene's corners p1 | p2 | p3 (N, 9), the edges formed
// here as the walk formed them; row i is triangle i's record, its id word i.
//
// What bounds it on the H100: bytes, 36 read and 80 written a triangle; it
// runs once a tree reaches the card (outside any graph capture), so its
// time counts as time to the first sample, not per sample.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_test.cuh"

namespace {

using namespace isaklm;

constexpr int kTableThreads = 256;

__global__ void __launch_bounds__(kTableThreads)
tri_consts_kernel(const float* __restrict__ src, int num, float4* __restrict__ out) {
  const int i = blockIdx.x * kTableThreads + threadIdx.x;
  if (i >= num) return;
  const float* p = src + 9 * static_cast<int64_t>(i);
  const float p1x = __ldg(p), p1y = __ldg(p + 1), p1z = __ldg(p + 2);
  const TriConsts c = make_tri(p1x, p1y, p1z, __ldg(p + 3) - p1x, __ldg(p + 4) - p1y,
                               __ldg(p + 5) - p1z, __ldg(p + 6) - p1x, __ldg(p + 7) - p1y,
                               __ldg(p + 8) - p1z);
  pack_tri(c, i, out + kRecordWords * static_cast<int64_t>(i));
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). src (num, 9) float32: p1 | p2 | p3; out (num, 20)
// float32, 16-byte aligned. Allocates nothing and does not synchronise.
extern "C" int tri_consts(int device, const float* src, int num, float* out, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num > 0) {
    tri_consts_kernel<<<(num + kTableThreads - 1) / kTableThreads, kTableThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(src, num,
                                                             reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
