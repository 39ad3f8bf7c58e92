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
// time counts as time to the first sample, not per sample. The design: a
// block of kTableThreads triangles stages its rows in shared memory by
// whole 16-byte words, neighbouring threads on neighbouring words, and
// its records likewise on the way out, so that every warp's load and
// store covers contiguous lines (a thread's own row is 36 bytes and its
// record 80: read and written in place, a warp's access spans 1-2.5 KB);
// blocks of 128 put the 20k-triangle hero on 154 blocks, more than the
// card's 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_test.cuh"

namespace {

using namespace isaklm;

constexpr int kTableThreads = 128;  // triangles a block, one a thread
constexpr int kRowFloats = 9;  // a row of the source: p1 | p2 | p3
constexpr int kRowWords = kTableThreads * kRowFloats / 4;  // a block's rows in 16-byte words

__global__ void __launch_bounds__(kTableThreads)
tri_consts_kernel(const float* __restrict__ src, int num, float4* __restrict__ out) {
  __shared__ float4 rows[kRowWords];
  __shared__ float4 records[kTableThreads * kRecordWords];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTableThreads;
  const int n = num - first < kTableThreads ? static_cast<int>(num - first) : kTableThreads;
  // the block's rows: whole 16-byte words where src is aligned to them (a
  // block's first row is 4,608 bytes after the one before), the rest and
  // an unaligned source as floats
  const float* from = src + kRowFloats * first;
  const int floats = kRowFloats * n;
  const int words = (reinterpret_cast<uintptr_t>(src) & 15u) == 0 ? floats / 4 : 0;
  for (int w = threadIdx.x; w < words; w += kTableThreads) {
    rows[w] = __ldg(reinterpret_cast<const float4*>(from) + w);
  }
  float* row_floats = reinterpret_cast<float*>(rows);
  for (int f = 4 * words + threadIdx.x; f < floats; f += kTableThreads) {
    row_floats[f] = __ldg(from + f);
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n) {
    const float* p = row_floats + kRowFloats * threadIdx.x;
    const float p1x = p[0], p1y = p[1], p1z = p[2];
    const TriConsts c = make_tri(p1x, p1y, p1z, p[3] - p1x, p[4] - p1y, p[5] - p1z,
                                 p[6] - p1x, p[7] - p1y, p[8] - p1z);
    pack_tri(c, static_cast<int>(first) + static_cast<int>(threadIdx.x),
             records + kRecordWords * threadIdx.x);
  }
  __syncthreads();
  float4* to = out + kRecordWords * first;
  for (int w = threadIdx.x; w < kRecordWords * n; w += kTableThreads) to[w] = records[w];
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
