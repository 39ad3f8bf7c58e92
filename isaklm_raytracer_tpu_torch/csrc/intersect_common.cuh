// Pieces shared by the intersector kernels of this directory.
//
// Port of the maths that the Pallas kernels of
// isaklm_raytracer_tpu/kernels/intersect.py share:
//   - `tri_hit`: the ray/triangle test `_make_intersect` (intersect.py:
//     217-256), operation for operation, on one triangle slot of a
//     (16, 128) cluster tile (accel/cluster.py layout);
//   - `slab`: the NaN-conservative slab test of `_make_box_any` and
//     `_dense_near` (intersect.py:121-149, 155-197);
//   - `accept`: the running-best update of the shared output contract;
//   - `warp_intersect_tile` / `warp_intersect_tile_mxu`: `tri_hit` over the
//     128 slots of a cluster in the VPU layout or the MXU tile-pair layout
//     (`_make_intersect_mxu`, intersect.py:259-309), by the 32 lanes of a
//     warp (the walks of group_walk.cuh). The flat kernels test a slot in
//     stages instead (flat_walk.cuh).
// Every library that includes this file is built with --fmad=false, so
// each product and sum rounds as in the plain PyTorch versions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace isaklm {

constexpr int kWidth = 128;        // triangles per cluster (lanes)
constexpr int kTileRows = 16;      // rows of one cluster tile in memory
constexpr int kTile = kTileRows * kWidth;  // floats per tile
constexpr int kBigId = 0x7FFFFFFF; // "no triangle won" (the seed id)
constexpr float kMiss = 3.4e38f;   // intersect.py _INF: a rejected candidate

// One ray of the (R, 8) [ox oy oz dx dy dz active t_max] layout, with the
// reciprocal direction the slab test needs (1/+-0 = +-inf).
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;
  float t_max;
  bool active;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int64_t r) {
  const float4* row = reinterpret_cast<const float4*>(rays + 8 * r);
  const float4 a = row[0];  // ox oy oz dx
  const float4 b = row[1];  // dy dz active t_max
  Ray ray;
  ray.ox = a.x; ray.oy = a.y; ray.oz = a.z;
  ray.dx = a.w; ray.dy = b.x; ray.dz = b.y;
  ray.ix = 1.0f / ray.dx; ray.iy = 1.0f / ray.dy; ray.iz = 1.0f / ray.dz;
  ray.active = b.z > 0.0f;
  ray.t_max = b.w;
  return ray;
}

// The candidate t of one triangle slot, or kMiss when the test rejects it.
// The constants are rows 0-14 of the slot: n, e1, e2, n.p1, p1.e1, p1.e2
// and the three Cramer coefficients. Pad slots are all zeros: ddn == 0.
__device__ __forceinline__ float tri_hit(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float nx, float ny, float nz, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float np1, float p1e1, float p1e2,
    float ca, float cb, float cc, float t_eps) {
  const float ddn = dx * nx + dy * ny + dz * nz;
  const float odn = ox * nx + oy * ny + oz * nz;
  const float s = (np1 - odn) / ddn;
  const float de1 = dx * e1x + dy * e1y + dz * e1z;
  const float oe1 = ox * e1x + oy * e1y + oz * e1z;
  const float d20 = oe1 + s * de1 - p1e1;
  const float de2 = dx * e2x + dy * e2y + dz * e2z;
  const float oe2 = ox * e2x + oy * e2y + oz * e2z;
  const float d21 = oe2 + s * de2 - p1e2;
  const float bb = d20 * ca - d21 * cb;
  const float c3 = d21 * cc - d20 * cb;
  const float aa = 1.0f - bb - c3;
  const bool inside = (aa >= 0.0f) & (aa <= 1.0f) & (bb >= 0.0f) &
                      (bb <= 1.0f) & (c3 >= 0.0f) & (c3 <= 1.0f);
  const bool valid = (ddn != 0.0f) & (s >= t_eps) & inside;
  return valid ? s : kMiss;
}

// The running best of the shared contract. It starts at (t_max, kBigId).
// A candidate wins if it is nearer, or as near with a lower id than a
// triangle that already won: ties go to the lowest id whatever order the
// clusters are visited in, and a candidate at exactly t_max never beats
// the seed.
__device__ __forceinline__ void accept(float t, int id, float& best_t, int& best_id) {
  if (t < best_t || (t == best_t && best_id != kBigId && id < best_id)) {
    best_t = t;
    best_id = id;
  }
}

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// The least (t, id) over the warp's lanes, by t and then by id, in every
// lane. The ids are distinct, so the least pair is unique.
__device__ __forceinline__ void warp_min_hit(float& t, int& id) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float other_t = __shfl_xor_sync(kFullMask, t, offset);
    const int other_id = __shfl_xor_sync(kFullMask, id, offset);
    if (other_t < t || (other_t == t && other_id < id)) {
      t = other_t;
      id = other_id;
    }
  }
}

__device__ __forceinline__ float component(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// `tri_hit` over the 128 slots of a cluster whose 15 constants lie in
// device memory as four runs of consecutive 128-lane rows: n (3 rows), e1
// (3), e2 (3) and np1 p1e1 p1e2 ca cb cc (6); `base` is the id of lane 0.
// The 32 lanes of a warp all hold the same ray and running best: lane l
// tests slots 4l..4l+3, so each 128-lane row is one coalesced 512-byte
// request of float4 loads (the rows must be 16-byte aligned). The warp
// takes the least (t, id) of the 128 candidates, by t and then by id, and
// applies `accept` to it once; every lane ends with the same best.
//
// That equals an `accept` of every slot in ascending id order. Let m be
// the least candidate t and i the lowest id with t = m. Sequentially, best
// t only falls, and a candidate replaces the best only if strictly nearer,
// or as near with a lower id than a triangle that won. If m < best t, the
// first candidate at m (id i) wins and a later one at m has a higher id,
// so the result is (m, i). If m = best t, no candidate is nearer; a
// candidate at m replaces only a won id above its own, and ids ascend, so
// the result is (m, min(best id, i)) when the best id won, and unchanged
// when it is the seed. If m > best t nothing changes. One `accept` of
// (m, i) gives each of the three. Rejected slots carry kMiss, a t like
// any other, in both.
__device__ __forceinline__ void warp_intersect_rows(
    const float* __restrict__ n, const float* __restrict__ e1,
    const float* __restrict__ e2, const float* __restrict__ aux, int base,
    const Ray& r, float t_eps, float& best_t, int& best_id) {
  const int slot = 4 * (threadIdx.x & 31);
  auto row = [slot](const float* p, int k) {
    return __ldg(reinterpret_cast<const float4*>(p + k * kWidth + slot));
  };
  const float4 nx = row(n, 0), ny = row(n, 1), nz = row(n, 2);
  const float4 e1x = row(e1, 0), e1y = row(e1, 1), e1z = row(e1, 2);
  const float4 e2x = row(e2, 0), e2y = row(e2, 1), e2z = row(e2, 2);
  const float4 np1 = row(aux, 0), p1e1 = row(aux, 1), p1e2 = row(aux, 2);
  const float4 ca = row(aux, 3), cb = row(aux, 4), cc = row(aux, 5);
  float t = kMiss;
  int id = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float tj = tri_hit(
        r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, component(nx, j), component(ny, j),
        component(nz, j), component(e1x, j), component(e1y, j), component(e1z, j),
        component(e2x, j), component(e2y, j), component(e2z, j), component(np1, j),
        component(p1e1, j), component(p1e2, j), component(ca, j), component(cb, j),
        component(cc, j), t_eps);
    if (j == 0 || tj < t) {  // ascending ids: a tie keeps the lower
      t = tj;
      id = base + slot + j;
    }
  }
  warp_min_hit(t, id);
  accept(t, id, best_t, best_id);
}

// One (16, 128) cluster tile of the VPU layout, by a warp.
__device__ __forceinline__ void warp_intersect_tile(
    const float* __restrict__ tile, int base, const Ray& r, float t_eps,
    float& best_t, int& best_id) {
  warp_intersect_rows(tile, tile + 3 * kWidth, tile + 6 * kWidth, tile + 9 * kWidth,
                      base, r, t_eps, best_t, best_id);
}

// One MXU tile pair (accel/cluster.py `with_mxu_tiles`), by a warp: W1
// holds n in rows 0-2 and e1 in rows 8-10, W2 holds e2 in rows 0-2 and np1
// p1e1 p1e2 ca cb cc in rows 8-13. The TPU kernels form the six dot
// products as matmuls of [d; o] against W1 and W2; here each is the same
// IEEE f32 sum `tri_hit` forms from the VPU layout, so the two layouts
// give the same bits.
__device__ __forceinline__ void warp_intersect_tile_mxu(
    const float* __restrict__ w1, const float* __restrict__ w2, int base,
    const Ray& r, float t_eps, float& best_t, int& best_id) {
  warp_intersect_rows(w1, w1 + 8 * kWidth, w2, w2 + 8 * kWidth, base, r, t_eps,
                      best_t, best_id);
}

// Slab test of one box (min xyz, max xyz) against a ray. Returns whether
// the ray pierces it and, if so, the entry distance clamped at 0.
// Conservative under NaN, as the Pallas kernels: an origin on a slab with
// a zero direction component gives 0 * inf = NaN, every comparison with
// NaN is false, so the box counts as pierced and its entry is 0 (visit
// first). jnp.minimum/maximum propagate NaN where fminf/fmaxf drop it, so
// the NaN case is decided before them.
__device__ __forceinline__ bool slab(
    float bx0, float by0, float bz0, float bx1, float by1, float bz1,
    const Ray& r, float t_eps, float& entry) {
  const float t1x = (bx0 - r.ox) * r.ix, t2x = (bx1 - r.ox) * r.ix;
  const float t1y = (by0 - r.oy) * r.iy, t2y = (by1 - r.oy) * r.iy;
  const float t1z = (bz0 - r.oz) * r.iz, t2z = (bz1 - r.oz) * r.iz;
  if ((t1x != t1x) | (t2x != t2x) | (t1y != t1y) | (t2y != t2y) |
      (t1z != t1z) | (t2z != t2z)) {
    entry = 0.0f;
    return true;
  }
  const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  if ((near > far) | (far < t_eps)) return false;
  entry = fmaxf(near, 0.0f);
  return true;
}

}  // namespace isaklm
