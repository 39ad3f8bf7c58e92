// The ray/triangle test of the KD walk (kd_intersect.cu) and the brute-force
// kernel (brute_intersect.cu).
//
// Port of the test that the JAX package's KD walks and brute-force oracle
// share (accel/kd_traverse.py:39-73, accel/wavefront.py:126-162,
// accel/traverse.py:29-47; reference trace_ray.cuh:73-113): the unit
// normal, the plane distance, Cramer's barycentrics and the inside test.
// `make_tri` forms what depends on the triangle alone, `tri_t` the rest;
// together they form every product and sum of `tri_hits`
// (accel/wavefront.py) and `nearest_hit_brute` (accel/traverse.py) in the
// same order, so under --fmad=false the kernels equal those plain versions
// bit for bit. The normal is scaled by 1.0f / sqrtf (correctly rounded:
// nvcc's default -prec-div and -prec-sqrt), as the plain versions' 1 /
// torch.sqrt; the JAX package's KD walks take XLA's rsqrt there.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace isaklm {

// What the test reads of one triangle: the unit normal n, n.p1, p1, the
// edges e1 = p2 - p1 and e2 = p3 - p1, their dot products and the
// reciprocal of Cramer's denominator.
struct TriConsts {
  float nx, ny, nz, np1;
  float p1x, p1y, p1z;
  float e1x, e1y, e1z;
  float e2x, e2y, e2z;
  float d00, d01, d11, inv_den;
};

__device__ __forceinline__ TriConsts make_tri(float p1x, float p1y, float p1z,
                                              float e1x, float e1y, float e1z,
                                              float e2x, float e2y, float e2z) {
  TriConsts c;
  float nx = e1y * e2z - e1z * e2y;
  float ny = e1z * e2x - e1x * e2z;
  float nz = e1x * e2y - e1y * e2x;
  float nn = nx * nx + ny * ny + nz * nz;
  nn = nn < 1e-30f ? 1e-30f : nn;  // torch.clamp_min: a NaN stays NaN
  const float inv = 1.0f / sqrtf(nn);
  c.nx = nx * inv;
  c.ny = ny * inv;
  c.nz = nz * inv;
  c.np1 = c.nx * p1x + c.ny * p1y + c.nz * p1z;
  c.p1x = p1x; c.p1y = p1y; c.p1z = p1z;
  c.e1x = e1x; c.e1y = e1y; c.e1z = e1z;
  c.e2x = e2x; c.e2y = e2y; c.e2z = e2z;
  c.d00 = e1x * e1x + e1y * e1y + e1z * e1z;
  c.d01 = e1x * e2x + e1y * e2y + e1z * e2z;
  c.d11 = e2x * e2x + e2y * e2y + e2z * e2z;
  c.inv_den = 1.0f / (c.d00 * c.d11 - c.d01 * c.d01);
  return c;
}

// The plane distance s of the ray (o, d) on the triangle when the ray
// hits it at s >= t_eps (ddn != 0, barycentrics all in [0, 1]), +inf
// when it does not.
__device__ __forceinline__ float tri_t(const TriConsts& c, float ox, float oy, float oz,
                                       float dx, float dy, float dz, float t_eps) {
  const float ddn = dx * c.nx + dy * c.ny + dz * c.nz;
  const float s = (c.np1 - (ox * c.nx + oy * c.ny + oz * c.nz)) / ddn;
  const float v2x = ox + s * dx - c.p1x;
  const float v2y = oy + s * dy - c.p1y;
  const float v2z = oz + s * dz - c.p1z;
  const float d20 = v2x * c.e1x + v2y * c.e1y + v2z * c.e1z;
  const float d21 = v2x * c.e2x + v2y * c.e2y + v2z * c.e2z;
  const float b = (c.d11 * d20 - c.d01 * d21) * c.inv_den;
  const float cc = (c.d00 * d21 - c.d01 * d20) * c.inv_den;
  const float a = 1.0f - b - cc;
  const bool inside = (a >= 0.0f) & (a <= 1.0f) & (b >= 0.0f) & (b <= 1.0f) &
                      (cc >= 0.0f) & (cc <= 1.0f);
  return (ddn != 0.0f) & (s >= t_eps) & inside ? s : INFINITY;
}

}  // namespace isaklm
