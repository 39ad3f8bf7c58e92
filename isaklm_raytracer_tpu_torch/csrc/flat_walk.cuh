// The staged walk that the flat intersectors share (`flat_kernel`, which
// flat_intersect.cu runs over the cluster tiles and flat_mxu_intersect.cu
// over the MXU tile pairs): one thread walks one ray through every slot of
// the scene's real clusters in id order.
//
// Contract (the same as the TPU kernels' output, not their packet schedule):
//   table   the first `num_clusters` clusters of a flat layout (below)
//   rays    (R, 8) f32, columns [ox oy oz dx dy dz active t_max]
//   out_t   (R,) f32: the best t, or t_max when no triangle beat it
//   out_id  (R,) i32: the winning id c*128 + lane, or 2^31-1 (no winner)
// Per ray the running best starts at (t_max, 2^31-1) and the triangles are
// walked in id order with a strict `<` update of the candidate t (`tri_hit`
// of intersect_common.cuh: s, or kMiss when the test rejects the slot), so
// ties go to the lowest id. The libraries are built with --fmad=false so
// that every product and sum rounds as in the plain PyTorch version, which
// makes the two agree bit for bit.
//
// A flat layout says where the 15 constants of a slot lie: constant k (0-14,
// the rows of `tri_hit`: n, e1, e2, n.p1, p1.e1, p1.e2 and the three Cramer
// coefficients) of slot `lane` of cluster c is
//   table[c * Layout::kClusterFloats + Layout::row(k) * kWidth + lane].
// It provides those two as compile-time constants; the walk reads nothing
// else of the layout, so both layouts give the same bits.
//
// What bounds it on the H100: issue slots, not bytes (a 6-cluster table is
// 48 KB, a ray 32 bytes). The full test is some 50 issue slots a (ray,
// slot) pair, an IEEE division among them, and most pairs cannot change
// the result: pad slots, planes behind the ray, planes hit beyond the
// ray's running best. The TPU kernels run the full test on every pair as
// one straight-line vector program. Here one thread walks one ray, and
// each block of 128 rays stages ONE cluster at a time in shared memory,
// transposed to triangle-major so a thread reads a triangle's constants
// as 16-byte broadcasts (all threads of a warp read the same triangle at
// the same time). Each slot is tested in three stages, and a pair stops at
// the first that rules it out:
//   1. plane: ddn = d.n, odn = o.n, num = n.p1 - odn, about 10 slots, no
//      division. Rejects ddn == 0, num == 0, and num and ddn of opposite
//      signs, tested as (num > 0) != (ddn > 0) on ordered operands (never
//      num * ddn, which underflows to 0 for small operands of one sign);
//   2. window: s = num / ddn; rejects !(s >= t_eps) and !(s < best_t);
//   3. edge: the barycentrics and the inside test, with the operations of
//      `tri_hit` in its order, so every value rounds as there.
// Inactive rays skip the arithmetic but still help stage the tiles; a
// block whose rays are all inactive returns at once. Trailing pad slots of
// a tile (all 15 constants zero), found while staging, are not visited.
//
// Why the stages change no result. The full walk's update `tval < best_t`
// changes the best only if the slot is valid (ddn != 0, s >= t_eps, inside)
// with s < best_t, or if it is rejected and kMiss < best_t. The stages run
// only while t_eps > 0 and best_t <= kMiss; then a rejected slot never
// changes the best, and a valid one with s < best_t passes every stage:
//   - ddn == 0 is rejected by `tri_hit` too;
//   - num == 0 (ddn != 0) gives s = +-0 < t_eps;
//   - opposite signs, both nonzero and ordered, give s = num / ddn <= 0
//     (negative, -0 when the quotient underflows, or -inf) < t_eps;
//   - a NaN in num or ddn passes the plane stage and gives s = NaN, which
//     `!(s >= t_eps)` rejects as `tri_hit` does;
//   - s, the edge values and the inside test are `tri_hit`'s own, operand
//     for operand, and a surviving slot is valid exactly when inside.
// A pad slot (all zeros) gives ddn = +-0, or NaN for a non-finite
// direction: rejected, so skipping the trailing ones changes nothing.
// Outside those conditions every slot takes the full `tri_hit`:
//   - t_eps <= 0 (or NaN): s = 0 and s < 0 may be valid;
//   - best_t > kMiss (a ray whose t_max exceeds 3.4e38, e.g. +inf): a
//     rejected slot's kMiss beats it, so the first rejected slot gives
//     (kMiss, its id), as the plain version does; best_t then stays at
//     most kMiss unless a valid s above it won;
//   - best_t NaN: no update ever happens, as in the plain version.
// best_t only falls, so once the stages apply they apply to the rest of
// the ray's walk.
//
// Divergence: each lane leaves a stage on its own (per-lane branches), and
// a warp runs a stage when any of its rays needs it. Where the warp's rays
// point different ways (bounce rays into a hemisphere, random rays) some
// ray needs the division and the edges at nearly every slot; measured, the
// stages still cost no more than the full test there, and save a quarter
// to a third of it on the render's Morton-ordered camera and NEE rays
// (PERF.md, section 6), so every warp takes them. A ray outside the
// stages' conditions at the start of a tile runs the full test through it.

#pragma once

#include "intersect_common.cuh"

namespace isaklm {

constexpr int kFlatRows = 15;      // constants a slot's test reads
constexpr int kFlatThreads = 128;  // rays per block
constexpr int kFlatWarps = kFlatThreads / 32;
static_assert(kFlatThreads == kWidth, "thread t stages slot t of each cluster");

// The flat kernel over a layout. The template is the kernel itself, its
// shared memory declared in it: ptxas gave the same body, inlined into a
// kernel of each source, other instructions for the cluster tiles, while
// `flat_kernel<TileLayout>` compiles to the flat kernel's own.
template <class Layout>
__global__ void __launch_bounds__(kFlatThreads)
flat_kernel(const float* __restrict__ table, int num_clusters, const float* __restrict__ rays,
            int num_rays, float t_eps, float* __restrict__ out_t, int* __restrict__ out_id) {
  // Triangle-major tile: slot `lane` holds its 15 constants at
  // [lane * 16, lane * 16 + 15), 16-byte aligned for float4 reads.
  __shared__ __align__(16) float tile[kWidth * kTileRows];
  // per warp: 1 + the last slot of its 32 with a nonzero constant, or 0
  __shared__ int warp_used[kFlatWarps];

  const int r = blockIdx.x * kFlatThreads + threadIdx.x;
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
  const bool staged = t_eps > 0.0f;  // else every slot takes the full test
  float best_t = d4.w;
  int best_id = kBigId;

  if (__syncthreads_or(active)) {
    for (int c = 0; c < num_clusters; ++c) {
      const float* src = table + (int64_t)c * Layout::kClusterFloats;
      __syncthreads();  // every thread is done with the previous tile
      bool nonzero = false;
#pragma unroll
      for (int k = 0; k < kFlatRows; ++k) {
        const float v = src[Layout::row(k) * kWidth + threadIdx.x];
        tile[threadIdx.x * kTileRows + k] = v;
        nonzero |= v != 0.0f;
      }
      const int used_here = __reduce_max_sync(kFullMask, nonzero ? threadIdx.x + 1 : 0);
      if ((threadIdx.x & 31) == 0) warp_used[threadIdx.x >> 5] = used_here;
      __syncthreads();
      if (!active) continue;
      int used = 0;  // slots [used, 128) are pad slots
#pragma unroll
      for (int w = 0; w < kFlatWarps; ++w) used = max(used, warp_used[w]);

      if (!(staged && best_t <= kMiss)) {  // the full test, as the plain version runs it
        for (int lane = 0; lane < kWidth; ++lane) {
          const float4* q = reinterpret_cast<const float4*>(tile + lane * kTileRows);
          const float4 a = q[0], b = q[1], e = q[2], f = q[3];
          const float tval = tri_hit(ox, oy, oz, dx, dy, dz, a.x, a.y, a.z, a.w, b.x, b.y, b.z,
                                     b.w, e.x, e.y, e.z, e.w, f.x, f.y, f.z, t_eps);
          if (tval < best_t) {
            best_t = tval;
            best_id = c * kWidth + lane;
          }
        }
        continue;
      }
      for (int lane = 0; lane < used; ++lane) {  // the stages; the rest are pad slots
        const float4* q = reinterpret_cast<const float4*>(tile + lane * kTileRows);
        // 1. plane
        const float4 a = q[0], e = q[2];  // nx ny nz e1x; e2z np1 p1e1 p1e2
        const float ddn = dx * a.x + dy * a.y + dz * a.z;
        const float odn = ox * a.x + oy * a.y + oz * a.z;
        const float num = e.y - odn;
        if ((num == num) & (ddn == ddn) &
            ((ddn == 0.0f) | (num == 0.0f) | ((num > 0.0f) != (ddn > 0.0f)))) {
          continue;
        }
        // 2. window
        const float s = num / ddn;
        if (!(s >= t_eps) || !(s < best_t)) continue;
        // 3. edges, as tri_hit
        const float4 b = q[1], f = q[3];  // e1y e1z e2x e2y; ca cb cc -
        const float de1 = dx * a.w + dy * b.x + dz * b.y;
        const float oe1 = ox * a.w + oy * b.x + oz * b.y;
        const float d20 = oe1 + s * de1 - e.z;
        const float de2 = dx * b.z + dy * b.w + dz * e.x;
        const float oe2 = ox * b.z + oy * b.w + oz * e.x;
        const float d21 = oe2 + s * de2 - e.w;
        const float bb = d20 * f.x - d21 * f.y;
        const float c3 = d21 * f.z - d20 * f.y;
        const float aa = 1.0f - bb - c3;
        if ((aa >= 0.0f) & (aa <= 1.0f) & (bb >= 0.0f) & (bb <= 1.0f) & (c3 >= 0.0f) &
            (c3 <= 1.0f)) {
          best_t = s;
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

// Launches `flat_kernel<Layout>` on `stream` of `device`, one thread a ray.
// Returns cudaGetLastError() (0 = launched). Allocates nothing and does not
// synchronise.
template <class Layout>
int launch_flat(int device, const float* table, int num_clusters, const float* rays,
                int num_rays, float t_eps, float* out_t, int* out_id, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kFlatThreads - 1) / kFlatThreads;
    flat_kernel<Layout><<<blocks, kFlatThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, num_clusters, rays, num_rays, t_eps, out_t, out_id);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace isaklm
