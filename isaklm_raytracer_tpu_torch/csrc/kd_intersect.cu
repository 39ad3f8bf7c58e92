// KD-tree nearest-hit walk for Hopper (sm_90a): one thread a ray, a short
// stack in local memory.
//
// Replaces no Pallas kernel. It computes two jnp functions of the JAX
// package, each with its contract: `nearest_hit_wavefront`
// (isaklm_raytracer_tpu/accel/wavefront.py:165), the walk over the tree's
// leaves re-laid out in chunk rows, and `nearest_hit_kd`
// (accel/kd_traverse.py:198), the walk over the tree's own triangle lists.
// Both re-derive the reference's per-thread walk (trace_ray.cuh:244-318),
// which this kernel follows: the JAX package's lockstep over all rays is a
// layout for the TPU's vector unit, and on this card each thread walks its
// own ray. The plain versions (`wavefront_plain`, `kd_plain`) are the
// lockstep, and each layout equals its own plain version bit for bit.
//
// Contract, per ray of the (R, 8) [ox oy oz dx dy dz active t_max] layout:
//   - out_t = the hit's t, out_id = its triangle id; +inf and -1 for a miss
//     and for an inactive ray. t_max is ignored, as in both JAX functions;
//   - the root box's slab test divides by d (IEEE infinities) and lets a
//     NaN through min and max (min.NaN/max.NaN, as jnp.minimum/jnp.max),
//     so a ray whose origin lies on the padded box's face with a zero
//     direction component misses;
//   - at an inner node: behind = o > plane | (o == plane & d < 0) picks
//     the near child; a NaN t_plane goes to the near child only; near-only
//     is decided before far-only; a straddling ray pushes the far cell;
//   - at a leaf: the nearest triangle strictly before min(exit, best t),
//     the first slot on ties; the first leaf with a hit returns; a leaf
//     without one pops, and a pop from an empty stack ends the walk;
//   - the stack has depth = max_depth + 2 slots. The chunk layout clamps
//     the pointer at depth - 1 on a push (wavefront.py:246); the tree
//     layout does not (kd_traverse.py:144-157): its push past the last
//     slot is dropped and its pop past it reads the last slot, as JAX's
//     scatter and gather do. Neither happens for a tree built to max_depth,
//     which pushes at most max_depth + 1 cells.
//   - stats (optional, (R, 3) int32): inner-node steps, leaf rows (chunk
//     rows scanned; leaves visited in the tree layout), triangle tests.
//
// Layouts:
//   nodes (K, 4) int32 rows [child_a, child_b, axis | leaf << 2, plane's
//   bits] (scene/types.py pack_kd_nodes), one 16-byte load a node; then
//   (a) chunk rows: leaf_first (K,), chunk_next (C,), chunk_tri (C, L),
//       chunk_data (C, L, 9) p1 | e1 | e2 (accel/wavefront.py);
//   (b) the tree's lists: tri_indices (I,) and vertices (N, 3, 3), each
//       leaf's (offset, count) in its node's (child_a, child_b).
//
// What bounds it on the H100: issue slots, those of the node steps and of
// the triangle tests a ray makes (chip_smoke.py counts them from the
// plain versions' stats); its table reads are a few bytes a step, mostly
// from L2. This first version accepts warp divergence (the rays of a warp
// walk different paths and leave at different steps) and a stack in local
// memory; a warp-cooperative or packet walk, a shared-memory top of the
// tree and triangles precomputed per leaf row are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_test.cuh"

namespace {

using namespace isaklm;

constexpr int kKdStack = 64;     // stack slots a thread: depth must fit
constexpr int kKdThreads = 128;  // threads (rays) a block

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

struct Tables {
  const int4* nodes;
  const float* bbox_min;
  const float* bbox_max;
  // (a) chunk rows
  const int* leaf_first;
  const int* chunk_next;
  const int* chunk_tri;
  const float* chunk_data;
  int width;
  // (b) the tree's lists
  const int* tri_indices;
  const float* vertices;
};

template <bool kChunks>
__global__ void __launch_bounds__(kKdThreads)
kd_intersect_kernel(Tables tb, const float* __restrict__ rays, int num_rays, float t_eps,
                    int depth, float* __restrict__ out_t, int* __restrict__ out_id,
                    int* __restrict__ stats) {
  const int r = blockIdx.x * kKdThreads + threadIdx.x;
  if (r >= num_rays) return;
  const float4* row = reinterpret_cast<const float4*>(rays + 8 * static_cast<int64_t>(r));
  const float4 ra = row[0], rb = row[1];
  const float o[3] = {ra.x, ra.y, ra.z};
  const float d[3] = {ra.w, rb.x, rb.y};
  float best_t = INFINITY;
  int best_i = -1;
  int steps = 0, leaf_rows = 0, tests = 0;

  float t_near = 0.0f, t_far = -1.0f;
  if (rb.z > 0.0f) {
    float lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = (__ldg(tb.bbox_min + k) - o[k]) / d[k];
      const float b = (__ldg(tb.bbox_max + k) - o[k]) / d[k];
      lo[k] = min_nan(a, b);
      hi[k] = max_nan(a, b);
    }
    t_near = max_nan(max_nan(lo[0], lo[1]), lo[2]);
    t_far = min_nan(min_nan(hi[0], hi[1]), hi[2]);
  }
  if (t_near <= t_far) {  // false for a NaN, as in the plain versions
    int st_node[kKdStack];
    float st_entry[kKdStack], st_exit[kKdStack];
    int node = 0, sp = 0;
    float entry = t_near, exit = t_far;
    while (true) {
      const int4 nd = __ldg(tb.nodes + node);
      if (!(nd.z & 4)) {  // inner node: descend one level
        ++steps;
        const int ax = nd.z & 3;
        const float plane = __int_as_float(nd.w);
        const float o_ax = o[ax], d_ax = d[ax];
        const bool behind = (o_ax > plane) | ((o_ax == plane) & (d_ax < 0.0f));
        const int near = behind ? nd.y : nd.x;
        const int far = behind ? nd.x : nd.y;
        const float t_plane = (plane - o_ax) / d_ax;
        const bool near_only = (t_plane >= exit) | (t_plane < 0.0f) | (t_plane != t_plane);
        const bool far_only = !near_only & (t_plane <= entry);
        if (!near_only & !far_only) {
          if (sp < depth) {
            st_node[sp] = far;
            st_entry[sp] = t_plane;
            st_exit[sp] = exit;
          }
          sp = kChunks ? min(sp + 1, depth - 1) : sp + 1;
          node = near;
          exit = t_plane;
        } else {
          node = far_only ? far : near;
        }
        continue;
      }
      if (kChunks) {  // the leaf's chain of rows
        for (int c = __ldg(tb.leaf_first + node); c >= 0; c = __ldg(tb.chunk_next + c)) {
          ++leaf_rows;
          float row_t = fminf(exit, best_t);
          int row_i = -1;
          for (int slot = 0; slot < tb.width; ++slot) {
            const int64_t at = static_cast<int64_t>(c) * tb.width + slot;
            const int id = __ldg(tb.chunk_tri + at);
            if (id < 0) continue;
            ++tests;
            const float* p = tb.chunk_data + 9 * at;
            const TriConsts tri = make_tri(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
                                           __ldg(p + 4), __ldg(p + 5), __ldg(p + 6),
                                           __ldg(p + 7), __ldg(p + 8));
            const float s = tri_t(tri, o[0], o[1], o[2], d[0], d[1], d[2], t_eps);
            if (s < row_t) {
              row_t = s;
              row_i = id;
            }
          }
          if (row_i >= 0) {
            best_t = row_t;
            best_i = row_i;
          }
        }
      } else {  // the leaf's own list, strictly before exit
        ++leaf_rows;
        float leaf_t = exit;
        int leaf_i = -1;
        for (int k = 0; k < nd.y; ++k) {
          ++tests;
          const int id = __ldg(tb.tri_indices + nd.x + k);
          const float* p = tb.vertices + 9 * static_cast<int64_t>(id);
          const float p1x = __ldg(p), p1y = __ldg(p + 1), p1z = __ldg(p + 2);
          const TriConsts tri = make_tri(p1x, p1y, p1z, __ldg(p + 3) - p1x,
                                         __ldg(p + 4) - p1y, __ldg(p + 5) - p1z,
                                         __ldg(p + 6) - p1x, __ldg(p + 7) - p1y,
                                         __ldg(p + 8) - p1z);
          const float s = tri_t(tri, o[0], o[1], o[2], d[0], d[1], d[2], t_eps);
          if (s < leaf_t) {
            leaf_t = s;
            leaf_i = id;
          }
        }
        if (leaf_i >= 0) {
          best_t = leaf_t;
          best_i = leaf_i;
        }
      }
      if (best_i >= 0 || sp == 0) break;  // the first leaf with a hit returns
      --sp;
      const int k = min(sp, depth - 1);
      node = st_node[k];
      entry = st_entry[k];
      exit = st_exit[k];
    }
  }
  out_t[r] = best_i >= 0 ? best_t : INFINITY;
  out_id[r] = best_i;
  if (stats != nullptr) {
    stats[3 * static_cast<int64_t>(r)] = steps;
    stats[3 * static_cast<int64_t>(r) + 1] = leaf_rows;
    stats[3 * static_cast<int64_t>(r) + 2] = tests;
  }
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). `chunks` picks the layout: 1 = chunk rows (leaf_first,
// chunk_next, chunk_tri, chunk_data, width), 0 = the tree's lists
// (tri_indices, vertices); the other layout's pointers are ignored.
// `stats` may be null. Allocates nothing and does not synchronise.
extern "C" int kd_intersect(int device, const int* nodes, const float* bbox_min,
                            const float* bbox_max, int chunks, const int* leaf_first,
                            const int* chunk_next, const int* chunk_tri,
                            const float* chunk_data, int width, const int* tri_indices,
                            const float* vertices, int depth, const float* rays, int num_rays,
                            float t_eps, float* out_t, int* out_id, int* stats,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (depth < 1 || depth > kKdStack) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return static_cast<int>(cudaGetLastError());
  const Tables tb{reinterpret_cast<const int4*>(nodes), bbox_min, bbox_max, leaf_first,
                  chunk_next, chunk_tri, chunk_data, width, tri_indices, vertices};
  const dim3 grid((num_rays + kKdThreads - 1) / kKdThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks) {
    kd_intersect_kernel<true><<<grid, kKdThreads, 0, s>>>(tb, rays, num_rays, t_eps, depth,
                                                         out_t, out_id, stats);
  } else {
    kd_intersect_kernel<false><<<grid, kKdThreads, 0, s>>>(tb, rays, num_rays, t_eps, depth,
                                                          out_t, out_id, stats);
  }
  return static_cast<int>(cudaGetLastError());
}
