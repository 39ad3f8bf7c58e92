// KD-tree nearest-hit walk for Hopper (sm_90a): one thread a ray in
// persistent warps, the triangles' constants read from a table built once a
// scene.
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
//   (a) chunk rows: leaf_first (K,), chunk_next (C,), chunk_tri (C, L)
//       (triangle ids, -1 pad) (accel/wavefront.py);
//   (b) the tree's lists: tri_indices (I,), each leaf's (offset, count) in
//       its node's (child_a, child_b);
//   and the table (N,) of 80-byte records indexed by triangle id
//   (tri_test.cuh; `WavefrontKD.tri_table`, `KDTreeArrays.tri_table`).
//
// What bounds it on the H100: issue slots, those of the node steps and of
// the triangle tests a ray makes (chip_smoke.py counts them from the
// plain versions' stats); its table reads are a few bytes a step, mostly
// from L1 and L2. The design against what held the first version back:
//   - a test reads five 16-byte words of its triangle's record
//     (tri_test.cuh) and runs `tri_t` alone: the normal's square root, the
//     two divisions and the nine scalar loads of `make_tri` left the walk
//     for the table kernel (tri_consts.cu), which runs once a scene. The
//     records are one a triangle, read through the ids of both layouts: a
//     table one a chunk slot (5.3x as many records on the 20k hero, 93 MB
//     against L2's 50) walked 17-20% slower;
//   - the walk is while-while (Aila & Laine 2009): a ray descends inner
//     nodes until it reaches a leaf, and the leaf's tests run after, so
//     the lanes of a warp test triangles together instead of one lane
//     testing while its neighbours step through nodes;
//   - a stack entry is one 16-byte record (node, entry, exit), pushed and
//     popped by one local access, in kKdStack slots (a second instantiation
//     with 32 slots for shallower trees timed the same on the 20k hero's
//     wavefronts, PERF.md section 6);
//   - the leaf row of the default width 8 is unrolled (a loop for other
//     widths).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_test.cuh"

namespace {

using namespace isaklm;

constexpr int kKdThreads = 128;  // threads (rays) a block
constexpr int kKdStack = 64;  // stack slots: the most a tree's depth may need
constexpr unsigned kFullWarp = 0xffffffffu;
// the layouts: the tree's lists, the chunk rows
constexpr int kTree = 0, kChunks = 1;
// a warp takes new rays once this many of its lanes are idle (8 walked the
// 20k hero's bounce rays 14% faster than one thread a ray, and a render
// 3.5% faster; 16 and 32 less)
constexpr int kRefill = 8;

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
  const int* leaf_first;   // (a) chunk rows
  const int* chunk_next;   // (a)
  const int* chunk_tri;    // (a)
  const int* tri_indices;  // (b) the tree's lists
  const float4* table;     // (N,) records, one a triangle
  int width;               // (a) slots a chunk row
  int depth;               // stack slots the walk's contract has
};

// One ray's walk: its ray, its best hit, its place in the tree and its
// counts. The stack lives beside it in the kernel's local memory.
struct Walk {
  float o[3], d[3];
  float best_t;
  int best_i;
  int node, sp;
  float entry, exit;
  int steps, rows, tests;
};

// Loads ray r and clips it to the root box: true when it walks.
__device__ __forceinline__ bool start(Walk& w, const Tables& tb, const float* rays, int r) {
  const float4* row = reinterpret_cast<const float4*>(rays + 8 * static_cast<int64_t>(r));
  const float4 ra = row[0], rb = row[1];
  w.o[0] = ra.x; w.o[1] = ra.y; w.o[2] = ra.z;
  w.d[0] = ra.w; w.d[1] = rb.x; w.d[2] = rb.y;
  w.best_t = INFINITY;
  w.best_i = -1;
  w.node = 0;
  w.sp = 0;
  w.steps = w.rows = w.tests = 0;
  float t_near = 0.0f, t_far = -1.0f;
  if (rb.z > 0.0f) {
    float lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = (__ldg(tb.bbox_min + k) - w.o[k]) / w.d[k];
      const float b = (__ldg(tb.bbox_max + k) - w.o[k]) / w.d[k];
      lo[k] = min_nan(a, b);
      hi[k] = max_nan(a, b);
    }
    t_near = max_nan(max_nan(lo[0], lo[1]), lo[2]);
    t_far = min_nan(min_nan(hi[0], hi[1]), hi[2]);
  }
  w.entry = t_near;
  w.exit = t_far;
  return t_near <= t_far;  // false for a NaN, as in the plain versions
}

// One record's test against the walk's ray, into (best_s, best_id) when
// strictly nearer (the caller skips an empty slot, id < 0).
__device__ __forceinline__ void test_record(Walk& w, const float4* rec, int id, float t_eps,
                                            float& best_s, int& best_id) {
  ++w.tests;
  const TriConsts c = unpack_tri(__ldg(rec), __ldg(rec + 1), __ldg(rec + 2), __ldg(rec + 3),
                                 __ldg(rec + 4));
  const float s = tri_t(c, w.o[0], w.o[1], w.o[2], w.d[0], w.d[1], w.d[2], t_eps);
  if (s < best_s) {
    best_s = s;
    best_id = id;
  }
}

// One leg of the walk: inner nodes down to a leaf, the leaf's tests, then
// return (true: the walk ended) or pop the next cell (false).
template <int kLayout, int kWidth>
__device__ __forceinline__ bool advance(Walk& w, float4* stack, const Tables& tb,
                                        float t_eps) {
  int4 nd = __ldg(tb.nodes + w.node);
  while (!(nd.z & 4)) {  // inner node: descend one level
    ++w.steps;
    const int ax = nd.z & 3;
    const float plane = __int_as_float(nd.w);
    const float o_ax = ax == 0 ? w.o[0] : (ax == 1 ? w.o[1] : w.o[2]);
    const float d_ax = ax == 0 ? w.d[0] : (ax == 1 ? w.d[1] : w.d[2]);
    const bool behind = (o_ax > plane) | ((o_ax == plane) & (d_ax < 0.0f));
    const int near = behind ? nd.y : nd.x;
    const int far = behind ? nd.x : nd.y;
    const float t_plane = (plane - o_ax) / d_ax;
    const bool near_only = (t_plane >= w.exit) | (t_plane < 0.0f) | (t_plane != t_plane);
    const bool far_only = !near_only & (t_plane <= w.entry);
    if (!near_only & !far_only) {
      if (w.sp < tb.depth) stack[w.sp] = make_float4(__int_as_float(far), t_plane, w.exit, 0.0f);
      w.sp = kLayout != kTree ? min(w.sp + 1, tb.depth - 1) : w.sp + 1;
      w.node = near;
      w.exit = t_plane;
    } else {
      w.node = far_only ? far : near;
    }
    nd = __ldg(tb.nodes + w.node);
  }
  if (kLayout != kTree) {  // the leaf's chain of rows
    for (int c = __ldg(tb.leaf_first + w.node); c >= 0; c = __ldg(tb.chunk_next + c)) {
      ++w.rows;
      float row_t = fminf(w.exit, w.best_t);
      int row_i = -1;
      const int width = kWidth > 0 ? kWidth : tb.width;
      const int* ids = tb.chunk_tri + static_cast<int64_t>(c) * width;
#pragma unroll
      for (int slot = 0; slot < (kWidth > 0 ? kWidth : width); ++slot) {
        const int id = __ldg(ids + slot);
        if (id >= 0)
          test_record(w, tb.table + static_cast<int64_t>(id) * kRecordWords, id, t_eps, row_t,
                      row_i);
      }
      if (row_i >= 0) {
        w.best_t = row_t;
        w.best_i = row_i;
      }
    }
  } else {  // the leaf's own list, strictly before exit
    ++w.rows;
    float leaf_t = w.exit;
    int leaf_i = -1;
    for (int k = 0; k < nd.y; ++k) {
      const int id = __ldg(tb.tri_indices + nd.x + k);
      test_record(w, tb.table + static_cast<int64_t>(id) * kRecordWords, id, t_eps, leaf_t,
                  leaf_i);
    }
    if (leaf_i >= 0) {
      w.best_t = leaf_t;
      w.best_i = leaf_i;
    }
  }
  if (w.best_i >= 0 || w.sp == 0) return true;  // the first leaf with a hit returns
  --w.sp;
  const float4 top = stack[min(w.sp, tb.depth - 1)];
  w.node = __float_as_int(top.x);
  w.entry = top.y;
  w.exit = top.z;
  return false;
}

__device__ __forceinline__ void finish(const Walk& w, int r, float* out_t, int* out_id,
                                       int* stats) {
  out_t[r] = w.best_i >= 0 ? w.best_t : INFINITY;
  out_id[r] = w.best_i;
  if (stats != nullptr) {
    stats[3 * static_cast<int64_t>(r)] = w.steps;
    stats[3 * static_cast<int64_t>(r) + 1] = w.rows;
    stats[3 * static_cast<int64_t>(r) + 2] = w.tests;
  }
}

// Persistent warps over the rays (Aila & Laine 2009): a grid that fills
// the card once; the idle lanes of a warp take the next rays from the
// counter `next_ray` once kRefill of them (or all) are idle, so a lane
// whose ray ended early walks another instead of idling until the warp's
// longest ray ends.
template <int kLayout, int kWidth>
__global__ void __launch_bounds__(kKdThreads)
kd_intersect_kernel(Tables tb, const float* __restrict__ rays, int num_rays, float t_eps,
                    float* __restrict__ out_t, int* __restrict__ out_id,
                    int* __restrict__ stats, int* __restrict__ next_ray) {
  const unsigned lane = threadIdx.x & 31;
  float4 stack[kKdStack];
  Walk w;
  int r = 0;
  bool walking = false, drained = false;
  while (true) {
    const unsigned idle = __ballot_sync(kFullWarp, !walking & !drained);
    if (__popc(idle) >= kRefill || (idle != 0 && !__any_sync(kFullWarp, walking))) {
      const int leader = __ffs(idle) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(next_ray, __popc(idle));
      base = __shfl_sync(kFullWarp, base, leader);
      if (!walking & !drained) {
        r = base + __popc(idle & ((1u << lane) - 1));
        drained = r >= num_rays;
        if (!drained) {
          walking = start(w, tb, rays, r);
          if (!walking) finish(w, r, out_t, out_id, stats);
        }
      }
    }
    if (__all_sync(kFullWarp, drained)) break;
    if (walking && advance<kLayout, kWidth>(w, stack, tb, t_eps)) {
      finish(w, r, out_t, out_id, stats);
      walking = false;
    }
  }
}

template <int kLayout, int kWidth>
cudaError_t launch(const Tables& tb, const float* rays, int num_rays, float t_eps, float* out_t,
                   int* out_id, int* stats, int* next_ray, cudaStream_t s) {
  // the blocks that fill the card, found at the first launch (a graph
  // step's first call runs eagerly, so never inside a capture); every card
  // of a process is taken for the first one's kind: the grid's size sets
  // the speed, not the result
  static int blocks_per_card = 0;
  if (blocks_per_card == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kd_intersect_kernel<kLayout, kWidth>, kKdThreads, 0);
    if (err != cudaSuccess) return err;
    blocks_per_card = sms * per_sm;
  }
  const cudaError_t err = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  const int needed = (num_rays + kKdThreads - 1) / kKdThreads;
  kd_intersect_kernel<kLayout, kWidth>
      <<<blocks_per_card < needed ? blocks_per_card : needed, kKdThreads, 0, s>>>(
          tb, rays, num_rays, t_eps, out_t, out_id, stats, next_ray);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). `chunks` picks the layout: 1 = chunk rows (leaf_first,
// chunk_next, chunk_tri and their width), 0 = the tree's lists
// (tri_indices); the other layout's pointers are ignored. `table` (N, 20)
// float32, 16-byte aligned, holds the records of both. `stats` may be
// null. `next_ray` is one int of scratch on the card (the persistent
// warps' counter, zeroed here on the stream). Allocates nothing and does
// not synchronise.
extern "C" int kd_intersect(int device, const int* nodes, const float* bbox_min,
                            const float* bbox_max, int chunks, const int* leaf_first,
                            const int* chunk_next, const int* chunk_tri,
                            const int* tri_indices, const float* table, int width, int depth,
                            const float* rays, int num_rays, float t_eps, float* out_t,
                            int* out_id, int* stats, int* next_ray, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (depth < 1 || depth > kKdStack) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rays <= 0) return static_cast<int>(cudaGetLastError());
  const Tables tb{reinterpret_cast<const int4*>(nodes), bbox_min, bbox_max, leaf_first,
                  chunk_next, chunk_tri, tri_indices, reinterpret_cast<const float4*>(table),
                  width, depth};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t launched;
  if (!chunks) {
    launched = launch<kTree, 0>(tb, rays, num_rays, t_eps, out_t, out_id, stats, next_ray, s);
  } else if (width == 8) {
    launched = launch<kChunks, 8>(tb, rays, num_rays, t_eps, out_t, out_id, stats, next_ray, s);
  } else {
    launched = launch<kChunks, 0>(tb, rays, num_rays, t_eps, out_t, out_id, stats, next_ray, s);
  }
  return static_cast<int>(launched);
}
