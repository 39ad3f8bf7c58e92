// The walk over groups of clusters that the queue, blocked, MXU-blocked and
// oct intersectors share (queue_intersect.cu, blk_intersect.cu,
// blk_mxu_intersect.cu, hbm_intersect.cu): one warp walks one ray, its 32
// lanes sharing every part of the walk.
//
// A scene's clusters are cut into groups of consecutive clusters (a single
// cluster, a block of `branch` clusters, or an oct of `oct_branch`), each
// with a box in a component-major (8, stride) table. The walk is front to
// back by an (entry, index) cursor: each step visits the pierced valid
// group with the least (entry, index) after the cursor whose entry is at
// most the ray's best t -- the inclusive bound `m <= tmax` of the TPU
// kernels' loops, per ray instead of per packet. A group behind the cursor
// was visited or had its entry beyond an earlier best t, which only
// shrinks, so the cursor needs no visited set. The steps:
//   1. Group entries, once a ray. A ray's slab entry into a group box never
//      changes during its walk; only its best t and its cursor move. Lane l
//      tests boxes l, l + 32, ... once, reading the table with coalesced
//      loads, and the warp compacts the pierced valid groups, in index
//      order, into its own slice of shared memory as (entry, index) keys.
//   2. Groups front to back. Each step is a warp-wide argmin over the keys
//      after the cursor whose entry is at most the ray's best t: the least
//      (entry, index), ties to the lower index, strictly after the cursor.
//      A step reads count / 32 keys a lane.
//   3. Cull a group. Lane l tests clusters l, l + 32, l + 64 and l + 96 of
//      the group against the best t at that moment (the header rows of a
//      block are read coalesced) and keeps their entries and pierced bits
//      in registers.
//   4. Clusters front to back: a warp argmin of (entry, k) over the pierced
//      clusters whose entry is at most the best t; a cluster whose entry is
//      now behind the best drops out for good. No slab test is repeated.
//   5. Test a cluster: 4 consecutive slots a lane (`warp_intersect_rows`),
//      the warp's least (t, id) applied once to the running best.
// A group of one cluster (a layout with `kOneCluster`) skips steps 3 and 4:
// the cluster's box is the group's, so its entry is the key's, which step 2
// took under the same `entry <= best t` that step 3 would test, with the
// best unchanged in between. Its walk visits and intersects the same
// clusters in the same order, and counts each visit once in each stat.
// All 32 lanes run every loop and every shuffle together: the ray, the
// keys' minima and the running best are the same in every lane.
//
// Each step's minimum is unique (the indices in a key are distinct), so the
// walk's visits and their order are fixed by the ray and the tables, and
// `_group_walk_pruned` (kernels/intersect.py) repeats them with the same
// `stats`.
//
// A group layout says where a cluster's box and constants lie. It provides
//   int size() const: clusters per group (at most 128);
//   Group group(int g) const: the group g, which provides
//     bool entry(int k, const Ray&, float t_eps, float& e) const: whether
//       the ray pierces cluster k of the group, and its entry distance;
//     void intersect(int k, const Ray&, float t_eps, float& best_t,
//       int& best_id) const: the warp's test of cluster k's 128 slots.
// A layout of single clusters instead declares
//   static constexpr bool kOneCluster = true;
// and its Group needs only `intersect` (k is always 0).

#pragma once

#include <type_traits>

#include "intersect_common.cuh"

namespace isaklm {

// Launch shape, measured on the hero (PERF.md, section 6): blocks of 2 warps
// beat 4 and 8 (more blocks fit an SM's shared memory and registers, and a
// block's slowest ray holds fewer warps); the blocked walks take at most 96
// registers a thread (kBlockWalkMinBlocks blocks an SM) without a spill,
// faster than their free 116, and the queue walk, whose lists are as
// short, takes the same cap; the oct walk is bound by its lists' shared
// memory (7 blocks an SM at the hero's 1,952 octs), so it takes no cap.
constexpr int kWalkWarps = 2;                  // rays per block, a warp each
constexpr int kWalkThreads = 32 * kWalkWarps;  // threads per block
constexpr int kBlockWalkMinBlocks = 10;        // 65536 / (10 * 64): 96 registers
constexpr int kSlotsPerLane = kWidth / 32;     // clusters of a group per lane
constexpr unsigned long long kNoKey = ~0ull;

// Shared memory of a walk over `num_groups` groups: one list of keys per
// warp, long enough for a ray that pierces every group.
inline size_t walk_shared_bytes(int num_groups) {
  return sizeof(unsigned long long) * kWalkWarps * static_cast<size_t>(num_groups);
}

// Whether `Layout` declares groups of one cluster (`kOneCluster`).
template <class Layout, class = void>
struct OneCluster : std::false_type {};
template <class Layout>
struct OneCluster<Layout, std::void_t<decltype(Layout::kOneCluster)>>
    : std::bool_constant<Layout::kOneCluster> {};

// The (entry, index) key of a group or cluster. Entries are >= 0 (`slab`
// clamps them at 0) and never NaN, and -0 becomes +0, so the keys order as
// the pairs do: by entry, then by index. Every real key is below kNoKey and
// below 2^63.
__device__ __forceinline__ unsigned long long walk_key(float e, int i) {
  const unsigned bits = e == 0.0f ? 0u : __float_as_uint(e);
  return (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned>(i);
}

__device__ __forceinline__ float key_entry(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(key & 0xFFFFFFFFull);
}

// The least key over the warp's lanes, in every lane.
__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long key) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFullMask, key, offset);
    key = other < key ? other : key;
  }
  return key;
}

// Steps 3-5 of the walk for one group of `size` clusters: the cull, then
// the pierced clusters front to back, each tested by the warp. Adds the
// clusters intersected to `clusters`.
template <class Group>
__device__ __forceinline__ void walk_clusters(const Group& group, int size, const Ray& ray,
                                              float t_eps, float& best_t, int& best_id,
                                              int& clusters) {
  const int lane = threadIdx.x & 31;
  // 3. cull the group's clusters against this ray's own best
  float ce[kSlotsPerLane];
  unsigned pierced = 0;
#pragma unroll
  for (int j = 0; j < kSlotsPerLane; ++j) {
    const int k = lane + 32 * j;
    ce[j] = 0.0f;
    if (k < size && group.entry(k, ray, t_eps, ce[j]) && ce[j] <= best_t) {
      pierced |= 1u << j;
    }
  }

  // 4. the pierced clusters front to back
  while (true) {
    unsigned long long cpick = kNoKey;
#pragma unroll
    for (int j = 0; j < kSlotsPerLane; ++j) {
      if (pierced & (1u << j)) {
        if (ce[j] > best_t) {
          pierced &= ~(1u << j);  // behind the best: never needed again
        } else {
          const unsigned long long key = walk_key(ce[j], lane + 32 * j);
          cpick = key < cpick ? key : cpick;
        }
      }
    }
    cpick = warp_min_key(cpick);
    if (cpick == kNoKey) break;
    const int k = key_index(cpick);
    if ((k & 31) == lane) pierced &= ~(1u << (k >> 5));
    ++clusters;
    group.intersect(k, ray, t_eps, best_t, best_id);  // 5.
  }
}

// The walk of ray r (rays of the (R, 8) layout) by the calling warp over
// the `num_groups` group boxes of the component-major (8, stride) table
// `group_t`, with `list` (num_groups keys) in the warp's shared memory.
// Writes the contract's (t, id) and, when `stats` is not null, the groups
// visited and the clusters intersected.
template <class Layout>
__device__ __forceinline__ void walk_ray(
    const Layout& layout, const float* __restrict__ group_t, int stride, int num_groups,
    const float* __restrict__ rays, int r, float t_eps, float* __restrict__ out_t,
    int* __restrict__ out_id, int* __restrict__ stats, unsigned long long* list) {
  const int lane = threadIdx.x & 31;
  const Ray ray = load_ray(rays, r);
  float best_t = ray.t_max;
  int best_id = kBigId;
  int visits = 0, clusters = 0;
  if (ray.active) {
    // 1. the pierced valid groups, in index order
    int count = 0;
    for (int g0 = 0; g0 < num_groups; g0 += 32) {
      const int g = g0 + lane;
      float e = 0.0f;
      const bool pierced =
          g < num_groups && __ldg(group_t + 6 * stride + g) > 0.0f &&
          slab(__ldg(group_t + g), __ldg(group_t + stride + g), __ldg(group_t + 2 * stride + g),
               __ldg(group_t + 3 * stride + g), __ldg(group_t + 4 * stride + g),
               __ldg(group_t + 5 * stride + g), ray, t_eps, e);
      const unsigned ballot = __ballot_sync(kFullMask, pierced);
      if (pierced) list[count + __popc(ballot & ((1u << lane) - 1u))] = walk_key(e, g);
      count += __popc(ballot);
    }
    __syncwarp();

    // 2. the groups front to back by the (entry, index) cursor
    long long cursor = -1;  // before every key
    while (true) {
      unsigned long long pick = kNoKey;
      for (int i = lane; i < count; i += 32) {
        const unsigned long long key = list[i];
        if (static_cast<long long>(key) > cursor && !(key_entry(key) > best_t) && key < pick) {
          pick = key;
        }
      }
      pick = warp_min_key(pick);
      if (pick == kNoKey) break;
      cursor = static_cast<long long>(pick);
      ++visits;
      const auto group = layout.group(key_index(pick));
      if constexpr (OneCluster<Layout>::value) {
        ++clusters;  // 5. (steps 3 and 4 have one cluster to pick)
        group.intersect(0, ray, t_eps, best_t, best_id);
      } else {
        walk_clusters(group, layout.size(), ray, t_eps, best_t, best_id, clusters);
      }
    }
  }
  if (lane == 0) {
    out_t[r] = best_t;
    out_id[r] = best_id;
    if (stats != nullptr) {
      stats[2 * (int64_t)r] = visits;
      stats[2 * (int64_t)r + 1] = clusters;
    }
  }
}

// The body of a walk kernel: warp w of block b walks ray b * kWalkWarps + w
// with its list in the block's dynamic shared memory.
template <class Layout>
__device__ __forceinline__ void walk(
    const Layout& layout, const float* __restrict__ group_t, int stride, int num_groups,
    const float* __restrict__ rays, int num_rays, float t_eps, float* __restrict__ out_t,
    int* __restrict__ out_id, int* __restrict__ stats) {
  extern __shared__ unsigned long long lists[];  // kWalkWarps * num_groups
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWalkWarps + warp;
  if (r >= num_rays) return;  // the whole warp
  walk_ray(layout, group_t, stride, num_groups, rays, r, t_eps, out_t, out_id, stats,
           lists + (size_t)warp * num_groups);
}

// Blocks of `branch` clusters (accel/cluster.py `_build_blocks_np`): a
// header tile (rows 0-5 the block's cluster boxes along lanes, row 6 their
// validity), then kTiles tiles per cluster: the cluster tile (kTiles = 1)
// or its MXU pair W1, W2 (kTiles = 2).
template <int kTiles>
struct BlockLayout {
  const float* blk;
  int branch;

  struct Group {
    const float* hdr;
    int base;  // id of lane 0 of the block's first cluster

    // lanes read consecutive clusters: each header row is one coalesced load
    __device__ __forceinline__ bool entry(int k, const Ray& r, float t_eps,
                                          float& e) const {
      if (!(__ldg(hdr + 6 * kWidth + k) > 0.0f)) return false;  // padding
      return slab(__ldg(hdr + k), __ldg(hdr + kWidth + k), __ldg(hdr + 2 * kWidth + k),
                  __ldg(hdr + 3 * kWidth + k), __ldg(hdr + 4 * kWidth + k),
                  __ldg(hdr + 5 * kWidth + k), r, t_eps, e);
    }

    __device__ __forceinline__ void intersect(int k, const Ray& r, float t_eps,
                                              float& best_t, int& best_id) const {
      const float* tile = hdr + (int64_t)(1 + kTiles * k) * kTile;
      if constexpr (kTiles == 1) {
        warp_intersect_tile(tile, base + k * kWidth, r, t_eps, best_t, best_id);
      } else {
        warp_intersect_tile_mxu(tile, tile + kTile, base + k * kWidth, r, t_eps, best_t,
                                best_id);
      }
    }
  };

  __device__ __forceinline__ int size() const { return branch; }

  __device__ __forceinline__ Group group(int b) const {
    return Group{blk + (int64_t)b * (kTiles * branch + 1) * kTile, b * branch * kWidth};
  }
};

// Launches `kernel` (a __global__ wrapper of `walk`) on `stream` of
// `device`: blocks of kWalkThreads threads, one warp per ray, and
// walk_shared_bytes(num_groups) of dynamic shared memory. Returns
// cudaGetLastError() (0 = launched). Allocates nothing and does not
// synchronise. A table too large for the block's shared memory fails here,
// never falls back.
template <class Kernel, class... Args>
int launch_walk(Kernel kernel, int device, int num_groups, int num_rays, void* stream,
                Args... args) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = walk_shared_bytes(num_groups);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kWalkWarps - 1) / kWalkWarps;
    kernel<<<blocks, kWalkThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace isaklm
