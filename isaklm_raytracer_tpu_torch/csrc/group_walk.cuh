// The per-ray walk over groups of clusters that the blocked, MXU-blocked
// and oct intersectors share (blk_intersect.cu, blk_mxu_intersect.cu,
// hbm_intersect.cu).
//
// A scene's clusters are cut into groups of consecutive clusters (a block
// of `branch` clusters, or an oct of `oct_branch`), each with a box in a
// component-major (8, stride) table. One thread walks one ray: the group
// boxes sit in shared memory, and the ray visits the groups front to back
// with the (entry, index) cursor of `next_box`, bounded by its own best t.
// In a group it culls the clusters against that best into a 128-bit mask
// held in registers, then intersects the pierced clusters front to back,
// dropping those whose entry falls behind its best.
//
// A group layout says where a cluster's box and constants lie. It provides
//   int size() const: clusters per group (at most 128);
//   Group group(int g) const: the group g, which provides
//     bool entry(int k, const Ray&, float t_eps, float& e) const: whether
//       the ray pierces cluster k of the group, and its entry distance;
//     void intersect(int k, const Ray&, float t_eps, float& best_t,
//       int& best_id) const: the 128-lane test of cluster k.

#pragma once

#include "intersect_common.cuh"

namespace isaklm {

constexpr int kWalkThreads = 128;  // rays per block
constexpr int kMaskWords = kWidth / 32;

// The walk of ray r (rays of the (R, 8) layout) over `num_groups` group
// boxes already staged in shared memory as boxes[k * num_groups + g].
// Writes the contract's (t, id) and, when `stats` is not null, the groups
// visited and the clusters intersected.
template <class Layout>
__device__ __forceinline__ void walk_groups(
    const Layout& layout, const float* __restrict__ boxes, int num_groups,
    const float* __restrict__ rays, int r, float t_eps, float* __restrict__ out_t,
    int* __restrict__ out_id, int* __restrict__ stats) {
  const Ray ray = load_ray(rays, r);
  const int size = layout.size();
  float best_t = ray.t_max;
  int best_id = kBigId;
  int visits = 0, clusters = 0;
  if (ray.active) {
    float cur_e = -1.0f;
    int cur_g = -1;
    while (true) {
      float e;
      const int g = next_box(boxes, num_groups, ray, t_eps, best_t, cur_e, cur_g, e);
      if (g < 0) break;
      cur_e = e;
      cur_g = g;
      ++visits;
      const auto group = layout.group(g);

      // cull the group's clusters against this ray's own best
      uint32_t mask[kMaskWords];
#pragma unroll
      for (int w = 0; w < kMaskWords; ++w) {
        uint32_t m = 0;
        for (int j = 0; j < 32 && w * 32 + j < size; ++j) {
          float ce;
          if (group.entry(w * 32 + j, ray, t_eps, ce) && ce <= best_t) m |= 1u << j;
        }
        mask[w] = m;
      }

      // walk the pierced clusters front to back
      while (true) {
        int k = -1;
        float ke = 0.0f;
#pragma unroll
        for (int w = 0; w < kMaskWords; ++w) {
          uint32_t bits = mask[w];
          while (bits) {
            const int j = __ffs(bits) - 1;
            bits &= bits - 1;
            float ce;
            group.entry(w * 32 + j, ray, t_eps, ce);  // pierced when set
            if (ce > best_t) {
              mask[w] &= ~(1u << j);  // behind the best: never needed again
            } else if (k < 0 || ce < ke) {  // ascending: ties keep the lower k
              k = w * 32 + j;
              ke = ce;
            }
          }
        }
        if (k < 0) break;
#pragma unroll
        for (int w = 0; w < kMaskWords; ++w) {
          if (w == (k >> 5)) mask[w] &= ~(1u << (k & 31));
        }
        ++clusters;
        group.intersect(k, ray, t_eps, best_t, best_id);
      }
    }
  }
  out_t[r] = best_t;
  out_id[r] = best_id;
  if (stats != nullptr) {
    stats[2 * (int64_t)r] = visits;
    stats[2 * (int64_t)r + 1] = clusters;
  }
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
        intersect_tile(tile, base + k * kWidth, r, t_eps, best_t, best_id);
      } else {
        intersect_tile_mxu(tile, tile + kTile, base + k * kWidth, r, t_eps, best_t,
                           best_id);
      }
    }
  };

  __device__ __forceinline__ int size() const { return branch; }

  __device__ __forceinline__ Group group(int b) const {
    return Group{blk + (int64_t)b * (kTiles * branch + 1) * kTile, b * branch * kWidth};
  }
};

// Launches `kernel` (a __global__ wrapper of `walk_groups` that stages the
// group boxes with `stage_boxes`) on `stream` of `device` with 7 floats of
// shared memory per group, and returns cudaGetLastError() (0 = launched).
// Allocates nothing and does not synchronise. A table too large for the
// block's shared memory fails here, never falls back.
template <class Kernel, class... Args>
int launch_walk(Kernel kernel, int device, int num_groups, int num_rays, void* stream,
                Args... args) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * 7 * (size_t)num_groups;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0) {
    const int blocks = (num_rays + kWalkThreads - 1) / kWalkThreads;
    kernel<<<blocks, kWalkThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace isaklm
