// Flat nearest-hit intersector over MXU tile pairs, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flat_mxu_kernel` of
// isaklm_raytracer_tpu/kernels/intersect.py:557 (with
// `_make_intersect_mxu`, :259; called by `nearest_hit_cluster_flat_mxu`,
// :1303): every ray against every triangle of the real clusters of a scene
// of at most 64 clusters, each cluster a pair of tiles so that the TPU
// kernel's six ray/triangle dot products run as (2B, 8) @ (8, 128)
// matmuls on the MXU.
//
// Contract: `flat_kernel` of flat_walk.cuh over
//   tiles   (C, 2, 16, 128) f32 (accel/cluster.py `with_mxu_tiles`): W1
//           holds n in rows 0-2 and e1 in rows 8-10, W2 holds e2 in rows
//           0-2 and np1 p1e1 p1e2 ca cb cc in rows 8-13; the kernel reads
//           those 15 rows of the first `num_clusters` pairs.
// The pair holds exactly the 15 constants of a cluster tile in other rows,
// so the flat kernel's staged walk runs on it unchanged: only the row of
// each constant differs (`PairLayout`). Each dot product is the IEEE f32
// sum of `tri_hit` (no tensor-core product), so the result equals the flat
// kernel's bit for bit.
//
// Why no tensor cores: a 3xTF32 `mma.sync` of the six dot products (18 of
// the 51 issue slots of a full test) would leave 33 slots a pair on the
// CUDA cores, more than the staged walk's least work per pair (PERF.md,
// section 6), and would lose both bit equality and the per-ray early
// exits; fp64 DMMA runs at the FP32 CUDA-core rate and gains nothing.

#include "flat_walk.cuh"

namespace {

using namespace isaklm;

// MXU pairs: constant k of cluster c is row kPairRows[k] of pair c, W1's
// rows counted 0-15 and W2's 16-31 (`_mxu_pairs_np` backwards).
struct PairLayout {
  static constexpr int kClusterFloats = 2 * kTile;
  __host__ __device__ static constexpr int row(int k) {
    constexpr int kPairRows[kFlatRows] = {0, 1, 2, 8, 9, 10, 16, 17, 18, 24, 25, 26, 27, 28, 29};
    return kPairRows[k];
  }
};

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). Allocates nothing and does not synchronise.
extern "C" int flat_mxu_intersect(int device, const float* tiles, int num_clusters,
                                  const float* rays, int num_rays, float t_eps,
                                  float* out_t, int* out_id, void* stream) {
  return launch_flat<PairLayout>(device, tiles, num_clusters, rays, num_rays, t_eps, out_t,
                                 out_id, stream);
}
