// A bounce's shading for Hopper (sm_90a): two kernels, one thread a ray,
// around the NEE shadow rays' intersector call.
//
// Replaces no Pallas kernel. It computes the body of the JAX package's
// bounce loop (isaklm_raytracer_tpu/integrator/path_trace.py:61-131, a
// lax.scan body that XLA compiles into a few fusions) but the two
// intersector calls:
//   shade_bounce_kernel  the hit's attributes and texture lookup
//                        (accel/traverse.py hit_attributes), the emitted
//                        radiance, the BSDF sample (integrator/bsdf.py
//                        scatter), the next ray state and the shadow rays
//                        (integrator/nee.py, up to the intersector call);
//   finish_bounce_kernel the direct light at the shadow hit (nee.py after
//                        the call) and Russian roulette.
// Each equals its plain version (kernels/shade.py shade_bounce_plain,
// finish_bounce_plain, which run PyTorch's element-wise CUDA kernels one op
// at a time) bit for bit on every output. So each operation here is the
// one PyTorch's kernel runs, in the plain version's order: --fmad=false
// keeps every product and sum rounded on its own; Python scalars are
// doubles rounded to float (F below); clamp and clamp_min pass NaN through,
// as PyTorch's do; remainder is fmod plus the sign fix; x ** 2 is x * x
// (PyTorch's pow with exponent 2); 1.0 / x is the IEEE reciprocal; sqrtf,
// sinf and cosf are CUDA's, as in PyTorch's kernels. Lanes that are not
// live still compute the geometry (the plain version's `normal` output on
// every lane, from triangle 0 at t = 1 on a miss); the material, the
// texture and the BSDF sample, whose results only live lanes select, run
// on live lanes only, and of the four lobes only the one selected.
//
// What bounds it on the H100: bytes. At the demo's 262,144 rays a bounce's
// first kernel reads the ray state and eight uniforms (88 B a ray), the
// distinct hit rows and the material table, and writes 88 B of pending
// state: about 46 MB, 14 us at the HBM rate; its arithmetic, about 660
// issue slots a ray, is about 5 us of the FP32 lanes (chip_smoke.py
// shade_bound). The second reads 30-90 B a ray (a visible light's row
// besides) and writes 25 B: about 21 MB, 6 us. The design: one thread a
// ray, its whole computation in registers, nothing staged in shared memory
// (a ray reads its own rows once); rows of the shading table as seven
// 16-byte loads. The structures and the forward helpers live in
// shade_common.cuh, which csrc/shade_backward.cu shares.
//
// Where autograd records the bounce (kernels/shade.py BounceFunction), the
// two kernels also write each ray's RayClass (o_ray_class: the lobe the
// first one chose, and the direct light's visibility, which only the
// second one knows), one byte a ray, so that the backward's binning reads
// that byte rather than derive the class again from the flags, the hit's
// material and the light pick through a chain of dependent loads. With a
// null o_ray_class (every render path) nothing more is read or written.
// Without nvcc (g++, for the CPU tests) the per-ray code builds for the
// host, with an entry point that runs the rays one after another.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "shade_common.cuh"

namespace {

// shade_bounce_plain on ray r.
__device__ __forceinline__ void shade_ray(const ShadeScene& s, const ShadeArgs& a, int64_t r) {
  const V3 o = load3(a.ray_o, r), d = load3(a.ray_d, r);
  const V3 throughput = load3(a.throughput, r);
  const int idx = a.idx[r];
  const bool hit = a.hit[r] != 0, live = (a.active[r] != 0) && hit;
  const bool inside = a.inside[r] != 0, prev_diffuse = a.prev_diffuse[r] != 0;
  const float* u = a.u + r;

  const Tri tri = load_tri(s, idx > 0 ? idx : 0);
  const Geometry g = hit_geometry(tri, o, d, hit);
  V3 emitted = {0.0f, 0.0f, 0.0f};  // where(emit, emittance * throughput, 0.0)
  V3 next_o = o, next_d = d, next_throughput = throughput;
  bool next_inside = inside, next_diffuse = prev_diffuse, diffuse = false;
  int ray_class = kDead;
  if (live) {
    const Material m = material(s, tri.mat, g.u, g.v);
    if (!prev_diffuse) emitted = mul(m.emittance, throughput);
    const Event ev = scatter(g, m, d, inside, u, a.u_stride, a.lobe_ratio_grad != 0);
    next_o = g.position;
    next_d = ev.direction;
    next_throughput = mul(throughput, ev.weight);
    next_inside = ev.inside;
    next_diffuse = diffuse = ev.diffuse;
    // the lobe scatter chose (a diffuse one's visibility is finish_ray's)
    ray_class = ev.diffuse             ? kDiffuseDark
                : ev.inside != inside  ? kTransmission
                : m.extinction > 0.0f  ? kMetal
                : inside               ? kSpecularInside
                                       : kSpecular;
  }
  store3(a.o_ray_o, r, next_o);
  store3(a.o_ray_d, r, next_d);
  store3(a.o_throughput, r, next_throughput);
  store3(a.o_radiance, r, load3(a.radiance, r) + emitted);
  store_flag(a.o_inside, r, next_inside);
  store_flag(a.o_prev_diffuse, r, next_diffuse);
  store_flag(a.o_live, r, live);
  if (a.o_ray_class != nullptr) a.o_ray_class[r] = static_cast<uint8_t>(ray_class);
  if (!s.has_lights) return;

  // integrator/nee.py shadow_rays from the next origin
  const int n = s.num_lights;
  int pick = static_cast<int>(u[5 * a.u_stride] * static_cast<float>(n));
  pick = pick < 0 ? 0 : (pick > n - 1 ? n - 1 : pick);
  const int light = s.light_indices[pick];
  const V3 p1 = load3(s.vertices, 3 * static_cast<int64_t>(light));
  const V3 p2 = load3(s.vertices, 3 * static_cast<int64_t>(light) + 1);
  const V3 p3 = load3(s.vertices, 3 * static_cast<int64_t>(light) + 2);
  const float sqrt_x = sqrtf(u[6 * a.u_stride]);
  const float bu = 1.0f - sqrt_x;
  const float bv = u[7 * a.u_stride] * sqrt_x;
  const float bw = 1.0f - bu - bv;
  const V3 point = bu * p1 + bv * p2 + bw * p3;
  const V3 to_light = point - next_o;
  const float dist_sq = dot(to_light, to_light);
  store_flag(a.o_nee_mask, r, live && diffuse);
  store3(a.o_shadow_dir, r, normalize(to_light));
  a.o_window[r] = sqrtf(dist_sq) * F(1.001) + F(1e-3);
  a.o_light_idx[r] = light;
  a.o_dist_sq[r] = dist_sq;
  store3(a.o_normal, r, g.normal);
}

// finish_bounce_plain on ray r.
__device__ __forceinline__ void finish_ray(const ShadeScene& s, const FinishArgs& a, int64_t r) {
  const V3 throughput = load3(a.throughput, r);
  V3 radiance = load3(a.radiance, r);
  const bool live = a.live[r] != 0;
  if (s.has_lights) {
    // integrator/nee.py direct_from_hit, then
    // radiance + where(nee_mask, direct * throughput, 0.0)
    V3 add = {0.0f, 0.0f, 0.0f};
    if (a.nee[r] != 0) {
      const int light = a.light_idx[r];
      const bool visible = (a.hit[r] != 0) && a.idx[r] == light;
      V3 direct = {0.0f, 0.0f, 0.0f};
      if (visible) {
        const V3 o = load3(a.ray_o, r), dir = load3(a.shadow_dir, r);
        const Tri tri = load_tri(s, light);
        const Geometry g = hit_geometry(tri, o, dir, true);
        const Material m = material(s, tri.mat, g.u, g.v);
        const V3 p1 = load3(s.vertices, 3 * static_cast<int64_t>(light));
        const V3 p2 = load3(s.vertices, 3 * static_cast<int64_t>(light) + 1);
        const V3 p3 = load3(s.vertices, 3 * static_cast<int64_t>(light) + 2);
        const V3 e = cross(p2 - p1, p3 - p1);
        const float light_area = 0.5f * sqrtf(dot(e, e));
        const float cos1 = clamp_min(-dot(dir, g.normal), 0.0f);
        const float cos2 = clamp_min(dot(dir, load3(a.normal, r)), 0.0f);
        const float scale = light_area * static_cast<float>(s.num_lights) * cos1 * cos2 /
                            clamp_min(a.dist_sq[r] * F(kPi), F(0.001));
        direct = scale * m.emittance;
        if (a.o_ray_class != nullptr) a.o_ray_class[r] = kDiffuseVisible;
      }
      add = mul(direct, throughput);
    }
    radiance = radiance + add;
  }
  store3(a.o_radiance, r, radiance);

  // Russian roulette on the live lanes: survival = the max channel (NaN
  // propagating, as torch.max), reweighted by 1 / max(survival, 1e-30)
  V3 next_throughput = throughput;
  bool alive = true;
  if (a.roulette != 0) {
    float survival = throughput.x;
    survival = (isnan(survival) || survival > throughput.y) ? survival : throughput.y;
    survival = (isnan(survival) || survival > throughput.z) ? survival : throughput.z;
    alive = a.u_rr[r] <= survival;
    if (live && alive) {
      const float p = clamp_min(survival, F(1e-30));
      next_throughput = {throughput.x / p, throughput.y / p, throughput.z / p};
    }
  }
  store3(a.o_throughput, r, next_throughput);
  store_flag(a.o_active, r, live && alive);
}

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(kShadeThreads)
shade_bounce_kernel(const ShadeScene s, const ShadeArgs a) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kShadeThreads + threadIdx.x;
  if (r < a.num_rays) shade_ray(s, a, r);
}

__global__ void __launch_bounds__(kShadeThreads)
finish_bounce_kernel(const ShadeScene s, const FinishArgs a) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kShadeThreads + threadIdx.x;
  if (r < a.num_rays) finish_ray(s, a, r);
}

inline dim3 grid_of(int num_rays) { return dim3((num_rays + kShadeThreads - 1) / kShadeThreads); }

}  // namespace

// Each launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). The structs are host memory, copied into the launch's
// parameters. Allocates nothing and does not synchronise.
extern "C" int shade_bounce(int device, const ShadeScene* scene, const ShadeArgs* args,
                            void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args->num_rays > 0) {
    shade_bounce_kernel<<<grid_of(args->num_rays), kShadeThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(*scene, *args);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int finish_bounce(int device, const ShadeScene* scene, const FinishArgs* args,
                             void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args->num_rays > 0) {
    finish_bounce_kernel<<<grid_of(args->num_rays), kShadeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(*scene, *args);
  }
  return static_cast<int>(cudaGetLastError());
}

#else  // a host build of the same code, for the CPU tests

// The kernels on the host: the rays one after another. Return 0.
extern "C" int shade_bounce_host(const ShadeScene* scene, const ShadeArgs* args) {
  for (int64_t r = 0; r < args->num_rays; ++r) shade_ray(*scene, *args, r);
  return 0;
}

extern "C" int finish_bounce_host(const ShadeScene* scene, const FinishArgs* args) {
  for (int64_t r = 0; r < args->num_rays; ++r) finish_ray(*scene, *args, r);
  return 0;
}

#endif
