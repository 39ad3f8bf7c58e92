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
// 16-byte loads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kShadeThreads = 128;  // rays a block

// A Python float as PyTorch hands it to a float32 kernel: the double
// rounded to float.
#define F(x) static_cast<float>(x)
constexpr double kPi = 3.141592653589793;  // math.pi

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
// s[..., None] * v
__device__ __forceinline__ V3 operator*(float s, V3 v) { return {s * v.x, s * v.y, s * v.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
// math/transforms.py dot: summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// torch.clamp_min / torch.clamp on float: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// math/transforms.py normalize: v * reciprocal(sqrt(max(dot, 1e-30)))
__device__ __forceinline__ V3 normalize(V3 v) {
  const float r = 1.0f / sqrtf(clamp_min(dot(v, v), F(1e-30)));
  return r * v;
}
// torch.remainder(x, 1.0): fmod, then the sign fix
__device__ __forceinline__ float remainder1(float x) {
  float mod = fmodf(x, 1.0f);
  if (mod != 0.0f && mod < 0.0f) mod += 1.0f;
  return mod;
}
__device__ __forceinline__ V3 load3(const float* p, int64_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, int64_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

}  // namespace

// Field for field the ctypes structures of kernels/shade.py.
struct ShadeScene {
  const float* table;  // (T, 32) [p1 p2 p3 | n1 n2 n3 | uv1 uv2 uv3 | mat | pad] or null
  const float* vertices;  // (N, 3, 3)
  const float* normals;  // (N, 3, 3), read without a table
  const float* uvs;  // (N, 3, 2), read without a table
  const int32_t* mat_id;  // (N,), read without a table
  const int32_t* light_indices;  // (L,)
  const float* albedo;  // (M, 3)
  const float* emittance;  // (M, 3)
  const float* roughness;  // (M,)
  const float* ior;
  const float* extinction;
  const float* transparent;
  const int32_t* tex_id;  // (M,), -1 = none
  const float* texels;  // (P, 3)
  const int32_t* tex_offset;  // (T,)
  const int32_t* tex_width;
  const int32_t* tex_height;
  int32_t num_lights;
  int32_t has_lights;
};

struct ShadeArgs {
  const float* ray_o;  // (R, 3)
  const float* ray_d;
  const int32_t* idx;  // (R,) the bounce's hit ids, -1 = miss
  const uint8_t* hit;  // (R,) bool
  const uint8_t* active;
  const float* throughput;  // (R, 3)
  const float* radiance;
  const uint8_t* inside;  // (R,) bool
  const uint8_t* prev_diffuse;
  const float* u;  // (n >= 8, R) the bounce's uniforms, rows u_stride apart
  float* o_ray_o;  // the Pending state (kernels/shade.py)
  float* o_ray_d;
  float* o_throughput;
  float* o_radiance;
  uint8_t* o_inside;
  uint8_t* o_prev_diffuse;
  uint8_t* o_live;
  uint8_t* o_nee_mask;  // this and the rest written only where has_lights
  float* o_shadow_dir;
  float* o_window;
  int32_t* o_light_idx;
  float* o_dist_sq;
  float* o_normal;
  int64_t u_stride;
  int32_t num_rays;
  int32_t lobe_ratio_grad;
};

struct FinishArgs {
  const float* ray_o;  // the Pending state: the shadow rays' origins
  const float* throughput;
  const float* radiance;
  const uint8_t* live;
  const uint8_t* nee;  // this and the rest up to hit read only where has_lights
  const float* shadow_dir;
  const int32_t* light_idx;
  const float* dist_sq;
  const float* normal;
  const int32_t* idx;  // the shadow rays' hit ids
  const uint8_t* hit;
  const float* u_rr;  // (R,) the bounce's Russian roulette uniform
  float* o_throughput;
  float* o_radiance;
  uint8_t* o_active;
  int32_t num_rays;
  int32_t roulette;  // bounce >= rr_start_bounce
};

namespace {

struct Tri {
  V3 p1, p2, p3, n1, n2, n3;
  float uv[6];
  int mat;
};

__device__ __forceinline__ Tri load_tri(const ShadeScene& s, int i) {
  Tri t;
  if (s.table != nullptr) {
    const float4* row = reinterpret_cast<const float4*>(s.table + 32 * static_cast<int64_t>(i));
    const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2), d = __ldg(row + 3);
    const float4 e = __ldg(row + 4), f = __ldg(row + 5), g = __ldg(row + 6);
    t.p1 = {a.x, a.y, a.z};
    t.p2 = {a.w, b.x, b.y};
    t.p3 = {b.z, b.w, c.x};
    t.n1 = {c.y, c.z, c.w};
    t.n2 = {d.x, d.y, d.z};
    t.n3 = {d.w, e.x, e.y};
    t.uv[0] = e.z; t.uv[1] = e.w; t.uv[2] = f.x; t.uv[3] = f.y; t.uv[4] = f.z; t.uv[5] = f.w;
    t.mat = static_cast<int>(g.x);  // row[:, 24].to(torch.int32)
  } else {
    const int64_t k = i;
    t.p1 = load3(s.vertices, 3 * k);
    t.p2 = load3(s.vertices, 3 * k + 1);
    t.p3 = load3(s.vertices, 3 * k + 2);
    t.n1 = load3(s.normals, 3 * k);
    t.n2 = load3(s.normals, 3 * k + 1);
    t.n3 = load3(s.normals, 3 * k + 2);
    for (int j = 0; j < 6; ++j) t.uv[j] = s.uvs[6 * k + j];
    t.mat = s.mat_id[k];
  }
  return t;
}

// hit_attributes' geometry: the hit point, the shading frame (the normal
// back-face flipped) and the texture coordinates.
struct Geometry {
  V3 position, normal, tangent, bitangent;
  float u, v;
};

__device__ __forceinline__ Geometry hit_geometry(const Tri& tr, V3 o, V3 d, bool hit) {
  const V3 geo_n = normalize(cross(tr.p2 - tr.p1, tr.p3 - tr.p1));
  float ddn = dot(d, geo_n);
  ddn = fabsf(ddn) < F(1e-20) ? F(1e-20) : ddn;
  float t = (dot(geo_n, tr.p1) - dot(o, geo_n)) / ddn;
  t = hit ? t : 1.0f;
  const V3 point = o + t * d;
  // barycentric (Cramer's rule)
  const V3 v0 = tr.p2 - tr.p1, v1 = tr.p3 - tr.p1, v2 = point - tr.p1;
  const float d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
  const float d20 = dot(v2, v0), d21 = dot(v2, v1);
  const float inv_den = 1.0f / (d00 * d11 - d01 * d01);  // reciprocal(x) * 1.0
  const float b = (d11 * d20 - d01 * d21) * inv_den;
  const float c = (d00 * d21 - d01 * d20) * inv_den;
  const float a = 1.0f - b - c;
  Geometry g;
  g.position = a * tr.p1 + b * tr.p2 + c * tr.p3;
  const V3 normal = normalize(a * tr.n1 + b * tr.n2 + c * tr.n3);
  g.tangent = normalize(cross(tr.p2 - tr.p1, normal));
  g.bitangent = normalize(cross(normal, g.tangent));
  g.normal = dot(d, normal) > 0.0f ? neg(normal) : normal;
  g.u = a * tr.uv[0] + b * tr.uv[2] + c * tr.uv[4];
  g.v = a * tr.uv[1] + b * tr.uv[3] + c * tr.uv[5];
  return g;
}

// scene/types.py sample_texture: nearest texel, uv wrapped by remainder,
// the texel index truncated toward zero and left unclamped
__device__ __forceinline__ V3 sample_texture(const ShadeScene& s, int tex_id, V3 color, float u,
                                             float v) {
  if (tex_id < 0) return color;
  const int w = s.tex_width[tex_id], h = s.tex_height[tex_id], off = s.tex_offset[tex_id];
  const int px = static_cast<int>(remainder1(v) * static_cast<float>(h)) * w +
                 static_cast<int>(remainder1(u) * static_cast<float>(w));
  return mul(load3(s.texels, static_cast<int64_t>(off + px)), color);
}

struct Material {
  V3 albedo, emittance;
  float roughness, ior, extinction, transparent;
};

__device__ __forceinline__ Material material(const ShadeScene& s, int mat, float u, float v) {
  Material m;
  const int tex = s.tex_id[mat];
  m.albedo = sample_texture(s, tex, load3(s.albedo, mat), u, v);
  m.emittance = sample_texture(s, tex, load3(s.emittance, mat), u, v);
  m.roughness = s.roughness[mat];
  m.ior = s.ior[mat];
  m.extinction = s.extinction[mat];
  m.transparent = s.transparent[mat];
  return m;
}

// --- math/sampling.py ---------------------------------------------------

__device__ __forceinline__ float fresnel_dielectric(V3 wi, V3 half, float n1, float n2) {
  const float c = fabsf(dot(wi, half));
  const float g = sqrtf(clamp_min(n2 * n2 / (n1 * n1) - 1.0f + c * c, F(1e-12)));
  const float q = (g - c) / clamp_min(g + c, F(1e-12));
  const float factor1 = 0.5f * (q * q);
  float den = c * (g - c) + 1.0f;
  den = fabsf(den) < F(1e-12) ? F(1e-12) : den;
  const float w = (c * (g + c) - 1.0f) / den;
  const float factor2 = 1.0f + w * w;
  return factor1 * factor2;
}

__device__ __forceinline__ float fresnel_conductor(V3 wi, V3 half, float n, float k) {
  const float n2 = n * n, k2 = k * k;
  const float cos_t = dot(wi, half);
  const float cos2 = cos_t * cos_t;
  const float sin2 = 1.0f - cos2;
  const float t0 = n2 - k2 - sin2;
  const float a2b2 = sqrtf(clamp_min(t0 * t0 + 4.0f * n2 * k2, 0.0f));
  const float a = sqrtf(clamp_min(0.5f * (a2b2 + t0), 0.0f));
  const float t1 = a2b2 + cos2;
  const float t2 = 2.0f * a * cos_t;
  const float rs = (t1 - t2) / (t1 + t2);
  const float t3 = cos2 * a2b2 * sin2 * sin2;
  const float t4 = t2 * sin2;
  const float denom = t3 + t4;
  const bool nonzero = denom != 0.0f;
  const float ratio = nonzero ? (t3 - t4) / (nonzero ? denom : 1.0f) : -1.0f;
  const float rp = rs * ratio;
  return 0.5f * (rs + rp);
}

__device__ __forceinline__ float smith_lambda(V3 dir, V3 normal, float roughness) {
  const float d = dot(dir, normal);
  const float d2 = clamp_min(d * d, F(1e-12));
  const float tan2 = (1.0f - d2) / d2;
  return (sqrtf(1.0f + roughness * roughness + tan2) - 1.0f) * 0.5f;
}

__device__ __forceinline__ float specular_weight(V3 wi, V3 wo, V3 half, V3 normal,
                                                 float roughness) {
  const float g = 1.0f / (1.0f + smith_lambda(wi, normal, roughness) +
                          smith_lambda(wo, normal, roughness));
  return fabsf(dot(wi, half)) * g /
         clamp_min(fabsf(dot(normal, half)) * fabsf(dot(wi, normal)), F(1e-12));
}

__device__ __forceinline__ V3 reflect(V3 wi, V3 half) { return (2.0f * dot(wi, half)) * half - wi; }

__device__ __forceinline__ V3 refract(V3 wi, V3 half, float n1, float n2) {
  const float c = dot(wi, half);
  const float n = n1 / n2;
  const float root = sqrtf(clamp_min(1.0f + n * n * (c * c - 1.0f), F(1e-12)));
  return (n * c - root) * half - n * wi;
}

// --- integrator/bsdf.py scatter, the selected lobe only -------------------

struct Event {
  V3 direction, weight;
  bool diffuse, inside;
};

__device__ __forceinline__ Event scatter(const Geometry& g, const Material& m, V3 ray_d,
                                         bool inside, const float* u, int64_t stride,
                                         bool lobe_ratio_grad) {
  const float tau = F(2.0 * kPi);
  const V3 wi = neg(ray_d);
  const float rough = m.roughness;
  // GGX half vector
  const float u0 = u[0], u1 = u[stride];
  const float a2 = rough * rough;
  const float denom = clamp_min(u0 * (a2 - 1.0f) + 1.0f, F(1e-12));
  const float cos_t = sqrtf(clamp((1.0f - u0) / denom, 0.0f, 1.0f));
  const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, F(1e-12)));
  const float phi = u1 * tau;
  const V3 half = (sin_t * cosf(phi)) * g.tangent + cos_t * g.normal +
                  (sin_t * sinf(phi)) * g.bitangent;

  Event ev;
  ev.inside = inside;
  ev.diffuse = false;
  if (m.extinction > 0.0f) {  // metallic
    const float f_cond = fresnel_conductor(wi, half, m.ior, m.extinction);
    ev.direction = reflect(wi, half);
    const float sw = specular_weight(wi, ev.direction, half, g.normal, rough);
    ev.weight = (sw * f_cond) * m.albedo;
    return ev;
  }
  const float ior = clamp_min(m.ior, F(1e-6));
  const float n1 = inside ? ior : 1.0f;
  const float n2 = inside ? 1.0f : ior;
  const float f = fresnel_dielectric(wi, half, n1, n2);
  const float ratio_spec = lobe_ratio_grad ? f / clamp_min(f, F(1e-12)) : 1.0f;
  const float ratio_rest = lobe_ratio_grad ? (1.0f - f) / clamp_min(1.0f - f, F(1e-12)) : 1.0f;
  if (u[2 * stride] < f) {  // specular
    ev.direction = reflect(wi, half);
    const float sw = inside ? 1.0f : specular_weight(wi, ev.direction, half, g.normal, rough);
    const float w = (sw * ratio_spec) * 1.0f;  // times ones((1, 3))
    ev.weight = {w, w, w};
  } else if (m.transparent > 0.5f) {  // transmission
    ev.direction = refract(wi, half, n1, n2);
    const float sw = specular_weight(wi, ev.direction, half, g.normal, rough);
    ev.weight = (sw * ratio_rest) * m.albedo;
    ev.inside = !inside;
  } else {  // diffuse: cosine_hemisphere
    const float phi_d = u[3 * stride] * tau, u4 = u[4 * stride];
    const float s = sqrtf(u4), ct = sqrtf(1.0f - u4);
    ev.direction = (s * cosf(phi_d)) * g.tangent + ct * g.normal + (s * sinf(phi_d)) * g.bitangent;
    ev.weight = ratio_rest * m.albedo;
    ev.diffuse = true;
  }
  return ev;
}

__device__ __forceinline__ void store_flag(uint8_t* p, int64_t i, bool v) {
  p[i] = v ? 1 : 0;
}

__global__ void __launch_bounds__(kShadeThreads)
shade_bounce_kernel(const ShadeScene s, const ShadeArgs a) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kShadeThreads + threadIdx.x;
  if (r >= a.num_rays) return;
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
  if (live) {
    const Material m = material(s, tri.mat, g.u, g.v);
    if (!prev_diffuse) emitted = mul(m.emittance, throughput);
    const Event ev = scatter(g, m, d, inside, u, a.u_stride, a.lobe_ratio_grad != 0);
    next_o = g.position;
    next_d = ev.direction;
    next_throughput = mul(throughput, ev.weight);
    next_inside = ev.inside;
    next_diffuse = diffuse = ev.diffuse;
  }
  store3(a.o_ray_o, r, next_o);
  store3(a.o_ray_d, r, next_d);
  store3(a.o_throughput, r, next_throughput);
  store3(a.o_radiance, r, load3(a.radiance, r) + emitted);
  store_flag(a.o_inside, r, next_inside);
  store_flag(a.o_prev_diffuse, r, next_diffuse);
  store_flag(a.o_live, r, live);
  if (!s.has_lights) return;

  // integrator/nee.py shadow_rays from the next origin
  const int n = s.num_lights;
  int pick = static_cast<int>(u[5 * a.u_stride] * static_cast<float>(n));
  pick = min(max(pick, 0), n - 1);
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

__global__ void __launch_bounds__(kShadeThreads)
finish_bounce_kernel(const ShadeScene s, const FinishArgs a) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kShadeThreads + threadIdx.x;
  if (r >= a.num_rays) return;
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
