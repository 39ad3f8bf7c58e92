// The reverse mode of a bounce's shading for Hopper (sm_90a): one kernel,
// one thread a ray.
//
// Replaces no Pallas kernel. It computes the gradient of the JAX package's
// bounce body (isaklm_raytracer_tpu/integrator/path_trace.py:61-131) but
// its two intersector calls, that is of kernels/shade.py's
// shade_bounce_plain followed by finish_bounce_plain, which
// csrc/shade_bounce.cu computes forward in two kernels. Given the gradients
// of a bounce's outputs (the next ray origin, direction, throughput and
// the radiance), it gives those of its inputs (ray origin, direction,
// throughput; the radiance's passes through unchanged and is not written
// here) and adds those of the material table (albedo, emittance,
// roughness, ior, extinction; transparent only feeds a comparison) and of
// the texel atlas. Hit ids, hit flags, the variates, the lobe choice's
// Fresnel term, Russian roulette's survival and the NEE window stay
// detached, as in the plain versions; the geometry (vertices, normals,
// uvs) is a constant here (integrator/path_trace.py shade_route takes the
// plain versions when it requires grad).
//
// There is no intersector call between the two halves of the reverse
// pass, so one kernel runs both: a thread recomputes its ray's forward in
// registers with the forward's own helpers (shade_common.cuh, bit for bit
// the forward kernels' values, so every branch and selection is the
// forward's), then runs the reverse pass by hand, op for op the derivative
// rules PyTorch applies to the plain versions: abs has derivative 0 at 0,
// clamp and clamp_min pass the gradient at equality, where routes it to
// the taken branch only, x ** 2 gives 2x, a / b gives -g (a / b) / b to b.
// Only the branches the forward selected run backward (a live lane's one
// lobe; the direct light of a visible shadow hit), where the plain
// backward carries zeros through the others: where such a zero meets an
// infinite local derivative the plain version gives NaN and this kernel
// a finite value (ROADMAP.md section C lists the cases).
//
// The material and texel gradients are sums over the rays. Every ray of a
// warp that hits one material would otherwise add to the same few
// addresses: a warp first groups its lanes by material (and by texel) with
// __match_any_sync, a group of one adds its values itself, a larger group
// sums them by shuffles and its first lane adds the sum, one atomic a
// (group, field). The order of the atomics differs from run to run, so
// these sums are not bit for bit the same from run to run; they are kept in
// float64 (one rounding to float32 at the end), since a float32 sum drifts
// where one term is added tens of thousands of times (the plain version's
// index_add over a 512x512 wavefront: up to 7e-4 of the light's emittance
// gradient on the H100).
//
// What bounds it on the H100: operations. At the demo's bounce 0 (262,144
// rays) a call must move about 37 MB (a ray's state, uniforms, shadow hit
// and output gradients in, three gradients out: 11 us at the HBM rate) and
// issue about 5e8 slots (the forward again and its reverse, 1,700-2,700 a
// live ray by its lobe and shadow hit: 15 us; chip_smoke.py
// shade_backward_bound). The design is shade_bounce.cu's: one thread a
// ray, all in registers, nothing staged; the reverse needs the forward's
// intermediates at once, 180 registers a thread, which leaves few warps an
// SM to hide latency (a first kernel: about ten times that bound).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "shade_common.cuh"

// Field for field the ctypes structure of kernels/shade.py.
struct BackwardArgs {
  const float* ray_o;  // (R, 3) the bounce's inputs
  const float* ray_d;
  const int32_t* idx;  // (R,) the bounce's hit ids, -1 = miss
  const uint8_t* hit;  // (R,) bool
  const uint8_t* active;
  const float* throughput;  // (R, 3)
  const uint8_t* inside;  // (R,) bool
  const uint8_t* prev_diffuse;
  const float* u;  // (9, R) the bounce's uniforms, rows u_stride apart
  const int32_t* shadow_idx;  // (R,) the shadow rays' hit ids; null without lights
  const uint8_t* shadow_hit;
  const float* g_ray_o;  // (R, 3) the gradients of the bounce's outputs
  const float* g_ray_d;
  const float* g_throughput;
  const float* g_radiance;
  float* o_ray_o;  // (R, 3) the gradients of its inputs
  float* o_ray_d;
  float* o_throughput;
  double* o_material;  // (M, 9) added to: albedo, emittance, roughness, ior, extinction; or null
  double* o_texels;  // (P, 3) added to; or null
  int64_t u_stride;
  int32_t num_rays;
  int32_t roulette;  // bounce >= rr_start_bounce
  int32_t lobe_ratio_grad;
};

namespace {

// One ray's additions to the material table and the atlas (a key < 0: none).
struct Contrib {
  int mat = -1;  // the hit's material: albedo 3, emittance 3, roughness, ior, extinction
  float mat_g[9] = {};
  int texel = -1;  // the hit's texel (albedo and emittance)
  float texel_g[3] = {};
  int light_mat = -1;  // the visible light's material: its emittance
  float light_g[3] = {};
  int light_texel = -1;
  float light_texel_g[3] = {};
};

__device__ __forceinline__ float sum3(V3 a) { return a.x + a.y + a.z; }
// sum(g * v) over the last axis: the gradient of a (R, 1) factor of v
__device__ __forceinline__ float dotg(V3 g, V3 v) { return sum3(mul(g, v)); }
// abs's derivative: sign, 0 at 0
__device__ __forceinline__ float sgn(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }
// d sqrt(x) / dx applied to g, PyTorch's g / (2 sqrt(x))
__device__ __forceinline__ float sqrt_bwd(float g, float root) { return g / (2.0f * root); }

// normalize(v) = v * r, r = 1 / sqrt(clamp_min(v.v, 1e-30)): the gradient
// of v from that of the result.
__device__ __forceinline__ V3 normalize_bwd(V3 v, V3 g) {
  const float dd = dot(v, v);
  const float root = sqrtf(clamp_min(dd, F(1e-30)));
  const float r = 1.0f / root;
  const float g_r = dotg(g, v);
  const float g_root = -g_r * (r * r);
  const float g_dd = dd >= F(1e-30) ? sqrt_bwd(g_root, root) : 0.0f;
  return r * g + (2.0f * g_dd) * v;
}

// c = cross(a, b): the gradients of a and b
__device__ __forceinline__ V3 cross_bwd_a(V3 b, V3 g) { return cross(b, g); }
__device__ __forceinline__ V3 cross_bwd_b(V3 a, V3 g) { return cross(g, a); }

// hit_geometry's reverse (accel/traverse.py hit_attributes): the gradients
// of the ray origin and direction from those of the position, the
// (flipped) normal, the tangent and the bitangent. The triangle is a
// constant; the uv feeds only the texel index, which has none.
struct GeometryGrad {
  V3 o, d;
};

__device__ GeometryGrad hit_geometry_bwd(const Tri& tr, V3 o, V3 d, bool hit, V3 g_position,
                                         V3 g_normal, V3 g_tangent, V3 g_bitangent,
                                         bool frame) {
  // the forward, as hit_geometry computes it
  const V3 e1 = tr.p2 - tr.p1;
  const V3 geo_n = normalize(cross(e1, tr.p3 - tr.p1));
  const float ddn_raw = dot(d, geo_n);
  const bool tiny = fabsf(ddn_raw) < F(1e-20);
  const float ddn = tiny ? F(1e-20) : ddn_raw;
  const float num = dot(geo_n, tr.p1) - dot(o, geo_n);
  const float t_raw = num / ddn;
  const float t = hit ? t_raw : 1.0f;
  const V3 point = o + t * d;
  const V3 v0 = tr.p2 - tr.p1, v1 = tr.p3 - tr.p1, v2 = point - tr.p1;
  const float d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
  const float d20 = dot(v2, v0), d21 = dot(v2, v1);
  const float inv_den = 1.0f / (d00 * d11 - d01 * d01);
  const float b = (d11 * d20 - d01 * d21) * inv_den;
  const float c = (d00 * d21 - d01 * d20) * inv_den;
  const float a = 1.0f - b - c;
  const V3 nsum = a * tr.n1 + b * tr.n2 + c * tr.n3;
  const V3 normal = normalize(nsum);
  const bool flip = dot(d, normal) > 0.0f;

  // the reverse
  V3 g_nr = flip ? neg(g_normal) : g_normal;
  if (frame) {  // tangent = normalize(cross(e1, normal)), bitangent = normalize(cross(normal, tangent))
    const V3 c1 = cross(e1, normal);
    const V3 tangent = normalize(c1);
    const V3 c2 = cross(normal, tangent);
    const V3 g_c2 = normalize_bwd(c2, g_bitangent);
    g_nr = g_nr + cross_bwd_a(tangent, g_c2);
    const V3 g_c1 = normalize_bwd(c1, g_tangent + cross_bwd_b(normal, g_c2));
    g_nr = g_nr + cross_bwd_b(e1, g_c1);
  }
  const V3 g_nsum = normalize_bwd(nsum, g_nr);
  float g_a = dotg(g_nsum, tr.n1) + dotg(g_position, tr.p1);
  float g_b = dotg(g_nsum, tr.n2) + dotg(g_position, tr.p2);
  float g_c = dotg(g_nsum, tr.n3) + dotg(g_position, tr.p3);
  g_b = g_b - g_a;  // a = 1 - b - c
  g_c = g_c - g_a;
  const float g_bp = g_b * inv_den, g_cp = g_c * inv_den;
  const float g_d20 = g_bp * d11 - g_cp * d01;
  const float g_d21 = g_cp * d00 - g_bp * d01;
  const V3 g_point = g_d20 * v0 + g_d21 * v1;
  GeometryGrad out;
  out.o = g_point;
  out.d = t * g_point;
  const float g_t = hit ? dotg(g_point, d) : 0.0f;
  const float g_num = g_t / ddn;
  const float g_ddn = tiny ? 0.0f : -g_t * (t_raw / ddn);
  out.o = out.o - g_num * geo_n;
  out.d = out.d + g_ddn * geo_n;
  return out;
}

// --- math/sampling.py's reverses -----------------------------------------

struct FresnelGrad {
  V3 wi, half;
  float n1, n2;
};

__device__ FresnelGrad fresnel_dielectric_bwd(V3 wi, V3 half, float n1, float n2, float g_f) {
  const float c_raw = dot(wi, half);
  const float c = fabsf(c_raw);
  const float nn1 = n1 * n1, nn2 = n2 * n2;
  const float q1 = nn2 / nn1;
  const float s = q1 - 1.0f + c * c;
  const float g = sqrtf(clamp_min(s, F(1e-12)));
  const float gm = g - c, gp = g + c;
  const float den1 = clamp_min(gp, F(1e-12));
  const float q = gm / den1;
  const float factor1 = 0.5f * (q * q);
  const float den_raw = c * gm + 1.0f;
  const bool tiny = fabsf(den_raw) < F(1e-12);
  const float den = tiny ? F(1e-12) : den_raw;
  const float w = (c * gp - 1.0f) / den;
  const float factor2 = 1.0f + w * w;

  const float g_factor1 = g_f * factor2, g_factor2 = g_f * factor1;
  const float g_w = g_factor2 * (2.0f * w);
  const float g_num2 = g_w / den;
  const float g_den = tiny ? 0.0f : -g_w * (w / den);
  float g_c = g_den * gm + g_num2 * gp + g_num2 * c;
  float g_g = g_num2 * c;
  const float g_gm2 = g_den * c;  // c * (g - c)
  g_g += g_gm2;
  g_c -= g_gm2;
  const float g_q = (g_factor1 * 0.5f) * (2.0f * q);
  const float g_gm = g_q / den1;
  const float g_gp = gp >= F(1e-12) ? -g_q * (q / den1) : 0.0f;
  g_g += g_gm + g_gp;
  g_c += g_gp - g_gm;
  const float g_s = s >= F(1e-12) ? sqrt_bwd(g_g, g) : 0.0f;
  g_c += 2.0f * g_s * c;
  const float g_nn2 = g_s / nn1;
  const float g_nn1 = -g_s * (q1 / nn1);
  const float g_c_raw = g_c * sgn(c_raw);
  FresnelGrad out;
  out.wi = g_c_raw * half;
  out.half = g_c_raw * wi;
  out.n1 = 2.0f * g_nn1 * n1;
  out.n2 = 2.0f * g_nn2 * n2;
  return out;
}

struct ConductorGrad {
  V3 wi, half;
  float n, k;
};

__device__ ConductorGrad fresnel_conductor_bwd(V3 wi, V3 half, float n, float k, float g_fc) {
  const float n2 = n * n, k2 = k * k;
  const float cos_t = dot(wi, half);
  const float cos2 = cos_t * cos_t;
  const float sin2 = 1.0f - cos2;
  const float t0 = n2 - k2 - sin2;
  const float m = t0 * t0 + 4.0f * n2 * k2;
  const float a2b2 = sqrtf(clamp_min(m, 0.0f));
  const float h = 0.5f * (a2b2 + t0);
  const float a = sqrtf(clamp_min(h, 0.0f));
  const float t1 = a2b2 + cos2;
  const float t2 = 2.0f * a * cos_t;
  const float nm = t1 - t2, dn = t1 + t2;
  const float rs = nm / dn;
  const float p1 = cos2 * a2b2, p2 = p1 * sin2;
  const float t3 = p2 * sin2;
  const float t4 = t2 * sin2;
  const float denom = t3 + t4;
  const bool nonzero = denom != 0.0f;
  const float ratio = nonzero ? (t3 - t4) / denom : -1.0f;

  const float g_sum = 0.5f * g_fc;  // 0.5 * (rs + rp), rp = rs * ratio
  const float g_rs = g_sum + g_sum * ratio;
  const float g_ratio = g_sum * rs;
  float g_t3 = 0.0f, g_t4 = 0.0f;
  if (nonzero) {
    const float g_diff = g_ratio / denom;
    const float g_denom = -g_ratio * (ratio / denom);
    g_t3 = g_diff + g_denom;
    g_t4 = g_denom - g_diff;
  }
  float g_t2 = g_t4 * sin2;
  float g_sin2 = g_t4 * t2;
  const float g_p2 = g_t3 * sin2;
  g_sin2 += g_t3 * p2;
  const float g_p1 = g_p2 * sin2;
  g_sin2 += g_p2 * p1;
  float g_cos2 = g_p1 * a2b2;
  float g_a2b2 = g_p1 * cos2;
  const float g_nm = g_rs / dn;
  const float g_dn = -g_rs * (rs / dn);
  const float g_t1 = g_nm + g_dn;
  g_t2 += g_dn - g_nm;
  float g_cos_t = g_t2 * (2.0f * a);
  const float g_a = (g_t2 * cos_t) * 2.0f;
  g_a2b2 += g_t1;
  g_cos2 += g_t1;
  const float g_h = h >= 0.0f ? sqrt_bwd(g_a, a) : 0.0f;
  g_a2b2 += 0.5f * g_h;
  float g_t0 = 0.5f * g_h;
  const float g_m = m >= 0.0f ? sqrt_bwd(g_a2b2, a2b2) : 0.0f;
  g_t0 += 2.0f * g_m * t0;
  float g_n2 = 4.0f * (g_m * k2);
  float g_k2 = g_m * (4.0f * n2);
  g_n2 += g_t0;
  g_k2 -= g_t0;
  g_sin2 -= g_t0;
  g_cos2 -= g_sin2;
  g_cos_t += 2.0f * g_cos2 * cos_t;
  ConductorGrad out;
  out.wi = g_cos_t * half;
  out.half = g_cos_t * wi;
  out.n = 2.0f * g_n2 * n;
  out.k = 2.0f * g_k2 * k;
  return out;
}

struct DirNormalGrad {
  V3 dir, normal;
  float roughness;
};

// smith_lambda(dir, normal, roughness)'s reverse
__device__ DirNormalGrad smith_lambda_bwd(V3 dir, V3 normal, float roughness, float g_l) {
  const float d = dot(dir, normal);
  const float dd = d * d;
  const float d2 = clamp_min(dd, F(1e-12));
  const float tan2 = (1.0f - d2) / d2;
  const float root = sqrtf(1.0f + roughness * roughness + tan2);
  const float g_y = sqrt_bwd(g_l * 0.5f, root);
  const float g_num = g_y / d2;
  const float g_d2 = -g_num - g_y * (tan2 / d2);
  const float g_d = dd >= F(1e-12) ? 2.0f * g_d2 * d : 0.0f;
  DirNormalGrad out;
  out.dir = g_d * normal;
  out.normal = g_d * dir;
  out.roughness = 2.0f * g_y * roughness;
  return out;
}

struct SpecularGrad {
  V3 wi, wo, half, normal;
  float roughness;
};

// specular_weight(wi, wo, half, normal, roughness)'s reverse
__device__ SpecularGrad specular_weight_bwd(V3 wi, V3 wo, V3 half, V3 normal, float roughness,
                                            float g_sw) {
  const float li = smith_lambda(wi, normal, roughness), lo = smith_lambda(wo, normal, roughness);
  const float x = 1.0f + li + lo;
  const float gr = 1.0f / x;
  const float G = gr * 1.0f;
  const float ai = dot(wi, half), an = dot(normal, half), ci = dot(wi, normal);
  const float A = fabsf(ai), Bn = fabsf(an), Ci = fabsf(ci);
  const float bc = Bn * Ci;
  const float D = clamp_min(bc, F(1e-12));
  const float sw = A * G / D;

  const float g_ag = g_sw / D;
  const float g_D = -g_sw * (sw / D);
  const float g_A = g_ag * G, g_G = g_ag * A;
  const float g_bc = bc >= F(1e-12) ? g_D : 0.0f;
  const float g_ai = g_A * sgn(ai), g_an = (g_bc * Ci) * sgn(an), g_ci = (g_bc * Bn) * sgn(ci);
  const float g_x = -(g_G * 1.0f) * (gr * gr);
  const DirNormalGrad lwi = smith_lambda_bwd(wi, normal, roughness, g_x);
  const DirNormalGrad lwo = smith_lambda_bwd(wo, normal, roughness, g_x);
  SpecularGrad out;
  out.wi = g_ai * half + g_ci * normal + lwi.dir;
  out.wo = lwo.dir;
  out.half = g_ai * wi + g_an * normal;
  out.normal = g_an * half + g_ci * wi + lwi.normal + lwo.normal;
  out.roughness = lwi.roughness + lwo.roughness;
  return out;
}

struct PairGrad {
  V3 wi, half;
};

// reflect(wi, half) = (2 wi.half) half - wi
__device__ __forceinline__ PairGrad reflect_bwd(V3 wi, V3 half, V3 g) {
  const float k = 2.0f * dot(wi, half);
  const float g_dot = dotg(g, half) * 2.0f;
  return {g_dot * half - g, k * g + g_dot * wi};
}

struct RefractGrad {
  V3 wi, half;
  float n1, n2;
};

__device__ RefractGrad refract_bwd(V3 wi, V3 half, float n1, float n2, V3 g) {
  const float c = dot(wi, half);
  const float n = n1 / n2;
  const float nn = n * n, cc1 = c * c - 1.0f;
  const float z = 1.0f + nn * cc1;
  const float root = sqrtf(clamp_min(z, F(1e-12)));
  const float k = n * c - root;
  const float g_k = dotg(g, half);
  float g_n = -dotg(g, wi);
  const float g_z = z >= F(1e-12) ? sqrt_bwd(-g_k, root) : 0.0f;
  float g_c = g_k * n + 2.0f * (g_z * nn) * c;
  g_n += g_k * c + 2.0f * (g_z * cc1) * n;
  RefractGrad out;
  out.wi = g_c * half - n * g;
  out.half = k * g + g_c * wi;
  out.n1 = g_n / n2;
  out.n2 = -g_n * (n / n2);
  return out;
}

// scene/types.py sample_texture's texel index (sample_texture's own)
__device__ __forceinline__ int texel_index(const ShadeScene& s, int tex_id, float u, float v) {
  const int w = s.tex_width[tex_id], h = s.tex_height[tex_id], off = s.tex_offset[tex_id];
  return off + static_cast<int>(remainder1(v) * static_cast<float>(h)) * w +
         static_cast<int>(remainder1(u) * static_cast<float>(w));
}

// The gradient of sample_texture(tex_id, color, uv)'s color, and (into
// texel, texel_g) of its texel, from that of its result.
__device__ __forceinline__ V3 texture_bwd(const ShadeScene& s, int tex_id, V3 color, float u,
                                          float v, V3 g, int* texel, float* texel_g) {
  if (tex_id < 0) return g;
  *texel = texel_index(s, tex_id, u, v);
  const V3 gt = mul(g, color);
  texel_g[0] = gt.x;
  texel_g[1] = gt.y;
  texel_g[2] = gt.z;
  return mul(g, load3(s.texels, *texel));
}

// One ray's reverse pass: writes its ray gradients, fills its additions.
__device__ void bounce_backward_ray(const ShadeScene& s, const BackwardArgs& a, int64_t r,
                                    Contrib& out) {
  const V3 o = load3(a.ray_o, r), d = load3(a.ray_d, r);
  const V3 throughput = load3(a.throughput, r);
  const int idx = a.idx[r];
  const bool hit = a.hit[r] != 0, live = (a.active[r] != 0) && hit;
  const bool inside = a.inside[r] != 0, prev_diffuse = a.prev_diffuse[r] != 0;
  const float* u = a.u + r;
  const int64_t stride = a.u_stride;
  const V3 g_o_out = load3(a.g_ray_o, r), g_d_out = load3(a.g_ray_d, r);
  const V3 g_t_out = load3(a.g_throughput, r), g_rad = load3(a.g_radiance, r);
  if (!live) {  // the state passes through; nothing of the surface is taken
    store3(a.o_ray_o, r, g_o_out);
    store3(a.o_ray_d, r, g_d_out);
    store3(a.o_throughput, r, g_t_out);
    return;
  }

  // --- the forward of shade_bounce_kernel on a live lane
  const Tri tri = load_tri(s, idx > 0 ? idx : 0);
  const Geometry g = hit_geometry(tri, o, d, hit);
  const Material m = material(s, tri.mat, g.u, g.v);
  const bool emit = !prev_diffuse;
  const float tau = F(2.0 * kPi);
  const V3 wi = neg(d);
  const float rough = m.roughness;
  const float u0 = u[0], u1 = u[stride];
  const float a2 = rough * rough;
  const float z = u0 * (a2 - 1.0f) + 1.0f;
  const float denom = clamp_min(z, F(1e-12));
  const float y = (1.0f - u0) / denom;
  const float cos_t = sqrtf(clamp(y, 0.0f, 1.0f));
  const float x = 1.0f - cos_t * cos_t;
  const float sin_t = sqrtf(clamp_min(x, F(1e-12)));
  const float phi = u1 * tau;
  const float cp = cosf(phi), sp = sinf(phi);
  const V3 half = (sin_t * cp) * g.tangent + cos_t * g.normal + (sin_t * sp) * g.bitangent;

  enum Lobe { kMetal, kSpecular, kTransmission, kDiffuse } lobe;
  float n1 = 1.0f, n2 = 1.0f, f = 0.0f, ratio_spec = 1.0f, ratio_rest = 1.0f;
  const bool lrg = a.lobe_ratio_grad != 0;
  V3 direction, weight;
  float sw = 1.0f, fc = 0.0f;
  if (m.extinction > 0.0f) {
    lobe = kMetal;
    fc = fresnel_conductor(wi, half, m.ior, m.extinction);
    direction = reflect(wi, half);
    sw = specular_weight(wi, direction, half, g.normal, rough);
    weight = (sw * fc) * m.albedo;
  } else {
    const float ior = clamp_min(m.ior, F(1e-6));
    n1 = inside ? ior : 1.0f;
    n2 = inside ? 1.0f : ior;
    f = fresnel_dielectric(wi, half, n1, n2);
    ratio_spec = lrg ? f / clamp_min(f, F(1e-12)) : 1.0f;
    ratio_rest = lrg ? (1.0f - f) / clamp_min(1.0f - f, F(1e-12)) : 1.0f;
    if (u[2 * stride] < f) {
      lobe = kSpecular;
      direction = reflect(wi, half);
      if (!inside) sw = specular_weight(wi, direction, half, g.normal, rough);
      const float w = (sw * ratio_spec) * 1.0f;
      weight = {w, w, w};
    } else if (m.transparent > 0.5f) {
      lobe = kTransmission;
      direction = refract(wi, half, n1, n2);
      sw = specular_weight(wi, direction, half, g.normal, rough);
      weight = (sw * ratio_rest) * m.albedo;
    } else {
      lobe = kDiffuse;
      weight = ratio_rest * m.albedo;
    }
  }
  const V3 next_t = mul(throughput, weight);
  const bool diffuse = lobe == kDiffuse;

  // --- finish_bounce_kernel's reverse: Russian roulette, then the direct light
  V3 g_next_t = g_t_out;
  if (a.roulette != 0) {
    float survival = next_t.x;
    survival = (isnan(survival) || survival > next_t.y) ? survival : next_t.y;
    survival = (isnan(survival) || survival > next_t.z) ? survival : next_t.z;
    if (u[8 * stride] <= survival) {
      const float p = clamp_min(survival, F(1e-30));
      g_next_t = {g_t_out.x / p, g_t_out.y / p, g_t_out.z / p};
    }
  }
  V3 g_position = g_o_out, g_normal = {0.0f, 0.0f, 0.0f};
  if (s.has_lights && diffuse && a.shadow_hit[r] != 0) {
    const int n = s.num_lights;
    int pick = static_cast<int>(u[5 * stride] * static_cast<float>(n));
    pick = pick < 0 ? 0 : (pick > n - 1 ? n - 1 : pick);
    const int light = s.light_indices[pick];
    if (a.shadow_idx[r] == light) {  // visible: the direct light and its reverse
      const V3 p1 = load3(s.vertices, 3 * static_cast<int64_t>(light));
      const V3 p2 = load3(s.vertices, 3 * static_cast<int64_t>(light) + 1);
      const V3 p3 = load3(s.vertices, 3 * static_cast<int64_t>(light) + 2);
      const float sqrt_x = sqrtf(u[6 * stride]);
      const float bu = 1.0f - sqrt_x;
      const float bv = u[7 * stride] * sqrt_x;
      const float bw = 1.0f - bu - bv;
      const V3 point = bu * p1 + bv * p2 + bw * p3;
      const V3 to_light = point - g.position;
      const float dist_sq = dot(to_light, to_light);
      const V3 dir = normalize(to_light);
      const Tri lt = load_tri(s, light);
      const Geometry lg = hit_geometry(lt, g.position, dir, true);
      const int ltex = s.tex_id[lt.mat];
      const V3 em_color = load3(s.emittance, lt.mat);
      const V3 em = sample_texture(s, ltex, em_color, lg.u, lg.v);
      const V3 e = cross(p2 - p1, p3 - p1);
      const float light_area = 0.5f * sqrtf(dot(e, e));
      const float nd1 = -dot(dir, lg.normal);
      const float cos1 = clamp_min(nd1, 0.0f);
      const float d2 = dot(dir, g.normal);
      const float cos2 = clamp_min(d2, 0.0f);
      const float den_raw = dist_sq * F(kPi);
      const float den = clamp_min(den_raw, F(0.001));
      const float s0 = light_area * static_cast<float>(n);
      const float s1 = s0 * cos1, s2 = s1 * cos2;
      const float scale = s2 / den;
      const V3 direct = scale * em;
      // radiance + direct * next_t
      g_next_t = g_next_t + mul(g_rad, direct);
      const V3 g_direct = mul(g_rad, next_t);
      const V3 g_em = scale * g_direct;
      const float g_scale = dotg(g_direct, em);
      const float g_s2 = g_scale / den;
      const float g_den = den_raw >= F(0.001) ? -g_scale * (scale / den) : 0.0f;
      const float g_cos2 = g_s2 * s1, g_s1 = g_s2 * cos2;
      const float g_cos1 = g_s1 * s0;
      const float g_dist_sq = g_den * F(kPi);
      const float g_d1 = nd1 >= 0.0f ? -g_cos1 : 0.0f;  // cos1 = clamp_min(-dot, 0)
      const float g_d2 = d2 >= 0.0f ? g_cos2 : 0.0f;
      V3 g_dir = g_d1 * lg.normal + g_d2 * g.normal;
      g_normal = g_d2 * dir;
      const GeometryGrad lgg = hit_geometry_bwd(lt, g.position, dir, true, {0.0f, 0.0f, 0.0f},
                                                g_d1 * dir, {0.0f, 0.0f, 0.0f},
                                                {0.0f, 0.0f, 0.0f}, false);
      g_dir = g_dir + lgg.d;
      const V3 g_to_light = normalize_bwd(to_light, g_dir) + (2.0f * g_dist_sq) * to_light;
      g_position = g_position + lgg.o - g_to_light;
      out.light_mat = lt.mat;
      const V3 g_em_color = texture_bwd(s, ltex, em_color, lg.u, lg.v, g_em, &out.light_texel,
                                        out.light_texel_g);
      out.light_g[0] = g_em_color.x;
      out.light_g[1] = g_em_color.y;
      out.light_g[2] = g_em_color.z;
    }
  }

  // --- shade_bounce_kernel's reverse: the state, the emission, the lobe
  V3 g_throughput = mul(g_next_t, weight);
  const V3 g_weight = mul(g_next_t, throughput);
  V3 g_emittance = {0.0f, 0.0f, 0.0f};
  if (emit) {  // radiance + emittance * throughput
    g_emittance = mul(g_rad, throughput);
    g_throughput = g_throughput + mul(g_rad, m.emittance);
  }
  V3 g_albedo = {0.0f, 0.0f, 0.0f}, g_wi = {0.0f, 0.0f, 0.0f}, g_half = {0.0f, 0.0f, 0.0f};
  V3 g_tangent = {0.0f, 0.0f, 0.0f}, g_bitangent = {0.0f, 0.0f, 0.0f};
  float g_rough = 0.0f, g_f = 0.0f, g_n1 = 0.0f, g_n2 = 0.0f, g_ior = 0.0f, g_ext = 0.0f;
  const V3 g_dir = g_d_out;
  if (lobe == kMetal) {
    g_albedo = (sw * fc) * g_weight;
    const float g_swfc = dotg(g_weight, m.albedo);
    const SpecularGrad sg = specular_weight_bwd(wi, direction, half, g.normal, rough,
                                                g_swfc * fc);
    const ConductorGrad cg = fresnel_conductor_bwd(wi, half, m.ior, m.extinction, g_swfc * sw);
    const PairGrad rg = reflect_bwd(wi, half, g_dir + sg.wo);
    g_wi = sg.wi + cg.wi + rg.wi;
    g_half = sg.half + cg.half + rg.half;
    g_normal = g_normal + sg.normal;
    g_rough = sg.roughness;
    g_ior = cg.n;
    g_ext = cg.k;
  } else if (lobe == kSpecular) {
    const float g_w = sum3(g_weight);
    V3 g_refl = g_dir;
    if (!inside) {
      const SpecularGrad sg = specular_weight_bwd(wi, direction, half, g.normal, rough,
                                                  g_w * ratio_spec);
      g_wi = sg.wi;
      g_half = sg.half;
      g_normal = g_normal + sg.normal;
      g_rough = sg.roughness;
      g_refl = g_refl + sg.wo;
    }
    if (lrg) g_f = (g_w * sw) / clamp_min(f, F(1e-12));
    const PairGrad rg = reflect_bwd(wi, half, g_refl);
    g_wi = g_wi + rg.wi;
    g_half = g_half + rg.half;
  } else if (lobe == kTransmission) {
    g_albedo = (sw * ratio_rest) * g_weight;
    const float g_swr = dotg(g_weight, m.albedo);
    const SpecularGrad sg = specular_weight_bwd(wi, direction, half, g.normal, rough,
                                                g_swr * ratio_rest);
    const RefractGrad rg = refract_bwd(wi, half, n1, n2, g_dir + sg.wo);
    if (lrg) g_f = -((g_swr * sw) / clamp_min(1.0f - f, F(1e-12)));
    g_wi = sg.wi + rg.wi;
    g_half = sg.half + rg.half;
    g_normal = g_normal + sg.normal;
    g_rough = sg.roughness;
    g_n1 = rg.n1;
    g_n2 = rg.n2;
  } else {  // diffuse: the cosine hemisphere's frame
    g_albedo = ratio_rest * g_weight;
    if (lrg) g_f = -(dotg(g_weight, m.albedo) / clamp_min(1.0f - f, F(1e-12)));
    const float phi_d = u[3 * stride] * tau, u4 = u[4 * stride];
    const float sq = sqrtf(u4), ct = sqrtf(1.0f - u4);
    g_tangent = (sq * cosf(phi_d)) * g_dir;
    g_normal = g_normal + ct * g_dir;
    g_bitangent = (sq * sinf(phi_d)) * g_dir;
  }
  if (lobe != kMetal) {
    if (lrg) {
      const FresnelGrad fg = fresnel_dielectric_bwd(wi, half, n1, n2, g_f);
      g_wi = g_wi + fg.wi;
      g_half = g_half + fg.half;
      g_n1 += fg.n1;
      g_n2 += fg.n2;
    }
    // n1 = where(inside, ior, 1), n2 = where(inside, 1, ior), ior = clamp_min(ior, 1e-6)
    const float g_ior_c = inside ? g_n1 : g_n2;
    g_ior = m.ior >= F(1e-6) ? g_ior_c : 0.0f;
  }
  // the GGX half vector
  g_tangent = g_tangent + (sin_t * cp) * g_half;
  g_normal = g_normal + cos_t * g_half;
  g_bitangent = g_bitangent + (sin_t * sp) * g_half;
  const float g_sin_t = dotg(g_half, g.tangent) * cp + dotg(g_half, g.bitangent) * sp;
  float g_cos_t = dotg(g_half, g.normal);
  const float g_x = x >= F(1e-12) ? sqrt_bwd(g_sin_t, sin_t) : 0.0f;
  g_cos_t -= 2.0f * g_x * cos_t;
  const float g_y = (y >= 0.0f && y <= 1.0f) ? sqrt_bwd(g_cos_t, cos_t) : 0.0f;
  const float g_denom = -g_y * (y / denom);
  const float g_a2 = z >= F(1e-12) ? g_denom * u0 : 0.0f;
  g_rough += 2.0f * g_a2 * rough;

  const GeometryGrad gg = hit_geometry_bwd(tri, o, d, hit, g_position, g_normal, g_tangent,
                                           g_bitangent, true);
  store3(a.o_ray_o, r, gg.o);
  store3(a.o_ray_d, r, gg.d - g_wi);
  store3(a.o_throughput, r, g_throughput);

  out.mat = tri.mat;
  const int tex = s.tex_id[tri.mat];
  const V3 albedo_color = load3(s.albedo, tri.mat), em_color = load3(s.emittance, tri.mat);
  float tg[3] = {0.0f, 0.0f, 0.0f};
  const V3 ga = texture_bwd(s, tex, albedo_color, g.u, g.v, g_albedo, &out.texel, out.texel_g);
  const V3 ge = texture_bwd(s, tex, em_color, g.u, g.v, g_emittance, &out.texel, tg);
  for (int k = 0; k < 3; ++k) out.texel_g[k] += tg[k];
  const float vals[9] = {ga.x, ga.y, ga.z, ge.x, ge.y, ge.z, g_rough, g_ior, g_ext};
  for (int k = 0; k < 9; ++k) out.mat_g[k] = vals[k];
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Adds each lane's n values at dst + key * stride (key < 0: nothing), one
// atomic a (group of lanes with one key, value). Every lane of the warp
// calls it.
template <int N>
__device__ __forceinline__ void warp_add(int key, const float* v, double* dst, int stride) {
  const int lane = threadIdx.x & 31;
  const bool has = key >= 0;
  const unsigned peers = __match_any_sync(kFull, key);
  const bool alone = __popc(peers) == 1;
  if (has && alone) {
    for (int f = 0; f < N; ++f) {
      atomicAdd(dst + static_cast<int64_t>(key) * stride + f, static_cast<double>(v[f]));
    }
  }
  unsigned todo = __ballot_sync(kFull, has && !alone);
  while (todo != 0) {
    const int leader = __ffs(todo) - 1;
    const int k = __shfl_sync(kFull, key, leader);
    const bool mine = key == k;
    for (int f = 0; f < N; ++f) {
      const double sum = warp_sum(mine ? v[f] : 0.0f);
      if (lane == leader) atomicAdd(dst + static_cast<int64_t>(k) * stride + f, sum);
    }
    todo &= ~__ballot_sync(kFull, mine);
  }
}

__global__ void __launch_bounds__(kShadeThreads)
bounce_backward_kernel(const ShadeScene s, const BackwardArgs a) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kShadeThreads + threadIdx.x;
  Contrib c;
  if (r < a.num_rays) bounce_backward_ray(s, a, r, c);
  // every lane of the warp takes part in the sums
  if (a.o_material != nullptr) {
    warp_add<9>(c.mat, c.mat_g, a.o_material, 9);
    warp_add<3>(c.light_mat, c.light_g, a.o_material + 3, 9);
  }
  if (a.o_texels != nullptr) {
    warp_add<3>(c.texel, c.texel_g, a.o_texels, 3);
    warp_add<3>(c.light_texel, c.light_texel_g, a.o_texels, 3);
  }
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 =
// launched). The structs are host memory, copied into the launch's
// parameters. Allocates nothing and does not synchronise; o_material and
// o_texels must hold zeros (or sums to add to).
extern "C" int bounce_backward(int device, const ShadeScene* scene, const BackwardArgs* args,
                               void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args->num_rays > 0) {
    const dim3 grid((args->num_rays + kShadeThreads - 1) / kShadeThreads);
    bounce_backward_kernel<<<grid, kShadeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *scene, *args);
  }
  return static_cast<int>(cudaGetLastError());
}

#else  // a host build of the same per-ray code, for the CPU tests

// The kernel's arithmetic ray after ray on the host, the sums in ray
// order (in float64, as the kernel's). Returns 0.
extern "C" int bounce_backward_host(const ShadeScene* scene, const BackwardArgs* args) {
  for (int64_t r = 0; r < args->num_rays; ++r) {
    Contrib c;
    bounce_backward_ray(*scene, *args, r, c);
    if (args->o_material != nullptr) {
      if (c.mat >= 0)
        for (int f = 0; f < 9; ++f) args->o_material[9 * c.mat + f] += c.mat_g[f];
      if (c.light_mat >= 0)
        for (int f = 0; f < 3; ++f) args->o_material[9 * c.light_mat + 3 + f] += c.light_g[f];
    }
    if (args->o_texels != nullptr) {
      if (c.texel >= 0)
        for (int f = 0; f < 3; ++f) args->o_texels[3 * c.texel + f] += c.texel_g[f];
      if (c.light_texel >= 0)
        for (int f = 0; f < 3; ++f) args->o_texels[3 * c.light_texel + f] += c.light_texel_g[f];
    }
  }
  return 0;
}

#endif
