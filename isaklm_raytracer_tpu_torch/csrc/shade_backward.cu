// The reverse mode of a bounce's shading for Hopper (sm_90a): a binning
// pass and the reverse itself, one thread a ray.
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
// pass, so one thread runs both: it recomputes its ray's forward in
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
// What bounds it on the H100: operations. At the demo's bounce 0 (262,144
// rays) a call must move about 37 MB (a ray's state, uniforms, shadow hit
// and output gradients in, three gradients out: 11 us at the HBM rate) and
// issue about 5e8 slots (the forward again and its reverse, 1,700-2,700 a
// live ray by its lobe and shadow hit: 15 us; chip_smoke.py
// shade_backward_bound). Three things held a first kernel (one thread a
// ray in pixel order, sums by global atomics) at a tenth of that:
//
// - Divergence. Each lobe's reverse and the direct light's are long
//   branches, and the lobe is drawn per ray: a warp ran several. So
//   bounce_bin_kernel first sorts the live rays by class (RayClass: the
//   lobe the forward chose and, for a diffuse lobe, whether its shadow ray
//   saw the picked light; the forward kernels write it, a byte a ray) into
//   one segment of a ray list each, by a block-local counting sort and one
//   atomic a (block, class); it writes the pass-through gradients of the
//   dead lanes.
//   bounce_backward_kernel's warps then take 32 consecutive entries of
//   one segment: a warp runs one lobe's code.
// - Registers. The reverse needs the forward's intermediates at once (the
//   first kernel: 180 registers a thread, 8 warps an SM). The code after
//   the lobe choice is one inlined tail a lobe (lobe_reverse), so no lobe
//   holds another's values; the direct light, which only the diffuse tail
//   runs, was the peak, so that tail reads the throughput and the material
//   again after it and computes the half vector again, and every tail
//   reads the ray origin and the triangle again for the geometry's
//   reverse, behind a compiler barrier (READ_AGAIN) so that the values
//   are not kept. __launch_bounds__ then holds a thread to 128 registers
//   without spills (2 blocks of 256 an SM, 16 warps) to hide the loads of
//   the hit's row, its material, texels and uniforms.
// - The sums. The material and texel gradients are sums over the rays,
//   and every ray that hits one material adds to the same few addresses. A
//   warp adds one sum a run of neighbouring lanes with one material (and
//   texel) and field, by a segmented scan of shuffles (warp_add). The
//   kernel's blocks are persistent (as many as stay resident, each walking
//   the list), and each keeps an (M, 12) float64 table in shared memory (9
//   material fields, the light's emittance 3) that takes its warps' sums
//   and is flushed once, one global atomic a non-zero (block, row, field).
//   Above kTableRows materials the warps' sums go to device memory as they
//   come. The texel sums (thousands of addresses) go to device memory by
//   the warps' runs. The order of the atomics differs from run to run, so these sums are
//   not bit for bit the same from run to run; they are kept in float64
//   (one rounding to float32 at the end), since a float32 sum drifts where one term is added tens of thousands
//   of times (the plain version's index_add over a 512x512 wavefront: up
//   to 7e-4 of the light's emittance gradient on the H100).
//
// The binning's first version was held by latency, not bytes: a
// thread a ray derived the class through dependent loads (the hit id, its
// row's material id, the material's extinction; the light pick), then one
// global atomic a (block, class) placed the block's rays, and the counts
// and sums took a zero fill of their own; 4.0-4.4 us a call at the demo's
// and the hero's first bounce, whose bytes differ by 1.9x. Now the class
// is one byte the forward wrote; a block takes four times the rays (a
// quarter of the atomics), each class's counter on a line of its own; the
// counters persist between calls and the reverse's last block leaves them
// at zero (no fill: the binning zeroes the sums). A version without
// atomics (each block's rays in a part of the list of its own, the
// reverse finding an entry's part by a binary search over the blocks'
// counts) made the reverse 4-7 us slower a call than the binning saved.
// What bounds it: bytes, a ray's class byte, a live ray's list entry and a
// dead ray's three gradients in and out (chip_smoke.py shade_bin_bound).
//
// Each ray's arithmetic is that of the first kernel op for op, so its
// gradients are too: only which lanes share a warp, how many registers a
// thread holds and how the sums reach device memory changed.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "shade_common.cuh"

// Field for field the ctypes structure of kernels/shade.py.
struct BackwardArgs {
  const float* ray_o;  // (R, 3) the bounce's inputs
  const float* ray_d;
  const int32_t* idx;  // (R,) the bounce's hit ids, -1 = miss
  const float* throughput;  // (R, 3)
  const uint8_t* inside;  // (R,) bool
  const uint8_t* prev_diffuse;
  const float* u;  // (9, R) the bounce's uniforms, rows u_stride apart
  const int32_t* shadow_idx;  // (R,) the shadow rays' hit ids; null without lights
  const uint8_t* shadow_hit;
  const uint8_t* ray_class;  // (R,) each ray's RayClass, as the forward wrote it
  const float* g_ray_o;  // (R, 3) the gradients of the bounce's outputs
  const float* g_ray_d;
  const float* g_throughput;
  const float* g_radiance;
  float* o_ray_o;  // (R, 3) the gradients of its inputs
  float* o_ray_d;
  float* o_throughput;
  double* o_material;  // (M, 9) added to: albedo, emittance, roughness, ior, extinction; or null
  double* o_texels;  // (P, 3) added to; or null
  int32_t* ray_list;  // (kLiveClasses, R): the live rays of each class, the binning's output
  // (kCounterWords,): class c's count at word kCountStride c, zero on the
  // binning's entry; the reverse's blocks count themselves out at word
  // kDoneWord, and the last one leaves every word zero for the next call
  int32_t* counters;
  void* zero;  // zero_words 16-byte words the binning zeroes (the sums the reverse adds to)
  int64_t zero_words;
  int64_t u_stride;
  int32_t num_rays;
  int32_t num_materials;
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


// The light nee.shadow_rays picked from the uniform u5.
__device__ __forceinline__ int picked_light(const ShadeScene& s, float u5) {
  const int n = s.num_lights;
  int pick = static_cast<int>(u5 * static_cast<float>(n));
  pick = pick < 0 ? 0 : (pick > n - 1 ? n - 1 : pick);
  return s.light_indices[pick];
}

// The binning: blocks of kBinThreads, each over a tile of kBinTile rays
// (kBinRounds a thread, in rounds of kBinThreads consecutive ones).
constexpr int kBinThreads = 256, kBinRounds = 4, kBinTile = kBinThreads * kBinRounds;
// The counters: a class's count on a line of its own (kCountStride words
// apart, so that the blocks' atomics on different classes do not queue on
// one address), then the reverse's count of finished blocks.
constexpr int kCountStride = 32, kDoneWord = kClassCounts * kCountStride;
constexpr int kCounterWords = kDoneWord + 1;

// A dead lane's state passes through.
__device__ __forceinline__ void pass_through(const BackwardArgs& a, int64_t r) {
  store3(a.o_ray_o, r, load3(a.g_ray_o, r));
  store3(a.o_ray_d, r, load3(a.g_ray_d, r));
  store3(a.o_throughput, r, load3(a.g_throughput, r));
}

// A compiler barrier: what the code reads from memory after it is read
// again rather than kept in registers since before (a value read or
// computed again by the same operations is the same, bit for bit, and a
// register held through a long stretch of code costs resident warps).
#define READ_AGAIN() asm volatile("" ::: "memory")

// The GGX half vector's terms (scatter's) from its two uniforms and the
// roughness.
struct HalfTerms {
  float u0, z, denom, y, cos_t, x, sin_t, cp, sp;
};

__device__ __forceinline__ HalfTerms half_terms(float u0, float u1, float rough) {
  HalfTerms h;
  const float tau = F(2.0 * kPi);
  h.u0 = u0;
  const float a2 = rough * rough;
  h.z = u0 * (a2 - 1.0f) + 1.0f;
  h.denom = clamp_min(h.z, F(1e-12));
  h.y = (1.0f - u0) / h.denom;
  h.cos_t = sqrtf(clamp(h.y, 0.0f, 1.0f));
  h.x = 1.0f - h.cos_t * h.cos_t;
  h.sin_t = sqrtf(clamp_min(h.x, F(1e-12)));
  const float phi = u1 * tau;
  h.cp = cosf(phi);
  h.sp = sinf(phi);
  return h;
}

// shade_bounce_kernel's forward on a live lane up to the choice of the
// lobe: what the lobes' tails read.
struct Front {
  V3 d, throughput;
  int tri_id, mat;  // the hit's row, read again for the geometry's reverse, and material
  bool inside, emit;
  Geometry g;
  Material m;
  V3 wi, half;
  float n1, n2, f;  // a dielectric's indices and Fresnel term
};

enum Lobe { kMetalLobe, kSpecularLobe, kTransmissionLobe, kDiffuseLobe };

// The reverse of the GGX half vector and of the hit's geometry from the
// gradients the lobe's tail gathered; writes the ray's gradients and fills
// its additions of the hit's material and texel.
__device__ __forceinline__ void front_reverse(const ShadeScene& s, const BackwardArgs& a, int64_t r,
                                              const Front& fr, V3 g_half, V3 g_tangent,
                                              V3 g_normal, V3 g_bitangent, float g_rough,
                                              V3 g_position, V3 g_wi, V3 g_throughput,
                                              V3 g_albedo, V3 g_emittance, float g_ior,
                                              float g_ext, float rough, Contrib& out) {
  READ_AGAIN();  // the half vector's terms and the ray and triangle again
  const HalfTerms h = half_terms(a.u[r], a.u[r + a.u_stride], rough);
  g_tangent = g_tangent + (h.sin_t * h.cp) * g_half;
  g_normal = g_normal + h.cos_t * g_half;
  g_bitangent = g_bitangent + (h.sin_t * h.sp) * g_half;
  const float g_sin_t = dotg(g_half, fr.g.tangent) * h.cp + dotg(g_half, fr.g.bitangent) * h.sp;
  float g_cos_t = dotg(g_half, fr.g.normal);
  const float g_x = h.x >= F(1e-12) ? sqrt_bwd(g_sin_t, h.sin_t) : 0.0f;
  g_cos_t -= 2.0f * g_x * h.cos_t;
  const float g_y = (h.y >= 0.0f && h.y <= 1.0f) ? sqrt_bwd(g_cos_t, h.cos_t) : 0.0f;
  const float g_denom = -g_y * (h.y / h.denom);
  const float g_a2 = h.z >= F(1e-12) ? g_denom * h.u0 : 0.0f;
  g_rough += 2.0f * g_a2 * rough;

  const V3 o = load3(a.ray_o, r);
  const Tri tri = load_tri(s, fr.tri_id);
  const GeometryGrad gg = hit_geometry_bwd(tri, o, fr.d, true, g_position, g_normal, g_tangent,
                                           g_bitangent, true);
  store3(a.o_ray_o, r, gg.o);
  store3(a.o_ray_d, r, gg.d - g_wi);
  store3(a.o_throughput, r, g_throughput);

  out.mat = tri.mat;
  const int tex = s.tex_id[tri.mat];
  const V3 albedo_color = load3(s.albedo, tri.mat), em_color = load3(s.emittance, tri.mat);
  float tg[3] = {0.0f, 0.0f, 0.0f};
  const V3 ga = texture_bwd(s, tex, albedo_color, fr.g.u, fr.g.v, g_albedo, &out.texel,
                            out.texel_g);
  const V3 ge = texture_bwd(s, tex, em_color, fr.g.u, fr.g.v, g_emittance, &out.texel, tg);
  for (int k = 0; k < 3; ++k) out.texel_g[k] += tg[k];
  const float vals[9] = {ga.x, ga.y, ga.z, ge.x, ge.y, ge.z, g_rough, g_ior, g_ext};
  for (int k = 0; k < 9; ++k) out.mat_g[k] = vals[k];
}

// The rest of a live lane's reverse pass once its lobe is known: the
// lobe's forward, finish_bounce_kernel's reverse (Russian roulette; the
// direct light on a diffuse lobe), then shade_bounce_kernel's (the state,
// the emission, the lobe). One inlined copy a lobe, so no lobe holds
// another's values.
template <int kLobe>
__device__ __forceinline__ void lobe_reverse(const ShadeScene& s, const BackwardArgs& a, int64_t r,
                                             const Front& fr, Contrib& out) {
  const float* u = a.u + r;
  const int64_t stride = a.u_stride;
  const bool lrg = a.lobe_ratio_grad != 0;
  const Geometry& g = fr.g;
  // the material, the throughput and the half vector: the diffuse tail reads
  // them again after the direct light rather than hold them through it
  Material m = fr.m;
  V3 throughput = fr.throughput, half = fr.half;
  const V3 wi = fr.wi;
  const float rough = m.roughness;

  // --- the lobe's forward: ratio is ratio_spec of a specular lobe,
  // ratio_rest of a transmission or a diffuse one
  float sw = 1.0f, fc = 0.0f, ratio = 1.0f;
  V3 direction = {0.0f, 0.0f, 0.0f}, weight;
  if constexpr (kLobe == kMetalLobe) {
    fc = fresnel_conductor(wi, half, m.ior, m.extinction);
    direction = reflect(wi, half);
    sw = specular_weight(wi, direction, half, g.normal, rough);
    weight = (sw * fc) * m.albedo;
  } else if constexpr (kLobe == kSpecularLobe) {
    ratio = lrg ? fr.f / clamp_min(fr.f, F(1e-12)) : 1.0f;
    direction = reflect(wi, half);
    if (!fr.inside) sw = specular_weight(wi, direction, half, g.normal, rough);
    const float w = (sw * ratio) * 1.0f;
    weight = {w, w, w};
  } else {
    ratio = lrg ? (1.0f - fr.f) / clamp_min(1.0f - fr.f, F(1e-12)) : 1.0f;
    if constexpr (kLobe == kTransmissionLobe) {
      direction = refract(wi, half, fr.n1, fr.n2);
      sw = specular_weight(wi, direction, half, g.normal, rough);
      weight = (sw * ratio) * m.albedo;
    } else {
      weight = ratio * m.albedo;
    }
  }
  const V3 next_t = mul(throughput, weight);

  // --- finish_bounce_kernel's reverse: Russian roulette, then the direct light
  const V3 g_t_out = load3(a.g_throughput, r);
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
  const V3 g_rad = load3(a.g_radiance, r);
  V3 g_position = load3(a.g_ray_o, r), g_normal = {0.0f, 0.0f, 0.0f};
  if constexpr (kLobe == kDiffuseLobe) {
    if (s.has_lights && a.shadow_hit[r] != 0) {
      const int light = picked_light(s, u[5 * stride]);
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
        const float s0 = light_area * static_cast<float>(s.num_lights);
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
    READ_AGAIN();
    throughput = load3(a.throughput, r);
    m = material(s, fr.mat, g.u, g.v);
    const HalfTerms h = half_terms(u[0], u[stride], m.roughness);
    half = (h.sin_t * h.cp) * g.tangent + h.cos_t * g.normal + (h.sin_t * h.sp) * g.bitangent;
    weight = ratio * m.albedo;
  }

  // --- shade_bounce_kernel's reverse: the state, the emission, the lobe
  V3 g_throughput = mul(g_next_t, weight);
  const V3 g_weight = mul(g_next_t, throughput);
  V3 g_emittance = {0.0f, 0.0f, 0.0f};
  if (fr.emit) {  // radiance + emittance * throughput
    g_emittance = mul(g_rad, throughput);
    g_throughput = g_throughput + mul(g_rad, m.emittance);
  }
  V3 g_albedo = {0.0f, 0.0f, 0.0f}, g_wi = {0.0f, 0.0f, 0.0f}, g_half = {0.0f, 0.0f, 0.0f};
  V3 g_tangent = {0.0f, 0.0f, 0.0f}, g_bitangent = {0.0f, 0.0f, 0.0f};
  float g_rough = 0.0f, g_f = 0.0f, g_n1 = 0.0f, g_n2 = 0.0f, g_ior = 0.0f, g_ext = 0.0f;
  const V3 g_dir = load3(a.g_ray_d, r);
  if constexpr (kLobe == kMetalLobe) {
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
  } else if constexpr (kLobe == kSpecularLobe) {
    const float g_w = sum3(g_weight);
    V3 g_refl = g_dir;
    if (!fr.inside) {
      const SpecularGrad sg = specular_weight_bwd(wi, direction, half, g.normal, rough,
                                                  g_w * ratio);
      g_wi = sg.wi;
      g_half = sg.half;
      g_normal = g_normal + sg.normal;
      g_rough = sg.roughness;
      g_refl = g_refl + sg.wo;
    }
    if (lrg) g_f = (g_w * sw) / clamp_min(fr.f, F(1e-12));
    const PairGrad rg = reflect_bwd(wi, half, g_refl);
    g_wi = g_wi + rg.wi;
    g_half = g_half + rg.half;
  } else if constexpr (kLobe == kTransmissionLobe) {
    g_albedo = (sw * ratio) * g_weight;
    const float g_swr = dotg(g_weight, m.albedo);
    const SpecularGrad sg = specular_weight_bwd(wi, direction, half, g.normal, rough,
                                                g_swr * ratio);
    const RefractGrad rg = refract_bwd(wi, half, fr.n1, fr.n2, g_dir + sg.wo);
    if (lrg) g_f = -((g_swr * sw) / clamp_min(1.0f - fr.f, F(1e-12)));
    g_wi = sg.wi + rg.wi;
    g_half = sg.half + rg.half;
    g_normal = g_normal + sg.normal;
    g_rough = sg.roughness;
    g_n1 = rg.n1;
    g_n2 = rg.n2;
  } else {  // diffuse: the cosine hemisphere's frame
    g_albedo = ratio * g_weight;
    if (lrg) g_f = -(dotg(g_weight, m.albedo) / clamp_min(1.0f - fr.f, F(1e-12)));
    const float tau = F(2.0 * kPi);
    const float phi_d = u[3 * stride] * tau, u4 = u[4 * stride];
    const float sq = sqrtf(u4), ct = sqrtf(1.0f - u4);
    g_tangent = (sq * cosf(phi_d)) * g_dir;
    g_normal = g_normal + ct * g_dir;
    g_bitangent = (sq * sinf(phi_d)) * g_dir;
  }
  if constexpr (kLobe != kMetalLobe) {
    if (lrg) {
      const FresnelGrad fg = fresnel_dielectric_bwd(wi, half, fr.n1, fr.n2, g_f);
      g_wi = g_wi + fg.wi;
      g_half = g_half + fg.half;
      g_n1 += fg.n1;
      g_n2 += fg.n2;
    }
    // n1 = where(inside, ior, 1), n2 = where(inside, 1, ior), ior = clamp_min(ior, 1e-6)
    const float g_ior_c = fr.inside ? g_n1 : g_n2;
    g_ior = m.ior >= F(1e-6) ? g_ior_c : 0.0f;
  }
  front_reverse(s, a, r, fr, g_half, g_tangent, g_normal, g_bitangent, g_rough, g_position, g_wi,
                g_throughput, g_albedo, g_emittance, g_ior, g_ext, m.roughness, out);
}

// One live ray's reverse pass: writes its ray gradients, fills its
// additions. (A dead ray's state passes through: pass_through.)
__device__ void bounce_backward_ray(const ShadeScene& s, const BackwardArgs& a, int64_t r,
                                    Contrib& out) {
  // --- the forward of shade_bounce_kernel on a live lane (hit is true)
  Front fr;
  const V3 o = load3(a.ray_o, r);
  fr.d = load3(a.ray_d, r);
  fr.throughput = load3(a.throughput, r);
  const int idx = a.idx[r];
  fr.tri_id = idx > 0 ? idx : 0;
  fr.inside = a.inside[r] != 0;
  fr.emit = a.prev_diffuse[r] == 0;
  const Tri tri = load_tri(s, fr.tri_id);
  fr.g = hit_geometry(tri, o, fr.d, true);
  fr.mat = tri.mat;
  fr.m = material(s, tri.mat, fr.g.u, fr.g.v);
  const float* u = a.u + r;
  const int64_t stride = a.u_stride;
  fr.wi = neg(fr.d);
  const HalfTerms h = half_terms(u[0], u[stride], fr.m.roughness);
  fr.half = (h.sin_t * h.cp) * fr.g.tangent + h.cos_t * fr.g.normal +
            (h.sin_t * h.sp) * fr.g.bitangent;
  // --- the lobe, chosen as the forward chose it
  fr.n1 = fr.n2 = 1.0f;
  fr.f = 0.0f;
  if (fr.m.extinction > 0.0f) {
    lobe_reverse<kMetalLobe>(s, a, r, fr, out);
    return;
  }
  const float ior = clamp_min(fr.m.ior, F(1e-6));
  fr.n1 = fr.inside ? ior : 1.0f;
  fr.n2 = fr.inside ? 1.0f : ior;
  fr.f = fresnel_dielectric(fr.wi, fr.half, fr.n1, fr.n2);
  if (u[2 * stride] < fr.f) {
    lobe_reverse<kSpecularLobe>(s, a, r, fr, out);
  } else if (fr.m.transparent > 0.5f) {
    lobe_reverse<kTransmissionLobe>(s, a, r, fr, out);
  } else {
    lobe_reverse<kDiffuseLobe>(s, a, r, fr, out);
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBinWarps = kBinThreads / 32;
// The reverse: blocks of kBackwardThreads, at least kBackwardMinBlocks of
// them resident an SM, so at most 65,536 / (256 x 2) = 128 registers a
// thread and 16 warps an SM.
constexpr int kBackwardThreads = 256, kBackwardMinBlocks = 2;
constexpr int kBackwardWarps = kBackwardThreads / 32;
// The material sums' table in shared memory: 9 fields and the light's
// emittance a material, at most kTableRows materials (24 KB).
constexpr int kTableCols = 12, kTableRows = 256;
constexpr size_t kTableBytes = sizeof(double) * kTableCols * kTableRows;

// Adds each lane's n values at dst + key * stride (key < 0: nothing), one
// atomic a (run of neighbouring lanes with one key, value): an inclusive
// scan of shuffles within each run, whose last lane adds the sum (the
// binning keeps a segment in ray order, so neighbouring lanes are
// neighbouring pixels, most often on one material and one texel). Every
// lane of the warp calls it. dst is device or shared memory.
template <int N>
__device__ __forceinline__ void warp_add(int key, const float* v, double* dst, int stride) {
  if (__all_sync(kFull, key < 0)) return;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, key, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || key != prev);
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));  // the run's first lane
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u) != 0;
  // the fields' scans side by side (independent chains of shuffles), then
  // the atomics
  double sum[N];
  for (int f = 0; f < N; ++f) sum[f] = v[f];
  for (int d = 1; d < 32; d <<= 1) {
    for (int f = 0; f < N; ++f) {
      const double up = __shfl_up_sync(kFull, sum[f], d);
      if (lane - d >= start) sum[f] += up;
    }
  }
  if (last && key >= 0) {
    for (int f = 0; f < N; ++f) atomicAdd(dst + static_cast<int64_t>(key) * stride + f, sum[f]);
  }
}

// The binning: one block a tile of kBinTile rays. Each thread reads its
// rays' class bytes (the forward's), passes a dead ray's gradients through
// (every load before any store, so that they overlap) and counts its
// warp's rays of each class (__match_any_sync); the block's scan of those
// counts over (round, warp) places each ray within the block's part of
// its class's segment, and one atomic a (block, class) on the counters
// places the part (ray order within a part; the parts in the order of the
// atomics). The blocks also zero the sums the reverse adds to (zero_words
// 16-byte words), which took a fill of its own before.
__global__ void __launch_bounds__(kBinThreads) bounce_bin_kernel(const BackwardArgs a) {
  __shared__ int offset[kBinRounds][kBinWarps][kLiveClasses];  // a count, then its offset
  __shared__ int base[kLiveClasses];  // the block's first entry of each segment
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBinThreads;
  uint4* zero = static_cast<uint4*>(a.zero);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kBinThreads + threadIdx.x;
       i < a.zero_words; i += stride) {
    zero[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int64_t num = a.num_rays;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kBinTile;
  int c[kBinRounds];
  for (int k = 0; k < kBinRounds; ++k) {
    const int64_t r = tile + k * kBinThreads + threadIdx.x;
    c[k] = r < num ? a.ray_class[r] : kDead;
  }
  V3 go[kBinRounds], gd[kBinRounds], gt[kBinRounds];
  for (int k = 0; k < kBinRounds; ++k) {
    const int64_t r = tile + k * kBinThreads + threadIdx.x;
    if (c[k] == kDead && r < num) {
      go[k] = load3(a.g_ray_o, r);
      gd[k] = load3(a.g_ray_d, r);
      gt[k] = load3(a.g_throughput, r);
    }
  }
  unsigned peers[kBinRounds];
  for (int k = 0; k < kBinRounds; ++k) {
    peers[k] = __match_any_sync(kFull, c[k]);
    if (lane < kLiveClasses) offset[k][warp][lane] = 0;
  }
  __syncwarp();
  for (int k = 0; k < kBinRounds; ++k) {
    if (c[k] != kDead && lane == __ffs(peers[k]) - 1) offset[k][warp][c[k]] = __popc(peers[k]);
  }
  __syncthreads();
  if (threadIdx.x < kLiveClasses) {
    const int cls = threadIdx.x;
    int sum = 0;
    for (int k = 0; k < kBinRounds; ++k) {
      for (int w = 0; w < kBinWarps; ++w) {
        const int n = offset[k][w][cls];
        offset[k][w][cls] = sum;
        sum += n;
      }
    }
    base[cls] = sum > 0 ? atomicAdd(a.counters + kCountStride * cls, sum) : 0;
  }
  __syncthreads();
  for (int k = 0; k < kBinRounds; ++k) {
    const int64_t r = tile + k * kBinThreads + threadIdx.x;
    if (c[k] != kDead) {
      const int rank = __popc(peers[k] & ((1u << lane) - 1u));
      a.ray_list[c[k] * num + base[c[k]] + offset[k][warp][c[k]] + rank] =
          static_cast<int32_t>(r);
    } else if (r < num) {
      store3(a.o_ray_o, r, go[k]);
      store3(a.o_ray_d, r, gd[k]);
      store3(a.o_throughput, r, gt[k]);
    }
  }
}

// A block of the reverse leaves: the last to leave (of the grid's) sets the
// counters to zero for the next call, once every block has read them.
__device__ __forceinline__ void leave(const BackwardArgs& a) {
  if (threadIdx.x == 0 && atomicAdd(a.counters + kDoneWord, 1) == static_cast<int>(gridDim.x) - 1) {
    for (int c = 0; c < kClassCounts; ++c) a.counters[kCountStride * c] = 0;
    a.counters[kDoneWord] = 0;
  }
}

// Persistent blocks over the ray list: a warp task is 32 consecutive
// entries of one class's segment, the tasks of all segments taken in
// turns (warp w of the grid's W: tasks w, w + W, ...). With kSharedSums
// the material sums go to the block's table in shared memory, flushed at
// its end; without, to device memory. Each block reads the counters at its
// start and counts itself out at its end (leave).
template <bool kSharedSums>
__global__ void __launch_bounds__(kBackwardThreads, kBackwardMinBlocks)
bounce_backward_kernel(const ShadeScene s, const BackwardArgs a) {
  extern __shared__ double table[];  // (M, kTableCols) with kSharedSums
  __shared__ int first[kLiveClasses + 1];  // the warp tasks before each segment
  __shared__ int count[kLiveClasses];
  if (threadIdx.x == 0) {
    int tasks = 0;
    for (int c = 0; c < kLiveClasses; ++c) {
      count[c] = a.counters[kCountStride * c];
      first[c] = tasks;
      tasks += (count[c] + 31) / 32;
    }
    first[kLiveClasses] = tasks;
  }
  __syncthreads();
  const int tasks = first[kLiveClasses];
  if (static_cast<int>(blockIdx.x) * kBackwardWarps >= tasks) {  // no task of its own
    leave(a);
    return;
  }
  const int cells = kSharedSums ? a.num_materials * kTableCols : 0;
  for (int i = threadIdx.x; i < cells; i += kBackwardThreads) table[i] = 0.0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int t = blockIdx.x * kBackwardWarps + (threadIdx.x >> 5); t < tasks;
       t += gridDim.x * kBackwardWarps) {
    int c = 0;
    while (t >= first[c + 1]) ++c;
    const int j = (t - first[c]) * 32 + lane;
    Contrib ct;
    if (j < count[c]) {
      bounce_backward_ray(s, a, a.ray_list[static_cast<int64_t>(c) * a.num_rays + j], ct);
    }
    // every lane of the warp takes part in the sums
    if constexpr (kSharedSums) {
      warp_add<9>(ct.mat, ct.mat_g, table, kTableCols);
      warp_add<3>(ct.light_mat, ct.light_g, table + 9, kTableCols);
    } else if (a.o_material != nullptr) {
      warp_add<9>(ct.mat, ct.mat_g, a.o_material, 9);
      warp_add<3>(ct.light_mat, ct.light_g, a.o_material + 3, 9);
    }
    if (a.o_texels != nullptr) {
      warp_add<3>(ct.texel, ct.texel_g, a.o_texels, 3);
      warp_add<3>(ct.light_texel, ct.light_texel_g, a.o_texels, 3);
    }
  }
  if constexpr (kSharedSums) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += kBackwardThreads) {
      const double v = table[i];
      const int row = i / kTableCols, col = i - row * kTableCols;
      // columns 9-11, the light's emittance, add to the material's 3-5
      if (v != 0.0) atomicAdd(a.o_material + 9 * row + (col < 9 ? col : col - 6), v);
    }
  }
  leave(a);
}

// The kernels' resident blocks an SM and the SMs of each card, read once.
struct Residency {
  int sms = 0, blocks[2] = {0, 0};  // blocks: the device-sums and the shared-table kernel
};

cudaError_t residency(int device, Residency* out) {
  static Residency known[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  Residency& k = known[device];
  if (k.sms == 0) {
    Residency fresh;
    cudaError_t err = cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fresh.blocks[0], bounce_backward_kernel<false>, kBackwardThreads, 0);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fresh.blocks[1], bounce_backward_kernel<true>, kBackwardThreads, kTableBytes);
    }
    if (err != cudaSuccess) return err;
    k = fresh;
  }
  *out = k;
  return cudaSuccess;
}

}  // namespace

// Both entry points launch on `stream` of `device` and return
// cudaGetLastError() (0 = launched; cudaErrorInvalidValue for a layout
// the kernels do not take). The structs are host memory, copied into the
// launch's parameters. They allocate nothing and do not synchronise.

// The binning: writes the ray list, adds the class counts to the counters
// (zero on entry) and the dead rays' gradients, and zeroes the sums (at
// least one block, so that the sums are zeroed with no ray).
extern "C" int bounce_bin(int device, const ShadeScene* scene, const BackwardArgs* args,
                          void* stream) {
  (void)scene;  // the classes are the forward's: the binning reads no scene table
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (static_cast<int64_t>(args->num_rays) + kBinTile - 1) / kBinTile;
  const dim3 grid(static_cast<unsigned>(tiles > 0 ? tiles : 1));
  bounce_bin_kernel<<<grid, kBinThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// The reverse of the live rays the binning listed (bounce_bin first, on
// the same stream, with the same args), which leaves the counters at zero.
// The grid: as many blocks as stay resident, no more than the most warp
// tasks the rays can give.
extern "C" int bounce_backward(int device, const ShadeScene* scene, const BackwardArgs* args,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args->num_rays <= 0) return static_cast<int>(cudaGetLastError());
  Residency res;
  err = residency(device, &res);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool shared = args->o_material != nullptr && args->num_materials <= kTableRows;
  const int64_t tasks = (static_cast<int64_t>(args->num_rays) + 31) / 32 + kLiveClasses;
  const int64_t needed = (tasks + kBackwardWarps - 1) / kBackwardWarps;
  const int64_t resident = static_cast<int64_t>(res.sms) * res.blocks[shared ? 1 : 0];
  const dim3 grid(static_cast<unsigned>(needed < resident ? needed : resident));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    const size_t bytes = sizeof(double) * kTableCols * args->num_materials;
    bounce_backward_kernel<true><<<grid, kBackwardThreads, bytes, st>>>(*scene, *args);
  } else {
    bounce_backward_kernel<false><<<grid, kBackwardThreads, 0, st>>>(*scene, *args);
  }
  return static_cast<int>(cudaGetLastError());
}

// The attributes of the backward's three kernels on `device` (the
// binning, the reverse with device sums, the reverse with the shared
// table), four words each into `out`: registers a thread, local memory
// bytes a thread (stack and spills), resident warps an SM (at the table's
// largest size) and threads a block. Returns a CUDA error (0 = none).
extern "C" int bounce_backward_attributes(int device, int32_t* out) {
  cudaError_t err = cudaSetDevice(device);
  const void* kernels[3] = {reinterpret_cast<const void*>(bounce_bin_kernel),
                            reinterpret_cast<const void*>(bounce_backward_kernel<false>),
                            reinterpret_cast<const void*>(bounce_backward_kernel<true>)};
  const int threads[3] = {kBinThreads, kBackwardThreads, kBackwardThreads};
  const size_t shared[3] = {0, 0, kTableBytes};
  for (int k = 0; k < 3 && err == cudaSuccess; ++k) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernels[k]);
    int blocks = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernels[k], threads[k],
                                                          shared[k]);
    }
    out[4 * k] = attr.numRegs;
    out[4 * k + 1] = static_cast<int32_t>(attr.localSizeBytes);
    out[4 * k + 2] = blocks * threads[k] / 32;
    out[4 * k + 3] = threads[k];
  }
  return static_cast<int>(err);
}

#else  // a host build of the same code, for the CPU tests

#include <string.h>

// bounce_bin_kernel on the host: the rays in order, each live one
// appended to its class's segment, the counts added to the counters; the
// zero fill. Returns 0.
extern "C" int bounce_bin_host(const ShadeScene* scene, const BackwardArgs* args) {
  (void)scene;
  if (args->zero_words > 0) memset(args->zero, 0, 16 * static_cast<size_t>(args->zero_words));
  const int64_t num = args->num_rays;
  for (int64_t r = 0; r < num; ++r) {
    const int c = args->ray_class[r];
    if (c == kDead) {
      pass_through(*args, r);
    } else {
      args->ray_list[c * num + args->counters[kCountStride * c]++] = static_cast<int32_t>(r);
    }
  }
  return 0;
}

// The kernels' arithmetic on the host: the binning, then each segment's
// rays in list order, the sums in that order (in float64, as the
// kernel's); the counters left at zero, as the reverse leaves them.
// Returns 0.
extern "C" int bounce_backward_host(const ShadeScene* scene, const BackwardArgs* args) {
  bounce_bin_host(scene, args);
  for (int c = 0; c < kLiveClasses; ++c) {
    const int32_t* segment = args->ray_list + c * static_cast<int64_t>(args->num_rays);
    for (int j = 0; j < args->counters[kCountStride * c]; ++j) {
      Contrib ct;
      bounce_backward_ray(*scene, *args, segment[j], ct);
      if (args->o_material != nullptr) {
        if (ct.mat >= 0)
          for (int f = 0; f < 9; ++f) args->o_material[9 * ct.mat + f] += ct.mat_g[f];
        if (ct.light_mat >= 0)
          for (int f = 0; f < 3; ++f)
            args->o_material[9 * ct.light_mat + 3 + f] += ct.light_g[f];
      }
      if (args->o_texels != nullptr) {
        if (ct.texel >= 0)
          for (int f = 0; f < 3; ++f) args->o_texels[3 * ct.texel + f] += ct.texel_g[f];
        if (ct.light_texel >= 0)
          for (int f = 0; f < 3; ++f)
            args->o_texels[3 * ct.light_texel + f] += ct.light_texel_g[f];
      }
    }
  }
  for (int w = 0; w < kCounterWords; ++w) args->counters[w] = 0;
  return 0;
}

#endif

// The counters' layout, for kernels/shade.py to be checked against:
// kCountStride, kDoneWord, kCounterWords. Returns 0.
extern "C" int bounce_counter_layout(int32_t* out) {
  out[0] = kCountStride;
  out[1] = kDoneWord;
  out[2] = kCounterWords;
  return 0;
}
