"""The plain reference: a path tracer of plain PyTorch tensor ops.

A frozen copy of the plain versions of the port's integrator (the camera,
the counter-mode sampler, the hit attributes, the BSDF sample, next event
estimation, Russian roulette, the adaptive gate, the G-buffer's sums and
the display transform), with the same arithmetic, so that a path of the
program and the same path here agree to rounding. It imports nothing of
the program and reads none of its tables: the scene is the benchmark's
own arrays (``scenes.procedural``), and the nearest hits come from
``reference.intersect``.

Every function computes in the dtype of its inputs (``Scene.dtype``):
float32 for the reference, bfloat16 for the lower-precision control that
``checks`` holds against it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

TAU = 2.0 * math.pi
CAMERA_STREAM = 255
_DIMS_PER_STREAM = 64
_MASK = 0xFFFFFFFF
BOUNCE_UNIFORMS = 9
ACES_INPUT = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566),
              (0.02840, 0.13383, 0.83777))
ACES_OUTPUT = ((1.60475, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605),
               (-0.00327, -0.07276, 1.07602))
LUMINANCE_WEIGHTS = (0.2126, 0.7152, 0.0722)


# --- vectors ---------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def apply(m, v):
    return torch.stack([dot(v, m[0]), dot(v, m[1]), dot(v, m[2])], -1)


def normalize(v):
    return v * torch.reciprocal(torch.sqrt(torch.clamp_min(dot(v, v), 1e-30)))[..., None]


def rotation_matrix(yaw, pitch):
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    roll = torch.zeros_like(yaw)
    cr, sr = torch.cos(roll), torch.sin(roll)
    one, zero = torch.ones_like(cy), torch.zeros_like(cy)
    ry = torch.stack([torch.stack([cy, zero, sy]), torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cp, -sp]),
                      torch.stack([zero, sp, cp])])
    rz = torch.stack([torch.stack([cr, -sr, zero]), torch.stack([sr, cr, zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


# --- the counter-mode sampler (Threefry-2x32, 20 rounds) --------------------

def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Words in Python ints or int64 tensors in [0, 2**32)."""
    ks0, ks1, ks2 = k0, k1, 0x1BD11BDA ^ k0 ^ k1
    x0 = (x0 + ks0) & _MASK
    x1 = (x1 + ks1) & _MASK

    def four(x0, x1, rots):
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    ra, rb = (13, 15, 26, 6), (17, 29, 16, 24)
    x0, x1 = four(x0, x1, ra)
    x0, x1 = (x0 + ks1) & _MASK, (x1 + ks2 + 1) & _MASK
    x0, x1 = four(x0, x1, rb)
    x0, x1 = (x0 + ks2) & _MASK, (x1 + ks0 + 2) & _MASK
    x0, x1 = four(x0, x1, ra)
    x0, x1 = (x0 + ks0) & _MASK, (x1 + ks1 + 3) & _MASK
    x0, x1 = four(x0, x1, rb)
    x0, x1 = (x0 + ks1) & _MASK, (x1 + ks2 + 4) & _MASK
    x0, x1 = four(x0, x1, ra)
    x0, x1 = (x0 + ks2) & _MASK, (x1 + ks0 + 5) & _MASK
    return x0, x1


def sample_key_words(seed: int, index: int) -> tuple:
    """The key words of sample ``index`` of a render seeded ``seed``
    (``fold_in(PRNGKey(seed), index)``)."""
    return threefry2x32(0, int(seed) & _MASK, 0, int(index) & _MASK)


def fold_in(key_words, data: int) -> tuple:
    k0, k1 = (int(k) & _MASK for k in key_words)
    return threefry2x32(k0, k1, 0, int(data) & _MASK)


def uniforms(keys, pixel_ids, stream: int, n: int, dtype):
    """(n, R) variates in [0, 1) of each ray's (k0, k1) ``keys`` ((R, 2)
    int64) and global pixel id."""
    k0, k1 = keys[:, 0] & _MASK, keys[:, 1] & _MASK
    w0 = pixel_ids.to(torch.int64) & _MASK
    rows = []
    for p in range(-(-n // 2)):
        a, b = threefry2x32(k0, k1, w0, torch.full_like(w0, stream * _DIMS_PER_STREAM + p))
        rows += [a, b]
    # 24 high bits, exact in float32
    return torch.stack([((r >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)
                        for r in rows[:n]])


# --- sampling warps --------------------------------------------------------

def cosine_hemisphere(u1, u2, normal, tangent, bitangent):
    phi = u1 * TAU
    sqrt_u2 = torch.sqrt(u2)
    cos_t = torch.sqrt(1.0 - u2)
    return ((sqrt_u2 * torch.cos(phi))[..., None] * tangent + cos_t[..., None] * normal
            + (sqrt_u2 * torch.sin(phi))[..., None] * bitangent)


def ggx_half_vector(u1, u2, roughness, normal, tangent, bitangent):
    a2 = roughness * roughness
    denom = torch.clamp_min(u1 * (a2 - 1.0) + 1.0, 1e-12)
    cos_t = torch.sqrt(torch.clamp((1.0 - u1) / denom, 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
    phi = u2 * TAU
    return ((sin_t * torch.cos(phi))[..., None] * tangent + cos_t[..., None] * normal
            + (sin_t * torch.sin(phi))[..., None] * bitangent)


def fresnel_dielectric(wi, half, n1, n2):
    c = torch.abs(dot(wi, half))
    g = torch.sqrt(torch.clamp_min((n2 * n2) / (n1 * n1) - 1.0 + c * c, 1e-12))
    factor1 = 0.5 * ((g - c) / torch.clamp_min(g + c, 1e-12)) ** 2
    den = c * (g - c) + 1.0
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    factor2 = 1.0 + ((c * (g + c) - 1.0) / den) ** 2
    return factor1 * factor2


def fresnel_conductor(wi, half, n, k):
    n2, k2 = n * n, k * k
    cos_t = dot(wi, half)
    cos2 = cos_t * cos_t
    sin2 = 1.0 - cos2
    t0 = n2 - k2 - sin2
    a2b2 = torch.sqrt(torch.clamp_min(t0 * t0 + 4.0 * n2 * k2, 0.0))
    a = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + t0), 0.0))
    t1 = a2b2 + cos2
    t2 = 2.0 * a * cos_t
    rs = (t1 - t2) / (t1 + t2)
    t3 = cos2 * a2b2 * sin2 * sin2
    t4 = t2 * sin2
    denom = t3 + t4
    nonzero = denom != 0.0
    ratio = torch.where(nonzero, (t3 - t4) / torch.where(nonzero, denom, torch.ones_like(denom)),
                        torch.full_like(denom, -1.0))
    return 0.5 * (rs + rs * ratio)


def smith_lambda(direction, normal, roughness):
    d = dot(direction, normal)
    d2 = torch.clamp_min(d * d, 1e-12)
    tan2 = (1.0 - d2) / d2
    return (torch.sqrt(1.0 + roughness * roughness + tan2) - 1.0) * 0.5


def specular_weight(wi, wo, half, normal, roughness):
    g = 1.0 / (1.0 + smith_lambda(wi, normal, roughness) + smith_lambda(wo, normal, roughness))
    return torch.abs(dot(wi, half)) * g / torch.clamp_min(
        torch.abs(dot(normal, half)) * torch.abs(dot(wi, normal)), 1e-12)


def reflect(wi, half):
    return 2.0 * dot(wi, half)[..., None] * half - wi


def refract(wi, half, n1, n2):
    c = dot(wi, half)
    n = n1 / n2
    root = torch.sqrt(torch.clamp_min(1.0 + n * n * (c * c - 1.0), 1e-12))
    return (n * c - root)[..., None] * half - n[..., None] * wi


def uniform_triangle(u1, u2, p1, p2, p3):
    sqrt_x = torch.sqrt(u1)
    u = 1.0 - sqrt_x
    v = u2 * sqrt_x
    w = 1.0 - u - v
    return u[..., None] * p1 + v[..., None] * p2 + w[..., None] * p3


# --- colour ----------------------------------------------------------------

def luminance(color):
    return dot(color, torch.tensor(LUMINANCE_WEIGHTS, dtype=color.dtype, device=color.device))


def correct_color(color):
    """clamp >= 0, ACES (Hill's fit), sRGB gamma, clamp to [0, 1]."""
    color = torch.clamp_min(color, 0.0)
    color = apply(torch.tensor(ACES_INPUT, dtype=color.dtype, device=color.device), color)
    num = color * (color + 0.0245786) - 0.000090537
    den = color * (0.983729 * color + 0.4329510) + 0.238081
    color = apply(torch.tensor(ACES_OUTPUT, dtype=color.dtype, device=color.device), num / den)
    linear = 12.92 * color
    curved = 1.055 * torch.pow(torch.clamp_min(color, 1e-10), 1.0 / 2.4) - 0.055
    return torch.clamp(torch.where(color > 0.0031308, curved, linear), 0.0, 1.0)


# --- the scene --------------------------------------------------------------

@dataclasses.dataclass
class Scene:
    """The benchmark's scene arrays as tensors, in the order the benchmark
    made them, with the light list ``light_indices`` (by default every
    emissive triangle in id order)."""

    vertices: torch.Tensor
    normals: torch.Tensor
    uvs: torch.Tensor
    mat_id: torch.Tensor
    light_indices: torch.Tensor
    materials: dict
    textures: dict

    @staticmethod
    def from_arrays(arrays, device, dtype=torch.float32) -> "Scene":
        def f(x):
            x = torch.as_tensor(x).to(device)
            return x.to(dtype) if x.is_floating_point() else x

        return Scene(f(arrays.vertices), f(arrays.normals), f(arrays.uvs), f(arrays.mat_id),
                     f(arrays.light_indices), {k: f(v) for k, v in arrays.materials.items()},
                     {k: f(v) for k, v in arrays.textures.items()})

    @property
    def dtype(self):
        return self.vertices.dtype

    @property
    def num_lights(self) -> int:
        return self.light_indices.shape[0]


def sample_texture(textures, tex_id, color, uv):
    valid = tex_id >= 0
    safe_id = torch.clamp_min(tex_id, 0).long()
    w, h = textures["width"][safe_id], textures["height"][safe_id]
    off = textures["offset"][safe_id]
    u = torch.remainder(uv[..., 0], 1.0)
    v = torch.remainder(uv[..., 1], 1.0)
    px = (v * h.to(uv.dtype)).to(torch.int32) * w + (u * w.to(uv.dtype)).to(torch.int32)
    # in range for every finite uv; a NaN (only in the bfloat16 control)
    # reads texel 0 instead of failing the gather
    px = torch.minimum(torch.clamp_min(px, 0), w * h - 1)
    texel = textures["buffer"][(off + px).long()]
    return torch.where(valid[..., None], texel * color, color)


def barycentric(point, p1, p2, p3):
    v0, v1, v2 = p2 - p1, p3 - p1, point - p1
    d00, d01, d11 = dot(v0, v0), dot(v0, v1), dot(v1, v1)
    d20, d21 = dot(v2, v0), dot(v2, v1)
    inv_den = 1.0 / (d00 * d11 - d01 * d01)
    b = (d11 * d20 - d01 * d21) * inv_den
    c = (d00 * d21 - d01 * d20) * inv_den
    return torch.stack([1.0 - b - c, b, c], dim=-1)


def hit_attributes(scene: Scene, o, d, idx, hit) -> dict:
    """The hit record (trace_ray.cuh:144-168) of a nearest-hit id; lanes
    without a hit get index 0 and t = 1."""
    safe = torch.clamp_min(idx, 0).long()
    tri, nrm, uvs = scene.vertices[safe], scene.normals[safe], scene.uvs[safe]
    p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
    geo_n = normalize(cross(p2 - p1, p3 - p1))
    ddn = dot(d, geo_n)
    ddn = torch.where(torch.abs(ddn) < 1e-20, torch.full_like(ddn, 1e-20), ddn)
    t = (dot(geo_n, p1) - dot(o, geo_n)) / ddn
    t = torch.where(hit, t, torch.ones_like(t))
    point = o + t[:, None] * d
    bary = barycentric(point, p1, p2, p3)
    position = bary[:, 0:1] * p1 + bary[:, 1:2] * p2 + bary[:, 2:3] * p3
    normal = normalize(bary[:, 0:1] * nrm[:, 0] + bary[:, 1:2] * nrm[:, 1]
                       + bary[:, 2:3] * nrm[:, 2])
    tangent = normalize(cross(p2 - p1, normal))
    bitangent = normalize(cross(normal, tangent))
    normal = torch.where((dot(d, normal) > 0.0)[:, None], -normal, normal)
    uv = bary[:, 0:1] * uvs[:, 0] + bary[:, 1:2] * uvs[:, 1] + bary[:, 2:3] * uvs[:, 2]
    m = scene.materials
    mat = scene.mat_id[safe].long()
    tex_id = m["tex_id"].index_select(0, mat)
    return {
        "albedo": sample_texture(scene.textures, tex_id, m["albedo"].index_select(0, mat), uv),
        "emittance": sample_texture(scene.textures, tex_id,
                                    m["emittance"].index_select(0, mat), uv),
        "roughness": m["roughness"].index_select(0, mat),
        "ior": m["ior"].index_select(0, mat),
        "extinction": m["extinction"].index_select(0, mat),
        "transparent": m["transparent"].index_select(0, mat),
        "position": position, "normal": normal, "tangent": tangent, "bitangent": bitangent,
    }


def scatter(hit: dict, ray_direction, inside_medium, u_half1, u_half2, u_lobe, u_diff1,
            u_diff2, lobe_ratio_grad: bool = True):
    """The next scattering event of every lane (path_tracing.cuh:151-219):
    (direction, weight, is_diffuse, inside_medium after it)."""
    wi = -ray_direction
    normal, tangent, bitangent = hit["normal"], hit["tangent"], hit["bitangent"]
    rough = hit["roughness"]
    half = ggx_half_vector(u_half1, u_half2, rough, normal, tangent, bitangent)
    is_metal = hit["extinction"] > 0.0
    n_metal = torch.where(is_metal, hit["ior"], 1.0)
    k_metal = torch.where(is_metal, hit["extinction"], 1.0)
    f_cond = fresnel_conductor(wi, half, n_metal, k_metal)
    refl = reflect(wi, half)
    sw_refl = specular_weight(wi, refl, half, normal, rough)
    w_metal = hit["albedo"] * (sw_refl * f_cond)[..., None]

    ior = torch.clamp_min(hit["ior"], 1e-6)
    n1 = torch.where(inside_medium, ior, 1.0)
    n2 = torch.where(inside_medium, torch.ones_like(ior), ior)
    f_diel = fresnel_dielectric(wi, half, n1, n2)
    f_det = f_diel.detach()
    choose_specular = u_lobe < f_det
    if lobe_ratio_grad:
        ratio_spec = f_diel / torch.clamp_min(f_det, 1e-12)
        ratio_rest = (1.0 - f_diel) / torch.clamp_min(1.0 - f_det, 1e-12)
    else:
        ratio_spec = ratio_rest = torch.ones_like(f_det)
    w_spec = (torch.where(inside_medium, torch.ones_like(sw_refl), sw_refl) * ratio_spec
              )[..., None] * torch.ones((1, 3), dtype=wi.dtype, device=wi.device)

    is_transparent = hit["transparent"] > 0.5
    n1_t = torch.where(is_transparent, n1, 1.0)
    n2_t = torch.where(is_transparent, n2, 1.5)
    refr = refract(wi, half, n1_t, n2_t)
    sw_refr = specular_weight(wi, refr, half, normal, rough)
    w_trans = hit["albedo"] * (sw_refr * ratio_rest)[..., None]
    diff = cosine_hemisphere(u_diff1, u_diff2, normal, tangent, bitangent)
    w_diff = hit["albedo"] * ratio_rest[..., None]

    is_spec = (~is_metal) & choose_specular
    is_trans = (~is_metal) & (~choose_specular) & is_transparent
    is_diff = (~is_metal) & (~choose_specular) & (~is_transparent)

    def sel(mask, a, b):
        return torch.where(mask[..., None], a, b)

    direction = sel(is_metal, refl, sel(is_spec, refl, sel(is_trans, refr, diff)))
    weight = sel(is_metal, w_metal, sel(is_spec, w_spec, sel(is_trans, w_trans, w_diff)))
    return direction, weight, is_diff, torch.where(is_trans, ~inside_medium, inside_medium)


def generate_rays(camera: dict, width: int, height: int, px, py, u):
    """Primary rays with pixel jitter and a thin-lens aperture sample; u is
    (R, 4)."""
    half_w, half_h = float(width // 2), float(height // 2)
    thf = torch.tan(camera["fov"] / 2.0)
    rot = rotation_matrix(camera["yaw"], camera["pitch"])
    x = px.to(u.dtype) + u[..., 0]
    y = py.to(u.dtype) + u[..., 1]
    dirs = torch.stack([thf * (x - half_w) / half_w, thf * (y - half_h) / half_w,
                        torch.ones_like(x)], dim=-1)
    dirs = apply(rot, normalize(dirs))
    theta = u[..., 2] * TAU
    r = torch.sqrt(u[..., 3]) * camera["aperture_radius"]
    ox, oy = r * torch.cos(theta), r * torch.sin(theta)
    offset = apply(rot, torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1))
    return camera["position"] + offset, dirs


def radiance(scene: Scene, trace, camera: dict, settings: dict, keys, pixel_ids,
             lobe_ratio_grad: bool = True):
    """One path's radiance (R, 3) for each (key words, pixel id) pair:
    ``keys`` (R, 2) int64 holds the sample key words of each path
    (``sample_key_words``), ``pixel_ids`` (R,) its global pixel id.
    ``trace(o, d, active, t_max)`` -> (idx, hit) is the nearest-hit
    function; ``settings`` the width, height, max_bounces and
    rr_start_bounce."""
    dtype, device = scene.dtype, scene.vertices.device
    width = settings["width"]
    px, py = pixel_ids % width, pixel_ids // width
    cam_u = uniforms(keys, pixel_ids, CAMERA_STREAM, 4, dtype).T
    ray_o, ray_d = generate_rays(camera, width, settings["height"], px, py, cam_u)
    n = pixel_ids.shape[0]
    throughput = torch.ones((n, 3), dtype=dtype, device=device)
    total = torch.zeros((n, 3), dtype=dtype, device=device)
    inside = torch.zeros((n,), dtype=torch.bool, device=device)
    prev_diffuse = torch.zeros((n,), dtype=torch.bool, device=device)
    active = torch.ones((n,), dtype=torch.bool, device=device)
    num_lights = scene.num_lights
    for bounce in range(settings["max_bounces"]):
        u = uniforms(keys, pixel_ids, bounce, BOUNCE_UNIFORMS, dtype)
        idx, hit = trace(ray_o, ray_d, active, None)
        attrs = hit_attributes(scene, ray_o, ray_d, idx, hit)
        live = active & hit
        emit = live & (~prev_diffuse)
        total = total + torch.where(emit[:, None], attrs["emittance"] * throughput, 0.0)
        direction, weight, is_diffuse, inside_after = scatter(
            attrs, ray_d, inside, u[0], u[1], u[2], u[3], u[4], lobe_ratio_grad)
        new_throughput = throughput * weight
        on = live[:, None]
        ray_o = torch.where(on, attrs["position"], ray_o)
        ray_d = torch.where(on, direction, ray_d)
        throughput = torch.where(on, new_throughput, throughput)
        inside = torch.where(live, inside_after, inside)
        prev_diffuse = torch.where(live, is_diffuse, prev_diffuse)

        # next event estimation (path_tracing.cuh:235-265)
        pick = torch.clamp((u[5] * num_lights).to(torch.int32), 0, num_lights - 1)
        light_idx = scene.light_indices[pick.long()]
        tri = scene.vertices[light_idx.long()]
        p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
        to_light = uniform_triangle(u[6], u[7], p1, p2, p3) - ray_o
        dist_sq = dot(to_light, to_light)
        window = torch.sqrt(dist_sq) * 1.001 + 1e-3
        shadow_dir = normalize(to_light)
        nee = live & is_diffuse
        s_idx, s_hit = trace(ray_o, shadow_dir, nee, window)
        visible = s_hit & (s_idx == light_idx)
        light = hit_attributes(scene, ray_o, shadow_dir, s_idx, s_hit)
        e = cross(p2 - p1, p3 - p1)
        light_area = 0.5 * torch.sqrt(dot(e, e))
        cos1 = torch.clamp_min(-dot(shadow_dir, light["normal"]), 0.0)
        cos2 = torch.clamp_min(dot(shadow_dir, attrs["normal"]), 0.0)
        scale = (light_area * float(num_lights) * cos1 * cos2
                 / torch.clamp_min(dist_sq * math.pi, 0.001))
        direct = torch.where(visible[..., None], light["emittance"] * scale[..., None], 0.0)
        total = total + torch.where(nee[:, None], direct * throughput, 0.0)

        if bounce >= settings["rr_start_bounce"]:
            survival = throughput.max(dim=-1).values.detach()
            alive = u[8] <= survival
            rolled = torch.where(alive[:, None],
                                 throughput / torch.clamp_min(survival, 1e-30)[:, None],
                                 throughput)
            throughput = torch.where(live[:, None], rolled, throughput)
            active = live & alive
        else:
            active = live
    return total


# --- the G-buffer and the adaptive gate -------------------------------------

def needs_sample(frame, sq_luminance, count, min_samples: int, max_samples: int,
                 tolerance: float):
    """Which pixels take another sample (path_tracing.cuh:347-376)."""
    nf = count.to(frame.dtype)
    total_lum = luminance(frame)
    safe_n = torch.clamp_min(nf, 2.0)
    mean = total_lum / safe_n
    variance = torch.clamp_min((sq_luminance - total_lum * total_lum / safe_n)
                               / (safe_n - 1.0), 0.0)
    z = torch.special.erfinv(torch.full((), 1.0 - tolerance, dtype=frame.dtype,
                                        device=frame.device))
    half_width = (torch.full((), math.sqrt(2.0), dtype=frame.dtype, device=frame.device) * z
                  * torch.sqrt(variance / safe_n))
    unconverged = half_width > mean * tolerance
    return (count < min_samples) | ((count < max_samples) & unconverged)
