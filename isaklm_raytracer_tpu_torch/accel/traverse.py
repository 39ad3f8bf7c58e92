"""Brute-force nearest-hit oracle and hit shading.

Port of ``isaklm_raytracer_tpu/accel/traverse.py``. The discrete part
(which triangle is hit) is computed detached and returned as int32 ids;
``hit_attributes`` rebuilds the hit point, shading frame and material sample
from the id, so gradients will flow through ray origins, directions and
material parameters while hit topology stays a constant.

Intersection maths match the reference: plane hit + barycentric inside test
with t >= t_eps (trace_ray.cuh:73-113), Cramer barycentrics
(trace_ray.cuh:48-71), the nearest-hit shading sample (trace_ray.cuh:115-172).
"""

from __future__ import annotations

import dataclasses

import torch

from isaklm_raytracer_tpu_torch.math import transforms
from isaklm_raytracer_tpu_torch.math.transforms import cross, dot
from isaklm_raytracer_tpu_torch.scene.types import Scene, sample_texture

_INF = float("inf")


def barycentric(point, p1, p2, p3) -> torch.Tensor:
    """Cramer's-rule barycentrics (trace_ray.cuh:48-71), broadcasting over
    leading axes. Returns (..., 3) weights for (p1, p2, p3)."""
    v0 = p2 - p1
    v1 = p3 - p1
    v2 = point - p1
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    inv_den = 1.0 / (d00 * d11 - d01 * d01)
    b = (d11 * d20 - d01 * d21) * inv_den
    c = (d00 * d21 - d01 * d20) * inv_den
    a = 1.0 - b - c
    return torch.stack([a, b, c], dim=-1)


@torch.no_grad()
def nearest_hit_brute(
    o: torch.Tensor,
    d: torch.Tensor,
    vertices: torch.Tensor,
    t_eps: float = 1e-5,
    chunk: int = 2048,
    active=None,
    t_max=None,
):
    """Nearest hit over all triangles: the exact oracle.

    o, d: (R, 3); vertices: (N, 3, 3). Returns detached (t (R,), idx (R,)
    int32, hit (R,) bool). Ties resolve to the lowest triangle id. ``t_max``
    is accepted for interface parity and ignored, as in the JAX package.
    """
    del t_max
    num_rays = o.shape[0]
    best_t = torch.full((num_rays,), _INF, dtype=torch.float32, device=o.device)
    best_idx = torch.full((num_rays,), -1, dtype=torch.int32, device=o.device)
    oc, dc = o[:, None, :], d[:, None, :]
    for base in range(0, vertices.shape[0], chunk):
        tri = vertices[base:base + chunk]
        p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
        geo_n = transforms.normalize(cross(p2 - p1, p3 - p1))  # (N, 3)
        ddn = dot(dc, geo_n)  # (R, N)
        s = (dot(geo_n, p1) - dot(oc, geo_n)) / ddn
        point = oc + s[..., None] * dc
        bary = barycentric(point, p1, p2, p3)
        inside = ((bary >= 0.0) & (bary <= 1.0)).all(dim=-1)
        valid = (ddn != 0.0) & (s >= t_eps) & inside
        t = torch.where(valid, s, torch.full_like(s, _INF))
        local_t, local_best = torch.min(t, dim=-1)
        better = local_t < best_t
        best_idx = torch.where(better, base + local_best.to(torch.int32), best_idx)
        best_t = torch.where(better, local_t, best_t)
    hit = torch.isfinite(best_t)
    if active is not None:
        hit = hit & active
        best_idx = torch.where(active, best_idx, torch.full_like(best_idx, -1))
        best_t = torch.where(active, best_t, torch.full_like(best_t, _INF))
    return best_t, best_idx, hit


@dataclasses.dataclass
class HitAttributes:
    """Hit record (reference Sample, trace_ray.cuh:17-29)."""

    albedo: torch.Tensor  # (R, 3) texture-modulated
    emittance: torch.Tensor  # (R, 3) texture-modulated
    roughness: torch.Tensor  # (R,)
    ior: torch.Tensor  # (R,)
    extinction: torch.Tensor  # (R,)
    transparent: torch.Tensor  # (R,) in {0., 1.}
    triangle_index: torch.Tensor  # (R,) int32 (detached)
    position: torch.Tensor  # (R, 3)
    normal: torch.Tensor  # (R, 3) shading normal (back-face flipped)
    tangent: torch.Tensor  # (R, 3)
    bitangent: torch.Tensor  # (R, 3)
    t: torch.Tensor  # (R,) hit distance


def hit_attributes(
    scene: Scene, o: torch.Tensor, d: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor
) -> HitAttributes:
    """Rebuild the reference's ``Sample`` (trace_ray.cuh:144-168) from a
    detached nearest-hit id. Non-hit lanes get safe dummy values (index 0,
    t = 1)."""
    safe_idx = torch.clamp_min(idx, 0).long()
    if scene.shade_table is not None:
        # One row gather for all per-triangle data.
        row = scene.shade_table[safe_idx]  # (R, 32)
        p1, p2, p3 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        nrm1, nrm2, nrm3 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        uv1, uv2, uv3 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
        mat = row[:, 24].to(torch.int32)
    else:
        tri = scene.vertices[safe_idx]
        p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
        nrm = scene.normals[safe_idx]
        nrm1, nrm2, nrm3 = nrm[:, 0], nrm[:, 1], nrm[:, 2]
        uvs = scene.uvs[safe_idx]
        uv1, uv2, uv3 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        mat = scene.mat_id[safe_idx]

    geo_n = transforms.normalize(cross(p2 - p1, p3 - p1))
    ddn = dot(d, geo_n)
    # Guard divide for miss lanes / degenerate triangles.
    ddn = torch.where(torch.abs(ddn) < 1e-20, torch.full_like(ddn, 1e-20), ddn)
    t = (dot(geo_n, p1) - dot(o, geo_n)) / ddn
    t = torch.where(hit, t, torch.ones_like(t))

    point = o + t[:, None] * d
    bary = barycentric(point, p1, p2, p3)
    position = bary[:, 0:1] * p1 + bary[:, 1:2] * p2 + bary[:, 2:3] * p3

    normal = transforms.normalize(
        bary[:, 0:1] * nrm1 + bary[:, 1:2] * nrm2 + bary[:, 2:3] * nrm3
    )
    # Frame from the UNflipped normal, then back-face flip of the normal only
    # (trace_ray.cuh:160-168).
    tangent = transforms.normalize(cross(p2 - p1, normal))
    bitangent = transforms.normalize(cross(normal, tangent))
    normal = torch.where((dot(d, normal) > 0.0)[:, None], -normal, normal)

    uv = bary[:, 0:1] * uv1 + bary[:, 1:2] * uv2 + bary[:, 2:3] * uv3

    m = scene.materials
    mat_l = mat.long()
    tex_id = m.tex_id[mat_l]
    albedo = sample_texture(scene.textures, tex_id, m.albedo[mat_l], uv)
    emittance = sample_texture(scene.textures, tex_id, m.emittance[mat_l], uv)

    return HitAttributes(
        albedo=albedo,
        emittance=emittance,
        roughness=m.roughness[mat_l],
        ior=m.ior[mat_l],
        extinction=m.extinction[mat_l],
        transparent=m.transparent[mat_l],
        triangle_index=idx,
        position=position,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        t=t,
    )
