"""Reparameterized sampling warps and microfacet/Fresnel terms.

Port of ``isaklm_raytracer_tpu/math/sampling.py``. Every sampler is a pure
function of explicit uniforms ``u`` in [0, 1). The reference's deliberate
deviations are kept: the conductor Fresnel's multiplicative t3 term and the
additive roughness term of the Smith lambda (path_tracing.cuh:76-127).

All inputs broadcast; vectors live on the last axis (..., 3).
"""

from __future__ import annotations

import math

import torch

from isaklm_raytracer_tpu_torch.math.transforms import dot

TAU = 2.0 * math.pi


def cosine_hemisphere(u1, u2, normal, tangent, bitangent) -> torch.Tensor:
    """Cosine-weighted hemisphere direction (path_tracing.cuh:45-59)."""
    phi = u1 * TAU
    sqrt_u2 = torch.sqrt(u2)
    cos_t = torch.sqrt(1.0 - u2)
    return (
        (sqrt_u2 * torch.cos(phi))[..., None] * tangent
        + cos_t[..., None] * normal
        + (sqrt_u2 * torch.sin(phi))[..., None] * bitangent
    )


def ggx_half_vector(u1, u2, roughness, normal, tangent, bitangent) -> torch.Tensor:
    """GGX NDF-sampled microfacet normal (path_tracing.cuh:103-118)."""
    a2 = roughness * roughness
    denom = torch.clamp_min(u1 * (a2 - 1.0) + 1.0, 1e-12)
    cos_t = torch.sqrt(torch.clamp((1.0 - u1) / denom, 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
    phi = u2 * TAU
    return (
        (sin_t * torch.cos(phi))[..., None] * tangent
        + cos_t[..., None] * normal
        + (sin_t * torch.sin(phi))[..., None] * bitangent
    )


def fresnel_dielectric(wi, half, n1, n2) -> torch.Tensor:
    """Exact dielectric Fresnel, Walter et al. form (path_tracing.cuh:61-74)."""
    c = torch.abs(dot(wi, half))
    g = torch.sqrt(torch.clamp_min((n2 * n2) / (n1 * n1) - 1.0 + c * c, 1e-12))
    factor1 = 0.5 * ((g - c) / torch.clamp_min(g + c, 1e-12)) ** 2
    den = c * (g - c) + 1.0
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    factor2 = 1.0 + ((c * (g + c) - 1.0) / den) ** 2
    return factor1 * factor2


def fresnel_conductor(wi, half, n, k) -> torch.Tensor:
    """Conductor Fresnel (path_tracing.cuh:76-101), with the reference's
    multiplicative t3 term and the analytic limit at normal incidence."""
    n2 = n * n
    k2 = k * k
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
    ratio = torch.where(
        nonzero,
        (t3 - t4) / torch.where(nonzero, denom, torch.ones_like(denom)),
        torch.full_like(denom, -1.0),
    )
    rp = rs * ratio
    return 0.5 * (rs + rp)


def smith_lambda(direction, normal, roughness) -> torch.Tensor:
    """Reference's Smith lambda term (path_tracing.cuh:120-127), with the
    roughness^2 term additive as there."""
    d = dot(direction, normal)
    d2 = torch.clamp_min(d * d, 1e-12)
    tan2 = (1.0 - d2) / d2
    return (torch.sqrt(1.0 + roughness * roughness + tan2) - 1.0) * 0.5


def specular_weight(wi, wo, half, normal, roughness) -> torch.Tensor:
    """Microfacet sample weight |i.h| G / (|n.h| |i.n|)
    (path_tracing.cuh:129-136)."""
    g = 1.0 / (
        1.0 + smith_lambda(wi, normal, roughness) + smith_lambda(wo, normal, roughness)
    )
    return torch.abs(dot(wi, half)) * g / torch.clamp_min(
        torch.abs(dot(normal, half)) * torch.abs(dot(wi, normal)), 1e-12
    )


def reflect(wi, half) -> torch.Tensor:
    """Mirror direction 2(i.h)h - i (path_tracing.cuh:138-141)."""
    return 2.0 * dot(wi, half)[..., None] * half - wi


def refract(wi, half, n1, n2) -> torch.Tensor:
    """Refraction direction (path_tracing.cuh:143-149); total internal
    reflection clamps to the grazing direction."""
    c = dot(wi, half)
    n = n1 / n2
    root = torch.sqrt(torch.clamp_min(1.0 + n * n * (c * c - 1.0), 1e-12))
    return (n * c - root)[..., None] * half - n[..., None] * wi


def uniform_triangle(u1, u2, p1, p2, p3) -> torch.Tensor:
    """Uniform point on a triangle via sqrt warp (path_tracing.cuh:222-233)."""
    sqrt_x = torch.sqrt(u1)
    u = 1.0 - sqrt_x
    v = u2 * sqrt_x
    w = 1.0 - u - v
    return u[..., None] * p1 + v[..., None] * p2 + w[..., None] * p3


def disc_aperture(u1, u2, radius):
    """(x, y) offset inside an aperture disc (path_tracing.cuh:327-336)."""
    theta = u1 * TAU
    r = torch.sqrt(u2) * radius
    return r * torch.cos(theta), r * torch.sin(theta)
