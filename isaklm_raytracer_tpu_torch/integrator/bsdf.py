"""Vectorised microfacet BSDF sampling (wavefront form).

Port of ``isaklm_raytracer_tpu/integrator/bsdf.py`` (reference
path_tracing.cuh:151-219): all four lobes -- metallic, specular,
transmission, diffuse -- are evaluated for every lane and combined with
``torch.where``. Lanes that never select a lobe still feed it benign inputs,
so no NaN reaches a selected value.
"""

from __future__ import annotations

import dataclasses

import torch

from isaklm_raytracer_tpu_torch.accel.traverse import HitAttributes
from isaklm_raytracer_tpu_torch.math import sampling


@dataclasses.dataclass
class ScatterSample:
    """Vectorised Scattering_Event (path_tracing.cuh:27-32)."""

    direction: torch.Tensor  # (R, 3) new ray direction
    weight: torch.Tensor  # (R, 3) throughput multiplier
    is_diffuse: torch.Tensor  # (R,) bool -- drives NEE + emittance bookkeeping
    inside_medium: torch.Tensor  # (R,) bool, post-event


def _where(mask, a, b: float):
    # a Python scalar goes to the kernel by value: no copy to the device
    return torch.where(mask, a, b)


def scatter(
    hit: HitAttributes,
    ray_direction: torch.Tensor,
    inside_medium: torch.Tensor,
    u_half1: torch.Tensor,
    u_half2: torch.Tensor,
    u_lobe: torch.Tensor,
    u_diff1: torch.Tensor,
    u_diff2: torch.Tensor,
    lobe_ratio_grad: bool = True,
) -> ScatterSample:
    """Sample the next scattering event for every lane.

    ray_direction: (R, 3) direction of travel (flipped to point away from
    the surface, path_tracing.cuh:155).
    """
    wi = -ray_direction
    normal, tangent, bitangent = hit.normal, hit.tangent, hit.bitangent
    rough = hit.roughness

    half = sampling.ggx_half_vector(u_half1, u_half2, rough, normal, tangent, bitangent)

    is_metal = hit.extinction > 0.0

    # --- metallic lobe (path_tracing.cuh:161-171)
    n_metal = _where(is_metal, hit.ior, 1.0)
    k_metal = _where(is_metal, hit.extinction, 1.0)
    f_cond = sampling.fresnel_conductor(wi, half, n_metal, k_metal)
    refl = sampling.reflect(wi, half)
    sw_refl = sampling.specular_weight(wi, refl, half, normal, rough)
    w_metal = hit.albedo * (sw_refl * f_cond)[..., None]

    # --- dielectric stack (path_tracing.cuh:174-217); the floor keeps an
    # unset ior 0 finite inside a medium.
    ior = torch.clamp_min(hit.ior, 1e-6)
    n1 = _where(inside_medium, ior, 1.0)
    n2 = torch.where(inside_medium, torch.ones_like(ior), ior)
    f_diel = sampling.fresnel_dielectric(wi, half, n1, n2)
    # The lobe is CHOSEN with the detached Fresnel; each lobe's weight
    # carries live/detached Fresnel ratios, exactly 1 in the forward pass.
    f_det = f_diel.detach()
    choose_specular = u_lobe < f_det
    if lobe_ratio_grad:
        ratio_spec = f_diel / torch.clamp_min(f_det, 1e-12)
        ratio_rest = (1.0 - f_diel) / torch.clamp_min(1.0 - f_det, 1e-12)
    else:
        ratio_spec = torch.ones_like(f_det)
        ratio_rest = torch.ones_like(f_det)

    w_spec = (
        torch.where(inside_medium, torch.ones_like(sw_refl), sw_refl) * ratio_spec
    )[..., None] * torch.ones((1, 3), dtype=torch.float32, device=wi.device)

    is_transparent = hit.transparent > 0.5
    n1_t = _where(is_transparent, n1, 1.0)
    n2_t = _where(is_transparent, n2, 1.5)
    refr = sampling.refract(wi, half, n1_t, n2_t)
    sw_refr = sampling.specular_weight(wi, refr, half, normal, rough)
    w_trans = hit.albedo * (sw_refr * ratio_rest)[..., None]

    diff = sampling.cosine_hemisphere(u_diff1, u_diff2, normal, tangent, bitangent)
    w_diff = hit.albedo * ratio_rest[..., None]

    is_spec = (~is_metal) & choose_specular
    is_trans = (~is_metal) & (~choose_specular) & is_transparent
    is_diff = (~is_metal) & (~choose_specular) & (~is_transparent)

    def sel(mask, a, b):
        return torch.where(mask[..., None], a, b)

    direction = sel(is_metal, refl, sel(is_spec, refl, sel(is_trans, refr, diff)))
    weight = sel(is_metal, w_metal, sel(is_spec, w_spec, sel(is_trans, w_trans, w_diff)))

    return ScatterSample(
        direction=direction,
        weight=weight,
        is_diffuse=is_diff,
        inside_medium=torch.where(is_trans, ~inside_medium, inside_medium),
    )
