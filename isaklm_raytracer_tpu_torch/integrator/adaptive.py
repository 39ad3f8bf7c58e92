"""Per-pixel adaptive sampling gate.

Port of ``isaklm_raytracer_tpu/integrator/adaptive.py`` (reference
path_tracing.cuh:347-376): always sample below MIN_SAMPLES; afterwards keep
sampling while the 95% CI half-width sqrt(2) * erfinv(1 - tol) * sqrt(var / n)
exceeds mean * tol.
"""

from __future__ import annotations

import math

import torch

from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.math.color import luminance
from isaklm_raytracer_tpu_torch.scene.types import GBuffer


def needs_sample(gbuffer: GBuffer, config: RenderConfig) -> torch.Tensor:
    """Boolean (H*W,) mask: which pixels still need another sample."""
    n = gbuffer.count
    nf = n.to(torch.float32)

    total_lum = luminance(gbuffer.frame)
    total_sq = gbuffer.sq_luminance

    # n <= 1 lanes are forced to sample by the MIN_SAMPLES branch.
    safe_n = torch.clamp_min(nf, 2.0)
    mean = total_lum / safe_n
    variance = (total_sq - total_lum * total_lum / safe_n) / (safe_n - 1.0)
    variance = torch.clamp_min(variance, 0.0)

    # torch.full fills on the device; a torch.tensor of a host value would
    # copy it there and wait, which a CUDA graph capture refuses
    z = torch.special.erfinv(
        torch.full((), 1.0 - config.max_tolerance, dtype=torch.float32, device=nf.device)
    )
    half_width = (
        torch.full((), math.sqrt(2.0), dtype=torch.float32, device=nf.device)
        * z
        * torch.sqrt(variance / safe_n)
    )
    unconverged = half_width > mean * config.max_tolerance

    return (n < config.min_samples) | ((n < config.max_samples) & unconverged)
