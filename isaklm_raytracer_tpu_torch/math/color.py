"""Color pipeline: sRGB OETF, ACES (Stephen Hill RRT+ODT fit), luminance.

Port of ``isaklm_raytracer_tpu/math/color.py`` (reference
math_library.cuh:37-52, 263-266, 422-460). All functions take tensors whose
last axis is RGB. The 3x3 colour transforms are applied row by row with
``transforms.apply`` so a pixel's value does not depend on the batch it
was computed in.
"""

from __future__ import annotations

import functools

import torch

from isaklm_raytracer_tpu_torch.math import transforms

# Row-major transposes of the reference's column-vector initialisers
# (math_library.cuh:424-436), as in the JAX package.
ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)
LUMINANCE_WEIGHTS = (0.2126, 0.7152, 0.0722)


@functools.cache
def _const_on(values, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` as a float32 tensor on ``like``'s device, made once a
    device: a CUDA graph capture refuses the copy from the host."""
    return _const_on(values, like.device)


def gamma_correction(x: torch.Tensor) -> torch.Tensor:
    """sRGB OETF (math_library.cuh:37-47). Elementwise."""
    linear = 12.92 * x
    safe = torch.clamp_min(x, 1e-10)
    curved = 1.055 * torch.pow(safe, 1.0 / 2.4) - 0.055
    return torch.where(x > 0.0031308, curved, linear)


def aces_curve(x: torch.Tensor) -> torch.Tensor:
    """Fitted RRT+ODT rational curve (math_library.cuh:49-52). Elementwise."""
    num = x * (x + 0.0245786) - 0.000090537
    den = x * (0.983729 * x + 0.4329510) + 0.238081
    return num / den


def aces_tone_mapping(color: torch.Tensor) -> torch.Tensor:
    """ACES tonemap on (..., 3) RGB (math_library.cuh:422-443)."""
    color = transforms.apply(_const(ACES_INPUT, color), color)
    color = aces_curve(color)
    return transforms.apply(_const(ACES_OUTPUT, color), color)


def correct_color(color: torch.Tensor) -> torch.Tensor:
    """Display transform: clamp>=0 -> ACES -> sRGB gamma -> clamp [0,1]
    (math_library.cuh:445-460)."""
    color = aces_tone_mapping(torch.clamp_min(color, 0.0))
    return torch.clamp(gamma_correction(color), 0.0, 1.0)


def luminance(color: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of (..., 3) RGB (math_library.cuh:263-266)."""
    return transforms.dot(color, _const(LUMINANCE_WEIGHTS, color))
