"""3x3 transforms and small vector helpers.

Port of ``isaklm_raytracer_tpu/math/transforms.py``. Matrices are row-major
(3, 3) float32 tensors applied as ``M @ v``.

The three-term dot and cross products are written out elementwise, never as
a reduction or a matmul: a library GEMM or reduction may pick another
summation order (or FMA contraction) depending on the batch size, and the
compacted adaptive steps must stay bit-identical to the masked full step.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Three-term dot product over the last axis, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3D cross product on the last axis (jnp.cross's formula)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v @ m.T`` for (..., 3) rows and a (3, 3) matrix, per row."""
    return torch.stack([dot(v, m[0]), dot(v, m[1]), dot(v, m[2])], -1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| along the last axis (reference normalize,
    math_library.cuh:232-237), with the JAX package's 1e-30 floor."""
    return v * torch.reciprocal(
        torch.sqrt(torch.clamp_min(dot(v, v), 1e-30))
    )[..., None]


def rotation_matrix(yaw: float, pitch: float = 0.0, roll: float = 0.0,
                    device=None) -> torch.Tensor:
    """Rz(roll) @ Ry(yaw) @ Rx(pitch), reference math_library.cuh:384-408."""
    # torch.full fills a host value on the device without a copy from the
    # host, which a CUDA graph capture refuses
    yaw, pitch, roll = (
        a.to(dtype=torch.float32, device=device) if isinstance(a, torch.Tensor)
        else torch.full((), a, dtype=torch.float32, device=device)
        for a in (yaw, pitch, roll)
    )
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    one, zero = torch.ones_like(cy), torch.zeros_like(cy)
    ry = torch.stack([
        torch.stack([cy, zero, sy]),
        torch.stack([zero, one, zero]),
        torch.stack([-sy, zero, cy]),
    ])
    rx = torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, cp, -sp]),
        torch.stack([zero, sp, cp]),
    ])
    rz = torch.stack([
        torch.stack([cr, -sr, zero]),
        torch.stack([sr, cr, zero]),
        torch.stack([zero, zero, one]),
    ])
    return rz @ ry @ rx



def scale_matrix(scale, device=None) -> torch.Tensor:
    """Uniform scale (math_library.cuh:410-420): eye(3) * scale, float32."""
    if isinstance(scale, torch.Tensor):
        scale = scale.to(dtype=torch.float32, device=device)
        device = scale.device
    return torch.eye(3, dtype=torch.float32, device=device) * scale


def invert(m: torch.Tensor) -> torch.Tensor:
    """3x3 inverse (math_library.cuh:357-382), by LU in float32 as the JAX
    package's ``jnp.linalg.inv``: not bit-equal to it (another
    factorization's rounding)."""
    return torch.linalg.inv(torch.as_tensor(m, dtype=torch.float32))


def orthonormal_frame(normal: torch.Tensor, edge: torch.Tensor):
    """Shading frame at hit points (trace_ray.cuh:161-162): tangent =
    normalize(cross(edge, normal)), bitangent = normalize(cross(normal,
    tangent)). ``normal`` (..., 3) must be normalized; ``edge`` is any
    vector not parallel to it."""
    tangent = normalize(cross(edge, normal))
    bitangent = normalize(cross(normal, tangent))
    return tangent, bitangent
