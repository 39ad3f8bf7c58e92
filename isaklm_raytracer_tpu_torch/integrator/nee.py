"""Next Event Estimation: direct light sampling with shadow rays.

Port of ``isaklm_raytracer_tpu/integrator/nee.py`` (reference
path_tracing.cuh:235-265): pick a light triangle uniformly, a uniform point
on it, shoot a shadow ray through the intersector, accept only if the light
triangle itself is the nearest hit, and weight by
  emittance * area * light_count * cos1 * cos2 / max(d^2 * pi, 1e-3).

The estimate comes in two halves around the intersector call, so that the
render's fused shading kernels (``kernels/shade.py``) can end one kernel
before the call and start the next after it: ``shadow_rays`` (the light
pick, the point on the light, the shadow ray and its window) and
``direct_from_hit`` (visibility and the weight). ``sample_direct_light``
composes them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from isaklm_raytracer_tpu_torch.accel.traverse import hit_attributes
from isaklm_raytracer_tpu_torch.math import sampling, transforms
from isaklm_raytracer_tpu_torch.math.transforms import cross, dot
from isaklm_raytracer_tpu_torch.scene.types import Scene


@dataclasses.dataclass
class ShadowRays:
    """The shadow rays of ``shadow_rays``, one a shading point."""

    origin: torch.Tensor  # (R, 3) the shading points
    direction: torch.Tensor  # (R, 3) unit, toward the point on the light
    window: torch.Tensor  # (R,) t_max of the intersector call
    light_idx: torch.Tensor  # (R,) int32 the picked light triangle
    dist_sq: torch.Tensor  # (R,) squared distance to the point on the light


def shadow_rays(
    scene: Scene,
    position: torch.Tensor,
    u_pick: torch.Tensor,
    u_tri1: torch.Tensor,
    u_tri2: torch.Tensor,
) -> ShadowRays:
    """The light pick, the uniform point on the picked triangle and the
    shadow ray from ``position`` (R, 3) toward it."""
    num_lights = scene.num_lights
    pick = torch.clamp((u_pick * num_lights).to(torch.int32), 0, num_lights - 1)
    light_idx = scene.light_indices[pick.long()]

    tri = scene.vertices[light_idx.long()]
    p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
    point = sampling.uniform_triangle(u_tri1, u_tri2, p1, p2, p3)

    to_light = point - position
    dist_sq = dot(to_light, to_light)
    # Search window: hits beyond the light cannot change the verdict, so
    # the intersector may stop there. The 0.1% slack covers f32 plane-hit
    # error so the light itself is never cut off.
    window = torch.sqrt(dist_sq) * 1.001 + 1e-3
    return ShadowRays(origin=position, direction=transforms.normalize(to_light),
                      window=window, light_idx=light_idx, dist_sq=dist_sq)


def direct_from_hit(
    scene: Scene,
    shadow: ShadowRays,
    surface_normal: torch.Tensor,
    idx: torch.Tensor,
    hit: torch.Tensor,
) -> torch.Tensor:
    """Radiance (R, 3) the shadow rays bring from their light, given the
    intersector's (idx, hit) for them: zero unless the picked triangle is
    the nearest hit."""
    visible = hit & (idx == shadow.light_idx)
    attrs = hit_attributes(scene, shadow.origin, shadow.direction, idx, hit)

    tri = scene.vertices[shadow.light_idx.long()]
    p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
    e = cross(p2 - p1, p3 - p1)
    light_area = 0.5 * torch.sqrt(dot(e, e))

    cos1 = torch.clamp_min(-dot(shadow.direction, attrs.normal), 0.0)
    cos2 = torch.clamp_min(dot(shadow.direction, surface_normal), 0.0)

    scale = (
        light_area
        * float(scene.num_lights)
        * cos1
        * cos2
        / torch.clamp_min(shadow.dist_sq * math.pi, 0.001)
    )
    contribution = attrs.emittance * scale[..., None]
    return torch.where(visible[..., None], contribution, 0.0)


def sample_direct_light(
    scene: Scene,
    position: torch.Tensor,
    surface_normal: torch.Tensor,
    u_pick: torch.Tensor,
    u_tri1: torch.Tensor,
    u_tri2: torch.Tensor,
    trace_fn,
    active=None,
) -> torch.Tensor:
    """Direct light estimate at ``position`` (R, 3); returns radiance (R, 3).

    trace_fn(o, d, active=, t_max=) -> (t, idx, hit) is the intersector.
    """
    shadow = shadow_rays(scene, position, u_pick, u_tri1, u_tri2)
    _, idx, hit = trace_fn(shadow.origin, shadow.direction, active=active, t_max=shadow.window)
    return direct_from_hit(scene, shadow, surface_normal, idx, hit)
