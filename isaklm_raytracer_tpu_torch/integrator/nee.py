"""Next Event Estimation: direct light sampling with shadow rays.

Port of ``isaklm_raytracer_tpu/integrator/nee.py`` (reference
path_tracing.cuh:235-265): pick a light triangle uniformly, a uniform point
on it, shoot a shadow ray through the intersector, accept only if the light
triangle itself is the nearest hit, and weight by
  emittance * area * light_count * cos1 * cos2 / max(d^2 * pi, 1e-3).
"""

from __future__ import annotations

import math

import torch

from isaklm_raytracer_tpu_torch.accel.traverse import hit_attributes
from isaklm_raytracer_tpu_torch.math import sampling, transforms
from isaklm_raytracer_tpu_torch.math.transforms import cross, dot
from isaklm_raytracer_tpu_torch.scene.types import Scene


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
    num_lights = scene.num_lights
    pick = torch.clamp((u_pick * num_lights).to(torch.int32), 0, num_lights - 1)
    light_idx = scene.light_indices[pick.long()]

    tri = scene.vertices[light_idx.long()]
    p1, p2, p3 = tri[:, 0], tri[:, 1], tri[:, 2]
    point = sampling.uniform_triangle(u_tri1, u_tri2, p1, p2, p3)

    to_light = point - position
    shadow_dir = transforms.normalize(to_light)

    # Search window: hits beyond the light cannot change the verdict, so
    # the intersector may stop there. The 0.1% slack covers f32 plane-hit
    # error so the light itself is never cut off.
    t_light = torch.sqrt(dot(to_light, to_light))
    window = t_light * 1.001 + 1e-3

    _, idx, hit = trace_fn(position, shadow_dir, active=active, t_max=window)
    visible = hit & (idx == light_idx)

    attrs = hit_attributes(scene, position, shadow_dir, idx, hit)

    e = cross(p2 - p1, p3 - p1)
    light_area = 0.5 * torch.sqrt(dot(e, e))
    dist_sq = dot(to_light, to_light)

    cos1 = torch.clamp_min(-dot(shadow_dir, attrs.normal), 0.0)
    cos2 = torch.clamp_min(dot(shadow_dir, surface_normal), 0.0)

    scale = (
        light_area
        * float(num_lights)
        * cos1
        * cos2
        / torch.clamp_min(dist_sq * math.pi, 0.001)
    )
    contribution = attrs.emittance * scale[..., None]
    return torch.where(visible[..., None], contribution, 0.0)
