"""Wavefront path tracing: a bounded Python loop over bounces with masks.

Port of ``isaklm_raytracer_tpu/integrator/path_trace.py`` (reference
path_tracing.cuh:268-325); the ``lax.scan`` over bounces becomes a Python
loop. The estimator's bookkeeping is kept exactly:
  - emitted radiance is added only when the PREVIOUS event was not diffuse
    (path_tracing.cuh:285-288);
  - after a diffuse event, the NEE contribution is weighted by the
    throughput INCLUDING the new albedo weight (path_tracing.cuh:296-301);
  - a miss terminates the path with a black background;
  - RR survival = max throughput channel, reweight 1/p, survival detached
    (path_tracing.cuh:309-318).

Per-bounce variates come from the counter sampler (stream = bounce), keyed
on the global pixel ids, so a pixel's path does not depend on its batch.

A bounce is the intersector call, the first half of the shading
(``kernels/shade.py``: hit attributes, emission, the BSDF sample and the
NEE shadow rays), the shadow rays' intersector call and the second half
(the direct light and Russian roulette): two kernels on the card, or their
plain versions (``shade_route``).
"""

from __future__ import annotations

import torch

from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.kernels import shade
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene.types import Scene


def shade_route(scene: Scene, origins: torch.Tensor, directions: torch.Tensor) -> str:
    """How ``trace_paths`` shades a bounce: "kernel" (the two kernels of
    ``kernels/shade.py``, one launch each a bounce) for CUDA rays when
    autograd records none of the inputs (none requires grad, or grad mode
    is off), else "plain" (their plain versions, whose tensor ops autograd
    differentiates)."""
    if not origins.is_cuda:
        return "plain"
    if torch.is_grad_enabled():
        m, tex = scene.materials, scene.textures
        inputs = (origins, directions, scene.vertices, scene.normals, scene.uvs,
                  scene.shade_table, tex.buffer, m.albedo, m.emittance, m.roughness, m.ior,
                  m.extinction, m.transparent)
        if any(t is not None and t.requires_grad for t in inputs):
            return "plain"
    return "kernel"


def shading(route: str):
    """(shade, finish) of a route: ``shade.shade_bounce`` and
    ``shade.finish_bounce``, or their plain versions."""
    if route == "kernel":
        return shade.shade_bounce, shade.finish_bounce
    return shade.shade_bounce_plain, shade.finish_bounce_plain


def trace_paths(
    scene: Scene,
    trace_fn,
    origins: torch.Tensor,
    directions: torch.Tensor,
    key_words,
    ray_ids: torch.Tensor,
    config: RenderConfig,
) -> torch.Tensor:
    """Trace one full path per ray; returns outgoing radiance (R, 3).

    trace_fn(o, d, active=, t_max=) -> (t, idx, hit): the intersector.
    key_words: per-sample (k0, k1) (math.rng.sample_key_words);
    ray_ids: (R,) global pixel ids (the RNG counter words).
    """
    num_rays = origins.shape[0]
    device = origins.device
    shade_fn, finish_fn = shading(shade_route(scene, origins, directions))
    ray_o, ray_d = origins.contiguous(), directions.contiguous()
    throughput = torch.ones((num_rays, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((num_rays, 3), dtype=torch.float32, device=device)
    inside = torch.zeros((num_rays,), dtype=torch.bool, device=device)
    prev_diffuse = torch.zeros((num_rays,), dtype=torch.bool, device=device)
    active = torch.ones((num_rays,), dtype=torch.bool, device=device)

    for bounce in range(config.max_bounces):
        u = rng.uniforms(key_words, ray_ids, bounce, shade.BOUNCE_UNIFORMS)  # (9, R)

        _, idx, hit = trace_fn(ray_o, ray_d, active=active)
        pending = shade_fn(scene, ray_o, ray_d, idx, hit, active, throughput, radiance, inside,
                           prev_diffuse, u, config.lobe_ratio_grad)
        shadow_idx = shadow_hit = None
        if scene.has_lights:
            _, shadow_idx, shadow_hit = trace_fn(pending.ray_o, pending.shadow_dir,
                                                 active=pending.nee_mask, t_max=pending.window)
        ray_o, ray_d, throughput, radiance, inside, prev_diffuse, active = finish_fn(
            scene, pending, shadow_idx, shadow_hit, u[8], bounce >= config.rr_start_bounce)

    return radiance
