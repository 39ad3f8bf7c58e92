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
"""

from __future__ import annotations

import torch

from isaklm_raytracer_tpu_torch.accel.traverse import hit_attributes
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.bsdf import scatter
from isaklm_raytracer_tpu_torch.integrator.nee import sample_direct_light
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene.types import Scene


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
    ray_o, ray_d = origins, directions
    throughput = torch.ones((num_rays, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((num_rays, 3), dtype=torch.float32, device=device)
    inside = torch.zeros((num_rays,), dtype=torch.bool, device=device)
    prev_diffuse = torch.zeros((num_rays,), dtype=torch.bool, device=device)
    active = torch.ones((num_rays,), dtype=torch.bool, device=device)

    for bounce in range(config.max_bounces):
        u = rng.uniforms(key_words, ray_ids, bounce, 9)  # (9, R)

        _, idx, hit = trace_fn(ray_o, ray_d, active=active)
        attrs = hit_attributes(scene, ray_o, ray_d, idx, hit)
        live = active & hit

        emit_mask = live & (~prev_diffuse)
        radiance = radiance + torch.where(
            emit_mask[:, None], attrs.emittance * throughput, 0.0
        )

        event = scatter(
            attrs, ray_d, inside, u[0], u[1], u[2], u[3], u[4],
            lobe_ratio_grad=config.lobe_ratio_grad,
        )
        new_throughput = throughput * event.weight

        if scene.has_lights:
            nee_mask = live & event.is_diffuse
            direct = sample_direct_light(
                scene, attrs.position, attrs.normal, u[5], u[6], u[7], trace_fn,
                active=nee_mask,
            )
            radiance = radiance + torch.where(
                nee_mask[:, None], direct * new_throughput, 0.0
            )

        # Russian roulette; the reference divides by the raw max channel
        # even when it exceeds 1. Bounces below rr_start_bounce skip it.
        survival = new_throughput.max(dim=-1).values.detach()
        if bounce >= config.rr_start_bounce:
            rr_alive = u[8] <= survival
            new_throughput = torch.where(
                rr_alive[:, None],
                new_throughput / torch.clamp_min(survival, 1e-30)[:, None],
                new_throughput,
            )
        else:
            rr_alive = torch.ones_like(live)

        next_active = live & rr_alive
        ray_o = torch.where(live[:, None], attrs.position, ray_o)
        ray_d = torch.where(live[:, None], event.direction, ray_d)
        throughput = torch.where(live[:, None], new_throughput, throughput)
        inside = torch.where(live, event.inside_medium, inside)
        prev_diffuse = torch.where(live, event.is_diffuse, prev_diffuse)
        active = next_active

    return radiance
