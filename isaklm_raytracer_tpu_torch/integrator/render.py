"""Progressive frame orchestration: the reference's render loop, headless.

Port of ``isaklm_raytracer_tpu/integrator/render.py`` (reference
render.cuh:18-76, main.cu:114-155). Each step adds one path-traced sample
to every unconverged pixel of the G-buffer; the display image is the
tonemapped per-pixel average.

The adaptive loop shrinks the launched wavefront to the unconverged pixels
along the ceil-halving bucket ladder, first by compacting the active ids,
then in TAIL MODE over a candidate id set that only shrinks. Every variate
is keyed on the global pixel id, so the compacted and tail steps are
bit-identical to the masked full step.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from isaklm_raytracer_tpu_torch.accel.kd_traverse import nearest_hit_kd
from isaklm_raytracer_tpu_torch.accel.wavefront import nearest_hit_wavefront
from isaklm_raytracer_tpu_torch.camera.camera import Camera, generate_rays
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
from isaklm_raytracer_tpu_torch.integrator.path_trace import trace_paths
from isaklm_raytracer_tpu_torch.kernels.intersect import (
    FLAT_CLUSTER_LIMIT,
    VMEM_TABLE_LIMIT,
    brute_intersect,
    nearest_hit_blk,
    nearest_hit_blk_mxu,
    nearest_hit_flat,
    nearest_hit_flat_mxu,
    nearest_hit_hbm,
    nearest_hit_queue,
)
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.math.color import correct_color, luminance
from isaklm_raytracer_tpu_torch.scene.types import GBuffer, Scene

# The JAX package's intersector names (ISAKLM_INTERSECTOR), each with its
# nearest-hit function and the ray order the JAX package's
# ``_pick_cluster_kernel`` gives it (blk: ``blk_sort_mode``).
_INTERSECTORS = {
    "flat": (nearest_hit_flat, True),
    "flat_mxu": (nearest_hit_flat_mxu, False),
    "queue": (nearest_hit_queue, True),
    "hbm": (nearest_hit_hbm, True),
    "blk": (nearest_hit_blk, None),
    "blk_mxu": (nearest_hit_blk_mxu, True),
}
# the table each override needs, as the JAX package checks it
_NEEDS = {"blk": "blk_const", "blk_mxu": "mxu_const", "flat_mxu": "mxu_tiles"}


def intersector_name(cbvh) -> str:
    """The intersector for a prepared scene, picked by the JAX package's
    auto rule: "flat" for at most FLAT_CLUSTER_LIMIT real clusters, "queue"
    for a cluster table of at most VMEM_TABLE_LIMIT bytes, above it "blk"
    if the scene has blocked tables, else "blk_mxu" if it has MXU blocks,
    else "hbm". The same name serves every device: its kernel on CUDA, its
    plain version on the CPU.

    ISAKLM_INTERSECTOR overrides the rule with any of the six names; an
    unknown name, or a name whose table the scene lacks (blk: blk_const,
    blk_mxu: mxu_const, flat_mxu: mxu_tiles), raises ValueError, as in the
    JAX package."""
    override = os.environ.get("ISAKLM_INTERSECTOR", "auto")
    if override != "auto":
        if override not in _INTERSECTORS:
            raise ValueError(
                f"ISAKLM_INTERSECTOR={override!r}: unknown intersector (expected one "
                f"of {tuple(_INTERSECTORS)} or 'auto')"
            )
        needs = _NEEDS.get(override)
        if needs is not None and getattr(cbvh, needs) is None:
            raise ValueError(
                f"ISAKLM_INTERSECTOR={override!r} needs cbvh.{needs}; this scene was "
                "prepared without that table (see accel.with_blocks / with_mxu_blocks "
                "/ with_mxu_tiles)"
            )
        return override
    if cbvh.real_clusters <= FLAT_CLUSTER_LIMIT:
        return "flat"
    if cbvh.vmem_bytes <= VMEM_TABLE_LIMIT:
        return "queue"
    if cbvh.blk_const is not None:
        return "blk"
    if cbvh.mxu_const is not None:
        return "blk_mxu"
    return "hbm"


def blk_sort_mode() -> str:
    """Ray ordering for the blk intersector, as the JAX package's
    ``blk_sort_mode``: "morton" (the default; the origin/direction Morton
    key) or "block" (the first-needed-block key of
    ``kernels.intersect.first_block_keys``). ISAKLM_BLK_SORT overrides;
    any other value raises ValueError."""
    mode = os.environ.get("ISAKLM_BLK_SORT", "morton")
    if mode not in ("block", "morton"):
        raise ValueError(f"ISAKLM_BLK_SORT={mode!r}: expected 'block' or 'morton'")
    return mode


def trace_name(scene: Scene) -> str:
    """What ``make_trace_fn`` traces ``scene`` with, in the JAX package's
    order of preference: the intersector ``intersector_name`` picks when the
    scene has cluster tables, else "wavefront kd" (``scene.wkd``), "kd"
    (``scene.kd``) or "brute"."""
    if scene.cbvh is not None:
        return intersector_name(scene.cbvh)
    if scene.wkd is not None:
        return "wavefront kd"
    return "brute" if scene.kd is None else "kd"


def make_trace_fn(scene: Scene, config: RenderConfig):
    """The intersector ``trace_name`` names: trace(o, d, active=None,
    t_max=None) -> (t, idx, hit), a kernel on CUDA tensors and its plain
    version on CPU tensors:

    - cluster tables: the ``nearest_hit_*`` of the intersector, ordering its
      rays as the JAX package's ``_pick_cluster_kernel`` does: caller order
      for flat_mxu, ``blk_sort_mode`` for blk, Morton for the others;
    - "wavefront kd": ``nearest_hit_wavefront`` over ``scene.wkd``;
    - "kd": ``nearest_hit_kd`` over ``scene.kd``;
    - "brute": ``kernels.intersect.brute_intersect`` (``nearest_hit_brute``
      on the CPU)."""
    name = trace_name(scene)
    if scene.cbvh is not None:
        # read for every scene, as the JAX package does: a bad value raises
        blk_sort = {"block": "block", "morton": True}[blk_sort_mode()]
        fn, sort_rays = _INTERSECTORS[name]
        return functools.partial(
            fn, scene.cbvh, t_eps=config.t_epsilon,
            sort_rays=blk_sort if sort_rays is None else sort_rays,
        )
    if name == "wavefront kd":
        return functools.partial(nearest_hit_wavefront, scene.wkd, t_eps=config.t_epsilon)
    if name == "kd":
        return functools.partial(nearest_hit_kd, scene.kd, scene.vertices,
                                 t_eps=config.t_epsilon)
    return functools.partial(brute_intersect, scene.vertices, t_eps=config.t_epsilon)


def render_sample(
    scene: Scene,
    camera: Camera,
    key_words,
    config: RenderConfig,
    active: Optional[torch.Tensor] = None,
    trace_fn=None,
    pixel_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One radiance sample per pixel; returns (R, 3).

    key_words: per-sample (k0, k1) from ``rng.sample_key_words``.
    ``pixel_ids`` (global flat ids) selects a pixel subset; default = all.
    ``active`` masks pixels: inactive ones still compute, their result is
    zeroed. Rays go through in ``config.ray_chunk``-sized passes.
    """
    device = scene.device
    if trace_fn is None:
        trace_fn = make_trace_fn(scene, config)
    if pixel_ids is None:
        pixel_ids = torch.arange(config.num_pixels, dtype=torch.int32, device=device)
    num_rays = pixel_ids.shape[0]
    chunk = config.ray_chunk or num_rays

    parts = []
    for start in range(0, num_rays, max(chunk, 1)):
        ids = pixel_ids[start:start + chunk]
        px = ids % config.width
        py = ids // config.width
        cam_u = rng.uniforms(key_words, ids, rng.CAMERA_STREAM, 4).T  # (R, 4)
        origins, directions = generate_rays(
            camera, config.width, config.height, px, py, cam_u
        )
        parts.append(
            trace_paths(scene, trace_fn, origins, directions, key_words, ids, config)
        )
    radiance = torch.cat(parts) if parts else torch.zeros(
        (0, 3), dtype=torch.float32, device=device
    )
    if active is not None:
        radiance = torch.where(active[:, None], radiance, 0.0)
    return radiance


def render_step(
    scene: Scene,
    camera: Camera,
    gbuffer: GBuffer,
    key_words,
    config: RenderConfig,
    adaptive: bool = True,
    trace_fn=None,
    pixel_ids: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    reduce=None,
) -> GBuffer:
    """Progressive step over every pixel, masked by the adaptive gate
    (path_tracing.cuh:338-395).

    For a shard of the image (``dist.sharding``): ``pixel_ids`` are the
    global ids of the G-buffer's entries, ``valid`` masks its padding, and
    ``reduce`` maps the radiance before it is added (the mean over sample
    streams)."""
    active = valid
    if adaptive:
        gate = needs_sample(gbuffer, config)
        active = gate if valid is None else gate & valid
    radiance = render_sample(scene, camera, key_words, config, active, trace_fn, pixel_ids)
    if reduce is not None:
        radiance = reduce(radiance)
    took = active if active is not None else torch.ones_like(gbuffer.count, dtype=torch.bool)
    return GBuffer(
        frame=gbuffer.frame + radiance,
        sq_luminance=gbuffer.sq_luminance
        + torch.where(took, torch.square(luminance(radiance)), 0.0),
        count=gbuffer.count + took.to(torch.int32),
    )


def resolve_image(gbuffer: GBuffer, config: RenderConfig) -> torch.Tensor:
    """Tonemapped display image (H, W, 3) in [0,1] (draw_frame,
    render.cuh:37-59): per-pixel average -> correct_color."""
    counts = torch.clamp_min(gbuffer.count, 1).to(torch.float32)
    img = correct_color(gbuffer.frame / counts[:, None])
    return img.reshape(config.height, config.width, 3)


def compact_bucket(n_active: int, num_pixels: int, chunk: int) -> int:
    """Smallest ceil-halving of num_pixels (floored at ``chunk``) >= n_active.

    The ladder {num_pixels, ceil(/2), ceil(/4), ..., chunk} keeps padding
    waste below 2x and works for odd pixel counts.
    """
    size = num_pixels
    while -(-size // 2) >= max(n_active, 1) and -(-size // 2) >= chunk:
        size = -(-size // 2)
    return size


def _accumulate(gb: GBuffer, ids, radiance, valid) -> GBuffer:
    """Scatter-add a compacted wavefront back; masked lanes add zeros."""
    return GBuffer(
        frame=gb.frame.index_add(0, ids, radiance),
        sq_luminance=gb.sq_luminance.index_add(
            0, ids, torch.where(valid, torch.square(luminance(radiance)), 0.0)
        ),
        count=gb.count.index_add(0, ids, valid.to(torch.int32)),
    )


def _first_ids(active: torch.Tensor, bucket: int):
    """Ascending ids of the active pixels, padded with 0 to ``bucket``, and
    their count (``jnp.nonzero(size=bucket, fill_value=0)``)."""
    ids = torch.nonzero(active).flatten()[:bucket].to(torch.int32)
    n = ids.shape[0]
    pad = torch.zeros((bucket - n,), dtype=torch.int32, device=active.device)
    return torch.cat([ids, pad]), n


def compact_step(
    scene: Scene, camera: Camera, gb: GBuffer, key_words, config: RenderConfig,
    bucket: int, trace_fn=None,
) -> GBuffer:
    """Compute-skipping adaptive step: gather the unconverged pixel ids into
    a ``bucket``-sized wavefront, render only those, scatter-add back."""
    ids, n_active = _first_ids(needs_sample(gb, config), bucket)
    valid = torch.arange(bucket, device=ids.device) < n_active
    radiance = render_sample(
        scene, camera, key_words, config, active=valid, trace_fn=trace_fn,
        pixel_ids=ids,
    )
    return _accumulate(gb, ids.long(), radiance, valid)


def candidates(gb: GBuffer, config: RenderConfig, bucket: int,
               valid: Optional[torch.Tensor] = None):
    """(bucket,) ascending ids of the unconverged pixels (among ``valid``
    ones), -1 padded, and their count. One O(num_pixels) scan, done once
    when entering tail mode."""
    active = needs_sample(gb, config)
    ids, n = _first_ids(active if valid is None else active & valid, bucket)
    ids = torch.where(torch.arange(bucket, device=ids.device) < n, ids, -1)
    return ids, n


def tail_step(
    scene: Scene, camera: Camera, gb: GBuffer, cand: torch.Tensor, key_words,
    config: RenderConfig, trace_fn=None, pixel_ids: Optional[torch.Tensor] = None,
    reduce=None,
):
    """O(bucket) adaptive step over a CANDIDATE id set.

    A pixel that leaves the active set accumulates nothing, so it can never
    re-activate: the tail loop re-tests needs_sample only on the candidates.
    Actives stay ascending and compact to the front. Returns
    (gbuffer', candidates', n_active). ``pixel_ids`` and ``reduce`` as in
    ``render_step``.
    """
    bucket = cand.shape[0]
    valid_c = cand >= 0
    safe = torch.clamp_min(cand, 0).long()
    sub = GBuffer(gb.frame[safe], gb.sq_luminance[safe], gb.count[safe])
    active = needs_sample(sub, config) & valid_c
    n = int(active.sum())
    order = torch.argsort((~active).to(torch.int8), stable=True)
    cand2 = torch.where(torch.arange(bucket, device=cand.device) < n, cand[order], -1)
    ids = torch.clamp_min(cand2, 0)
    valid = cand2 >= 0
    radiance = render_sample(
        scene, camera, key_words, config, active=valid, trace_fn=trace_fn,
        pixel_ids=ids if pixel_ids is None else pixel_ids[ids.long()],
    )
    if reduce is not None:
        radiance = reduce(radiance)
    return _accumulate(gb, ids.long(), radiance, valid), cand2, n


@torch.no_grad()
def render(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    num_samples: int,
    seed: int = 0,
    adaptive: bool = False,
    gbuffer: Optional[GBuffer] = None,
    sample_offset: int = 0,
) -> GBuffer:
    """Render ``num_samples`` progressive steps (main.cu:114-132).

    Step i uses the key words of sample ``sample_offset + i`` of ``seed``
    (the JAX package's ``fold_in(PRNGKey(seed), sample_offset + i)``).
    """
    device = scene.device
    if gbuffer is None:
        gbuffer = GBuffer.create(config.num_pixels, device)
    trace_fn = make_trace_fn(scene, config)
    floor = min(config.min_wavefront, config.num_pixels)

    cand = None  # tail-mode candidate ids (ascending, -1 padded)
    bucket = config.num_pixels
    for i in range(num_samples):
        key_words = rng.sample_key_words(seed, sample_offset + i)
        if adaptive:
            # One host sync per step sizes the wavefront to the unconverged
            # set, like the reference's per-thread skip
            # (path_tracing.cuh:347-379).
            if cand is None:
                n_active = int(needs_sample(gbuffer, config).sum())
                if n_active == 0:
                    break
                bucket = compact_bucket(n_active, config.num_pixels, floor)
                if bucket < config.num_pixels:
                    cand, _ = candidates(gbuffer, config, bucket)
            if cand is not None:
                gbuffer, cand, n_active = tail_step(
                    scene, camera, gbuffer, cand, key_words, config, trace_fn
                )
                if n_active == 0:
                    break
                nb = compact_bucket(n_active, config.num_pixels, floor)
                if nb < bucket:
                    cand = cand[:nb]  # actives are compacted to the front
                    bucket = nb
                continue
        gbuffer = render_step(
            scene, camera, gbuffer, key_words, config, adaptive, trace_fn
        )
    return gbuffer
